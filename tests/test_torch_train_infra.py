"""The port's training infrastructure against the JAX reference and its
own tests, on the CPU: the data stream (bitwise), checkpointing (the
reference's tests/test_checkpoint.py but its mesh re-shard case), the
fault-tolerant loop (all five of tests/test_fault_tolerance.py), gradient
compression (tests/test_compression.py, and the payloads against the
reference's), ``model_flops`` / ``remat_overhead`` (equal for every
configuration and shape) and the ``repro_torch.launch.train`` CLI.

Tolerances: the token batches and ``model_flops`` / ``remat_overhead``
exact; a checkpoint round trip bitwise (bf16 too); the loop's crash
recovery bitwise against an uninterrupted run (deterministic step,
replayable data); compression's payloads against the reference's: int8
codes and scales exact, top-k kept values exact (f32 both sides, the same
elementwise formulas); the running-sum contract at the reference's own
rtol = atol = 1e-4.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.analysis.roofline import model_flops as ref_model_flops
from repro.analysis.roofline import remat_overhead as ref_remat_overhead
from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.distributed.compression import compress_grads as ref_compress
from repro.distributed.compression import \
    init_compress_state as ref_init_compress
from repro.train.data import DataConfig as RDataConfig
from repro.train.data import TokenStream as RTokenStream
from repro_torch.analysis.roofline import model_flops, remat_overhead
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.distributed.compression import (compress_grads,
                                                 compressed_bytes,
                                                 decompress_grads,
                                                 init_compress_state)
from repro_torch.models.convert import leaves
from repro_torch.train import (AdamConfig, Checkpointer, DataConfig,
                               FaultTolerantLoop, LoopConfig, TokenStream,
                               TrainConfig, init_train_state,
                               make_train_step)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 4, 0),
                                                  (49152, 256, 8, 0),
                                                  (128, 7, 3, 5)])
def test_token_stream_is_bitwise_the_reference(vocab, seq, batch, seed):
    ref = RTokenStream(RDataConfig(vocab=vocab, seq=seq, batch=batch,
                                   seed=seed))
    port = TokenStream(DataConfig(vocab=vocab, seq=seq, batch=batch,
                                  seed=seed))
    for step in (0, 1, 7, 123):
        a, b = port.batch(step), ref.batch(step)
        for key in ("tokens", "targets"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
    it = port.iterate(5)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  np.asarray(ref.batch(5)["tokens"]))


# -------------------------------------------------------------- checkpoint
def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.random((8, 16), np.float32)),
                   "b": torch.from_numpy(rng.random(16, np.float32))},
        "opt": {"mu": [torch.from_numpy(rng.random(4, np.float32)),
                       torch.from_numpy(rng.random((2, 2), np.float32))]},
    }


def assert_tree_equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip_sync(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = tree(1)
    ck.save(7, t, extra={"data_step": 7})
    step, got, extra = ck.restore_latest(t)
    assert step == 7 and extra["data_step"] == 7
    assert_tree_equal(t, got)


def test_roundtrip_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        ck.save(s, tree(s))
    ck.wait()
    steps = ck.list_steps()
    assert steps == [3, 4]
    step, got, _ = ck.restore_latest(tree(0))
    assert step == 4
    assert_tree_equal(tree(4), got)


def test_uncommitted_checkpoint_skipped(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, tree(5))
    # simulate a crash mid-save at step 9: directory without DONE marker
    broken = tmp_path / "step_000000009"
    broken.mkdir()
    (broken / "meta.json").write_text("{}")
    step, got, _ = ck.restore_latest(tree(0))
    assert step == 5
    assert_tree_equal(tree(5), got)


def test_restore_empty_dir(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    assert ck.restore_latest(tree(0)) is None
    assert ck.restore_latest_into(tree(0)) is None


def test_overwrite_same_step(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(2, tree(1))
    ck.save(2, tree(9))
    _, got, _ = ck.restore_latest(tree(0))
    assert_tree_equal(tree(9), got)


def test_restore_into_copies_in_place_and_keeps_bf16_and_ints(tmp_path):
    """``restore_latest_into`` fills the caller's own tensors; bf16 leaves
    and a 0-d int32 step come back bit for bit; the async save in flight
    is waited for; a leaf of another shape raises."""
    t = tree(3)
    t["params"]["h"] = torch.randn(5, 3).to(torch.bfloat16)
    t["step"] = torch.tensor(11, dtype=torch.int32)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(4, t)
    into = tree(0)
    into["params"]["h"] = torch.zeros(5, 3, dtype=torch.bfloat16)
    into["step"] = torch.zeros((), dtype=torch.int32)
    keep = into["params"]["w"]
    step, got, _ = ck.restore_latest_into(into)
    assert step == 4 and got is into and into["params"]["w"] is keep
    assert_tree_equal(t, into)
    _, fresh, _ = ck.restore_latest(into)
    assert_tree_equal(t, fresh)
    into["params"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore_latest_into(into)


def test_async_write_failure_raises_at_wait(tmp_path, monkeypatch):
    """A write that fails off-thread is not lost: the next ``wait`` (or
    ``save``, or restore) raises it, and nothing is committed."""
    import repro_torch.train.checkpoint as C

    def full_disk(*a, **kw):
        raise OSError("No space left on device")

    monkeypatch.setattr(C.np, "savez", full_disk)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(3, tree(3))
    with pytest.raises(OSError, match="No space"):
        ck.wait()
    assert ck.list_steps() == []
    ck.wait()                                   # raised once


# ------------------------------------------------------ fault tolerance
def make_setup(tmp_path, total_steps=12, name="ckpt"):
    cfg = dataclasses.replace(get_config("granite-8b", reduced=True),
                              dtype=torch.float32, n_layers=2, d_model=32,
                              d_ff=64, n_heads=2, n_kv=2, head_dim=16,
                              vocab=128)
    tcfg = TrainConfig(adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=total_steps))
    step_fn = make_train_step(cfg, tcfg)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   tcfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=32, batch=4))
    ck = Checkpointer(str(tmp_path / name), keep=5, async_save=False)
    return step_fn, params, opt, stream, ck


def run_loop(tmp_path, name, fault_hook=None, total=12):
    step_fn, params, opt, stream, ck = make_setup(tmp_path, total, name)
    loop = FaultTolerantLoop(
        train_step=step_fn, params=params, opt_state=opt, stream=stream,
        ckpt=ck, loop_cfg=LoopConfig(total_steps=total, checkpoint_every=4,
                                     log_every=1),
        fault_hook=fault_hook)
    result = loop.run()
    return loop, result


def test_clean_run_loss_decreases(tmp_path):
    loop, result = run_loop(tmp_path, "clean")
    assert result["final_step"] == 12
    losses = [m["loss"] for m in result["log"]]
    assert losses[-1] < losses[0]


def test_crash_recovery_bit_exact(tmp_path):
    """A crash at step 6 must restore from the step-4 checkpoint and end
    with exactly the same weights as an uninterrupted run (replayable data
    + deterministic step)."""
    loop_clean, _ = run_loop(tmp_path, "a2")

    crashed = {"done": False}

    def hook(step):
        if step == 6 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    loop_faulty, result = run_loop(tmp_path, "b", fault_hook=hook)
    assert result["restores"] == 1
    assert result["final_step"] == 12
    for a, b in zip(leaves(loop_clean.params), leaves(loop_faulty.params)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(loop_clean.opt_state),
                    leaves(loop_faulty.opt_state)):
        assert torch.equal(a, b)


def test_repeated_crash_eventually_raises(tmp_path):
    def hook(step):
        raise RuntimeError("permanently broken")

    with pytest.raises(RuntimeError):
        run_loop(tmp_path, "c", fault_hook=hook)


def test_nan_guard_restores(tmp_path):
    """A NaN loss triggers restore instead of committing poisoned state."""
    step_fn, params, opt, stream, ck = make_setup(tmp_path, 8, "nan")
    calls = {"n": 0}

    def poisoned_step(params, opt_state, batch):
        calls["n"] += 1
        p2, o2, m = step_fn(params, opt_state, batch)
        if calls["n"] == 3:
            m = dict(m)
            m["loss"] = torch.tensor(float("nan"))
        return p2, o2, m

    loop = FaultTolerantLoop(
        train_step=poisoned_step, params=params, opt_state=opt,
        stream=stream, ckpt=ck,
        loop_cfg=LoopConfig(total_steps=8, checkpoint_every=2, log_every=1))
    result = loop.run()
    assert result["final_step"] == 8
    assert result["restores"] == 1


def test_resume_from_checkpoint_after_shutdown(tmp_path):
    """Loop killed at step 8 (simulated by a fresh loop over the same ckpt
    dir) resumes at the last checkpoint, not from scratch."""
    step_fn, params, opt, stream, ck = make_setup(tmp_path, 8, "resume")
    loop1 = FaultTolerantLoop(train_step=step_fn, params=params,
                              opt_state=opt, stream=stream, ckpt=ck,
                              loop_cfg=LoopConfig(total_steps=8,
                                                  checkpoint_every=4,
                                                  log_every=1))
    loop1.run()
    # new process: same dir, higher target
    step_fn2, params2, opt2, stream2, _ = make_setup(tmp_path, 16, "unused")
    ck2 = Checkpointer(str(tmp_path / "resume"), keep=5, async_save=False)
    loop2 = FaultTolerantLoop(train_step=step_fn2, params=params2,
                              opt_state=opt2, stream=stream2, ckpt=ck2,
                              loop_cfg=LoopConfig(total_steps=16,
                                                  checkpoint_every=4,
                                                  log_every=1))
    result = loop2.run()
    assert result["final_step"] == 16
    # resumed (restored step-8 checkpoint), so first logged step is ≥ 9
    assert result["log"][0]["step"] >= 9


# ------------------------------------------------------------ compression
def grads_like(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(
                rng.standard_normal((32, 16)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(64).astype(np.float32))}


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_tracks_running_sum(scheme):
    """Σ decompressed ≈ Σ true gradients (residual carries the error)."""
    state = init_compress_state(grads_like(0))
    total_true = {k: torch.zeros_like(v) for k, v in grads_like(0).items()}
    total_sent = {k: torch.zeros_like(v) for k, v in grads_like(0).items()}
    for step in range(20):
        g = grads_like(step)
        payload, state = compress_grads(g, state, scheme=scheme,
                                        topk_frac=0.2)
        d = decompress_grads(payload, scheme=scheme)
        total_true = {k: total_true[k] + g[k] for k in g}
        total_sent = {k: total_sent[k] + d[k] for k in g}
    for k in total_true:
        r = state.residual[k]
        np.testing.assert_allclose((total_true[k] - total_sent[k]).numpy(),
                                   r.numpy(), rtol=1e-4, atol=1e-4)
        assert float(r.abs().max()) < 10.0


def test_int8_payload_size():
    g = grads_like(1)
    payload, _ = compress_grads(g, init_compress_state(g), scheme="int8")
    n_elems = sum(x.numel() for x in g.values())
    assert compressed_bytes(payload, scheme="int8") == n_elems + 4 * len(g)


def test_int8_quantisation_error_bounded():
    g = grads_like(2)
    payload, _ = compress_grads(g, init_compress_state(g), scheme="int8")
    d = decompress_grads(payload, scheme="int8")
    for k in g:
        scale = float(g[k].abs().max()) / 127.0
        assert float((g[k] - d[k]).abs().max()) <= scale * 0.5 + 1e-6


def test_topk_keeps_largest():
    g = {"a": torch.tensor([1.0, -5.0, 0.1, 3.0, -0.2, 0.05, 2.0, -1.5])}
    payload, _ = compress_grads(g, init_compress_state(g), scheme="topk",
                                topk_frac=0.25)
    d = decompress_grads(payload, scheme="topk")["a"]
    assert set(torch.nonzero(d).flatten().tolist()) == {1, 3}


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_payloads_and_residuals_equal_the_reference(scheme):
    g = grads_like(3)
    got, state = compress_grads(g, init_compress_state(g), scheme=scheme,
                                topk_frac=0.2)
    rg = {k: jnp.asarray(v.numpy()) for k, v in g.items()}
    want, rstate = ref_compress(rg, ref_init_compress(rg), scheme=scheme,
                                topk_frac=0.2)
    for k in g:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(state.residual[k].numpy(),
                                      np.asarray(rstate.residual[k]))


# --------------------------------------------------------------- roofline
def test_model_flops_and_remat_overhead_equal_the_reference():
    assert ARCH_NAMES == REF_ARCHS and list(SHAPES) == list(REF_SHAPES)
    for arch in ARCH_NAMES:
        for reduced in (False, True):
            cfg, rcfg = (get_config(arch, reduced=reduced),
                         ref_config(arch, reduced=reduced))
            assert cfg.n_active_params() == rcfg.n_active_params()
            for name, shape in SHAPES.items():
                for chips in (1, 4, 256):
                    assert model_flops(cfg, shape, chips=chips) == \
                        ref_model_flops(rcfg, REF_SHAPES[name], chips=chips)
                assert remat_overhead(cfg, shape) == \
                    ref_remat_overhead(rcfg, REF_SHAPES[name])
            for block_remat in (True, False):
                c = dataclasses.replace(cfg, block_remat=block_remat)
                rc = dataclasses.replace(rcfg, block_remat=block_remat)
                assert remat_overhead(c, SHAPES["train_4k"]) == \
                    ref_remat_overhead(rc, REF_SHAPES["train_4k"])


# ------------------------------------------------------------------- CLI
def run_cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)


def test_train_cli_runs_reduced_on_the_cpu(tmp_path):
    res = run_cli("--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
                  "--checkpoint-every", "2", "--device", "cpu", "--ckpt",
                  str(tmp_path / "ck"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "arch=granite-8b-reduced" in res.stdout    # the default arch
    assert "done: steps=4 restores=0" in res.stdout
    assert Checkpointer(str(tmp_path / "ck")).list_steps()[-1] == 4


def test_train_cli_defaults_are_the_reference_launchers():
    from repro_torch.launch import train as T
    import argparse
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        seen.update(vars(real(self, [], namespace)))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            T.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    assert (seen["arch"], seen["batch"], seen["seq"], seen["steps"],
            seen["lr"], seen["checkpoint_every"], seen["mesh"],
            seen["device"]) == ("granite-8b", 8, 256, 100, 3e-4, 50, "host",
                                None)


def test_train_cli_needs_the_card_unless_told_and_refuses_a_mesh(tmp_path):
    if not torch.cuda.is_available():
        res = run_cli("--reduced", "--steps", "1", "--ckpt",
                      str(tmp_path / "ck"))
        assert res.returncode != 0 and "CUDA" in res.stderr
    res = run_cli("--reduced", "--steps", "1", "--mesh", "production",
                  "--device", "cpu", "--ckpt", str(tmp_path / "ck2"))
    assert res.returncode != 0 and "out of scope" in res.stderr
