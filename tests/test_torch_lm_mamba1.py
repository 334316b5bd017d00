"""Port parity: the selective scan and falcon-mamba-7b serving (Mamba-1
prefill + decode) against the JAX reference, on the CPU at small sizes.

The same numpy inputs, or the reference's parameters carried over with
``repro_torch.models.convert``, go through both packages. Tolerances, each
with its reason:

* the plain ``selective_scan_ref`` against the reference's Pallas
  ``selective_scan`` in interpret mode and its oracle: rtol = atol = 2e-5,
  the reference's own (tests/test_kernel_mamba_scan.py:33);
* one Mamba-1 mixer: 1e-5 of the output's scale (f32 both sides, the same
  formulas; the reference scans in chunks, the port sequentially, and sums
  in other orders);
* the whole reduced model: logits within 1e-4 of their scale, caches within
  1e-4 of each leaf's scale, greedy tokens equal; the port's decode against
  its own train-mode forward: 2e-3 of the logits' scale, the reference's own
  pin (tests/test_serve_decode.py:54).

The kernel itself runs only on the card: tests/test_torch_lm_cuda.py.
"""

import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_config
from repro.kernels.mamba_scan import selective_scan as ref_scan
from repro.kernels.mamba_scan import selective_scan_ref as ref_scan_oracle
from repro.models import init_params as ref_init
from repro.models.mamba import init_mamba1 as ref_init_mamba1
from repro.models.mamba import mamba1_forward as ref_m1_forward
from repro.models.mamba import mamba1_step as ref_m1_step
from repro.models.model import make_caches as ref_make_caches
from repro.serve.serve_step import decode_step as ref_decode
from repro.serve.serve_step import greedy_generate as ref_greedy
from repro.serve.serve_step import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import kernel as MK
from repro_torch.kernels.mamba_scan import (selective_scan,
                                            selective_scan_op,
                                            selective_scan_ref)
from repro_torch.models import (Mamba1State, forward, init_params,
                                make_caches, make_mamba1_state,
                                mamba1_forward, mamba1_step)
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        to_numpy)
from repro_torch.models.mamba import init_mamba1
from repro_torch.serve.serve_step import decode_step, greedy_generate, \
    prefill
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_lm_cuda import scan_inputs, tt

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
B, S0, S = 2, 40, 48          # prompt of 40 tokens, then 8 decode steps


def scale_of(a) -> float:
    return max(float(np.abs(np.asarray(a)).max()), 1e-30)


def close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale_of(want), (err, scale_of(want))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


# ------------------------------------------------------- (a) the plain scan
@pytest.mark.parametrize("Bz,Sz,dI,N,bd,with_h0", [
    (1, 32, 16, 8, 16, False),          # the reference test's four shapes
    (2, 64, 32, 16, 16, False),
    (1, 128, 64, 16, 32, False),
    (3, 48, 24, 4, 8, False),
    (2, 50, 24, 8, 8, True),            # an initial state
])
def test_plain_scan_matches_reference_kernel(Bz, Sz, dI, N, bd, with_h0):
    args = scan_inputs(Bz, Sz, dI, N, seed=Sz + dI)
    h0 = (np.random.default_rng(1).standard_normal((Bz, dI, N)).astype(
        np.float32) if with_h0 else None)
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_k, h_k = ref_scan(*map(jnp.asarray, args), h0=jh0, block_d=bd,
                        interpret=True)
    y_o, h_o = ref_scan_oracle(*map(jnp.asarray, args), h0=jh0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = selective_scan_ref(*tt(args), h0=th0)
    assert y.shape == (Bz, Sz, dI) and h.shape == (Bz, dI, N)
    for want_y, want_h in ((y_k, h_k), (y_o, h_o)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


# -------------------------------------------------------- (b) the wrapper
def test_scan_wrapper_rejects_bad_arguments():
    args = tt(scan_inputs(1, 16, 8, 4))
    with pytest.raises(ValueError, match="dt"):
        selective_scan(args[0], args[1][:, :8], *args[2:])
    with pytest.raises(ValueError, match="A"):
        selective_scan(*args[:2], args[2][:4], *args[3:])
    with pytest.raises(ValueError, match="Cm"):
        selective_scan(*args[:4], args[4][..., :2], args[5])
    with pytest.raises(ValueError, match="D"):
        selective_scan(*args[:5], args[5][:3])
    with pytest.raises(ValueError, match="h0"):
        selective_scan(*args, h0=torch.zeros(1, 4, 8))
    with pytest.raises(ValueError, match="u must be"):
        selective_scan(args[0][0], *args[1:])
    # every argument on u's device
    with pytest.raises(ValueError, match="Bm on meta"):
        selective_scan(*args[:3], args[3].to("meta"), *args[4:])
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan(*(a.to("meta") for a in args))
    # the CUDA-only limits: the built state widths
    assert MK.KERNEL_N == (4, 8, 16)


# ---------------------------------------------------------- (i) no kernel
def test_cpu_scan_launches_no_kernel_and_op_takes_views():
    """The CPU path is the plain version; the op makes the model's views
    (B and C sliced from one projection) contiguous first."""
    args = scan_inputs(2, 20, 12, 8, seed=3)
    proj = np.concatenate([args[3], args[4]], axis=-1)     # (B, S, 2N)
    tp = torch.from_numpy(proj)
    n0 = MK.selective_scan.launches
    y, h = selective_scan_op(*tt(args[:3]), tp[..., :8], tp[..., 8:],
                             torch.from_numpy(args[5]))
    want = selective_scan_ref(*tt(args))
    assert MK.selective_scan.launches == n0
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


# ------------------------------------------------------ (c) Mamba-1 mixer
@pytest.fixture(scope="module", params=[True, False], ids=["bcdt_rms",
                                                           "plain"])
def mixer(request):
    d, N, chunk = 32, 8, 16
    rms = request.param
    rp = ref_init_mamba1(jax.random.PRNGKey(3), d, d_state=N, bcdt_rms=rms)
    p = {k: torch.from_numpy(np.array(v)) for k, v in np_tree(rp).items()}
    x = np.random.default_rng(7).standard_normal((2, 37, d)).astype(
        np.float32)
    return dict(d=d, N=N, chunk=chunk, rms=rms, rp=rp, p=p, x=x)


def test_mamba1_forward_with_and_without_state_matches_reference(mixer):
    m = mixer
    kw = dict(d_state=m["N"], bcdt_rms=m["rms"])
    rkw = dict(kw, chunk=m["chunk"])       # the reference scans in chunks
    ry, _ = ref_m1_forward(m["rp"], jnp.asarray(m["x"]), **rkw)
    y, s = mamba1_forward(m["p"], torch.from_numpy(m["x"]), **kw)
    assert s is None
    close(y.numpy(), ry, 1e-5)
    ry, rs = ref_m1_forward(m["rp"], jnp.asarray(m["x"]), return_state=True,
                            **rkw)
    y, s = mamba1_forward(m["p"], torch.from_numpy(m["x"]),
                          return_state=True, **kw)
    close(y.numpy(), ry, 1e-5)
    close(s.conv.numpy(), rs.conv, 1e-6)
    close(s.ssm.numpy(), rs.ssm, 1e-5)
    # continuing from a state: the second half of a split sequence
    a, b = m["x"][:, :20], m["x"][:, 20:]
    _, rs_a = ref_m1_forward(m["rp"], jnp.asarray(a), return_state=True,
                             **rkw)
    ry_b, _ = ref_m1_forward(m["rp"], jnp.asarray(b), state=rs_a, **rkw)
    _, s_a = mamba1_forward(m["p"], torch.from_numpy(a), return_state=True,
                            **kw)
    y_b, _ = mamba1_forward(m["p"], torch.from_numpy(b), state=s_a, **kw)
    close(y_b.numpy(), ry_b, 1e-5)
    close(y_b.numpy(), y[:, 20:].numpy(), 1e-5)


def test_mamba1_step_matches_reference(mixer):
    m = mixer
    kw = dict(d_state=m["N"], bcdt_rms=m["rms"])
    _, rs = ref_m1_forward(m["rp"], jnp.asarray(m["x"][:, :30]),
                           return_state=True, chunk=m["chunk"], **kw)
    _, s = mamba1_forward(m["p"], torch.from_numpy(m["x"][:, :30]),
                          return_state=True, **kw)
    for t in range(30, 37):
        xt = m["x"][:, t:t + 1]
        ry, rs = ref_m1_step(m["rp"], jnp.asarray(xt), rs, **kw)
        y, s = mamba1_step(m["p"], torch.from_numpy(xt), s, **kw)
        close(y.numpy(), ry, 1e-5)
    close(s.ssm.numpy(), rs.ssm, 1e-5)
    close(s.conv.numpy(), rs.conv, 1e-6)


def test_init_mamba1_draws_the_reference_distributions():
    """Shapes, constants and value ranges of the port's own draws (the two
    packages' generators give different numbers from one seed)."""
    d, N = 64, 16
    rp = np_tree(ref_init_mamba1(jax.random.PRNGKey(0), d, d_state=N,
                                 bcdt_rms=True))
    p = init_mamba1(torch.Generator().manual_seed(0), d, d_state=N,
                    bcdt_rms=True)
    assert sorted(p) == sorted(rp)
    for k, v in p.items():
        assert tuple(v.shape) == rp[k].shape and v.dtype == torch.float32, k
    for k in ("D", "conv_b", "b_norm", "c_norm", "dt_norm"):
        np.testing.assert_array_equal(p[k].numpy(), rp[k])
    # log(1..N): XLA's CPU log is one ulp off the correctly rounded log 7,
    # which PyTorch (and numpy in float64) give
    np.testing.assert_allclose(p["A_log"].numpy(), rp["A_log"],
                               rtol=2.0 ** -23, atol=0)
    np.testing.assert_array_equal(
        p["A_log"].numpy()[0],
        np.log(np.arange(1, N + 1, dtype=np.float64)).astype(np.float32))
    # dt_bias = softplus⁻¹(dt), dt log-uniform on [0.001, 0.1]
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 0.001 * (1 - 1e-3)
    assert float(dt.max()) <= 0.1 * (1 + 1e-3)
    for k, s in (("in_proj", d ** -0.5), ("x_proj", (2 * d) ** -0.5),
                 ("dt_proj", (d // 16) ** -0.5), ("conv_w", 0.5)):
        assert abs(float(p[k].std()) / s - 1) < 0.25, k


# ------------------------------------------- (d) the whole reduced model
@pytest.fixture(scope="module")
def falcon():
    """The reduced falcon-mamba-7b in both packages from one set of
    parameters, tokens, the reference's prefill + teacher-forced decode,
    and the port's."""
    rcfg = dataclasses.replace(ref_config("falcon-mamba-7b", reduced=True),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("falcon-mamba-7b", reduced=True),
                              dtype=torch.float32)
    rparams = ref_init(rcfg, jax.random.PRNGKey(2))
    tree = np_tree(rparams)
    params = params_from_numpy(tree)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)

    rlog, rcaches, rolling = ref_prefill(rparams, rcfg,
                                         jnp.asarray(tokens[:, :S0]),
                                         cache_len=S)
    ref_steps = [np.asarray(rlog)]
    pos = jnp.asarray(S0, jnp.int32)
    for t in range(S0, S):
        lg, rcaches = ref_decode(rparams, rcfg,
                                 jnp.asarray(tokens[:, t:t + 1]), rcaches,
                                 pos, rolling=rolling)
        ref_steps.append(np.asarray(lg))
        pos = pos + 1

    tok = torch.from_numpy(tokens).long()
    n0 = MK.selective_scan.launches
    lg, caches, rolling_p = prefill(params, cfg, tok[:, :S0], cache_len=S)
    steps = [lg.numpy()]
    for t in range(S0, S):
        lg, caches = decode_step(params, cfg, tok[:, t:t + 1], caches, t,
                                 rolling=rolling_p)
        steps.append(lg.numpy())
    return dict(rcfg=rcfg, cfg=cfg, rparams=rparams, tree=tree,
                params=params, tokens=tokens, ref_steps=ref_steps,
                ref_caches=np_tree(rcaches), steps=steps,
                caches=to_numpy(caches), rolling=rolling_p,
                launches=MK.selective_scan.launches - n0)


def test_falcon_prefill_last_logits_match_reference(falcon):
    close(falcon["steps"][0], falcon["ref_steps"][0], 1e-4)


def test_falcon_teacher_forced_decode_matches_reference(falcon):
    scale = scale_of(falcon["ref_steps"][0])
    for t, (got, want) in enumerate(zip(falcon["steps"][1:],
                                        falcon["ref_steps"][1:])):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (t, err, scale)


def test_falcon_decode_caches_match_reference(falcon):
    want, want_def = jax.tree.flatten(falcon["ref_caches"])
    got, got_def = jax.tree.flatten(falcon["caches"])
    n = falcon["cfg"].n_layers
    assert len(got) == len(want) == 2 * n          # conv and ssm per layer
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        close(g, w, 1e-4)


def test_falcon_greedy_tokens_match_reference(falcon):
    prompt = falcon["tokens"][:, :S0]
    want = ref_greedy(falcon["rparams"], falcon["rcfg"], jnp.asarray(prompt),
                      n_new=8)
    got = greedy_generate(falcon["params"], falcon["cfg"],
                          torch.from_numpy(prompt).long(), n_new=8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_falcon_decode_matches_own_train_forward(falcon):
    full = forward(falcon["params"], falcon["cfg"],
                   torch.from_numpy(falcon["tokens"]).long()).logits.numpy()
    scale = max(scale_of(full), 1.0)
    for t, got in zip(range(S0 - 1, S), falcon["steps"]):
        assert np.abs(got - full[:, t]).max() < 2e-3 * scale, t


def test_falcon_cpu_serve_path_launches_no_kernel(falcon):
    assert falcon["launches"] == 0


# ------------------------------------------------- (e) convert and init
def test_falcon_convert_round_trips_every_leaf(falcon):
    back = params_to_numpy(falcon["params"])
    want, want_def = jax.tree.flatten(falcon["tree"])
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    segs = falcon["params"]["segments"]
    assert [[len(pos) for pos in seg] for seg in segs] == [[4]]
    np.testing.assert_array_equal(
        segs[0][0][2]["mix"]["x_proj"].numpy(),
        falcon["tree"]["segments"][0][0]["mix"]["x_proj"][2])


def test_falcon_init_params_shapes_match_reference(falcon):
    cfg = falcon["cfg"]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(np.shape, params_to_numpy(params))
    want = jax.tree.map(np.shape, falcon["tree"])
    assert got == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)))
    assert n > 0


# ----------------------------------------------------- (f) the caches
def test_falcon_make_caches_match_reference_layout(falcon):
    want, rolling = ref_make_caches(falcon["rcfg"], B, S, stacked=False)
    got, rolling_p = make_caches(falcon["cfg"], B, S, device="cpu")
    assert rolling_p == rolling == {}
    assert isinstance(got[0][0][0], Mamba1State)
    want = jax.tree.leaves(np_tree(want))
    got = jax.tree.leaves(to_numpy(got))
    assert len(got) == len(want) == 2 * falcon["cfg"].n_layers
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert not np.any(g) and not np.any(w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_caches(falcon["cfg"], B, S)        # the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mamba1_state(B, 8)


# ------------------------------------------------ (g) config, (h) CLI
def test_falcon_config_matches_reference():
    for reduced in (False, True):
        ref = dataclasses.asdict(ref_config("falcon-mamba-7b",
                                            reduced=reduced))
        got = dataclasses.asdict(get_config("falcon-mamba-7b",
                                            reduced=reduced))
        ref.pop("dtype"), got.pop("dtype")
        assert got == ref
        assert get_config("falcon-mamba-7b", reduced=reduced).n_params() == \
            ref_config("falcon-mamba-7b", reduced=reduced).n_params()
    cfg = get_config("falcon-mamba-7b")
    assert 7.2e9 < cfg.n_params() < 7.3e9
    # 65,024 is already a multiple of the padding unit, 256
    assert cfg.vocab_padded == ref_config("falcon-mamba-7b").vocab_padded \
        == 65024
    assert get_config("falcon-mamba-7b-reduced").name == \
        "falcon-mamba-7b-reduced"


def test_falcon_serve_cli_runs_on_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    n0 = MK.selective_scan.launches
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--batch", "2",
                    "--prompt-len", "12", "--new-tokens", "4",
                    "--device", "cpu"])
    text = out.getvalue()
    assert "prefill: 2×12 tokens" in text and "decode: 6 tokens" in text
    assert text.count("on cpu") == 2
    assert MK.selective_scan.launches == n0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "falcon-mamba-7b", "--reduced",
                        "--prompt-len", "4"])


# ----------------------------------------------- (j) chip_smoke's bound
def test_chip_smoke_scan_bound_counts_the_function():
    """chip_smoke.py's selective_scan bound: 7 operations per (b, t, d, n)
    (dt·A, exp, the decay multiply, the input and C FMAs, an FMA counted
    as 2) and 3 per (b, t, d) (dt·u, D·u and its add); bytes: u, dt, B, C,
    A, D and h0 read once, y and h written once — not the kernel's tiles."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as C
    ops, moved = C.scan_ops_bytes(2, 10, 24, 8)
    assert ops == 2 * 10 * 24 * (7 * 8 + 3)
    assert moved == 4 * (3 * 2 * 10 * 24 + 2 * 2 * 10 * 8 + 24 * 8 + 24
                         + 2 * 24 * 8)
    _, with_h0 = C.scan_ops_bytes(2, 10, 24, 8, with_h0=True)
    assert with_h0 == moved + 4 * 2 * 24 * 8
    ops, moved = C.scan_ops_bytes(4, 2048, 8192, 16)   # the serve shape
    assert ops == 4 * 2048 * 8192 * 115
    assert 0.80e9 < moved < 0.81e9
