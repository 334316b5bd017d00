"""Port parity: LM training (``lm_loss``, the train-mode remat, the flash
op's autograd, AdamW and the train step) against the JAX reference, on the
CPU at the reduced sizes.

The reference trains by ``jax.value_and_grad`` over plain ``jnp``
attention (``repro/models/layers.py:_sdpa``); the port's train forward
sends attention through ``flash_attention_op``, which on the CPU is the
plain flash version under PyTorch's autograd (on the card: the f32 kernel
and its backward kernel, tests/test_torch_lm_cuda.py). The reference's
parameters and gradients are carried into the port with
``repro_torch.models.convert``. Tolerances, each with its reason:

* attention's gradients and the forward's row log-sum-exp: 1e-5 of each
  one's scale — f32 both sides, the same formulas, sums in other orders;
* ``lm_loss`` and every parameter's gradient of a reduced model: 1e-4 of
  the loss and of each leaf's scale (the serving tests' pin on logits,
  tests/test_torch_lm_serve.py), with and without ``block_remat``;
* the remat levels change no bit: the gradients with ``block_remat`` on
  and off are bitwise equal;
* three train steps: loss and gradient norm within 1e-5 relative, the
  rate exact, every parameter and moment within 1e-4 of its leaf's scale
  (Adam's first steps divide each gradient by its own magnitude, so an
  element whose gradient is near zero moves by up to the rate whichever
  way rounding tips it: 4.9e-6 of scale at the launcher's 3e-4, 8e-5 at
  1e-3 — measured on this CPU);
* ``lr_schedule``, and ``adam_step``'s gradient norm and rate: within 4
  ulps (f32 ``pow``, ``cos`` and the norm's sums are not bitwise XLA's;
  the port's square roots are correctly rounded, as XLA's are); its
  parameters and moments over six steps within 1e-6 of each leaf's scale
  (the clip factor's ulps reach every element: at most 3.5e-7 measured on
  this CPU; an ulp count misleads where a moment is near zero).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init
from repro.models.layers import _sdpa as ref_sdpa
from repro.models.layers import _train_mask as ref_train_mask
from repro.models.model import lm_loss as ref_lm_loss
from repro.train import AdamConfig as RAdamConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import adam_init as ref_adam_init
from repro.train import adam_step as ref_adam_step
from repro.train import init_train_state as ref_init_train_state
from repro.train import lr_schedule as ref_lr_schedule
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_op)
from repro_torch.models import lm_loss
from repro_torch.models import layers as L
from repro_torch.models.convert import leaves, params_from_numpy
from repro_torch.train import (AdamConfig, DataConfig, TokenStream,
                               TrainConfig, adam_init, adam_step,
                               lr_schedule, make_train_step)
from torch_threads import one_torch_thread  # noqa: F401

TRAIN_ARCHS = ["granite-8b", "gemma-7b", "gemma3-27b",
               "seamless-m4t-large-v2", "zamba2-1.2b", "falcon-mamba-7b"]
B, S, ENC = 2, 24, 13


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


# ------------------------------------------------------ attention autograd
# (B, S, T, H, K, hd, causal, window, softcap): no query row without a live
# key (the reference's additive -1e30 mask spreads such a row over every
# key; the flash version gives it zeros)
ATTN_CASES = {
    "causal_gqa": (2, 40, 40, 4, 2, 16, True, None, None),
    "window": (1, 50, 50, 4, 4, 16, True, 16, None),
    "softcap": (2, 33, 33, 4, 2, 32, True, None, 5.0),
    "nomask_s_lt_t": (2, 20, 37, 4, 4, 16, False, None, None),
    "nomask_s_gt_t": (1, 37, 20, 4, 1, 16, False, None, None),
    "ragged_offset": (1, 27, 61, 6, 3, 16, True, 21, None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_autograd_matches_reference_sdpa_grad(case):
    Bq, Sq, T, H, K, hd, causal, window, softcap = ATTN_CASES[case]
    rng = np.random.default_rng(Sq + T)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((Bq, Sq, H, hd), (Bq, T, K, hd), (Bq, T, K, hd)))
    dout = rng.standard_normal((Bq, Sq, H * hd)).astype(np.float32)
    mask = ref_train_mask(jnp.arange(Sq) + (T - Sq), jnp.arange(T),
                          causal=causal, window=window)

    def f(q, k, v):
        out = ref_sdpa(q, k, v, mask, softcap=softcap)
        return jnp.sum(out * dout), out

    (_, want_out), want = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention_op(qt, kt, vt, causal=causal, window=window,
                             softcap=softcap).reshape(Bq, Sq, H * hd)
    out.backward(torch.from_numpy(dout))
    assert rel(out.detach(), want_out) <= 1e-5
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        assert rel(got, w) <= 1e-5, case


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_backward_wrapper_on_cpu_matches_reference(case):
    """The backward's wrapper and the forward's LSE on CPU tensors (the
    plain versions, which the card tests hold the kernels to) against the
    reference: ``flash_attention_bwd`` against ``jax.vjp`` of ``_sdpa``,
    ``flash_attention(return_lse=True)`` against the log-sum-exp of
    ``_sdpa``'s masked scores (its first lines), both within 1e-5 of
    scale."""
    Bq, Sq, T, H, K, hd, causal, window, softcap = ATTN_CASES[case]
    rng = np.random.default_rng(Sq + T + 1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((Bq, Sq, H, hd), (Bq, T, K, hd), (Bq, T, K, hd)))
    dout = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    mask = ref_train_mask(jnp.arange(Sq) + (T - Sq), jnp.arange(T),
                          causal=causal, window=window)
    _, vjp = jax.vjp(lambda q, k, v: ref_sdpa(q, k, v, mask, softcap=softcap),
                     q, k, v)
    want = vjp(dout.reshape(Bq, Sq, H * hd))
    scores = jnp.einsum("bskgh,btkh->bkgst", q.reshape(Bq, Sq, K, H // K, hd),
                        k) / np.sqrt(hd)
    if softcap is not None:
        scores = jnp.tanh(scores / softcap) * softcap
    want_lse = jax.nn.logsumexp(scores + mask[:, None, None], axis=-1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention(qt, kt, vt, return_lse=True, **kw)
    assert lse.shape == (Bq, H, Sq)
    assert rel(lse, np.asarray(want_lse).reshape(Bq, H, Sq)) <= 1e-5
    got = flash_attention_bwd(qt, kt, vt, out, torch.from_numpy(dout), lse,
                              **kw)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-5, case


# ---------------------------------------------------------- lm_loss, grads
def frontend(cfg, rng):
    if cfg.is_encdec:
        return {"enc_inputs": (0.1 * rng.standard_normal(
            (B, ENC, cfg.d_model))).astype(np.float32)}
    return {}


def both_models(arch, block_remat=True):
    rcfg = dataclasses.replace(ref_config(arch, reduced=True),
                               dtype=jnp.float32, block_remat=block_remat)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32, block_remat=block_remat)
    return rcfg, cfg


def port_loss_and_grads(params, cfg, toks, front):
    ps = list(leaves(params))
    for p in ps:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, cfg, torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]),
                      **{k: torch.from_numpy(v) for k, v in front.items()})
    return float(loss.detach()), torch.autograd.grad(loss, ps)


@pytest.mark.parametrize("block_remat", [True, False])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_loss_and_every_gradient_match_reference(arch, block_remat):
    rcfg, cfg = both_models(arch, block_remat)
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    front = frontend(cfg, rng)

    def f(p):
        return ref_lm_loss(p, rcfg, jnp.asarray(toks[:, :-1]),
                           jnp.asarray(toks[:, 1:]),
                           **{k: jnp.asarray(v) for k, v in front.items()})[0]

    want_loss, want_grads = jax.value_and_grad(f)(rp)
    loss, grads = port_loss_and_grads(params_from_numpy(np_tree(rp)), cfg,
                                      toks, front)
    assert abs(loss - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    want = list(leaves(params_from_numpy(np_tree(want_grads))))
    assert len(want) == len(grads)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        assert rel(got, w) <= 1e-4


def count_attention_calls(monkeypatch):
    calls = {"n": 0}
    orig = L.flash_attention_op

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(L, "flash_attention_op", counted)
    return calls


@pytest.mark.parametrize("arch,n_layers", [("granite-8b", 4),
                                           ("granite-8b", 6),
                                           ("seamless-m4t-large-v2", 3)])
def test_remat_levels_change_no_bit_and_run_the_stated_forwards(
        monkeypatch, arch, n_layers):
    """Both remat levels give bitwise the gradients of the group level
    alone; a backward runs each attention call's forward again once per
    level, but the group's recompute stops before its last block's
    interior (PyTorch's non-reentrant checkpoint stops once it holds every
    tensor the group saved): with G = ``_group(L, scan_group)`` layers a
    group, 3·L − L/G forwards a step with both levels, 2·L with one."""
    from repro_torch.models.model import _group
    calls = count_attention_calls(monkeypatch)
    runs = {}
    for block_remat in (True, False):
        _, cfg = both_models(arch, block_remat)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        rcfg = dataclasses.replace(ref_config(arch, reduced=True),
                                   dtype=jnp.float32, n_layers=n_layers)
        params = params_from_numpy(np_tree(ref_init(rcfg,
                                                    jax.random.PRNGKey(2))))
        toks = np.random.default_rng(3).integers(
            0, cfg.vocab, (B, S + 1)).astype(np.int32)
        front = frontend(cfg, np.random.default_rng(4))
        calls["n"] = 0
        _, grads = port_loss_and_grads(params, cfg, toks, front)
        runs[block_remat] = (grads, calls["n"])
    per_layer = 2 if cfg.is_encdec else 1         # dec: self and cross
    segments = [(n_layers, per_layer)]
    if cfg.is_encdec:
        segments.append((cfg.n_enc_layers, 1))
    want = {True: 0, False: 0}
    for L_, c in segments:
        G = _group(L_, cfg.scan_group)
        want[True] += (3 * L_ - L_ // G) * c
        want[False] += 2 * L_ * c
    assert runs[True][1] == want[True] and runs[False][1] == want[False]
    for a, b in zip(runs[True][0], runs[False][0]):
        assert torch.equal(a, b)


# --------------------------------------------------------------- optimizer
def random_tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((8, 16))).astype(np.float32),
            "b": [(scale * rng.standard_normal(16)).astype(np.float32),
                  (scale * rng.standard_normal((3, 5))).astype(np.float32)]}


def ulps(got, want) -> float:
    """max |got − want| in units of the last place of f32 at |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    spacing = np.spacing(np.abs(want)).astype(np.float64)
    return float((np.abs(got.astype(np.float64) - want) / spacing).max())


def test_lr_schedule_matches_reference():
    for cfg in (AdamConfig(), AdamConfig(warmup_steps=10, total_steps=100),
                AdamConfig(warmup_steps=0, total_steps=1, lr=1e-3)):
        rcfg = RAdamConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 5000, 10000, 20000):
            want = ref_lr_schedule(rcfg, jnp.asarray(step, jnp.int32))
            got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert ulps(got.numpy(), np.asarray(want)) <= 4, (cfg, step)


def test_adam_step_matches_reference_over_several_steps():
    rng = np.random.default_rng(0)
    cfg = AdamConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    rcfg = RAdamConfig(**dataclasses.asdict(cfg))
    p0 = random_tree(rng)
    rp = jax.tree.map(jnp.asarray, p0)
    rs = ref_adam_init(rp)
    pp = jax.tree.map(torch.from_numpy, p0,
                      is_leaf=lambda x: isinstance(x, np.ndarray))
    ps = adam_init(pp)
    for step in range(6):
        # step 3's gradients are clipped (norm > grad_clip = 1)
        g = random_tree(rng, scale=0.5 if step != 3 else 4.0)
        rp, rs, rm = ref_adam_step(rcfg, rp, jax.tree.map(jnp.asarray, g), rs)
        pp, ps, m = adam_step(cfg, pp, jax.tree.map(
            torch.from_numpy, g, is_leaf=lambda x: isinstance(x,
                                                              np.ndarray)), ps)
        assert int(ps.step) == int(rs.step) == step + 1
        assert ulps(m["grad_norm"].numpy(), np.asarray(rm["grad_norm"])) <= 4
        assert ulps(m["lr"].numpy(), np.asarray(rm["lr"])) <= 4
        for got, want in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu)):
            for a, b in zip(leaves(got), jax.tree.leaves(want)):
                assert a.dtype == torch.float32
                assert rel(a.numpy(), np.asarray(b)) <= 1e-6


# ------------------------------------------------------- train trajectory
def test_three_train_steps_match_the_reference_jitted_step():
    """The launcher's optimiser settings (AdamW 3e-4, warmup 10)."""
    rcfg, cfg = both_models("granite-8b")
    rt = RTrainConfig(adam=RAdamConfig(lr=3e-4, warmup_steps=10,
                                       total_steps=10))
    tc = TrainConfig(adam=AdamConfig(lr=3e-4, warmup_steps=10,
                                     total_steps=10))
    rp, ro = ref_init_train_state(rcfg, jax.random.PRNGKey(0), rt)
    ref_step = jax.jit(ref_make_train_step(rcfg, rt))
    params = params_from_numpy(np_tree(rp))
    opt = adam_init(params)
    step = make_train_step(cfg, tc)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=32, batch=4))
    for s in range(3):
        batch = stream.batch(s)
        rp, ro, rm = ref_step(rp, ro, batch)
        params, opt, m = step(params, opt, batch)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(rm[key])) \
                <= 1e-5 * abs(float(rm[key])), key
        assert float(m["lr"]) == float(rm["lr"])
        for got, want in ((params, rp), (opt.mu, ro.mu), (opt.nu, ro.nu)):
            want = list(leaves(params_from_numpy(np_tree(want))))
            for a, b in zip(leaves(got), want):
                assert rel(a.detach(), b) <= 1e-4
