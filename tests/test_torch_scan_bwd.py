"""Port parity: the plain backwards of the two scans (the oracles of the
backward kernels) against autograd and the JAX reference, on the CPU.

``selective_scan_bwd_ref`` (Mamba-1, an explicit reverse scan over chunks
of recomputed states) and ``ssd_scan_bwd_ref`` (Mamba-2, the chunked form)
are held to ``torch.autograd`` of the port's plain forwards and to
``jax.vjp`` of the reference's oracles (``repro/kernels/mamba_scan/ref.py:
selective_scan_ref``, ``repro/kernels/ssd_scan/ref.py:ssd_scan_ref``, both
sequential ``lax.scan``s), every gradient within 2e-4 of its scale (the
kernels' tolerance; both sides f32, sums in other orders). The cases cover
S under, at and over one chunk, ragged S, an initial state, a gradient of
the final state, and every state width (and head width) the kernels are
built for.

The plain SSD backward also takes the bf16 entry's inputs (u, B, C and dy
in bf16, the rest f32): there it is held to ``torch.autograd`` of the plain
forward on the same bf16 tensors, du, dB and dC (bf16, each rounded once)
within one bf16 rounding of the value plus 2e-4 of the scale, the f32
gradients within 2e-4 of their scale (the rule of the bf16 scans on the
card, tests/test_torch_lm_cuda.py).

The autograd functions that carry the kernels on the card
(``SelectiveScanF32``, ``SsdScan``) run here on CPU tensors, where their
wrappers take the plain versions: through a reduced model's ``lm_loss``
they give the plain autograd's gradients (within 1e-4 of each leaf's
scale, the model-level pin), and under both remat levels they
run 3·L − L/G forwards (G layers a group: the group's recompute stops
before its last block) and L backwards a step.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_selective
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import (SelectiveScanF32,
                                            selective_scan_bwd,
                                            selective_scan_bwd_ref,
                                            selective_scan_ref)
from repro_torch.kernels.ssd_scan import (SsdScan, ssd_scan_bwd,
                                          ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.models import init_params, lm_loss
from repro_torch.models import mamba as M
from repro_torch.models.convert import leaves
from repro_torch.models.model import train_step_launches
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 2e-4
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")
BF16_REL = 2.0 ** -7       # one bf16 rounding step, relative to the value
BF16_OUT = ("du", "dB", "dC")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def selective_inputs(B, S, dI, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, dI)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, dI))).astype(np.float32),
            (-rng.random((dI, N)) - 0.1).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(dI).astype(np.float32)]


def ssd_inputs(B, S, H, hp, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hp)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, H))).astype(np.float32),
            (-(0.1 + rng.random(H))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(H).astype(np.float32)]


def extras(rng, y_shape, h_shape, with_h0, with_dh):
    h0 = rng.standard_normal(h_shape).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal(y_shape).astype(np.float32)
    dh = rng.standard_normal(h_shape).astype(np.float32) if with_dh else None
    return h0, dy, dh


def jax_grads(fn, args, h0, dy, dh, h_shape):
    """jax.vjp of the reference oracle at (args, h0) with cotangents (dy,
    dh or zeros): the gradients of the six inputs and of h0 (or None)."""
    def f(*xs):
        return fn(*xs[:6], h0=xs[6] if h0 is not None else None)
    primals = [jnp.asarray(a) for a in args]
    if h0 is not None:
        primals.append(jnp.asarray(h0))
    _, vjp = jax.vjp(f, *primals)
    cot_h = np.zeros(h_shape, np.float32) if dh is None else dh
    got = vjp((jnp.asarray(dy), jnp.asarray(cot_h)))
    return [np.asarray(g) for g in got] + ([None] if h0 is None else [])


def torch_grads(fn, args, h0, dy, dh, **kw):
    """``torch.autograd`` of the port's plain forward."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h0t = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    y, h = fn(*ts, h0=h0t, **kw)
    outs, cots = [y], [torch.from_numpy(dy)]
    if dh is not None:
        outs.append(h)
        cots.append(torch.from_numpy(dh))
    torch.autograd.backward(outs, cots)
    return [t.grad for t in ts] + [None if h0t is None else h0t.grad]


def check(got, want_torch, want_jax):
    for name, g, wt, wj in zip(NAMES, got, want_torch, want_jax):
        if wj is None:
            assert g is None and wt is None, name
            continue
        assert tuple(g.shape) == wj.shape, name
        assert rel(g, wt) <= RTOL, (name, rel(g, wt))
        assert rel(g, wj) <= RTOL, (name, rel(g, wj))


# (B, S, dI, N, h0, dh): S under, at and over the backward kernel's chunk
# of 8 steps (the plain version's default), ragged dI
SELECTIVE_CASES = [(2, 5, 12, N, True, False) for N in (4, 8, 16)] + \
    [(1, 8, 16, N, True, True) for N in (4, 8, 16)] + \
    [(2, 37, 20, N, False, True) for N in (4, 8, 16)] + \
    [(1, 70, 9, 16, False, False)]


@pytest.mark.parametrize("B,S,dI,N,with_h0,with_dh", SELECTIVE_CASES)
def test_selective_scan_bwd_ref_matches_autograd_and_reference(
        B, S, dI, N, with_h0, with_dh):
    args = selective_inputs(B, S, dI, N, seed=S + N)
    h0, dy, dh = extras(np.random.default_rng(S * N), (B, S, dI), (B, dI, N),
                        with_h0, with_dh)
    want_jax = jax_grads(jax_selective, args, h0, dy, dh, (B, dI, N))
    want_torch = torch_grads(selective_scan_ref, args, h0, dy, dh)
    ts = [torch.from_numpy(a) for a in args]
    maybe = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = selective_scan_bwd_ref(*ts, torch.from_numpy(dy), h0=maybe(h0),
                                 dh=maybe(dh))
    check(got, want_torch, want_jax)
    # the wrapper on CPU tensors is the plain version
    again = selective_scan_bwd(*ts, torch.from_numpy(dy), h0=maybe(h0),
                               dh=maybe(dh))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


# (B, S, H, hp, N, chunk, h0, dh): every (N, hp) the kernel takes; S under,
# at and over its chunk of 64, ragged; the plain version's chunk the
# kernel's (64) and the reduced models' (16)
SSD_CASES = [(1, 100, 2, hp, N, 64, (hp + N) % 32 == 0, (hp * N) % 3 == 1)
             for N in (16, 32, 64) for hp in (16, 32, 64)] + [
    (2, 40, 3, 16, 16, 64, True, True),      # S under one chunk
    (1, 64, 2, 32, 16, 64, False, True),     # S one chunk
    (2, 150, 2, 16, 32, 64, True, False),    # ragged over two chunks
    (2, 77, 3, 16, 16, 16, True, True),      # the reduced models' chunk
]


@pytest.mark.parametrize("B,S,H,hp,N,chunk,with_h0,with_dh", SSD_CASES)
def test_ssd_scan_bwd_ref_matches_autograd_and_reference(
        B, S, H, hp, N, chunk, with_h0, with_dh):
    args = ssd_inputs(B, S, H, hp, N, seed=S + N + hp)
    h0, dy, dh = extras(np.random.default_rng(S * N + hp), (B, S, H, hp),
                        (B, H, N, hp), with_h0, with_dh)
    want_jax = jax_grads(jax_ssd, args, h0, dy, dh, (B, H, N, hp))
    want_torch = torch_grads(ssd_scan_ref, args, h0, dy, dh, chunk=chunk)
    ts = [torch.from_numpy(a) for a in args]
    maybe = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = ssd_scan_bwd_ref(*ts, torch.from_numpy(dy), chunk=chunk,
                           h0=maybe(h0), dh=maybe(dh))
    check(got, want_torch, want_jax)
    again = ssd_scan_bwd(*ts, torch.from_numpy(dy), chunk=chunk,
                         h0=maybe(h0), dh=maybe(dh))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_ssd_scan_bwd_ref_stays_finite_where_exp_of_minus_l_overflows():
    """A strong decay (dt·A ≈ −3 a step, L ≈ −190 at the end of a chunk of
    64): exp(−L) overflows f32, the differences of L that the backward
    forms do not. Every gradient finite and within tolerance of
    autograd."""
    args = ssd_inputs(1, 128, 2, 16, 16, seed=5)
    args[1] = np.full_like(args[1], 1.5)
    args[2] = np.full_like(args[2], -2.0)
    dy = np.random.default_rng(6).standard_normal(args[0].shape).astype(
        np.float32)
    want = torch_grads(ssd_scan_ref, args, None, dy, None, chunk=64)
    got = ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                           torch.from_numpy(dy), chunk=64)
    for name, g, w in zip(NAMES, got[:6], want[:6]):
        assert bool(torch.isfinite(g).all()), name
        assert rel(g, w) <= RTOL, name


def within_bf16_rounding(got, want, rtol=RTOL) -> float:
    """max(|got − want| − 2^-7 |want|) over the scale of ``want``: at most
    ``rtol`` for two f32 values within rtol of the scale, each rounded to
    bf16 once."""
    got, want = got.double(), want.double()
    scale = max(float(want.abs().max()), 1e-30)
    return float(((got - want).abs() - BF16_REL * want.abs()).max()) / scale


def check_bf16(got, want):
    """The bf16 entry's gradients against another computation of them: du,
    dB and dC bf16 within one rounding plus ``RTOL`` of scale, the rest
    f32 within ``RTOL``."""
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype == (torch.bfloat16 if name in BF16_OUT
                                      else torch.float32), (name, g.dtype)
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = (within_bf16_rounding(g, w) if name in BF16_OUT
               else rel(g, w))
        assert err <= RTOL, (name, err)


def bf16_stream(ts):
    """The SSD inputs as the bf16 entry takes them: u, B and C bf16."""
    ts = list(ts)
    for i in (0, 3, 4):
        ts[i] = ts[i].bfloat16()
    return ts


# (B, S, H, hp, N, chunk, h0, dh): ragged over three chunks, zamba2's
# widths at one chunk, under a chunk at the reduced models' chunk
SSD_BF16_CASES = [(2, 150, 3, 16, 32, 64, True, True),
                  (1, 64, 2, 64, 64, 64, False, True),
                  (2, 40, 3, 16, 16, 16, True, False)]


@pytest.mark.parametrize("B,S,H,hp,N,chunk,with_h0,with_dh", SSD_BF16_CASES)
def test_bf16_ssd_scan_bwd_ref_matches_bf16_autograd(B, S, H, hp, N, chunk,
                                                     with_h0, with_dh):
    """``ssd_scan_bwd_ref`` on bf16 u, B, C and dy against autograd of
    ``ssd_scan_ref`` on the same bf16 tensors (its y bf16, its casts
    rounding each input's gradient once); the wrapper on CPU tensors is the
    plain version."""
    args = ssd_inputs(B, S, H, hp, N, seed=S + N + hp + 1)
    h0, dy, dh = extras(np.random.default_rng(S * N + hp + 1), (B, S, H, hp),
                        (B, H, N, hp), with_h0, with_dh)
    maybe = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ts = bf16_stream(torch.from_numpy(a) for a in args)
    dyb = torch.from_numpy(dy).bfloat16()
    ins = [t.clone().requires_grad_(True)
           for t in (*ts, *(() if h0 is None else (maybe(h0),)))]
    y, h = ssd_scan_ref(*ins[:6], chunk=chunk,
                        h0=ins[6] if h0 is not None else None)
    assert y.dtype == torch.bfloat16
    outs, cots = [y], [dyb]
    if dh is not None:
        outs.append(h)
        cots.append(maybe(dh))
    want = list(torch.autograd.grad(outs, ins, cots)) + (
        [None] if h0 is None else [])
    got = ssd_scan_bwd_ref(*ts, dyb, chunk=chunk, h0=maybe(h0), dh=maybe(dh))
    check_bf16(got, want)
    again = ssd_scan_bwd(*ts, dyb, chunk=chunk, h0=maybe(h0), dh=maybe(dh))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_ssd_autograd_function_on_cpu_bf16_tensors():
    """``SsdScan`` on the bf16 entry's CPU tensors (the plain versions)
    against autograd of the plain forward, with an initial state and a
    loss on both outputs: the same dtypes, within the bf16 rule."""
    args = ssd_inputs(2, 70, 3, 16, 16, seed=2)
    h0 = np.random.default_rng(3).standard_normal((2, 3, 16, 16)).astype(
        np.float32)
    grads = []
    for run in ("function", "plain"):
        ts = [t.requires_grad_(True) for t in bf16_stream(
            torch.from_numpy(a) for a in (*args, h0))]
        if run == "function":
            y, h = SsdScan.apply(*ts, 16)
        else:
            y, h = ssd_scan_ref(*ts[:6], chunk=16, h0=ts[6])
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        ((y.float() ** 2).sum() + (h * h.detach()).sum()).backward()
        grads.append([t.grad for t in ts])
    check_bf16(grads[0], grads[1])


@pytest.mark.parametrize("fn,args,kw", [
    (SelectiveScanF32, selective_inputs(2, 21, 12, 8, seed=1), ()),
    (SsdScan, ssd_inputs(2, 70, 3, 16, 16, seed=2), (16,)),
])
def test_autograd_functions_on_cpu_tensors_match_plain_autograd(fn, args,
                                                                kw):
    """The autograd functions with their wrappers' plain versions (CPU
    tensors): the same gradients as autograd of the plain forward, with an
    initial state and a loss on both outputs."""
    plain = selective_scan_ref if fn is SelectiveScanF32 else (
        lambda *a, h0: ssd_scan_ref(*a, chunk=16, h0=h0))
    rng = np.random.default_rng(3)
    h_shape = ((args[0].shape[0], args[0].shape[2], args[2].shape[1])
               if fn is SelectiveScanF32 else
               (args[0].shape[0], args[0].shape[2], args[3].shape[2],
                args[0].shape[3]))
    h0 = rng.standard_normal(h_shape).astype(np.float32)
    grads = []
    for run in ("function", "plain"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (*args, h0)]
        if run == "function":
            y, h = fn.apply(*ts, *kw)
        else:
            y, h = plain(*ts[:6], h0=ts[6])
        ((y ** 2).sum() + (h * h.detach()).sum()).backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert rel(a, b) <= 1e-5


def through_functions(monkeypatch):
    """Route the models' scans through the autograd functions (as on the
    card), counting each function's forwards and backwards."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(cls, chunked):
        class Counted(cls):
            @staticmethod
            def forward(ctx, *a):
                calls["fwd"] += 1
                return cls.forward(ctx, *a)

            @staticmethod
            def backward(ctx, *g):
                calls["bwd"] += 1
                return cls.backward(ctx, *g)

        def op(u, dt, A, Bm, Cm, D, *, chunk=None, h0=None):
            args = [t.contiguous() for t in (u, dt, A, Bm, Cm, D)]
            return Counted.apply(*args, h0, *((chunk,) if chunked else ()))
        return op

    monkeypatch.setattr(M, "selective_scan_op",
                        counted(SelectiveScanF32, False))
    monkeypatch.setattr(M, "ssd_scan_op", counted(SsdScan, True))
    return calls


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "falcon-mamba-7b"])
def test_model_gradients_through_the_functions_and_remat_counts(
        monkeypatch, arch):
    """A reduced model's ``lm_loss`` gradients with the scans through the
    autograd functions (the card's route) equal the plain autograd's within
    1e-4 of each leaf's scale (the model-level pin of
    tests/test_torch_lm_train.py: the explicit backward sums in other
    orders, and a small leaf such as dt_bias sums 2·S·H terms), under both
    remat levels; the functions run
    3·L − L/G forwards (2·L with one level) and L backwards a step."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 41)).astype(np.int64))
    ps = list(leaves(params))
    for p in ps:
        p.requires_grad_(True)

    def grads(c):
        loss, _ = lm_loss(params, c, toks[:, :-1], toks[:, 1:])
        return torch.autograd.grad(loss, ps)

    for block_remat in (True, False):
        c = dataclasses.replace(cfg, block_remat=block_remat)
        want = grads(c)
        with monkeypatch.context() as mp:
            calls = through_functions(mp)
            got = grads(c)
        for a, b in zip(got, want):
            assert rel(a, b) <= 1e-4
        launches = train_step_launches(c)
        assert calls == {
            "fwd": launches["selective_scan"] + launches["ssd_scan"],
            "bwd": c.n_layers}, (block_remat, calls)
        assert calls["bwd"] == (launches["selective_scan_bwd"]
                                + launches["ssd_scan_bwd"])
