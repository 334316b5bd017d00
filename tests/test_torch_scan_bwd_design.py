"""The decompositions of the scans' backward kernels, emulated on the CPU in
plain PyTorch (no card here; the kernels themselves are held on the card by
tests/test_torch_lm_cuda.py and chip_smoke.py phase 16b).

``ssd_scan_bwd`` (src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu)
runs in two kernels: a short pass a (batch, head) that carries the state
entering each chunk (H_in) forwards and the adjoint of the state leaving
each chunk (dH) backwards, both to scratch; then one CTA a (batch, head,
chunk), all chunks at once, that forms every other gradient of its chunk
from its own tiles and those two states. ``ssd_bwd_chunk_parallel`` below
is that algorithm with a pluggable product: exact, or split-TF32 as the
kernel's ``mma.sync`` takes it (each f32 operand as a TF32 "big" part, its
low 13 bits cut, and the TF32 part of the rest; three products a step,
small·big + big·small + big·big), or one TF32 product (big·big). It is
held against the port's plain backward ``ssd_scan_bwd_ref``, against
``jax.vjp`` of the reference's oracle (``repro/kernels/ssd_scan/ref.py``)
and, through a whole Mamba-2 layer, against ``jax.vjp`` of the reference's
chunked SSD (``repro/models/mamba.py:mamba2_forward``); the split keeps
every gradient within 2e-4 of its scale (``SCAN_BWD_RTOL``) at zamba2's
widths, the one-product form does not. The bf16 entry
(``ssd_scan_bwd_bf16``) runs the same form on bf16 stream tensors widened
to f32: emulated with its one rounding of du, dB and dC, it stays within
one bf16 rounding plus 2e-4 of scale of the plain backward on the same
bf16 tensors.

``selective_scan_bwd`` (csrc/selective_scan_bwd.cu) sums the dB and dC
terms over a warp's channels in registers: a reduce-scatter over the lanes
of a state group (lanes cl and cl ^ h swap halves of their 2·SPT terms,
h = SPT, …, 1), then butterflies over the rest of the warp's channels, then
the CTA's four warp partials in a fixed order, then the CTAs' partials by
``torch.sum``. ``lane_reduce_scatter`` plays the kernel's shuffles lane by
lane; the backward with its sums in that order is held against
``selective_scan_bwd_ref``.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd
from repro.models import mamba as RM
from repro_torch.kernels.mamba_scan import selective_scan_bwd_ref
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.models import mamba as PM
from torch_threads import one_torch_thread  # noqa: F401

SCAN_BWD_RTOL = 2e-4      # chip_smoke.py phase 16b, tests/test_torch_lm_cuda.py
QC = 64                   # the kernels' chunk (ssd_scan_bwd_chunk)
LOG2E = 1.4426950408889634
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# ------------------------------------------------------------- the products
def tf32(x):
    """x with its low 13 mantissa bits cut: what the tensor cores read of a
    TF32 operand."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def mm_exact(a, b):
    return a @ b


def mm_split3(a, b):
    """a @ b as the kernel's mma.sync forms it: each 8-deep step three TF32
    products (small·big, big·small, big·big), each exact, added to the f32
    accumulator in that order."""
    ab = tf32(a)
    as_ = tf32(a - ab)
    bb = tf32(b)
    bs = tf32(b - bb)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        sl = slice(k, k + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = (acc.double() + x[..., sl].double() @ y[..., sl, :].double()
                   ).float()
    return acc


def mm_single(a, b):
    """One TF32 product (big·big): the split's control."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    ab, bb = tf32(a), tf32(b)
    for k in range(0, a.shape[-1], 8):
        sl = slice(k, k + 8)
        acc = (acc.double() + ab[..., sl].double() @ bb[..., sl, :].double()
               ).float()
    return acc


PRODUCTS = {"exact": mm_exact, "split3": mm_split3, "single": mm_single}


# ------------------------------------------------- the SSD backward, emulated
def ssd_bwd_chunk_parallel(u, dt, A, Bm, Cm, D, dy, *, h0=None, dh=None,
                           mm=mm_exact, Q=QC):
    """The gradients of ``ssd_scan(u, dt, A, Bm, Cm, D, h0=h0)`` as
    ssd_scan_bwd.cu forms them (log-decays in base 2, the per-head scalar
    sums in float64, dA and dD one partial a (batch, head, chunk), dB and
    dC one a head), in the inputs' dtype; ``mm`` takes every product."""
    dtype = u.dtype
    f64 = torch.float64
    B_, S, H, hp = u.shape
    N = Bm.shape[-1]
    T = -(-S // Q)
    pad = T * Q - S

    def chunks(a):          # (B, S, ...) -> (B, T, Q, ...), zeros past S
        a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape((B_, T, Q) + tuple(a.shape[2:]))

    uc = chunks(u).permute(0, 3, 1, 2, 4)                   # (B,H,T,Q,hp)
    dyc = chunks(dy).permute(0, 3, 1, 2, 4)
    dtc = chunks(dt).permute(0, 3, 1, 2)                    # (B,H,T,Q)
    bc = chunks(Bm)[:, None].expand(B_, H, T, Q, N)
    cc = chunks(Cm)[:, None].expand(B_, H, T, Q, N)
    L2 = torch.cumsum(dtc * (A * LOG2E)[None, :, None, None], dim=-1)
    EL = torch.exp2(L2)                                     # e^{L_t}
    DEC = torch.exp2(L2[..., -1:] - L2)                     # e^{L_Q - L_s}
    WS = DEC * dtc
    eEnd = EL[..., -1]                                      # (B,H,T)
    tr = lambda x: x.transpose(-1, -2)                      # noqa: E731

    # pass 1: the states entering each chunk, forwards
    zero = torch.zeros((B_, H, N, hp), dtype=dtype)
    state = zero if h0 is None else h0
    hin = []
    for c in range(T):
        hin.append(state)
        if c < T - 1:
            state = eEnd[:, :, c, None, None] * state + mm(
                tr(bc[:, :, c] * WS[:, :, c, :, None]), uc[:, :, c])
    # ... and the adjoints of the states leaving each chunk, backwards
    g = zero if dh is None else dh
    dho = [None] * T
    for c in reversed(range(T)):
        dho[c] = g
        if c > 0 or h0 is not None:
            g = eEnd[:, :, c, None, None] * g + mm(
                tr(cc[:, :, c] * EL[:, :, c, :, None]), dyc[:, :, c])
    hin, dho = torch.stack(hin, 2), torch.stack(dho, 2)     # (B,H,T,N,hp)

    # pass 2: every chunk alone, rows s and columns t of the Q x Q products
    St = mm(bc, tr(cc))                                     # (C Bᵀ)ᵀ
    DYUt = mm(uc, tr(dyc))                                  # (dy uᵀ)ᵀ
    idx = torch.arange(Q)
    causal = idx[None, :] >= idx[:, None]                   # t >= s
    Wt = torch.where(causal, torch.exp2(L2[..., None, :] - L2[..., :, None]),
                     torch.zeros((), dtype=dtype))
    wd = Wt * dtc[..., :, None]
    Mt, Gt = St * wd, DYUt * wd
    Yt = (DYUt * St) * Wt
    colY = Yt.to(f64).sum(-1)                               # Σ_t, by s
    rowY = (Yt.to(f64) * dtc.to(f64)[..., :, None]).sum(-2)   # Σ_s, by t
    du = WS[..., None] * mm(bc, dho) + mm(Mt, dyc)
    R = mm(uc, tr(dho))                                     # u dHᵀ
    z = DEC.to(f64) * (bc.to(f64) * R.to(f64)).sum(-1)
    dB = WS[..., None] * R + mm(Gt, cc)
    V = mm(dyc, tr(hin))                                    # dy H_inᵀ
    cv = (cc.to(f64) * V.to(f64)).sum(-1)
    dC = EL[..., None] * V + mm(tr(Gt), bc)
    dot = (dho.to(f64) * hin.to(f64)).sum((-1, -2))
    d64 = dtc.to(f64)
    dL = rowY - d64 * colY + EL.to(f64) * cv - d64 * z
    dL[..., -1] += eEnd.to(f64) * dot + (d64 * z).sum(-1)
    dla = torch.flip(torch.cumsum(torch.flip(dL, (-1,)), -1), (-1,))
    ddt = (colY + z + A.to(f64)[None, :, None, None] * dla).to(dtype)
    dA_part = (d64 * dla).sum(-1).to(dtype)                 # (B,H,T)
    dD_part = (dyc.to(f64) * uc.to(f64)).sum((-1, -2)).to(dtype)

    def unchunk(a):         # (B,H,T,Q,...) -> (B,S,H,...)
        a = a.reshape((B_, H, T * Q) + tuple(a.shape[4:]))[:, :, :S]
        return a.transpose(1, 2)

    du = unchunk(du) + D[None, None, :, None] * dy
    return (du, unchunk(ddt), dA_part.sum((0, 2)),
            unchunk(dB).sum(2), unchunk(dC).sum(2), dD_part.sum((0, 2)),
            None if h0 is None else g)


def ssd_arrays(B, S, H, hp, N, seed, decay="phase16b"):
    """Inputs from a seed: phase 16b's (chip_smoke.ssd_inputs: dt in
    [0.05, 0.15], A in [-1.1, -0.1]) or zamba2's at initialisation (A =
    -linspace(1, 16, H), dt = softplus of a unit normal)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, H, hp))
    if decay == "phase16b":
        dt = 0.05 + 0.1 * rng.random((B, S, H))
        A = -(0.1 + rng.random(H))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        A = -np.linspace(1.0, 16.0, H)
    arrs = [u, dt, A, rng.standard_normal((B, S, N)),
            rng.standard_normal((B, S, N)), rng.random(H),
            rng.standard_normal((B, S, H, hp)),
            rng.standard_normal((B, H, N, hp)),
            rng.standard_normal((B, H, N, hp))]
    return [a.astype(np.float32) for a in arrs]


def jax_ssd_grads(arrs, with_h0, with_dh):
    """jax.vjp of the reference's oracle: the six inputs' gradients and
    h0's (or None)."""
    u, dt, A, Bm, Cm, D, dy, h0, dh = arrs

    def f(*xs):
        return jax_ssd(*xs[:6], h0=xs[6] if with_h0 else None)
    primals = [jnp.asarray(a) for a in (u, dt, A, Bm, Cm, D)]
    if with_h0:
        primals.append(jnp.asarray(h0))
    _, vjp = jax.vjp(f, *primals)
    got = vjp((jnp.asarray(dy), jnp.asarray(dh if with_dh else
                                            np.zeros_like(dh))))
    return [np.asarray(x) for x in got] + ([] if with_h0 else [None])


# (B, S, H, hp, N, h0, dh): reduced and ragged, under, at and over a chunk
SSD_CASES = [
    (2, 150, 3, 16, 32, True, True),      # ragged over three chunks
    (1, 40, 2, 32, 16, True, False),      # under one chunk
    (2, 64, 2, 16, 16, False, True),      # one chunk
    (1, 300, 2, 64, 64, True, True),      # zamba2's widths, five chunks
    (2, 257, 2, 32, 64, False, False),    # one step into a fifth chunk
]


@pytest.mark.parametrize("B,S,H,hp,N,with_h0,with_dh", SSD_CASES)
def test_ssd_chunk_parallel_form_matches_plain_and_reference(
        B, S, H, hp, N, with_h0, with_dh):
    """The two-pass, chunk-parallel form (exact products, f32) against the
    port's plain backward and jax.vjp of the reference's oracle."""
    arrs = ssd_arrays(B, S, H, hp, N, seed=S + hp + N)
    ts = [torch.from_numpy(a) for a in arrs]
    h0 = ts[7] if with_h0 else None
    dh = ts[8] if with_dh else None
    got = ssd_bwd_chunk_parallel(*ts[:7], h0=h0, dh=dh)
    plain = ssd_scan_bwd_ref(*ts[:7], chunk=QC, h0=h0, dh=dh)
    ref = jax_ssd_grads(arrs, with_h0, with_dh)
    for name, a, p, r in zip(NAMES, got, plain, ref):
        if r is None:
            assert a is None and p is None, name
            continue
        assert tuple(a.shape) == r.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert rel(a, p) <= SCAN_BWD_RTOL, (name, rel(a, p))
        assert rel(a, r) <= SCAN_BWD_RTOL, (name, rel(a, r))


def f64_oracle(ts, h0, dh):
    """The same form in float64 with exact products."""
    d = [t.double() for t in ts[:7]]
    return ssd_bwd_chunk_parallel(
        *d, h0=None if h0 is None else h0.double(),
        dh=None if dh is None else dh.double())


def split_errors(case, product):
    (B, S, H, hp, N, decay) = case
    arrs = ssd_arrays(B, S, H, hp, N, seed=7 * S + H, decay=decay)
    ts = [torch.from_numpy(a) for a in arrs]
    want = f64_oracle(ts, ts[7], ts[8])
    got = ssd_bwd_chunk_parallel(*ts[:7], h0=ts[7], dh=ts[8],
                                 mm=PRODUCTS[product])
    return {n: rel(a, w) for n, a, w in zip(NAMES, got, want)}


# zamba2's widths (hp = N = 64), cut in length: phase 16b's inputs and
# zamba2's decays at initialisation (A to -16, dt ~ softplus)
SPLIT_CASES = [(1, 256, 2, 64, 64, "phase16b"), (1, 200, 4, 64, 64, "zamba2"),
               (2, 100, 2, 64, 64, "phase16b")]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"S{c[1]}-{c[5]}" for c in SPLIT_CASES])
def test_split_tf32_keeps_every_ssd_gradient_within_rtol(case):
    """The kernel's choice: split-TF32 products, three a step."""
    errs = split_errors(case, "split3")
    print(case, "split3:", {n: f"{e:.3g}" for n, e in errs.items()})
    assert all(math.isfinite(e) for e in errs.values())
    assert max(errs.values()) <= SCAN_BWD_RTOL, errs


@pytest.mark.parametrize("case", SPLIT_CASES[:2],
                         ids=[f"S{c[1]}-{c[5]}" for c in SPLIT_CASES[:2]])
def test_one_tf32_product_fails_rtol(case):
    """One TF32 product a step (each operand's low 13 bits cut) lands
    above SCAN_BWD_RTOL: the margin the design keeps is the split."""
    errs = split_errors(case, "single")
    print(case, "single:", {n: f"{e:.3g}" for n, e in errs.items()})
    assert max(errs.values()) > SCAN_BWD_RTOL, errs


class ChunkParallelSsd(torch.autograd.Function):
    """The plain forward, the chunk-parallel backward (exact products)."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D, h0):
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, h0)
        return ssd_scan_ref(u, dt, A, Bm, Cm, D, chunk=QC, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, A, Bm, Cm, D, h0 = ctx.saved_tensors
        return ssd_bwd_chunk_parallel(u, dt, A, Bm, Cm, D, dy.contiguous(),
                                      h0=h0, dh=dh)


@pytest.mark.parametrize("S,d_model,N,hp", [(150, 64, 16, 32),
                                            (70, 128, 64, 64)])
def test_mamba2_layer_gradients_through_the_chunk_parallel_form(
        monkeypatch, S, d_model, N, hp):
    """A Mamba-2 layer with an entering state, the port's SSD backward
    replaced by the chunk-parallel form: the gradients of every parameter,
    the input and the state against jax.vjp of the reference's chunked SSD
    layer (``mamba2_forward``, chunk 64), each within SCAN_BWD_RTOL of its
    scale."""
    rng = np.random.default_rng(S + N)
    B_, K = 2, 4
    dI = 2 * d_model
    H = dI // hp
    conv_dim = dI + 2 * N
    p = {"in_proj": rng.standard_normal((d_model, 2 * dI + 2 * N + H))
         / math.sqrt(d_model),
         "conv_w": 0.5 * rng.standard_normal((K, conv_dim)),
         "conv_b": 0.1 * rng.standard_normal(conv_dim),
         "dt_bias": 0.1 * rng.standard_normal(H),
         "A_log": np.log(np.linspace(1.0, 16.0, H)),
         "D": 1.0 + 0.1 * rng.standard_normal(H),
         "norm": 1.0 + 0.1 * rng.standard_normal(dI),
         "out_proj": rng.standard_normal((dI, d_model)) / math.sqrt(dI)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B_, S, d_model)).astype(np.float32)
    conv = rng.standard_normal((B_, K - 1, conv_dim)).astype(np.float32)
    ssm = rng.standard_normal((B_, H, hp, N)).astype(np.float32)
    cot = rng.standard_normal((B_, S, d_model)).astype(np.float32)
    kw = dict(d_state=N, headdim=hp, chunk=QC)

    def ref(pp, xx, ss):
        out, _ = RM.mamba2_forward(pp, xx, state=RM.Mamba2State(
            jnp.asarray(conv), ss), **kw)
        return out
    _, vjp = jax.vjp(ref, {k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), jnp.asarray(ssm))
    want_p, want_x, want_s = vjp(jnp.asarray(cot))

    def op(u, dt, A, Bm, Cm, D, *, chunk=None, h0=None):
        return ChunkParallelSsd.apply(*(t.contiguous() for t in
                                        (u, dt, A, Bm, Cm, D)), h0)
    monkeypatch.setattr(PM, "ssd_scan_op", op)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(ssm).requires_grad_(True)
    out, _ = PM.mamba2_forward(tp, tx, state=PM.Mamba2State(
        torch.from_numpy(conv), ts), **kw)
    out.backward(torch.from_numpy(cot))
    for k in p:
        assert rel(tp[k].grad, want_p[k]) <= SCAN_BWD_RTOL, k
    assert rel(tx.grad, want_x) <= SCAN_BWD_RTOL
    assert rel(ts.grad, want_s) <= SCAN_BWD_RTOL


# ------------------------------------ the SSD backward's bf16 entry, emulated
BF16_REL = 2.0 ** -7       # one bf16 rounding step, relative to the value


def test_widened_bf16_is_its_own_tf32_part():
    """A bf16 value widened to f32 has 8 significant bits, within TF32's
    11: the split's small part is 0, so the bf16 entry's products of two
    stream tiles (B Cᵀ, u dyᵀ) are exact in the first pass."""
    x = torch.randn(4096).bfloat16().float()
    assert torch.equal(tf32(x), x)
    assert not bool(tf32(x - tf32(x)).any())


@pytest.mark.parametrize("B,S,H,hp,N,with_h0,with_dh", [
    (1, 300, 2, 64, 64, True, True),      # zamba2's widths, five chunks
    (2, 150, 3, 16, 32, False, True),     # ragged over three chunks
])
def test_bf16_entry_split_tf32_and_one_rounding_within_the_bf16_rule(
        B, S, H, hp, N, with_h0, with_dh):
    """``ssd_scan_bwd_bf16``'s arithmetic: u, B, C and dy bf16 widened to
    f32, the f32 entry's split-TF32 products and f64 sums, du rounded to
    bf16 once, dB and dC summed over heads in f32 and only then rounded.
    Against the plain backward on the same bf16 tensors: du, dB and dC
    within one bf16 rounding plus 2e-4 of scale, the f32 gradients within
    2e-4 of scale."""
    arrs = ssd_arrays(B, S, H, hp, N, seed=S + hp)
    ts = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4, 6):                  # u, B, C, dy
        ts[i] = ts[i].bfloat16()
    h0 = ts[7] if with_h0 else None
    dh = ts[8] if with_dh else None
    got = list(ssd_bwd_chunk_parallel(*(t.float() for t in ts[:7]), h0=h0,
                                      dh=dh, mm=mm_split3))
    for i in (0, 3, 4):                     # du, dB, dC: rounded once
        got[i] = got[i].bfloat16()
    want = ssd_scan_bwd_ref(*ts[:7], chunk=QC, h0=h0, dh=dh)
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
            continue
        assert a.dtype == w.dtype, name
        a, w = a.double(), w.double()
        scale = max(float(w.abs().max()), 1e-30)
        slack = BF16_REL * w.abs() if name in ("du", "dB", "dC") else 0.0
        err = float(((a - w).abs() - slack).max()) / scale
        assert err <= SCAN_BWD_RTOL, (name, err)


# --------------------------------------- the selective backward's channel sums
def selective_tile(N):
    """(states a lane SPT, lanes a channel L, channels a warp M, a lane's
    terms V) as selective_scan_bwd.cu's Tile<N>."""
    SPT = N if N < 8 else 8
    L = N // SPT
    return SPT, L, 32 // L, 2 * SPT


def lane_reduce_scatter(vals, N):
    """The kernel's shuffles, lane by lane: vals (32, V) float32, lane
    ``cl·L + g``'s dB terms then dC terms of its SPT states. Returns (32,)
    float32: what each lane holds after them."""
    _, L, M, V = selective_tile(N)
    vals = vals.astype(np.float32).copy()
    lanes = np.arange(32)
    cl = lanes // L
    hh = V // 2
    while hh >= 1:
        upper = (cl & hh) != 0
        for i in range(hh):
            send = np.where(upper, vals[:, i], vals[:, i + hh])
            keep = np.where(upper, vals[:, i + hh], vals[:, i])
            vals[:, i] = keep + send[lanes ^ (hh * L)]
        hh //= 2
    out = vals[:, 0].copy()
    o = V
    while o < M:
        out = out + out[lanes ^ (o * L)]
        o *= 2
    return out


def warp_order_sum(x, N):
    """Σ over the last axis (a warp's M channels) in the kernel's order:
    pairs of channels apart by V/2, …, 1 (the reduce-scatter), then by V,
    …, M/2 (the butterflies)."""
    _, _, M, V = selective_tile(N)
    bits = [V >> (i + 1) for i in range(int(math.log2(V)))] + \
        [V << i for i in range(int(math.log2(M // V)))]
    # the channel axis as one axis a bit, the most significant first
    left = [M >> (i + 1) for i in range(int(math.log2(M)))]
    x = x.reshape(x.shape[:-1] + (2,) * len(left))
    for b in bits:
        axis = x.dim() - len(left) + left.index(b)
        x = x.select(axis, 0) + x.select(axis, 1)
        left.remove(b)
    return x


@pytest.mark.parametrize("N", [4, 8, 16])
def test_lane_reduce_scatter_leaves_each_term_summed_once(N):
    """After the shuffles lane cl·L + g (cl < V) holds the warp's sum of
    term cl of state group g, bit for bit the pairwise order of
    ``warp_order_sum``; every (kind, state) of the 2N is held by one
    writing lane."""
    SPT, L, M, V = selective_tile(N)
    rng = np.random.default_rng(N)
    vals = rng.standard_normal((32, V)).astype(np.float32)
    got = lane_reduce_scatter(vals, N)
    seen = set()
    for lane in range(32):
        cl, g = lane // L, lane % L
        if cl >= V:
            continue
        terms = torch.from_numpy(vals[g::L, cl].copy())   # (M,) channels
        want = warp_order_sum(terms, N)
        assert got[lane] == float(want), (lane, got[lane], float(want))
        assert abs(got[lane] - vals[g::L, cl].astype(np.float64).sum()) <= \
            1e-5 * np.abs(vals).sum()
        seen.add((cl // SPT, g * SPT + cl % SPT))
    assert seen == {(k, n) for k in (0, 1) for n in range(N)}


def selective_bwd_kernel_order(u, dt, A, Bm, Cm, D, dy, *, h0=None, dh=None,
                               nt=128, nwarp=4):
    """selective_scan_bwd_ref's arithmetic with dB and dC summed over
    channels as the kernel sums them: within a warp in ``warp_order_sum``'s
    order, the CTA's warps in order, the CTAs by torch.sum."""
    B_, S, dI = u.shape
    N = A.shape[1]
    SPT, L, M, V = selective_tile(N)
    CH = nt // L
    G = -(-dI // CH)
    f32 = torch.float32
    h = torch.zeros((B_, dI, N), dtype=f32) if h0 is None else h0
    hs = [h]
    for t in range(S):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :])
        hs.append(h)

    def channel_sum(x):       # (B, dI, N) -> (B, N), the kernel's order
        x = torch.nn.functional.pad(x, (0, 0, 0, G * CH - dI))
        x = x.reshape(B_, G, nwarp, M, N).permute(0, 1, 2, 4, 3)
        w = warp_order_sum(x, N)                       # (B, G, nwarp, N)
        s = w[:, :, 0]
        for i in range(1, nwarp):
            s = s + w[:, :, i]
        return s.sum(1)

    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    gc = torch.zeros((B_, dI, N), dtype=f32) if dh is None else dh
    for t in reversed(range(S)):
        a = torch.exp(dt[:, t, :, None] * A)
        g = gc + dy[:, t, :, None] * Cm[:, t, None, :]
        du[:, t] = dt[:, t] * (g * Bm[:, t, None, :]).sum(-1) + D * dy[:, t]
        ddt[:, t] = (g * (A * a * hs[t] + u[:, t, :, None]
                          * Bm[:, t, None, :])).sum(-1)
        dA += (g * dt[:, t, :, None] * a * hs[t]).sum(0)
        dB[:, t] = channel_sum(g * (dt[:, t] * u[:, t])[:, :, None])
        dC[:, t] = channel_sum(dy[:, t, :, None] * hs[t + 1])
        gc = a * g
    dD = (dy * u).sum((0, 1))
    return du, ddt, dA, dB, dC, dD, (None if h0 is None else gc)


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,S,dI,with_h0,with_dh", [
    (2, 37, 150, True, True),        # two CTAs at N 16, ragged dI
    (1, 9, 300, False, True),        # three CTAs at N 4 and 8
])
def test_selective_kernel_order_of_sums_matches_plain(N, B, S, dI, with_h0,
                                                      with_dh):
    """The backward with its cross-channel sums in the kernel's order
    against selective_scan_bwd_ref, every gradient within SCAN_BWD_RTOL."""
    rng = np.random.default_rng(N + S)
    arrs = [rng.standard_normal((B, S, dI)),
            0.05 + 0.1 * rng.random((B, S, dI)),
            -rng.random((dI, N)) - 0.1,
            rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
            rng.random(dI), rng.standard_normal((B, S, dI)),
            rng.standard_normal((B, dI, N)), rng.standard_normal((B, dI, N))]
    ts = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    h0 = ts[7] if with_h0 else None
    dh = ts[8] if with_dh else None
    got = selective_bwd_kernel_order(*ts[:7], h0=h0, dh=dh)
    want = selective_scan_bwd_ref(*ts[:7], h0=h0, dh=dh)
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
            continue
        assert rel(a, w) <= SCAN_BWD_RTOL, (name, rel(a, w))
