"""Port parity: the ssd_scan and flash_attention kernels' plain versions and
wrappers.

The plain PyTorch versions (``repro_torch.kernels.{ssd_scan,flash_attention}
.ref``) are held against the reference's Pallas kernels run in interpret
mode and against the reference's oracles, on the shapes of
tests/test_kernel_ssd_scan.py and tests/test_kernel_flash_attention.py and
at their tolerance, rtol = atol = 2e-4 (f32; the two sum in different
orders: the chunked einsum form here, a sequential scan or XLA's dot there).

The wrappers launch the CUDA kernels only for CUDA tensors; the tests that
need a card are in tests/test_torch_lm_cuda.py.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ssd_scan import ssd_scan as ref_ssd
from repro.kernels.ssd_scan import ssd_scan_ref as ref_ssd_oracle
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ssd_scan
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_lm_cuda import TOL, qkv_inputs, ssd_inputs, tt


# --------------------------------------------------------------- ssd_scan
@pytest.mark.parametrize("B,S,H,hp,N,chunk", [
    (1, 32, 2, 8, 4, 8),
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (1, 64, 3, 8, 4, 64),     # single chunk
])
def test_plain_ssd_matches_reference_kernel(B, S, H, hp, N, chunk):
    args = ssd_inputs(B, S, H, hp, N, seed=S + H)
    y_k, h_k = ref_ssd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    y_o, h_o = ref_ssd_oracle(*map(jnp.asarray, args))
    n0 = SK.ssd_scan.launches
    y, h = ssd_scan(*tt(args), chunk=chunk)
    assert SK.ssd_scan.launches == n0          # the CPU path launches nothing
    assert y.shape == (B, S, H, hp) and h.shape == (B, H, N, hp)
    for want_y, want_h in ((y_k, h_k), (y_o, h_o)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_plain_ssd_ragged_length_and_initial_state():
    """S not a multiple of the chunk (zero padding inside) and a given h0,
    against the reference's sequential oracle, which takes h0 too."""
    args = ssd_inputs(2, 50, 3, 16, 8, seed=4)
    h0 = np.random.default_rng(5).standard_normal((2, 3, 8, 16)).astype(
        np.float32)
    y_o, h_o = ref_ssd_oracle(*map(jnp.asarray, args), h0=jnp.asarray(h0))
    for chunk in (16, 7, 64):
        y, h = ssd_scan(*tt(args), chunk=chunk, h0=torch.from_numpy(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_o), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_o), **TOL)


def test_ssd_wrapper_rejects_bad_arguments():
    args = tt(ssd_inputs(1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="dt"):
        ssd_scan(args[0], args[1][:, :8], *args[2:])
    with pytest.raises(ValueError, match="Cm"):
        ssd_scan(*args[:4], args[4][..., :2], args[5])
    with pytest.raises(ValueError, match="h0"):
        ssd_scan(*args, h0=torch.zeros(1, 2, 8, 4))


# -------------------------------------------------------- flash_attention
@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 64, 4, 4, 32),     # MHA
    (2, 128, 8, 2, 16),    # GQA 4:1
    (1, 256, 4, 1, 64),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference_kernel(B, S, H, K, hd, causal):
    q, k, v = qkv_inputs(B, S, S, H, K, hd, seed=S + H)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_k = ref_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                       interpret=True)
    want_o = attention_ref(jq, jk, jv, causal=causal)
    n0 = FK.flash_attention.launches
    got = flash_attention(*tt((q, k, v)), causal=causal).numpy()
    assert FK.flash_attention.launches == n0
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_o), **TOL)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_plain_flash_sliding_window(window):
    q, k, v = qkv_inputs(1, 256, 256, 4, 4, 32, seed=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_k = ref_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                       block_k=64, interpret=True)
    want_o = attention_ref(jq, jk, jv, causal=True, window=window)
    got = flash_attention(*tt((q, k, v)), causal=True, window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_o), **TOL)


@pytest.mark.parametrize("S,T,window", [(96, 96, None), (64, 128, None),
                                        (48, 112, 40)])
def test_plain_flash_uneven_and_offset_queries(S, T, window):
    """Lengths that do not tile by 64, and queries offset by T − S (the
    reference's kernel asserts tiling; its oracle takes any length)."""
    q, k, v = qkv_inputs(2, S, T, 4, 2, 16, seed=S + T)
    want = attention_ref(*map(jnp.asarray, (q, k, v)), causal=True,
                         window=window)
    got = flash_attention(*tt((q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,T", [(64, 128), (128, 64)])
@pytest.mark.parametrize("H,K,hd", [(4, 2, 16), (4, 4, 64), (8, 2, 64)])
def test_plain_flash_noncausal_with_other_key_lengths(S, T, H, K, hd):
    """No mask and S ≠ T, the encoder's and cross-attention's prefill
    (fewer and more keys than queries), with GQA: against the Pallas kernel
    in interpret mode at block 64 and the reference's oracle."""
    q, k, v = qkv_inputs(2, S, T, H, K, hd, seed=S + 2 * T + hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_k = ref_flash(jq, jk, jv, causal=False, block_q=64, block_k=64,
                       interpret=True)
    want_o = attention_ref(jq, jk, jv, causal=False)
    n0 = FK.flash_attention.launches
    got = flash_attention(*tt((q, k, v)), causal=False).numpy()
    assert FK.flash_attention.launches == n0
    assert got.shape == (2, S, H, hd)
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_o), **TOL)


def tf32_rna(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest of
    10 mantissa bits, ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """x cut to TF32: its low 13 bits cleared, as the tensor cores read an
    f32 register given to them as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_product(a, b, split, to_tf32=tf32_rna):
    """a @ b as a kernel's mma.sync forms it: the operands made TF32 by
    ``to_tf32`` (split: big + small, three products small·big + big·small +
    big·big), each product exact, the sum rounded once to f32.
    flash_attention rounds both parts (``tf32_rna``); ssd_scan cuts both
    (``tf32_trunc``: big by a mask, small by the tensor cores)."""
    ab, bb = to_tf32(a), to_tf32(b)
    d = lambda x: x.double()
    if not split:
        return (d(ab) @ d(bb)).float()
    as_, bs = to_tf32(a - ab), to_tf32(b - bb)
    return (d(as_) @ d(bb) + d(ab) @ d(bs) + d(ab) @ d(bb)).float()


def test_split_tf32_attention_keeps_f32_accuracy():
    """The CUDA kernel's arithmetic at hd 64, emulated bit-exactly in its
    rounding to TF32: with the three-product split, Q Kᵀ and P V stay within
    2e-5 of the output's scale of a float64 oracle (the card-vs-plain pin is
    2e-4, the card-vs-CPU logits pin 1e-4); a single TF32 product lands near
    1e-3, which is why the kernel splits."""
    q, k, v = (torch.from_numpy(a[0].transpose(1, 0, 2)) for a in
               qkv_inputs(1, 256, 256, 2, 2, 64, seed=7))   # (H, S, hd)
    S = q.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    oracle = torch.softmax(
        (q.double() @ k.double().transpose(1, 2) / 8.0).masked_fill(
            ~causal, float("-inf")), -1) @ v.double()
    scale = float(oracle.abs().max())
    errs = {}
    for split in (True, False):
        s = tf32_product(q, k.transpose(1, 2), split) * np.float32(1 / 8.0)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = tf32_product(p, v, split)
        errs[split] = float((o.double() - oracle).abs().max()) / scale
    print(f"split-TF32 error {errs[True]:.3g}, single TF32 {errs[False]:.3g} "
          f"(of the output's scale)")
    assert errs[True] <= 2e-5
    assert errs[False] > 10 * errs[True]
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12])
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                    -(1.0 + 2.0 ** -10), 1.0]


def split_tf32_ssd(u, dt, a, Bm, Cm, d, split, Q=64):
    """One (batch, head) strip of the SSD scan as the CUDA kernel forms it
    (u (S, hp), dt (S,), Bm/Cm (S, N); a, d scalars): chunks of Q, the
    cumulative decay in log2 units, and its four products C·Bᵀ, M·u,
    (exp(L)·C)·h and (B·w)ᵀ·u through ``tf32_product`` with the operands
    cut to TF32 (``tf32_trunc``)."""
    def product(x, y):
        return tf32_product(x, y, split, tf32_trunc)

    S, hp = u.shape
    N = Bm.shape[1]
    h = torch.zeros(N, hp)
    ys = []
    a2 = np.float32(a) * np.float32(1.4426950408889634)
    for c0 in range(0, S, Q):
        uc, dc, bc, cc = u[c0:c0 + Q], dt[c0:c0 + Q], Bm[c0:c0 + Q], \
            Cm[c0:c0 + Q]
        L = torch.cumsum(dc * a2, 0)
        causal = torch.ones(len(dc), len(dc), dtype=torch.bool).tril()
        decay = torch.exp2(torch.where(causal, L[:, None] - L[None, :],
                                       -float("inf")))
        M = product(cc, bc.T) * decay * dc[None, :]
        y = product(M, uc) + product(cc * torch.exp2(L)[:, None], h)
        ys.append(y + uc * np.float32(d))
        w = torch.exp2(L[-1] - L) * dc
        h = torch.exp2(L[-1]) * h + product((bc * w[:, None]).T, uc)
    return torch.cat(ys), h


def ssd_oracle64(u, dt, a, Bm, Cm, d):
    """One (batch, head) strip of the SSD recurrence step by step in
    float64: (y (S, hp), final state (N, hp))."""
    hs = torch.zeros(Bm.shape[1], u.shape[1], dtype=torch.float64)
    ys = []
    for t in range(u.shape[0]):
        hs = (torch.exp(dt[t].double() * a) * hs
              + dt[t].double() * Bm[t].double()[:, None]
              * u[t].double()[None, :])
        ys.append(Cm[t].double() @ hs + d * u[t])
    return torch.stack(ys), hs


def test_split_tf32_ssd_keeps_f32_accuracy():
    """The SSD kernel's arithmetic at N = hp = 64 over 8 chunks of 64 (the
    state carried through seven), emulated in its TF32 operands (big cut
    by a mask, small cut by the tensor cores): with the three-product split
    for all four products, y and the final state stay within 2e-5 of their
    scale of a float64 sequential oracle (the card-vs-plain pin is 2e-4);
    a single TF32 product lands above that pin, which is why the kernel
    splits. Permuting the k index, as the kernel does, reorders exact
    products only."""
    u, dt, A, Bm, Cm, D = (torch.from_numpy(x) for x in
                           ssd_inputs(1, 512, 2, 64, 64, seed=11))
    errs = {}
    for split in (True, False):
        worst = 0.0
        for hh in range(2):
            uh, dh = u[0, :, hh], dt[0, :, hh]
            y, h = split_tf32_ssd(uh, dh, float(A[hh]), Bm[0], Cm[0],
                                  float(D[hh]), split)
            yo, hs = ssd_oracle64(uh, dh, float(A[hh]), Bm[0], Cm[0],
                                  float(D[hh]))
            for got, want in ((y, yo), (h, hs)):
                worst = max(worst, float((got.double() - want).abs().max())
                            / float(want.abs().max()))
        errs[split] = worst
    print(f"SSD split-TF32 error {errs[True]:.3g}, single TF32 "
          f"{errs[False]:.3g} (of the outputs' scale)")
    assert errs[True] <= 2e-5
    assert errs[False] > 10 * errs[True]
    assert errs[False] > 2e-4


def bf16_pieces(x, k):
    """x (f32) as k bf16 values (held in f32) whose sum is x to within
    2^-8k of it: each rounds (RNE, as cvt.rn.bf16x2.f32) what the ones
    before it leave."""
    out = []
    for _ in range(k):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def split_bf16_ssd(u, dt, a, Bm, Cm, d, k, Q=64):
    """One (batch, head) strip of the SSD scan as ssd_bf16_hopper forms it
    (u, Bm, Cm bf16 values in f32; dt f32; a, d scalars): chunks of Q, the
    cumulative decay in log2 units, S = C·Bᵀ of the exact bf16 operands, M =
    S·2^(L_t − L_s)·dt_s, y = 2^(L_t)·(C·h) + M·u + D·u and h = 2^(L_Q)·h +
    Bᵀ·(w·u), each f32 operand (h, M, w·u) in ``k`` bf16 pieces; every
    product of a piece with a bf16 value exact, each pass summed in f32."""
    def product(xs, ys, acc=None):
        """acc + Σ x @ y over the pieces xs and ys, a pass each in f32"""
        for x in xs:
            for y in ys:
                t = (x.double() @ y.double()).float()
                acc = t if acc is None else acc + t
        return acc

    h = torch.zeros(Bm.shape[1], u.shape[1])
    ys = []
    a2 = np.float32(a) * np.float32(1.4426950408889634)
    for c0 in range(0, u.shape[0], Q):
        uc, dc, bc, cc = u[c0:c0 + Q], dt[c0:c0 + Q], Bm[c0:c0 + Q], \
            Cm[c0:c0 + Q]
        L = torch.cumsum(dc * a2, 0)
        causal = torch.ones(len(dc), len(dc), dtype=torch.bool).tril()
        decay = torch.exp2(torch.where(causal, L[:, None] - L[None, :],
                                       -float("inf")))
        M = product([cc], [bc.T]) * decay * dc[None, :]
        y = torch.exp2(L)[:, None] * product([cc], bf16_pieces(h, k))
        y = product(bf16_pieces(M, k), [uc], y)
        ys.append(y + uc * np.float32(d))
        w = torch.exp2(L[-1] - L) * dc
        h = product([bc.T], bf16_pieces(w[:, None] * uc, k),
                    torch.exp2(L[-1]) * h)
    return torch.cat(ys), h


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_split_bf16_ssd_keeps_f32_accuracy(pieces):
    """ssd_bf16_hopper's arithmetic at N = hp = 64 over 8 chunks of 64 (the
    state carried through seven), emulated in its bf16 operands: with two
    bf16 pieces of each f32 operand (M, h, w·u; the kernel's choice) y and
    the final state stay within 2e-5 of their scale of a float64 sequential
    oracle on the same bf16-rounded u, B and C, as the f32 entry's
    three-product TF32 split does; three pieces too. One piece (each f32
    operand rounded to bf16) lands above the card check's 2e-4, so that
    check tells one piece from two."""
    u, dt, A, Bm, Cm, D = (torch.from_numpy(x) for x in
                           ssd_inputs(1, 512, 2, 64, 64, seed=11))
    u, Bm, Cm = (x.bfloat16().float() for x in (u, Bm, Cm))
    worst = 0.0
    for hh in range(2):
        uh, dh = u[0, :, hh], dt[0, :, hh]
        y, h = split_bf16_ssd(uh, dh, float(A[hh]), Bm[0], Cm[0],
                              float(D[hh]), pieces)
        yo, hs = ssd_oracle64(uh, dh, float(A[hh]), Bm[0], Cm[0],
                              float(D[hh]))
        for got, want in ((y, yo), (h, hs)):
            worst = max(worst, float((got.double() - want).abs().max())
                        / float(want.abs().max()))
    print(f"SSD bf16 pieces {pieces}: error {worst:.3g} of the outputs' "
          f"scale")
    if pieces == 1:
        assert worst > 2e-4
    else:
        assert worst <= 2e-5


def test_flash_wrapper_rejects_bad_arguments():
    q, k, v = tt(qkv_inputs(1, 16, 16, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k[:, :, :1].expand(1, 16, 3, 8), v[:, :, :1]
                        .expand(1, 16, 3, 8))
    with pytest.raises(ValueError, match="fit"):
        flash_attention(q, k[..., :4], v[..., :4])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


def test_chip_smoke_bounds_count_the_live_work():
    """chip_smoke.py's kernel bounds: attention counts the (query, key)
    pairs its mask keeps, 4·hd operations each; the SSD scan the least count
    of its chunked form over chunk lengths (Q×Q products on s ≤ t only, no
    padded steps) or of the sequential recurrence; bytes read and written
    once; on the tensor cores three TF32 products each."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as C
    ops, moved = C.flash_ops_bytes(2, 128, 128, 4, 2, 16, True, None)
    assert ops == 4 * 16 * (128 * 129 // 2) * 2 * 4
    assert moved == 4 * (2 * 2 * 128 * 4 * 16 + 2 * 2 * 128 * 2 * 16)
    ops, _ = C.flash_ops_bytes(1, 128, 128, 1, 1, 16, True, 32)
    assert ops == 4 * 16 * (32 * 33 // 2 + (128 - 32) * 32)
    ops, _ = C.flash_ops_bytes(1, 4, 10, 1, 1, 16, True, None)
    assert ops == 4 * 16 * (7 + 8 + 9 + 10)        # offset by T − S = 6
    ops, _ = C.flash_ops_bytes(1, 8, 8, 1, 1, 16, False, None)
    assert ops == 4 * 16 * 64

    def chunk(L, N=64, hp=64):     # triangular products, C·h, update, decay
        return L * (L + 1) * (N + hp) + 4 * L * N * hp + N * hp
    ops, _ = C.ssd_ops_bytes(1, 12, 1, 64, 64)
    assert ops == 2 * chunk(6)                      # least at Q = 6
    ops, _ = C.ssd_ops_bytes(1, 13, 1, 64, 64)
    assert ops == chunk(7) + chunk(6)               # ragged chunk, no padding
    ops, _ = C.ssd_ops_bytes(3, 2048, 2, 64, 64)    # not the kernel's 64
    assert ops == 3 * 2 * (341 * chunk(6) + chunk(2))
    ops, moved = C.ssd_ops_bytes(1, 100, 2, 16, 8)
    assert ops == 2 * 5 * 8 * 16 * 100              # sequential form least
    assert moved == 4 * (2 * 100 * 2 * 16 + 2 * 100 * 8 + 100 * 2 + 2 * 2
                         + 2 * 8 * 16)

    # the tensor-core kernels' bound: three TF32 products each or the
    # bytes, the f32 FMA figure beside it; at the zamba2-1.2b prefill shape
    # the SSD scan is bound by its 0.28 GB
    ops, moved = C.ssd_ops_bytes(4, 2048, 64, 64, 64)
    b = C.lm_bound("ssd_scan", ops, moved)
    assert b["bound_ms"] == max(moved / 3.35e12, 3 * ops / 495e12) * 1e3
    assert b["bound_by"] == "bytes"
    assert b["fma_bound_ms"] == max(moved / 3.35e12, ops / 67e12) * 1e3
    assert abs(b["bound_ms"] - 0.083) < 0.001
    assert abs(b["fma_bound_ms"] - 0.141) < 0.001
    ops, moved = C.flash_ops_bytes(4, 2048, 2048, 32, 32, 64, True, None)
    b = C.lm_bound("flash_attention", ops, moved)
    assert b["bound_by"] == "operations (3×TF32)"
    assert abs(b["bound_ms"] - 0.417) < 0.001
    ops, moved = C.scan_ops_bytes(4, 2048, 8192, 16)
    b = C.lm_bound("selective_scan", ops, moved)
    assert b == {"bound_ms": moved / 3.35e12 * 1e3, "bound_by": "bytes"}


def test_chip_smoke_ssd_backward_bound_as_the_forward():
    """chip_smoke.py's bound of the SSD scan's gradients, counted as the
    forward's is: the least operation count of the chunked form over chunk
    lengths (triangular products on s ≤ t only, five L·N·hp products and
    the two decays a chunk, no padded steps); bytes of u, dy and du (not
    y), dt and ddt, B, C, dB, dC, A, D, dA, dD (and h0, dh, dh0) once;
    three TF32 products each on the tensor cores, as the forward."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as C

    def chunk(L, N=64, hp=64):
        # C·Bᵀ, dy·uᵀ, Mᵀ·dy, G·B, Gᵀ·C and 6 on each pair s ≤ t
        return (L * (L + 1) / 2 * (6 * N + 4 * hp + 6) + 10 * L * N * hp
                + 2 * N * hp)
    ops, moved, _ = C.ssd_bwd_ops_bytes(1, 12, 1, 64, 64, False)
    assert ops == 2 * chunk(6) < 3 * chunk(4)       # least at Q = 6
    ops, _, _ = C.ssd_bwd_ops_bytes(1, 13, 1, 64, 64, False)
    assert ops == 2 * chunk(5) + chunk(3) < chunk(7) + chunk(6)
    assert moved == 4 * (3 * 12 * 64 + 2 * 12 + 4 * 12 * 64 + 4)
    _, with_state, _ = C.ssd_bwd_ops_bytes(1, 12, 1, 64, 64, True)
    assert with_state == moved + 4 * 3 * 64 * 64
    ops, moved, _ = C.ssd_bwd_ops_bytes(8, 256, 64, 64, 64, False)
    b = C.lm_bound("ssd_scan_bwd", ops, moved)
    assert b["bound_by"] == "operations (3×TF32)"
    assert b["bound_ms"] == 3 * ops / 495e12 * 1e3
    assert b["fma_bound_ms"] == ops / 67e12 * 1e3
    assert abs(b["bound_ms"] - 0.0354) < 0.0001


def test_chip_smoke_ssd_backward_bf16_bound_counts_bf16_stream_bytes():
    """The bf16 entry's backward bound: the same operations, the stream
    tensors (u, dy, du, B, C, dB, dC) at 2 bytes, dt, ddt, A, D, dA, dD
    (and h0, dh, dh0) at 4; at zamba2-1.2b's train shape 52.4 MB, 0.0157
    ms at 3.35 TB/s, half of the f32 entry's bytes bound, so the route's
    operations (3×TF32, 0.0354 ms) bound it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as C
    ops32, moved32, _ = C.ssd_bwd_ops_bytes(1, 12, 1, 64, 64, True)
    ops, moved, _ = C.ssd_bwd_ops_bytes(1, 12, 1, 64, 64, True, elem=2)
    assert ops == ops32
    assert moved == 2 * (3 * 12 * 64 + 4 * 12 * 64) + 4 * (2 * 12 + 4
                                                           + 3 * 64 * 64)
    ops, moved, _ = C.ssd_bwd_ops_bytes(8, 256, 64, 64, 64, False, elem=2)
    _, moved32, _ = C.ssd_bwd_ops_bytes(8, 256, 64, 64, 64, False)
    assert moved == 2 * (3 * 8 * 256 * 64 * 64 + 4 * 8 * 256 * 64) \
        + 4 * (2 * 8 * 256 * 64 + 4 * 64)
    assert abs(moved / 3.35e12 * 1e3 - 0.0157) < 0.0001
    assert abs(moved / moved32 - 0.5) < 0.01
    b = C.bwd_bounds(ops, moved, "mma_sync")
    assert b["route_bound_by"] == "operations (3×TF32)"
    assert abs(b["route_bound_ms"] - 0.0354) < 0.0001
