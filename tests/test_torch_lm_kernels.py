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


def tf32_rna(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest of
    10 mantissa bits, ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(a, b, split):
    """a @ b as the kernel's mma.sync forms it: the operands rounded to TF32
    (split: big + small, three products small·big + big·small + big·big),
    each product exact, the sum rounded once to f32."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    d = lambda x: x.double()
    if not split:
        return (d(ab) @ d(bb)).float()
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
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
    once."""
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
