"""The ssd_scan, flash_attention and selective_scan CUDA kernels against
their plain versions, on the card.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without one. The file imports no JAX (the machine with the card has
none), so it runs there as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py

The plain versions, held against the JAX reference on the CPU by
tests/test_torch_lm_kernels.py and tests/test_torch_lm_mamba1.py, are the
oracle: each kernel must agree with its plain version on the same inputs
within rtol = atol = 2e-4 (the reference's kernel tolerance; the two sum in
different orders), at the model's widths, with ragged lengths, GQA,
windows and (attention) a soft-cap, and give bitwise-equal results when
run twice (no atomics). The dense models' prefill shapes (granite-8b,
gemma-7b at hd 256, gemma3-27b's local layers) run at full size.

The bf16 entries are held to their plain versions on the same bf16 inputs,
each output within one bf16 rounding of the plain one (2^-7 of the value)
plus a share of the scale: 2e-3 for attention (the kernel rounds P to bf16
against the running maximum of its key tiles — 128 keys at hd 64 and 128,
64 at hd 256 and at hd 16 and 32 —, the plain version against the row's),
2e-4 for the scans (f32 arithmetic from the same bf16 inputs, y rounded
once); the scans' f32 states within 2e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import kernel as MK
from repro_torch.kernels.mamba_scan import (selective_scan,
                                            selective_scan_ref)
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 2.0 ** -7       # one bf16 rounding step, relative to the value
FLASH_BF16_RTOL = 2e-3     # of the scale, beyond one rounding


def ssd_inputs(B, S, H, hp, N, seed=0):
    """The inputs of tests/test_kernel_ssd_scan.py:11."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hp)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, H))).astype(np.float32),
            (-(0.1 + rng.random(H))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(H).astype(np.float32)]


def scan_inputs(B, S, dI, N, seed=0):
    """The inputs of tests/test_kernel_mamba_scan.py:make_inputs."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, dI)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, dI))).astype(np.float32),
            (-rng.random((dI, N)) - 0.1).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(dI).astype(np.float32)]


def qkv_inputs(B, S, T, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32)]


def tt(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def within_bf16_rounding(got, want, rtol):
    """|got − want| ≤ 2^-7 |want| + rtol · max |want|, elementwise: two f32
    values within rtol of the scale, each rounded to bf16 once."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    err = float(((got - want).abs() - BF16_REL * want.abs()).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hp,N,with_h0", [
    (2, 256, 4, 64, 64, False),
    (1, 200, 3, 16, 16, True),       # ragged S, the reduced model's widths
    (2, 77, 2, 32, 64, True),
    (1, 64, 5, 64, 16, False),
])
def test_cuda_ssd_kernel_matches_plain(cuda_device, B, S, H, hp, N, with_h0):
    args = tt(ssd_inputs(B, S, H, hp, N, seed=S), cuda_device)
    h0 = (torch.randn(B, H, N, hp, device=cuda_device) if with_h0 else None)
    n0 = SK.ssd_scan.launches
    y, h = ssd_scan(*args, h0=h0)
    y2, h2 = ssd_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert SK.ssd_scan.launches == n0 + 2
    assert SK.library().ssd_scan_chunk() == SK.KERNEL_CHUNK
    assert torch.equal(y, y2) and torch.equal(h, h2)       # no atomics
    y_p, h_p = ssd_scan_ref(*args, h0=h0)
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(), **TOL)
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (2, 256, 256, 4, 4, 64, True, None),
    (1, 200, 200, 8, 2, 32, True, None),     # ragged, GQA
    (1, 130, 300, 4, 1, 16, True, 64),       # offset queries, window, MQA
    (2, 128, 128, 2, 2, 128, False, None),
    (1, 96, 96, 4, 4, 64, False, 32),
])
def test_cuda_flash_kernel_matches_plain(cuda_device, B, S, T, H, K, hd,
                                         causal, window):
    q, k, v = tt(qkv_inputs(B, S, T, H, K, hd, seed=S + T), cuda_device)
    n0 = FK.flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches == n0 + 2
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,S,T,H,K,causal,window", [
    (1, 77, 77, 4, 2, True, None),           # ragged, GQA 2:1
    (1, 100, 261, 6, 3, True, 50),           # T > S, window, GQA
    (2, 150, 90, 2, 2, True, None),          # S > T: rows with no live key
    (1, 65, 129, 2, 1, False, None),         # MQA, no mask, ragged tiles
    (1, 200, 200, 4, 4, False, 70),          # window alone
])
def test_cuda_flash_kernel_every_head_width_and_mask(cuda_device, hd, B, S, T,
                                                     H, K, causal, window):
    """The tensor-core kernel against its plain version at S and T that are
    not multiples of its tiles, at every head width it is built for."""
    q, k, v = tt(qkv_inputs(B, S, T, H, K, hd, seed=hd + S + T), cuda_device)
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if causal and S > T:                     # the first S - T rows see no key
        assert not bool(got[:, :S - T].any())
        assert bool(got[:, S - T:].abs().sum(-1).gt(0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,hd,window,softcap", [
    (4, 2048, 32, 8, 128, None, None),       # granite-8b's prefill
    (4, 2048, 16, 16, 256, None, None),      # gemma-7b's, hd 256
    (4, 2048, 32, 16, 128, 1024, None),      # gemma3-27b's local layers
    (2, 1000, 16, 8, 256, 300, 30.0),        # hd 256, ragged, window, cap
    (2, 777, 8, 2, 128, None, 50.0),         # soft-capped, GQA 4:1
    (1, 300, 4, 4, 64, None, 1.0),           # a cap that bends every score
])
def test_cuda_flash_kernel_at_the_dense_models_shapes(cuda_device, B, S, H,
                                                      K, hd, window, softcap):
    q, k, v = tt(qkv_inputs(B, S, S, H, K, hd, seed=hd + S), cuda_device)
    n0 = FK.flash_attention.launches
    got = flash_attention(q, k, v, window=window, softcap=softcap)
    again = flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches == n0 + 2
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k, v, window=window, softcap=softcap)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if softcap is not None:
        plain = flash_attention(q, k, v, window=window)
        assert float((plain - got).abs().max()) > 1e-4     # the cap bites


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt", [("gemma3-27b", 64),
                                         ("gemma-7b", 40)])
def test_cuda_dense_prefill_goes_through_the_kernel(cuda_device, arch,
                                                    prompt):
    """A reduced dense model's prefill on the card launches the flash
    kernel once a layer (gemma3: banded local and full global layers) and
    decode none, with logits within 1e-4 of the CPU's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import tree_map
    from repro_torch.serve.serve_step import decode_step, prefill
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, prompt + 4)))
    on_card = tree_map(lambda t: t.to(cuda_device), params)
    runs = []
    for p, toks in ((on_card, tokens.to(cuda_device)), (params, tokens)):
        n0 = FK.flash_attention.launches
        lg, caches, rolling = prefill(p, cfg, toks[:, :prompt],
                                      cache_len=prompt + 4)
        n1 = FK.flash_attention.launches
        steps = [lg]
        for t in range(prompt, prompt + 4):
            lg, caches = decode_step(p, cfg, toks[:, t:t + 1], caches, t,
                                     rolling=rolling)
            steps.append(lg)
        runs.append((torch.stack(steps).cpu().numpy(), n1 - n0,
                     FK.flash_attention.launches - n1))
    (card, pre, dec), (cpu, pre_cpu, _) = runs
    assert (pre, dec, pre_cpu) == (cfg.n_layers, 0, 0)
    scale = float(np.abs(cpu).max())
    assert float(np.abs(card - cpu).max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    q, k, v = tt(qkv_inputs(1, 64, 64, 2, 2, 64), cuda_device)
    with pytest.raises(TypeError):           # fp16: neither entry takes it
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):           # a mix: no conversion either way
        flash_attention(q.bfloat16(), k, v)
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    qw, kw, vw = tt(qkv_inputs(1, 64, 64, 2, 2, 48), cuda_device)
    with pytest.raises(ValueError, match="head width"):
        flash_attention(qw, kw, vw)
    args = tt(ssd_inputs(1, 64, 2, 8, 4), cuda_device)
    with pytest.raises(ValueError, match="not built"):
        ssd_scan(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,dI,N,with_h0", [
    (2, 256, 128, 16, False),
    (1, 200, 100, 16, True),         # ragged S and dI (not a CTA's width)
    (3, 48, 24, 4, False),
    (2, 77, 130, 8, True),
    (1, 40, 128, 8, True),           # the reduced falcon's widths
    (2, 1000, 1000, 16, True),
])
def test_cuda_scan_kernel_matches_plain(cuda_device, B, S, dI, N, with_h0):
    args = tt(scan_inputs(B, S, dI, N, seed=S + dI), cuda_device)
    h0 = (torch.randn(B, dI, N, device=cuda_device) if with_h0 else None)
    n0 = MK.selective_scan.launches
    y, h = selective_scan(*args, h0=h0)
    y2, h2 = selective_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert MK.selective_scan.launches == n0 + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)       # no atomics
    y_p, h_p = selective_scan_ref(*args, h0=h0)
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(), **TOL)
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_scan_wrapper_raises_on_what_the_kernel_does_not_take(
        cuda_device):
    args = tt(scan_inputs(1, 64, 32, 16), cuda_device)
    u, dt, A, Bm, Cm, D = args
    for bad in ((u.half(), dt, A, Bm.half(), Cm.half(), D),   # fp16
                (u.bfloat16(), dt, A, Bm, Cm, D),             # a mix
                (u.bfloat16(), dt.bfloat16(), A, Bm.bfloat16(),
                 Cm.bfloat16(), D)):                          # dt not f32
        with pytest.raises(TypeError):
            selective_scan(*bad)
    u, dt, A, Bm, Cm, D = tt(ssd_inputs(1, 16, 2, 16, 16), cuda_device)
    for bad in ((u.half(), dt, A, Bm.half(), Cm.half(), D),
                (u.bfloat16(), dt, A, Bm, Cm.bfloat16(), D),
                (u.bfloat16(), dt, A.bfloat16(), Bm.bfloat16(),
                 Cm.bfloat16(), D)):
        with pytest.raises(TypeError):
            ssd_scan(*bad)
    with pytest.raises(ValueError, match="contiguous"):
        u_t = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        selective_scan(u_t, *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(*args, h0=torch.zeros(1, 16, 32, device=cuda_device)
                       .transpose(1, 2))
    for N in (2, 12, 32):
        with pytest.raises(ValueError, match="not built"):
            selective_scan(*tt(scan_inputs(1, 16, 8, N), cuda_device))


def run_twice_against_plain(kernel, plain, args, h0):
    """Kernel twice (bitwise equal: no atomics) and its plain version on
    the same inputs, within TOL."""
    y, h = kernel(*args, h0=h0)
    y2, h2 = kernel(*args, h0=h0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y_p, h_p = plain(*args, h0=h0)
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(), **TOL)
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,S,dI,with_h0", [
    (2, 1, 24, True),          # one step
    (1, 37, 13, True),         # dI % 4 != 0 and dI < 32: 4-byte copies
    (2, 300, 70, False),       # dI % 4 != 0 over several CTAs
    (1, 17, 36, True),         # 16-byte copies, the last CTA part-filled
])
def test_cuda_scan_kernel_edges(cuda_device, N, B, S, dI, with_h0):
    """The selective scan where its tiles meet the edges: ragged dI (the
    4-byte copy path), a single step, steps past S in the last tile."""
    args = tt(scan_inputs(B, S, dI, N, seed=S + dI + N), cuda_device)
    h0 = (torch.randn(B, dI, N, device=cuda_device) if with_h0 else None)
    run_twice_against_plain(selective_scan, selective_scan_ref, args, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("hp", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 130])
def test_cuda_ssd_kernel_every_width(cuda_device, N, hp, S):
    """The tensor-core SSD scan at every (N, hp) it is built for, with an
    initial state: one step, and S not a multiple of its 64-step chunk."""
    args = tt(ssd_inputs(2, S, 3, hp, N, seed=N + hp + S), cuda_device)
    h0 = torch.randn(2, 3, N, hp, device=cuda_device)
    run_twice_against_plain(ssd_scan, ssd_scan_ref, args, h0)


def unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
def test_cuda_scans_take_views_off_a_16_byte_boundary(cuda_device):
    """The scans copy u, dt, B and C in 16-byte pieces; the wrappers give
    them an aligned copy of a view that starts elsewhere, and the result is
    the aligned call's bit for bit."""
    args = tt(scan_inputs(2, 50, 64, 16, seed=3), cuda_device)
    want = selective_scan(*args)
    got = selective_scan(*[unaligned(a) if i in (0, 1, 3, 4) else a
                           for i, a in enumerate(args)])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = tt(ssd_inputs(2, 70, 3, 32, 16, seed=3), cuda_device)
    want = ssd_scan(*args)
    got = ssd_scan(*[unaligned(a) if i in (0, 3, 4) else a
                     for i, a in enumerate(args)])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------------ bf16
def bf16(ts):
    return [t.bfloat16() for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,S,T,H,K,causal,window,softcap", [
    (2, 130, 130, 4, 2, True, None, None),     # ragged, GQA 2:1
    (1, 100, 261, 6, 3, True, 50, None),       # T > S, window, GQA
    (2, 150, 90, 2, 2, True, None, None),      # S > T: rows with no live key
    (1, 65, 129, 2, 1, False, None, None),     # MQA, no mask, ragged tiles
    (1, 1, 77, 4, 4, True, None, None),        # one query row
    (1, 200, 200, 4, 4, True, 70, 30.0),       # window and soft-cap
    # the edges of the Hopper kernel's tiles (128 query rows; 128 keys, 64
    # at hd 256) and of its TMA boxes
    (1, 1000, 1000, 4, 2, True, None, None),   # S, T not multiples of a tile
    (2, 333, 1000, 4, 4, True, None, None),    # T > S, ragged
    (1, 300, 300, 4, 4, True, 50, None),       # a window under one tile
    (1, 500, 500, 2, 2, True, 200, None),      # a window off the tiles
    (1, 256, 256, 64, 8, True, None, None),    # G = 8
    (1, 520, 520, 4, 2, True, None, 50.0),     # soft-cap, no window
    (1, 200, 200, 2, 2, True, None, None),     # 4 CTAs, far under 132 SMs
    (1, 300, 100, 4, 4, True, 32, None),       # no live key, window, T < S
])
def test_cuda_flash_bf16_kernel_matches_plain(cuda_device, hd, B, S, T, H, K,
                                              causal, window, softcap):
    """The bf16 entry against the plain version on the same bf16 inputs,
    run twice bitwise, at every head width and mask; bf16 out."""
    q, k, v = bf16(tt(qkv_inputs(B, S, T, H, K, hd, seed=hd + S + T),
                      cuda_device))
    n0 = dict(FK.flash_attention.launches_by_dtype)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)
    again = flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches_by_dtype[torch.bfloat16] == \
        n0[torch.bfloat16] + 2
    assert FK.flash_attention.launches_by_dtype[torch.float32] == \
        n0[torch.float32]
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    assert want.dtype == torch.bfloat16
    within_bf16_rounding(got, want, FLASH_BF16_RTOL)
    if causal and S > T:                     # the first S - T rows see no key
        assert not bool(got[:, :S - T].any())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (4, 2048, 32, 8, 128, None),             # granite-8b's prefill
    (4, 2048, 16, 16, 256, None),            # gemma-7b's, hd 256
    (4, 2048, 32, 16, 128, 1024),            # gemma3-27b's local layers
    (1, 2048, 40, 40, 128, None),            # qwen1.5-32b's, B = 1
])
def test_cuda_flash_bf16_kernel_at_the_dense_models_shapes(cuda_device, B, S,
                                                           H, K, hd, window):
    q, k, v = bf16(tt(qkv_inputs(B, S, S, H, K, hd, seed=hd + S),
                      cuda_device))
    got = flash_attention(q, k, v, window=window)
    assert torch.equal(got, flash_attention(q, k, v, window=window))
    want = flash_attention_ref(q, k, v, window=window)
    within_bf16_rounding(got, want, FLASH_BF16_RTOL)


def check_ssd_bf16(dev, B, S, H, hp, N, with_h0=True):
    """The SSD scan's bf16 entry (u, B, C bf16; dt, A, D, h0 f32) against
    the plain version on the same inputs, run twice bitwise: y bf16 within
    one rounding plus 2e-4 of the scale, h f32 within 2e-4; two launches of
    the bf16 entry and none of the f32 one."""
    u, dt, A, Bm, Cm, D = tt(ssd_inputs(B, S, H, hp, N, seed=N + hp + S),
                             dev)
    args = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
    h0 = torch.randn(B, H, N, hp, device=dev) if with_h0 else None
    n0 = dict(SK.ssd_scan.launches_by_dtype)
    y, h = ssd_scan(*args, h0=h0)
    y2, h2 = ssd_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert SK.ssd_scan.launches_by_dtype[torch.bfloat16] == \
        n0[torch.bfloat16] + 2
    assert SK.ssd_scan.launches_by_dtype[torch.float32] == \
        n0[torch.float32]
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y_p, h_p = ssd_scan_ref(*args, h0=h0)
    within_bf16_rounding(y, y_p, TOL["rtol"])
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N,hp", [(16, 16), (32, 64), (64, 32), (64, 64)])
@pytest.mark.parametrize("S", [1, 130])
def test_cuda_ssd_bf16_kernel_matches_plain(cuda_device, N, hp, S):
    """The bf16 entry on both routes: (64, 64) through ssd_bf16_hopper, the
    other pairs through the mma.sync kernel."""
    check_ssd_bf16(cuda_device, 2, S, 3, hp, N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [
    (2, 1, 3), (2, 63, 3), (2, 65, 3), (2, 130, 3),
    (2, 2048 - 77, 3),                      # ragged, 32 chunks
    (4, 2048, 64),                          # zamba2-1.2b's prefill
    (1, 2048, 64),                          # the same at batch 1
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_ssd_bf16_hopper_route_matches_plain(cuda_device, B, S, H,
                                                  with_h0):
    """ssd_bf16_hopper (N = hp = 64): ragged and single-step sequences,
    chunk edges, zamba2's prefill shape at batch 4 and 1, with and without
    an initial state."""
    assert SK.hopper_route(64, 64)
    assert not any(SK.hopper_route(N, hp) for N in (16, 32, 64)
                   for hp in (16, 32, 64) if (N, hp) != (64, 64))
    check_ssd_bf16(cuda_device, B, S, H, 64, 64, with_h0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,hp", [(64, 64), (32, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ssd_takes_h0_off_a_16_byte_boundary(cuda_device, N, hp, dtype):
    """ssd_bf16_hopper reads h0 in 8-byte pieces: an h0 view that starts 4
    bytes past a 16-byte boundary gets an aligned copy, on every route, and
    the result is the aligned call's bit for bit."""
    u, dt, A, Bm, Cm, D = tt(ssd_inputs(2, 130, 3, hp, N, seed=5),
                             cuda_device)
    args = [u.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D]
    h0 = torch.randn(2, 3, N, hp, device=cuda_device)
    want = ssd_scan(*args, h0=h0)
    got = ssd_scan(*args, h0=unaligned(h0))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,S,dI,with_h0", [
    (2, 1, 24, True),          # one step
    (1, 37, 13, True),         # dI % 4 != 0: per-element stores
    (2, 300, 128, False),      # 8-byte stores of four channels
    (4, 64, 1000, True),
])
def test_cuda_scan_bf16_kernel_matches_plain(cuda_device, N, B, S, dI,
                                             with_h0):
    """The selective scan's bf16 entry against the plain version on the
    same inputs, run twice bitwise: y bf16, h f32."""
    u, dt, A, Bm, Cm, D = tt(scan_inputs(B, S, dI, N, seed=S + dI + N),
                             cuda_device)
    args = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
    h0 = torch.randn(B, dI, N, device=cuda_device) if with_h0 else None
    n0 = dict(MK.selective_scan.launches_by_dtype)
    y, h = selective_scan(*args, h0=h0)
    y2, h2 = selective_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert MK.selective_scan.launches_by_dtype[torch.bfloat16] == \
        n0[torch.bfloat16] + 2
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y_p, h_p = selective_scan_ref(*args, h0=h0)
    within_bf16_rounding(y, y_p, TOL["rtol"])
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_device_pins_f32_accumulation_of_bf16_products(cuda_device):
    """resolve_device pins cuBLAS's bf16 products to f32 reductions (XLA's
    bf16 dot accumulates in f32) beside TF32 off."""
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
