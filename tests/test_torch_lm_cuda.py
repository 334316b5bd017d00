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
    with pytest.raises(TypeError):
        flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
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
    with pytest.raises(TypeError, match="float32"):
        selective_scan(*(a.bfloat16() for a in args))
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
