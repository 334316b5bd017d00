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
gemma-7b at hd 256, gemma3-27b's local layers) and the mixtrals' (GQA 32/8
and 48/8 with a window of 4,096, and a sequence where it bites) run at full
size; one MoE layer and the reduced mixtrals run on the card against the
CPU.

The backward of the f32 flash entry (``flash_attention_bwd``) is held to
the plain version's autograd: dQ, dK and dV within 2e-4 of each gradient's
scale (``BWD_RTOL``, the forward's tolerance; the kernel sums in other
orders), the forward's row log-sum-exp within 2e-4 of its scale and +inf
exactly where a row has no live key, each run twice bitwise; hd 64, 128
and 256 through the Hopper kernel (``flash_bwd_hopper``) and hd 16 and 32
through the mma.sync one, as the wrapper's per-route count shows. The
backwards of the scans' f32 entries (``selective_scan_bwd``,
``ssd_scan_bwd``) are held to the plain forwards' autograd the same way
(every gradient within ``BWD_RTOL`` of its scale, h0 and the final state's
gradient given or not, ragged S, every built width, twice bitwise).
The backward of the bf16 flash entry (``flash_attention_bwd`` on bf16
tensors: ``flash_attention_bwd_bf16``) is held to the plain version's
autograd in bf16: each of dQ, dK and dV within 2 x the plain bf16
backward's own RMS distance from the plain f32 backward on the same values
widened (tests/test_torch_train_bf16.py's rule and its reason), run twice
bitwise, at every head width with windows and soft-caps; the bf16
forward's log-sum-exp as the f32 one's, with the output bit for bit the
one without it. The backward of the bf16 SSD entry
(``ssd_scan_bwd`` on bf16 u, B, C and dy) is held to the plain backward on
the same bf16 tensors by the bf16 scans' rule below (du, dB and dC each
rounded once), twice bitwise, at zamba2's train shape, ragged with h0 and
dh, and every built width; at (N, hp) = (64, 64) through its Hopper route
(TMA + ``wgmma``, ``kernel.bwd_hopper_route``) at the sequence and batch
edges and from views off a 16-byte boundary. Training on the card (the ops under autograd, a
reduced model's train steps against the CPU's within 1e-4 of scale, the
Mamba kinds' and a mixtral's too, a reduced mixtral's f32 step and a
reduced granite's bf16 step each twice bitwise) and the entry that has no
backward kernel (the Mamba-1 scan's bf16 entry, on no model's training
path) raising under grad are tested at the end of the file.

The Mamba-1 scan's bf16 entry is also held to its f32 entry on the same
values widened, bit for bit: h, and y rounded once to bf16.

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
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_op,
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd", [
    (2, 700, 1500, 16, 16, 64),      # S < T over several tiles each
    (2, 1500, 700, 16, 16, 64),      # S > T: every row sees every key
    (2, 1000, 1537, 16, 8, 128),     # GQA 2:1, T off every tile
    (2, 1537, 1000, 16, 8, 128),
    (4, 2048, 2048, 16, 16, 64),     # seamless-m4t-large-v2's encoder
])
def test_cuda_flash_noncausal_over_many_tiles(cuda_device, dtype, B, S, T, H,
                                              K, hd):
    """No mask, as the encoder and cross-attention take the kernel, over
    many query and key tiles with S < T and S > T, in each entry: run twice
    bitwise, against the plain version on the same inputs."""
    q, k, v = (t.to(dtype) for t in tt(qkv_inputs(B, S, T, H, K, hd,
                                                  seed=S + T + hd),
                                       cuda_device))
    n0 = dict(FK.flash_attention.launches_by_dtype)
    got = flash_attention(q, k, v, causal=False)
    again = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches_by_dtype[dtype] == n0[dtype] + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = flash_attention_ref(q, k, v, causal=False)
    if dtype == torch.bfloat16:
        within_bf16_rounding(got, want, FLASH_BF16_RTOL)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)
    assert bool(got.float().abs().sum(-1).gt(0).all())   # every row sees keys


@pytest.mark.cuda
@pytest.mark.parametrize("arch,enc_len", [("seamless-m4t-large-v2", 24),
                                          ("seamless-m4t-large-v2", 56),
                                          ("internvl2-2b", 0)])
def test_cuda_encdec_and_vlm_prefill_go_through_the_kernel(cuda_device, arch,
                                                           enc_len):
    """A reduced enc-dec or VLM model's prefill on the card launches the
    flash kernel once an attention (seamless: encoder, decoder self- and
    cross-attention, S ≠ T) and decode none, with logits within 1e-4 of the
    CPU's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import tree_map
    from repro_torch.serve.serve_step import decode_step, prefill
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompt, P = 40, cfg.vlm_patches
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt + 4)))
    front = {}
    if cfg.is_encdec:
        front["enc_inputs"] = 0.1 * torch.from_numpy(rng.standard_normal(
            (2, enc_len, cfg.d_model)).astype(np.float32))
    if P:
        front["patch_embeds"] = 0.1 * torch.from_numpy(rng.standard_normal(
            (2, P, cfg.d_model)).astype(np.float32))
    on_card = tree_map(lambda t: t.to(cuda_device), params)
    runs = []
    for p, dev in ((on_card, cuda_device), (params, torch.device("cpu"))):
        toks = tokens.to(dev)
        kw = {n: t.to(dev) for n, t in front.items()}
        n0 = FK.flash_attention.launches
        lg, caches, rolling = prefill(p, cfg, toks[:, :prompt],
                                      cache_len=prompt + 4 + P, **kw)
        n1 = FK.flash_attention.launches
        steps = [lg]
        for t in range(prompt, prompt + 4):
            lg, caches = decode_step(p, cfg, toks[:, t:t + 1], caches, t + P,
                                     rolling=rolling)
            steps.append(lg)
        runs.append((torch.stack(steps).cpu().numpy(), n1 - n0,
                     FK.flash_attention.launches - n1))
    (card, pre, dec), (cpu, pre_cpu, _) = runs
    per_prefill = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.is_encdec
                   else cfg.n_layers)
    assert (pre, dec, pre_cpu) == (per_prefill, 0, 0)
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
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary (a view into a larger buffer): 4 bytes for f32, 2 for bf16."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous()
    assert view.data_ptr() % 16 == t.element_size()
    return view


@pytest.mark.cuda
def test_cuda_scans_take_views_off_a_16_byte_boundary(cuda_device):
    """The scans copy u, dt, B and C in 16-byte pieces; the wrappers give
    them an aligned copy of a view that starts elsewhere, and the result is
    the aligned call's bit for bit (the Mamba-1 scan's bf16 entry too, its
    u, B and C 2 bytes off)."""
    args = tt(scan_inputs(2, 50, 64, 16, seed=3), cuda_device)
    want = selective_scan(*args)
    got = selective_scan(*[unaligned(a) if i in (0, 1, 3, 4) else a
                           for i, a in enumerate(args)])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = [a.bfloat16() if i in (0, 3, 4) else a
            for i, a in enumerate(args)]
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
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,S,dI,with_h0", [
    (2, 1, 24, True),          # one step
    (1, 37, 13, True),         # odd dI: u by 2-byte loads, y by channel
    (2, 300, 128, False),      # 16-byte copies and stores
    (4, 64, 1000, True),
    (2, 300, 70, False),       # dI % 4 != 0 over several CTAs
    (1, 17, 36, True),         # dI % 8 != 0, the last CTA part-filled
    (2, 77, 1004, True),       # dI % 8 != 0 over many CTAs, S % 32 != 0
])
def test_cuda_scan_bf16_is_the_f32_entry_bit_for_bit(cuda_device, N, B, S,
                                                     dI, with_h0):
    """The selective scan's bf16 entry does the f32 entry's arithmetic on
    the same values widened: h bit for bit, y that entry's y rounded once
    to bf16 (nearest even)."""
    u, dt, A, Bm, Cm, D = tt(scan_inputs(B, S, dI, N, seed=S + dI + N),
                             cuda_device)
    args = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
    h0 = torch.randn(B, dI, N, device=cuda_device) if with_h0 else None
    y, h = selective_scan(*args, h0=h0)
    y32, h32 = selective_scan(*[a.float() for a in args], h0=h0)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(h, h32)
    assert torch.equal(y, y32.bfloat16())


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


# ------------------------------------------------------------------- MoE
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,window", [
    (4, 2048, 32, 8, 4096),          # mixtral-8x7b's prefill, GQA 4:1
    (4, 2048, 48, 8, 4096),          # mixtral-8x22b's, a group of 6
    (1, 6144, 32, 8, 4096),          # the window bites: tiles skipped
    (1, 700, 48, 8, 300),            # group of 6, ragged, window off tiles
])
def test_cuda_flash_kernel_at_the_moe_models_shapes(cuda_device, dtype, B, S,
                                                    H, K, window):
    """The mixtrals' windowed GQA attention at hd 128 in each entry, run
    twice bitwise, against the plain version on the same inputs."""
    q, k, v = (t.to(dtype) for t in tt(qkv_inputs(B, S, S, H, K, 128,
                                                  seed=H + S), cuda_device))
    n0 = dict(FK.flash_attention.launches_by_dtype)
    got = flash_attention(q, k, v, window=window)
    again = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches_by_dtype[dtype] == n0[dtype] + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = flash_attention_ref(q, k, v, window=window)
    if dtype == torch.bfloat16:
        within_bf16_rounding(got, want, FLASH_BF16_RTOL)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,E,capacity_factor", [
    (4, 512, 8, 1.25),               # groups of 1,024 with drops
    (4, 1, 8, 1.25),                 # decode: g 4, cap 2
])
def test_cuda_moe_matches_cpu(cuda_device, B, S, E, capacity_factor):
    """One MoE layer on the card against the CPU on the same f32 inputs:
    the same routing, counts and drops exactly, the output within 1e-5 of
    its scale (products summed in other orders), run twice bitwise."""
    from repro_torch.models.moe import init_moe, moe, route
    p = init_moe(torch.Generator().manual_seed(E), 256, 512, E)
    # an offset shared by every token tilts the router: uneven loads drop
    x = torch.from_numpy((np.random.default_rng(S).standard_normal(
        (B, S, 256)) + 0.5).astype(np.float32))
    on_card = {n: t.to(cuda_device) for n, t in p.items()}
    xc = x.to(cuda_device)
    kw = dict(top_k=2, capacity_factor=capacity_factor)
    y, s = moe(on_card, xc, **kw)
    y2, s2 = moe(on_card, xc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and all(torch.equal(a, b)
                                      for a, b in zip(s, s2))
    y_cpu, s_cpu = moe(p, x, **kw)
    r, r_cpu = route(on_card, xc, **kw), route(p, x, **kw)
    for name in ("gate_idx", "pos", "keep"):
        assert torch.equal(getattr(r, name).cpu(), getattr(r_cpu, name))
    assert torch.equal(s.tokens_per_expert.cpu(), s_cpu.tokens_per_expert)
    assert float(s.dropped_fraction) == float(s_cpu.dropped_fraction)
    if S > 1:
        assert float(s_cpu.dropped_fraction) > 0
    scale = float(y_cpu.abs().max())
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_cuda_moe_prefill_goes_through_the_kernel(cuda_device, arch):
    """A reduced mixtral's prefill of 80 tokens (past its window of 64) on
    the card launches the flash kernel once a layer and its decode (4
    steps into rolling caches) none, with logits within 1e-4 of the CPU's
    and the same summed expert counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.convert import tree_map
    from repro_torch.serve.serve_step import decode_step, prefill
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompt = 80
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, prompt + 4)))
    on_card = tree_map(lambda t: t.to(cuda_device), params)
    runs = []
    for p, toks in ((on_card, tokens.to(cuda_device)), (params, tokens)):
        n0 = FK.flash_attention.launches
        lg, caches, rolling = prefill(p, cfg, toks[:, :prompt],
                                      cache_len=prompt + 4)
        n1 = FK.flash_attention.launches
        assert rolling == {"moe": True}
        steps = [lg]
        for t in range(prompt, prompt + 4):
            lg, caches = decode_step(p, cfg, toks[:, t:t + 1], caches, t,
                                     rolling=rolling)
            steps.append(lg)
        n2 = FK.flash_attention.launches
        counts = forward(p, cfg, toks[:, :prompt]).expert_counts
        runs.append((torch.stack(steps).cpu().numpy(), n1 - n0, n2 - n1,
                     counts.cpu()))
    (card, pre, dec, counts), (cpu, pre_cpu, _, counts_cpu) = runs
    assert (pre, dec, pre_cpu) == (cfg.n_layers, 0, 0)
    assert torch.equal(counts, counts_cpu)
    scale = float(np.abs(cpu).max())
    assert float(np.abs(card - cpu).max()) <= 1e-4 * scale


# ------------------------------------------------- the f32 backward kernel
BWD_RTOL = 2e-4      # of each gradient's scale: the forward's tolerance

# (B, S, T, H, K, hd, causal, window, softcap)
BWD_CASES = [
    (8, 256, 256, 32, 8, 128, True, None, None),   # granite-8b's train shape
    (1, 200, 200, 8, 2, 32, True, None, None),     # ragged, GQA
    (2, 130, 300, 4, 1, 16, True, 64, None),       # T − S offset, window, MQA
    (2, 96, 96, 4, 4, 64, False, 32, None),        # a window without causal
    (1, 333, 200, 4, 2, 64, True, None, None),     # S > T: 133 dead rows
    (2, 300, 300, 16, 16, 256, True, None, None),  # gemma-7b's hd 256
    (2, 300, 300, 16, 16, 256, True, None, 30.0),  # ... soft-capped
    (1, 200, 200, 4, 2, 128, True, None, 20.0),    # a soft-cap at hd 128
    (2, 700, 700, 8, 4, 128, True, 256, None),     # a local window
    (2, 200, 517, 16, 16, 64, False, None, None),  # no mask, S < T
    (2, 517, 200, 16, 16, 64, False, None, None),  # no mask, S > T
]


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def check_backward(dev, B, S, T, H, K, hd, causal, window, softcap):
    """The backward kernel against the plain autograd on the same inputs,
    run twice bitwise; the forward's LSE against the plain version's."""
    q, k, v = tt(qkv_inputs(B, S, T, H, K, hd, seed=S + T + hd), dev)
    dout = torch.from_numpy(np.random.default_rng(hd).standard_normal(
        (B, S, H, hd)).astype(np.float32)).to(dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attention(q, k, v, **kw))   # lse: no change
    n0 = FK.flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert FK.flash_attention_bwd.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_ref(q, k, v, dout, **kw)
    errs = {name: rel_err(a, b) for name, a, b in zip(("dq", "dk", "dv"),
                                                       got, want)}
    want_lse = flash_attention_lse_ref(q, k, **kw)
    dead = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), dead)
    assert bool((lse[dead] > 0).all())
    errs["lse"] = rel_err(lse[~dead], want_lse[~dead])
    assert max(errs.values()) <= BWD_RTOL, errs
    for g in got:
        assert bool(torch.isfinite(g).all())
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,softcap", BWD_CASES)
def test_cuda_flash_backward_matches_plain_autograd(cuda_device, B, S, T, H,
                                                    K, hd, causal, window,
                                                    softcap):
    check_backward(cuda_device, B, S, T, H, K, hd, causal, window, softcap)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_flash_backward_every_head_width(cuda_device, hd):
    """Every built width; hd 64, 128 and 256 through flash_bwd_hopper, hd 16
    and 32 through the mma.sync kernel: the wrapper counts each call under
    the route the C entry dispatches on, and only that route's count
    moves."""
    want = "hopper" if hd >= 64 else "mma_sync"
    assert FK.bwd_route(hd) == want
    before = dict(FK.flash_attention_bwd.launches_by_route)
    check_backward(cuda_device, 1, 150, 190, 4, 2, hd, True, 100, None)
    moved = {r: n - before[r]
             for r, n in FK.flash_attention_bwd.launches_by_route.items()}
    assert moved == {r: 2 if r == want else 0 for r in FK.BWD_ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (4, 2048, 32, 8, 128, None),       # granite-8b's serve shape
    (4, 2048, 32, 16, 128, 1024),      # gemma3-27b's local layers
])
def test_cuda_flash_backward_at_serve_shapes(cuda_device, B, S, H, K, hd,
                                             window):
    check_backward(cuda_device, B, S, S, H, K, hd, True, window, None)


# flash_bwd_hopper's own edges (hd 64, 128, 256): GQA groups of 1, 4 and
# 6, S and T off the 64-row blocks and the column tiles (64 at hd 64 and
# 128, 16 at hd 256), windows with T − S ≠ 0, the soft-cap at hd 256, and
# query rows with no live key
HOPPER_BWD_CASES = [
    (1, 130, 130, 16, 16, 128, True, None, None),   # G 1
    (1, 130, 130, 32, 8, 128, True, None, None),    # G 4 (granite-8b's)
    (1, 130, 130, 48, 8, 128, True, None, None),    # G 6 (mixtral-8x22b's)
    (2, 77, 93, 4, 2, 64, True, None, None),        # S, T off every tile
    (1, 171, 250, 4, 2, 256, True, None, None),     # ... at hd 256
    (1, 150, 300, 8, 4, 128, True, 70, None),       # window, T − S = 150
    (1, 300, 150, 8, 4, 64, True, 40, None),        # window, T − S = −150
    (1, 200, 200, 4, 4, 256, True, 64, 30.0),       # soft-cap at hd 256
    (1, 100, 60, 4, 2, 256, True, None, None),      # 40 rows with no key
    (2, 90, 200, 4, 4, 256, False, None, 50.0),     # no mask, capped
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,softcap",
                         HOPPER_BWD_CASES)
def test_cuda_flash_backward_hopper_edges(cuda_device, B, S, T, H, K, hd,
                                          causal, window, softcap):
    n0 = FK.flash_attention_bwd.launches_by_route["hopper"]
    check_backward(cuda_device, B, S, T, H, K, hd, causal, window, softcap)
    assert FK.flash_attention_bwd.launches_by_route["hopper"] == n0 + 2


def rms_share(got, want, scale) -> float:
    """RMS of ``got − want`` over the RMS of ``scale``, in f64."""
    got, want, scale = (t.double().cpu() for t in (got, want, scale))
    return float((got - want).pow(2).mean().sqrt()
                 / scale.pow(2).mean().sqrt().clamp_min(1e-30))


BWD_BF16_RATIO = 2.0   # the kernel's distance / the plain bf16 one's own


def check_backward_bf16(dev, B, S, T, H, K, hd, causal, window, softcap):
    """The bf16 backward kernel against the plain autograd in bf16 on the
    same inputs, run twice bitwise, each gradient bf16 and within
    ``BWD_BF16_RATIO`` × the plain bf16 backward's own distance from the
    plain f32 backward, dQ 0 on the rows with no live key; one launch of
    the bf16 entry a call. Returns the ratios."""
    q, k, v = (t.bfloat16() for t in tt(qkv_inputs(B, S, T, H, K, hd,
                                                    seed=S + T + hd), dev))
    dout = torch.from_numpy(np.random.default_rng(hd).standard_normal(
        (B, S, H, hd)).astype(np.float32)).to(dev).bfloat16()
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    n0 = FK.flash_attention_bwd.launches_by_dtype[torch.bfloat16]
    got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert FK.flash_attention_bwd.launches_by_dtype[torch.bfloat16] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain16 = flash_attention_bwd_ref(q, k, v, dout, **kw)
    plain32 = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      dout.float(), **kw)
    ratios = {}
    for name, g, p16, p32 in zip(("dq", "dk", "dv"), got, plain16, plain32):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        own = rms_share(p16, p32, p32)
        ratios[name] = rms_share(g, p16, p32) / own
    assert max(ratios.values()) <= BWD_BF16_RATIO, ratios
    # a query row with no live key (LSE +inf) has dQ = 0
    dead = torch.isinf(lse).transpose(1, 2)          # (B, S, H)
    assert bool((got[0][dead] == 0).all())
    return ratios


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,S,T,H,K,causal,window,softcap", [
    (1, 150, 190, 4, 2, True, 100, None),       # window, T − S offset, GQA
    (2, 130, 130, 4, 1, True, None, 30.0),      # soft-capped, MQA
    (1, 300, 150, 8, 4, True, 40, None),        # S > T: rows with no key
    (2, 90, 200, 4, 4, False, None, 50.0),      # no mask, capped, S < T
])
def test_cuda_flash_bf16_backward_matches_plain(cuda_device, hd, B, S, T, H,
                                                K, causal, window, softcap):
    """Every built width; hd 64, 128 and 256 through flash_bwd_bf16_hopper,
    hd 16 and 32 through flash_bwd_kernel_bf16, as the wrapper's per-route
    count shows."""
    want = FK.bwd_route(hd)
    before = dict(FK.flash_attention_bwd.launches_by_route)
    check_backward_bf16(cuda_device, B, S, T, H, K, hd, causal, window,
                        softcap)
    moved = {r: n - before[r]
             for r, n in FK.flash_attention_bwd.launches_by_route.items()}
    assert moved == {r: 2 if r == want else 0 for r in FK.BWD_ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (8, 256, 32, 8, 128, None),        # granite-8b's train shape
    (8, 256, 48, 8, 128, 4096),        # mixtral-8x22b's, a group of 6
    (4, 2048, 32, 8, 128, None),       # granite-8b's serve shape
])
def test_cuda_flash_bf16_backward_at_train_shapes(cuda_device, B, S, H, K,
                                                  hd, window):
    """The train shapes, and granite-8b's serve shape: 16 key blocks of
    128 reach its last query tiles, so each of their dQ sums runs through
    15 adds in flash_bwd_bf16_hopper's fixed order (twice bitwise)."""
    check_backward_bf16(cuda_device, B, S, S, H, K, hd, True, window, None)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,softcap",
                         HOPPER_BWD_CASES)
def test_cuda_flash_bf16_backward_hopper_edges(cuda_device, B, S, T, H, K,
                                               hd, causal, window, softcap):
    """flash_bwd_bf16_hopper at the f32 Hopper kernel's edges: GQA groups
    of 1, 4 and 6, S and T off its tiles (128 keys a CTA and 64 queries a
    tile at hd 128, 128 and 128 at hd 64, 64 and 64 at hd 256), windows
    with T − S ≠ 0, the soft-cap at hd 256, and query tiles that no key
    reaches (their dQ zeroed by D's launch)."""
    n0 = FK.flash_attention_bwd.launches_by_route["hopper"]
    check_backward_bf16(cuda_device, B, S, T, H, K, hd, causal, window,
                        softcap)
    assert FK.flash_attention_bwd.launches_by_route["hopper"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,S,T,H,K,causal,window,softcap", [
    (2, 150, 190, 4, 2, True, 100, None),
    (1, 300, 150, 8, 4, True, None, 20.0),      # 150 rows with no live key
])
def test_cuda_flash_bf16_lse_matches_plain(cuda_device, hd, B, S, T, H, K,
                                           causal, window, softcap):
    """The bf16 forward's log-sum-exp against ``flash_attention_lse_ref``
    on the same bf16 inputs within ``BWD_RTOL`` of its scale, +inf exactly
    on the rows with no live key; asking for it leaves the output bit for
    bit as without it."""
    q, k, v = (t.bfloat16() for t in tt(qkv_inputs(B, S, T, H, K, hd,
                                                    seed=hd), cuda_device))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    want = flash_attention_lse_ref(q, k, **kw)
    dead = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] > 0).all())
    assert rel_err(lse[~dead], want[~dead]) <= BWD_RTOL


@pytest.mark.cuda
def test_cuda_flash_op_carries_gradients(cuda_device):
    """``flash_attention_op`` under autograd on the card: one forward and
    one backward launch, gradients within ``BWD_RTOL`` of the CPU's plain
    autograd through the same op."""
    arrays = qkv_inputs(2, 100, 100, 4, 2, 64, seed=3)
    dout = np.random.default_rng(4).standard_normal(
        (2, 100, 4, 64)).astype(np.float32)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        q, k, v = (t.requires_grad_(True) for t in tt(arrays, dev))
        n0, n1 = FK.flash_attention.launches, FK.flash_attention_bwd.launches
        out = flash_attention_op(q, k, v, window=40)
        out.backward(torch.from_numpy(dout).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (FK.flash_attention.launches - n0,
                    FK.flash_attention_bwd.launches - n1) == (1, 1)
        grads.append([q.grad, k.grad, v.grad])
    for a, b in zip(*grads):
        assert rel_err(a, b) <= BWD_RTOL


@pytest.mark.cuda
def test_cuda_entries_without_a_backward_raise_under_grad(cuda_device):
    """The Mamba-1 scan's bf16 entry has no backward kernel (no model
    trains through it: the reference upcasts before the scan): on the card
    it raises when an input requires grad (no silent detach); without grad
    it runs; under ``no_grad`` it runs. The bf16 flash and SSD entries have
    one: under grad each runs its forward (the flash with the LSE), and the
    backward launches the bf16 backward entry once, the gradients of the
    bf16 inputs bf16. The f32 entries of all three carry gradients (the
    tests above and below)."""
    from repro_torch.kernels.mamba_scan import selective_scan_op
    from repro_torch.kernels.ssd_scan import ssd_scan_op
    q, k, v = tt(qkv_inputs(1, 64, 64, 2, 2, 64), cuda_device)
    qb = q.bfloat16().requires_grad_(True)
    n0 = (FK.flash_attention.launches_by_dtype[torch.bfloat16],
          FK.flash_attention_bwd.launches_by_dtype[torch.bfloat16])
    flash_attention_op(qb, k.bfloat16(), v.bfloat16()).float().sum() \
        .backward()
    torch.cuda.synchronize()
    assert (FK.flash_attention.launches_by_dtype[torch.bfloat16] - n0[0],
            FK.flash_attention_bwd.launches_by_dtype[torch.bfloat16]
            - n0[1]) == (1, 1)
    assert qb.grad.dtype == torch.bfloat16
    with torch.no_grad():
        flash_attention_op(qb, k.bfloat16(), v.bfloat16())
    ts = tt(ssd_inputs(1, 64, 2, 16, 16), cuda_device)
    ts[0], ts[3], ts[4] = (t.bfloat16().requires_grad_(True)
                           for t in (ts[0], ts[3], ts[4]))
    n0 = (SK.ssd_scan.launches_by_dtype[torch.bfloat16],
          SK.ssd_scan_bwd.launches_by_dtype[torch.bfloat16])
    y, _ = ssd_scan_op(*ts)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert (SK.ssd_scan.launches_by_dtype[torch.bfloat16] - n0[0],
            SK.ssd_scan_bwd.launches_by_dtype[torch.bfloat16] - n0[1]) \
        == (1, 1)
    assert all(ts[i].grad.dtype == torch.bfloat16 for i in (0, 3, 4))
    ts = tt(scan_inputs(1, 64, 32, 16), cuda_device)
    ts[0], ts[3], ts[4] = (t.bfloat16() for t in (ts[0], ts[3], ts[4]))
    selective_scan_op(*ts)
    ts[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Mamba-1"):
        selective_scan_op(*ts)
    with torch.no_grad():
        selective_scan_op(*ts)


def check_scan_backward(kernel_bwd, plain_fwd, dev, args, h0, dh, **kw):
    """A scan's backward kernel against the plain forward's autograd on the
    same inputs, each gradient within ``BWD_RTOL`` of its scale, run twice
    bitwise, one launch a call."""
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(args[0].shape)).astype(np.float32)).to(dev)
    n0 = kernel_bwd.launches
    got = kernel_bwd(*args, dy, h0=h0, dh=dh, **kw)
    again = kernel_bwd(*args, dy, h0=h0, dh=dh, **kw)
    torch.cuda.synchronize()
    assert kernel_bwd.launches == n0 + 2
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))
    ins = [t.detach().clone().requires_grad_(True)
           for t in (*args, *(() if h0 is None else (h0,)))]
    y, h = plain_fwd(*ins[:6], h0=ins[6] if h0 is not None else None, **kw)
    outs, cots = [y], [dy]
    if dh is not None:
        outs.append(h)
        cots.append(dh)
    want = torch.autograd.grad(outs, ins, cots)
    assert (got[6] is None) == (h0 is None)
    for name, g, w in zip(("du", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                          got, want):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert rel_err(g, w) <= BWD_RTOL, (name, rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,S,dI,with_h0,with_dh", [
    (2, 300, 256, False, False),     # falcon-mamba-7b's reduced dI is 128
    (1, 1, 70, True, True),          # S = 1, dI off the CTA's channels
    (2, 77, 130, True, False),       # ragged S and dI
    (1, 4, 64, False, True),         # S one chunk of the backward
])
def test_cuda_scan_backward_matches_plain_autograd(cuda_device, N, B, S, dI,
                                                   with_h0, with_dh):
    args = tt(scan_inputs(B, S, dI, N, seed=S + dI), cuda_device)
    g = torch.Generator(cuda_device).manual_seed(N)
    h0 = (torch.randn(B, dI, N, device=cuda_device, generator=g)
          if with_h0 else None)
    dh = (torch.randn(B, dI, N, device=cuda_device, generator=g)
          if with_dh else None)
    check_scan_backward(MK.selective_scan_bwd, selective_scan_ref,
                        cuda_device, args, h0, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("hp", [16, 32, 64])
@pytest.mark.parametrize("B,S,H,with_h0,with_dh", [
    (1, 1, 2, True, True),           # S = 1
    (2, 150, 3, False, True),        # ragged over three chunks
])
def test_cuda_ssd_backward_every_width(cuda_device, N, hp, B, S, H, with_h0,
                                       with_dh):
    args = tt(ssd_inputs(B, S, H, hp, N, seed=S + hp), cuda_device)
    g = torch.Generator(cuda_device).manual_seed(N + hp)
    h0 = (torch.randn(B, H, N, hp, device=cuda_device, generator=g)
          if with_h0 else None)
    dh = (torch.randn(B, H, N, hp, device=cuda_device, generator=g)
          if with_dh else None)
    check_scan_backward(SK.ssd_scan_bwd, ssd_scan_ref, cuda_device, args, h0,
                        dh, chunk=SK.KERNEL_CHUNK)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hp,N,with_h0,with_dh", [
    (8, 256, 64, 64, 64, False, False),   # zamba2-1.2b's train shape
    (2, 64, 4, 64, 64, True, True),       # one chunk
    (1, 40, 4, 16, 16, True, False),      # under a chunk, reduced widths
    (2, 300, 4, 64, 64, True, True),      # five chunks: the states' scratch
    (1, 333, 3, 32, 16, True, True),      # six chunks, ragged, other widths
])
def test_cuda_ssd_backward_matches_plain_autograd(cuda_device, B, S, H, hp,
                                                  N, with_h0, with_dh):
    args = tt(ssd_inputs(B, S, H, hp, N, seed=S), cuda_device)
    g = torch.Generator(cuda_device).manual_seed(S)
    h0 = (torch.randn(B, H, N, hp, device=cuda_device, generator=g)
          if with_h0 else None)
    dh = (torch.randn(B, H, N, hp, device=cuda_device, generator=g)
          if with_dh else None)
    check_scan_backward(SK.ssd_scan_bwd, ssd_scan_ref, cuda_device, args, h0,
                        dh, chunk=SK.KERNEL_CHUNK)


def check_ssd_backward_bf16(dev, B, S, H, hp, N, with_h0, with_dh):
    """The bf16 entry's backward kernel against the plain backward on the
    same bf16 tensors on the card, run twice bitwise, one launch of the
    bf16 entry a call: du, dB and dC bf16 within one bf16 rounding plus
    ``BWD_RTOL`` of scale (the bf16 scans' rule), the f32 gradients within
    ``BWD_RTOL``."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref
    args = tt(ssd_inputs(B, S, H, hp, N, seed=S + hp + N), dev)
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    g = torch.Generator(dev).manual_seed(S + N)
    dy = torch.randn(B, S, H, hp, device=dev, generator=g).bfloat16()
    h0 = (torch.randn(B, H, N, hp, device=dev, generator=g)
          if with_h0 else None)
    dh = (torch.randn(B, H, N, hp, device=dev, generator=g)
          if with_dh else None)
    n0 = SK.ssd_scan_bwd.launches_by_dtype[torch.bfloat16]
    got = SK.ssd_scan_bwd(*args, dy, h0=h0, dh=dh)
    again = SK.ssd_scan_bwd(*args, dy, h0=h0, dh=dh)
    torch.cuda.synchronize()
    assert SK.ssd_scan_bwd.launches_by_dtype[torch.bfloat16] == n0 + 2
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))
    want = ssd_scan_bwd_ref(*args, dy, chunk=SK.KERNEL_CHUNK, h0=h0, dh=dh)
    assert (got[6] is None) == (h0 is None)
    for name, a, w in zip(("du", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                          got, want):
        if w is None:
            continue
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        if a.dtype == torch.bfloat16:
            within_bf16_rounding(a, w, BWD_RTOL)
        else:
            assert rel_err(a, w) <= BWD_RTOL, (name, rel_err(a, w))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hp,N,with_h0,with_dh", [
    (8, 256, 64, 64, 64, False, False),   # zamba2-1.2b's train shape
    (2, 1000, 64, 64, 64, True, True),    # ragged, 16 chunks
    (4, 40, 8, 16, 16, True, True),       # the reduced widths
    (1, 1, 2, 32, 16, True, True),        # S = 1
])
def test_cuda_ssd_backward_bf16_matches_plain(cuda_device, B, S, H, hp, N,
                                              with_h0, with_dh):
    check_ssd_backward_bf16(cuda_device, B, S, H, hp, N, with_h0, with_dh)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("hp", [16, 32, 64])
def test_cuda_ssd_backward_bf16_every_width(cuda_device, N, hp):
    check_ssd_backward_bf16(cuda_device, 2, 150, 3, hp, N, True, True)


@pytest.mark.cuda
def test_cuda_ssd_backward_bf16_routes(cuda_device):
    """The bf16 backward's route by (N, hp): (64, 64), zamba2-1.2b's,
    through the Hopper kernels, the other eight pairs through the mma.sync
    ones (the built library's answer)."""
    assert SK.bwd_hopper_route(64, 64)
    assert not any(SK.bwd_hopper_route(N, hp) for N in (16, 32, 64)
                   for hp in (16, 32, 64) if (N, hp) != (64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,with_h0,with_dh", [
    (2, 1, 3, True, True),        # S = 1
    (2, 40, 3, True, False),      # S under a chunk
    (2, 128, 3, False, True),     # S a multiple of the chunk
    (1, 200, 4, True, True),      # B = 1, ragged
    (3, 130, 5, True, True),      # an odd H, one step into a third chunk
])
def test_cuda_ssd_backward_bf16_hopper_route_matches_plain(
        cuda_device, B, S, H, with_h0, with_dh):
    """The Hopper route of the bf16 backward (N = hp = 64) at the sequence
    and batch edges, by the bf16 scans' rule, twice bitwise."""
    check_ssd_backward_bf16(cuda_device, B, S, H, 64, 64, with_h0, with_dh)


@pytest.mark.cuda
def test_cuda_ssd_backward_bf16_takes_views_off_a_16_byte_boundary(
        cuda_device):
    """The Hopper route reads u, dy, B and C by TMA, whose tensor maps want
    16-byte aligned bases: views that start 2 bytes past a boundary get
    aligned copies, and the gradients are the aligned call's bit for bit."""
    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view
    args = tt(ssd_inputs(2, 130, 3, 64, 64, seed=9), cuda_device)
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    g = torch.Generator(cuda_device).manual_seed(9)
    dy = torch.randn(2, 130, 3, 64, device=cuda_device,
                     generator=g).bfloat16()
    h0 = torch.randn(2, 3, 64, 64, device=cuda_device, generator=g)
    dh = torch.randn(2, 3, 64, 64, device=cuda_device, generator=g)
    want = SK.ssd_scan_bwd(*args, dy, h0=h0, dh=dh)
    moved = list(args)
    for i in (0, 3, 4):
        moved[i] = off(args[i])
    got = SK.ssd_scan_bwd(*moved, off(dy), h0=h0, dh=dh)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["selective_scan", "ssd_scan"])
def test_cuda_scan_ops_carry_gradients(cuda_device, which):
    """The scan ops under autograd on the card: one forward and one
    backward launch, the gradients of every input and of h0 within
    ``BWD_RTOL`` of the CPU's plain autograd through the same op; the bf16
    entries untouched."""
    from repro_torch.kernels.mamba_scan import selective_scan_op
    from repro_torch.kernels.ssd_scan import ssd_scan_op
    if which == "selective_scan":
        op, fwd, bwd = selective_scan_op, MK.selective_scan, \
            MK.selective_scan_bwd
        arrays = scan_inputs(2, 90, 48, 8, seed=3)
        h_shape = (2, 48, 8)
    else:
        op, fwd, bwd = ssd_scan_op, SK.ssd_scan, SK.ssd_scan_bwd
        arrays = ssd_inputs(2, 90, 3, 16, 16, seed=3)
        h_shape = (2, 3, 16, 16)
    rng = np.random.default_rng(4)
    h0 = rng.standard_normal(h_shape).astype(np.float32)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        ts = [t.requires_grad_(True) for t in tt([*arrays, h0], dev)]
        n0 = (fwd.launches_by_dtype[torch.float32], bwd.launches)
        y, h = op(*ts[:6], h0=ts[6])
        ((y ** 2).sum() + (h * h.detach()).sum()).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (fwd.launches_by_dtype[torch.float32] - n0[0],
                    bwd.launches - n0[1]) == (1, 1)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert rel_err(a, b) <= BWD_RTOL


def train_card_and_cpu(arch, dev, steps=3):
    """``steps`` train steps of ``arch``'s reduced configuration (f32, the
    launcher's AdamW settings) on the card and on the CPU from the same
    parameters and batches: for each, (losses, final parameters, the flash
    launches of each step (forward f32 entry, backward), the scans'
    (selective_scan forward f32 entry, backward, ssd_scan's the same),
    Adam's first moments after each step). The card's first moments are
    those of each step taken again on the card from the CPU's state before
    it, so they differ from the CPU's by 0.1 × that step's clipped
    gradients alone."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import FrontendStream
    from repro_torch.models import init_params
    from repro_torch.models.convert import leaves, tree_map
    from repro_torch.train import (AdamConfig, DataConfig, TokenStream,
                                   TrainConfig, adam_init, make_train_step)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    tcfg = TrainConfig(adam=AdamConfig(lr=3e-4, warmup_steps=10,
                                       total_steps=100))
    stream = FrontendStream(TokenStream(DataConfig(
        vocab=cfg.vocab, seq=40, batch=4)), cfg)
    base = init_params(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, tcfg)

    def moments(opt):
        return [t.detach().cpu().clone() for t in leaves(opt.mu)]

    out, states = {}, []
    for d in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.clone().to(d), base)
        opt = adam_init(params)
        losses, counts, scans, moms = [], [], [], []
        for s in range(steps):
            if d.type == "cpu":
                states.append(tree_map(lambda t: t.detach().clone(),
                                       (params, opt)))
            n0 = (FK.flash_attention.launches_by_dtype[torch.float32],
                  FK.flash_attention_bwd.launches)
            s0 = scan_launches()
            params, opt, m = step(params, opt, stream.batch(s))
            losses.append(float(m["loss"]))
            counts.append((FK.flash_attention.launches_by_dtype[
                torch.float32] - n0[0], FK.flash_attention_bwd.launches
                - n0[1]))
            scans.append(tuple(b - a for a, b in zip(s0, scan_launches())))
            moms.append(moments(opt))
        out[d.type] = [losses, [t.detach().cpu() for t in leaves(params)],
                       counts, scans, moms]
    out["cuda"][4] = [moments(step(*tree_map(lambda t: t.to(dev), state),
                                   stream.batch(s))[1])
                      for s, state in enumerate(states)]
    return cfg, out


def scan_launches():
    """(selective_scan f32 forwards, backwards, ssd_scan f32 forwards,
    backwards) launched so far."""
    f32 = torch.float32
    return (MK.selective_scan.launches_by_dtype[f32],
            MK.selective_scan_bwd.launches,
            SK.ssd_scan.launches_by_dtype[f32], SK.ssd_scan_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "gemma3-27b",
                                  "seamless-m4t-large-v2", "mixtral-8x7b"])
def test_cuda_reduced_training_matches_cpu(cuda_device, arch):
    """Three train steps of a reduced model (``make_train_step``) on the
    card and on the CPU from the same parameters and batches: each loss and
    the final parameters within 1e-4 of scale; each card step goes through
    the flash kernels (with both remat levels, 3·L − L/G forwards and L
    backwards over L attention calls of a segment, G = its group:
    ``train_step_launches``) and the CPU's through none."""
    from repro_torch.models.model import train_step_launches
    cfg, out = train_card_and_cpu(arch, cuda_device)
    (l_card, p_card, c_card, *_), (l_cpu, p_cpu, c_cpu, *_) = \
        out["cuda"], out["cpu"]
    for a, b in zip(l_card, l_cpu):
        assert abs(a - b) <= 1e-4 * abs(b)
    for a, b in zip(p_card, p_cpu):
        assert rel_err(a, b) <= 1e-4
    want = train_step_launches(cfg)
    assert c_card == [(want["flash_attention"],
                       want["flash_attention_bwd"])] * 3
    assert c_cpu == [(0, 0)] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "falcon-mamba-7b"])
def test_cuda_reduced_mamba_training_matches_cpu(cuda_device, arch):
    """Three train steps of a reduced Mamba-kind model on the card and on
    the CPU from the same parameters and batches: each loss and the final
    parameters within 1e-4 of scale; the leaves the model initialises at
    zero (``zero_leaves``: zamba2's conv and dt biases and LoRA
    up-projections, falcon's conv biases) are held by each step's
    gradients instead, through Adam's first moments after each step taken
    on the card from the CPU's state before it, within 1e-4 of scale:
    Adam's first steps put such an element at ±lr by the sign of a
    gradient that may be near zero, so its value's last digits follow the
    order of the sums (two correct CPU runs differing only in it: up to
    1.2e-3 of such a leaf's scale after 3 steps, its moments from the same
    state within 1.4e-5; ``tools/adam_order_noise.py``). The second
    moments, squares of the gradients, double their relative error and
    are not held (on the card with the plain scans: 9.6e-5 of scale,
    ``tools/card_moment_noise.py``). Each card step goes through the
    scans' f32 kernels and their backward kernels (and zamba2's shared
    attention through the flash kernels) as ``train_step_launches`` says;
    the CPU's steps launch nothing."""
    from repro_torch.models import init_params
    from repro_torch.models.convert import zero_leaves
    from repro_torch.models.model import train_step_launches
    cfg, out = train_card_and_cpu(arch, cuda_device)
    (l_card, p_card, c_card, s_card, m_card), \
        (l_cpu, p_cpu, c_cpu, s_cpu, m_cpu) = out["cuda"], out["cpu"]
    for a, b in zip(l_card, l_cpu):
        assert abs(a - b) <= 1e-4 * abs(b)
    zero = zero_leaves(init_params(cfg, torch.Generator().manual_seed(0)))
    assert any(zero)
    for a, b, z in zip(p_card, p_cpu, zero):
        assert z or rel_err(a, b) <= 1e-4
    for got, want in zip(m_card, m_cpu):
        for a, b, z in zip(got, want, zero):
            assert not z or rel_err(a, b) <= 1e-4
    want = train_step_launches(cfg)
    assert s_card == [(want["selective_scan"], want["selective_scan_bwd"],
                       want["ssd_scan"], want["ssd_scan_bwd"])] * 3
    assert s_cpu == [(0, 0, 0, 0)] * 3
    assert c_card == [(want["flash_attention"],
                       want["flash_attention_bwd"])] * 3
    assert c_cpu == [(0, 0)] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [("mixtral-8x7b", torch.float32),
                                        ("granite-8b", torch.bfloat16)])
def test_cuda_train_step_twice_bitwise(cuda_device, arch, dtype):
    """A reduced mixtral's f32 train step (its MoE gathers differentiate
    through ``index_add_``, whose atomics add at most top-k nonzero terms
    a row) and a reduced granite's bf16 step (through the bf16 flash
    entry and its backward): taken twice from the same state, every loss,
    gradient norm, weight and moment bitwise the same; the step's flash
    launches as ``train_step_launches`` counts them; the weights keep
    their dtypes and the moments are f32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import leaves, tree_map
    from repro_torch.models.model import train_step_launches
    from repro_torch.train import (AdamConfig, DataConfig, TokenStream,
                                   TrainConfig, adam_init, make_train_step)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    step = make_train_step(cfg, TrainConfig(adam=AdamConfig(
        lr=3e-4, warmup_steps=10, total_steps=100)))
    base = init_params(cfg, torch.Generator().manual_seed(0))
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq=40,
                                   batch=4)).batch(0)
    want = train_step_launches(cfg)
    fwd = "flash_attention" + ("_bf16" if dtype == torch.bfloat16 else "")
    bwd = "flash_attention_bwd" + ("_bf16" if dtype == torch.bfloat16 else "")
    runs = []
    for _ in range(2):
        params = tree_map(lambda t: t.clone().to(cuda_device), base)
        opt = adam_init(params)
        n0 = (FK.flash_attention.launches_by_dtype[dtype],
              FK.flash_attention_bwd.launches_by_dtype[dtype])
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        assert (FK.flash_attention.launches_by_dtype[dtype] - n0[0],
                FK.flash_attention_bwd.launches_by_dtype[dtype] - n0[1]) \
            == (want[fwd], want[bwd])
        runs.append([m["loss"], m["grad_norm"], *leaves(params),
                     *leaves(opt.mu), *leaves(opt.nu)])
        assert [t.dtype for t in leaves(params)] == \
            [t.dtype for t in leaves(base)]
        assert {t.dtype for t in leaves(opt.mu)} == {torch.float32}
    assert bool(torch.isfinite(runs[0][0]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
