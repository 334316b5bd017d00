"""Mamba-1 (falcon-mamba-7b) and Mamba-2/SSD (zamba2) blocks, the port's
counterpart of ``repro.models.mamba``.

Prefill runs each block's scan through a fused op: Mamba-1's diagonal-A
recurrence through ``selective_scan`` and the Mamba-2 SSD core through
``ssd_scan`` — the Hopper kernels on the card, on the CPU their plain
versions. The reference model computes the same cores in its own forms (a
two-level ``lax.scan`` for Mamba-1, ``repro/models/mamba.py:148-173``; the
chunked matmul form for Mamba-2, ``:273-336``); the results agree up to
rounding. Decode keeps (conv_state, ssm_state) per layer and costs O(1) per
token, in plain PyTorch as in the reference. The depthwise causal conv is
written, as the reference writes it, as K shifted multiply-adds, so no
convolution library (and no cuDNN TF32) is involved.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.mamba_scan import selective_scan_op
from ..kernels.ssd_scan import ssd_scan_op
from .layers import normal

Params = Dict[str, Any]


def _rms(x, w, eps=1e-6):
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * w.to(torch.float32)).to(x.dtype)


def _causal_conv(p: Params, u, conv_state=None):
    """Depthwise causal conv along S. Returns (y, new_conv_state)."""
    K, dI = p["conv_w"].shape
    B_, S, _ = u.shape
    if conv_state is None:
        pad = torch.zeros((B_, K - 1, dI), dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)                    # (B, S+K-1, dI)
    y = ext[:, 0:S, :] * p["conv_w"][0][None, None, :]
    for i in range(1, K):
        y = y + ext[:, i:i + S, :] * p["conv_w"][i][None, None, :]
    y = y + p["conv_b"]
    # a copy, so that the state does not hold the whole (B, S+K-1, dI) ext
    new_state = ext[:, ext.shape[1] - (K - 1):, :].clone()
    return F.silu(y), new_state


def _conv_step(p: Params, conv_state, x):
    """One decode step of the depthwise causal conv: the state's K−1 rows
    and the new row ``x`` (B, C), multiply-added over the K taps. Returns
    (silu(y), new_conv_state)."""
    ext = torch.cat([conv_state.to(x.dtype), x[:, None]], dim=1)  # (B, K, C)
    y = ext[:, 0] * p["conv_w"][0]
    for i in range(1, ext.shape[1]):
        y = y + ext[:, i] * p["conv_w"][i]
    return F.silu(y + p["conv_b"]), ext[:, 1:].clone()


# =================================================================== Mamba-1
class Mamba1State(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, d_inner)
    ssm: torch.Tensor      # (B, d_inner, d_state) — always f32


def init_mamba1(gen: torch.Generator, d_model: int, *, d_state: int = 16,
                d_conv: int = 4, expand: int = 2,
                dt_rank: Optional[int] = None, bcdt_rms: bool = False,
                dtype=torch.float32) -> Params:
    """The reference's distributions (``repro/models/mamba.py:46-73``),
    drawn from ``gen`` on its device."""
    dI = expand * d_model
    R = dt_rank or max(d_model // 16, 1)
    dev = gen.device
    f32 = torch.float32
    sI = 1.0 / math.sqrt(dI)
    p = {
        "in_proj": normal(gen, (d_model, 2 * dI), 1.0 / math.sqrt(d_model),
                          dtype),
        "conv_w": normal(gen, (d_conv, dI), 0.5, dtype),
        "conv_b": torch.zeros((dI,), dtype=dtype, device=dev),
        "x_proj": normal(gen, (dI, R + 2 * d_state), sI, dtype),
        "dt_proj": normal(gen, (R, dI), 1.0 / math.sqrt(R), dtype),
    }
    # softplus-inverse of dt drawn log-uniformly from [0.001, 0.1]
    lo, hi = math.log(0.001), math.log(0.1)
    dt0 = torch.exp(torch.rand((dI,), generator=gen, dtype=f32, device=dev)
                    * (hi - lo) + lo)
    p["dt_bias"] = torch.log(torch.exp(dt0) - 1.0 + 1e-6)
    p["A_log"] = torch.log(torch.arange(1, d_state + 1, dtype=f32,
                                        device=dev)[None].repeat(dI, 1))
    p["D"] = torch.ones((dI,), dtype=f32, device=dev)
    p["out_proj"] = normal(gen, (dI, d_model), sI, dtype)
    if bcdt_rms:
        p["b_norm"] = torch.ones((d_state,), dtype=f32, device=dev)
        p["c_norm"] = torch.ones((d_state,), dtype=f32, device=dev)
        p["dt_norm"] = torch.ones((R,), dtype=f32, device=dev)
    return p


def _mamba1_inputs(p: Params, x):
    """The input projection, split: (u, z), each (B, S, dI)."""
    dI = p["conv_w"].shape[1]
    xz = x @ p["in_proj"]
    return xz[..., :dI], xz[..., dI:]


def _mamba1_ssm_params(p: Params, u, *, d_state: int, bcdt_rms: bool):
    """x_proj → (dt_r, B, C) → RMS norms → dt = softplus(dt_r·dt_proj +
    dt_bias). Returns (dt, B, C), f32."""
    R = p["dt_proj"].shape[0]
    proj = u @ p["x_proj"]                                   # (B, S, R+2N)
    dt_r = proj[..., :R]
    Bm = proj[..., R:R + d_state]
    Cm = proj[..., R + d_state:]
    if bcdt_rms:
        dt_r = _rms(dt_r, p["dt_norm"])
        Bm = _rms(Bm, p["b_norm"])
        Cm = _rms(Cm, p["c_norm"])
    f32 = torch.float32
    dt = F.softplus((dt_r @ p["dt_proj"]).to(f32) + p["dt_bias"])
    return dt, Bm.to(f32), Cm.to(f32)


def mamba1_forward(p: Params, x, *, d_state: int = 16,
                   bcdt_rms: bool = False,
                   state: Optional[Mamba1State] = None,
                   return_state: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Mamba1State]]:
    """Full-sequence Mamba-1 with the scan in ``selective_scan``.
    x (B, S, d) → (B, S, d). The reference's ``chunk`` (its two-level
    scan's chunk) has no counterpart: the selective scan walks time without
    chunks, and the reference's result is chunk-invariant up to rounding
    (tests/test_kernel_mamba_scan.py)."""
    u, z = _mamba1_inputs(p, x)
    conv_state = state.conv if state is not None else None
    u, new_conv = _causal_conv(p, u, conv_state)
    dt, Bm, Cm = _mamba1_ssm_params(p, u, d_state=d_state, bcdt_rms=bcdt_rms)
    A = -torch.exp(p["A_log"])                               # (dI, N)
    h0 = state.ssm if state is not None else None
    y, h_fin = selective_scan_op(u.to(torch.float32), dt, A, Bm, Cm, p["D"],
                                 h0=h0)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    new_state = Mamba1State(new_conv, h_fin) if return_state else None
    return out, new_state


def mamba1_step(p: Params, x, state: Mamba1State, *, d_state: int = 16,
                bcdt_rms: bool = False) -> Tuple[torch.Tensor, Mamba1State]:
    """Single-token decode. x (B, 1, d)."""
    u, z = _mamba1_inputs(p, x[:, 0])                        # (B, dI)
    u, new_conv = _conv_step(p, state.conv, u)
    dt, Bm, Cm = _mamba1_ssm_params(p, u, d_state=d_state, bcdt_rms=bcdt_rms)
    A = -torch.exp(p["A_log"])
    uf = u.to(torch.float32)
    dA = torch.exp(dt[:, :, None] * A[None])                 # (B, dI, N)
    h = dA * state.ssm + (dt * uf)[:, :, None] * Bm[:, None, :]
    y = (h * Cm[:, None, :]).sum(-1) + uf * p["D"][None]
    y = y.to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], Mamba1State(new_conv, h)


def make_mamba1_state(batch: int, d_model: int, *, d_state: int = 16,
                      d_conv: int = 4, expand: int = 2, dtype=torch.float32,
                      device=None) -> Mamba1State:
    """Zero conv and SSM state, on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    dI = expand * d_model
    return Mamba1State(
        torch.zeros((batch, d_conv - 1, dI), dtype=dtype, device=device),
        torch.zeros((batch, dI, d_state), dtype=torch.float32,
                    device=device))


# =================================================================== Mamba-2
class Mamba2State(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, conv_dim)
    ssm: torch.Tensor      # (B, H, headdim, d_state) f32


def init_mamba2(gen: torch.Generator, d_model: int, *, d_state: int = 64,
                d_conv: int = 4, expand: int = 2, headdim: int = 64,
                dtype=torch.float32) -> Params:
    dI = expand * d_model
    H = dI // headdim
    conv_dim = dI + 2 * d_state
    dev = gen.device
    f32 = torch.float32
    return {
        # projects to [z (dI), u (dI), B (N), C (N), dt (H)]
        "in_proj": normal(gen, (d_model, 2 * dI + 2 * d_state + H),
                          1.0 / math.sqrt(d_model), dtype),
        "conv_w": normal(gen, (d_conv, conv_dim), 0.5, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "norm": torch.ones((dI,), dtype=dtype, device=dev),
        "out_proj": normal(gen, (dI, d_model), 1.0 / math.sqrt(dI), dtype),
    }


def _split(zxbcdt, dI: int, conv_dim: int):
    """(…, 2 dI + 2N + H) → z (…, dI), ubc (…, conv_dim), dt_raw (…, H)."""
    return (zxbcdt[..., :dI], zxbcdt[..., dI:dI + conv_dim],
            zxbcdt[..., dI + conv_dim:])


def mamba2_forward(p: Params, x, *, d_state: int = 64, headdim: int = 64,
                   chunk: int = 128, bf16_einsum: bool = False,
                   state: Optional[Mamba2State] = None,
                   return_state: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
    """Full-sequence Mamba-2 with the SSD core in ``ssd_scan``.
    x (B, S, d) → (B, S, d). ``chunk`` is the SSD chunk of the plain
    version (CPU); the card's kernel computes in its own.

    ``bf16_einsum`` (the reference's ``ssm_bf16`` path) takes the
    reference's stream dtype ``sd = x.dtype`` for u, B and C, which reach
    the scan in it (a bf16 model: the scan's bf16 entry, y back in bf16);
    dt, A and D stay f32, as the reference keeps them. The scan computes in
    f32 where the reference's einsums round their operands (decays, M, the
    chunk states) to bf16 (``repro/models/mamba.py:294-333``), so this path
    is held to the reference within the bf16 tolerance, not bit for bit; in
    an f32 model it does no rounding at all, where the reference rounds
    those operands all the same.
    """
    B_, S, d = x.shape
    conv_dim = p["conv_w"].shape[1]
    dI = p["out_proj"].shape[0]
    H = dI // headdim

    z, ubc, dt_raw = _split(x @ p["in_proj"], dI, conv_dim)
    conv_state = state.conv if state is not None else None
    ubc, new_conv = _causal_conv(p, ubc, conv_state)
    f32 = torch.float32
    sd = x.dtype if bf16_einsum else f32        # the reference's stream dtype
    u = ubc[..., :dI].to(sd).reshape(B_, S, H, headdim)
    Bm = ubc[..., dI:dI + d_state].to(sd)                    # (B,S,N)
    Cm = ubc[..., dI + d_state:].to(sd)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])           # (B,S,H)
    A = -torch.exp(p["A_log"])                               # (H,)
    h0 = state.ssm.transpose(-1, -2) if state is not None else None
    y, h_fin = ssd_scan_op(u, dt, A, Bm, Cm, p["D"], chunk=chunk, h0=h0)
    y = y.reshape(B_, S, dI).to(x.dtype)
    y = _rms(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"]
    new_state = None
    if return_state:
        new_state = Mamba2State(new_conv, h_fin.transpose(-1, -2))
    return out, new_state


def mamba2_step(p: Params, x, state: Mamba2State, *, d_state: int = 64,
                headdim: int = 64) -> Tuple[torch.Tensor, Mamba2State]:
    """Single-token decode. x (B, 1, d)."""
    B_ = x.shape[0]
    dI = p["out_proj"].shape[0]
    H = dI // headdim
    conv_dim = p["conv_w"].shape[1]
    z, ubc, dt_raw = _split(x[:, 0] @ p["in_proj"], dI, conv_dim)
    ubc, new_conv = _conv_step(p, state.conv, ubc)
    f32 = torch.float32
    u = ubc[:, :dI].to(f32).reshape(B_, H, headdim)
    Bm = ubc[:, dI:dI + d_state].to(f32)
    Cm = ubc[:, dI + d_state:].to(f32)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])           # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None])                             # (B,H)
    h = state.ssm * dA[:, :, None, None] \
        + (dt[:, :, None] * u)[:, :, :, None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm) + u * p["D"][None, :, None]
    y = y.reshape(B_, dI).to(x.dtype)
    y = _rms(y * F.silu(z), p["norm"])
    return (y @ p["out_proj"])[:, None], Mamba2State(new_conv, h)


def make_mamba2_state(batch: int, d_model: int, *, d_state: int = 64,
                      d_conv: int = 4, expand: int = 2, headdim: int = 64,
                      dtype=torch.float32, device=None) -> Mamba2State:
    """Zero conv and SSM state, on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    dI = expand * d_model
    H = dI // headdim
    conv_dim = dI + 2 * d_state
    return Mamba2State(
        torch.zeros((batch, d_conv - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, H, headdim, d_state), dtype=torch.float32,
                    device=device))
