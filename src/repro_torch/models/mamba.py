"""Mamba-2/SSD block (zamba2), the port's counterpart of the Mamba-2 half of
``repro.models.mamba``.

Prefill runs the SSD core through the fused ``ssd_scan`` op: the Hopper
kernel on the card, on the CPU its plain version, which computes the chunked
matmul form of the reference model (``repro/models/mamba.py:273-336``).
Decode keeps (conv_state, ssm_state) per layer and costs O(1) per token, in
plain PyTorch as in the reference. The depthwise causal conv is written, as
the reference writes it, as K shifted multiply-adds, so no convolution
library (and no cuDNN TF32) is involved.

Mamba-1 (falcon-mamba-7b) is the next slice (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
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
    version (CPU); the card's kernel computes in its own."""
    if bf16_einsum:
        raise NotImplementedError("bf16 SSD operands are not ported yet: "
                                  "ROADMAP queue 2 item 5")
    B_, S, d = x.shape
    conv_dim = p["conv_w"].shape[1]
    dI = p["out_proj"].shape[0]
    H = dI // headdim

    z, ubc, dt_raw = _split(x @ p["in_proj"], dI, conv_dim)
    conv_state = state.conv if state is not None else None
    ubc, new_conv = _causal_conv(p, ubc, conv_state)
    f32 = torch.float32
    u = ubc[..., :dI].to(f32).reshape(B_, S, H, headdim)
    Bm = ubc[..., dI:dI + d_state].to(f32)                   # (B,S,N)
    Cm = ubc[..., dI + d_state:].to(f32)
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
    ext = torch.cat([state.conv.to(ubc.dtype), ubc[:, None]], dim=1)
    K = ext.shape[1]
    yc = ext[:, 0] * p["conv_w"][0]
    for i in range(1, K):
        yc = yc + ext[:, i] * p["conv_w"][i]
    ubc = F.silu(yc + p["conv_b"])
    new_conv = ext[:, 1:].clone()
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
