"""Wrapper of the Hopper flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention`` takes the reference's arguments
(``repro/kernels/flash_attention/kernel.py:flash_attention``) less its tile
sizes, which the kernel fixes (64 query rows, 64 keys; 32 keys at hd 128
and 256), and takes the soft-cap of the reference's ``_sdpa`` as
``softcap``.
For tensors on a CUDA device it launches the hand-written kernel on the
current stream and raises if the kernel does not take the arguments or the
launch fails; for tensors on the CPU it calls the plain PyTorch version
(``ref.py``). There is no other path.

``flash_attention.launches`` counts kernel launches (one per launch,
nowhere else), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import check_launch, load_library
from .ref import flash_attention_ref

SOURCES = [Path(__file__).parent / "csrc" / "flash_attention.cu"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# head widths the kernel is built for (csrc: flash_attention_supported)
HEAD_WIDTHS = (16, 32, 64, 128, 256)


def library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    lib = load_library("flash_attention", SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.flash_attention_f32.argtypes = ([_P] * 4 + [_I] * 8
                                            + [ctypes.c_float, _P])
        lib.flash_attention_f32.restype = _I
        lib.flash_attention_supported.argtypes = [_I]
        lib.flash_attention_supported.restype = _I
        lib._repro_typed = True
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "(B, S, H, hd) / (B, T, K, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {dev}")
    return dev


def check_kernel_args(q, k, v) -> None:
    """Raise unless the CUDA kernel takes these (already shape-checked)
    tensors: f32, contiguous, 16-byte aligned, a head width it is built
    for (:data:`HEAD_WIDTHS`)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            f"kernel takes torch.float32 (bf16 is later work)")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernel loads 16-byte rows)")
    hd = q.shape[3]
    if hd not in HEAD_WIDTHS:
        raise ValueError(f"flash_attention: head width {hd} not built "
                         f"({', '.join(map(str, HEAD_WIDTHS))})")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q (B, S, H, hd); k/v (B, T, K, hd), H = K·G. → (B, S, H, hd).

    ``window`` (> 0) keeps keys within ``window`` positions of the query;
    None keeps all. ``softcap`` (> 0) maps each scaled score s to
    ``softcap · tanh(s / softcap)`` before the mask; None leaves it. On the
    card: f32, contiguous, hd ∈ {16, 32, 64, 128, 256}.
    """
    dev = _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    check_kernel_args(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    lib = library()
    if not lib.flash_attention_supported(hd):
        raise RuntimeError(f"flash_attention: the built library does not "
                           f"take head width {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, hd, int(causal), window or 0,
            float(softcap or 0.0), stream)
    check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    flash_attention.launches = 0
