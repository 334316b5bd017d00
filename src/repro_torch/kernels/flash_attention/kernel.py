"""Wrapper of the Hopper flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention`` takes the reference's arguments
(``repro/kernels/flash_attention/kernel.py:flash_attention``) less its tile
sizes, which the kernels fix (f32: 64 query rows, 64 keys, 32 at hd 128
and 256; bf16 at hd 64, 128 and 256, the Hopper kernel with TMA and
``wgmma``: 128 query rows, 128 keys, 64 at hd 256; bf16 at hd 16 and 32:
64 query rows, 64 keys), and takes the soft-cap of the reference's
``_sdpa`` as ``softcap``.
For tensors on a CUDA device it launches the hand-written kernel on the
current stream and raises if the kernel does not take the arguments or the
launch fails; for tensors on the CPU it calls the plain PyTorch version
(``ref.py``). There is no other path. With ``return_lse`` either entry
also returns each row's log-sum-exp (B, H, S) f32, which the backward
recomputes P from.

``flash_attention_bwd`` is the backward of either entry
(``csrc/flash_attention_bwd.cu``, a library of its own, built beside this
one: ``flash_attention_bwd_f32`` and ``flash_attention_bwd_bf16``): dQ, dK
and dV in q's dtype from q, k, v, the forward's output and LSE and the
output's gradient; on the CPU it differentiates the plain version
(``flash_attention_bwd_ref``). The autograd function that joins the two
is ``ops.FlashAttentionFn``, through ``ops.flash_attention_op``.

On the card q, k and v are all float32 (``flash_attention_f32``) or all
bfloat16 (``flash_attention_bf16``, the reference's default dtype: bf16
products accumulated in f32, P rounded to bf16 before P·V, the output in
bf16); any other dtype or a mix raises ``TypeError``. A bf16 input is never
widened to reach the f32 kernel.

``flash_attention.launches`` counts kernel launches of either entry (one
per launch, nowhere else), so a run can show that it went through the
kernel; ``launches_by_dtype`` splits the count by entry.
``flash_attention_bwd.launches`` counts calls of either backward entry
that launched their kernels (one per call: its three launches, D, dQ, then
dK and dV together); ``launches_by_dtype`` splits the count by entry, and
``launches_by_route`` by the kernel that served the call, as the
library's ``flash_attention_bwd_route`` gives it for the head width (the
function both C entries dispatch on): ``"hopper"`` (``flash_bwd_hopper``,
TMA and ``wgmma``, hd 64, 128 and 256) or ``"mma_sync"``
(``flash_bwd_kernel`` or, bf16, ``flash_bwd_kernel_bf16``, hd 16 and 32).
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Optional

import torch

from ..build import check_launch, load_library, ptxas_resources
from ..dtypes import ENTRY_DTYPES, check_dtypes
from .ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                  flash_attention_ref)

_CSRC = Path(__file__).parent / "csrc"
SOURCES = [_CSRC / "flash_attention.cu", _CSRC / "split_tf32.cuh",
           _CSRC / "bf16_mma.cuh", Path(__file__).parent.parent / "hopper.cuh"]
BWD_SOURCES = [_CSRC / "flash_attention_bwd.cu", _CSRC / "split_tf32.cuh",
               _CSRC / "bf16_mma.cuh",
               Path(__file__).parent.parent / "hopper.cuh"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# head widths the kernel is built for (csrc: flash_attention_supported)
HEAD_WIDTHS = (16, 32, 64, 128, 256)


def library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    lib = load_library("flash_attention", SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.flash_attention_f32.argtypes = ([_P] * 4 + [_I] * 8
                                            + [ctypes.c_float, _P, _P])
        lib.flash_attention_f32.restype = _I
        lib.flash_attention_bf16.argtypes = ([_P] * 4 + [_I] * 8
                                             + [ctypes.c_float, _P, _P])
        lib.flash_attention_bf16.restype = _I
        lib.flash_attention_supported.argtypes = [_I]
        lib.flash_attention_supported.restype = _I
        lib._repro_typed = True
    return lib


def library_bwd() -> ctypes.CDLL:
    """The built backward library (built at first use)."""
    lib = load_library("flash_attention_bwd", BWD_SOURCES)
    if not getattr(lib, "_repro_typed", False):
        for fn in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16"):
            getattr(lib, fn).argtypes = ([_P] * 10 + [_I] * 8
                                         + [ctypes.c_float, _P])
            getattr(lib, fn).restype = _I
        for fn in ("flash_attention_bwd_route",
                   "flash_attention_bwd_smem_bytes",
                   "flash_attention_bwd_bf16_smem_bytes"):
            getattr(lib, fn).argtypes = [_I]
            getattr(lib, fn).restype = _I
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
    tensors: all float32 or all bfloat16, contiguous, 16-byte aligned, a
    head width it is built for (:data:`HEAD_WIDTHS`)."""
    check_dtypes("flash_attention", {"q": q, "k": k, "v": v})
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernel loads 16-byte rows)")
    hd = q.shape[3]
    if hd not in HEAD_WIDTHS:
        raise ValueError(f"flash_attention: head width {hd} not built "
                         f"({', '.join(map(str, HEAD_WIDTHS))})")


def _check_mask(window, softcap) -> None:
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    return_lse: bool = False):
    """q (B, S, H, hd); k/v (B, T, K, hd), H = K·G. → (B, S, H, hd), and
    with ``return_lse`` also each row's log-sum-exp (B, H, S) f32 (+inf for
    a row with no live key).

    ``window`` (> 0) keeps keys within ``window`` positions of the query;
    None keeps all. ``softcap`` (> 0) maps each scaled score s to
    ``softcap · tanh(s / softcap)`` before the mask; None leaves it. On the
    card: all f32 or all bf16, contiguous, hd ∈ {16, 32, 64, 128, 256}.
    """
    dev = _check(q, k, v)
    _check_mask(window, softcap)
    kw = dict(causal=causal, window=window, softcap=softcap)
    if dev.type == "cpu":
        out = flash_attention_ref(q, k, v, **kw)
        return (out, flash_attention_lse_ref(q, k, **kw)) if return_lse \
            else out
    check_kernel_args(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    lib = library()
    if not lib.flash_attention_supported(hd):
        raise RuntimeError(f"flash_attention: the built library does not "
                           f"take head width {hd}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = (lib.flash_attention_bf16 if q.dtype == torch.bfloat16
                 else lib.flash_attention_f32)
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, T, H, K, hd, int(causal), window or 0,
                   float(softcap or 0.0),
                   lse.data_ptr() if return_lse else None, stream)
    check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_dtype[q.dtype] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)``'s
    output, given its gradient ``dout`` (B, S, H, hd), the output ``out``
    and ``lse`` (B, H, S) of the same forward call (``return_lse=True``).
    On the card q, k, v, out and dout all f32 or all bf16 (the gradients in
    that dtype), lse f32, all contiguous; on the CPU the plain version's
    autograd (``out`` and ``lse`` unused)."""
    dev = _check(q, k, v)
    _check_mask(window, softcap)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.device != dev:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} on {t.device} does not fit "
                             f"q {tuple(q.shape)} on {dev}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if lse.shape != (B, H, S) or lse.device != dev:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} is "
                         f"not (B, H, S) = {(B, H, S)} on {dev}")
    if dev.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window, softcap=softcap)
    check_kernel_args(q, k, v)
    for name, t, dt in (("out", out, q.dtype), ("dout", dout, q.dtype),
                        ("lse", lse, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be {dt}, "
                             f"contiguous and 16-byte aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    lib = library_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = (lib.flash_attention_bwd_bf16 if q.dtype == torch.bfloat16
                 else lib.flash_attention_bwd_f32)
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), B, S, T, H, K, hd, int(causal),
            window or 0, float(softcap or 0.0), stream)
    check_launch(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_dtype[q.dtype] += 1
    flash_attention_bwd.launches_by_route[bwd_route(hd)] += 1
    return dq, dk, dv


BWD_ROUTES = ("hopper", "mma_sync")
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
flash_attention_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


def bwd_route(hd: int) -> str:
    """The backward kernel that serves head width ``hd`` on the card, as the
    built library reports it: ``"hopper"`` or ``"mma_sync"``."""
    route = library_bwd().flash_attention_bwd_route(hd)
    if route < 0:
        raise ValueError(f"flash_attention_bwd: head width {hd} not built")
    return BWD_ROUTES[1 - route]


def bwd_resources(library: str = "flash_attention_bwd") -> dict:
    """{"flash_bwd_hopper<hd,DQ|DKV,cap|nocap>" (the f32 entry's; the bf16
    entry's with ",bf16" before the ">"; or ``flash_bwd_kernel``,
    ``flash_bwd_kernel_bf16``): [registers, spill bytes]} of a backward
    library built in this process (empty if it was found built)."""
    out = {}
    for sym, res in ptxas_resources(library).items():
        m = re.search(r"(flash_bwd_(?:kernel_bf16|kernel|hopper))ILi(\d+)ELi"
                      r"(\d)ELb(\d)E(t?)", sym)
        if m:
            out[f"{m[1]}<{m[2]},{('DQ', 'DKV')[int(m[3])]},"
                f"{('nocap', 'cap')[int(m[4])]}{',bf16' if m[5] else ''}>"] \
                = res
    return out


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)
