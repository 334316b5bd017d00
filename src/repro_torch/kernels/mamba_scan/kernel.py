"""Wrapper of the Hopper selective-scan kernel (``csrc/selective_scan.cu``).

``selective_scan`` takes the reference's arguments in the reference's order
(``repro/kernels/mamba_scan/kernel.py:selective_scan``), with the optional
initial state ``h0``, and returns the same (y, h_final). For tensors on a
CUDA device it launches the hand-written kernel on the current stream and
raises if the kernel does not take the arguments or the launch fails; for
tensors on the CPU it calls the plain PyTorch version (``ref.py``). There is
no other path.

The reference's ``block_d`` (the TPU kernel's channel tile) has no
counterpart: the CUDA kernel tiles channels by the state width itself and
takes any d_inner.

On the card u, Bm and Cm are all float32 (``selective_scan_f32``) or all
bfloat16 (``selective_scan_bf16``: widened to f32 as they are loaded, y
returned in bf16); dt, A, D and h0 are float32 and the final state is
float32. Any other dtype or a mix raises ``TypeError``; a bf16 input is
never widened to reach the f32 entry.

``selective_scan.launches`` counts kernel launches of either entry (one
per launch, nowhere else), so a run can show that it went through the
kernel; ``launches_by_dtype`` splits the count by entry (u's dtype).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import check_launch, load_library
from ..dtypes import ENTRY_DTYPES, check_dtypes
from .ref import selective_scan_ref

SOURCES = [Path(__file__).parent / "csrc" / "selective_scan.cu"]
KERNEL_N = (4, 8, 16)      # state widths the kernel is built for (its switch)

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    lib = load_library("selective_scan", SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.selective_scan_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.selective_scan_f32.restype = _I
        lib.selective_scan_bf16.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.selective_scan_bf16.restype = _I
        lib._repro_typed = True
    return lib


def _check(u, dt, A, Bm, Cm, D, h0):
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: u must be (B, S, dI) and A "
                         f"(dI, N), got {tuple(u.shape)} and "
                         f"{tuple(A.shape)}")
    B_, S, dI = u.shape
    N = A.shape[1]
    want = {"dt": (B_, S, dI), "A": (dI, N), "Bm": (B_, S, N),
            "Cm": (B_, S, N), "D": (dI,)}
    if h0 is not None:
        want["h0"] = (B_, dI, N)
    got = {"dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "h0": h0}
    dev = u.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan: unsupported device {dev}")
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"selective_scan: {name} on {t.device}, u on "
                             f"{dev}")
    if S == 0:
        raise ValueError("selective_scan: empty sequence")
    return dev


def selective_scan(u, dt, A, Bm, Cm, D, *,
                   h0: Optional[torch.Tensor] = None):
    """u/dt (B, S, dI); A (dI, N); Bm/Cm (B, S, N); D (dI,);
    h0 (B, dI, N) or None (zeros).

    Returns (y (B, S, dI) in u's dtype, h_final (B, dI, N) f32). On the
    card: u, Bm, Cm all f32 or all bf16, the rest f32; contiguous; N one of
    ``KERNEL_N``; any S and dI.
    """
    dev = _check(u, dt, A, Bm, Cm, D, h0)
    if dev.type == "cpu":
        return selective_scan_ref(u, dt, A, Bm, Cm, D, h0=h0)
    stream = {"u": u, "Bm": Bm, "Cm": Cm}
    f32 = {"dt": dt, "A": A, "D": D}
    if h0 is not None:
        f32["h0"] = h0
    check_dtypes("selective_scan", stream, f32)
    for name, t in {**stream, **f32}.items():
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} is not contiguous")
    # the kernel copies u, dt, B and C in 16-byte pieces: a view that
    # starts off a 16-byte boundary is copied to a fresh allocation
    u, dt, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (u, dt, Bm, Cm))
    B_, S, dI = u.shape
    N = A.shape[1]
    if N not in KERNEL_N:
        raise ValueError(f"selective_scan: N = {N} not built (one of "
                         f"{KERNEL_N})")
    lib = library()
    y = torch.empty_like(u)
    h = torch.empty((B_, dI, N), dtype=torch.float32, device=dev)
    if B_ * dI == 0:
        return y, h
    entry = lib.selective_scan_bf16 if u.dtype == torch.bfloat16 else \
        lib.selective_scan_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), D.data_ptr(),
                   None if h0 is None else h0.data_ptr(), y.data_ptr(),
                   h.data_ptr(), B_, S, dI, N, stream)
    check_launch(rc, "selective_scan")
    selective_scan.launches += 1
    selective_scan.launches_by_dtype[u.dtype] += 1
    return y, h


selective_scan.launches = 0
selective_scan.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)


def reset_launches() -> None:
    """Set the wrapper's launch counts to 0."""
    selective_scan.launches = 0
    selective_scan.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
