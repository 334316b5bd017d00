"""Wrapper of the Hopper fused SSD scan kernel (``csrc/ssd_scan.cu``).

``ssd_scan`` takes the reference's arguments in the reference's order
(``repro/kernels/ssd_scan/kernel.py:ssd_scan``), plus an optional initial
state ``h0``, and returns the same (y, h_final). For tensors on a CUDA device
it launches the hand-written kernel on the current stream and raises if the
kernel does not take the arguments or the launch fails; for tensors on the
CPU it calls the plain PyTorch version (``ref.py``). There is no other path.

``chunk`` is the chunk length of the plain version and is used for CPU
tensors only; by default the plain version takes the kernel's own,
``KERNEL_CHUNK``. On the card the kernel always computes in chunks of
``KERNEL_CHUNK`` = 64 steps (``ssd_scan_chunk`` in the source), which fit two
CTAs to an SM, whatever ``chunk`` is: the result is chunk-invariant up to
rounding.

``ssd_scan.launches`` counts kernel launches (one per launch, nowhere
else), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import check_launch, load_library
from .ref import ssd_scan_ref

SOURCES = [Path(__file__).parent / "csrc" / "ssd_scan.cu"]
KERNEL_CHUNK = 64          # the kernel's chunk length, ssd_scan_chunk()

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    lib = load_library("ssd_scan", SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.ssd_scan_f32.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.ssd_scan_f32.restype = _I
        lib.ssd_scan_supported.argtypes = [_I, _I]
        lib.ssd_scan_supported.restype = _I
        lib.ssd_scan_chunk.argtypes = []
        lib.ssd_scan_chunk.restype = _I
        lib._repro_typed = True
    return lib


def _check(u, dt, A, Bm, Cm, D, h0):
    if u.dim() != 4:
        raise ValueError(f"ssd_scan: u must be (B, S, H, hp), got "
                         f"{tuple(u.shape)}")
    B_, S, H, hp = u.shape
    N = Bm.shape[-1]
    want = {"dt": (B_, S, H), "A": (H,), "Bm": (B_, S, N), "Cm": (B_, S, N),
            "D": (H,)}
    if h0 is not None:
        want["h0"] = (B_, H, N, hp)
    got = {"dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "h0": h0}
    dev = u.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} on {t.device}, u on {dev}")
    if S == 0:
        raise ValueError("ssd_scan: empty sequence")
    return dev


def ssd_scan(u, dt, A, Bm, Cm, D, *, chunk: Optional[int] = None,
             h0: Optional[torch.Tensor] = None):
    """u (B, S, H, hp); dt (B, S, H); A/D (H,); Bm/Cm (B, S, N);
    h0 (B, H, N, hp) or None (zeros); chunk: the plain version's chunk
    length (CPU only; None: ``KERNEL_CHUNK``, which the card always uses).

    Returns (y (B, S, H, hp), h_final (B, H, N, hp)). On the card: f32,
    contiguous, N and hp each 16, 32 or 64; any S.
    """
    dev = _check(u, dt, A, Bm, Cm, D, h0)
    if dev.type == "cpu":
        return ssd_scan_ref(u, dt, A, Bm, Cm, D,
                            chunk=chunk or KERNEL_CHUNK, h0=h0)
    args = {"u": u, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    if h0 is not None:
        args["h0"] = h0
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}; the kernel "
                            f"takes torch.float32 (bf16 is later work)")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} is not contiguous")
    # the kernel copies u, B and C in 16-byte pieces: a view that starts
    # off a 16-byte boundary is copied to a fresh allocation
    u, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (u, Bm, Cm))
    B_, S, H, hp = u.shape
    N = Bm.shape[-1]
    lib = library()
    if not lib.ssd_scan_supported(N, hp):
        raise ValueError(f"ssd_scan: (N, hp) = ({N}, {hp}) not built "
                         f"(each of 16, 32, 64)")
    y = torch.empty_like(u)
    h = torch.empty((B_, H, N, hp), dtype=torch.float32, device=dev)
    if B_ * H == 0:
        return y, h
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_f32(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            B_, S, H, N, hp, stream)
    check_launch(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    ssd_scan.launches = 0
