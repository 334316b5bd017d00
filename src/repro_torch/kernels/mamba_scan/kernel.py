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

``selective_scan_bwd`` is the backward of the f32 entry
(``csrc/selective_scan_bwd.cu``, a library of its own, built beside this
one): the gradients of u, dt, A, B, C, D and h0 from the same inputs, the
gradient of y and that of the final state; on the CPU the plain version
(``selective_scan_bwd_ref``). ``selective_scan_bwd.launches`` counts its
launches. The kernel writes dA and dD as one partial a batch row and dB
and dC as one a CTA of channels; the wrapper sums them with ``torch.sum``
over that axis (no float atomics: bitwise run to run). The autograd
function that joins the two is ``ops.SelectiveScanF32``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import check_launch, load_library
from ..dtypes import ENTRY_DTYPES, check_dtypes
from .ref import selective_scan_bwd_ref, selective_scan_ref

SOURCES = [Path(__file__).parent / "csrc" / "selective_scan.cu"]
BWD_SOURCES = [Path(__file__).parent / "csrc" / "selective_scan_bwd.cu"]
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


def library_bwd() -> ctypes.CDLL:
    """The built backward library (built at first use)."""
    lib = load_library("selective_scan_bwd", BWD_SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.selective_scan_bwd_f32.argtypes = [_P] * 17 + [_I] * 4 + [_P]
        lib.selective_scan_bwd_f32.restype = _I
        lib.selective_scan_bwd_groups.argtypes = [_I, _I]
        lib.selective_scan_bwd_groups.restype = _I
        lib.selective_scan_bwd_smem_bytes.argtypes = [_I]
        lib.selective_scan_bwd_smem_bytes.restype = _I
        lib.selective_scan_bwd_chunk.argtypes = []
        lib.selective_scan_bwd_chunk.restype = _I
        lib.selective_scan_bwd_ctas_per_sm.argtypes = [_I]
        lib.selective_scan_bwd_ctas_per_sm.restype = _I
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


def selective_scan_bwd(u, dt, A, Bm, Cm, D, dy, *,
                       h0: Optional[torch.Tensor] = None,
                       dh: Optional[torch.Tensor] = None):
    """The gradients of ``selective_scan(u, dt, A, Bm, Cm, D, h0=h0)``'s
    outputs, given ``dy`` (B, S, dI), the gradient of y, and ``dh``
    (B, dI, N) or None, the gradient of the final state.

    Returns (du, ddt, dA, dB, dC, dD, dh0): dh0 is None unless h0 is
    given. On the card all float32 and contiguous (the bf16 entry has no
    backward), N one of ``KERNEL_N``, any S and dI; on the CPU the plain
    version."""
    dev = _check(u, dt, A, Bm, Cm, D, h0)
    B_, S, dI = u.shape
    N = A.shape[1]
    for name, t, shape in (("dy", dy, (B_, S, dI)), ("dh", dh, (B_, dI, N))):
        if t is not None and (tuple(t.shape) != shape or t.device != dev):
            raise ValueError(f"selective_scan_bwd: {name} {tuple(t.shape)} "
                             f"on {t.device}, expected {shape} on {dev}")
    if dev.type == "cpu":
        return selective_scan_bwd_ref(u, dt, A, Bm, Cm, D, dy, h0=h0, dh=dh)
    named = {"u": u, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "dy": dy,
             "h0": h0, "dh": dh}
    for name, t in named.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan_bwd: {name} is {t.dtype}; the "
                            f"backward kernel takes float32 (no model trains "
                            f"through a bf16 Mamba-1 scan: the reference "
                            f"upcasts u before it)")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_bwd: {name} is not contiguous")
    if N not in KERNEL_N:
        raise ValueError(f"selective_scan_bwd: N = {N} not built (one of "
                         f"{KERNEL_N})")
    # the kernel copies u, dt, dy, B and C in 16-byte pieces: a view that
    # starts off a 16-byte boundary is copied to a fresh allocation
    u, dt, dy, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (u, dt, dy, Bm, Cm))
    lib = library_bwd()
    G = lib.selective_scan_bwd_groups(dI, N)
    chunks = -(-S // lib.selective_scan_bwd_chunk())
    f32 = dict(dtype=torch.float32, device=dev)
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dA_p = torch.empty((B_, dI, N), **f32)
    bc_p = torch.empty((2, B_, G, S, N), **f32)   # dB's beside dC's
    dB_p, dC_p = bc_p
    dD_p = torch.empty((B_, dI), **f32)
    dh0 = None if h0 is None else torch.empty((B_, dI, N), **f32)
    if B_ * dI == 0:
        return (du, ddt, torch.zeros_like(A), torch.zeros_like(Bm),
                torch.zeros_like(Cm), torch.zeros_like(D), dh0)
    scratch = torch.empty((B_, chunks, dI, N), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.selective_scan_bwd_f32(
            *(ptr(t) for t in (u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt,
                               dA_p, dB_p, dC_p, dD_p, dh0, scratch)),
            B_, S, dI, N, stream)
    check_launch(rc, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    dB, dC = bc_p.sum(2)
    return du, ddt, dA_p.sum(0), dB, dC, dD_p.sum(0), dh0


selective_scan_bwd.launches = 0


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    selective_scan.launches = 0
    selective_scan.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
    selective_scan_bwd.launches = 0
