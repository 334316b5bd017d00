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

On the card u, Bm and Cm are all float32 (``ssd_scan_f32``) or all
bfloat16 (``ssd_scan_bf16``, y returned in bf16); dt, A, D and h0 are
float32 and the final state is float32. Any other dtype or a mix raises
``TypeError``; a bf16 input is never widened to reach the f32 entry. The
bf16 entry has two routes, fixed by (N, hp) (``hopper_route``): (64, 64),
zamba2-1.2b's, runs ``ssd_bf16_hopper`` (TMA loads of the bf16 tiles,
``wgmma`` with the bf16 operands as they are and the f32 ones in two bf16
pieces); the other eight pairs run the ``mma.sync`` kernel that widens u, B
and C to f32 as it loads them. Neither falls back to the other.

``ssd_scan.launches`` counts kernel launches of either entry (one per
launch, nowhere else), so a run can show that it went through the kernel;
``launches_by_dtype`` splits the count by entry (u's dtype).

``ssd_scan_bwd`` is the backward of both entries (``csrc/ssd_scan_bwd.cu``,
a library of its own, built beside this one, with an entry for each:
``ssd_scan_bwd_f32`` and ``ssd_scan_bwd_bf16``): the gradients of u, dt, A,
B, C, D and h0 from the same inputs, the gradient of y and that of the
final state, in the kernel's chunks of ``KERNEL_CHUNK``; on the CPU the
plain version (``ssd_scan_bwd_ref``). The bf16 entry takes u, B, C and dy
in bf16 (dy is y's gradient, and y is bf16) and gives du, dB and dC in
bf16, each rounded once from its f32 sum; dt, A, D, h0, dh and their
gradients are f32, as in the forward. ``ssd_scan_bwd.launches`` counts its
launches (``launches_by_dtype`` by entry): one a call, which runs two
kernels (the chunks' entering states and leaving adjoints into a scratch
tensor, then every chunk at once). They write dB and dC as one f32 partial
a head and dA and dD as one a (batch, head, chunk); the wrapper sums them
with ``torch.sum`` over those axes (no float atomics: bitwise run to run)
and only then rounds dB and dC to bf16. The bf16 backward has the
forward's two routes, fixed by (N, hp) (``bwd_hopper_route``): (64, 64)
runs ``ssd_bwd_states_bf16_hopper`` and ``ssd_bwd_chunks_bf16_hopper``
(TMA loads of the bf16 tiles and of the states' bf16 pieces, ``wgmma`` with
the bf16 operands as they are and the f32 ones in two bf16 pieces); the
other eight pairs run the ``mma.sync`` kernels that widen to f32 tiles.
Neither falls back to the other. The autograd function that joins forward
and backward is ``ops.SsdScan``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import check_launch, load_library
from ..dtypes import ENTRY_DTYPES, check_dtypes
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

_HEADERS = [Path(__file__).parent.parent / "hopper.cuh",
            Path(__file__).parent.parent / "ssd_hopper.cuh"]
SOURCES = [Path(__file__).parent / "csrc" / "ssd_scan.cu", *_HEADERS]
BWD_SOURCES = [Path(__file__).parent / "csrc" / "ssd_scan_bwd.cu", *_HEADERS]
KERNEL_CHUNK = 64          # the kernel's chunk length, ssd_scan_chunk()

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    lib = load_library("ssd_scan", SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.ssd_scan_f32.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.ssd_scan_f32.restype = _I
        lib.ssd_scan_bf16.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.ssd_scan_bf16.restype = _I
        lib.ssd_scan_supported.argtypes = [_I, _I]
        lib.ssd_scan_supported.restype = _I
        lib.ssd_scan_chunk.argtypes = []
        lib.ssd_scan_chunk.restype = _I
        lib.ssd_scan_bf16_hopper.argtypes = [_I, _I]
        lib.ssd_scan_bf16_hopper.restype = _I
        lib._repro_typed = True
    return lib


def library_bwd() -> ctypes.CDLL:
    """The built backward library (built at first use)."""
    lib = load_library("ssd_scan_bwd", BWD_SOURCES)
    if not getattr(lib, "_repro_typed", False):
        for fn in (lib.ssd_scan_bwd_f32, lib.ssd_scan_bwd_bf16):
            fn.argtypes = [_P] * 17 + [_I] * 5 + [_P]
            fn.restype = _I
        for fn in (lib.ssd_scan_bwd_kernel_smem_bytes,
                   lib.ssd_scan_bwd_bf16_kernel_smem_bytes,
                   lib.ssd_scan_bwd_ctas_per_sm,
                   lib.ssd_scan_bwd_bf16_ctas_per_sm):
            fn.argtypes = [_I, _I, _I]
            fn.restype = _I
        lib.ssd_scan_bwd_bf16_hopper.argtypes = [_I, _I]
        lib.ssd_scan_bwd_bf16_hopper.restype = _I
        lib.ssd_scan_bwd_chunk.argtypes = []
        lib.ssd_scan_bwd_chunk.restype = _I
        lib._repro_typed = True
    return lib


def hopper_route(N: int, hp: int) -> bool:
    """True if the bf16 entry takes (N, hp) through ``ssd_bf16_hopper``,
    False if through the ``mma.sync`` kernel (asks the built library)."""
    return bool(library().ssd_scan_bf16_hopper(N, hp))


def bwd_hopper_route(N: int, hp: int) -> bool:
    """True if the bf16 entry's backward takes (N, hp) through the Hopper
    kernels (``ssd_bwd_states_bf16_hopper``, ``ssd_bwd_chunks_bf16_hopper``),
    False if through the ``mma.sync`` ones (asks the built library)."""
    return bool(library_bwd().ssd_scan_bwd_bf16_hopper(N, hp))


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

    Returns (y (B, S, H, hp) in u's dtype, h_final (B, H, N, hp) f32). On
    the card: u, Bm, Cm all f32 or all bf16, the rest f32; contiguous; N
    and hp each 16, 32 or 64; any S.
    """
    dev = _check(u, dt, A, Bm, Cm, D, h0)
    if dev.type == "cpu":
        return ssd_scan_ref(u, dt, A, Bm, Cm, D,
                            chunk=chunk or KERNEL_CHUNK, h0=h0)
    stream = {"u": u, "Bm": Bm, "Cm": Cm}
    f32 = {"dt": dt, "A": A, "D": D}
    if h0 is not None:
        f32["h0"] = h0
    check_dtypes("ssd_scan", stream, f32)
    for name, t in {**stream, **f32}.items():
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} is not contiguous")
    # the kernels copy u, B and C in 16-byte pieces and ssd_bf16_hopper
    # reads h0 in 8-byte ones: a view that starts off a 16-byte boundary is
    # copied to a fresh allocation
    u, Bm, Cm, h0 = (t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                     for t in (u, Bm, Cm, h0))
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
    entry = lib.ssd_scan_bf16 if u.dtype == torch.bfloat16 else \
        lib.ssd_scan_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), D.data_ptr(),
                   None if h0 is None else h0.data_ptr(), y.data_ptr(),
                   h.data_ptr(), B_, S, H, N, hp, stream)
    check_launch(rc, "ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.launches_by_dtype[u.dtype] += 1
    return y, h


ssd_scan.launches = 0
ssd_scan.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)


def ssd_scan_bwd(u, dt, A, Bm, Cm, D, dy, *, chunk: Optional[int] = None,
                 h0: Optional[torch.Tensor] = None,
                 dh: Optional[torch.Tensor] = None):
    """The gradients of ``ssd_scan(u, dt, A, Bm, Cm, D, h0=h0)``'s outputs,
    given ``dy`` (B, S, H, hp), the gradient of y, and ``dh`` (B, H, N, hp)
    or None, the gradient of the final state; ``chunk`` as ``ssd_scan``'s
    (CPU only).

    Returns (du, ddt, dA, dB, dC, dD, dh0): dh0 is None unless h0 is
    given; du, dB and dC in u's dtype, the rest float32. On the card u,
    Bm, Cm and dy all float32 (``ssd_scan_bwd_f32``) or all bfloat16
    (``ssd_scan_bwd_bf16``), dt, A, D, h0 and dh float32, all contiguous;
    N and hp each 16, 32 or 64, any S. On the CPU the plain version."""
    dev = _check(u, dt, A, Bm, Cm, D, h0)
    B_, S, H, hp = u.shape
    N = Bm.shape[-1]
    for name, t, shape in (("dy", dy, (B_, S, H, hp)),
                           ("dh", dh, (B_, H, N, hp))):
        if t is not None and (tuple(t.shape) != shape or t.device != dev):
            raise ValueError(f"ssd_scan_bwd: {name} {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
    if dev.type == "cpu":
        return ssd_scan_bwd_ref(u, dt, A, Bm, Cm, D, dy,
                                chunk=chunk or KERNEL_CHUNK, h0=h0, dh=dh)
    streamed = {"u": u, "Bm": Bm, "Cm": Cm, "dy": dy}
    f32_args = {name: t for name, t in (("dt", dt), ("A", A), ("D", D),
                                        ("h0", h0), ("dh", dh))
                if t is not None}
    check_dtypes("ssd_scan_bwd", streamed, f32_args)
    for name, t in {**streamed, **f32_args}.items():
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: {name} is not contiguous")
    lib = library_bwd()
    if not lib.ssd_scan_bwd_kernel_smem_bytes(N, hp, 1):
        raise ValueError(f"ssd_scan_bwd: (N, hp) = ({N}, {hp}) not built "
                         f"(each of 16, 32, 64)")
    # the kernels copy u, dy, B and C in 16-byte pieces (the Hopper route
    # by TMA, whose tensor maps want 16-byte aligned bases): a view that
    # starts off a 16-byte boundary is copied to a fresh allocation
    u, dy, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (u, dy, Bm, Cm))
    f32 = dict(dtype=torch.float32, device=dev)
    chunks = -(-S // lib.ssd_scan_bwd_chunk())
    entry = lib.ssd_scan_bwd_bf16 if u.dtype == torch.bfloat16 else \
        lib.ssd_scan_bwd_f32
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    # the partials, dA's beside dD's and dB's beside dC's: one torch.sum
    # each pair
    ad_p = torch.empty((2, B_, H, chunks), **f32)
    bc_p = torch.empty((2, B_, H, S, N), **f32)
    dA_p, dD_p = ad_p
    dB_p, dC_p = bc_p
    dh0 = None if h0 is None else torch.empty((B_, H, N, hp), **f32)
    if B_ * H == 0:
        return (du, ddt, torch.zeros_like(A), torch.zeros_like(Bm),
                torch.zeros_like(Cm), torch.zeros_like(D), dh0)
    # the states entering and the adjoints leaving each chunk (the Hopper
    # route holds each element as two bf16 pieces in the same 4 bytes)
    scratch = torch.empty((2, B_, H, chunks, N, hp), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            *(ptr(t) for t in (u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt,
                               dA_p, dB_p, dC_p, dD_p, dh0, scratch)),
            B_, S, H, N, hp, stream)
    check_launch(rc, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.launches_by_dtype[u.dtype] += 1
    dA, dD = ad_p.sum((1, 3))
    # summed in f32, then rounded once to the stream dtype
    dB, dC = bc_p.sum(2).to(Bm.dtype)
    return du, ddt, dA, dB, dC, dD, dh0


ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    ssd_scan.launches = 0
    ssd_scan.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
    ssd_scan_bwd.launches = 0
    ssd_scan_bwd.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
