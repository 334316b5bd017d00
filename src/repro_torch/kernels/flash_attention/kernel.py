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
that launched their kernels (one per call: D, then dQ and dK/dV as two
launches, or, for the bf16 entry at hd 64, 128 and 256, as one);
``launches_by_dtype`` splits the count by entry, and
``launches_by_route`` by the kernels that served the call, as the
library's ``flash_attention_bwd_route`` gives it for the head width (the
function both C entries dispatch on): ``"hopper"`` (TMA and ``wgmma``, hd
64, 128 and 256: ``flash_bwd_hopper`` for f32, ``flash_bwd_bf16_hopper``
for bf16) or ``"mma_sync"`` (``flash_bwd_kernel`` or, bf16,
``flash_bwd_kernel_bf16``, hd 16 and 32).

``flash_bwd_bf16_hopper`` sums each query tile's dQ over the key blocks
that reach it in a fixed order, in an f32 workspace behind a counter a
tile; the wrapper allocates them (``torch.empty``) as the tail of the
``dsum`` workspace, sized by ``flash_attention_bwd_workspace``.
``bf16_bwd_design`` mirrors that kernel's work list and add order in
Python (its tests, and ``chip_smoke.py``'s CTA counts and bytes).
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
                   "flash_attention_bwd_bf16_smem_bytes",
                   "flash_attention_bwd_bf16_ctas_per_sm"):
            getattr(lib, fn).argtypes = [_I]
            getattr(lib, fn).restype = _I
        lib.flash_attention_bwd_workspace.argtypes = [_I] * 5
        lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
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
    lib = library_bwd()
    dsum = torch.empty(lib.flash_attention_bwd_workspace(
        B, S, H, hd, int(q.dtype == torch.bfloat16)), dtype=torch.float32,
        device=dev)
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
    """{"flash_bwd_hopper<hd,DQ|DKV,cap|nocap>" (the f32 entry's; or
    ``flash_bwd_kernel``, ``flash_bwd_kernel_bf16``; an older library's
    bf16 ``flash_bwd_hopper`` with ",bf16" before the ">"), or
    "flash_bwd_bf16_hopper<hd,cap|nocap>": [registers, spill bytes]} of a
    backward library built in this process (empty if it was found
    built)."""
    out = {}
    for sym, res in ptxas_resources(library).items():
        m = re.search(r"(flash_bwd_(?:kernel_bf16|kernel|hopper))ILi(\d+)ELi"
                      r"(\d)ELb(\d)E(t?)", sym)
        if m:
            out[f"{m[1]}<{m[2]},{('DQ', 'DKV')[int(m[3])]},"
                f"{('nocap', 'cap')[int(m[4])]}{',bf16' if m[5] else ''}>"] \
                = res
        m = re.search(r"flash_bwd_bf16_hopperILi(\d+)ELb(\d)E", sym)
        if m:
            out[f"flash_bwd_bf16_hopper<{m[1]},"
                f"{('nocap', 'cap')[int(m[2])]}>"] = res
    return out


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_dtype = dict.fromkeys(ENTRY_DTYPES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


# flash_bwd_bf16_hopper's tiles by head width: (queries a streamed tile,
# keys a CTA), csrc's bf16_tiles
BF16_BWD_TILES = {64: (128, 128), 128: (64, 128), 256: (64, 64)}


# bytes of f32 dQ workspace up to which the ticket order takes every
# (b, kv head) group at once (csrc's L2_SUMS)
L2_SUMS = 24 << 20


def bf16_chunk_groups(B, S, H, K, hd) -> int:
    """(b, kv head) groups a chunk of the ticket order (csrc's
    ``bf16_chunk_groups``): all of them if the call's f32 workspace fits
    in ``L2_SUMS`` bytes, else one."""
    BM = BF16_BWD_TILES[hd][0]
    return B * K if B * H * -(-S // BM) * BM * hd * 4 <= L2_SUMS else 1


def tile_kblocks(m, BM, BN, nkb, off, causal, window):
    """The key blocks [klo, khi) that query tile ``m`` reaches (csrc's
    ``tile_kblocks``): causal, query i sees key j iff j <= i + off; a
    window, iff j > i + off − window."""
    klo, khi = 0, nkb
    if causal:
        last = m * BM + BM - 1 + off
        khi = 0 if last < 0 else min(nkb, last // BN + 1)
    if window:
        first = m * BM + off - window + 1
        klo = min(nkb, first // BN) if first > 0 else 0
    return klo, khi


def kblock_tiles(n, BM, BN, nqt, off, causal, window):
    """The query tiles [mlo, mhi) that key block ``n`` reaches (csrc's
    ``kblock_tiles``), the same test read the other way."""
    mlo, mhi = 0, nqt
    if causal:
        first = n * BN - off
        mlo = min(nqt, first // BM) if first > 0 else 0
    if window:
        last = n * BN + BN - 1 - off + window - 1
        mhi = 0 if last < 0 else min(nqt, last // BM + 1)
    return mlo, mhi


def bf16_bwd_design(B, S, T, H, K, hd, causal=True, window=None) -> dict:
    """``flash_bwd_bf16_hopper``'s launch, as the kernel orders its work:

    * ``items``: the CTAs' work items in ticket order, (key block n, b, kv
      head): chunk by chunk of ``bf16_chunk_groups`` (b, kv head) groups,
      within a chunk the last key block first, then the groups in turn;
    * ``iterations``: each item's (query tile m, head h, rank, count): the
      rank of its dQ partial among the tile's adders (0 stores, each next
      one adds, count − 1, the last, adds the sum to its own, scales and
      rounds to bf16), in the order the CTA visits them;
    * ``dead_tiles``: the (b, h, m) that no key block reaches, which D's
      launch zeroes;
    * ``bytes``: what the design moves (each operand tile as the CTAs load
      it, D's launch, the dQ workspace traffic: 4 bytes an element written
      by a tile's first adder, read and written by each middle one's add
      in L2, read by the last, then dq in bf16), and ``workspace_bytes``,
      that traffic alone."""
    BM, BN = BF16_BWD_TILES[hd]
    G, off = H // K, T - S
    nkb, nqt = -(-T // BN), -(-S // BM)
    window = window or 0
    items, iterations = [], []
    P = bf16_chunk_groups(B, S, H, K, hd)
    for i in range(nkb * B * K):
        chunk, j = divmod(i, P * nkb)
        ng = min(P, B * K - chunk * P)
        n, bk = nkb - 1 - j // ng, chunk * P + j % ng
        b, kh = divmod(bk, K)
        items.append((n, b, kh))
        mlo, mhi = kblock_tiles(n, BM, BN, nqt, off, causal, window)
        its = []
        for m in range(mlo, mhi):
            klo, khi = tile_kblocks(m, BM, BN, nkb, off, causal, window)
            for gi in range(G):
                its.append((m, kh * G + gi, khi - 1 - n, khi - klo))
        iterations.append(its)
    dead = [(b, h, m) for b in range(B) for h in range(H) for m in range(nqt)
            if (lambda lo, hi: hi <= lo)(*tile_kblocks(
                m, BM, BN, nkb, off, causal, window))]
    rows = lambda m: min(BM, S - m * BM)              # noqa: E731
    keys = lambda n: min(BN, T - n * BN)              # noqa: E731
    ws = 0
    moved = 2 * 2 * B * S * H * hd + 4 * B * H * S + 4 * (B * H * nqt + 1)
    moved += 2 * hd * sum(rows(m) for _, _, m in dead)
    for (n, _, _), its in zip(items, iterations):
        moved += 2 * 2 * keys(n) * hd * 2          # K, V in; dK, dV out
        for m, _, rank, count in its:
            moved += 2 * 2 * rows(m) * hd + 8 * rows(m)   # Q, dO, lse, D
            chunk = 4 * BM * hd
            if count == 1:
                ws += 2 * rows(m) * hd
            elif rank == 0:
                ws += chunk
            elif rank < count - 1:
                ws += 2 * chunk
            else:
                ws += chunk + 2 * rows(m) * hd
    return {"tiles": (BM, BN), "ctas": len(items), "items": items,
            "iterations": iterations, "dead_tiles": dead,
            "bytes": moved + ws, "workspace_bytes": ws}
