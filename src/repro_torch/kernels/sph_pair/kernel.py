"""Wrappers of the Hopper sph_pair kernels (``csrc/sph_pair.cu``).

``density_pair`` and ``force_pair`` take the reference's arguments in the
reference's order (``density_pair_pallas`` / ``force_pair_pallas``) and
return the same output tuples. ``density_pair_cells`` computes what
``density_pair`` computes on the blocks gathered through a pair list, from
the cell arrays and the list: the same kernel gathers as it loads. For
tensors on a CUDA device each wrapper launches the hand-written kernel on
the current stream and raises if the launch fails; for tensors on the CPU
it calls the plain PyTorch version (``ref.py``). There is no other path.

Each wrapper counts its launches in ``<wrapper>.launches`` (one per kernel
launch, nowhere else), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import check_launch, load_library
from .ref import density_pair_cells_ref, density_pair_ref, force_pair_ref

SOURCES = [Path(__file__).parent / "csrc" / "sph_pair.cu"]
KERNEL_IDS = {"cubic": 0, "wendland_c2": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    lib = load_library("sph_pair", SOURCES)
    if not getattr(lib, "_repro_typed", False):
        lib.sph_density_pair.argtypes = [_P] * 17 + [_I] * 4 + [_P]
        lib.sph_density_pair.restype = _I
        lib.sph_force_pair.argtypes = ([_P] * 22 + [_I, _I, _I]
                                       + [_F, _F, _F, _P])
        lib.sph_force_pair.restype = _I
        lib._repro_typed = True
    return lib


def _check(name, tensors, P, C):
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for k, t in enumerate(tensors):
        want = (P, C, 3) if t.dim() == 3 else (P, C)
        if t.device != dev:
            raise ValueError(f"{name}: argument {k} on {t.device}, "
                             f"expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: argument {k} is {t.dtype}, "
                            f"expected torch.float32")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: argument {k} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {k} is not contiguous")
    return dev


def _kernel_id(kernel: str) -> int:
    try:
        return KERNEL_IDS[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}; have {list(KERNEL_IDS)}")


def _launch_density(name, dev, sides, index, outs, P, C, kid):
    """Launch the density kernel: ``sides`` the i- and j-side slot arrays
    (pos, h, m, mask each, ``rows`` slot rows), ``index`` (ci, cj, shift)
    or Nones. An index outside [0, rows) stops the kernel with a
    device-side assertion."""
    rows = sides[0].shape[0]
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sph_density_pair(
            *(t.data_ptr() for t in sides),
            *(None if t is None else t.data_ptr() for t in index),
            *(t.data_ptr() for t in outs), P, C, rows, kid, stream)
    check_launch(rc, name)


def density_pair(pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j,
                 *, kernel: str = "cubic"):
    """Batched cell-pair density, both directions per pair task.

    pos (P, C, 3) with pos_j image-shifted; h/m/mask (P, C); f32,
    contiguous. Returns (rho_i, drho_i, nngb_i, rho_j, drho_j, nngb_j).
    """
    args = (pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j)
    P, C = pos_i.shape[0], pos_i.shape[1]
    dev = _check("density_pair", args, P, C)
    kid = _kernel_id(kernel)
    if dev.type == "cpu":
        return density_pair_ref(*args, kernel=kernel)
    outs = tuple(torch.empty((P, C), dtype=torch.float32, device=dev)
                 for _ in range(6))
    if P == 0:
        return outs
    _launch_density("density_pair", dev, args, (None, None, None), outs,
                    P, C, kid)
    density_pair.launches += 1
    return outs


density_pair.launches = 0


def density_pair_cells(pos, h, mass, mask, ci, cj, shift, *,
                       kernel: str = "cubic"):
    """``density_pair`` over a pair list, gathering as it loads.

    pos (ncells, C, 3) and h/mass/mask (ncells, C), f32 and contiguous;
    ci, cj (P,) int32 cell indices in [0, ncells); shift (P, 3) f32, added
    to cell cj's positions. Returns the six (P, C) outputs of
    ``density_pair`` on the blocks ``ref.gather_density_blocks`` gathers.
    An index out of range raises on the CPU (``index_select``) and stops
    the kernel with a device-side assertion on the card, as
    ``index_select``'s own check does there (no host-side check, which
    would wait for the card).
    """
    cells = (pos, h, mass, mask)
    dev = _check("density_pair_cells", cells, pos.shape[0], pos.shape[1])
    P, C = (ci.shape[0] if ci.dim() == 1 else -1), pos.shape[1]
    for k, (t, dtype, want) in enumerate(((ci, torch.int32, (P,)),
                                          (cj, torch.int32, (P,)),
                                          (shift, torch.float32, (P, 3)))):
        if t.device != dev:
            raise ValueError(f"density_pair_cells: argument {4 + k} on "
                             f"{t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"density_pair_cells: argument {4 + k} is "
                            f"{t.dtype}, expected {dtype}")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"density_pair_cells: argument {4 + k} has "
                             f"shape {tuple(t.shape)}, expected a "
                             f"contiguous {want}")
    kid = _kernel_id(kernel)
    if dev.type == "cpu":
        return density_pair_cells_ref(*cells, ci, cj, shift, kernel=kernel)
    outs = tuple(torch.empty((P, C), dtype=torch.float32, device=dev)
                 for _ in range(6))
    if P == 0:
        return outs
    _launch_density("density_pair_cells", dev, cells + cells, (ci, cj, shift),
                    outs, P, C, kid)
    density_pair_cells.launches += 1
    return outs


density_pair_cells.launches = 0


def force_pair(pos_i, vel_i, h_i, press_i, rho_i, om_i, cs_i, m_i, mask_i,
               pos_j, vel_j, h_j, press_j, rho_j, om_j, cs_j, m_j, mask_j,
               *, kernel: str = "cubic", alpha_visc: float = 0.0):
    """Batched cell-pair forces, both directions per pair task.

    Returns (dv_i, du_i, dv_j, du_j): (P,C,3), (P,C), (P,C,3), (P,C).
    """
    args = (pos_i, vel_i, h_i, press_i, rho_i, om_i, cs_i, m_i, mask_i,
            pos_j, vel_j, h_j, press_j, rho_j, om_j, cs_j, m_j, mask_j)
    P, C = pos_i.shape[0], pos_i.shape[1]
    dev = _check("force_pair", args, P, C)
    kid = _kernel_id(kernel)
    if dev.type == "cpu":
        return force_pair_ref(*args, kernel=kernel, alpha_visc=alpha_visc)
    lib = library()
    kw = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((P, C, 3), **kw), torch.empty((P, C), **kw),
            torch.empty((P, C, 3), **kw), torch.empty((P, C), **kw))
    if P == 0:
        return outs
    alpha = float(alpha_visc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sph_force_pair(*(t.data_ptr() for t in args + outs),
                                P, C, kid, alpha, -alpha, 2.0 * alpha, stream)
    check_launch(rc, "force_pair")
    force_pair.launches += 1
    return outs


force_pair.launches = 0


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    density_pair.launches = 0
    density_pair_cells.launches = 0
    force_pair.launches = 0
