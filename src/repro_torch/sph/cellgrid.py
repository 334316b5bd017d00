"""Cell-grid decomposition of the simulation volume (paper §3.1).

Port of ``repro.sph.cellgrid``. Cells are padded to a fixed capacity so
every ``density_pair`` / ``force_pair`` task is a dense (C × C) block.
Binning and the half-stencil pair list are built on the host with numpy
and handed to the device as tensors; ``perm``, ``ci``, ``cj`` and
``shift`` are exactly the reference's.

The pair list also carries a per-cell *incoming* table (built here, on the
host): for each cell, the rows of the pass's contribution array that land
in it — every pair's i-side in pair order, then every pair's j-side in pair
order, the order in which the reference's scatter-adds accumulate. The
wave passes (``kernels/sph_pair/ops.py``) sum through this table in a fixed
order instead of with atomics, so a run repeats bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class ParticleCells(NamedTuple):
    """Padded per-cell particle arrays (leading dims: ncells, capacity)."""
    pos: torch.Tensor     # (ncells, C, 3)
    vel: torch.Tensor     # (ncells, C, 3)
    mass: torch.Tensor    # (ncells, C)    0 for padded slots
    u: torch.Tensor       # (ncells, C)    internal energy
    h: torch.Tensor       # (ncells, C)    smoothing length
    mask: torch.Tensor    # (ncells, C)    1.0 real, 0.0 padded


class PairList(NamedTuple):
    """Half-stencil cell pairs. ``shift`` is the periodic image offset to be
    *added to cell j's positions* when interacting with cell i.
    ``incoming`` is the ``(cells, table)`` pair of :func:`incoming_table`
    as int64 tensors; :func:`make_pair_list` builds all four."""
    ci: torch.Tensor      # (npairs,) int32
    cj: torch.Tensor      # (npairs,) int32
    shift: torch.Tensor   # (npairs, 3) float32
    incoming: Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class GridSpec:
    box: float
    ncells_side: int
    capacity: int

    @property
    def ncells(self) -> int:
        return self.ncells_side ** 3

    @property
    def cell_size(self) -> float:
        return self.box / self.ncells_side


def choose_grid(box: float, h_max: float, num_particles: int, *,
                capacity_margin: float = 2.5,
                min_capacity: int = 8) -> GridSpec:
    """Pick cells/side so cell edge ≥ h_max, and a padded capacity sized for
    the mean occupancy with head-room, rounded up to a multiple of 8."""
    ncells_side = max(int(np.floor(box / max(h_max, 1e-12))), 1)
    ncells = ncells_side ** 3
    mean_occ = num_particles / ncells
    cap = int(np.ceil(mean_occ * capacity_margin))
    cap = max(cap, min_capacity)
    cap = ((cap + 7) // 8) * 8
    return GridSpec(box=box, ncells_side=ncells_side, capacity=cap)


def bin_particles(spec: GridSpec, pos: np.ndarray, vel: np.ndarray,
                  mass: np.ndarray, u: np.ndarray, h: np.ndarray,
                  *, grow: bool = True, device=None
                  ) -> Tuple[ParticleCells, np.ndarray]:
    """Host-side binning into the padded cell layout, returned on ``device``.

    Returns (cells, perm) where ``perm[c, k]`` is the original particle index
    in cell c slot k (−1 for padding). Raises if a cell overflows and
    ``grow`` is False; otherwise capacity is grown to fit.
    """
    n = len(pos)
    posw = np.mod(pos, spec.box)
    idx3 = np.floor(posw / spec.cell_size).astype(np.int64)
    idx3 = np.clip(idx3, 0, spec.ncells_side - 1)
    flat = (idx3[:, 0] * spec.ncells_side + idx3[:, 1]) * spec.ncells_side \
        + idx3[:, 2]
    counts = np.bincount(flat, minlength=spec.ncells)
    cap = spec.capacity
    if counts.max() > cap:
        if not grow:
            raise ValueError(
                f"cell overflow: max occupancy {counts.max()} > capacity {cap}")
        cap = int(((counts.max() + 7) // 8) * 8)
    # stable order by cell; a particle's slot is its rank within its cell
    order = np.argsort(flat, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cell_of = flat[order]
    slot = np.arange(n) - starts[cell_of]
    perm = np.full((spec.ncells, cap), -1, dtype=np.int64)
    perm[cell_of, slot] = order

    valid = perm >= 0

    def take(arr, fill):
        out = np.full((spec.ncells, cap) + arr.shape[1:], fill,
                      dtype=np.float32)
        out[valid] = arr[perm[valid]]
        return torch.from_numpy(out).to(device)

    cells = ParticleCells(
        pos=take(posw.astype(np.float32), 0.0),
        vel=take(vel.astype(np.float32), 0.0),
        mass=take(mass.astype(np.float32), 0.0),
        u=take(u.astype(np.float32), 0.0),
        h=take(h.astype(np.float32), 1e-6),
        mask=torch.from_numpy(valid.astype(np.float32)).to(device),
    )
    return cells, perm


def unbin(cells: ParticleCells, perm: np.ndarray, n: int
          ) -> Dict[str, np.ndarray]:
    """Scatter padded cell arrays back to flat particle arrays."""
    valid = perm >= 0
    idx = perm[valid]
    out = {}
    for name in ("pos", "vel", "mass", "u", "h"):
        arr = getattr(cells, name).cpu().numpy()
        shaped = np.zeros((n,) + arr.shape[2:], dtype=arr.dtype)
        shaped[idx] = arr[valid]
        out[name] = shaped
    return out


_HALF_STENCIL = [(dz, dy, dx)
                 for dz in (-1, 0, 1)
                 for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1)][14:]   # lexicographic upper half (13)


def incoming_table(ci: np.ndarray, cj: np.ndarray, ncells: int,
                   nlive: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell rows of a pass's stacked contributions: (cells, table).

    The contributions are stacked as [i-side of pair 0..P−1, j-side of pair
    0..P−1, one zero row]: row p is pair p's i-side, row P + p its j-side,
    row 2P the zero row. ``cells`` (T,) lists the cells some pair touches,
    ascending; ``table`` (T, K) their rows, in stacked order, padded with
    the zero row.

    With ``nlive`` only pairs 0..nlive−1 are listed: the time-bin engine
    pads its pair subsets with masked repeats of pair 0, whose
    contributions are x·0 = ±0 and would change no sum — listing them
    would only make cell ci[0]'s list as long as the padding.
    """
    P = len(ci)
    n = P if nlive is None else int(nlive)
    keys = np.concatenate([np.asarray(ci[:n], np.int64),
                           np.asarray(cj[:n], np.int64)])
    rows = np.concatenate([np.arange(n), P + np.arange(n)])
    return gather_table(keys, rows, ncells, 2 * P)


def gather_table(keys: np.ndarray, rows: np.ndarray, nkeys: int, pad: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows grouped by key: (cells, table).

    ``keys`` (N,) in [0, nkeys) names where each of ``rows`` (N,) lands.
    ``cells`` (T,) lists the keys that occur, ascending; ``table`` (T, K)
    each one's rows in their given order, padded with ``pad``.
    """
    keys = np.asarray(keys, np.int64)
    rows = np.asarray(rows, np.int64)
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=nkeys)
    cells = np.nonzero(counts)[0]
    K = max(int(counts.max()) if len(keys) else 0, 1)
    rank = np.zeros(nkeys, np.int64)
    rank[cells] = np.arange(len(cells))
    starts = np.concatenate([[0], np.cumsum(counts[cells])[:-1]]).astype(
        np.int64)
    row_of = rank[keys[order]]
    slot = np.arange(len(keys)) - starts[row_of]
    table = np.full((len(cells), K), pad, dtype=np.int64)
    table[row_of, slot] = rows[order]
    return cells, table


def make_pair_list(ci: np.ndarray, cj: np.ndarray, shift: np.ndarray,
                   ncells: int, device=None,
                   nlive: Optional[int] = None) -> PairList:
    """A :class:`PairList` on ``device`` from host arrays, with its
    incoming table (over the first ``nlive`` pairs when given: the rest
    are masked padding)."""
    cells, table = incoming_table(ci, cj, ncells, nlive)
    return PairList(
        ci=torch.from_numpy(np.array(ci, np.int32)).to(device),
        cj=torch.from_numpy(np.array(cj, np.int32)).to(device),
        shift=torch.from_numpy(np.array(shift, np.float32)).to(device),
        incoming=(torch.from_numpy(cells).to(device),
                  torch.from_numpy(table).to(device)))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def stack_incoming(tables: Sequence[Tuple[np.ndarray, np.ndarray]],
                   npairs: int, ncells: int, *,
                   width: Optional[int] = None, every_row: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Lanes' incoming tables as the one table of their stacked list.

    Lane ``l``'s list has ``npairs`` (P) pairs over ``ncells`` cells, and
    its table (:func:`incoming_table`) numbers its contribution rows i-side
    ``p``, j-side ``P + p`` and the zero row ``2P``. In the stacked list
    (``L·P`` pairs, lane ``l``'s cells offset by ``l·ncells``) these are
    ``l·P + p``, ``L·P + l·P + p`` and ``2·L·P``: every cell keeps its own
    lane's contributions in its lane's order. Tables narrower than
    ``width`` (default: the widest) are padded with the zero row, which
    adds +0.0 — a sum in table order from +0.0 never holds −0.0, so the
    padding leaves every bit. With ``every_row`` the table lists all
    ``L·ncells`` cells (untouched ones all zero row), so its shape depends
    only on the lanes' sizes and ``width``.
    """
    L, P = len(tables), int(npairs)
    W = max((t.shape[1] for _, t in tables), default=1) \
        if width is None else int(width)
    zero = 2 * L * P
    rows_out, tabs = [], []
    for lane, (rows, table) in enumerate(tables):
        t = np.asarray(table, np.int64)
        t = np.where(t < P, t + lane * P,
                     np.where(t < 2 * P, t - P + (L + lane) * P, zero))
        if t.shape[1] < W:
            t = np.concatenate(
                [t, np.full((t.shape[0], W - t.shape[1]), zero, np.int64)],
                axis=1)
        rows_out.append(np.asarray(rows, np.int64) + lane * ncells)
        tabs.append(t)
    rows = np.concatenate(rows_out)
    table = np.concatenate(tabs).reshape(-1, W)
    if every_row:
        full = np.full((L * ncells, W), zero, np.int64)
        full[rows] = table
        rows, table = np.arange(L * ncells, dtype=np.int64), full
    return rows, table


def stack_pair_list(pairs: PairList, bucket: int, ncells: int,
                    device=None) -> PairList:
    """``pairs`` (one lane's list over ``ncells`` cells) repeated for
    ``bucket`` lanes, on ``device``.

    Lane ``l``'s ``ci``/``cj`` are offset by ``l·ncells`` and its shifts
    repeated; its incoming table maps as :func:`stack_incoming` says. Every
    lane has the same geometry, so this equals ``incoming_table`` of the
    stacked ``ci``/``cj`` exactly: the same width, the same zero-row
    padding, lanes in ascending order.
    """
    B, P = int(bucket), int(pairs.ci.shape[0])
    ci = _host(pairs.ci).astype(np.int64)
    cj = _host(pairs.cj).astype(np.int64)
    incoming = tuple(_host(a) for a in pairs.incoming)
    cell_off = (np.arange(B, dtype=np.int64) * ncells)[:, None]
    rows, table = stack_incoming([incoming] * B, P, ncells)
    return PairList(
        ci=torch.from_numpy((ci[None] + cell_off).reshape(-1).astype(
            np.int32)).to(device),
        cj=torch.from_numpy((cj[None] + cell_off).reshape(-1).astype(
            np.int32)).to(device),
        shift=torch.from_numpy(np.tile(_host(pairs.shift), (B, 1))).to(
            device),
        incoming=(torch.from_numpy(rows).to(device),
                  torch.from_numpy(table).to(device)))


def pair_arrays(spec: GridSpec, *, include_self: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Half-stencil periodic pair list as host arrays (ci, cj, shift), in
    the reference's order: per cell in flat order, the self pair, then the
    13 upper-half neighbours."""
    ns = spec.ncells_side
    box = spec.box
    c = np.arange(ns ** 3, dtype=np.int64)
    i, j, k = c // (ns * ns), (c // ns) % ns, c % ns
    ci_cols, cj_cols, sh_cols, keep_cols = [], [], [], []
    if include_self:
        ci_cols.append(c)
        cj_cols.append(c)
        sh_cols.append(np.zeros((len(c), 3), np.float64))
        keep_cols.append(np.ones(len(c), bool))
    for (dz, dy, dx) in _HALF_STENCIL:
        ii, jj, kk = i + dz, j + dy, k + dx
        # periodic wrap + the image shift of cell j relative to cell i
        s = [np.where(a >= ns, -box, np.where(a < 0, box, 0.0))
             for a in (ii, jj, kk)]
        n2 = ((ii % ns) * ns + (jj % ns)) * ns + (kk % ns)
        ci_cols.append(c)
        cj_cols.append(n2)
        # pos_j_eff = pos_j + shift, shift = (−sz, −sy, −sx)
        sh_cols.append(np.stack([-s[0], -s[1], -s[2]], -1))
        # tiny grids: a neighbour that wraps onto the cell itself is dropped
        keep_cols.append(~((ns <= 2) & (n2 == c)))
    ci = np.stack(ci_cols, 1).reshape(-1)
    cj = np.stack(cj_cols, 1).reshape(-1)
    sh = np.stack(sh_cols, 1).reshape(-1, 3)
    keep = np.stack(keep_cols, 1).reshape(-1)
    return (ci[keep].astype(np.int32), cj[keep].astype(np.int32),
            sh[keep].astype(np.float32))


def build_pair_list(spec: GridSpec, *, include_self: bool = True,
                    device=None) -> PairList:
    """Half-stencil periodic cell-pair list with image shifts, on
    ``device``."""
    ci, cj, sh = pair_arrays(spec, include_self=include_self)
    return make_pair_list(ci, cj, sh, spec.ncells, device)
