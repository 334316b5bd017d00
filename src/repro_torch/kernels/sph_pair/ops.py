"""Wave execution: pair kernel over the pair list → per-cell sums.

Port of ``repro/kernels/sph_pair/ops.py``: one ``density_pairs`` call runs
every density task of the wave as one batched kernel launch, which reads
the cell arrays through ``ci``/``cj`` itself (``density_pair_cells``);
``force_pairs`` still gathers its eighteen (P, C[, 3]) blocks first.

The reference scatter-adds each pair's i-side into cell ci and its j-side
into cell cj. ``index_add_`` on CUDA does that with atomics in no fixed
order, which would break run-twice bitwise determinism, so the sums here
go through the pair list's *incoming* table (``cellgrid.incoming_table``):
each cell adds its contributions in one fixed order — i-sides in pair
order, then j-sides in pair order, the order of the reference's
sequential scatter — one table column at a time.

``pair_mask`` (npairs,) zeroes masked pair tasks (the time-bin engine's
padding, which repeats pair 0, and the device schedule's inactive pairs
of its full tables): their contributions are replaced by +0.0, which
adds nothing to a sum from +0.0 — even where a masked pair's contribution
is not finite, which a multiplication by 0 would keep.
"""

from __future__ import annotations

import torch

from ...sph.cellgrid import PairList
from .kernel import density_pair_cells, force_pair


def force_inputs(cells, pairs: PairList, rho, press, omega, cs):
    """The force kernel's eighteen (P, C[, 3]) blocks."""
    ci, cj = pairs.ci.long(), pairs.cj.long()
    gi = lambda a: a.index_select(0, ci)
    gj = lambda a: a.index_select(0, cj)
    pos_j = gj(cells.pos) + pairs.shift[:, None, :]
    return (gi(cells.pos), gi(cells.vel), gi(cells.h), gi(press), gi(rho),
            gi(omega), gi(cs), gi(cells.mass), gi(cells.mask),
            pos_j, gj(cells.vel), gj(cells.h), gj(press), gj(rho),
            gj(omega), gj(cs), gj(cells.mass), gj(cells.mask))


def _live(pairs: PairList, pair_mask, dtype):
    notself = (pairs.ci != pairs.cj).to(dtype)
    live = torch.ones_like(notself) if pair_mask is None else pair_mask
    return live, notself * live


def masked(side: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(P, C, F) contributions with the rows of pairs whose ``live`` is 0
    set to +0.0 (the others bit for bit, as a multiplication by 1)."""
    return torch.where(live[:, None, None] > 0, side, 0.0)


def table_sums(parts, incoming, nout: int) -> torch.Tensor:
    """Σ of each output row's contributions in table order, from +0.

    ``parts`` are (R_k, C, F) contribution arrays, stacked in order into
    rows 0 … R − 1; ``incoming`` is ``(rows, table)``: the output rows some
    contribution lands in, ascending, and for each its contributions' rows
    in the order they are added, padded with R (a zero row). Returns
    (nout, C, F), zero in rows no contribution lands in. Each touched row
    is written once, so the result does not depend on thread scheduling.
    """
    rows, table = incoming
    stacked = torch.cat(list(parts) + [parts[0].new_zeros(
        (1,) + parts[0].shape[1:])])
    acc = stacked.new_zeros((table.shape[0],) + stacked.shape[1:])
    for k in range(table.shape[1]):
        acc = acc + stacked.index_select(0, table[:, k])
    out = stacked.new_zeros((nout,) + stacked.shape[1:])
    return out.index_copy_(0, rows, acc)


def _cell_sums(side_i, side_j, incoming, ncells: int) -> torch.Tensor:
    """Σ of each cell's contributions in table order, from +0:
    ``side_i``/``side_j`` (P, C, F) per-pair contributions (already
    multiplied by their masks) stacked as ``incoming_table`` numbers its
    rows, i-sides then j-sides; (ncells, C, F), zero in cells no pair
    touches."""
    return table_sums((side_i, side_j), incoming, ncells)


def density_pairs(cells, pairs: PairList, *, kernel: str = "cubic",
                  pair_mask=None):
    """All density_pair/density_self tasks → (rho, drho_dh, nngb)."""
    rho_i, drho_i, nn_i, rho_j, drho_j, nn_j = density_pair_cells(
        cells.pos, cells.h, cells.mass, cells.mask, pairs.ci, pairs.cj,
        pairs.shift, kernel=kernel)
    ncells = cells.mass.shape[0]
    live_i, live_j = _live(pairs, pair_mask, cells.pos.dtype)
    side_i = masked(torch.stack([rho_i, drho_i, nn_i], -1), live_i)
    side_j = masked(torch.stack([rho_j, drho_j, nn_j], -1), live_j)
    sums = _cell_sums(side_i, side_j, pairs.incoming, ncells)
    return sums[..., 0], sums[..., 1], sums[..., 2]


def force_pairs(cells, pairs: PairList, rho, press, omega, cs, *,
                kernel: str = "cubic", alpha_visc: float = 0.0,
                pair_mask=None):
    """All force_pair/force_self tasks → (dv, du)."""
    dv_i, du_i, dv_j, du_j = force_pair(
        *force_inputs(cells, pairs, rho, press, omega, cs), kernel=kernel,
        alpha_visc=alpha_visc)
    ncells = cells.mass.shape[0]
    live_i, live_j = _live(pairs, pair_mask, cells.pos.dtype)
    side_i = masked(torch.cat([dv_i, du_i[..., None]], -1), live_i)
    side_j = masked(torch.cat([dv_j, du_j[..., None]], -1), live_j)
    sums = _cell_sums(side_i, side_j, pairs.incoming, ncells)
    return sums[..., :3], sums[..., 3]
