"""On-card collective transport: the halo exchange as index copies.

Port of the wire of ``repro.sph.collectives`` (its exchange programs and
``CollectiveTransport``). Where :class:`~repro_torch.distributed.transport.
HostTransport` copies rows through numpy, this module does the same copies
on the device, over the ranks stacked as the leading dimension of one
``(nranks, nrows, …)`` tensor per field — the port runs every rank on the
one card, so the reference's rank mesh becomes a tensor dimension:

* every rank packs the rows it owes its neighbours into a
  **power-of-two-bucketed export buffer** (padded, so the program's
  shapes do not depend on how many cut-cell rows are active);
* the buffers move either in ppermute rounds — the neighbour-to-neighbour
  schedule from the comm planner's export edge list
  (``core.comm_planner.ppermute_rounds``); ``lax.ppermute`` becomes an
  index over the stacked export buffer by the round's permutation — or
  through one all-gather, which on stacked ranks is a view of the stacked
  buffer;
* each rank scatters the received slots into its halo replica rows;
  padding slots are routed to a scratch row that is sliced off, so they
  provably leave the state untouched.

Exchanges are pure row copies, so this wire gives bit for bit the host
wire's states. Programs are cached by their static signature (bucket,
rounds, field shapes) in a :class:`~repro_torch.distributed.transport.
ProgramCache`.

**Fused sub-step programs** (:func:`build_fused_substep_program`): the
device-resident engine runs a *whole force sub-step* — drift, density
phase, exchange 1, force phase, kick and exchange 2 — as one function over
the stacked per-rank extended states, flattened to ``(nranks·(K+H), C,
…)`` so each pair kernel launches once for all ranks. The state stays on
the card between cycle boundaries. The reference splits the force pair
pass into interior and cut pairs so its compiler can overlap the interior
pairs with exchange 1 (:func:`_split_force_pass`, kept here and held to
the unsplit pass by a test); on one card and one stream the split buys
nothing, so the fused body runs the unsplit pass over the post-exchange
fields, which is bitwise the split one.

**Device-scheduled segments** (:func:`build_cycle_scan_program`,
:func:`build_plan_program`): one program runs a *whole cycle* — every
sub-step of the ladder — deriving levels, activity, pair masks, ship sets
and wake floors from the resident ``bins``, and a second plans the next
cycle of a segment on the device (CFL field, bins, limiter, depth,
u_floor, opening half-kick), so inside a segment the host reads nothing.
The reference's ``lax.scan`` over the trips becomes a Python loop that
enqueues every trip; a trip with nothing due keeps every carry through
``torch.where``, so no trip needs a host decision.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.comm_planner import ppermute_rounds
from ..distributed.transport import (BucketPolicy, CompileProbe, ProgramCache,
                                     ShipSlots, Transport, pack_allgather,
                                     pack_rounds)
from ..observability import device_metrics as dmetrics
from .cellgrid import PairList, ParticleCells
from .engine import _force_pass
from .physics import dot3, sound_speed, sqrt_rn
from .timebins import (STATE_AUX_FIELDS, STATE_CELL_FIELDS, TimeBinState,
                       _apply_final_kick, _apply_force_kick, _cycle_start,
                       _drift, _substep_density_phase, assign_bins,
                       device_table, dt_min_of, mass_weighted_mean_u,
                       substep_active_mask, trailing_zeros_table)


# ------------------------------------------------------- stacked row copies
def _with_scratch(loc: torch.Tensor) -> torch.Tensor:
    """(nranks, nrows + 1, …): each rank's rows plus one zero scratch row."""
    scratch = loc.new_zeros((loc.shape[0], 1) + tuple(loc.shape[2:]))
    return torch.cat([loc, scratch], dim=1)


def _scatter_rows(loc: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                  got: torch.Tensor, nrows: int) -> torch.Tensor:
    """Write ``got`` (nranks, bucket, …) into rows ``rows`` (nranks,
    bucket) of the scratch-extended ``loc``; invalid slots land on the
    scratch row ``nrows``. Every real destination row is written at most
    once, so only the scratch row sees repeated writes."""
    nranks, width = loc.shape[0], loc.shape[1]
    safe = torch.where(valid > 0, rows.long(), nrows)
    flat = safe + width * torch.arange(nranks, device=loc.device)[:, None]
    out = loc.reshape((nranks * width,) + tuple(loc.shape[2:]))
    out[flat.reshape(-1)] = got.reshape((-1,) + tuple(got.shape[2:]))
    return out.reshape(loc.shape)


def _take_rows(loc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(nranks, bucket, …): rank r's rows ``rows[r]`` of ``loc``."""
    idx = rows.long()
    return loc[torch.arange(loc.shape[0], device=loc.device)[:, None], idx]


def _round_sources(perms, nranks: int) -> List[torch.Tensor]:
    """Per round, each destination's source rank; ``nranks`` (the zero
    buffer appended below) where a rank receives nothing."""
    out = []
    for perm in perms:
        src = torch.full((nranks,), nranks, dtype=torch.long)
        for s, d in perm:
            src[d] = s
        out.append(src)
    return out


def _permute_copy(loc, pack, unpack, valid, sources, nrows: int):
    """ppermute-rounds copy of one stacked field.

    ``loc`` (nranks, nrows, …) holds every rank's field; ``pack``/
    ``unpack``/``valid`` (nranks, R, bucket) are the ranks' index tables;
    ``sources`` is :func:`_round_sources` of the rounds. In round t every
    rank packs its rows, and destination d receives the buffer of the
    source s with (s, d) in the round's permutation (zeros where it
    receives nothing, as ``lax.ppermute`` gives).
    """
    loc = _with_scratch(loc)
    for t, src in enumerate(sources):
        buf = _take_rows(loc, pack[:, t])                # (nranks, B, …)
        bufz = torch.cat([buf, torch.zeros_like(buf[:1])])
        got = bufz[src]
        loc = _scatter_rows(loc, unpack[:, t], valid[:, t], got, nrows)
    return loc[:, :nrows]


def _allgather_copy(loc, pack, unpack_src, unpack_rows, valid, nrows: int):
    """All-gather copy of one stacked field: every rank's export buffer,
    flattened, is the gathered buffer each rank reads its slots from."""
    loc = _with_scratch(loc)
    buf = _take_rows(loc, pack)                          # (nranks, Bo, …)
    flat = buf.reshape((-1,) + tuple(buf.shape[2:]))     # the gather
    got = flat[unpack_src.long()]                        # (nranks, Bi, …)
    loc = _scatter_rows(loc, unpack_rows, valid, got, nrows)
    return loc[:, :nrows]


def build_permute_program(rounds: Sequence[Sequence[Tuple[int, int]]],
                          nranks: int, nrows: int, bucket: int,
                          nfields: int):
    """One ppermute-rounds exchange over ``nfields`` stacked fields.

    Inputs: ``pack``/``unpack`` (nranks, R, bucket) int32, ``valid``
    (nranks, R, bucket) float, then each field (nranks, nrows, …). Returns
    the fields with every valid received slot written into its destination
    row; everything else bit-identical. (``bucket`` is the programs'
    cache key; the tables carry it.)
    """
    sources = _round_sources([list(rnd) for rnd in rounds], nranks)
    on_device: Dict[torch.device, List[torch.Tensor]] = {}

    def program(pack, unpack, valid, *fields):
        assert len(fields) == nfields and pack.shape[-1] == bucket
        dev = pack.device
        if dev not in on_device:
            on_device[dev] = [s.to(dev) for s in sources]
        return tuple(_permute_copy(f, pack, unpack, valid, on_device[dev],
                                   nrows) for f in fields)

    return program


def build_allgather_program(nrows: int, bucket_out: int, bucket_in: int,
                            nfields: int):
    """The all-gather fallback exchange.

    Inputs: ``pack`` (nranks, bucket_out) int32, ``unpack_src``/
    ``unpack_rows`` (nranks, bucket_in) int32, ``valid`` (nranks,
    bucket_in) float, then the stacked fields.
    """

    def program(pack, unpack_src, unpack_rows, valid, *fields):
        assert len(fields) == nfields
        assert pack.shape[-1] == bucket_out
        assert unpack_src.shape[-1] == bucket_in
        return tuple(_allgather_copy(f, pack, unpack_src, unpack_rows,
                                     valid, nrows) for f in fields)

    return program


# ------------------------------------------------------ the stacked ranks
class _StackedRanks:
    """The fused and segment programs' view of the stacked ranks:
    ``(nranks, nrows, …)`` buffers flattened to ``(nranks·nrows, …)`` rows
    (each rank's pairs offset by its first row, so one kernel launch
    covers all ranks), per-rank and owned-row slices, and the exchange
    over the tables' index copies (its slot validity given per call)."""

    def __init__(self, mode: str, rounds, nranks: int, nrows: int, K: int,
                 device):
        self.mode, self.nranks, self.nrows, self.K = mode, nranks, nrows, K
        for name in ("thresholds", "scale"):    # the bin ladder's tables
            device_table(name, device)
        self.sources = [s.to(device) for s in
                        _round_sources([list(r) for r in rounds], nranks)]
        self.first = (torch.arange(nranks, device=device) * nrows)[:, None]
        self.rank = torch.arange(nranks, device=device)

    def flat(self, x):
        return x.reshape((self.nranks * self.nrows,) + tuple(x.shape[2:]))

    def stacked(self, x):
        return x.reshape((self.nranks, self.nrows) + tuple(x.shape[1:]))

    def owned(self, x):
        return self.stacked(x)[:, :self.K]

    def per_rank(self, x):
        return x.reshape(self.nranks, -1)

    def state(self, state) -> TimeBinState:
        """The stacked state dict as one flattened ``TimeBinState``, each
        rank's time expanded per row."""
        time = state["time"][:, None].expand(self.nranks, self.nrows)
        return TimeBinState(
            cells=ParticleCells(**{k: self.flat(state[k])
                                   for k in STATE_CELL_FIELDS}),
            time=time.reshape(-1, 1),
            **{k: self.flat(state[k]) for k in STATE_AUX_FIELDS})

    def pair_index(self, tables):
        """Each rank's pair ends in the flattened rows (int64)."""
        return tuple((tables[k].long() + self.first).reshape(-1)
                     for k in ("ci", "cj"))

    def pairs(self, tables) -> PairList:
        """The ranks' pair tables as one list over the flattened rows, with
        their stacked incoming table."""
        ci, cj = self.pair_index(tables)
        return PairList(ci=ci.to(torch.int32), cj=cj.to(torch.int32),
                        shift=tables["shift"].reshape(-1, 3),
                        incoming=(tables["in_rows"], tables["in_table"]))

    def recv_rows(self, tables):
        return tables["e_unpack" if self.mode == "ppermute" else "e_urows"]

    def take(self, x, rows):
        """Rank r's entries ``rows[r, …]`` of the flattened ``x``."""
        idx = self.rank.reshape((-1,) + (1,) * (rows.dim() - 1))
        return self.stacked(x)[idx, rows.long()]

    def xchg(self, tables, fields, valid):
        """The exchange of flattened ``fields`` with slot validity
        ``valid`` (the tables' ``e_valid`` or a gated copy)."""
        if self.mode == "ppermute":
            outs = [_permute_copy(self.stacked(f), tables["e_pack"],
                                  tables["e_unpack"], valid, self.sources,
                                  self.nrows) for f in fields]
        else:
            outs = [_allgather_copy(self.stacked(f), tables["e_pack"],
                                    tables["e_usrc"], tables["e_urows"],
                                    valid, self.nrows) for f in fields]
        return [self.flat(o) for o in outs]


# ------------------------------------------------- interior/cut force split
def _split_force_pass(cells: ParticleCells, pairs: PairList, pair_mask,
                      pre, post, int_pos, int_valid, cut_pos, cut_valid,
                      *, cfg):
    """``engine._force_pass`` with the interior/cut work split.

    ``pre``/``post`` are (rho, press, omega, cs) before/after exchange 1.
    ``int_pos``/``cut_pos`` partition the live pair positions of ``pairs``
    into interior pairs (both rows owned) and cut pairs (one row a halo
    replica), each padded to its own bucket with ``*_valid`` zeros.

    Interior pairs read only owned rows, which exchange 1 never writes, so
    their contributions are computed from the *pre*-exchange fields; cut
    pairs wait for the exchanged ones. Both subsets' contributions are
    put back at their **pair-list position** (padding on a scratch slot)
    and summed through the list's incoming table as ``_force_pass`` sums
    them, so every row folds the same contributions in the same order —
    bit for bit the unsplit pass over the ``post`` fields. Each subset is
    one ``force_pair`` launch.
    """
    from ..kernels.sph_pair import ops
    from ..kernels.sph_pair.kernel import force_pair
    B = int(pairs.ci.shape[0])

    def subset(fieldset, pos):
        rho, press, omega, cs = fieldset
        p = pos.long().clamp(0, max(B - 1, 0))
        sub = pairs._replace(ci=pairs.ci[p], cj=pairs.cj[p],
                             shift=pairs.shift[p])
        return force_pair(*ops.force_inputs(cells, sub, rho, press, omega,
                                            cs),
                          kernel=cfg.kernel, alpha_visc=cfg.alpha_visc)

    got_int = subset(pre, int_pos)
    got_cut = subset(post, cut_pos)
    safe_int = torch.where(int_valid > 0, int_pos.long(), B)
    safe_cut = torch.where(cut_valid > 0, cut_pos.long(), B)

    def assemble(int_vals, cut_vals):
        full = int_vals.new_zeros((B + 1,) + tuple(int_vals.shape[1:]))
        full[safe_int] = int_vals
        full[safe_cut] = cut_vals
        return full[:B]

    dv_i, du_i, dv_j, du_j = (assemble(a, b)
                              for a, b in zip(got_int, got_cut))
    ncells = cells.mass.shape[0]
    live_i, live_j = ops._live(pairs, pair_mask, cells.pos.dtype)
    side_i = ops.masked(torch.cat([dv_i, du_i[..., None]], -1), live_i)
    side_j = ops.masked(torch.cat([dv_j, du_j[..., None]], -1), live_j)
    sums = ops._cell_sums(side_i, side_j, pairs.incoming, ncells)
    return sums[..., :3], sums[..., 3]


# --------------------------------------------------- fused sub-step programs
# scalars shipped per particle slot in each exchange (for byte accounting):
# exchange 1: rho, omega, press, cs; exchange 2: vel(3), u, bins, t_start,
# accel(3), dudt
_EX1_FIELDS = 4
_EX2_FIELDS = 10


def build_fused_substep_program(*, mode: str,
                                rounds: Sequence[Sequence[Tuple[int, int]]],
                                nranks: int, nrows: int, K: int, cfg,
                                box: float, device, final: bool = False):
    """One whole force sub-step over the stacked per-rank states.

    The device-resident engine's unit of work: drift → density phase →
    exchange 1 (rho, omega, press, cs) → force pass → kick/deepen →
    exchange 2 (vel, u, bins, t_start, accel, dudt). With ``final=True``
    it is the cycle-closing boundary instead: every particle active, the
    closing kick, no exchange 2.

    The program takes three dicts — ``state`` (each field ``(nranks,
    nrows, C, …)``, ``time`` ``(nranks,)``), ``tables`` (this sub-step's
    pair table in each rank's extended-row numbering, its stacked incoming
    table, the interior/cut positions, the wake floors and the exchange
    index tables) and ``scalars`` (dt/level/…) — and ``metrics``. The
    ranks are flattened to ``(nranks·nrows, C, …)`` for the body, each
    rank's pair ``(ci, cj)`` offset by its first row, so the density and
    the force pass each launch their pair kernel once for all ranks; each
    rank's time is expanded per row, so every element sees the operands of
    the rank's own 0-d time.

    Returns the updated state dict, a per-rank ``changed`` flag (int32, 1
    iff an owned row's bin deepened — the one signal the host needs
    mid-cycle), and, with ``metrics``, each rank's
    :mod:`~repro_torch.observability.device_metrics` rows
    (``counts``, ``values``, per-cell ``cells``) over its owned rows, else
    ``None``. The rows only read what the body holds, so the state is the
    same either way; the port has no compiled program for them to share,
    so they are built only when asked for.
    """
    lay = _StackedRanks(mode, rounds, nranks, nrows, K, device)
    stacked, per_rank = lay.stacked, lay.per_rank

    def program(state, tables, scalars, metrics: bool = False):
        dev = state["pos"].device

        def xchg(fields):
            return lay.xchg(tables, fields, tables["e_valid"])

        st = _drift(lay.state(state), scalars["dt_drift"], box=box)
        pairs = lay.pairs(tables)
        pmask = tables["pmask"].reshape(-1)
        wake = tables["wake"].reshape(-1)

        if final:
            active = st.cells.mask
        else:
            active = substep_active_mask(st, scalars["level"], wake)
        rho, om, pr, cs = _substep_density_phase(st, pairs, pmask, active,
                                                 cfg=cfg)
        rho2, om2, pr2, cs2 = xchg([rho, om, pr, cs])
        dv, du = _force_pass(st.cells, pairs, rho2, pr2, om2, cs2, cfg,
                             pair_mask=pmask)
        zeros = torch.zeros(nranks, dtype=torch.int32, device=dev)
        if final:
            st = _apply_final_kick(st, dv, du, rho2, om2, scalars["dt_max"],
                                   cfg=cfg)
            changed = deepened = woken = zeros
            kicked = per_rank((active > 0) & (st.cells.mask > 0)).sum(1)
            nexch = 1
        else:
            st, _ = _apply_force_kick(st, active, dv, du, rho2, om2, wake,
                                      scalars["dt_max"], scalars["depth"],
                                      scalars["u_floor"], cfg=cfg)
            vel, uu, bb, ts, ac, dd = xchg(
                [st.cells.vel, st.cells.u, st.bins, st.t_start, st.accel,
                 st.dudt])
            deepened = per_rank(lay.owned(bb)
                                != state["bins"][:, :K]).sum(1).to(
                                    torch.int32)
            changed = (deepened > 0).to(torch.int32)
            woken = (tables["wake"] > scalars["level"]).sum(1).to(
                torch.int32)
            kicked = per_rank(active).sum(1)
            st = st._replace(cells=st.cells._replace(vel=vel, u=uu),
                             bins=bb, t_start=ts, accel=ac, dudt=dd)
            nexch = 2
        met = None
        if metrics:
            cap = int(st.cells.mass.shape[1])
            slot_bytes = _EX1_FIELDS * cap * 4
            if nexch == 2:
                slot_bytes += _EX2_FIELDS * cap * 4
            nslots = per_rank(tables["e_valid"] > 0).sum(1)
            own = lay.owned
            counts, values = dmetrics.measure_substep(
                mask=own(st.cells.mask), active=own(active),
                vel=own(st.cells.vel), u=own(st.cells.u),
                mass=own(st.cells.mass), rho=own(st.rho),
                live_pairs=per_rank(tables["pmask"]).sum(1),
                pair_int=per_rank(tables["int_valid"] > 0).sum(1),
                pair_cut=per_rank(tables["cut_valid"] > 0).sum(1),
                exch_slots=nslots * nexch, exch_bytes=nslots * slot_bytes,
                deepened=deepened, woken=woken, kicked=kicked)
            cells = dmetrics.measure_cells(
                nrows=nrows, K=K, mask=own(st.cells.mask),
                pmask=tables["pmask"], ci=tables["ci"], cj=tables["cj"],
                exch_rows=lay.recv_rows(tables),
                exch_valid=tables["e_valid"], nexch=nexch)
            met = {"counts": counts, "values": values, "cells": cells}
        out = {k: stacked(getattr(st.cells, k)) for k in STATE_CELL_FIELDS}
        out.update({k: stacked(getattr(st, k)) for k in STATE_AUX_FIELDS})
        out["time"] = stacked(st.time)[:, 0, 0].contiguous()
        return out, changed, met

    return program


# ------------------------------------------------ device-scheduled segments
# neutral element of the integer scatter-max over possibly empty stencils
# (timebins.limit_neighbour_bins' value)
_NEG_INF_BIN = -10 ** 6


def limiter_sweeps(max_depth: int, bin_delta: int) -> int:
    """Jacobi sweeps after which the neighbour limiter's floors are the
    fixpoint's, with no convergence test (which would be a host read).

    A cell's deep value at the fixpoint is the largest deep₀(c') −
    bin_delta·d(c, c') over the cells c' at graph distance d; deep₀ ≤
    max_depth, so a value that has travelled more than max_depth /
    bin_delta cells is negative, and a floor, clip(nb − bin_delta, 0,
    max_depth), never sees a negative value. After ceil(max_depth /
    bin_delta) sweeps every value ≥ 0 is the fixpoint's, so every floor
    is. Without a positive delta nothing bounds the travel: the host's
    limiter stops after 256 sweeps, so these run 256, and a sweep after
    convergence changes nothing — the same floors either way.
    """
    if bin_delta >= 1:
        return -(-max(max_depth, 0) // bin_delta)
    return 256


def _stencil_max(x, ci, cj, pmask, neutral):
    """``x`` (rows, …) maxed over each row's stencil — itself and every row
    it shares a live pair with — as two scatter-maxes over the pair list
    (order-free, so any launch order gives the host neighbour table's
    value)."""
    live = pmask > 0
    nb = x.scatter_reduce(0, ci, torch.where(live, x[cj], neutral), "amax")
    return nb.scatter_reduce(0, cj, torch.where(live, x[ci], neutral),
                             "amax")


def np_mod(x, box: float):
    """``np.mod(x, box)`` on float32 tensors, bit for bit: fmod, plus
    ``box`` where a nonzero remainder's sign differs from the box's, and
    +0.0 for a zero one (``torch.remainder`` computes ``a − b·floor(a/b)``,
    which can differ just below ``box``)."""
    r = torch.fmod(x, box)
    r = torch.where((r != 0) & ((r < 0) != (box < 0)), r + box, r)
    return torch.where(r == 0, 0.0, r)


def cell_ids(pos, box: float, ncells_side: int, cell_size: torch.Tensor):
    """(cell id of each position, its wrapped position): ``cellgrid.
    bin_particles``' float32 arithmetic on the device (``cell_size`` a 0-d
    float32 tensor: a quotient by a host scalar may be taken as a product
    by its reciprocal on the card)."""
    ns = int(ncells_side)
    posw = np_mod(pos, box)
    idx3 = torch.floor(posw / cell_size).long().clamp(0, ns - 1)
    return (idx3[..., 0] * ns + idx3[..., 1]) * ns + idx3[..., 2], posw


def limit_bins(bins0, maskb, ci, cj, pmask, *, bin_delta: int,
               max_depth: int, exchange=lambda f: f):
    """``timebins.limit_neighbour_bins`` on the device: ``bins0`` (rows, C)
    floored at each row's stencil's deepest bin − ``bin_delta``, at the
    fixpoint, by :func:`limiter_sweeps` Jacobi sweeps with no convergence
    test; 0 where ``maskb`` is False. ``exchange`` gives halo rows their
    owner's values after each step (the identity on one rank)."""
    deep = exchange(torch.where(maskb, bins0, _NEG_INF_BIN).amax(1))
    for _ in range(limiter_sweeps(max_depth, bin_delta)):
        nb = _stencil_max(deep, ci, cj, pmask, _NEG_INF_BIN)
        deep = exchange(torch.maximum(deep, nb - bin_delta))
    nb = _stencil_max(deep, ci, cj, pmask, _NEG_INF_BIN)
    floor = torch.clamp(nb - bin_delta, 0, max_depth)
    return exchange(torch.where(maskb, torch.maximum(bins0, floor[:, None]),
                                0).to(torch.int32))


def _where_state(cond, a: TimeBinState, b: TimeBinState) -> TimeBinState:
    """``a`` where ``cond`` (a 0-d bool tensor) holds, else ``b``, field by
    field; a field both share is kept as it is."""
    pick = lambda x, y: x if x is y else torch.where(cond, x, y)
    return TimeBinState(
        cells=ParticleCells(*(pick(x, y) for x, y in zip(a.cells, b.cells))),
        **{k: pick(getattr(a, k), getattr(b, k))
           for k in STATE_AUX_FIELDS + ("time",)})


def build_cycle_scan_program(*, mode: str,
                             rounds: Sequence[Sequence[Tuple[int, int]]],
                             nranks: int, nrows: int, K: int, cfg,
                             box: float, nsub_static: int, bin_delta: int,
                             device, activity_aware: bool = True):
    """One whole cycle — every sub-step — over the stacked per-rank states.

    The device-scheduled lowering (``schedule="device"``): where
    :func:`build_fused_substep_program` runs one sub-step and leaves the
    ladder's bookkeeping (levels, pair subsets, ship sets, wake floors) to
    the host, this program derives all of it from the resident ``bins``,
    so the host enqueues a cycle and reads nothing until the segment ends.
    Its trips n = 1 … ``nsub_static`` (the static ladder; ``scalars
    ["nsub"]`` may select a shorter one, and the later trips are dead)
    each, for all ranks at once:

    * take the level max(depth − tz[n], 0) from a static trailing-zeros
      table;
    * recompute the wake floors from the bins by scatter-max over the pair
      table, and give the halo rows their owner's by a full-cut exchange;
    * gate the static **full touch table** by this trip's activity (a pair
      is live iff it touches an active row, the host's selection rule) and
      the exchange slots by their receiving row's activity;
    * are *dead* when no owned particle of any rank is due (and it is not
      the closing trip): every carry keeps its value through
      ``torch.where``, as the host's ``continue`` keeps it — the drift of
      the dead trips is made up by the next live one (``drifted_to``);
    * compute the interior and the closing kick side by side and keep one
      by ``torch.where``, and run exchange 2 on the closing trip too, so
      the halo rows enter a segment's next cycle current.

    Every trip launches each pair kernel once for all ranks, dead or live.
    A masked pair's contributions are +0.0 in each row's fixed-order sum
    (``ops.masked``), so each owned row adds what the host schedule's
    restricted table adds, in its order: bit for bit the host schedule.

    Inputs: ``state`` (the resident dict, ``time`` ``(nranks,)``),
    ``tables`` (:meth:`~repro_torch.sph.dist_timebins.
    DistTimeBinSimulation._segment_tables`) and ``scalars`` (0-d
    tensors ``dt_max``, ``depth``, ``nsub``, ``u_floor``). Returns the
    state, per-rank counters (owned active updates, owned live pair tasks,
    live interior trips, received slots, live trips, and ``t_end``) and
    the cycle's accumulated metrics rows (``counts``, ``values``,
    ``cells``) with their health flags — the one boundary pull reads them
    all. The device constants are made here, so a call copies nothing to
    the card.
    """
    lay = _StackedRanks(mode, rounds, nranks, nrows, K, device)
    tz = trailing_zeros_table(nsub_static)
    sel = {kind: torch.tensor([a == kind for a in dmetrics._V_ACCUM],
                              device=device)
           for kind in ("sum", "last", "max")}
    i32, f32 = torch.int32, torch.float32

    def fold_values(acc, row, live):
        """Live-gated fold of one values row by ``_V_ACCUM`` (a dead
        trip's row must not reach the last/max/min columns)."""
        upd_sum = acc + torch.where(live, row, 0.0)
        upd_last = torch.where(live, row, acc)
        upd_max = torch.maximum(acc, torch.where(live, row, -torch.inf))
        upd_min = torch.minimum(acc, torch.where(live, row, torch.inf))
        return torch.where(sel["sum"], upd_sum,
                           torch.where(sel["last"], upd_last,
                                       torch.where(sel["max"], upd_max,
                                                   upd_min)))

    def count(x):
        return lay.per_rank(x).sum(1).to(i32)

    def program(state, tables, scalars):
        dt_max, depth = scalars["dt_max"], scalars["depth"]
        nsub_dyn, u_floor = scalars["nsub"], scalars["u_floor"]
        dt_min = dt_min_of(dt_max, depth)
        pairs = lay.pairs(tables)
        ci, cj = pairs.ci.long(), pairs.cj.long()
        pmask = tables["pmask"].reshape(-1)
        e_valid = tables["e_valid"]
        rows_e = lay.recv_rows(tables)
        st = lay.state(state)
        fdt = st.cells.pos.dtype
        cap = int(st.cells.mass.shape[1])
        dev = st.cells.pos.device
        drifted = torch.zeros((), dtype=i32, device=dev)
        zero = torch.zeros(nranks, dtype=i32, device=dev)
        cnt = dict.fromkeys(("updates", "pair_tasks", "force_substeps",
                             "exported", "live_trips"), zero)
        met_c = torch.zeros((nranks, dmetrics.N_COUNTS), dtype=i32,
                            device=dev)
        met_v = torch.zeros((nranks, dmetrics.N_VALUES), dtype=f32,
                            device=dev)
        met_v[:, dmetrics.VALUE_INDEX["min_rho"]] = torch.inf
        met_w = torch.zeros((nranks, nrows, dmetrics.N_CELL_COLS),
                            dtype=f32, device=dev)
        for n in range(1, nsub_static + 1):
            mask = st.cells.mask
            maskb = mask > 0
            level = torch.clamp_min(depth - int(tz[n]), 0)
            is_final = nsub_dyn == n
            # ---- wake floors from the bins (the host's _wake_floor)
            deep = torch.where(maskb, st.bins, _NEG_INF_BIN).amax(1)
            wake_own = torch.clamp_min(_stencil_max(
                deep, ci, cj, pmask, _NEG_INF_BIN) - bin_delta, 0)
            (wake,) = lay.xchg(tables, [wake_own], e_valid)
            # ---- activity (substep_active_mask, or all on the last trip)
            sub_act = ((st.bins >= level) | (st.bins < wake[:, None])) \
                & maskb
            active = torch.where(is_final, mask, sub_act.to(fdt))
            row_act = sub_act.any(1).to(fdt)
            live = (((lay.owned(sub_act).sum() > 0) | is_final)
                    & (nsub_dyn >= n))
            # ---- the drift of every trip since the last live one
            kdt = (n - drifted).to(f32) * dt_min
            std = _drift(st, kdt, box=box)
            # ---- density, exchange 1, force over the gated tables
            pm = torch.where(is_final, pmask, pmask * torch.maximum(
                row_act[ci], row_act[cj]))
            rho, om, pr, cs = _substep_density_phase(std, pairs, pm, active,
                                                     cfg=cfg)
            ev = e_valid
            if activity_aware:
                ev = torch.where(is_final, e_valid,
                                 e_valid * lay.take(row_act, rows_e))
            rho2, om2, pr2, cs2 = lay.xchg(tables, [rho, om, pr, cs], ev)
            dv, du = _force_pass(std.cells, pairs, rho2, pr2, om2, cs2, cfg,
                                 pair_mask=pm)
            # ---- the interior and the closing kick, one kept
            st_f, _ = _apply_force_kick(std, sub_act.to(fdt), dv, du, rho2,
                                        om2, wake, dt_max, depth, u_floor,
                                        cfg=cfg)
            st_l = _apply_final_kick(std, dv, du, rho2, om2, dt_max, cfg=cfg)
            st_k = _where_state(is_final, st_l, st_f)
            # ---- exchange 2, the closing trip's too
            vel, uu, bb, ts, ac, dd = lay.xchg(
                tables, [st_k.cells.vel, st_k.cells.u, st_k.bins,
                         st_k.t_start, st_k.accel, st_k.dudt], ev)
            st_n = st_k._replace(cells=st_k.cells._replace(vel=vel, u=uu),
                                 bins=bb, t_start=ts, accel=ac, dudt=dd)
            # ---- counters (per rank; _run_segment sums them over ranks)
            live32 = live.to(i32)
            pm_r = lay.per_rank(pm)
            n_slots = count(ev > 0)
            n_upd = torch.where(is_final, count(lay.owned(maskb)),
                                count(lay.owned(sub_act)))
            cnt = {
                "updates": cnt["updates"] + live32 * n_upd,
                "pair_tasks": cnt["pair_tasks"] + live32 * count(
                    (pm_r > 0) & (tables["own_pair"] > 0)),
                "force_substeps": cnt["force_substeps"]
                + (live & ~is_final).to(i32),
                "exported": cnt["exported"] + live32 * n_slots,
                "live_trips": cnt["live_trips"] + live32,
            }
            # ---- the metrics rows, as the fused sub-step builds them
            nexch = torch.where(is_final, 1, 2)
            slot_bytes = torch.where(is_final, _EX1_FIELDS * cap * 4,
                                     (_EX1_FIELDS + _EX2_FIELDS) * cap * 4)
            pair_in = lambda pos, valid: torch.where(
                valid > 0, torch.gather(pm_r, 1, pos.long()), 0.0).sum(1)
            own = lay.owned
            counts, values = dmetrics.measure_substep(
                mask=own(st_n.cells.mask), active=own(active),
                vel=own(st_n.cells.vel), u=own(st_n.cells.u),
                mass=own(st_n.cells.mass), rho=own(st_n.rho),
                live_pairs=pm_r.sum(1),
                pair_int=pair_in(tables["int_pos"], tables["int_valid"]),
                pair_cut=pair_in(tables["cut_pos"], tables["cut_valid"]),
                exch_slots=n_slots * nexch, exch_bytes=n_slots * slot_bytes,
                deepened=torch.where(is_final, 0, count(own(bb != st.bins))),
                woken=torch.where(is_final, 0, count(wake > level)),
                kicked=torch.where(is_final, count((active > 0) & maskb),
                                   count(sub_act)))
            cells = dmetrics.measure_cells(
                nrows=nrows, K=K, mask=own(st_n.cells.mask), pmask=pm_r,
                ci=tables["ci"], cj=tables["cj"], exch_rows=rows_e,
                exch_valid=ev, nexch=nexch)
            met_c = met_c + torch.where(live, counts, 0)
            met_v = fold_values(met_v, values, live)
            met_w = met_w + torch.where(live, cells, 0.0)
            # ---- a dead trip keeps every carry
            st = _where_state(live, st_n, st)
            drifted = torch.where(live, n, drifted)
        out = {k: lay.stacked(getattr(st.cells, k))
               for k in STATE_CELL_FIELDS}
        out.update({k: lay.stacked(getattr(st, k)) for k in STATE_AUX_FIELDS})
        out["time"] = lay.stacked(st.time)[:, 0, 0].contiguous()
        cnt["t_end"] = out["time"]
        return out, cnt, {"counts": met_c, "values": met_v, "cells": met_w}

    return program


def build_plan_program(*, mode: str,
                       rounds: Sequence[Sequence[Tuple[int, int]]],
                       nranks: int, nrows: int, K: int, cfg, box: float,
                       ncells_side: int, max_depth: int, bin_delta: int,
                       depth_headroom: int, nsub_static: int, device,
                       dt_max_static: Optional[float] = None):
    """The opening of a segment's next cycle, on the device.

    What ``TimeBinSimulation._plan_cycle`` and the distributed prologue do
    on the host — the signal-velocity CFL field, the bins, the neighbour
    limiter, the depth, u_floor and the opening half-kick — over the
    resident rows, with the two sentinels the segment needs:

    * ``crossed``: the owned particles whose cell id (``cellgrid.
      bin_particles``' float32 arithmetic: ``np.mod``, then floor of the
      quotient) is not their row's cell, or whose position ``np.mod``
      would rewrite (the host's re-bin between the cycles would not have
      been the identity);
    * ``capacity``: the next cycle wants more sub-steps than the scan's
      static ladder.

    Every reduction is order-free (min, max, compare, scatter-max) or the
    pinned tree fold (u_floor over the owned rows gathered into global
    cell order by ``consts["gather_idx"]``), and the float chains round as
    the host's: bit for bit its plan. The limiter runs
    :func:`limiter_sweeps` Jacobi sweeps with a full-cut exchange in each,
    so it needs no convergence test. Returns ``bins``, ``vel``, ``u``,
    ``t_start`` (stacked), the cycle's scalars (0-d ``dt_max``, ``depth``,
    ``nsub``, ``u_floor``) and the flags (0-d ``crossed``, ``capacity``,
    and ``hist``, the owned bins' histogram over 0 … max_depth).
    """
    lay = _StackedRanks(mode, rounds, nranks, nrows, K, device)
    ns = int(ncells_side)
    cell_size = torch.tensor(np.float32(box / ns), device=device)
    ladder = torch.tensor(np.float32(2.0 ** max_depth), device=device)
    fixed = (None if dt_max_static is None
             else torch.tensor(np.float32(dt_max_static), device=device))
    levels = torch.arange(max_depth + 1, dtype=torch.int32, device=device)
    one = torch.ones((), dtype=torch.int32, device=device)

    def program(state, tables, consts):
        st = lay.state(state)
        cells = st.cells
        maskb = cells.mask > 0
        ci, cj = lay.pair_index(tables)
        pmask = tables["pmask"].reshape(-1)
        own = lay.owned
        e_valid = tables["e_valid"]

        # ---- crossing sentinel (bin_particles' cell id of each particle)
        pos = cells.pos
        cellid, posw = cell_ids(pos, box, ns, cell_size)
        rowcell = tables["rowcell"].reshape(-1, 1).long()
        moved = (posw.view(torch.int32) != pos.view(torch.int32)).any(-1)
        crossed = (own(((cellid != rowcell) | moved) & maskb).sum()
                   ).to(torch.int32)

        # ---- the signal-velocity CFL field (TimeBinSimulation.
        # _signal_speeds, over each owned row's complete stencil)
        cs = sound_speed(torch.ones_like(cells.u), cells.u, cfg.gamma)
        speed = torch.where(maskb, cs + sqrt_rn(dot3(cells.vel, cells.vel)),
                            0.0)
        s_nb = _stencil_max(speed.amax(1), ci, cj, pmask, 0.0)
        dts = cfg.cfl * cells.h / torch.clamp_min(s_nb[:, None], 1e-12)
        dts = torch.where(maskb, dts, torch.inf)
        dt_min_req = own(dts).amin()
        dt_max_c0 = fixed if fixed is not None else torch.where(
            own(maskb), own(dts), -torch.inf).amax()
        dt_max_c = torch.minimum(dt_max_c0, dt_min_req * ladder)

        # ---- bins and the neighbour limiter; halo rows' stencils are
        # incomplete, so they take their owner's values after each step
        bins0 = torch.where(maskb, assign_bins(dts, dt_max_c, max_depth), 0)
        bins = limit_bins(bins0, maskb, ci, cj, pmask, bin_delta=bin_delta,
                          max_depth=max_depth,
                          exchange=lambda f: lay.xchg(tables, [f],
                                                      e_valid)[0])

        # ---- depth, sub-steps and the owned bins' histogram
        occ = torch.clamp_min(torch.where(own(maskb), own(bins),
                                          _NEG_INF_BIN).amax(), 0)
        depth = torch.clamp_max(occ + depth_headroom, max_depth).to(
            torch.int32)
        nsub = torch.bitwise_left_shift(one, depth)
        hist = ((own(bins)[..., None] == levels)
                & own(maskb)[..., None]).sum((0, 1, 2))

        # ---- u_floor: the owned rows in global cell order, tree-folded
        gidx = consts["gather_idx"]
        cap = cells.mass.shape[1]
        glob = lambda x: own(x).reshape(-1, cap).index_select(0, gidx)
        u_floor = mass_weighted_mean_u(glob(cells.mass * cells.mask),
                                       glob(cells.u))

        # ---- the opening half-kick with the new bins (_cycle_start)
        opened = _cycle_start(st._replace(bins=bins), dt_max_c, cfg=cfg)
        upd = {"bins": lay.stacked(bins),
               "vel": lay.stacked(opened.cells.vel),
               "u": lay.stacked(opened.cells.u),
               "t_start": lay.stacked(opened.t_start)}
        scal = {"dt_max": dt_max_c, "depth": depth, "nsub": nsub,
                "u_floor": u_floor}
        flags = {"crossed": crossed,
                 "capacity": (nsub > nsub_static).to(torch.int32),
                 "hist": hist}
        return upd, scal, flags

    return program


class CollectiveTransport(Transport):
    """The exchange as index copies over the ranks stacked on the device.

    Holds the round schedule of the current decomposition, the bucket
    policy and the program cache. ``prepare(edges)`` is called whenever
    the decomposition (and so the export edge list) changes; ``exchange``
    stacks each field's per-rank tensors, runs one cached program and
    hands back per-rank views of its outputs.

    ``host_bytes`` stays 0: the copies never leave the card. (The
    reference pulls every output to the host after its collective only to
    normalise JAX's device placement of the mesh-sharded result; stacked
    ranks on one card have no placement to normalise.)
    """

    kind = "collective"

    def __init__(self, *, nranks: int, probe: Optional[CompileProbe] = None,
                 mode: str = "auto", min_bucket: int = 8,
                 shrink_patience: int = 4):
        if mode not in ("auto", "ppermute", "allgather"):
            raise ValueError(f"mode must be auto|ppermute|allgather, "
                             f"got {mode!r}")
        self.nranks = int(nranks)
        self.mode_requested = mode
        self.buckets = BucketPolicy(min_bucket=min_bucket,
                                    shrink_patience=shrink_patience)
        self.programs = ProgramCache(probe)
        self.rounds: List[List[Tuple[int, int]]] = []
        self._perms_sig: Tuple = ()
        self._edges: Optional[Tuple[Tuple[int, int], ...]] = None
        self.exchanges = 0
        self.shipped_rows = 0
        self.host_bytes = 0

    # ------------------------------------------------------------- planning
    def prepare(self, edges: Sequence[Tuple[int, int]]) -> None:
        edges_t = tuple(sorted({(int(s), int(d)) for s, d in edges}))
        if edges_t == self._edges:
            return
        self._edges = edges_t
        self.rounds = ppermute_rounds(edges_t, self.nranks)
        self._perms_sig = tuple(tuple(rnd) for rnd in self.rounds)

    @property
    def mode(self) -> str:
        if self.mode_requested != "auto":
            return self.mode_requested
        # neighbour-to-neighbour rounds while the edge colouring stays
        # within the ring bound; degenerate cuts fall back to one gather
        return "ppermute" if len(self.rounds) < self.nranks else "allgather"

    # ------------------------------------------------------------- exchange
    def exchange(self, slots: ShipSlots, fields: List[List],
                 stream: str = "substep",
                 label: Optional[str] = None) -> List[List]:
        if self._edges is None:
            raise RuntimeError("CollectiveTransport.exchange before "
                               "prepare(edges)")
        tr = self.tracer
        t0 = tr.now() if tr.enabled else 0.0
        nranks = self.nranks
        dev = fields[0][0].device
        nrows = int(fields[0][0].shape[0])
        meta = tuple((tuple(f[0].shape[1:]), str(f[0].dtype))
                     for f in fields)
        stacked = [torch.stack(list(f)) for f in fields]
        T = lambda a: torch.from_numpy(a).to(dev)
        if self.mode == "ppermute":
            B = self.buckets.fit(("edge", stream), slots.max_edge_slots)
            pack, unpack, valid = pack_rounds(self.rounds, slots, nranks, B)
            key = ("ppermute", nranks, nrows, B, self._perms_sig, meta)
            prog = self.programs.get(key, lambda: build_permute_program(
                self.rounds, nranks, nrows, B, len(fields)))
            outs = prog(T(pack), T(unpack), T(valid), *stacked)
            bkt = B
        else:
            Bo = self.buckets.fit(("ag_out", stream),
                                  slots.max_rank_exports(nranks))
            Bi = self.buckets.fit(("ag_in", stream),
                                  slots.max_rank_imports(nranks))
            pack, usrc, urows, valid = pack_allgather(slots, nranks, Bo, Bi)
            key = ("allgather", nranks, nrows, Bo, Bi, meta)
            prog = self.programs.get(key, lambda: build_allgather_program(
                nrows, Bo, Bi, len(fields)))
            outs = prog(T(pack), T(usrc), T(urows), T(valid), *stacked)
            bkt = max(Bo, Bi)
        self.exchanges += 1
        self.shipped_rows += slots.total
        if tr.enabled:
            tr.fence(outs[-1])
            tr.record_all(range(nranks), label or "exchange", t0,
                          stream=stream, mode=self.mode, bucket=bkt,
                          units=slots.total, kind="collective", collective=1)
        return [[o[r] for r in range(nranks)] for o in outs]

    def stats(self) -> Dict[str, object]:
        return {"kind": self.kind, "mode": self.mode,
                "rounds": len(self.rounds), "exchanges": self.exchanges,
                "shipped_rows": self.shipped_rows,
                "host_bytes": self.host_bytes,
                "programs": self.programs.builds,
                "bucket_events": list(self.buckets.events)}
