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
fields, which is bitwise the split one. The reference's device-scheduled
cycle programs are ROADMAP queue 1 item 11b-2.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.comm_planner import ppermute_rounds
from ..distributed.transport import (BucketPolicy, CompileProbe, ProgramCache,
                                     ShipSlots, Transport, pack_allgather,
                                     pack_rounds)
from ..observability import device_metrics as dmetrics
from .cellgrid import PairList, ParticleCells
from .engine import _force_pass
from .timebins import (STATE_AUX_FIELDS, STATE_CELL_FIELDS, TimeBinState,
                       _apply_final_kick, _apply_force_kick, _drift,
                       _substep_density_phase, substep_active_mask)


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
    side_i = torch.cat([dv_i, du_i[..., None]], -1) * live_i[:, None, None]
    side_j = torch.cat([dv_j, du_j[..., None]], -1) * live_j[:, None, None]
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
                                box: float, final: bool = False):
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
    sources = _round_sources([list(rnd) for rnd in rounds], nranks)
    on_device: Dict[torch.device, List[torch.Tensor]] = {}
    N = nranks * nrows

    def flat(x):
        return x.reshape((N,) + tuple(x.shape[2:]))

    def stacked(x):
        return x.reshape((nranks, nrows) + tuple(x.shape[1:]))

    def per_rank(x):
        return x.reshape(nranks, -1)

    def program(state, tables, scalars, metrics: bool = False):
        dev = state["pos"].device
        if dev not in on_device:
            on_device[dev] = [s.to(dev) for s in sources]
        srcs = on_device[dev]

        def xchg(fields):
            if mode == "ppermute":
                outs = [_permute_copy(stacked(f), tables["e_pack"],
                                      tables["e_unpack"], tables["e_valid"],
                                      srcs, nrows) for f in fields]
            else:
                outs = [_allgather_copy(stacked(f), tables["e_pack"],
                                        tables["e_usrc"], tables["e_urows"],
                                        tables["e_valid"], nrows)
                        for f in fields]
            return [flat(o) for o in outs]

        st = TimeBinState(
            cells=ParticleCells(**{k: flat(state[k])
                                   for k in STATE_CELL_FIELDS}),
            time=state["time"].repeat_interleave(nrows)[:, None],
            **{k: flat(state[k]) for k in STATE_AUX_FIELDS})
        st = _drift(st, scalars["dt_drift"], box=box)
        first = (torch.arange(nranks, device=dev) * nrows)[:, None]
        pairs = PairList(
            ci=(tables["ci"] + first).to(torch.int32).reshape(-1),
            cj=(tables["cj"] + first).to(torch.int32).reshape(-1),
            shift=tables["shift"].reshape(-1, 3),
            incoming=(tables["in_rows"], tables["in_table"]))
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
            deepened = per_rank(stacked(bb)[:, :K]
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
            own = lambda x: stacked(x)[:, :K]
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
                exch_rows=(tables["e_unpack"] if mode == "ppermute"
                           else tables["e_urows"]),
                exch_valid=tables["e_valid"], nexch=nexch)
            met = {"counts": counts, "values": values, "cells": cells}
        out = {k: stacked(getattr(st.cells, k)) for k in STATE_CELL_FIELDS}
        out.update({k: stacked(getattr(st, k)) for k in STATE_AUX_FIELDS})
        out["time"] = st.time.reshape(nranks, nrows)[:, 0].contiguous()
        return out, changed, met

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
