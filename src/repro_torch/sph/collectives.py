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

The reference's fused device-resident sub-step and cycle programs wait for
ROADMAP queue 1 item 11b.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.comm_planner import ppermute_rounds
from ..distributed.transport import (BucketPolicy, CompileProbe, ProgramCache,
                                     ShipSlots, Transport, pack_allgather,
                                     pack_rounds)


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
