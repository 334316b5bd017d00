"""Transport subsystem: bucketed exchange buffers and program reuse.

Port of ``repro.distributed.transport``. SWIFT's communication is "just
another task": data ships the moment it is ready. The distributed time-bin
engine's exchanges must therefore keep one program shape for every
sub-step, however many cut-cell rows happen to be active — on the card,
the shape a CUDA-graph capture would be keyed by. This module holds the
generic machinery:

* :func:`next_pow2` / :class:`BucketPolicy` — power-of-two bucket sizing
  with grow/shrink **hysteresis**, the reference's exactly: growth is
  immediate, a bucket only shrinks after the demand has sat at half a
  bucket or less for ``shrink_patience`` consecutive fits.
* :class:`CompileProbe` / :class:`ProgramCache` — the program-signature
  probe. The port compiles nothing at run time, so a registered program
  counts the **distinct input-shape signatures** it has been called with
  (structure plus each tensor's shape and dtype): the keys a CUDA-graph
  capture would use. ``counts()`` keeps the reference's meaning for the
  exchange programs, whose inputs are bucket-padded: one per (program,
  bucket).
* :class:`ShipSlots` + :func:`pack_rounds` / :func:`pack_allgather` — the
  host-side image of one exchange, packed into bucket-padded index tables.
* :class:`HostTransport` — the host-mediated wire: each exchanged field's
  per-rank tensors go card → host (numpy) → card, with the shipped rows
  copied on the host. The reference semantics every on-card lowering must
  reproduce bit for bit.
* :class:`TransferProbe` — per-field accounting of the bytes the engine
  moves across the host boundary, split into cycle-boundary and
  intra-cycle traffic.
* :class:`ResidentBuffers` — the device-resident engine's stacked
  ``(nranks, …)`` state buffers, whose only host access goes through the
  probe.
* :func:`make_transport` — factory over ``"host" | "collective"`` (the
  collective wire lives in ``repro_torch.sph.collectives``, imported
  lazily so this layer stays free of SPH specifics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability.tracer import NULL_TRACER

TRANSPORTS = ("host", "collective")
RESIDENCIES = ("host", "device")

# the dynamical per-particle state of the time-bin engine: the arrays whose
# intra-cycle host↔device movement a device-resident path would eliminate.
# ``bins`` is deliberately *not* here — it is the schedule (1 int32 a
# particle) and its host mirror is refreshed on deepening events.
DYNAMIC_STATE_FIELDS = ("pos", "vel", "mass", "u", "h", "mask", "accel",
                        "dudt", "rho", "omega", "t_start", "time")


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ max(n, 1)."""
    p = 1
    while p < max(int(n), 1):
        p *= 2
    return p


class BucketPolicy:
    """Per-stream power-of-two bucket sizing with grow/shrink hysteresis.

    ``fit(key, n)`` returns the bucket to pad stream ``key``'s current
    demand ``n`` to. Growth (n > bucket) snaps immediately to
    ``next_pow2(n)``. Shrinking is damped: only after ``shrink_patience``
    consecutive fits with ``next_pow2(n) ≤ bucket / 2`` does the bucket
    halve (one level per event). Each power-of-two crossing of the demand
    therefore costs at most one bucket change — at most one new shape of
    any program keyed by the bucket.
    """

    def __init__(self, *, min_bucket: int = 1, shrink_patience: int = 4):
        self.min_bucket = next_pow2(min_bucket)
        self.shrink_patience = int(shrink_patience)
        self._bucket: Dict[object, int] = {}
        self._below: Dict[object, int] = {}
        self.events: List[Tuple[object, int, int]] = []   # (key, old, new)

    def current(self, key) -> Optional[int]:
        return self._bucket.get(key)

    def fit(self, key, n: int) -> int:
        need = max(next_pow2(n), self.min_bucket)
        cur = self._bucket.get(key)
        if cur is None:
            self._bucket[key] = need
            self._below[key] = 0
            return need
        if need > cur:                                   # grow: immediate
            self.events.append((key, cur, need))
            self._bucket[key] = need
            self._below[key] = 0
            return need
        if need <= cur // 2:
            # need ≥ min_bucket, so the halved bucket is always legal here
            self._below[key] = self._below[key] + 1
            if self._below[key] >= self.shrink_patience:
                new = cur // 2
                self.events.append((key, cur, new))
                self._bucket[key] = new
                # re-earn the patience at the new size, so a stream just
                # under the new half-bucket boundary does not halve again
                # on the very next fit
                self._below[key] = 0
                return new
        else:
            self._below[key] = 0
        return self._bucket[key]


def call_signature(value) -> object:
    """The shape signature of a call's arguments: nested tuples/lists (and
    NamedTuples) keep their structure, a tensor or array contributes its
    (shape, dtype), anything else its type name."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return (tuple(value.shape), str(value.dtype))
    if isinstance(value, (tuple, list)):
        return (type(value).__name__,
                tuple(call_signature(v) for v in value))
    if isinstance(value, dict):
        return tuple(sorted((k, call_signature(v)) for k, v in
                            value.items()))
    return (None, type(value).__name__)


class _SignatureCountingProgram:
    """A registered program: calls through and records the distinct
    :func:`call_signature` of its arguments."""

    __slots__ = ("_fn", "_signatures")

    def __init__(self, fn):
        self._fn = fn
        self._signatures = set()

    def __call__(self, *args, **kwargs):
        self._signatures.add(call_signature((args, kwargs)))
        return self._fn(*args, **kwargs)

    def signatures(self) -> int:
        return len(self._signatures)


class CompileProbe:
    """Registry of the engine's programs with their signature counts.

    ``register(name, fn)`` wraps ``fn`` so each distinct input-shape
    signature it is called with is counted; ``counts()`` reports them per
    program. Where the reference reads each jitted program's cache size
    (its XLA compiles), the port counts the same keys: a program over
    bucket-padded inputs shows one per (program, bucket). The phase
    programs' pair lists carry an incoming table whose shape follows the
    sub-step's active set, so their counts grow with the sub-steps until
    that table is padded too (ROADMAP queue 1 item 8).
    """

    def __init__(self):
        self._fns: Dict[str, _SignatureCountingProgram] = {}

    def register(self, name: str, fn) -> _SignatureCountingProgram:
        prog = _SignatureCountingProgram(fn)
        self._fns[name] = prog
        return prog

    def counts(self) -> Dict[str, int]:
        return {name: fn.signatures() for name, fn in self._fns.items()}

    def total_compiles(self) -> int:
        return sum(self.counts().values())


class ProgramCache:
    """Build-once cache of exchange programs, keyed by the static exchange
    signature (bucket, rounds, field shapes). Each build is registered with
    the probe, so its call signatures are counted."""

    def __init__(self, probe: Optional[CompileProbe] = None):
        self.probe = probe or CompileProbe()
        self._programs: Dict[object, Callable] = {}
        self.builds = 0

    def get(self, key, builder: Callable[[], Callable]) -> Callable:
        if key not in self._programs:
            prog = self.probe.register(f"program:{key}", builder())
            self._programs[key] = prog
            self.builds += 1
        return self._programs[key]

    @property
    def keys(self):
        return set(self._programs)


class TransferProbe:
    """Host↔device transfer accounting.

    Every byte the engine moves across the host boundary is ``record``-ed
    under a field name, tagged as cycle-``boundary`` traffic (scatter /
    gather, the once-a-cycle metrics pull) or intra-cycle traffic.
    """

    def __init__(self):
        self.boundary_bytes: Dict[str, int] = {}
        self.intra_bytes: Dict[str, int] = {}
        self.intra_events: Dict[str, int] = {}
        self.boundary_events: Dict[str, int] = {}

    def record(self, fname: str, nbytes: int, *, boundary: bool) -> None:
        book = self.boundary_bytes if boundary else self.intra_bytes
        book[fname] = book.get(fname, 0) + int(nbytes)
        events = self.boundary_events if boundary else self.intra_events
        events[fname] = events.get(fname, 0) + 1

    def intra_state_bytes(
            self, fields: Sequence[str] = DYNAMIC_STATE_FIELDS) -> int:
        """Intra-cycle bytes of dynamical state."""
        return sum(self.intra_bytes.get(f, 0) for f in fields)

    def total_bytes(self) -> int:
        return (sum(self.boundary_bytes.values())
                + sum(self.intra_bytes.values()))

    def stats(self) -> Dict[str, object]:
        return {"boundary_bytes": dict(self.boundary_bytes),
                "boundary_events": dict(self.boundary_events),
                "intra_bytes": dict(self.intra_bytes),
                "intra_state_bytes": self.intra_state_bytes(),
                "total_bytes": self.total_bytes()}


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


class ResidentBuffers:
    """Named stacked device buffers of the device-resident engine.

    Holds one ``(nranks, …)`` tensor per state field on the engine's
    device for the duration of a cycle. The only mutation path is
    :meth:`update` with a program's outputs (a device-side handoff, no
    transfer); every other access goes through :meth:`put` / :meth:`pull`,
    which record their bytes with the :class:`TransferProbe` — so the
    ledger is complete by construction as long as the engine never
    touches ``arrays`` directly.
    """

    def __init__(self, probe: TransferProbe):
        self.probe = probe
        self.arrays: Dict[str, torch.Tensor] = {}

    def put(self, name: str, array, place: Callable, *,
            boundary: bool = True) -> None:
        """Place ``array`` (a host array, or the global mirror's stacked
        rows, which the port keeps on the device) through ``place`` and
        record its bytes."""
        self.probe.record(name, _nbytes(array), boundary=boundary)
        self.arrays[name] = place(array)

    def pull(self, name: str, *, boundary: bool = True,
             index: Optional[object] = None,
             device: Optional[torch.device] = None):
        """Bring a buffer (or only its ``index`` slice) back and record the
        bytes that move: to the host as a numpy array, or, with
        ``device``, as a tensor on it (the cycle's gather into the
        global mirror, which lives on the card)."""
        arr = self.arrays[name]
        out = arr if index is None else arr[index]
        self.probe.record(name, _nbytes(out), boundary=boundary)
        if device is not None:
            return out.to(device)
        return out.cpu().numpy()

    def update(self, mapping: Dict[str, torch.Tensor]) -> None:
        """Adopt a program's outputs (they stay on the device: no
        transfer)."""
        self.arrays.update(mapping)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.arrays[name]


# ---------------------------------------------------------------- ship slots
@dataclass
class ShipSlots:
    """One exchange's copies, grouped by rank-to-rank edge.

    ``edges[(src, dst)]`` lists (src_row, dst_row) pairs: the source rank's
    extended-state row to read and the destination rank's row to overwrite.
    Rows are unique per destination (each replica row has one owner), so
    copy order is irrelevant.
    """
    edges: Dict[Tuple[int, int], List[Tuple[int, int]]] = \
        field(default_factory=dict)

    def add(self, src: int, dst: int, src_row: int, dst_row: int) -> None:
        self.edges.setdefault((src, dst), []).append((src_row, dst_row))

    @property
    def total(self) -> int:
        return sum(len(v) for v in self.edges.values())

    @property
    def max_edge_slots(self) -> int:
        return max((len(v) for v in self.edges.values()), default=0)

    def max_rank_exports(self, nranks: int) -> int:
        out = [0] * nranks
        for (s, _d), v in self.edges.items():
            out[s] += len(v)
        return max(out, default=0)

    def max_rank_imports(self, nranks: int) -> int:
        out = [0] * nranks
        for (_s, d), v in self.edges.items():
            out[d] += len(v)
        return max(out, default=0)


def pack_rounds(rounds: Sequence[Sequence[Tuple[int, int]]],
                slots: ShipSlots, nranks: int, bucket: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket-padded index tables for a ppermute-rounds exchange.

    Returns ``(pack_rows, unpack_rows, unpack_valid)``, each
    ``(nranks, R, bucket)``: in round ``t`` rank ``r`` sends the rows
    ``pack_rows[r, t]`` (0-padded) and, if it is the round's destination,
    writes the received slots ``k`` with ``unpack_valid[r, t, k] > 0`` into
    rows ``unpack_rows[r, t, k]``. Each round is a partial permutation
    (``core.comm_planner.ppermute_rounds``), so sender and receiver agree on
    slot order by construction.
    """
    scheduled = {e for rnd in rounds for e in rnd}
    missing = set(slots.edges) - scheduled
    if missing:
        raise ValueError(
            f"ship slots on edges {sorted(missing)} absent from the round "
            f"schedule — transport.prepare() did not run for this plan")
    R = max(len(rounds), 1)
    pack = np.zeros((nranks, R, bucket), dtype=np.int32)
    unpack = np.zeros((nranks, R, bucket), dtype=np.int32)
    valid = np.zeros((nranks, R, bucket), dtype=np.float32)
    for t, rnd in enumerate(rounds):
        for (s, d) in rnd:
            pairs = slots.edges.get((s, d), ())
            if len(pairs) > bucket:
                raise ValueError(
                    f"edge ({s}->{d}) ships {len(pairs)} rows > bucket "
                    f"{bucket}")
            for k, (srow, drow) in enumerate(pairs):
                pack[s, t, k] = srow
                unpack[d, t, k] = drow
                valid[d, t, k] = 1.0
    return pack, unpack, valid


def pack_allgather(slots: ShipSlots, nranks: int, bucket_out: int,
                   bucket_in: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucket-padded index tables for the all-gather fallback.

    Every rank contributes one export buffer of ``bucket_out`` rows
    (``pack_rows``); after the gather each rank reads slot
    ``unpack_src[r, k]`` of the flattened ``(nranks * bucket_out)`` buffer
    into row ``unpack_rows[r, k]`` where ``unpack_valid[r, k] > 0``.
    """
    pack = np.zeros((nranks, bucket_out), dtype=np.int32)
    unpack_src = np.zeros((nranks, bucket_in), dtype=np.int32)
    unpack_rows = np.zeros((nranks, bucket_in), dtype=np.int32)
    valid = np.zeros((nranks, bucket_in), dtype=np.float32)
    out_n = [0] * nranks
    in_n = [0] * nranks
    for (s, d) in sorted(slots.edges):
        for (srow, drow) in slots.edges[(s, d)]:
            k = out_n[s]
            if k >= bucket_out:
                raise ValueError(
                    f"rank {s} exports {k + 1} rows > bucket {bucket_out}")
            pack[s, k] = srow
            out_n[s] += 1
            m = in_n[d]
            if m >= bucket_in:
                raise ValueError(
                    f"rank {d} imports {m + 1} rows > bucket {bucket_in}")
            unpack_src[d, m] = s * bucket_out + k
            unpack_rows[d, m] = drow
            valid[d, m] = 1.0
            in_n[d] += 1
    return pack, unpack_src, unpack_rows, valid


# ---------------------------------------------------------------- transports
class Transport:
    """One exchange step: owner rows → replica rows across ranks.

    ``fields`` is a list of per-rank tensor lists (``fields[f][r]`` has the
    extended row layout on rank ``r``); the returned structure is the same
    with the destination rows of every slot overwritten by the source rank's
    values, bit for bit. Implementations are pure copies, so every wire
    gives the same states.
    """

    kind = "abstract"
    # observability hook: rebound to the run's tracer by the engine
    tracer = NULL_TRACER

    def prepare(self, edges: Sequence[Tuple[int, int]]) -> None:
        """New decomposition: the rank-to-rank export edge list changed."""

    def exchange(self, slots: ShipSlots, fields: List[List],
                 stream: str = "substep",
                 label: Optional[str] = None) -> List[List]:
        """``stream`` names the demand stream for bucket sizing (the
        activity-restricted sub-steps and the full-cut cycle sync must not
        share a bucket); ``label`` names the traced span."""
        raise NotImplementedError

    def stats(self) -> Dict[str, object]:
        return {"kind": self.kind}


class HostTransport(Transport):
    """Host-mediated wire: numpy row copies between the phase programs.

    ``host_bytes`` counts what this wire costs beyond the copies
    themselves: every exchanged field makes a device → host → device round
    trip of its *full* per-rank arrays (not just the shipped rows).
    """

    kind = "host"

    def __init__(self):
        self.host_bytes = 0
        self.exchanges = 0

    def exchange(self, slots: ShipSlots, fields: List[List],
                 stream: str = "substep",
                 label: Optional[str] = None) -> List[List]:
        tr = self.tracer
        t0 = tr.now() if tr.enabled else 0.0
        nranks = max(len(f) for f in fields)
        devices = [[fr.device for fr in f] for f in fields]
        arrays = [[fr.cpu().numpy().copy() for fr in f] for f in fields]
        self.host_bytes += 2 * sum(a.nbytes for f in arrays for a in f)
        self.exchanges += 1
        for (s, d), pairs in slots.edges.items():
            for (srow, drow) in pairs:
                for f in range(len(arrays)):
                    arrays[f][d][drow] = arrays[f][s][srow]
        out = [[torch.from_numpy(arrays[f][r]).to(devices[f][r])
                for r in range(nranks)] for f in range(len(arrays))]
        if tr.enabled:
            tr.record_all(range(nranks), label or "exchange", t0,
                          stream=stream, units=slots.total,
                          kind="host", collective=1)
        return out

    def stats(self) -> Dict[str, object]:
        return {"kind": self.kind, "exchanges": self.exchanges,
                "host_bytes": self.host_bytes}


def make_transport(kind: str, *, nranks: int,
                   probe: Optional[CompileProbe] = None,
                   mode: str = "auto") -> Transport:
    """Build a transport: ``"host"`` (numpy copies) or ``"collective"``
    (index copies over the ranks stacked on the device, ppermute rounds or
    one all-gather over bucketed buffers)."""
    if kind == "host":
        return HostTransport()
    if kind == "collective":
        from ..sph.collectives import CollectiveTransport
        return CollectiveTransport(nranks=nranks, probe=probe, mode=mode)
    raise ValueError(f"transport must be one of {TRANSPORTS}, got {kind!r}")
