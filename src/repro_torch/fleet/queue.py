"""Request queue: admission control, inflight tracking, deadlines.

Port of ``repro.fleet.queue``, unchanged in behaviour. A
:class:`FleetRequest` is one user's simulation — a frozen
:class:`~repro_torch.sph.api.SimulationSpec` plus how far to run it and by
when. The :class:`RequestQueue` never blocks on any single request; it
only answers "what work is ready *right now*", so the batcher
(:mod:`repro_torch.fleet.batcher`) can form shape-compatible batches, the
way SWIFT's scheduler hands each core the next *ready* task.

Admission is bounded (``max_inflight``): a full fleet rejects at the door
with :class:`AdmissionError` rather than queueing unboundedly. Deadlines
are wall-clock seconds from submission; :meth:`RequestQueue.expire` sweeps
overdue queued requests into ``EXPIRED`` (their callbacks fire with the
error) on every submit, poll and claim.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from ..sph.api import SimulationSpec


class RequestState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    EXPIRED = "expired"


class AdmissionError(RuntimeError):
    """The fleet is at ``max_inflight``; the request was not admitted."""


@dataclass
class FleetResult:
    """What a finished request hands back.

    ``particles`` is the final state in the user's flat per-particle order
    (the ``unbin`` layout: pos/vel/mass/u/h host numpy arrays of shape
    (n, …)), the representation that is bitwise-comparable across
    execution strategies — batched, sequential, card, CPU, either package
    — because it is independent of any engine's internal cell padding.
    ``energy``/``momentum`` are the standard diagnostics computed on host
    from exactly those arrays.
    """
    particles: Dict[str, Any]
    energy: float
    momentum: Any
    t: float
    steps: int
    wall: float                       # seconds inside the runner
    batched: bool                     # served by a batched entry point?
    batch_size: int = 1               # real members of the serving batch
    bucket: int = 1                   # padded batch bucket it rode in


@dataclass
class FleetRequest:
    """One admitted simulation request."""
    request_id: str
    spec: SimulationSpec
    n_steps: int
    deadline: Optional[float] = None        # seconds from submission
    callback: Optional[Callable[["FleetRequest"], None]] = None
    state: RequestState = RequestState.QUEUED
    submitted: float = field(default_factory=time.perf_counter)
    started: Optional[float] = None
    finished: Optional[float] = None
    result: Optional[FleetResult] = None
    error: Optional[BaseException] = None
    signature_key: str = ""
    row: int = 0                            # fleet trace row (timeline tid)

    @property
    def overdue(self) -> bool:
        return (self.deadline is not None
                and time.perf_counter() - self.submitted > self.deadline)

    @property
    def latency(self) -> Optional[float]:
        if self.finished is None:
            return None
        return self.finished - self.submitted

    def _finish(self, state: RequestState,
                result: Optional[FleetResult] = None,
                error: Optional[BaseException] = None) -> None:
        self.state = state
        self.result = result
        self.error = error
        self.finished = time.perf_counter()
        if self.callback is not None:
            self.callback(self)


class RequestQueue:
    """FIFO of queued requests with bounded admission and deadline sweeps."""

    def __init__(self, *, max_inflight: int = 1024):
        self.max_inflight = int(max_inflight)
        self._queued: List[FleetRequest] = []
        self._all: Dict[str, FleetRequest] = {}
        self._ids = itertools.count()
        self._rows = itertools.count()

    # ---------------------------------------------------------- admission
    def submit(self, spec: SimulationSpec, *, n_steps: int = 1,
               deadline: Optional[float] = None,
               request_id: Optional[str] = None,
               callback: Optional[Callable[[FleetRequest], None]] = None
               ) -> FleetRequest:
        # sweep first: a stale burst must not hold admission slots, and
        # its EXPIRED callbacks must fire even if nobody ever claims —
        # every front-door entry (submit/poll/claim) runs the sweep
        self.expire()
        if self.inflight >= self.max_inflight:
            raise AdmissionError(
                f"fleet at max_inflight={self.max_inflight}; request "
                f"rejected at admission")
        rid = request_id if request_id is not None \
            else f"req-{next(self._ids):04d}"
        if rid in self._all:
            raise ValueError(f"duplicate request_id {rid!r}")
        req = FleetRequest(request_id=rid, spec=spec, n_steps=int(n_steps),
                           deadline=deadline, callback=callback,
                           signature_key=spec.signature_key(),
                           row=next(self._rows))
        self._queued.append(req)
        self._all[rid] = req
        return req

    # ----------------------------------------------------------- tracking
    @property
    def inflight(self) -> int:
        return sum(1 for r in self._all.values()
                   if r.state in (RequestState.QUEUED, RequestState.RUNNING))

    def get(self, request_id: str) -> FleetRequest:
        return self._all[request_id]

    def expire(self) -> List[FleetRequest]:
        """Sweep overdue queued requests into EXPIRED; returns them."""
        dead = [r for r in self._queued if r.overdue]
        for r in dead:
            self._queued.remove(r)
            r._finish(RequestState.EXPIRED,
                      error=TimeoutError(
                          f"{r.request_id}: deadline {r.deadline}s passed "
                          f"before scheduling"))
        return dead

    def take_ready(self) -> List[FleetRequest]:
        """Claim every queued request (deadline sweep included), marking
        them RUNNING. Grouping into batches is the batcher's job."""
        self.expire()
        ready = self._queued
        self._queued = []
        now = time.perf_counter()
        for r in ready:
            r.state = RequestState.RUNNING
            r.started = now
        return ready

    def requeue(self, requests: List[FleetRequest]) -> None:
        """Return claimed requests to the head of the queue (a batch the
        runner could not place this round, e.g. a shape straggler)."""
        for r in requests:
            r.state = RequestState.QUEUED
            r.started = None
        self._queued[:0] = requests

    def complete(self, req: FleetRequest, result: FleetResult) -> None:
        req._finish(RequestState.DONE, result=result)

    def fail(self, req: FleetRequest, error: BaseException) -> None:
        req._finish(RequestState.FAILED, error=error)

    # ------------------------------------------------------------ reading
    def poll(self) -> Dict[str, int]:
        """Deadline sweep + queue stats: the non-claiming status check.

        Before this existed, sweeps ran only inside :meth:`take_ready` —
        a request with a passed deadline sat QUEUED forever (callback
        never fired) unless some *other* submission triggered a claim."""
        self.expire()
        return self.stats()

    def by_state(self, state: RequestState) -> List[FleetRequest]:
        return [r for r in self._all.values() if r.state is state]

    def stats(self) -> Dict[str, int]:
        out = {s.value: 0 for s in RequestState}
        for r in self._all.values():
            out[r.state.value] += 1
        out["total"] = len(self._all)
        return out
