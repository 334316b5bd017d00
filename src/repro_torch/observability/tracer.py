"""Low-overhead host-side span tracer (port of ``repro.observability.tracer``).

SWIFT instruments every task with per-core tic/toc timestamps and reads the
resulting task plots to find load imbalance and dead time
(arXiv:1606.02738 §4). Kernel launches return before the device finishes,
so a ``perf_counter`` pair times the *enqueue*; spans are therefore paired
with :meth:`Tracer.fence` calls, which synchronise the CUDA device — only
when tracing is enabled — so device work is attributed to the phase that
launched it. Fences change no computed value.

:data:`NULL_TRACER` is the default: its ``span()`` returns one shared no-op
context manager and ``fence()`` does nothing, so tracing off keeps the
engines' asynchronous launches.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence


class Span(NamedTuple):
    """One closed tic/toc interval on one rank's timeline."""
    name: str
    rank: int
    t0: float                       # perf_counter seconds
    t1: float
    attrs: Optional[Dict[str, Any]]

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _ActiveSpan:
    """Context manager of one in-flight span.

    Also the ``timed()`` result: ``elapsed`` is always measured (the
    engines' ``stats["wall"]`` comes from it), recording into the tracer
    happens only when one is attached.
    """

    __slots__ = ("_tracer", "name", "rank", "attrs", "t0", "elapsed")

    def __init__(self, tracer: Optional["Tracer"], name: str, rank: int,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.rank = rank
        self.attrs = attrs
        self.t0 = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "_ActiveSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.elapsed = t1 - self.t0
        tr = self._tracer
        if tr is not None:
            tr._spans.append(Span(self.name, self.rank, self.t0, t1,
                                  self.attrs))
        return False


class _NoopSpan:
    """The disabled-path context manager: shared, stateless, free."""

    __slots__ = ()
    elapsed = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


def _tensors(value: Any):
    """The tensors in ``value`` (itself, or the leaves of a tuple)."""
    if hasattr(value, "device") and hasattr(value, "dtype"):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


class Tracer:
    """Collects :class:`Span` records for one run (all ranks, one stream).

    ``t_origin`` anchors the run's timeline; exported traces report µs
    since this origin so per-rank rows line up in one Perfetto view.
    """

    enabled = True

    def __init__(self, t_origin: Optional[float] = None):
        self._spans: List[Span] = []
        self.t_origin = (time.perf_counter() if t_origin is None
                         else float(t_origin))
        # ambient attrs merged into every span — engines park loop state
        # here (cycle, sub-step) so leaf call sites (e.g. a transport's
        # exchange) inherit it without plumbing arguments through layers
        self.ctx: Dict[str, Any] = {}

    def _merge(self, attrs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if self.ctx:
            merged = dict(self.ctx)
            merged.update(attrs)
            return merged
        return attrs or None

    # ------------------------------------------------------------ recording
    def span(self, name: str, rank: int = 0, **attrs) -> _ActiveSpan:
        """``with tracer.span("density", rank=r, units=npairs): ...``"""
        return _ActiveSpan(self, name, rank, self._merge(attrs))

    def timed(self, name: str, rank: int = 0, **attrs) -> _ActiveSpan:
        """A span whose ``elapsed`` the caller consumes (wall-clock stats).

        On :data:`NULL_TRACER` this still measures — it is the one shared
        timing helper behind every quadrant's ``stats["wall"]``.
        """
        return _ActiveSpan(self, name, rank, self._merge(attrs))

    def now(self) -> float:
        """Clock read for manual record()/record_all() intervals."""
        return time.perf_counter()

    def record(self, name: str, rank: int, t0: float,
               t1: Optional[float] = None, **attrs) -> None:
        """Append a closed span (manual tic/toc)."""
        if t1 is None:
            t1 = time.perf_counter()
        self._spans.append(Span(name, rank, t0, t1, self._merge(attrs)))

    def record_all(self, ranks: Sequence[int], name: str, t0: float,
                   t1: Optional[float] = None, **attrs) -> None:
        """Append the same interval to every participating rank's row —
        how one collective program (an exchange, a fused sub-step) shows
        up as a task on each rank's timeline."""
        if t1 is None:
            t1 = time.perf_counter()
        a = self._merge(attrs)
        for r in ranks:
            self._spans.append(Span(name, int(r), t0, t1, a))

    # -------------------------------------------------------------- fencing
    def fence(self, value: Any) -> Any:
        """Wait for the CUDA device that ``value`` (a tensor, or a
        NamedTuple / sequence holding tensors) lives on — attributes
        in-flight device work to the enclosing span. No-op on
        :data:`NULL_TRACER` and for CPU tensors."""
        import torch
        for t in _tensors(value):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
                break
        return value

    # -------------------------------------------------------------- reading
    @property
    def spans(self) -> List[Span]:
        return self._spans

    def clear(self) -> None:
        self._spans.clear()

    def ranks(self) -> List[int]:
        return sorted({s.rank for s in self._spans})


class NullTracer(Tracer):
    """The default, disabled tracer: recording is free, fencing is off."""

    enabled = False

    def __init__(self):
        super().__init__(t_origin=0.0)

    def span(self, name: str, rank: int = 0, **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def timed(self, name: str, rank: int = 0, **attrs) -> _ActiveSpan:
        return _ActiveSpan(None, name, rank, None)

    def record(self, name, rank, t0, t1=None, **attrs) -> None:
        pass

    def record_all(self, ranks, name, t0, t1=None, **attrs) -> None:
        pass

    def fence(self, value: Any) -> Any:
        return value


NULL_TRACER = NullTracer()
