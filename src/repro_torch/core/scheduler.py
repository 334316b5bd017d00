"""Wave scheduling and discrete-event simulation of the async executor.

On CPU clusters SWIFT's QuickSched picks runnable tasks dynamically. On a TPU
the program is static, so the graph is compiled ahead of time into **waves**:
maximal conflict-free antichains of ready tasks. Each wave lowers to one fused
XLA/Pallas op batched over all tasks of the same kind (see ``sph/engine.py``).

The :class:`AsyncExecutorSim` is a discrete-event simulator of the *paper's*
runtime (work-stealing threads + asynchronous sends/recvs with latency). It is
used by ``benchmarks/strong_scaling.py`` to reproduce the strong-scaling
figures (Figs 5, 6, 8): the simulated speed-up of the SWIFT schedule vs the
bulk-synchronous baseline is the paper's central claim, and it is a property
of the *schedule*, not of the hardware.
"""

from __future__ import annotations

import collections
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .taskgraph import TaskGraph


# --------------------------------------------------------------------- waves
def wave_schedule(graph: TaskGraph, *, by_kind: bool = True,
                  active_only: bool = False) -> List[List[int]]:
    """Greedy maximal conflict-free antichain decomposition.

    Repeatedly take every task whose dependencies are all satisfied, then
    within the ready set drop tasks that conflict with an already-picked task
    of the same wave (greedy maximal independent set in the conflict graph,
    highest-cost-first so expensive tasks are scheduled early).

    With ``by_kind`` the ready set is additionally split per task kind so
    each wave lowers to a single homogeneous batched op.

    With ``active_only`` the schedule covers only tasks whose activation
    mask is set (hierarchical time-stepping: inactive tasks have nothing
    due at the current bin level). Dependencies on inactive tasks count as
    satisfied; the returned waves never contain an inactive task.
    """
    if active_only:
        graph = graph.active_subgraph()
    indeg = {tid: len(graph.dependencies(tid)) for tid in graph.tasks}
    ready = {tid for tid, d in indeg.items() if d == 0}
    waves: List[List[int]] = []
    while ready:
        pool = sorted(ready, key=lambda t: (-graph.tasks[t].cost, t))
        if by_kind:
            kinds = collections.Counter(graph.tasks[t].kind for t in pool)
            # schedule the kind with the largest ready population first
            kind = max(kinds, key=lambda k: (kinds[k], k))
            pool = [t for t in pool if graph.tasks[t].kind == kind]
        wave: List[int] = []
        picked: set = set()
        blocked: set = set()
        for tid in pool:
            if tid in blocked:
                continue
            wave.append(tid)
            picked.add(tid)
            blocked |= graph.conflicts(tid)
        waves.append(wave)
        for tid in wave:
            ready.discard(tid)
            for dep in graph.dependents(tid):
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    ready.add(dep)
    graph.validate_schedule(waves)
    return waves


def balance_wave(costs: Sequence[float], num_bins: int) -> List[List[int]]:
    """Cost-balanced batching of one wave across ``num_bins`` executors.

    LPT (longest processing time) greedy: the AOT analogue of QuickSched's
    dynamic load balancing. Returns per-bin task-index lists.
    """
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    heap: List[Tuple[float, int]] = [(0.0, b) for b in range(num_bins)]
    heapq.heapify(heap)
    bins: List[List[int]] = [[] for _ in range(num_bins)]
    for i in order:
        load, b = heapq.heappop(heap)
        bins[b].append(i)
        heapq.heappush(heap, (load + costs[i], b))
    return bins


def makespan_lower_bound(graph: TaskGraph, workers: int) -> float:
    """max(critical path, total work / workers) — classic Graham bound."""
    cp, _ = graph.critical_path()
    return max(cp, graph.total_cost() / max(workers, 1))


# --------------------------------------------------- discrete-event simulator
@dataclass
class SimResult:
    makespan: float
    per_rank_busy: Dict[int, float]
    per_rank_idle: Dict[int, float]
    messages: int
    message_bytes: float
    ranks: int = 1
    threads: int = 1
    timeline: Optional[List[Tuple[float, float, int, int]]] = None  # (t0,t1,rank,tid)

    @property
    def efficiency(self) -> float:
        busy = sum(self.per_rank_busy.values())
        denom = self.makespan * max(self.ranks, 1) * max(self.threads, 1)
        return busy / denom if denom > 0 else 0.0


class AsyncExecutorSim:
    """Discrete-event simulation of SWIFT's async runtime.

    Ranks own tasks (``task.rank``); each rank has ``threads`` workers. A
    ``send``/``recv`` task pair models one MPI_Isend/Irecv: the send occupies
    its rank for ``send_overhead`` seconds (injection), then the matching recv
    completes ``latency + bytes/bandwidth`` later *without occupying a core* —
    this is the "fully asynchronous" part. Compute tasks become runnable when
    all dependencies are done; each worker greedily picks the costliest
    runnable local task (work-stealing within a rank is free on shared
    memory).

    For the bulk-synchronous baseline (``synchronous=True``) every task kind
    forms a barrier across all ranks, and communication happens in a separate
    phase where workers sit idle — the branch-and-bound model the paper
    argues against.
    """

    def __init__(self, graph: TaskGraph, *, ranks: int, threads: int = 1,
                 latency: float = 1e-6, bandwidth: float = 5e9,
                 send_overhead: float = 5e-7, synchronous: bool = False,
                 record_timeline: bool = False, active_only: bool = False):
        if active_only:
            # hierarchical time-stepping: simulate only the tasks that are
            # due at the current bin level (inactive deps pre-satisfied)
            graph = graph.active_subgraph()
        self.g = graph
        self.ranks = ranks
        self.threads = threads
        self.latency = latency
        self.bandwidth = bandwidth
        self.send_overhead = send_overhead
        self.synchronous = synchronous
        self.record_timeline = record_timeline

    def run(self) -> SimResult:
        g = self.g
        indeg = {tid: len(g.dependencies(tid)) for tid in g.tasks}
        ready: List[List[Tuple[float, int]]] = [[] for _ in range(self.ranks)]
        for tid, d in indeg.items():
            if d == 0:
                t = g.tasks[tid]
                heapq.heappush(ready[t.rank], (-t.cost, tid))

        # event heap: (time, seq, kind, payload)
        events: List[Tuple[float, int, str, tuple]] = []
        seq = 0
        free_workers = {r: self.threads for r in range(self.ranks)}
        busy = collections.defaultdict(float)
        done_time = 0.0
        messages = 0
        message_bytes = 0.0
        timeline: List[Tuple[float, float, int, int]] = []
        now = 0.0
        ndone = 0

        def message_size(task) -> float:
            # payload convention for send/recv: (peer_rank, nbytes)
            if len(task.payload) >= 2:
                return float(task.payload[1])
            return 4096.0

        def try_dispatch(rank: int):
            nonlocal seq, messages, message_bytes
            while free_workers[rank] > 0 and ready[rank]:
                if self.synchronous:
                    # BSP superstep: only tasks at the current barrier
                    # level may run (lock-step level-by-level execution —
                    # the branch-and-bound baseline of the paper)
                    kept = [(c, t) for (c, t) in ready[rank]
                            if depth[t] == barrier_level]
                    if not kept:
                        return
                    heapq.heapify(kept)
                    c, tid = heapq.heappop(kept)
                    rest = [(cc, tt) for (cc, tt) in ready[rank]
                            if tt != tid]
                    heapq.heapify(rest)
                    ready[rank][:] = rest
                else:
                    c, tid = heapq.heappop(ready[rank])
                task = g.tasks[tid]
                if task.kind == "send":
                    # occupies the core only for the injection overhead
                    free_workers[rank] -= 1
                    seq += 1
                    heapq.heappush(events, (now + self.send_overhead, seq,
                                            "worker_free", (rank,)))
                    nbytes = message_size(task)
                    messages += 1
                    message_bytes += nbytes
                    wire = self.latency + nbytes / self.bandwidth
                    seq += 1
                    heapq.heappush(events, (now + self.send_overhead + wire,
                                            seq, "task_done", (tid,)))
                    busy[rank] += self.send_overhead
                elif task.kind == "recv":
                    # recv is passive: completes instantly once its
                    # dependency (the matching send) is done.
                    seq += 1
                    heapq.heappush(events, (now, seq, "task_done", (tid,)))
                else:
                    free_workers[rank] -= 1
                    seq += 1
                    heapq.heappush(events, (now + task.cost, seq,
                                            "compute_done", (tid, rank, now)))
                    busy[rank] += task.cost

        depth: Dict[int, int] = {}
        remaining_by_level: Optional[collections.Counter] = None
        barrier_level = 0
        if self.synchronous:
            # level barriers: every task waits for the whole previous
            # topological level across all ranks — the bulk-synchronous
            # compute/communicate phase structure the paper argues against
            for tid in g.toposort():
                deps = g.dependencies(tid)
                depth[tid] = 1 + max((depth[d] for d in deps), default=-1)
            remaining_by_level = collections.Counter(depth.values())

        for r in range(self.ranks):
            try_dispatch(r)

        while events:
            now, _, ekind, payload = heapq.heappop(events)
            if ekind == "worker_free":
                (rank,) = payload
                free_workers[rank] += 1
                try_dispatch(rank)
                continue
            if ekind == "compute_done":
                tid, rank, t0 = payload
                free_workers[rank] += 1
                if self.record_timeline:
                    timeline.append((t0, now, rank, tid))
                seq += 1
                heapq.heappush(events, (now, seq, "task_done", (tid,)))
                try_dispatch(rank)
                continue
            # task_done: release dependents
            (tid,) = payload
            ndone += 1
            done_time = max(done_time, now)
            task = g.tasks[tid]
            if self.synchronous and remaining_by_level is not None:
                remaining_by_level[depth[tid]] -= 1
                advanced = False
                while remaining_by_level.get(barrier_level, 0) == 0 \
                        and barrier_level <= max(remaining_by_level):
                    barrier_level += 1
                    advanced = True
                if advanced:
                    for r in range(self.ranks):
                        try_dispatch(r)
            for dep in self.g.dependents(tid):
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    t = self.g.tasks[dep]
                    heapq.heappush(ready[t.rank], (-t.cost, dep))
                    try_dispatch(t.rank)

        if ndone != len(g.tasks):
            raise RuntimeError(
                f"simulation deadlock: {ndone}/{len(g.tasks)} tasks done")
        idle = {r: done_time * self.threads - busy[r]
                for r in range(self.ranks)}
        return SimResult(makespan=done_time,
                         per_rank_busy=dict(busy), per_rank_idle=idle,
                         messages=messages, message_bytes=message_bytes,
                         ranks=self.ranks, threads=self.threads,
                         timeline=timeline if self.record_timeline else None)
