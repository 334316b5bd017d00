"""Task graph with dependencies and conflicts (SWIFT §3.1, QuickSched model).

A computation is decomposed into :class:`Task` objects. Two relations are
tracked, exactly as in the paper:

* **dependency** — task A *depends on* task B: B must complete before A may
  start (data produced by B is consumed by A).
* **conflict** — tasks A and B require exclusive access to the same resource
  but in no particular order; a valid schedule must never run them
  concurrently.

On a TPU there is no runtime scheduler — the graph is *compiled* (see
``scheduler.py``) into a static wave schedule ahead of time. This module is
the pure data structure: construction, validation, topological utilities, and
the cell-graph projection used by the domain decomposition (SWIFT §3.2).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple


class TaskGraphError(Exception):
    """Raised for structural errors (cycles, unknown ids, self-deps)."""


@dataclass(frozen=True)
class Task:
    """A single unit of work.

    Attributes
    ----------
    tid:        unique integer id within the graph.
    kind:       task type, e.g. ``"sort"``, ``"density_self"``,
                ``"density_pair"``, ``"ghost"``, ``"force_self"``,
                ``"force_pair"``, ``"kick"``, ``"send"``, ``"recv"``.
    resources:  ids of the resources (cells, tensors) the task touches.
                Tasks sharing a resource *with write intent* conflict.
    writes:     subset of ``resources`` written (exclusive access needed).
    cost:       estimated execution cost (arbitrary units; see cost_model).
    rank:       partition / rank the task is assigned to (-1 = unassigned).
    payload:    opaque metadata (e.g. cell indices for a pair task).
    active:     activation mask for hierarchical time-stepping: a task whose
                cells contain no particle due at the current time-bin level
                is *inactive* and is skipped by the wave scheduler and the
                executor simulation (see ``sph/timebins.py``).
    """

    tid: int
    kind: str
    resources: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    cost: float = 1.0
    rank: int = -1
    payload: tuple = ()
    active: bool = True

    def __post_init__(self):
        for w in self.writes:
            if w not in self.resources:
                raise TaskGraphError(
                    f"task {self.tid}: write target {w} not in resources")


class TaskGraph:
    """Mutable task graph with dependencies and conflicts."""

    def __init__(self) -> None:
        self.tasks: Dict[int, Task] = {}
        # dependents[b] = set of tasks that depend on b (b -> a edges)
        self._dependents: Dict[int, Set[int]] = collections.defaultdict(set)
        # dependencies[a] = set of tasks a depends on
        self._dependencies: Dict[int, Set[int]] = collections.defaultdict(set)
        self._conflicts: Dict[int, Set[int]] = collections.defaultdict(set)
        self._next_id = 0

    # ------------------------------------------------------------------ build
    def add_task(self, kind: str, *, resources: Sequence[int] = (),
                 writes: Sequence[int] = (), cost: float = 1.0,
                 rank: int = -1, payload: tuple = (),
                 active: bool = True) -> int:
        tid = self._next_id
        self._next_id += 1
        self.tasks[tid] = Task(tid=tid, kind=kind,
                               resources=tuple(resources),
                               writes=tuple(writes), cost=float(cost),
                               rank=rank, payload=tuple(payload),
                               active=bool(active))
        return tid

    def add_dependency(self, task: int, depends_on: int) -> None:
        """``task`` may only run after ``depends_on`` has completed."""
        if task == depends_on:
            raise TaskGraphError(f"self-dependency on task {task}")
        self._check(task), self._check(depends_on)
        self._dependencies[task].add(depends_on)
        self._dependents[depends_on].add(task)

    def add_conflict(self, a: int, b: int) -> None:
        if a == b:
            raise TaskGraphError(f"self-conflict on task {a}")
        self._check(a), self._check(b)
        self._conflicts[a].add(b)
        self._conflicts[b].add(a)

    def auto_conflicts(self) -> int:
        """Derive conflicts from write-sets (two tasks writing one resource).

        Returns the number of conflict pairs added. Dependency-ordered pairs
        are skipped — ordering already serialises them.
        """
        by_resource: Dict[int, List[int]] = collections.defaultdict(list)
        for t in self.tasks.values():
            for w in t.writes:
                by_resource[w].append(t.tid)
        added = 0
        reach = None
        for tids in by_resource.values():
            if len(tids) < 2:
                continue
            if reach is None:
                reach = self._reachability()
            for i in range(len(tids)):
                for j in range(i + 1, len(tids)):
                    a, b = tids[i], tids[j]
                    if b in reach.get(a, ()) or a in reach.get(b, ()):
                        continue  # ordered by dependencies already
                    if b not in self._conflicts[a]:
                        self.add_conflict(a, b)
                        added += 1
        return added

    # ------------------------------------------------------------ inspection
    def dependencies(self, tid: int) -> FrozenSet[int]:
        return frozenset(self._dependencies.get(tid, ()))

    def dependents(self, tid: int) -> FrozenSet[int]:
        return frozenset(self._dependents.get(tid, ()))

    def conflicts(self, tid: int) -> FrozenSet[int]:
        return frozenset(self._conflicts.get(tid, ()))

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks.values())

    def total_cost(self) -> float:
        return sum(t.cost for t in self.tasks.values())

    def _check(self, tid: int) -> None:
        if tid not in self.tasks:
            raise TaskGraphError(f"unknown task id {tid}")

    # ----------------------------------------------------- activity masking
    def active_tasks(self) -> FrozenSet[int]:
        """Ids of tasks whose activation mask is set."""
        return frozenset(t.tid for t in self.tasks.values() if t.active)

    def set_active(self, predicate: Callable[["Task"], bool]) -> int:
        """Recompute every task's activation flag; returns #active.

        Used by the time-bin hierarchy: at sub-step level L only tasks whose
        cells hold particles in bins ≥ L are due, everything else is skipped
        by the scheduler (SWIFT runs "only the work that is due").
        """
        n = 0
        for tid, t in list(self.tasks.items()):
            a = bool(predicate(t))
            n += a
            if a != t.active:
                self.tasks[tid] = Task(tid=t.tid, kind=t.kind,
                                       resources=t.resources, writes=t.writes,
                                       cost=t.cost, rank=t.rank,
                                       payload=t.payload, active=a)
        return n

    def active_subgraph(self) -> "TaskGraph":
        """Project onto the active tasks (same task ids).

        Dependencies on inactive tasks are treated as already satisfied —
        an inactive density task belongs to a cell with nothing due, so the
        ghost/force chain of an *active* neighbour must not wait on it.
        Conflicts between two active tasks are preserved.
        """
        keep = {tid for tid, t in self.tasks.items() if t.active}
        g = TaskGraph()
        g.tasks = {tid: self.tasks[tid] for tid in keep}
        g._next_id = self._next_id
        for tid in keep:
            deps = {d for d in self._dependencies.get(tid, ()) if d in keep}
            if deps:
                g._dependencies[tid] = deps
                for d in deps:
                    g._dependents[d].add(tid)
            confl = {c for c in self._conflicts.get(tid, ()) if c in keep}
            if confl:
                g._conflicts[tid] = confl
        return g

    # ---------------------------------------------------------------- orders
    def toposort(self) -> List[int]:
        """Kahn topological order; raises on cycles."""
        indeg = {tid: len(self._dependencies.get(tid, ())) for tid in self.tasks}
        queue = collections.deque(sorted(t for t, d in indeg.items() if d == 0))
        order: List[int] = []
        while queue:
            tid = queue.popleft()
            order.append(tid)
            for dep in sorted(self._dependents.get(tid, ())):
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    queue.append(dep)
        if len(order) != len(self.tasks):
            raise TaskGraphError("dependency cycle detected")
        return order

    def _reachability(self) -> Dict[int, Set[int]]:
        """reach[a] = all tasks transitively reachable from a via dependents."""
        order = self.toposort()
        reach: Dict[int, Set[int]] = {tid: set() for tid in self.tasks}
        for tid in reversed(order):
            for d in self._dependents.get(tid, ()):
                reach[tid].add(d)
                reach[tid] |= reach[d]
        return reach

    def critical_path(self) -> Tuple[float, List[int]]:
        """Longest cost-weighted path — the lower bound on parallel makespan."""
        order = self.toposort()
        best: Dict[int, float] = {}
        pred: Dict[int, Optional[int]] = {}
        for tid in order:
            deps = self._dependencies.get(tid, ())
            if deps:
                p = max(deps, key=lambda d: best[d])
                best[tid] = best[p] + self.tasks[tid].cost
                pred[tid] = p
            else:
                best[tid] = self.tasks[tid].cost
                pred[tid] = None
        end = max(best, key=lambda t: best[t])
        path = []
        cur: Optional[int] = end
        while cur is not None:
            path.append(cur)
            cur = pred[cur]
        return best[end], list(reversed(path))

    # -------------------------------------------------- cell-graph projection
    def cell_graph(self) -> Tuple[Dict[int, float], Dict[Tuple[int, int], float]]:
        """Project the task graph onto its resources (SWIFT §3.2).

        Returns ``(node_weights, edge_weights)`` where nodes are resource ids.
        A task touching one resource adds its cost to that node; a task
        touching two resources adds its cost to the edge between them (and
        half to each node, so node weights estimate per-cell work). Tasks
        touching >2 resources contribute cost to every pairwise edge scaled
        by 1/npairs (hyperedge approximation — in SWIFT each task references
        at most two cells so the graph is a plain cell graph).
        """
        nodes: Dict[int, float] = collections.defaultdict(float)
        edges: Dict[Tuple[int, int], float] = collections.defaultdict(float)
        for t in self.tasks.values():
            res = sorted(set(t.resources))
            if not res:
                continue
            if len(res) == 1:
                nodes[res[0]] += t.cost
                continue
            share = t.cost / len(res)
            for r in res:
                nodes[r] += share
            npairs = len(res) * (len(res) - 1) // 2
            for i in range(len(res)):
                for j in range(i + 1, len(res)):
                    edges[(res[i], res[j])] += t.cost / npairs
        return dict(nodes), dict(edges)

    # ------------------------------------------------------------- validation
    def validate_schedule(self, waves: Sequence[Sequence[int]]) -> None:
        """Check a wave schedule: every task exactly once; dependencies in
        strictly earlier waves; no intra-wave conflicts."""
        seen: Dict[int, int] = {}
        for w, wave in enumerate(waves):
            for tid in wave:
                self._check(tid)
                if tid in seen:
                    raise TaskGraphError(f"task {tid} scheduled twice")
                seen[tid] = w
        if len(seen) != len(self.tasks):
            missing = set(self.tasks) - set(seen)
            raise TaskGraphError(f"tasks never scheduled: {sorted(missing)[:8]}…")
        for tid, w in seen.items():
            for dep in self._dependencies.get(tid, ()):
                if seen[dep] >= w:
                    raise TaskGraphError(
                        f"task {tid} (wave {w}) depends on {dep} "
                        f"(wave {seen[dep]})")
        for w, wave in enumerate(waves):
            wset = set(wave)
            for tid in wave:
                bad = wset & self._conflicts.get(tid, set())
                bad.discard(tid)
                if bad:
                    raise TaskGraphError(
                        f"wave {w}: conflicting tasks {tid} and {sorted(bad)}")
