"""Communication planning: send/recv task generation and halo-exchange plans.

SWIFT §3.3: for every task that uses data residing on a different rank,
``send``/``recv`` tasks are generated automatically on the source and
destination ranks, and the consumer is made dependent on the ``recv``. This
module does exactly that, given a partitioned task graph, and additionally
compiles the resulting point-to-point pattern into a **halo exchange plan** —
the static, TPU-lowerable form (a sequence of ``lax.ppermute`` rounds over
mesh axes) used by ``sph/distributed.py`` and ``distributed/halo.py``.

Message statistics (count, bytes) reproduce the paper's §5 numbers
(~58 000 point-to-point messages of ~6 kB per node per step on 32 nodes of
SuperMUC) in ``benchmarks/comm_stats.py``.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .taskgraph import TaskGraph


@dataclass
class CommStats:
    messages: int
    total_bytes: float
    per_pair: Dict[Tuple[int, int], int]
    per_pair_bytes: Dict[Tuple[int, int], float]

    @property
    def mean_message_bytes(self) -> float:
        return self.total_bytes / self.messages if self.messages else 0.0


def insert_comm_tasks(graph: TaskGraph, resource_rank: Dict[int, int],
                      resource_bytes: Dict[int, float],
                      phases: Optional[Dict[int, str]] = None,
                      resource_freq: Optional[Dict[int, float]] = None
                      ) -> CommStats:
    """Insert send/recv tasks for every cross-rank (consumer, resource) pair.

    Parameters
    ----------
    graph: task graph whose tasks already carry ``rank`` assignments.
    resource_rank: owner rank of each resource (cell).
    resource_bytes: payload size of each resource.
    phases: optional task-kind -> phase label; data is re-sent once per
        phase that needs it (the paper sends twice per step: positions for
        the density phase, densities for the force phase).
    resource_freq: optional activation frequency of each resource under a
        time-bin hierarchy (``core.cost_model.cell_activation_frequency``).
        Send/recv task costs and message statistics are scaled by it: a
        boundary cell that wakes on 1/8 of the sub-steps ships (and costs)
        1/8 of what an always-active cell does — the activity-aware halo
        accounting of ``sph/dist_timebins.py`` at the task-graph layer.

    The function deduplicates: one send/recv pair per
    (resource, destination rank, phase). Consumers are made dependent on the
    recv; the recv depends on the send; the send depends on all *producer*
    tasks of that resource on the owner rank in an earlier phase (tasks that
    write the resource).

    Returns message statistics.
    """
    tasks = list(graph.tasks.values())
    # producers[resource][phase] = [tid...] writing that resource
    def phase_of(kind: str) -> str:
        return phases.get(kind, kind) if phases is not None else ""

    producers: Dict[Tuple[int, str], List[int]] = collections.defaultdict(list)
    for t in tasks:
        for w in t.writes:
            producers[(w, phase_of(t.kind))].append(t.tid)

    # ordered phases via topological order of first appearance
    phase_order: List[str] = []
    for tid in graph.toposort():
        ph = phase_of(graph.tasks[tid].kind)
        if ph not in phase_order:
            phase_order.append(ph)
    phase_idx = {ph: i for i, ph in enumerate(phase_order)}

    pair_tasks: Dict[Tuple[int, int, str], Tuple[int, int]] = {}
    per_pair: Dict[Tuple[int, int], int] = collections.defaultdict(int)
    per_pair_bytes: Dict[Tuple[int, int], float] = collections.defaultdict(float)
    messages = 0
    total_bytes = 0.0

    for t in tasks:
        if t.kind in ("send", "recv"):
            continue
        for r in t.resources:
            owner = resource_rank.get(r, t.rank)
            if owner == t.rank:
                continue
            key = (r, t.rank, phase_of(t.kind))
            if key not in pair_tasks:
                freq = 1.0
                if resource_freq is not None:
                    freq = float(resource_freq.get(r, 1.0))
                nbytes = resource_bytes.get(r, 0.0) * freq
                send = graph.add_task("send", resources=(r,),
                                      cost=1e-6 * freq, rank=owner,
                                      payload=(t.rank, nbytes))
                recv = graph.add_task("recv", resources=(r,),
                                      cost=1e-6 * freq, rank=t.rank,
                                      payload=(owner, nbytes))
                graph.add_dependency(recv, send)
                # send waits for the freshest producers in strictly earlier
                # phases (data must be ready before it is shipped)
                my_phase = phase_idx[phase_of(t.kind)]
                best_phase = -1
                best: List[int] = []
                for (rr, ph), tids in producers.items():
                    if rr != r or phase_idx.get(ph, -1) >= my_phase:
                        continue
                    if phase_idx[ph] > best_phase:
                        best_phase, best = phase_idx[ph], tids
                for ptid in best:
                    graph.add_dependency(send, ptid)
                pair_tasks[key] = (send, recv)
                messages += 1
                total_bytes += nbytes
                per_pair[(owner, t.rank)] += 1
                per_pair_bytes[(owner, t.rank)] += nbytes
            graph.add_dependency(t.tid, pair_tasks[key][1])

    return CommStats(messages, total_bytes, dict(per_pair),
                     dict(per_pair_bytes))


# ------------------------------------------------------------------ halo plan
@dataclass(frozen=True)
class HaloPlan:
    """Static halo-exchange plan over a 1-D device ring.

    ``offsets`` lists the ring offsets whose neighbour data is needed (e.g.
    (+1, -1) for nearest-neighbour halos). Lowered with ``lax.ppermute`` —
    one round per offset; rounds are independent so XLA may overlap them
    with interior compute (the dependency structure guarantees interior
    work never waits on the halo: SWIFT's "strictly local tasks first").
    """

    axis: str
    offsets: Tuple[int, ...]

    def perms(self, axis_size: int) -> List[List[Tuple[int, int]]]:
        out = []
        for off in self.offsets:
            out.append([(i, (i + off) % axis_size) for i in range(axis_size)])
        return out


def plan_halo_1d(*, axis: str, radius: int = 1) -> HaloPlan:
    offs: List[int] = []
    for r in range(1, radius + 1):
        offs.extend([+r, -r])
    return HaloPlan(axis=axis, offsets=tuple(offs))


def ppermute_rounds(edges, nranks: Optional[int] = None
                    ) -> List[List[Tuple[int, int]]]:
    """Decompose directed rank edges into ``lax.ppermute`` rounds.

    SWIFT's send/recv tasks are point-to-point; the TPU-lowerable image is a
    sequence of *partial permutations* — in each round every rank sends to at
    most one rank and receives from at most one (``ppermute``'s contract).
    Greedy edge colouring over the export edge list: each round grabs a
    maximal set of edges with distinct sources and distinct destinations, so
    all edges are covered in at most 2·Δ − 1 rounds (Δ = max in/out degree).
    For the graph-partitioned cut the degree is the number of neighbouring
    ranks, independent of the total rank count — the neighbour-to-neighbour
    schedule the paper's asynchronous exchange relies on.

    ``edges``: iterable of (src, dst) rank pairs, src ≠ dst. Deduplicated and
    sorted for determinism. Returns a list of rounds, each a list of
    (src, dst) forming a partial permutation.
    """
    remaining = sorted({(int(s), int(d)) for s, d in edges})
    for s, d in remaining:
        if s == d:
            raise ValueError(f"self-edge ({s}, {d}) in export edge list")
        if nranks is not None and not (0 <= s < nranks and 0 <= d < nranks):
            raise ValueError(f"edge ({s}, {d}) outside rank range {nranks}")
    rounds: List[List[Tuple[int, int]]] = []
    while remaining:
        used_src: Set[int] = set()
        used_dst: Set[int] = set()
        rnd: List[Tuple[int, int]] = []
        rest: List[Tuple[int, int]] = []
        for (s, d) in remaining:
            if s in used_src or d in used_dst:
                rest.append((s, d))
            else:
                rnd.append((s, d))
                used_src.add(s)
                used_dst.add(d)
        rounds.append(rnd)
        remaining = rest
    return rounds


def pairwise_stats_from_partition(
        cell_edges: Dict[Tuple[int, int], float],
        assignment: np.ndarray,
        cell_bytes: Sequence[float],
        cell_freq: Optional[Sequence[float]] = None) -> CommStats:
    """Message statistics implied by a cell partition: one message per
    (cut cell, neighbouring rank, phase) with two phases per step (density +
    force), matching the paper's accounting.

    With ``cell_freq`` (per-cell activation frequency under a time-bin
    hierarchy) the counts and bytes become *expected values per finest
    sub-step*: a cut cell ships only on the sub-steps it is active, so its
    messages and bytes are scaled by its frequency — the planning-side
    image of the activity-aware halo exchange.
    """
    per_pair: Dict[Tuple[int, int], float] = collections.defaultdict(float)
    per_pair_bytes: Dict[Tuple[int, int], float] = collections.defaultdict(float)
    seen: Set[Tuple[int, int]] = set()
    for (u, v), _w in cell_edges.items():
        ru, rv = int(assignment[u]), int(assignment[v])
        if ru == rv:
            continue
        for (cell, src, dst) in ((u, ru, rv), (v, rv, ru)):
            if (cell, dst) in seen:
                continue
            seen.add((cell, dst))
            f = 1.0 if cell_freq is None else float(cell_freq[cell])
            per_pair[(src, dst)] += 2 * f                  # density + force
            per_pair_bytes[(src, dst)] += 2 * f * float(cell_bytes[cell])
    messages = sum(per_pair.values())
    total = sum(per_pair_bytes.values())
    return CommStats(messages, total, dict(per_pair), dict(per_pair_bytes))
