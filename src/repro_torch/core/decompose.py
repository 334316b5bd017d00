"""Domain-decomposition driver: cells → ranks via the task graph (SWIFT §3.2).

Pipeline (exactly the paper's):

1. build the SPH task graph for the current cell grid (``sph/engine.py``),
2. project it onto the cell graph (``TaskGraph.cell_graph``) with
   cost-weighted edges,
3. partition with the multilevel partitioner (``core/partition.py``),
4. insert send/recv tasks for the cut (``core/comm_planner.py``),
5. re-decompose every ``repartition_every`` steps with *measured* costs.

The same driver serves the LM stack: ``decompose_layers`` partitions a layer
task graph into pipeline stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .comm_planner import CommStats, insert_comm_tasks, pairwise_stats_from_partition
from .cost_model import CostModel
from .partition import Graph, PartitionResult, evaluate, partition_graph
from .taskgraph import TaskGraph


@dataclass
class Decomposition:
    assignment: np.ndarray            # cell -> rank
    partition: PartitionResult
    comm: Optional[CommStats] = None

    @property
    def nranks(self) -> int:
        return self.partition.nparts


def timebin_node_weights(occupancy_by_bin: np.ndarray) -> np.ndarray:
    """Per-cell time-averaged work: Σ_b occ[c, b] · 2**(b − max_bin).

    ``occupancy_by_bin`` is (ncells, nbins) with bin b holding particles
    stepped at dt_max/2**b. A bin-b particle is integrated on a fraction
    2**(b − d) of the finest sub-steps, so this weight measures updates
    actually performed per sub-step — the quantity the partitioner must
    balance under hierarchical time-stepping (the paper's "work, not data"
    extended along the time axis).
    """
    occ = np.asarray(occupancy_by_bin, dtype=np.float64)
    if occ.ndim != 2:
        raise ValueError("occupancy_by_bin must be (ncells, nbins)")
    d = occ.shape[1] - 1
    freq = 2.0 ** (np.arange(occ.shape[1]) - d)
    return occ @ freq


def rank_bin_occupancy(assignment: np.ndarray,
                       occupancy_by_bin: np.ndarray,
                       nranks: Optional[int] = None) -> np.ndarray:
    """(nranks, nbins) per-rank time-bin occupancy under a partition.

    Pass ``nranks`` explicitly when ranks may own zero cells — inferring
    it from ``assignment.max()`` makes empty ranks invisible.
    """
    assignment = np.asarray(assignment, dtype=np.int64)
    occ = np.asarray(occupancy_by_bin, dtype=np.int64)
    if nranks is None:
        nranks = int(assignment.max()) + 1 if assignment.size else 1
    out = np.zeros((nranks, occ.shape[1]), dtype=np.int64)
    np.add.at(out, assignment, occ)
    return out


def bin_occupancy_imbalance(assignment: np.ndarray,
                            occupancy_by_bin: np.ndarray,
                            nranks: Optional[int] = None) -> float:
    """max/mean ratio of per-rank *time-averaged active work*.

    The repartition trigger for the distributed time-bin engine: a rank's
    load is Σ over its cells of ``timebin_node_weights`` — updates actually
    performed per finest sub-step — so a rank that inherited the deep
    (short-step) bins shows up here long before raw particle counts drift.
    Returns 1.0 for a perfectly balanced partition. Pass ``nranks``
    explicitly when ranks may own zero cells — a starved rank inferred
    away from ``assignment.max()`` would masquerade as perfect balance,
    the one condition the trigger must fire on.
    """
    assignment = np.asarray(assignment, dtype=np.int64)
    if nranks is None:
        nranks = int(assignment.max()) + 1 if assignment.size else 1
    w = timebin_node_weights(occupancy_by_bin)
    rank_w = np.zeros(nranks)
    np.add.at(rank_w, assignment, w)
    mean = rank_w.mean()
    if mean <= 0:
        return 1.0
    return float(rank_w.max() / mean)


def decompose_cells(graph: TaskGraph, num_cells: int, nranks: int, *,
                    seed: int = 0, max_imbalance: float = 1.05,
                    cell_bytes: Optional[Sequence[float]] = None,
                    node_weights: Optional[Sequence[float]] = None,
                    occupancy_by_bin: Optional[np.ndarray] = None
                    ) -> Decomposition:
    """Partition the computation (not just the data): SWIFT §3.2.

    ``node_weights`` overrides the cell weights projected from the task
    graph — used with :func:`timebin_node_weights` to balance the
    *time-averaged* active work when particles carry per-particle
    time-steps (a graph built with ``time_average=True`` already carries
    these weights in its task costs, in which case no override is needed).

    ``occupancy_by_bin`` (ncells, nbins) is the convenience form of the
    same: per-cell time-bin occupancy histograms, converted internally via
    :func:`timebin_node_weights`. This is the input the distributed
    time-bin engine's repartition trigger feeds (see
    :func:`bin_occupancy_imbalance`); explicit ``node_weights`` wins if
    both are given.
    """
    node_w, edge_w = graph.cell_graph()
    vw = np.zeros(num_cells)
    for r, w in node_w.items():
        if r < num_cells:
            vw[r] = w
    if node_weights is None and occupancy_by_bin is not None:
        node_weights = timebin_node_weights(occupancy_by_bin)
    if node_weights is not None:
        vw = np.asarray(node_weights, dtype=np.float64).copy()
        if len(vw) != num_cells:
            raise ValueError(
                f"node_weights has {len(vw)} entries for {num_cells} cells")
    vw = np.maximum(vw, 1e-12)      # empty cells still need a home
    edges = {(u, v): w for (u, v), w in edge_w.items()
             if u < num_cells and v < num_cells}
    g = Graph.from_edges(num_cells, edges, vw)
    part = partition_graph(g, nranks, seed=seed, max_imbalance=max_imbalance)
    comm = None
    if cell_bytes is not None:
        comm = pairwise_stats_from_partition(edges, part.assignment, cell_bytes)
    return Decomposition(part.assignment, part, comm)


def assign_tasks(graph: TaskGraph, assignment: np.ndarray) -> TaskGraph:
    """Return a new graph with each task pinned to a rank.

    Single-cell tasks go to the owner rank. Pair tasks spanning two ranks are
    *duplicated* on both ranks (the paper's Fig. 2: green tasks along the cut
    are executed on both partitions) — here realised as one task per side,
    each reading the remote cell via a recv dependency.
    """
    out = TaskGraph()
    id_map: Dict[int, List[int]] = {}
    for t in graph.tasks.values():
        ranks = sorted({int(assignment[r]) for r in t.resources}) or [0]
        new_ids = []
        for rk in ranks:
            nid = out.add_task(t.kind, resources=t.resources, writes=t.writes,
                               cost=t.cost, rank=rk, payload=t.payload)
            new_ids.append(nid)
        id_map[t.tid] = new_ids
    for t in graph.tasks.values():
        for dep in graph.dependencies(t.tid):
            for a in id_map[t.tid]:
                for b in id_map[dep]:
                    out.add_dependency(a, b)
    for t in graph.tasks.values():
        for c in graph.conflicts(t.tid):
            for a in id_map[t.tid]:
                for b in id_map.get(c, ()):  # conflicts only matter same-rank
                    if a != b and out.tasks[a].rank == out.tasks[b].rank:
                        out.add_conflict(a, b)
    return out


def decompose_with_comm(graph: TaskGraph, num_cells: int, nranks: int, *,
                        cell_bytes: Sequence[float],
                        phases: Optional[Dict[str, str]] = None,
                        seed: int = 0) -> Tuple[TaskGraph, Decomposition]:
    """Full §3.2+§3.3 pipeline → (distributed task graph, decomposition)."""
    dec = decompose_cells(graph, num_cells, nranks, seed=seed,
                          cell_bytes=cell_bytes)
    dist = assign_tasks(graph, dec.assignment)
    resource_rank = {c: int(dec.assignment[c]) for c in range(num_cells)}
    resource_bytes = {c: float(cell_bytes[c]) for c in range(num_cells)}
    comm = insert_comm_tasks(dist, resource_rank, resource_bytes,
                             phases={k: v for k, v in (phases or {}).items()})
    dec.comm = comm
    return dist, dec


# ----------------------------------------------------------- LM: layer→stage
def decompose_layers(layer_costs: Sequence[float], num_stages: int, *,
                     act_bytes: float = 1.0,
                     contiguous: bool = True) -> np.ndarray:
    """Partition a layer chain into pipeline stages.

    For a chain graph the optimal contiguous partition is found by DP
    (minimise max stage cost); the graph partitioner is overkill there but
    non-contiguous assignment is allowed with ``contiguous=False`` where it
    uses the multilevel partitioner on the chain + skip edges.
    Returns layer -> stage.
    """
    n = len(layer_costs)
    costs = np.asarray(layer_costs, dtype=np.float64)
    if num_stages >= n:
        return np.arange(n) % max(num_stages, 1)
    if contiguous:
        # DP over prefix sums: minimise the maximum stage sum.
        prefix = np.concatenate([[0.0], np.cumsum(costs)])
        INF = float("inf")
        dp = np.full((num_stages + 1, n + 1), INF)
        cut = np.zeros((num_stages + 1, n + 1), dtype=np.int64)
        dp[0, 0] = 0.0
        for s in range(1, num_stages + 1):
            for i in range(1, n + 1):
                for j in range(s - 1, i):
                    cand = max(dp[s - 1, j], prefix[i] - prefix[j])
                    if cand < dp[s, i]:
                        dp[s, i] = cand
                        cut[s, i] = j
        stages = np.zeros(n, dtype=np.int64)
        i = n
        for s in range(num_stages, 0, -1):
            j = cut[s, i]
            stages[j:i] = s - 1
            i = j
        return stages
    edges = {(i, i + 1): act_bytes for i in range(n - 1)}
    g = Graph.from_edges(n, edges, costs)
    res = partition_graph(g, num_stages, seed=0)
    return res.assignment
