"""Recursive cell splitting (paper §3.1).

    "These initial interaction tasks are then refined by recursively
    splitting cells that contain more than a certain number of particles
    and replacing tasks that span a pair of split cells with tasks spanning
    the neighbouring sub-cells."

Clustered ICs put thousands of particles in a handful of cells; without
splitting, a single cell's O(occ²) self-task exceeds the per-rank budget
and no partition can balance it (observed directly in
``benchmarks/partition_quality.py``). This module builds the *refined* cell
graph: cells over ``threshold`` particles are split into 8 children (with
their true sub-occupancies, recursively up to ``max_levels``), and pair
tasks are re-derived between spatially adjacent leaves of mixed levels.

The output is the (node_weights, edges, meta) cost graph the domain
decomposition partitions — granularity restored exactly the way SWIFT
does it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class LeafCell:
    level: int                 # 0 = base grid
    idx: Tuple[int, int, int]  # grid index at that level
    occupancy: int

    def bounds(self, box: float, base_side: int):
        side = base_side * (2 ** self.level)
        size = box / side
        lo = np.array(self.idx, dtype=np.float64) * size
        return lo, lo + size


def _touching(a: LeafCell, b: LeafCell, box: float, base_side: int) -> bool:
    """Periodic box-touch test (face/edge/corner adjacency)."""
    lo_a, hi_a = a.bounds(box, base_side)
    lo_b, hi_b = b.bounds(box, base_side)
    eps = 1e-9 * box
    for d in range(3):
        direct = max(0.0, max(lo_a[d], lo_b[d]) - min(hi_a[d], hi_b[d]))
        wrapped = max(0.0, (box - max(hi_a[d], hi_b[d])) + min(lo_a[d],
                                                               lo_b[d]))
        if min(direct, wrapped) > eps:
            return False
    return True


def split_cells(pos: np.ndarray, box: float, base_side: int, *,
                threshold: int = 64, max_levels: int = 3
                ) -> List[LeafCell]:
    """Recursively split overloaded cells; returns the leaf set."""
    pos = np.mod(np.asarray(pos, dtype=np.float64), box)

    def occupancy_at(level: int) -> Dict[Tuple[int, int, int], int]:
        side = base_side * (2 ** level)
        idx = np.clip((pos / box * side).astype(np.int64), 0, side - 1)
        out: Dict[Tuple[int, int, int], int] = {}
        for i in map(tuple, idx):
            out[i] = out.get(i, 0) + 1
        return out

    occ_by_level = [occupancy_at(l) for l in range(max_levels + 1)]
    leaves: List[LeafCell] = []

    def recurse(level: int, idx: Tuple[int, int, int]):
        occ = occ_by_level[level].get(idx, 0)
        if occ > threshold and level < max_levels:
            i, j, k = idx
            for di in (0, 1):
                for dj in (0, 1):
                    for dk in (0, 1):
                        child = (2 * i + di, 2 * j + dj, 2 * k + dk)
                        if occ_by_level[level + 1].get(child, 0) > 0:
                            recurse(level + 1, child)
            return
        leaves.append(LeafCell(level, idx, occ))

    for i in range(base_side):
        for j in range(base_side):
            for k in range(base_side):
                recurse(0, (i, j, k))
    return leaves


def refined_cell_graph(pos: np.ndarray, box: float, base_side: int, *,
                       threshold: int = 64, max_levels: int = 3,
                       n_ngb: float = 48.0, include_empty: bool = False
                       ) -> Tuple[np.ndarray, Dict[Tuple[int, int], float],
                                  List[LeafCell]]:
    """(node_weights, edge_weights, leaves) of the refined task graph.

    Cost model matches *adaptive* SPH: each particle interacts with
    ≈ ``n_ngb`` neighbours regardless of local density (h shrinks where it
    is dense), so a task over occupancies (a, b) costs
    min(a·b, n_ngb·min(a, b)) interactions — never the naive a·b, which
    would overweight dense cells the smoothing length has already shrunk
    away from. Two phases (density + force) per step.
    """
    leaves = [l for l in split_cells(pos, box, base_side,
                                     threshold=threshold,
                                     max_levels=max_levels)
              if include_empty or l.occupancy > 0]
    n = len(leaves)

    def self_cost(occ: float) -> float:
        return min(0.5 * occ * occ, n_ngb * occ)

    def pair_cost(a: float, b: float) -> float:
        return min(a * b, n_ngb * min(a, b))

    node_w = np.array([2.0 * self_cost(l.occupancy) + 3.0 * l.occupancy
                       for l in leaves], dtype=np.float64)
    edges: Dict[Tuple[int, int], float] = {}
    for a in range(n):
        for b in range(a + 1, n):
            if leaves[a].occupancy == 0 or leaves[b].occupancy == 0:
                continue
            if _touching(leaves[a], leaves[b], box, base_side):
                edges[(a, b)] = 2.0 * pair_cost(leaves[a].occupancy,
                                                leaves[b].occupancy)
    return node_w, edges, leaves
