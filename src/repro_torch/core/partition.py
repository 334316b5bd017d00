"""Multilevel k-way graph partitioner (SWIFT §3.2's METIS role).

METIS is not available in this environment, so the same algorithm family
[Karypis & Kumar, SIAM J. Sci. Comput. 20(1), 1998] is implemented from
scratch:

1. **Coarsening** — heavy-edge matching (HEM): repeatedly collapse the
   heaviest incident edge of each unmatched vertex until the graph is small.
2. **Initial partitioning** — greedy graph growing on the coarsest graph
   (k-way; BFS region growth from pseudo-peripheral seeds, balanced by node
   weight), with an LPT fallback for disconnected graphs.
3. **Uncoarsening + refinement** — project the partition back up, at every
   level running boundary Fiduccia–Mattheyses (FM) refinement: greedy
   max-gain moves with a balance constraint and hill-climbing rollback.

The objective follows the paper: minimise the **maximum per-partition work**
(node weight plus edge weight of cut edges, which are "computed twice" —
Fig. 2), with edge-cut reported alongside. Deterministic given the input.

Graphs are plain ``numpy`` CSR arrays; no external dependencies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Graph:
    """Undirected weighted graph in CSR form.

    ``xadj[i]:xadj[i+1]`` indexes ``adjncy``/``adjwgt`` for vertex ``i``.
    Every edge appears twice (both directions) with equal weight.
    """

    xadj: np.ndarray      # (n+1,) int64
    adjncy: np.ndarray    # (m,)   int64
    adjwgt: np.ndarray    # (m,)   float64
    vwgt: np.ndarray      # (n,)   float64

    @property
    def n(self) -> int:
        return len(self.vwgt)

    def degree(self, v: int) -> int:
        return int(self.xadj[v + 1] - self.xadj[v])

    def neighbors(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.xadj[v], self.xadj[v + 1]
        return self.adjncy[s:e], self.adjwgt[s:e]

    @staticmethod
    def from_edges(num_nodes: int,
                   edges: Dict[Tuple[int, int], float],
                   node_weights: Optional[Sequence[float]] = None) -> "Graph":
        """Build from an ``{(u,v): w}`` dict (u != v; duplicates summed)."""
        acc: Dict[Tuple[int, int], float] = {}
        for (u, v), w in edges.items():
            if u == v:
                continue
            key = (min(u, v), max(u, v))
            acc[key] = acc.get(key, 0.0) + float(w)
        deg = np.zeros(num_nodes, dtype=np.int64)
        for (u, v) in acc:
            deg[u] += 1
            deg[v] += 1
        xadj = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(deg, out=xadj[1:])
        adjncy = np.zeros(xadj[-1], dtype=np.int64)
        adjwgt = np.zeros(xadj[-1], dtype=np.float64)
        fill = xadj[:-1].copy()
        for (u, v), w in acc.items():
            adjncy[fill[u]] = v
            adjwgt[fill[u]] = w
            fill[u] += 1
            adjncy[fill[v]] = u
            adjwgt[fill[v]] = w
            fill[v] += 1
        vwgt = (np.ones(num_nodes) if node_weights is None
                else np.asarray(node_weights, dtype=np.float64))
        if len(vwgt) != num_nodes:
            raise ValueError("node_weights length mismatch")
        return Graph(xadj, adjncy, adjwgt, vwgt)


@dataclass
class PartitionResult:
    assignment: np.ndarray         # (n,) int: vertex -> part
    nparts: int
    edge_cut: float                # total weight of cut edges
    part_loads: np.ndarray         # node weight + cut-edge weight per part
    imbalance: float               # max load / mean load

    def summary(self) -> str:
        return (f"parts={self.nparts} cut={self.edge_cut:.3g} "
                f"imbalance={self.imbalance:.3f} "
                f"max_load={self.part_loads.max():.3g}")


# ----------------------------------------------------------------- metrics
def evaluate(g: Graph, part: np.ndarray, nparts: int) -> PartitionResult:
    """Edge cut and per-partition *work* loads (paper's Fig. 2 cost model:
    cut tasks are executed on both sides)."""
    loads = np.zeros(nparts, dtype=np.float64)
    np.add.at(loads, part, g.vwgt)
    cut = 0.0
    for u in range(g.n):
        s, e = g.xadj[u], g.xadj[u + 1]
        nbr = g.adjncy[s:e]
        w = g.adjwgt[s:e]
        mask = part[nbr] != part[u]
        if mask.any():
            wcut = w[mask]
            cut += wcut.sum()            # counted once per direction; halved below
            loads[part[u]] += wcut.sum() # duplicated work lands on this side too
    cut *= 0.5
    mean = loads.mean() if nparts else 0.0
    imbalance = float(loads.max() / mean) if mean > 0 else 1.0
    return PartitionResult(part.copy(), nparts, float(cut), loads, imbalance)


# --------------------------------------------------------------- coarsening
def _heavy_edge_matching(g: Graph, rng: np.random.Generator) -> np.ndarray:
    """Return match[v] = partner (or v itself). Visit order randomised by
    ``rng`` but resulting coarse graph is deterministic for a fixed seed."""
    match = np.full(g.n, -1, dtype=np.int64)
    order = rng.permutation(g.n)
    for v in order:
        if match[v] != -1:
            continue
        nbr, w = g.neighbors(v)
        best, best_w = -1, -1.0
        for u, wu in zip(nbr, w):
            if match[u] == -1 and u != v and wu > best_w:
                best, best_w = int(u), float(wu)
        if best >= 0:
            match[v] = best
            match[best] = v
        else:
            match[v] = v
    return match


def _coarsen(g: Graph, rng: np.random.Generator) -> Tuple[Graph, np.ndarray]:
    """One coarsening level. Returns (coarse graph, fine->coarse map)."""
    match = _heavy_edge_matching(g, rng)
    cmap = np.full(g.n, -1, dtype=np.int64)
    nc = 0
    for v in range(g.n):
        if cmap[v] != -1:
            continue
        u = match[v]
        cmap[v] = nc
        if u != v:
            cmap[u] = nc
        nc += 1
    cvwgt = np.zeros(nc, dtype=np.float64)
    np.add.at(cvwgt, cmap, g.vwgt)
    edges: Dict[Tuple[int, int], float] = {}
    for v in range(g.n):
        cv = cmap[v]
        s, e = g.xadj[v], g.xadj[v + 1]
        for u, w in zip(g.adjncy[s:e], g.adjwgt[s:e]):
            cu = cmap[u]
            if cu == cv:
                continue
            key = (min(cv, cu), max(cv, cu))
            edges[key] = edges.get(key, 0.0) + float(w)
    # each undirected edge visited twice above -> halve
    for k in edges:
        edges[k] *= 0.5
    coarse = Graph.from_edges(nc, edges, cvwgt)
    return coarse, cmap


# ------------------------------------------------------ initial partitioning
def _greedy_growth(g: Graph, nparts: int,
                   rng: np.random.Generator) -> np.ndarray:
    """K-way greedy graph growing, balanced by node weight."""
    target = g.vwgt.sum() / nparts
    part = np.full(g.n, -1, dtype=np.int64)
    loads = np.zeros(nparts)
    unassigned = set(range(g.n))
    order = sorted(unassigned, key=lambda v: -g.vwgt[v])
    for p in range(nparts):
        if not unassigned:
            break
        # seed: heaviest unassigned vertex
        seed = next(v for v in order if part[v] == -1)
        frontier = [seed]
        while frontier and loads[p] < target:
            # pick the frontier vertex with max connectivity into part p
            v = frontier.pop(0)
            if part[v] != -1:
                continue
            part[v] = p
            loads[p] += g.vwgt[v]
            unassigned.discard(v)
            nbr, w = g.neighbors(v)
            cand = [int(u) for u in nbr[np.argsort(-w)] if part[u] == -1]
            frontier.extend(cand)
    # leftovers: LPT into lightest part
    for v in sorted(unassigned, key=lambda v: -g.vwgt[v]):
        p = int(np.argmin(loads))
        part[v] = p
        loads[p] += g.vwgt[v]
    return part


# ---------------------------------------------------------------- refinement
def _fm_refine(g: Graph, part: np.ndarray, nparts: int, *,
               max_imbalance: float, passes: int = 8) -> np.ndarray:
    """Boundary FM: greedy max-gain single-vertex moves with rollback.

    Gain of moving v from a to b = (edge weight to b) − (edge weight to a),
    i.e. the edge-cut reduction. Moves violating the balance bound are
    skipped. Each pass moves each vertex at most once, tracking the best
    prefix (classic FM hill-climbing), then rolls back past it. The boundary
    set is maintained incrementally so a pass costs O(boundary × degree), not
    O(n²).
    """
    part = part.copy()
    total = g.vwgt.sum()
    max_load = max_imbalance * total / nparts
    loads = np.zeros(nparts)
    np.add.at(loads, part, g.vwgt)

    def best_move_for(v: int):
        """(gain, target_part) of the best feasible move for v, or None."""
        nbr, w = g.neighbors(v)
        if len(nbr) == 0:
            return None
        pv = part[v]
        ext: Dict[int, float] = {}
        internal = 0.0
        for u, wu in zip(nbr, w):
            pu = part[u]
            if pu == pv:
                internal += wu
            else:
                ext[pu] = ext.get(pu, 0.0) + wu
        if not ext:
            return None
        best = None
        for pb, wb in ext.items():
            if loads[pb] + g.vwgt[v] > max_load:
                continue
            gain = wb - internal
            if best is None or gain > best[0]:
                best = (gain, pb)
        return best

    for _ in range(passes):
        # initial boundary: vertices with ≥1 cross-part edge
        boundary = set()
        for v in range(g.n):
            nbr, _w = g.neighbors(v)
            if len(nbr) and (part[nbr] != part[v]).any():
                boundary.add(v)
        moved = np.zeros(g.n, dtype=bool)
        history: List[Tuple[int, int, int, float]] = []  # v, from, to, gain
        cum = 0.0
        best_cum, best_len = 0.0, 0
        improved = False
        max_moves = max(64, g.n // 2)
        for _step in range(max_moves):
            best_move = None
            best_gain = -np.inf
            for v in boundary:
                if moved[v]:
                    continue
                cand = best_move_for(v)
                if cand is None:
                    continue
                gain, pb = cand
                if gain > best_gain:
                    best_gain = gain
                    best_move = (v, int(part[v]), pb)
            if best_move is None:
                break
            v, pa, pb = best_move
            part[v] = pb
            loads[pa] -= g.vwgt[v]
            loads[pb] += g.vwgt[v]
            moved[v] = True
            cum += best_gain
            history.append((v, pa, pb, best_gain))
            if cum > best_cum + 1e-12:
                best_cum, best_len = cum, len(history)
                improved = True
            # moved vertex and its neighbours may enter/leave the boundary
            boundary.add(v)
            nbr, _w = g.neighbors(v)
            boundary.update(int(u) for u in nbr)
            if best_gain <= 0 and len(history) - best_len > 16:
                break  # plateau: stop exploring
        # rollback past the best prefix
        for (v, pa, pb, _) in reversed(history[best_len:]):
            part[v] = pa
            loads[pb] -= g.vwgt[v]
            loads[pa] += g.vwgt[v]
        if not improved:
            break
    return part


# ------------------------------------------------------------ balance repair
def _work_loads(g: Graph, part: np.ndarray, nparts: int) -> np.ndarray:
    """Per-part *work* = node weight + cut-edge weight (the paper's Fig. 2
    objective: cut tasks execute on both sides)."""
    loads = np.zeros(nparts)
    np.add.at(loads, part, g.vwgt)
    for u in range(g.n):
        s, e = g.xadj[u], g.xadj[u + 1]
        nbr = g.adjncy[s:e]
        w = g.adjwgt[s:e]
        cutw = w[part[nbr] != part[u]].sum()
        loads[part[u]] += cutw
    return loads


def _balance_repair(g: Graph, part: np.ndarray, nparts: int, *,
                    max_imbalance: float, max_moves: int = 400
                    ) -> np.ndarray:
    """Greedy repair on the *work* metric: repeatedly move the best boundary
    vertex off the max-work part, accepting only moves that reduce the
    maximum work (the paper's slowest-rank objective)."""
    part = part.copy()
    loads = _work_loads(g, part, nparts)
    for _ in range(max_moves):
        over = int(np.argmax(loads))
        mean = loads.sum() / nparts
        if loads[over] <= max(max_imbalance * mean, loads.mean() + 1e-12):
            break
        cands = np.nonzero(part == over)[0]
        best = None
        cur_max = loads[over]
        for v in cands:
            nbr, w = g.neighbors(v)
            ext: Dict[int, float] = {}
            internal = 0.0
            for u, wu in zip(nbr, w):
                if part[u] == over:
                    internal += wu
                else:
                    ext[int(part[u])] = ext.get(int(part[u]), 0.0) + wu
            targets = set(ext) | ({int(np.argmin(loads))} if not ext
                                  else set())
            for pb in targets:
                if pb == over:
                    continue
                # work deltas: vertex weight moves; its cut edges flip roles
                d_over = -(g.vwgt[v] + ext.get(pb, 0.0))     # loses v + cut→pb
                d_over += 0.0
                d_pb = g.vwgt[v] + internal                  # gains v + new cut
                new_over = loads[over] + d_over + internal - internal
                new_pb = loads[pb] + d_pb - ext.get(pb, 0.0)
                new_max_pair = max(new_over, new_pb)
                if new_max_pair >= cur_max - 1e-12:
                    continue
                key = -new_max_pair
                if best is None or key > best[0]:
                    best = (key, v, pb)
        if best is None:
            break
        _, v, pb = best
        part[v] = pb
        loads = _work_loads(g, part, nparts)     # exact recompute (safe)
    return part


# ------------------------------------------------------------------- driver
def partition_graph(g: Graph, nparts: int, *, seed: int = 0,
                    max_imbalance: float = 1.05,
                    coarsen_to: int = 64,
                    refine_passes: int = 8) -> PartitionResult:
    """Multilevel k-way partition. Deterministic for fixed ``seed``."""
    if nparts <= 0:
        raise ValueError("nparts must be positive")
    if nparts == 1 or g.n <= 1:
        return evaluate(g, np.zeros(g.n, dtype=np.int64), max(nparts, 1))
    if nparts >= g.n:
        # one vertex per part (extra parts stay empty)
        return evaluate(g, np.arange(g.n, dtype=np.int64) % nparts, nparts)

    rng = np.random.default_rng(seed)
    levels: List[Tuple[Graph, np.ndarray]] = []   # (fine graph, fine->coarse)
    cur = g
    while cur.n > max(coarsen_to, 4 * nparts):
        coarse, cmap = _coarsen(cur, rng)
        if coarse.n >= cur.n * 0.95:   # matching stalled (e.g. star graphs)
            break
        levels.append((cur, cmap))
        cur = coarse

    part = _greedy_growth(cur, nparts, rng)
    part = _fm_refine(cur, part, nparts, max_imbalance=max_imbalance,
                      passes=refine_passes)

    for fine, cmap in reversed(levels):
        part = part[cmap]              # project to fine level
        part = _fm_refine(fine, part, nparts, max_imbalance=max_imbalance,
                          passes=refine_passes)
    part = _balance_repair(g, part, nparts, max_imbalance=max_imbalance)
    return evaluate(g, part, nparts)


# ------------------------------------------------------------ baselines
def partition_geometric(positions: np.ndarray, nparts: int,
                        weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Recursive coordinate bisection — the 'traditional' geometric baseline
    the paper contrasts with (slab/grid cuts)."""
    n = len(positions)
    w = np.ones(n) if weights is None else weights
    out = np.zeros(n, dtype=np.int64)

    def rec(idx: np.ndarray, parts: int, base: int):
        if parts == 1 or len(idx) == 0:
            out[idx] = base
            return
        left_parts = parts // 2
        frac = left_parts / parts
        spans = positions[idx].max(axis=0) - positions[idx].min(axis=0)
        axis = int(np.argmax(spans))
        order = idx[np.argsort(positions[idx, axis], kind="stable")]
        cw = np.cumsum(w[order])
        split = int(np.searchsorted(cw, cw[-1] * frac))
        split = max(1, min(len(order) - 1, split))
        rec(order[:split], left_parts, base)
        rec(order[split:], parts - left_parts, base + left_parts)

    rec(np.arange(n), nparts, 0)
    return out
