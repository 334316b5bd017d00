"""Per-cell task-cost attribution → calibration → repartition advice
(port of ``repro.observability.costs``).

SWIFT refines its domain decomposition with *measured* task costs (§3.2:
"after a task has been executed, its effective computational cost is
computed and used"). The engines attribute their work to cells once a
cycle (``device_cell_work_last``: a per-cell units vector per task kind),
and this module closes the loop on the host:

* :class:`TaskCostLedger` — accumulates per-cycle (units-by-kind, wall
  seconds) samples, keeps the direct per-kind ``CostModel.observe`` stream
  flowing (so ``measured_vs_modelled`` reports from cycle one), and
  periodically runs the joint :meth:`CostModel.calibrate` fit. Its fitted
  rates convert per-cell unit vectors into measured per-cell *weights* —
  the currency the decomposition balances.
* :class:`RepartitionAdvisor` — replays ``decompose_cells`` against the
  measured cell weights each cycle and reports what the imbalance *would
  be* under the advised partition vs the current one. Purely advisory: it
  never moves a cell, it emits the ``advised_imbalance`` ≤
  ``current_imbalance`` time-series into the metrics record.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .device_metrics import CELL_COLUMNS

__all__ = ["TaskCostLedger", "RepartitionAdvisor", "weighted_imbalance"]


def weighted_imbalance(assignment, weights, nranks: int) -> float:
    """max/mean of per-rank load for per-cell ``weights`` under
    ``assignment`` (1.0 = perfectly balanced). Pass ``nranks`` explicitly
    so ranks owning zero cells still count."""
    assignment = np.asarray(assignment, np.int64)
    w = np.asarray(weights, np.float64)
    rank_w = np.zeros(int(nranks))
    np.add.at(rank_w, assignment, w)
    mean = rank_w.mean()
    return float(rank_w.max() / mean) if mean > 0 else 1.0


class TaskCostLedger:
    """Sliding window of measured (units-by-kind, seconds) cycle samples
    feeding :meth:`CostModel.calibrate`.

    ``record`` takes one cycle's aggregate work units (from the per-cell
    vectors' totals) and the wall of the programs that did them (the
    reference's fused sub-step programs; the port's host-residency paths
    time each phase instead and feed ``CostModel.observe`` directly). It
    apportions the wall across kinds by unit share and
    feeds ``CostModel.observe`` — the same information the pre-calibration
    heuristic provided, so ``cost_ratios``/``observed_units`` behave
    identically — then refits the joint per-kind rates over the window.
    """

    def __init__(self, cost_model, *, window: int = 64,
                 refit_every: int = 1, skip_first: int = 1,
                 outlier_factor: float = 8.0):
        self.cm = cost_model
        self.samples: deque = deque(maxlen=int(window))
        self.refit_every = max(int(refit_every), 1)
        # the first cycle's wall carries one-off costs (the kernels' first
        # launches) — feed it to observe() but keep it out of the
        # calibration window, like any benchmark warmup
        self.skip_first = max(int(skip_first), 0)
        # spikes can also land mid-run (a repartition): samples whose
        # wall exceeds ``outlier_factor`` × the window's fastest wall are
        # spikes, not work, and are excluded from the fit the same way
        # the warmup cycle is
        self.outlier_factor = float(outlier_factor)
        self.last_calibration: Dict[str, Dict[str, float]] = {}
        self.last_residual: Optional[float] = None
        self.last_nfit = 0
        self._since_fit = 0
        self._seen = 0

    # ------------------------------------------------------------ feeding
    def record(self, units: Dict[str, float], seconds: float
               ) -> Dict[str, Any]:
        """Fold one cycle's aggregate sample in; returns the current
        calibration block (see :meth:`snapshot`)."""
        units = {k: float(v) for k, v in units.items() if float(v) > 0}
        if seconds > 0 and units:
            tot = sum(units.values())
            if hasattr(self.cm, "observe") and tot > 0:
                for k, u in units.items():
                    self.cm.observe(k, u, seconds * u / tot)
            self._seen += 1
            if self._seen > self.skip_first:
                self.samples.append((units, float(seconds)))
                self._since_fit += 1
                if self._since_fit >= self.refit_every:
                    self.calibrate()
        return self.snapshot()

    def _fit_window(self) -> list:
        """The window minus spikes (walls ≫ the fastest wall)."""
        if not self.samples:
            return []
        floor = min(s for _, s in self.samples)
        cut = self.outlier_factor * floor
        return [(u, s) for u, s in self.samples if s <= cut]

    def calibrate(self) -> Dict[str, Dict[str, float]]:
        """Joint per-kind rate fit over the outlier-filtered sample
        window (needs ≥ 2 surviving samples; keeps the last fit
        otherwise)."""
        self._since_fit = 0
        fit = self._fit_window()
        if len(fit) >= 2 and hasattr(self.cm, "calibrate"):
            cal = self.cm.calibrate(fit)
            if cal:
                self.last_calibration = cal
                self.last_nfit = len(fit)
                self.last_residual = self._residual(cal, fit)
        return self.last_calibration

    def _residual(self, cal: Dict[str, Dict[str, float]],
                  fit: list) -> Optional[float]:
        """Mean relative |predicted − measured| wall over the fit set."""
        rates = {k: v["rate"] for k, v in cal.items()}
        num = den = 0.0
        for u, s in fit:
            pred = sum(rates.get(k, 0.0) * v for k, v in u.items())
            num += abs(pred - s)
            den += abs(s)
        return (num / den) if den > 0 else None

    def snapshot(self) -> Dict[str, Any]:
        """The ``cost_calibration`` block of the metrics record."""
        return {"kinds": {k: dict(v)
                          for k, v in self.last_calibration.items()},
                "residual": self.last_residual,
                "nsamples": self.last_nfit}

    # ------------------------------------------------------------ weights
    def rate(self, kind: str) -> float:
        """Fitted seconds-per-unit for ``kind``; falls back to the cost
        model's EMA rate, then its default."""
        cal = self.last_calibration.get(kind)
        if cal and cal.get("rate", 0.0) > 0:
            return float(cal["rate"])
        return float(self.cm.rates.get(kind, self.cm.default_rate))

    def cell_weights(self, cell_work: Dict[str, Any]) -> np.ndarray:
        """Measured per-cell weight: Σ over kinds of rate·units.

        ``cell_work`` is the engines' ``device_cell_work_last`` dict
        (columns / cells / per_rank). This is the node-weight vector the
        advisor feeds back into ``decompose_cells``."""
        cells = np.asarray(cell_work["cells"], np.float64)
        cols = list(cell_work.get("columns", CELL_COLUMNS))
        w = np.zeros(cells.shape[0], np.float64)
        for i, k in enumerate(cols):
            w += self.rate(k) * cells[:, i]
        return w

    def per_cell_ratio(self, cell_work: Dict[str, Any],
                       modelled: Sequence[float]) -> Dict[str, float]:
        """Distribution of measured/modelled per-cell weight (both
        normalised to unit mass): how far the analytic model's *shape*
        is from the measured one, cell by cell."""
        meas = self.cell_weights(cell_work)
        mod = np.maximum(np.asarray(modelled, np.float64), 1e-300)
        ms, ds = meas.sum(), mod.sum()
        if ms <= 0 or ds <= 0:
            return {"mean": 1.0, "max": 1.0}
        ratio = (meas / ms) / (mod / ds)
        live = ratio[meas > 0]
        if live.size == 0:
            return {"mean": 1.0, "max": 1.0}
        return {"mean": float(live.mean()), "max": float(live.max())}


class RepartitionAdvisor:
    """What-if replay of the graph partitioner against measured weights.

    Holds the task graph built from the *current* grid/pair structure
    (structure changes rarely; weights every cycle). Each ``advise``
    call partitions with the measured per-cell weights as node weights
    and compares per-rank load imbalance under the candidate vs the
    engine's current assignment. ``advised_imbalance`` is
    ``min(candidate, current)`` — the advisor may always *keep* the
    current partition, so its advice is never worse than doing nothing.
    """

    def __init__(self, graph, ncells: int, nranks: int, *, seed: int = 0):
        self.graph = graph
        self.ncells = int(ncells)
        self.nranks = int(nranks)
        self.seed = int(seed)
        node_w, _ = graph.cell_graph()
        mod = np.zeros(self.ncells, np.float64)
        for r, w in node_w.items():
            if r < self.ncells:
                mod[r] = w
        self.modelled_weights = np.maximum(mod, 1e-12)

    def advise(self, assignment, cell_weights) -> Dict[str, Any]:
        """One advisory step. Returns the ``advisor`` block of the
        metrics record plus the candidate ``assignment`` (stripped
        before serialisation)."""
        w = np.maximum(np.asarray(cell_weights, np.float64), 1e-12)
        cur = weighted_imbalance(assignment, w, self.nranks)
        if self.nranks <= 1:
            return {"current_imbalance": cur, "candidate_imbalance": cur,
                    "advised_imbalance": cur, "accepted": False,
                    "assignment": np.asarray(assignment, np.int64)}
        from ..core.decompose import decompose_cells
        dec = decompose_cells(self.graph, self.ncells, self.nranks,
                              seed=self.seed, node_weights=w)
        cand_assign = np.asarray(dec.assignment, np.int64)
        cand = weighted_imbalance(cand_assign, w, self.nranks)
        accepted = cand < cur - 1e-9
        return {"current_imbalance": cur,
                "candidate_imbalance": cand,
                "advised_imbalance": min(cand, cur),
                "accepted": bool(accepted),
                "assignment": cand_assign if accepted
                else np.asarray(assignment, np.int64)}
