"""Task cost model: analytic first, measured after (SWIFT §3.2).

    "The cost of each task is initially approximated via the asymptotic cost
    of the task type and the number of particles involved. After a task has
    been executed, its effective computational cost is computed and used."

Two clients:

* the SPH engine — per-task-type asymptotic costs in "interactions" units,
  refined by an exponential moving average of measured per-type rates;
* the LM stack — per-layer analytic FLOPs/bytes, refined by
  ``compiled.cost_analysis()`` from the dry-run (see ``analysis/roofline.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


# Asymptotic per-type cost exponents for SPH tasks: a self task over a cell of
# N particles does ~N^2/2 pair checks; a pair task over (N, M) does ~N*M.
_SPH_ASYMPTOTIC: Dict[str, Callable[..., float]] = {
    "sort": lambda n, m=0: n * max(math.log2(max(n, 2)), 1.0),
    "density_self": lambda n, m=0: 0.5 * n * n,
    "density_pair": lambda n, m: n * m,
    "ghost": lambda n, m=0: n,
    "force_self": lambda n, m=0: 0.5 * n * n,
    "force_pair": lambda n, m: n * m,
    "kick": lambda n, m=0: n,
    "send": lambda n, m=0: n,
    "recv": lambda n, m=0: n,
}


def timebin_frequency(bin_idx: int, max_bin: int) -> float:
    """Fraction of the finest sub-steps on which bin ``bin_idx`` is active.

    Bin b steps with dt = dt_max / 2**b, so over one dt_max cycle of
    2**max_bin sub-steps it is integrated 2**b times: frequency 2**(b−d).
    """
    return 2.0 ** (min(int(bin_idx), int(max_bin)) - int(max_bin))


def cell_activation_frequency(occ_by_bin, max_bin: int) -> float:
    """Fraction of sub-steps on which a cell has *anything* due.

    A cell wakes whenever its deepest-bin (smallest-dt) particle does, so
    the frequency is that of the highest occupied bin; an empty cell never
    wakes.
    """
    occupied = [b for b, o in enumerate(occ_by_bin) if o > 0]
    if not occupied:
        return 0.0
    return timebin_frequency(max(occupied), max_bin)


@dataclass
class CostModel:
    """Per-task-type cost = rate[type] * asymptotic(type, sizes).

    ``update`` folds in a measured execution time with an EMA — the paper's
    measured-cost refinement. Rates are in seconds per asymptotic unit.
    ``timebin_units`` is the time-averaged variant used when particles sit
    in a hierarchy of time bins (see ``sph/timebins.py``).
    """

    rates: Dict[str, float] = field(default_factory=dict)
    ema: float = 0.3
    default_rate: float = 1e-9
    asymptotic: Dict[str, Callable[..., float]] = field(
        default_factory=lambda: dict(_SPH_ASYMPTOTIC))
    # measured-cost ledger fed by the observability layer: per task kind,
    # [seconds, units, calls] accumulated over the run, plus the rate each
    # kind carried *before* its first measurement (the modelled baseline
    # the measured-vs-modelled report compares against)
    observed: Dict[str, list] = field(default_factory=dict)
    modelled_baseline: Dict[str, float] = field(default_factory=dict)

    def units(self, kind: str, n: int, m: int = 0) -> float:
        fn = self.asymptotic.get(kind)
        if fn is None:
            return float(max(n, 1))
        return float(fn(n, m))

    def cost(self, kind: str, n: int, m: int = 0) -> float:
        return self.rates.get(kind, self.default_rate) * self.units(kind, n, m)

    # --------------------------------------------------- time-bin weighting
    def timebin_units(self, kind: str, occ_by_bin, occ_by_bin_j=None, *,
                      max_bin: Optional[int] = None) -> float:
        """Time-averaged cost units of a task under the bin hierarchy.

        ``occ_by_bin`` is the per-bin occupancy histogram of the task's cell
        (bin b holds particles stepped with dt_max/2**b, so bin b is active
        a fraction 2**(b - max_bin) of the finest sub-steps). Per-particle
        tasks (ghost/kick/sort) cost the *sum over bins of occupancy scaled
        by each bin's activity fraction* — every particle pays at its own
        cadence. Interaction tasks (density/force, self and pair) evaluate
        the full block whenever the cell — for pairs: either cell — has
        anything due, so they pay the full asymptotic cost at the *cell's*
        activation frequency. This is the per-task weight that makes the
        domain decomposition balance what actually runs, extending the
        paper's "work, not data" principle along the time axis.
        """
        occ = [float(x) for x in occ_by_bin]
        d = int(max_bin) if max_bin is not None else max(len(occ) - 1, 0)
        n_tot = int(sum(occ))
        if kind in ("send", "recv"):
            # activity-aware halos: the whole cell buffer ships whenever the
            # cell has *anything* due (and only then), so communication
            # tasks pay the full message cost at the cell's activation
            # frequency — not per-particle cadence (the buffer is shipped
            # as one message either way).
            return (cell_activation_frequency(occ, d)
                    * self.units(kind, n_tot))
        if kind in ("sort", "ghost", "kick"):
            # linear-ish per-particle work: each bin pays at its cadence
            n_eff = sum(o * timebin_frequency(b, d) for b, o in enumerate(occ))
            return self.units(kind, n_tot) * n_eff / max(n_tot, 1)
        freq = cell_activation_frequency(occ, d)
        if occ_by_bin_j is not None:
            occ_j = [float(x) for x in occ_by_bin_j]
            freq = max(freq, cell_activation_frequency(occ_j, d))
            return freq * self.units(kind, n_tot, int(sum(occ_j)))
        return freq * self.units(kind, n_tot)

    def update(self, kind: str, n: int, m: int, measured_seconds: float) -> None:
        u = self.units(kind, n, m)
        if u <= 0 or measured_seconds <= 0:
            return
        rate = measured_seconds / u
        old = self.rates.get(kind)
        self.rates[kind] = rate if old is None else (
            (1 - self.ema) * old + self.ema * rate)

    # ----------------------------------------------- measured-cost feedback
    def observe(self, kind: str, units: float, seconds: float) -> None:
        """Fold one measured task execution into the model (paper §3.2:
        "after a task has been executed, its effective computational cost
        is computed and used").

        Unlike :meth:`update`, the caller supplies the work units directly
        (live pair count, shipped slots — whatever the span measured), so
        task kinds the asymptotic table doesn't know about still refine.
        The rate each kind carried before its first observation is
        snapshotted as the modelled baseline for
        :meth:`measured_vs_modelled`.
        """
        if units <= 0 or seconds <= 0:
            return
        if kind not in self.modelled_baseline:
            self.modelled_baseline[kind] = self.rates.get(kind,
                                                          self.default_rate)
        acc = self.observed.setdefault(kind, [0.0, 0.0, 0])
        acc[0] += float(seconds)
        acc[1] += float(units)
        acc[2] += 1
        rate = seconds / units
        old = self.rates.get(kind)
        self.rates[kind] = rate if old is None else (
            (1 - self.ema) * old + self.ema * rate)

    def observed_units(self, kind: str) -> float:
        """Total measured work units folded in for ``kind`` (0 if never
        observed)."""
        acc = self.observed.get(kind)
        return acc[1] if acc else 0.0

    def observed_seconds(self, kind: str) -> float:
        acc = self.observed.get(kind)
        return acc[0] if acc else 0.0

    def observed_rate(self, kind: str) -> Optional[float]:
        """Mean measured seconds-per-unit over the whole run (not the
        EMA-refined ``rates`` entry)."""
        acc = self.observed.get(kind)
        if not acc or acc[1] <= 0:
            return None
        return acc[0] / acc[1]

    def measured_vs_modelled(self) -> Dict[str, float]:
        """Per-kind ratio of the mean measured rate to the rate the model
        assumed before any measurement. 1.0 = the analytic model was
        right; ≫1 = the task is more expensive per unit than modelled
        (the decomposition under-weights it)."""
        out = {}
        for kind, acc in self.observed.items():
            if acc[1] <= 0:
                continue
            base = self.modelled_baseline.get(kind, self.default_rate)
            out[kind] = (acc[0] / acc[1]) / base if base > 0 else float("inf")
        return out

    def calibrate(self, samples) -> Dict[str, Dict[str, float]]:
        """Fit one seconds-per-unit coefficient per task kind from joint
        (units-by-kind, seconds) samples — the online refinement of the
        paper's measured-cost feedback when the run is fully fused and
        only aggregate walls exist.

        ``samples`` is a sequence of ``(units: Dict[str, float],
        seconds: float)`` pairs, one per cycle. A non-negative
        least-squares fit (lstsq with clamping) recovers each kind's
        rate; the fit's R² is reported as a shared confidence and each
        positively-fitted rate is EMA-folded into :attr:`rates`. Kinds
        whose unit columns are collinear across samples (e.g. density
        and force when every live pair runs both) split the joint rate
        between them — the *sum* of their costs is still right, which is
        what the decomposition weights need. Returns ``{kind: {"rate",
        "confidence"}}`` (empty if under-determined)."""
        import numpy as _np
        samples = [(dict(u), float(s)) for u, s in samples
                   if s > 0 and any(v > 0 for v in u.values())]
        kinds = sorted({k for u, _ in samples for k in u if u[k] > 0})
        if not kinds or len(samples) < 1:
            return {}
        A = _np.array([[float(u.get(k, 0.0)) for k in kinds]
                       for u, _ in samples], dtype=_np.float64)
        b = _np.array([s for _, s in samples], dtype=_np.float64)
        coef, *_ = _np.linalg.lstsq(A, b, rcond=None)
        coef = _np.clip(coef, 0.0, None)
        pred = A @ coef
        ss_res = float(((b - pred) ** 2).sum())
        ss_tot = float(((b - b.mean()) ** 2).sum())
        r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else (
            1.0 if ss_res < 1e-18 else 0.0)
        confidence = float(max(0.0, min(1.0, r2)))
        out: Dict[str, Dict[str, float]] = {}
        for k, c in zip(kinds, coef):
            c = float(c)
            out[k] = {"rate": c, "confidence": confidence}
            if c > 0:
                if k not in self.modelled_baseline:
                    self.modelled_baseline[k] = self.rates.get(
                        k, self.default_rate)
                old = self.rates.get(k)
                self.rates[k] = c if old is None else (
                    (1 - self.ema) * old + self.ema * c)
        return out


# --------------------------------------------------------------- LM analytic
@dataclass(frozen=True)
class LayerCost:
    flops: float
    param_bytes: float
    act_bytes: float

    @property
    def total_bytes(self) -> float:
        return self.param_bytes + self.act_bytes


def attention_cost(*, batch: int, q_len: int, kv_len: int, d_model: int,
                   n_heads: int, n_kv: int, head_dim: int,
                   dtype_bytes: int = 2, causal: bool = True,
                   window: Optional[int] = None) -> LayerCost:
    """Analytic attention FLOPs/bytes (projections + scores + output)."""
    d_q = n_heads * head_dim
    d_kv = n_kv * head_dim
    proj = 2 * batch * q_len * d_model * (d_q + 2 * d_kv)      # qkv
    proj += 2 * batch * q_len * d_q * d_model                  # out proj
    kv_eff = kv_len
    if window is not None:
        kv_eff = min(kv_len, window)
    score_frac = 0.5 if (causal and q_len == kv_len and window is None) else 1.0
    scores = 2 * batch * n_heads * q_len * kv_eff * head_dim * 2 * score_frac
    params = (d_model * (d_q + 2 * d_kv) + d_q * d_model) * dtype_bytes
    acts = batch * q_len * (d_model + d_q + 2 * d_kv) * dtype_bytes
    acts += batch * n_heads * q_len * min(kv_eff, 4096) * dtype_bytes  # tile-resident scores
    return LayerCost(proj + scores, float(params), float(acts))


def mlp_cost(*, batch: int, seq: int, d_model: int, d_ff: int,
             gated: bool = True, dtype_bytes: int = 2) -> LayerCost:
    mats = 3 if gated else 2
    flops = 2 * batch * seq * d_model * d_ff * mats
    params = mats * d_model * d_ff * dtype_bytes
    acts = batch * seq * (d_model + d_ff * (2 if gated else 1)) * dtype_bytes
    return LayerCost(float(flops), float(params), float(acts))


def moe_cost(*, batch: int, seq: int, d_model: int, d_ff: int,
             num_experts: int, top_k: int, dtype_bytes: int = 2) -> LayerCost:
    dense = mlp_cost(batch=batch, seq=seq, d_model=d_model, d_ff=d_ff,
                     gated=True, dtype_bytes=dtype_bytes)
    router = 2 * batch * seq * d_model * num_experts
    return LayerCost(dense.flops * top_k + router,
                     dense.param_bytes * num_experts,
                     dense.act_bytes * top_k)


def mamba_cost(*, batch: int, seq: int, d_model: int, d_state: int,
               expand: int = 2, d_conv: int = 4,
               dtype_bytes: int = 2) -> LayerCost:
    d_inner = expand * d_model
    flops = 2 * batch * seq * d_model * d_inner * 2          # in_proj (x, z)
    flops += 2 * batch * seq * d_inner * d_conv              # conv1d
    flops += 6 * batch * seq * d_inner * d_state             # selective scan
    flops += 2 * batch * seq * d_inner * d_model             # out_proj
    params = (d_model * d_inner * 3 + d_inner * d_state * 2) * dtype_bytes
    acts = batch * seq * (d_model + 3 * d_inner) * dtype_bytes
    return LayerCost(float(flops), float(params), float(acts))


def model_flops_6nd(n_params: float, n_tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D for a training step (fwd+bwd)."""
    return 6.0 * n_params * n_tokens


def model_flops_2nd(n_params: float, n_tokens: float) -> float:
    """Inference (fwd only): 2·N·D."""
    return 2.0 * n_params * n_tokens
