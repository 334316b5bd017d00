"""Unified metrics registry (port of ``repro.observability.metrics``).

The engines measure in several ledgers — ``TransferProbe`` (host↔device
bytes by field), ``CompileProbe`` (distinct program signatures), the
bucket policies' grow/shrink events, the halo export counters of
``sph/dist_timebins.py``. The :class:`MetricsRegistry` absorbs them behind
two primitives:

* **counters** — monotonically non-decreasing totals. ``count(name,
  total)`` adopts a ledger's cumulative value; ``inc(name, delta)``
  accumulates directly.
* **gauges** — point-in-time values (per-cycle load imbalance, dead-time
  fraction, bin-occupancy imbalance).

``snapshot()`` returns a plain-JSON view; the per-cycle JSONL sink writes
one snapshot-bearing record per cycle (see ``observer.py``). The schema
version is the reference's, stamped into every record, so the two
packages' logs are read by the same readers.
"""

from __future__ import annotations

from typing import Dict

# bump when metric record field names / meanings change
# v1: phase aggregates + verbatim engine ledgers
# v2: adds the device-metrics block pulled from inside the
#     phase programs — ``device_metrics`` (named per-rank
#     counts/values columns), ``device_phase_units``,
#     ``device_imbalance``, ``health`` (sentinel flags + energy drift),
#     and ``flight_dump`` on a sentinel trip. v1 readers that ignore
#     unknown fields keep working; ``analysis/report.py`` upgrades v1
#     records on read (``upgrade_record``).
# v3: per-cell cost attribution — ``cell_work`` (per-rank /
#     total work units by task kind, attributed per owned cell and
#     folded on the host), ``cost_calibration``
#     (the TaskCostLedger's jointly-fitted per-kind rates + confidence
#     + window residual), ``advisor`` (repartition advisor's
#     current/candidate/advised imbalance + accepted flag), and
#     ``cost_ratios``/``observed_units`` now always present (empty dict
#     before any observation). ``upgrade_record`` chains v1→v2→v3.
METRICS_SCHEMA_VERSION = 3


class MetricsRegistry:
    """Counters + gauges with a JSON-safe snapshot."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}

    # ------------------------------------------------------------- counters
    def inc(self, name: str, delta: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    def count(self, name: str, total: float) -> None:
        """Adopt a ledger's cumulative total. Counters never go backwards —
        a regressing source (a probe reset mid-run) keeps the high-water
        mark rather than corrupting the monotonicity contract."""
        self.counters[name] = max(self.counters.get(name, 0), total)

    # --------------------------------------------------------------- gauges
    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges)}
