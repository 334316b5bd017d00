"""Observability for the port (SWIFT §4): task-timeline tracing + unified
metrics, the reference's ``repro.observability`` over the port's engines.

SWIFT's engineering loop is *instrument every task, read the task plot*:
per-core tic/toc timestamps rendered as one row per core, one slice per
task, from which load imbalance, dead time and communication stalls are
read off directly (arXiv:1606.02738 §4).

* :mod:`~repro_torch.observability.tracer` — the span tracer; its fence
  synchronises the CUDA device, so device work is attributed to the phase
  that launched it; free when disabled.
* :mod:`~repro_torch.observability.metrics` — counters/gauges registry
  absorbing the engines' ledgers.
* :mod:`~repro_torch.observability.sinks` — Chrome-trace JSON export (the
  task plot) + per-cycle JSONL metrics log (schema v3), with the minimal
  schema validator.
* :mod:`~repro_torch.observability.observer` — the per-run merge point
  wired in by ``SimulationSpec(observe=True)``; feeds measured task costs
  back into :class:`~repro_torch.core.cost_model.CostModel`.
* :mod:`~repro_torch.observability.device_metrics` — the per-rank
  telemetry rows the engines adopt once a cycle.
* :mod:`~repro_torch.observability.flight` — last-K-cycles flight recorder
  + post-mortem dump bundles, written on any health-sentinel trip.
* :mod:`~repro_torch.observability.costs` — the cost ledger and the
  repartition advisor.

``python -m repro_torch.observability`` runs one traced time-bin ×
distributed Sedov run and exports + validates ``trace.json`` /
``metrics.jsonl``; ``dump`` produces and validates a flight-recorder bundle;
``advise`` renders the cost-attribution table and the advisor's trend.
"""

from .costs import RepartitionAdvisor, TaskCostLedger, weighted_imbalance
from .device_metrics import (CELL_COLUMNS, COUNT_COLUMNS, VALUE_COLUMNS,
                             DEVICE_METRICS_VERSION)
from .flight import FlightRecorder, read_bundle, validate_bundle
from .metrics import METRICS_SCHEMA_VERSION, MetricsRegistry
from .observer import ObserveSpec, RunObserver, UMBRELLA_SPANS
from .sinks import (chrome_trace, jsonify, read_metrics_jsonl,
                    upgrade_record, validate_chrome_trace,
                    write_chrome_trace, write_metrics_jsonl)
from .tracer import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "METRICS_SCHEMA_VERSION", "MetricsRegistry",
    "CELL_COLUMNS", "COUNT_COLUMNS", "VALUE_COLUMNS",
    "DEVICE_METRICS_VERSION",
    "RepartitionAdvisor", "TaskCostLedger", "weighted_imbalance",
    "FlightRecorder", "read_bundle", "validate_bundle",
    "ObserveSpec", "RunObserver", "UMBRELLA_SPANS",
    "chrome_trace", "jsonify", "read_metrics_jsonl", "upgrade_record",
    "validate_chrome_trace", "write_chrome_trace", "write_metrics_jsonl",
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
]
