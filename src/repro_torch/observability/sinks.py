"""Trace/metrics sinks (port of ``repro.observability.sinks``): Chrome-trace
JSON (the task plot) + per-cycle JSONL.

The Chrome trace event format is the Perfetto-openable analogue of SWIFT's
task plots (arXiv:1606.02738 Figs. 9-11): one row per rank (``tid``), one
complete ("X") slice per phase, with the task attrs (cycle, sub-step,
time-bin level, pair count, …) in ``args``. Open the exported file at
https://ui.perfetto.dev or ``chrome://tracing``.

:func:`validate_chrome_trace` is the minimal schema contract every traced
run is checked against: a ``traceEvents`` list whose "X" events have
numeric ``ts``/non-negative ``dur`` in sorted order, whose "B"/"E" events
match up per (pid, tid), and whose every rank row is named by a
``thread_name`` metadata event.

The JSONL sink writes one self-describing record per cycle (see
``observer.py`` for the record layout), schema version stamped in every
line. Both files are byte-for-byte the reference's format, so the
reference's readers accept them unchanged.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Sequence

import torch

from .tracer import Span

TRACE_PID = 0


def jsonify(obj: Any) -> Any:
    """Best-effort conversion to plain JSON types (tensors on any device,
    numpy scalars/arrays, tuples, sets, dict keys)."""
    if isinstance(obj, torch.Tensor):
        # 0-d → a Python scalar, else nested lists; CUDA tensors via host
        return jsonify(obj.detach().cpu().tolist())
    if isinstance(obj, dict):
        return {str(k): jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, (str, bool)) or obj is None:
        return obj
    if isinstance(obj, (int, float)):
        return obj
    if hasattr(obj, "item"):            # numpy scalar
        try:
            return jsonify(obj.item())
        except Exception:
            pass
    if hasattr(obj, "tolist"):          # numpy array
        try:
            return jsonify(obj.tolist())
        except Exception:
            pass
    return str(obj)


# ------------------------------------------------------------- chrome trace
def chrome_trace(spans: Sequence[Span], t_origin: float = 0.0,
                 process_name: str = "repro",
                 row_names: Dict[int, str] = None) -> Dict[str, Any]:
    """Spans → a Chrome-trace document: per-rank rows, per-phase slices.

    ``ts``/``dur`` are microseconds since ``t_origin`` (the tracer's run
    anchor), so one run's ranks share a timeline in the Perfetto view.
    ``row_names`` overrides the default ``rank {r}`` row labels — the
    fleet serving trace names each row by its ``request_id`` so a
    multi-request timeline reads per user, not per rank.
    """
    ranks = sorted({s.rank for s in spans})
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": TRACE_PID, "tid": 0,
        "args": {"name": process_name}}]
    row_names = row_names or {}
    for r in ranks:
        events.append({"ph": "M", "name": "thread_name", "pid": TRACE_PID,
                       "tid": r,
                       "args": {"name": row_names.get(r, f"rank {r}")}})
        # ranks sort by index, not lexically, in the viewer
        events.append({"ph": "M", "name": "thread_sort_index",
                       "pid": TRACE_PID, "tid": r,
                       "args": {"sort_index": r}})
    slices = [{
        "ph": "X", "name": s.name, "cat": "task", "pid": TRACE_PID,
        "tid": s.rank,
        "ts": (s.t0 - t_origin) * 1e6,
        "dur": max(s.dur, 0.0) * 1e6,
        "args": jsonify(s.attrs or {}),
    } for s in spans]
    slices.sort(key=lambda e: (e["ts"], e["tid"]))
    return {"traceEvents": events + slices, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Sequence[Span],
                       t_origin: float = 0.0,
                       process_name: str = "repro",
                       row_names: Dict[int, str] = None) -> Dict[str, Any]:
    doc = chrome_trace(spans, t_origin, process_name, row_names=row_names)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Minimal schema check; returns a list of violations (empty = valid).

    * ``traceEvents`` is a list of dicts with a ``ph`` field;
    * "X" events carry numeric ``ts`` and ``dur`` ≥ 0, appear in
      non-decreasing ``ts`` order, and their ``(pid, tid)`` row is mapped
      by a ``thread_name`` metadata event;
    * "B"/"E" events nest properly per ``(pid, tid)`` (every E closes a B,
      nothing left open).
    """
    errors: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_rows = set()
    for e in events:
        if isinstance(e, dict) and e.get("ph") == "M" \
                and e.get("name") == "thread_name":
            named_rows.add((e.get("pid"), e.get("tid")))
    last_ts = None
    stacks: Dict[tuple, List[str]] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            errors.append(f"event {i}: not a dict with 'ph'")
            continue
        ph = e["ph"]
        row = (e.get("pid"), e.get("tid"))
        if ph == "X":
            ts, dur = e.get("ts"), e.get("dur")
            if not isinstance(ts, (int, float)):
                errors.append(f"event {i}: X without numeric ts")
                continue
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({e.get('name')}): bad dur {dur}")
            if last_ts is not None and ts < last_ts:
                errors.append(f"event {i} ({e.get('name')}): ts {ts} < "
                              f"previous {last_ts} (unsorted)")
            last_ts = ts
            if row not in named_rows:
                errors.append(f"event {i} ({e.get('name')}): row {row} has "
                              f"no thread_name metadata (rank mapping)")
        elif ph == "B":
            stacks.setdefault(row, []).append(e.get("name", ""))
        elif ph == "E":
            if not stacks.get(row):
                errors.append(f"event {i}: E without matching B on {row}")
            else:
                stacks[row].pop()
    for row, stack in stacks.items():
        if stack:
            errors.append(f"row {row}: unclosed B events {stack}")
    return errors


# -------------------------------------------------------------------- jsonl
def write_metrics_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(jsonify(rec)) + "\n")


def _v1_to_v2(up: Dict[str, Any]) -> None:
    """v2 added the device-metrics block; absent on v1 records."""
    up.setdefault("device_metrics", None)
    up.setdefault("device_phase_units", None)
    up.setdefault("device_imbalance", None)
    up.setdefault("health", None)


def _v2_to_v3(up: Dict[str, Any]) -> None:
    """v3 added per-cell cost attribution / calibration /
    advisor blocks and made the cost-feedback dicts always present."""
    up.setdefault("cell_work", None)
    up.setdefault("cost_calibration", None)
    up.setdefault("advisor", None)
    up.setdefault("cost_ratios", {})
    up.setdefault("observed_units", {})


_UPGRADES = {1: _v1_to_v2, 2: _v2_to_v3}


def upgrade_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Normalise a metrics record to the current schema shape, chaining
    one version step at a time (v1→v2→v3).

    Older records predate newer blocks; readers that branch on them
    (``analysis/report.py``, the flight-bundle tools) call this so any
    supported log renders through the same code path — the added fields
    are explicit "not measured" markers, and the original schema number
    is preserved under ``schema_original``. A record claiming a schema
    *newer* than this build understands is rejected loudly rather than
    mis-rendered.
    """
    from .metrics import METRICS_SCHEMA_VERSION
    ver = int(rec.get("schema", 1))
    if ver > METRICS_SCHEMA_VERSION:
        raise ValueError(
            f"metrics record has schema {ver}, newer than this build's "
            f"{METRICS_SCHEMA_VERSION} — upgrade the reader, not the "
            f"record")
    if ver >= METRICS_SCHEMA_VERSION:
        return rec
    up = dict(rec)
    up["schema_original"] = ver
    while ver < METRICS_SCHEMA_VERSION:
        _UPGRADES[ver](up)
        ver += 1
    up["schema"] = ver
    return up


def read_metrics_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
