"""Flight recorder (port of ``repro.observability.flight``): last-K-cycles
metric ring + post-mortem dump bundles.

A crashed run is diagnosed from what the runtime logged *before* it died;
here that is a ring buffer of the last ``K`` cycles' telemetry rows (the
``(counts, values)`` host rows the engines adopt once a cycle) plus a
compact state fingerprint per cycle.

On any health-sentinel trip (NaN / Inf / non-positive density / energy
drift) the observer writes a post-mortem bundle::

    <out>/flight-cycle00012-nan/
        manifest.json       # reason, cycle, schema, ring span
        metrics.jsonl       # one record per ring entry (named columns)
        fingerprints.json   # per-cycle per-rank state fingerprints
        trace.json          # Chrome-trace slice covering the ring window

``validate_bundle`` checks a bundle's shape; ``python -m
repro_torch.observability dump`` produces and validates one end to end.
The bundle layout and ``FLIGHT_SCHEMA`` are the reference's, so its
``validate_bundle`` accepts the port's bundles.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import device_metrics as dm
from .sinks import chrome_trace, jsonify, validate_chrome_trace

FLIGHT_SCHEMA = 2
_BUNDLE_FILES = ("manifest.json", "metrics.jsonl", "fingerprints.json",
                 "trace.json")
DEFAULT_RING = 8


class FlightRecorder:
    """Ring of the last ``k`` cycles' metric rows, dump-on-trip."""

    def __init__(self, k: int = DEFAULT_RING):
        self.k = max(int(k), 1)
        self._ring = deque(maxlen=self.k)   # (cycle, counts, values)
        self.dumps: List[str] = []          # bundle dirs written so far

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def cycles(self) -> List[int]:
        return [c for c, _, _ in self._ring]

    def record(self, cycle: int, counts, values) -> None:
        """Append one cycle's accumulated row."""
        self._ring.append((int(cycle), counts, values))

    def rows(self) -> List[Dict[str, object]]:
        """Pull the ring to host: one summarised record per entry."""
        out = []
        for cycle, counts, values in self._ring:
            rec = dm.summarize(np.asarray(counts), np.asarray(values))
            rec["cycle"] = cycle
            out.append(rec)
        return out

    # -------------------------------------------------------------- dumping
    def dump(self, out_dir: str, *, reason: str, cycle: int,
             spans: Sequence = (), row_names: Optional[Dict] = None,
             extra: Optional[Dict[str, object]] = None) -> str:
        """Write one post-mortem bundle; returns the bundle directory."""
        tag = "".join(ch if ch.isalnum() else "-" for ch in reason) or "trip"
        path = os.path.join(out_dir, f"flight-cycle{int(cycle):05d}-{tag}")
        os.makedirs(path, exist_ok=True)

        rows = self.rows()
        with open(os.path.join(path, "metrics.jsonl"), "w") as f:
            for rec in rows:
                f.write(json.dumps(jsonify(rec)) + "\n")

        prints = [{"cycle": c, "ranks": dm.fingerprint(np.asarray(v))}
                  for c, _, v in self._ring]
        with open(os.path.join(path, "fingerprints.json"), "w") as f:
            json.dump(jsonify(prints), f, indent=1)

        trace = chrome_trace(list(spans), row_names=row_names)
        with open(os.path.join(path, "trace.json"), "w") as f:
            json.dump(trace, f)

        manifest = {
            "schema": FLIGHT_SCHEMA,
            "reason": str(reason),
            "cycle": int(cycle),
            "ring_cycles": self.cycles,
            "ring_size": self.k,
            "created_unix": time.time(),
            "records": len(rows),
            "spans": len(trace.get("traceEvents", [])),
        }
        if extra:
            manifest.update(jsonify(dict(extra)))
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        self.dumps.append(path)
        return path


def read_bundle(path: str) -> Dict[str, object]:
    """Load a bundle back (manifest + records + fingerprints + trace)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(path, "fingerprints.json")) as f:
        prints = json.load(f)
    with open(os.path.join(path, "trace.json")) as f:
        trace = json.load(f)
    return {"manifest": manifest, "records": records,
            "fingerprints": prints, "trace": trace}


def validate_bundle(path: str) -> Dict[str, object]:
    """Assert a dump bundle is well-formed; returns its manifest.

    Checks: all four files present and parseable, manifest carries the
    schema/reason/cycle keys, every metrics record has the named-column
    layout, the trip cycle is inside the recorded ring span, and the
    trace slice passes the Chrome-trace schema validator.
    """
    for fname in _BUNDLE_FILES:
        if not os.path.isfile(os.path.join(path, fname)):
            raise ValueError(f"flight bundle {path!r} missing {fname}")
    bundle = read_bundle(path)
    manifest = bundle["manifest"]
    for key in ("schema", "reason", "cycle", "ring_cycles", "records"):
        if key not in manifest:
            raise ValueError(f"flight manifest missing {key!r}")
    if manifest["schema"] != FLIGHT_SCHEMA:
        raise ValueError(f"flight schema {manifest['schema']} != "
                         f"{FLIGHT_SCHEMA}")
    records = bundle["records"]
    if len(records) != manifest["records"]:
        raise ValueError("manifest record count disagrees with metrics.jsonl")
    for rec in records:
        for key in ("cycle", "count_columns", "value_columns", "counts",
                    "values", "flags", "per_rank_work"):
            if key not in rec:
                raise ValueError(f"flight record missing {key!r}")
        if rec["count_columns"] != list(dm.COUNT_COLUMNS):
            raise ValueError("flight record count-column layout mismatch")
    ring = manifest["ring_cycles"]
    if ring and not (min(ring) <= manifest["cycle"] <= max(ring) + 1):
        raise ValueError(f"trip cycle {manifest['cycle']} outside ring "
                         f"span {ring}")
    errors = validate_chrome_trace(bundle["trace"])
    if errors:
        raise ValueError(f"flight trace slice invalid: {errors[:3]}")
    return manifest
