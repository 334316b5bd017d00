"""Render SWIFT-style task timelines and per-cycle tables from the port's
observability files (port of the trace mode of ``repro.analysis.report``).

    python -m repro_torch.analysis.report trace.json [--metrics m.jsonl]

renders the Chrome trace exported by a ``SimulationSpec(observe=True)`` run
as a text task plot — one row per rank, one character per time bucket,
dominant task per bucket (the terminal rendition of SWIFT §4's
task-timeline figures) — followed by the per-cycle imbalance/dead-time
table, the measured-vs-modelled task-cost ratios, the per-rank cost
attribution and the repartition advisor's trend from the metrics log. Logs
of schema v1 and v2 render their missing columns as ``-``.

The reference's other mode (no trace: the roofline table of LM training
dry-runs compiled for a TPU mesh) reads the artifacts of
``repro.launch.dryrun``, which the port does not have (out of scope with
the mesh and sharding modules, README), and raises.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

_DRYRUN = ("repro_torch.analysis.report: the dry-run roofline table reads "
           "the artifacts of repro.launch.dryrun (LM training compiled for "
           "a TPU mesh), which is out of scope for the port (README); pass "
           "a trace.json")


# ----------------------------------------------------- task-timeline report
def load_trace(path: str) -> Dict:
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, list):                    # bare event-array flavour
        doc = {"traceEvents": doc}
    return doc


def _task_slices(doc: Dict) -> List[Dict]:
    from ..observability import UMBRELLA_SPANS
    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("name") not in UMBRELLA_SPANS]


def render_timeline(doc: Dict, width: int = 72) -> str:
    """One row per rank, one char per time bucket, dominant task wins.

    The terminal rendition of SWIFT's task plot: load imbalance shows as
    rows going quiet ('.') while others still work; communication-heavy
    stretches show as exchange characters lining up across rows.
    """
    xs = _task_slices(doc)
    if not xs:
        return "(no task slices in trace)"
    t0 = min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in xs)
    span = max(t1 - t0, 1e-9)
    names = sorted({e["name"] for e in xs})
    chars: Dict[str, str] = {}
    used = set()
    for nm in names:
        for ch in (nm[:1].upper() + nm[1:] + "0123456789*#@"):
            ch = ch.upper()
            if ch not in used and not ch.isspace():
                chars[nm] = ch
                used.add(ch)
                break
    rows = sorted({e["tid"] for e in xs})
    # row labels come from the trace's thread_name metadata when present
    # (fleet traces name rows by request_id; rank traces by "rank N")
    row_names = {e.get("tid"): str(e.get("args", {}).get("name"))
                 for e in doc.get("traceEvents", [])
                 if isinstance(e, dict) and e.get("ph") == "M"
                 and e.get("name") == "thread_name"
                 and e.get("args", {}).get("name")}
    label_w = max([8] + [len(v) for v in row_names.values()])
    lines = [f"task timeline: {span / 1e6:.4f} s over {width} buckets "
             f"('.' = dead time)"]
    bw = span / width
    for r in rows:
        cover: List[Dict[str, float]] = [{} for _ in range(width)]
        for e in xs:
            if e["tid"] != r:
                continue
            e0, e1 = e["ts"] - t0, e["ts"] + e["dur"] - t0
            b0 = max(int(e0 / bw), 0)
            b1 = min(int(e1 / bw), width - 1)
            for b in range(b0, b1 + 1):
                ov = max(0.0, min(e1, (b + 1) * bw) - max(e0, b * bw))
                cover[b][e["name"]] = cover[b].get(e["name"], 0.0) + ov
        line = "".join(chars[max(c, key=c.get)] if c else "."
                       for c in cover)
        label = row_names.get(r, f"rank {r:>3}")
        lines.append(f"{label:>{label_w}} |{line}|")
    legend = "  ".join(f"{c}={n}"
                       for n, c in sorted(chars.items(), key=lambda kv: kv[1]))
    lines.append(f"legend: {legend}")
    # dead lanes must be loud: every expired-sweep marker called out by
    # request, not left as a zero-width slice nobody notices
    expired = [e for e in xs if e.get("name") == "expired"]
    if expired:
        lines.append(f"EXPIRED lanes ({len(expired)}):")
        for e in expired:
            a = e.get("args", {})
            who = a.get("request_id", row_names.get(e.get("tid"),
                                                    f"row {e.get('tid')}"))
            lines.append(f"  {who}: deadline={a.get('deadline')} "
                         f"({a.get('error', 'expired before scheduling')})")
    return "\n".join(lines)


def attribution_table(records: List[Dict]) -> str:
    """Per-rank × per-kind cost-attribution table from the last record's
    ``cell_work`` block (schema v3). Pre-v3 logs — upgraded records with
    ``cell_work: None`` — render every column as '-'."""
    if not records:
        return "(no metrics records)"
    from ..observability import upgrade_record
    last = upgrade_record(records[-1])
    cw = last.get("cell_work")
    cols = (cw or {}).get("columns") or ["drift", "density", "force",
                                         "exchange"]
    lines = ["per-rank cost attribution (work units by task kind, "
             "last cycle):",
             f"{'rank':>5} " + " ".join(f"{c:>12}" for c in cols)]
    if not cw:
        lines.append(f"{'-':>5} " + " ".join(f"{'-':>12}" for _ in cols))
        lines.append("(record predates schema v3 — no per-cell "
                     "attribution)")
        return "\n".join(lines)
    for r, row in enumerate(cw["per_rank"]):
        lines.append(f"{r:>5} " + " ".join(f"{v:>12.4g}" for v in row))
    lines.append(f"{'total':>5} "
                 + " ".join(f"{v:>12.4g}" for v in cw["totals"]))
    cal = last.get("cost_calibration")
    if cal and cal.get("kinds"):
        res = cal.get("residual")
        lines += ["", "calibrated per-kind rates (joint fit over "
                      f"{cal.get('nsamples', 0)} cycle samples, relative "
                      "residual "
                      f"{'-' if res is None else format(res, '.3f')}):",
                  f"{'kind':<12} {'rate (s/unit)':>14} {'confidence':>11}"]
        for k in sorted(cal["kinds"]):
            v = cal["kinds"][k]
            lines.append(f"{k:<12} {v['rate']:>14.4g} "
                         f"{v['confidence']:>11.3f}")
    return "\n".join(lines)


def advisor_trend(records: List[Dict]) -> str:
    """Repartition-advisor time-series: measured current vs advised
    imbalance per cycle (schema v3; '-' for records predating it)."""
    if not records:
        return "(no metrics records)"
    from ..observability import upgrade_record
    records = [upgrade_record(r) for r in records]
    lines = ["repartition advisor trend (measured per-rank load "
             "imbalance, max/mean):",
             f"{'cycle':>5} {'current':>9} {'advised':>9} "
             f"{'candidate':>10} {'accepted':>9}"]
    any_adv = False
    for r in records:
        adv = r.get("advisor")
        if adv is None:
            lines.append(f"{r.get('cycle', 0):>5} {'-':>9} {'-':>9} "
                         f"{'-':>10} {'-':>9}")
            continue
        any_adv = True
        lines.append(
            f"{r.get('cycle', 0):>5} "
            f"{adv['current_imbalance']:>9.3f} "
            f"{adv['advised_imbalance']:>9.3f} "
            f"{adv['candidate_imbalance']:>10.3f} "
            f"{'yes' if adv.get('accepted') else 'keep':>9}")
    if not any_adv:
        lines.append("(no advisor records — single rank, device metrics "
                     "off, or pre-v3 log)")
    return "\n".join(lines)


def metrics_summary(records: List[Dict]) -> str:
    """Per-cycle imbalance/dead-time table + measured-vs-modelled costs.

    Accepts schema-v1 through v3 records alike: every record is
    normalised through ``upgrade_record``, so the device-metrics and
    cost-attribution columns render as '-' for logs that predate them."""
    if not records:
        return "(no metrics records)"
    from ..observability import upgrade_record
    records = [upgrade_record(r) for r in records]
    lines = ["per-cycle summary:",
             f"{'cycle':>5} {'wall (s)':>10} {'imbalance':>10} "
             f"{'dev_imb':>8} {'health':>7} "
             f"{'dead_frac':>10} {'updates':>10} {'compiles':>9}"]
    for r in records:
        imb = r.get("imbalance")
        dead = r.get("dead_frac")
        dimb = r.get("device_imbalance")
        health = r.get("health")
        if health is None:
            hcol = "-"
        else:
            hcol = "TRIP" if health.get("tripped") else "ok"
        lines.append(
            f"{r.get('cycle', 0):>5} {r.get('wall', 0.0):>10.4f} "
            f"{'-' if imb is None else format(imb, '.3f'):>10} "
            f"{'-' if dimb is None else format(dimb, '.3f'):>8} "
            f"{hcol:>7} "
            f"{'-' if dead is None else format(dead, '.3f'):>10} "
            f"{r.get('updates', 0):>10} "
            f"{str(r.get('total_compiles', '-')):>9}")
    last = records[-1]
    du = last.get("device_phase_units")
    if du:
        lines += ["", "device-measured work units (last cycle, in-program "
                      "telemetry):",
                  "  " + "  ".join(f"{k}={v:.4g}"
                                   for k, v in sorted(du.items()))]
    dumps = [r["flight_dump"] for r in records if r.get("flight_dump")]
    if dumps:
        lines += ["", "flight-recorder dumps (sentinel trips):"]
        lines += [f"  {d}" for d in dumps]
    ratios = last.get("cost_ratios") or {}
    if ratios:
        units = last.get("observed_units") or {}
        lines += ["",
                  "measured vs modelled task cost (rate ratio; >1 = task "
                  "costlier per unit than the model assumed):",
                  f"{'task kind':<16} {'units':>12} {'ratio':>12}"]
        for k in sorted(ratios):
            lines.append(f"{k:<16} {units.get(k, 0):>12.4g} "
                         f"{ratios[k]:>12.4g}")
    lines += ["", attribution_table(records), "", advisor_trend(records)]
    return "\n".join(lines)


def trace_report(trace_path: str, metrics_path: Optional[str] = None,
                 width: int = 72) -> str:
    doc = load_trace(trace_path)
    parts = [render_timeline(doc, width=width)]
    if metrics_path:
        from ..observability import read_metrics_jsonl
        parts += ["", metrics_summary(read_metrics_jsonl(metrics_path))]
    return "\n".join(parts)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.report")
    ap.add_argument("trace", nargs="?", default=None,
                    help="Chrome-trace JSON from an observe=True run")
    ap.add_argument("--metrics", default=None,
                    help="per-cycle metrics JSONL to summarise under the "
                         "timeline")
    ap.add_argument("--width", type=int, default=72)
    args = ap.parse_args(argv)
    if not args.trace:
        raise NotImplementedError(_DRYRUN)
    print(trace_report(args.trace, args.metrics, width=args.width))


if __name__ == "__main__":
    main()
