"""Port parity: the port's analysis (``repro_torch.analysis``).

* The trace report renders the reference's own test inputs
  (tests/test_observability.py:272-356) exactly as
  ``repro.analysis.report`` does: the task timeline, the per-cycle table
  with measured-vs-modelled ratios, the cost attribution and the advisor
  trend, schema v1 and v2 records with ``-``, and both files through
  ``trace_report`` and its command line.
* The reference's dry-run mode (LM training roofline tables for a TPU
  mesh) raises and names ROADMAP queue 1 item 13.
* The H100 roofline: its constants are the data-sheet peaks
  ``chip_smoke.py``'s kernel bounds use, and its bound is theirs.
"""

import json
import os
import subprocess
import sys

import pytest

import repro.analysis.report as RR
import repro_torch.analysis.report as PR
from repro.observability import Tracer, chrome_trace, write_metrics_jsonl
from repro_torch.analysis import roofline
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy_doc():
    """The reference's toy trace (tests/test_observability.py:88-97) with
    its clock fixed, so both renderings see the same events."""
    tr = Tracer(t_origin=0.0)
    for r in (0, 1):
        tr.record("density", r, 0.1 * r, 0.1 * r + 0.3, units=8)
        tr.record("force", r, 0.1 * r + 0.3, 0.1 * r + 0.5)
    tr.record_all(range(2), "exchange1", 0.6, 0.7, collective=1)
    tr.record("cycle", 0, 0.0, 0.8)
    return chrome_trace(tr.spans)


RECORDS = [{"cycle": 0, "wall": 0.5, "imbalance": 1.25,
            "dead_frac": 0.1, "updates": 216, "total_compiles": 3},
           {"cycle": 1, "wall": 0.4, "imbalance": None,
            "dead_frac": None, "updates": 216,
            "cost_ratios": {"density": 1.5},
            "observed_units": {"density": 4000.0}}]
OLD = [{"schema": 1, "cycle": 0, "wall": 0.5},
       {"schema": 2, "cycle": 1, "wall": 0.4, "device_imbalance": 1.1}]
V3 = [{"schema": 3, "cycle": 0, "wall": 0.3, "imbalance": 1.1,
       "device_imbalance": 1.2, "health": {"tripped": True,
                                           "flags": {}},
       "device_phase_units": {"density": 10.0, "force": 12.0},
       "flight_dump": "flight-dumps/flight-cycle00000-nan",
       "cell_work": {"columns": ["drift", "density", "force", "exchange"],
                     "per_rank": [[1.0, 2.0, 3.0, 4.0],
                                  [5.0, 6.0, 7.0, 8.0]],
                     "totals": [6.0, 8.0, 10.0, 12.0], "ncells": 8},
       "cost_calibration": {"kinds": {"density": {"rate": 2e-6,
                                                  "confidence": 0.9}},
                            "residual": 0.05, "nsamples": 4},
       "advisor": {"current_imbalance": 1.4, "advised_imbalance": 1.1,
                   "candidate_imbalance": 1.1, "accepted": True},
       "cost_ratios": {}, "observed_units": {}}]


@pytest.mark.parametrize("width", [40, 72])
def test_timeline_renders_like_reference(width):
    doc = _toy_doc()
    text = PR.render_timeline(doc, width=width)
    assert text == RR.render_timeline(doc, width=width)
    assert "rank 0 |" in text and "D=density" in text
    assert PR.render_timeline({"traceEvents": []}) \
        == RR.render_timeline({"traceEvents": []})


@pytest.mark.parametrize("records", [RECORDS, OLD, V3, []],
                         ids=["v1-ratios", "v1-v2", "v3", "empty"])
def test_tables_render_like_reference(records):
    for fn in ("metrics_summary", "attribution_table", "advisor_trend"):
        assert getattr(PR, fn)(records) == getattr(RR, fn)(records), fn
    if records is OLD:
        assert "predates schema v3" in PR.attribution_table(records)
        assert "no advisor records" in PR.advisor_trend(records)
    if records is RECORDS:
        table = PR.metrics_summary(records)
        assert "1.250" in table and "measured vs modelled" in table


def test_trace_report_and_command_line_like_reference(tmp_path):
    trace_path = tmp_path / "trace.json"
    trace_path.write_text(json.dumps(_toy_doc()))
    metrics_path = tmp_path / "metrics.jsonl"
    write_metrics_jsonl(str(metrics_path), RECORDS + V3)
    out = PR.trace_report(str(trace_path), str(metrics_path), width=40)
    assert out == RR.trace_report(str(trace_path), str(metrics_path),
                                  width=40)
    assert "task timeline" in out and "per-cycle summary" in out
    # a bare event array is a trace too
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(_toy_doc()["traceEvents"]))
    assert PR.trace_report(str(bare)) == RR.trace_report(str(bare))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.report",
         str(trace_path), "--metrics", str(metrics_path), "--width", "40"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == out + "\n"


def test_dry_run_mode_names_item_13():
    """The dry-run mode reads ``repro.launch.dryrun``'s artifacts, out of
    scope for the port (README): it raises and says so (it cited item 13
    while LM training was unported)."""
    with pytest.raises(NotImplementedError, match="out of scope"):
        PR.main([])


def test_roofline_is_chip_smokes_bound():
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    assert (roofline.HBM_BYTES_PER_S, roofline.PEAK_F32_FLOPS,
            roofline.PEAK_TF32_FLOPS) == (3.35e12, 67e12, 495e12)
    assert C.Roofline is roofline.Roofline
    assert C.PEAK_TF32_FLOPS == roofline.PEAK_TF32_FLOPS
    ops, moved = 1.0e11, 1.0e9
    r = roofline.Roofline(moved, ops)
    assert r.t_memory == moved / 3.35e12 and r.t_compute == ops / 67e12
    assert r.t_bound == max(r.t_memory, r.t_compute)
    assert r.bottleneck == "operations"
    assert roofline.Roofline(1e12, 1.0).bottleneck == "bytes"
    b = C.lm_bound("selective_scan", ops, moved)
    assert b == {"bound_ms": r.t_bound * 1e3, "bound_by": "operations"}
    tc = C.lm_bound("flash_attention", ops, moved)
    assert tc["bound_ms"] == max(moved / 3.35e12, 3 * ops / 495e12) * 1e3
    assert tc["bound_by"] == "operations (3×TF32)"
    assert tc["fma_bound_ms"] == r.t_bound * 1e3
