"""Port parity: the port's observability (``repro_torch.observability``)
against the reference's ``repro.observability``.

* **Sinks:** the same spans give the reference's Chrome trace, as JSON;
  the validator flags the reference's tampering cases with the reference's
  messages; ``upgrade_record`` gives the reference's v1→v3 and v2→v3
  records and refuses a newer schema; ``jsonify`` turns tensors (0-d,
  CUDA) into what it makes of the same numpy values.
* **Telemetry digests:** ``summarize``, ``fingerprint``, ``phase_units``,
  ``fold_cell_rows``, ``cell_work_record`` and ``combine`` equal the
  reference's on seeded rows, exactly.
* **Costs:** ``TaskCostLedger`` and ``CostModel.calibrate`` fit the
  reference's rates (rtol 1e-12, both numpy); ``RepartitionAdvisor`` gives
  the reference's assignment and imbalances on the clustered scenario.
* **Records, per quadrant:** ``observe=True`` at Sedov 6³ (the reference's
  conformance physics, ``dt=0.004``) in all four quadrants, distributed
  with 1 and 4 ranks (the time-bin one against the reference's
  ``residency="host"``; the global one at 4 ranks against a reference
  subprocess with four host devices): equal key sets; discrete fields
  exact; float fields within rtol 1e-5, momentum sums within 1e-4 of the
  state's momentum scale (they are cancellations); wall-derived fields
  (walls, busy times, imbalance, dead time, cost ratios, the advisor's
  wall-weighted imbalances) excluded.
* **Invisibility:** traced runs are bit for bit untraced ones on the local
  ladder and on the time-bin × distributed quadrant over both wires, with
  equal ``CompileProbe`` counts.
* **End to end:** the record equals the probes and reads back from JSONL;
  the reference's ``read_metrics_jsonl``, ``validate_bundle`` and report
  read the port's files unchanged; the NaN sentinel trips and writes a
  valid bundle; the CLI's three modes exit 0 on the CPU and
  ``--residency device`` runs the fused sub-steps and passes the same
  checks. (On the card:
  ``tests/test_torch_dist_cuda.py`` and ``chip_smoke.py`` phases 5c, 6f.)
* ``sph/adaptive.py`` is the reference's source, line for line, and its
  refined cell graph equals the reference's on Sedov 8³.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.observability as RO
import repro.sph as R
import repro_torch.observability as PO
import repro_torch.sph as P
from repro.core.cost_model import CostModel as RCostModel
from repro.observability import device_metrics as rdm
from repro_torch.core.cost_model import CostModel as PCostModel
from repro_torch.observability import device_metrics as pdm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's conformance Sedov (tests/test_conformance.py:47-60) at
# the fixed dt of its observability tests (tests/test_observability.py:138)
SEDOV = dict(scenario="sedov",
             scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
             dt_max=0.02, max_depth=4, dt=0.004)
NCYCLES = 2
RTOL = 1e-5
SCALE_TOL = 1e-4


def _specs(**kw):
    kw = dict(SEDOV, **kw)
    return (R.SimulationSpec(physics=R.SPHConfig(alpha_visc=1.0, cfl=0.15),
                             **kw),
            P.SimulationSpec(physics=P.SPHConfig(alpha_visc=1.0, cfl=0.15),
                             **kw))


# ----------------------------------------------------------------- sinks
def _spans(mod):
    """The same spans for either package: two ranks, attrs with numpy
    scalars, one collective interval on both rows."""
    S = mod.Span
    out = []
    t = 10.0
    for r in (0, 1):
        out.append(S("density", r, t, t + 0.25,
                     {"units": np.int64(8), "cycle": 0, "level": 2}))
        out.append(S("force", r, t + 0.25, t + 0.75, None))
        t += 0.125
    a = {"collective": 1, "units": 4.0}
    out += [S("exchange1", r, 11.0, 11.5, a) for r in (0, 1)]
    return out


def test_chrome_trace_equals_reference():
    for names in (None, {0: "req-a", 1: "req-b"}):
        ref = RO.chrome_trace(_spans(RO), 9.5, "toy", row_names=names)
        port = PO.chrome_trace(_spans(PO), 9.5, "toy", row_names=names)
        assert json.dumps(port) == json.dumps(ref)
        assert PO.validate_chrome_trace(port) == []


def _tamper(doc, how):
    bad = json.loads(json.dumps(doc))
    ev = bad["traceEvents"]
    xs = [e for e in ev if e["ph"] == "X"]
    if how == "negative_dur":
        ev[-1]["dur"] = -1.0
    elif how == "unsorted":
        xs[0]["ts"], xs[-1]["ts"] = xs[-1]["ts"], xs[0]["ts"]
    elif how == "no_rank_names":
        bad["traceEvents"] = [e for e in ev if e.get("name") != "thread_name"]
    elif how == "unmatched_end":
        ev.append({"ph": "E", "pid": 0, "tid": 0})
    elif how == "unclosed_begin":
        ev.append({"ph": "B", "pid": 0, "tid": 1, "name": "open"})
    elif how == "not_a_list":
        bad["traceEvents"] = {}
    elif how == "no_ts":
        xs[0].pop("ts")
    return bad


@pytest.mark.parametrize("how", ["negative_dur", "unsorted",
                                 "no_rank_names", "unmatched_end",
                                 "unclosed_begin", "not_a_list", "no_ts"])
def test_validator_catches_tampering_like_reference(how):
    doc = RO.chrome_trace(_spans(RO))
    bad = _tamper(doc, how)
    errors = PO.validate_chrome_trace(bad)
    assert errors
    assert errors == RO.validate_chrome_trace(bad)


@pytest.mark.parametrize("rec", [
    {"schema": 1, "cycle": 3, "wall": 0.5, "imbalance": 1.2},
    {"schema": 2, "cycle": 7, "device_imbalance": 1.1,
     "health": {"tripped": False}, "cost_ratios": {"density": 1.5}},
    {"cycle": 0},
    {"schema": 3, "cycle": 1, "cell_work": None, "cost_ratios": {}}])
def test_upgrade_record_equals_reference(rec):
    assert PO.upgrade_record(dict(rec)) == RO.upgrade_record(dict(rec))


def test_upgrade_record_refuses_newer_schema():
    for schema in (PO.METRICS_SCHEMA_VERSION + 1, 99):
        with pytest.raises(ValueError, match="newer"):
            PO.upgrade_record({"schema": schema})
    assert PO.METRICS_SCHEMA_VERSION == RO.METRICS_SCHEMA_VERSION == 3


def test_jsonify_tensors_as_reference_does_numpy():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    cases = [(torch.tensor(2.5), np.float32(2.5)),
             (torch.tensor(7), np.int64(7)),
             (torch.tensor(True), np.bool_(True)),
             (torch.from_numpy(a), a),
             ({1: torch.zeros(2, dtype=torch.int32)},
              {1: np.zeros(2, np.int32)})]
    if torch.cuda.is_available():
        cases.append((torch.from_numpy(a).cuda(), a))
    for t, n in cases:
        assert PO.jsonify(t) == RO.jsonify(n)
        assert json.dumps(PO.jsonify(t)) == json.dumps(RO.jsonify(n))


def test_metrics_registry_equals_reference():
    reg = {m: m.MetricsRegistry() for m in (RO, PO)}
    for m, r in reg.items():
        r.count("bytes", 10)
        r.count("bytes", 4)             # never goes backwards
        r.inc("cycles")
        r.inc("cycles", 2)
        r.gauge("imbalance", 1.25)
    assert reg[PO].snapshot() == reg[RO].snapshot()


# ------------------------------------------------------- telemetry digests
def _rows(seed, nranks=3):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 1000, (nranks, pdm.N_COUNTS)).astype(np.int64)
    counts[:, pdm.COUNT_INDEX["flag_nan"]] = [0, 1, 0][:nranks]
    values = rng.uniform(0, 50, (nranks, pdm.N_VALUES))
    values[0, pdm.VALUE_INDEX["min_rho"]] = np.inf
    values[-1, pdm.VALUE_INDEX["max_speed"]] = np.nan
    return counts, values


def test_device_metric_digests_equal_reference():
    assert pdm.COUNT_COLUMNS == rdm.COUNT_COLUMNS
    assert pdm.VALUE_COLUMNS == rdm.VALUE_COLUMNS
    assert pdm.CELL_COLUMNS == rdm.CELL_COLUMNS
    assert pdm.DEVICE_METRICS_VERSION == rdm.DEVICE_METRICS_VERSION
    for seed in range(3):
        counts, values = _rows(seed)
        summary = pdm.summarize(counts, values)
        assert json.dumps(summary) == json.dumps(rdm.summarize(counts,
                                                               values))
        assert pdm.fingerprint(values) == rdm.fingerprint(values)
        assert pdm.phase_units(summary) == rdm.phase_units(summary)
        acc = pdm.zero_rows(3)
        row = _rows(seed + 10)
        for (pc, pv), (rc, rv) in ((pdm.combine(acc, row),
                                    rdm.combine(acc, row)),):
            np.testing.assert_array_equal(pc, rc)
            np.testing.assert_array_equal(pv, rv)
    # all-zero work: no imbalance, like the reference
    z = pdm.zero_rows(2)
    assert pdm.summarize(*z)["imbalance"] is None
    assert pdm.summarize(*z) == rdm.summarize(*z)


def test_cell_work_fold_and_record_equal_reference():
    rng = np.random.default_rng(4)
    K, ncells, nranks = 5, 12, 3
    owned = [np.array([0, 3, 6, 9]), np.array([1, 4, 7, 10, 11]),
             np.array([2, 5, 8])]
    halo = [np.array([1, 2]), np.array([0]), np.array([4, 7, 11])]
    rows = rng.integers(0, 9, (nranks, K + 3, pdm.N_CELL_COLS)) \
        .astype(np.float32)
    got = pdm.fold_cell_rows(rows, owned, halo, ncells, K)
    want = rdm.fold_cell_rows(rows, owned, halo, ncells, K)
    assert got["columns"] == want["columns"]
    np.testing.assert_array_equal(got["cells"], want["cells"])
    np.testing.assert_array_equal(got["per_rank"], want["per_rank"])
    assert pdm.cell_work_record(got) == rdm.cell_work_record(want)
    assert pdm.cell_work_record(None) is rdm.cell_work_record(None) is None


# ------------------------------------------------------------------ costs
def test_cost_calibration_and_ledger_equal_reference():
    rng = np.random.default_rng(0)
    true = {"density": 4e-6, "force": 9e-6, "exchange": 1e-6}
    samples = []
    for _ in range(12):
        units = {k: float(rng.uniform(1e3, 1e5)) for k in true}
        samples.append((units, sum(true[k] * u for k, u in units.items())))
    cal_p = PCostModel(rates={"density": 1e-9}).calibrate(samples)
    cal_r = RCostModel(rates={"density": 1e-9}).calibrate(samples)
    assert sorted(cal_p) == sorted(cal_r)
    for k in cal_r:
        for f in ("rate", "confidence"):
            assert cal_p[k][f] == pytest.approx(cal_r[k][f], rel=1e-12)
        assert cal_p[k]["rate"] == pytest.approx(true[k], rel=1e-6)

    leds = {}
    for mod, cm in ((PO, PCostModel), (RO, RCostModel)):
        led = mod.TaskCostLedger(cm(rates={"density": 1e-9}), skip_first=1)
        led.record({"density": 100.0, "force": 100.0}, 50.0)
        g = np.random.default_rng(1)
        for _ in range(6):
            u = {"density": float(g.uniform(50, 500)),
                 "force": float(g.uniform(50, 500))}
            led.record(u, 4e-6 * u["density"] + 8e-6 * u["force"])
        leds[mod] = led
    sp, sr = leds[PO].snapshot(), leds[RO].snapshot()
    assert sp["nsamples"] == sr["nsamples"] == 6
    assert sp["residual"] == pytest.approx(sr["residual"], rel=1e-12)
    for k in sr["kinds"]:
        assert sp["kinds"][k]["rate"] == pytest.approx(
            sr["kinds"][k]["rate"], rel=1e-12)
    cell_work = {"columns": list(pdm.CELL_COLUMNS),
                 "cells": np.array([[0.0, 10.0, 0.0, 0.0],
                                    [0.0, 0.0, 10.0, 0.0]])}
    np.testing.assert_allclose(leds[PO].cell_weights(cell_work),
                               leds[RO].cell_weights(cell_work), rtol=1e-12)
    assert PO.weighted_imbalance([0, 0], [1.0, 1.0], 4) \
        == RO.weighted_imbalance([0, 0], [1.0, 1.0], 4) == 4.0


def test_advisor_equals_reference_on_clustered():
    """The advisor's replay of the partitioner on the clustered scenario
    (the reference's tests/test_observability.py:430), with seeded
    measured weights: the reference's candidate assignment and
    imbalances."""
    from repro.core import decompose_cells as r_decompose
    from repro.sph.cellgrid import bin_particles as r_bin
    from repro.sph.cellgrid import build_pair_list as r_pairs
    from repro.sph.cellgrid import choose_grid as r_grid
    from repro.sph.engine import build_taskgraph as r_graph
    from repro_torch.sph.cellgrid import (bin_particles, build_pair_list,
                                          choose_grid)
    from repro_torch.sph.engine import build_taskgraph
    ic = P.make_ic("clustered", n=96, seed=0)
    args = (ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"])
    hmax = float(ic["h"].max())
    rs = r_grid(ic["box"], hmax, len(ic["pos"]), capacity_margin=3.0)
    ps = choose_grid(ic["box"], hmax, len(ic["pos"]), capacity_margin=3.0)
    rc, _ = r_bin(rs, *args)
    pc, _ = bin_particles(ps, *args, device="cpu")
    rg = r_graph(rs, r_pairs(rs), np.asarray(rc.mask.sum(axis=1)))
    pg = build_taskgraph(ps, build_pair_list(ps),
                         pc.mask.sum(1).numpy().astype(np.int64))
    nranks = 4
    assign = np.asarray(r_decompose(rg, rs.ncells, nranks, seed=0)
                        .assignment)
    w = np.random.default_rng(3).gamma(2.0, 1.0, rs.ncells)
    w[np.asarray(rc.mask.sum(axis=1)) == 0] = 0.0
    got = PO.RepartitionAdvisor(pg, ps.ncells, nranks, seed=0)
    want = RO.RepartitionAdvisor(rg, rs.ncells, nranks, seed=0)
    np.testing.assert_array_equal(got.modelled_weights,
                                  want.modelled_weights)
    a, b = got.advise(assign, w), want.advise(assign, w)
    np.testing.assert_array_equal(a.pop("assignment"), b.pop("assignment"))
    assert a == b
    assert a["advised_imbalance"] <= a["current_imbalance"]


# ------------------------------------------------------ records by quadrant
def _momentum_scale(sim) -> float:
    """Σ m·|v| over real particles: the scale of the momentum sums."""
    st = sim.state
    cells = st if hasattr(st, "mask") else st.cells
    m = np.asarray(cells.mass * cells.mask, np.float64)
    v = np.asarray(cells.vel, np.float64)
    return float((m * np.sqrt((v * v).sum(-1))).sum())


# walls and what is derived from them (the cost model's EMA rates, which
# weigh the advisor's imbalances)
_WALL_KEYS = {"wall", "phase_wall", "rank_busy", "imbalance", "dead_frac"}


def _close(a, b, path, scale=0.0):
    assert a == pytest.approx(b, rel=RTOL, abs=SCALE_TOL * scale), path


def _compare(got, want, path, mscale):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, set(got) ^ set(want))
        for k in want:
            _compare(got[k], want[k], f"{path}.{k}", mscale)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (x, y) in enumerate(zip(got, want)):
            _compare(x, y, f"{path}[{i}]", mscale)
    elif isinstance(want, float) and not isinstance(got, bool):
        _close(got, want, path)
    else:
        assert got == want, (path, got, want)


def _compare_record(got, want, mscale):
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k in want:
        if k in _WALL_KEYS:
            continue
        if k in ("cost_ratios", "advisor"):
            assert (got[k] is None) == (want[k] is None), k
            if want[k] is not None:
                assert sorted(got[k]) == sorted(want[k]), k
            continue
        if k == "metrics":
            assert got[k]["counters"] == want[k]["counters"]
            assert sorted(got[k]["gauges"]) == sorted(want[k]["gauges"])
            for g in ("bin_occupancy_imbalance", "device_imbalance",
                      "depth"):
                if g in want[k]["gauges"]:
                    _close(got[k]["gauges"][g], want[k]["gauges"][g], g)
            continue
        if k == "device_metrics":
            mi = pdm.VALUE_INDEX["momentum_abs"]
            for r, (x, y) in enumerate(zip(got[k]["values"],
                                           want[k]["values"])):
                _close(x[mi], y[mi], f"momentum_abs[{r}]", mscale)
                _compare(x[:mi] + x[mi + 1:], y[:mi] + y[mi + 1:],
                         f"values[{r}]", mscale)
            rest = {f for f in want[k] if f != "values"}
            _compare({f: got[k][f] for f in rest},
                     {f: want[k][f] for f in rest}, k, mscale)
            continue
        _compare(got[k], want[k], k, mscale)


def _run(sim, ncycles=NCYCLES):
    scales = []
    for _ in range(ncycles):
        sim.step()
        scales.append(_momentum_scale(sim))
    return sim.observer.records, scales


QUADRANTS = [("global", "local", None), ("timebin", "local", None),
             ("global", "distributed", 1), ("timebin", "distributed", 1),
             ("timebin", "distributed", 4)]


@pytest.mark.parametrize("integrator,backend,ranks", QUADRANTS)
def test_records_match_reference(integrator, backend, ranks):
    kw = dict(integrator=integrator, backend=backend, ranks=ranks,
              observe=True)
    if integrator == "timebin" and backend == "distributed":
        kw.update(transport="host", residency="host")
    spec_r, spec_p = _specs(**kw)
    want, _ = _run(R.build_simulation(spec_r))
    got, scales = _run(P.build_simulation(spec_p, device="cpu"))
    assert len(got) == len(want) == NCYCLES
    for g, w, s in zip(got, want, scales):
        _compare_record(g, w, s)
        assert g["schema"] == 3 and g["cycle"] == w["cycle"]


_REF_GLOBAL4 = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax
jax.config.update("jax_default_matmul_precision", "float32")
import repro.sph as R
spec = R.SimulationSpec(physics=R.SPHConfig(alpha_visc=1.0, cfl=0.15),
                        integrator="global", backend="distributed", ranks=4,
                        observe=True, **{sedov!r})
sim = R.build_simulation(spec)
for _ in range({n}):
    sim.step()
print("RECORDS", json.dumps(sim.observer.records))
"""


def test_records_match_reference_global_four_ranks():
    """Global × distributed at 4 ranks: the reference needs four JAX
    devices, so it runs in a subprocess with four host devices."""
    script = _REF_GLOBAL4.format(src=os.path.join(ROOT, "src"),
                                 sedov=SEDOV, n=NCYCLES)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RECORDS "))
    want = json.loads(line[len("RECORDS "):])
    _, spec_p = _specs(integrator="global", backend="distributed", ranks=4,
                       observe=True)
    got, scales = _run(P.build_simulation(spec_p, device="cpu"))
    got = json.loads(json.dumps(got))       # as the reference's went
    for g, w, s in zip(got, want, scales):
        _compare_record(g, w, s)
        assert len(g["device_metrics"]["per_rank_work"]) == 4


# ------------------------------------------------------------ invisibility
def _bits(sim):
    st = sim.state
    return [t.numpy().tobytes() for t in list(st.cells) + list(st[1:])]


@pytest.mark.parametrize("backend,transport", [("local", "host"),
                                               ("distributed", "host"),
                                               ("distributed", "collective")])
def test_tracing_is_bitwise_invisible(backend, transport):
    _, spec = _specs(integrator="timebin", backend=backend,
                     ranks=4 if backend == "distributed" else None,
                     transport=transport)
    plain = P.build_simulation(spec, device="cpu")
    traced = P.build_simulation(spec.with_(observe=True), device="cpu")
    for _ in range(NCYCLES):
        a, b = plain.step(), traced.step()
        for k in ("depth", "substeps", "force_substeps", "updates", "t"):
            assert a[k] == b[k], k
    assert _bits(traced) == _bits(plain)
    assert traced.observer.tracer.spans
    if backend == "distributed":
        assert traced.engine.probe.counts() == plain.engine.probe.counts()
        assert traced.engine.probe.total_compiles() \
            == plain.engine.probe.total_compiles()


# -------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def traced_dist(tmp_path_factory):
    """The CLI's default run (time-bin × distributed, collective wire,
    host residency) at Sedov 6³ over 2 ranks, two cycles, exported."""
    from repro_torch.observability.__main__ import run_spec
    out = tmp_path_factory.mktemp("obs")
    sim = P.build_simulation(run_spec(6, 2, out_dir=str(out)), device="cpu")
    for _ in range(NCYCLES):
        sim.step()
    obs = sim.observer
    doc = obs.export_chrome_trace(str(out / "trace.json"))
    obs.write_metrics_jsonl(str(out / "metrics.jsonl"))
    return sim, doc, out


def test_record_equals_probes_and_round_trips(traced_dist):
    from repro_torch.observability.__main__ import check_run
    sim, doc, out = traced_dist
    obs, eng = sim.observer, sim.engine
    rec = obs.records[-1]
    assert rec["compiles"] == PO.jsonify(eng.probe.counts())
    assert rec["total_compiles"] == eng.probe.total_compiles()
    assert rec["transfers"] == PO.jsonify(eng.transfers.stats())
    assert rec["transport"] == PO.jsonify(eng._transport.stats())
    assert rec["transfers"]["boundary_events"] == {"metrics": NCYCLES}
    assert PO.read_metrics_jsonl(str(out / "metrics.jsonl")) == obs.records
    assert PO.validate_chrome_trace(doc) == []
    assert check_run(sim, doc, 2, NCYCLES) == []
    assert rec["cost_ratios"] and rec["advisor"] is not None
    counters = obs.registry.snapshot()["counters"]
    assert counters["cycles"] == NCYCLES
    assert counters["transfer_total_bytes"] \
        == rec["transfers"]["total_bytes"]


def test_reference_readers_accept_port_files(traced_dist):
    from repro.analysis.report import trace_report as r_report
    from repro_torch.analysis.report import trace_report as p_report
    sim, doc, out = traced_dist
    recs = RO.read_metrics_jsonl(str(out / "metrics.jsonl"))
    assert recs == sim.observer.records
    assert [RO.upgrade_record(r) for r in recs] == recs
    tr = json.loads((out / "trace.json").read_text())
    assert RO.validate_chrome_trace(tr) == []
    args = (str(out / "trace.json"), str(out / "metrics.jsonl"))
    text = r_report(*args)
    assert text == p_report(*args)
    assert "rank 0 |" in text and "rank 1 |" in text
    bundle = sim.observer.dump_flight(reason="manual")
    assert RO.validate_bundle(bundle) == PO.validate_bundle(bundle)


def test_nan_sentinel_trips_and_dumps_flight_bundle(tmp_path):
    from repro_torch.observability.__main__ import inject_nan
    _, spec = _specs(integrator="timebin", backend="distributed", ranks=1,
                     transport="collective",
                     observe={"flight_dir": str(tmp_path)})
    sim = P.build_simulation(spec, device="cpu")
    sim.step()
    obs = sim.observer
    assert obs.records[-1]["health"]["tripped"] is False
    assert not obs.flight.dumps
    inject_nan(sim.engine)
    with np.errstate(invalid="ignore"):
        sim.step()
    rec = obs.records[-1]
    assert rec["health"]["tripped"] is True
    assert rec["health"]["flags"]["flag_nan"] > 0
    assert rec["flight_dump"] == obs.flight.dumps[-1]
    for validate in (PO.validate_bundle, RO.validate_bundle):
        manifest = validate(rec["flight_dump"])
        assert manifest["reason"] == "nan" and manifest["cycle"] == 1
    counters = obs.registry.snapshot()["counters"]
    assert counters["sentinel_trips"] == 1 and counters["flight_dumps"] == 1


def test_flight_recorder_matches_reference(tmp_path):
    bundles = {}
    for mod, sub in ((PO, "port"), (RO, "ref")):
        fr = mod.FlightRecorder(k=3)
        for cyc in range(5):
            counts, values = pdm.zero_rows(2)
            counts[:, 0] = cyc + 1
            fr.record(cyc, counts, values)
        assert [r["cycle"] for r in fr.rows()] == [2, 3, 4]
        path = fr.dump(str(tmp_path / sub), reason="unit test!", cycle=4,
                       spans=_spans(mod), extra={"note": "x"})
        bundles[sub] = mod.read_bundle(path)
        bundles[sub]["manifest"].pop("created_unix")
        assert os.path.basename(path) == "flight-cycle00004-unit-test-"
    assert bundles["port"] == bundles["ref"]
    # tampering is caught
    path = str(tmp_path / "port" / "flight-cycle00004-unit-test-")
    mpath = os.path.join(path, "manifest.json")
    doc = json.loads(open(mpath).read())
    doc["records"] = 99
    open(mpath, "w").write(json.dumps(doc))
    with pytest.raises(ValueError, match="record count"):
        PO.validate_bundle(path)


# --------------------------------------------------------------------- CLI
def test_cli_default_run_exits_zero(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.observability", "--device",
         "cpu", "--n-side", "6", "--ranks", "2", "--out-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["ok"] and summary["device"] == "cpu"
    for f in ("trace.json", "metrics.jsonl", "advisor_trend.txt"):
        assert (tmp_path / f).is_file()


def test_cli_dump_and_advise(tmp_path, capsys):
    from repro.analysis.report import advisor_trend, attribution_table
    from repro_torch.observability.__main__ import run
    args = ["--device", "cpu", "--n-side", "6", "--ranks", "2",
            "--out-dir", str(tmp_path)]
    assert run(["dump", "--inject-nan"] + args) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["tripped"] and out["dumps"]
    for d in out["dumps"]:
        assert PO.validate_bundle(d["bundle"])["reason"] == "nan"
        assert run(["dump", "--validate", d["bundle"]]) == 0
        capsys.readouterr()
    assert run(args) == 0
    capsys.readouterr()
    metrics = str(tmp_path / "metrics.jsonl")
    assert run(["advise", "--metrics", metrics]) == 0
    records = RO.read_metrics_jsonl(metrics)
    want = attribution_table(records) + "\n\n" + advisor_trend(records)
    assert capsys.readouterr().out == want + "\n"


def test_cli_device_residency_names_item_11b(tmp_path, capsys):
    """``--residency device`` runs (it raised until the device residency
    was ported): the fused run at its smallest size passes the CLI's own
    checks, and its trace validates with one fused slice per sub-step."""
    from repro_torch.observability.__main__ import run
    assert run(["--device", "cpu", "--residency", "device", "--n-side",
                "6", "--ranks", "2", "--out-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["residency"] == "device"
    assert out["cost_calibration"] is not None
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert PO.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"scatter", "fused_substep", "fused_final", "gather"} <= names
    assert not names & {"density", "force"}


# ---------------------------------------------------------------- adaptive
def test_adaptive_is_a_whole_copy():
    ref = importlib.import_module("repro.sph.adaptive")
    port = importlib.import_module("repro_torch.sph.adaptive")
    assert inspect.getsource(port) == inspect.getsource(ref)


@pytest.mark.parametrize("threshold,levels", [(16, 3), (64, 2)])
def test_refined_cell_graph_equals_reference(threshold, levels):
    from repro.sph.adaptive import refined_cell_graph as ref_graph
    from repro_torch.sph.adaptive import refined_cell_graph
    ic = P.make_ic("sedov", n_side=8, seed=0)
    kw = dict(threshold=threshold, max_levels=levels, n_ngb=16.0)
    got = refined_cell_graph(ic["pos"], float(ic["box"]), 3, **kw)
    want = ref_graph(ic["pos"], float(ic["box"]), 3, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert [(l.level, l.idx, l.occupancy) for l in got[2]] \
        == [(l.level, l.idx, l.occupancy) for l in want[2]]
