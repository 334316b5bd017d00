"""Port parity: the time-bin × distributed quadrant (``repro_torch.sph.
dist_timebins``) against the reference's ``repro.sph.dist_timebins`` (its
host residency and host schedule, over the host wire).

* The rank plan, the static halo export schedule and the per-rank extended
  states scattered from the reference's injected state equal the
  reference's exactly; so do ``cell_max_bins`` and ``cell_bin_histogram``.
* Two cycles at 4 ranks on the reference's conformance scenarios
  (tests/test_conformance.py:47-60): every cycle stat and the telemetry
  count rows equal; ``mask``, ``bins``, ``t_start``, ``time``, ``h`` and
  ``mass`` exact, ``pos`` within 1e-6, the other floats within 1e-4 of each
  field's scale, energy within 1e-5 — the local ladder's tolerances
  (tests/test_torch_timebins.py): the port's pair passes contract momentum
  in double-float where the reference's blocks sum in f32.
* The reference's fine blast (tests/test_api.py:292-302, cut from
  ``max_depth`` 6 to 4 to keep this file near a minute on one CPU worker:
  the shipped share is 0.42 of the full boundary at both depths in the
  reference) ships under 0.7 of the full boundary and exactly the
  reference's slots; ``repartition_threshold=1.0`` forces a repartition
  and the new assignment is the reference's.
* Against the port's own single-host ladder, bit for bit (the reference's
  contract for the time-bin family, tests/test_conformance.py:9-15): 1, 3
  and 4 ranks, the host wire and the collective wire in both modes, with
  activity-aware halos off too; run twice, bitwise.
* The reference's ``ValueError``s, word for word; the device schedule
  and segments run, one segment bit for bit the host schedule (device
  residency: ``tests/test_torch_dist_resident.py``; the device schedule:
  ``tests/test_torch_dist_schedule.py``).
"""

import warnings

import numpy as np
import pytest
import torch

import repro.sph as R
from repro.sph import dist_timebins as rdt
from repro.sph import timebins as rtb
import repro_torch.sph as P
from repro_torch.sph import dist_timebins as pdt
from repro_torch.sph import timebins as ptb
from repro_torch.sph.convert import timebin_state_to_torch, to_numpy
from torch_threads import one_torch_thread  # noqa: F401

# the reference's conformance scenarios (tests/test_conformance.py:47-60)
SCENARIOS = {
    "sedov": dict(scenario="sedov",
                  scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
                  alpha=1.0, cfl=0.15, dt_max=0.02, max_depth=4),
    "kelvin_helmholtz": dict(
        scenario="kelvin_helmholtz",
        scenario_params={"n_side": 5, "v_shear": 0.5, "seed": 0},
        alpha=1.0, cfl=0.2, dt_max=0.01, max_depth=3),
}
# the reference's fine blast (tests/test_api.py:292-302), max_depth 6 → 4
FINE = dict(scenario="sedov",
            scenario_params={"n_side": 8, "e0": 1.0, "seed": 0,
                             "n_target": 16.0, "r_inject": 0.06},
            alpha=1.0, cfl=0.15, n_target=16.0, max_depth=4)
COUNTS = ("depth", "substeps", "force_substeps", "updates", "pair_tasks",
          "global_equiv_updates", "global_equiv_pair_tasks",
          "halo_exported_slots", "halo_full_slots", "nranks")
NCYCLES = 2


def _specs(kw, **dist):
    kw = dict(kw)
    phys = dict(alpha_visc=kw.pop("alpha"), cfl=kw.pop("cfl"))
    if "n_target" in kw:
        phys["n_target"] = kw.pop("n_target")
    dist = dict(dict(integrator="timebin", backend="distributed", ranks=4),
                **dist)
    return (R.SimulationSpec(physics=R.SPHConfig(**phys), **kw, **dist),
            P.SimulationSpec(physics=P.SPHConfig(**phys), **kw, **dist))


def _close(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)


def _flat(state) -> dict:
    out = to_numpy(state)
    out.update(out.pop("cells"))
    return out


def _ref_flat(state) -> dict:
    out = {k: np.asarray(v) for k, v in state._asdict().items()
           if k != "cells"}
    out.update({k: np.asarray(v) for k, v in state.cells._asdict().items()})
    return out


def _assert_tracks_reference(got, want, name):
    m = want["mask"] > 0
    for k in ("mask", "bins", "t_start", "time", "h", "mass"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
    np.testing.assert_allclose(got["pos"][m], want["pos"][m], atol=1e-6)
    for k in ("vel", "u", "accel", "dudt", "rho", "omega"):
        _close(got[k][m], want[k][m], 1e-4, f"{name}: {k}")


def _bitwise(a: dict, b: dict):
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _stats_equal(a, b, exact_time=True):
    for k in COUNTS:
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["bin_hist"], b["bin_hist"])
    if exact_time:
        assert a["t"] == b["t"] and a["dt_max"] == b["dt_max"]
    else:
        assert a["t"] == pytest.approx(b["t"], rel=1e-5)
        assert a["dt_max"] == pytest.approx(b["dt_max"], rel=1e-5)


# ------------------------------------------------------------ against ref
@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def conformance(request):
    """Reference and port, 4 ranks on the host wire, telemetry on, two
    cycles; and the port's local ladder on the same spec."""
    spec_r, spec_p = _specs(SCENARIOS[request.param])
    ref = R.build_simulation(spec_r)
    port = P.build_simulation(spec_p, device="cpu")
    ref.engine.device_metrics_enabled = True
    port.engine.device_metrics_enabled = True
    stats = []
    for _ in range(NCYCLES):
        stats.append((ref.step(), port.step(),
                      ref.engine.device_metrics_last[0].copy(),
                      port.engine.device_metrics_last[0].copy()))
    local = P.build_simulation(spec_p.with_(backend="local"), device="cpu")
    local_stats = [local.step() for _ in range(NCYCLES)]
    return request.param, ref, port, stats, local, local_stats


def test_two_cycles_match_reference(conformance):
    name, ref, port, stats, _, _ = conformance
    for a, b, _, _ in stats:
        _stats_equal(a, b)
        assert b["halo_full_slots"] > 0
    _assert_tracks_reference(_flat(port.state), _ref_flat(ref.state), name)
    e_r, _ = ref.diagnostics()
    e_p, _ = port.diagnostics()
    assert e_p == pytest.approx(e_r, rel=1e-5)
    assert port.engine.repartitions == ref.engine.repartitions
    np.testing.assert_array_equal(port.engine._assignment,
                                  ref.engine._assignment)


def test_metrics_count_rows_equal_reference(conformance):
    _, ref, port, stats, _, _ = conformance
    for _, _, c_ref, c_port in stats:
        assert c_port.shape == c_ref.shape
        np.testing.assert_array_equal(c_port, c_ref)
    assert port.engine.device_metrics_pulls == NCYCLES
    tr = port.engine.transport_stats()
    assert tr["transfers"]["boundary_events"] == {"metrics": NCYCLES}
    assert tr["kind"] == "host" and tr["exchanges"] > 0


def test_bitwise_the_local_ladder(conformance):
    _, _, port, stats, local, local_stats = conformance
    _bitwise(_flat(port.state), _flat(local.state))
    for (_, b, _, _), c in zip(stats, local_stats):
        for k in ("depth", "substeps", "force_substeps", "updates",
                  "pair_tasks", "t", "dt_max"):
            assert b[k] == c[k], k
        np.testing.assert_array_equal(b["bin_hist"], c["bin_hist"])


@pytest.fixture(scope="module")
def fine():
    spec_r, spec_p = _specs(FINE, repartition_threshold=1.0)
    ref = R.build_simulation(spec_r)
    port = P.build_simulation(spec_p, device="cpu")
    a0 = port.engine._assignment.copy()
    stats = [(ref.step(), port.step()) for _ in range(NCYCLES)]
    return ref, port, stats, a0


def test_fine_blast_ships_less_and_as_reference(fine):
    ref, port, stats, _ = fine
    for a, b in stats:
        _stats_equal(a, b, exact_time=False)
        assert b["halo_full_slots"] > 0
        assert b["halo_exported_slots"] < 0.7 * b["halo_full_slots"]
    np.testing.assert_array_equal(
        [h["exported_slots"] for h in port.engine.halo_log],
        [h["exported_slots"] for h in ref.engine.halo_log])
    # no dt_max: the second cycle's span is a float of the state, equal
    # to rounding (above), so the fields part at that rounding; the
    # discrete ones stay equal
    got, want = _flat(port.state), _ref_flat(ref.state)
    for k in ("mask", "bins", "h", "mass"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_repartition_forced_and_equal_reference(fine):
    ref, port, _, a0 = fine
    assert port.engine.repartitions == ref.engine.repartitions >= 1
    assert len(port.engine.repartition_seconds) == port.engine.repartitions
    assert not np.array_equal(port.engine._assignment, a0)
    np.testing.assert_array_equal(port.engine._assignment,
                                  ref.engine._assignment)


@pytest.fixture(scope="module")
def sedov8():
    """The reference's and the port's engines on Sedov 8³, 4 ranks, built
    (decomposed) but not stepped."""
    spec_r, spec_p = _specs(dict(scenario="sedov",
                                 scenario_params={"n_side": 8},
                                 alpha=1.0, cfl=0.15, max_depth=4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (R.build_simulation(spec_r).engine,
                P.build_simulation(spec_p, device="cpu").engine)


def test_rank_plan_equals_reference(sedov8):
    ref, port = sedov8
    np.testing.assert_array_equal(port._assignment, ref._assignment)
    pr = pdt.build_rank_plan(port._assignment, port._ci, port._cj, 4)
    rr = rdt.build_rank_plan(ref._assignment, ref._ci, ref._cj, 4)
    assert (pr.nranks, pr.K, pr.H) == (rr.nranks, rr.K, rr.H)
    np.testing.assert_array_equal(pr.assignment, rr.assignment)
    np.testing.assert_array_equal(pr.ext_row, rr.ext_row)
    for name in ("owned", "halo", "touch", "ci_ext", "cj_ext"):
        for a, b in zip(getattr(pr, name), getattr(rr, name)):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert pr.cut == rr.cut
    assert pr.cut_slots == rr.cut_slots > 0
    assert pr.export_edges() == rr.export_edges()
    due = sorted(pr.cut)[::3]
    assert pr.ship_slots(due).edges == rr.ship_slots(due).edges


@pytest.mark.parametrize("seed", range(3))
def test_halo_export_schedule_and_cell_bins_equal_reference(sedov8, seed):
    ref, port = sedov8
    rng = np.random.default_rng(seed)
    shape = port.state.bins.shape
    bins = rng.integers(0, 5, size=shape).astype(np.int32)
    mask = (rng.random(shape) < 0.6).astype(np.float32)
    mask[rng.integers(0, shape[0], 5)] = 0.0          # some empty cells
    cb = ptb.cell_max_bins(bins, mask)
    np.testing.assert_array_equal(cb, rtb.cell_max_bins(bins, mask))
    assert cb.dtype == np.int64 and (cb == -1).any()
    for nbins in (3, 5, 7):
        np.testing.assert_array_equal(
            ptb.cell_bin_histogram(bins, mask, nbins),
            rtb.cell_bin_histogram(bins, mask, nbins))
    pr = pdt.build_rank_plan(port._assignment, port._ci, port._cj, 4)
    rr = rdt.build_rank_plan(ref._assignment, ref._ci, ref._cj, 4)
    for depth in (2, 4):
        got = pdt.halo_export_schedule(cb, pr, depth)
        want = rdt.halo_export_schedule(cb, rr, depth)
        for k in ("active", "full"):
            np.testing.assert_array_equal(got[k], want[k])


def test_scatter_of_injected_state_equals_reference(sedov8):
    """The reference's global state and assignment, injected into the
    port: each rank's extended state equals the reference's
    ``_scatter_state``, field by field, bit for bit."""
    ref, port = sedov8
    st = ref.state
    st = st._replace(bins=(np.arange(np.size(st.bins)).reshape(
        np.shape(st.bins)) % 5).astype(np.int32))
    ref.state = st
    port.state = timebin_state_to_torch(st, device="cpu")
    port._assignment = np.asarray(ref._assignment).copy()
    want = ref._scatter_state(ref._get_plan())
    got = port._scatter_state(port._get_plan())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _bitwise(_flat(g), {k: v for k, v in _ref_flat(w).items()})


# --------------------------------------------------- against the port's own
SEDOV = SCENARIOS["sedov"]


@pytest.fixture(scope="module")
def sedov_local():
    _, spec_p = _specs(SEDOV)
    local = P.build_simulation(spec_p.with_(backend="local"), device="cpu")
    stats = [local.step() for _ in range(NCYCLES)]
    return spec_p, _flat(local.state), stats


# 4 ranks on the host wire with activity-aware halos: ``conformance``
MATRIX = [(1, "host", "auto", True), (4, "host", "auto", False),
          (3, "collective", "ppermute", True),
          (3, "collective", "allgather", True),
          (4, "collective", "ppermute", True),
          (4, "collective", "allgather", False)]


@pytest.mark.parametrize("ranks,transport,mode,aware", MATRIX)
def test_bitwise_local_ladder_matrix(sedov_local, ranks, transport, mode,
                                     aware):
    spec, want, local_stats = sedov_local
    sim = P.build_simulation(spec.with_(ranks=ranks, transport=transport,
                                        transport_mode=mode,
                                        activity_aware_halos=aware),
                             device="cpu")
    stats = [sim.step() for _ in range(NCYCLES)]
    _bitwise(_flat(sim.state), want)
    for a, b in zip(stats, local_stats):
        for k in ("depth", "force_substeps", "updates", "pair_tasks"):
            assert a[k] == b[k], k
        assert a["nranks"] == ranks
        assert (a["halo_full_slots"] > 0) == (ranks > 1)
        if not aware:
            assert a["halo_exported_slots"] == a["halo_full_slots"]
    tr = sim.engine.transport_stats()
    assert tr["kind"] == transport and tr["residency"] == "host"
    if transport == "collective":
        assert tr["mode"] == mode and tr["host_bytes"] == 0
        # both exchanges of a sub-step ship its slots, the closing
        # boundary's one exchange the full cut
        cut = sim.engine._get_plan().cut_slots
        assert tr["shipped_rows"] == sum(2 * s["halo_exported_slots"] - cut
                                         for s in stats)
        # one program signature per (program, bucket)
        assert all(v == 1 for k, v in tr["compiles"].items()
                   if k.startswith("program:"))


def test_run_twice_bitwise(sedov_local):
    spec, _, _ = sedov_local
    spec = spec.with_(scenario_params={"n_side": 6, "e0": 1.0, "seed": 1},
                      transport="collective")
    runs = []
    for _ in range(2):
        sim = P.build_simulation(spec, device="cpu")
        stats = [sim.step() for _ in range(NCYCLES)]
        runs.append((_flat(sim.state), [s["halo_exported_slots"]
                                        for s in stats]))
    _bitwise(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


# -------------------------------------------------------------- validation
def _ic():
    return P.make_ic("uniform", n_side=3)


BAD = [dict(transport="mpi"), dict(residency="disk"),
       dict(residency="device", transport="host"),
       dict(residency="device", transport="collective",
            cfg=dict(use_pallas=True)),
       dict(schedule="graph"), dict(schedule="device"),
       dict(segment_cycles=0), dict(segment_cycles=2)]


@pytest.mark.parametrize("bad", BAD)
def test_value_errors_as_reference(bad):
    bad = dict(bad)
    cfg = bad.pop("cfg", {})
    ic = _ic()
    args = (ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"])
    with pytest.raises(ValueError) as want:
        rdt.DistTimeBinSimulation(*args, box=1.0, cfg=R.SPHConfig(**cfg),
                                  **bad)
    with pytest.raises(ValueError) as got:
        pdt.DistTimeBinSimulation(*args, box=1.0, cfg=P.SPHConfig(**cfg),
                                  device="cpu", **bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("policy", [
    dict(residency="device", transport="collective", schedule="device"),
    dict(residency="device", transport="collective", schedule="device",
         segment_cycles=2)])
def test_device_residency_raises_item_11b(policy):
    """The device schedule (ROADMAP queue 1 item 11b-2, once a raise) runs:
    one segment is bit for bit the host schedule at its boundary, with
    equal stats (tests/test_torch_dist_schedule.py holds it further)."""
    spec = P.SimulationSpec(scenario="uniform", scenario_params={"n_side": 3},
                            integrator="timebin", backend="distributed",
                            ranks=2, **policy)
    K = spec.segment_cycles
    host = P.build_simulation(spec.with_(schedule="host", segment_cycles=1),
                              device="cpu")
    dev = P.build_simulation(spec, device="cpu")
    for _ in range(K):
        a, b = host.step(), dev.step()
        assert b["schedule"] == "device" and b["segment_cycles"] == K
        for k in COUNTS + ("t", "dt_max"):
            assert a[k] == b[k], k
        np.testing.assert_array_equal(a["bin_hist"], b["bin_hist"])
    _bitwise(_flat(dev.state), _flat(host.state))
    assert dev.engine.segments == 1 and dev.engine.segment_aborts == 0
