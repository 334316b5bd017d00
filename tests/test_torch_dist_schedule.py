"""Port parity: the device schedule and K-cycle segments of the time-bin ×
distributed quadrant (``schedule="device"``, ``segment_cycles=K``:
``repro_torch.sph.dist_timebins._run_segment`` and ``sph/collectives.py``'s
cycle-scan and plan programs).

The oracle is the reference's contract (tests/test_conformance.py:9-15,
:332-425): a device-scheduled segment is bit for bit the host-scheduled
resident ladder at every segment boundary, with equal per-cycle stats, and
tests/test_torch_dist_resident.py holds that ladder bit for bit to host
residency. (The reference's own device schedule is held against the port
in tests/test_torch_dist_schedule_ref.py.) Here, on the CPU:

* the ladder helpers without host reads: ``trailing_zeros_table`` equals
  the reference's; the limiter's fixed sweep count reaches
  ``limit_neighbour_bins``' floors (hypothesis over bins, masks,
  ``bin_delta`` 1–3 and ``max_depth`` 1–12, and ``bin_delta`` ≤ 0 at 256
  sweeps); the tensor tree fold is bitwise the numpy one; the crossing
  sentinel's cell ids and wrapped positions are ``bin_particles``' at the
  box's edges; a re-bin with no crossing is the identity;
* the plan program on an engine's state against ``_plan_cycle`` and the
  prologue at 1, 2 and 4 ranks, every output exact;
* one cycle-scan cycle against one host-scheduled cycle: state, stats and
  the metrics rows bitwise;
* 4-cycle trajectories at K = 1 and K = 4 on the conformance scenarios
  (tests/test_conformance.py:47-60) in both collective modes; the
  Kelvin–Helmholtz K = 4 segment crosses a cell, aborts and replays; the
  hot Sedov deepens mid-segment with no abort (:399-425); a NaN trips the
  sentinel, replays bitwise and shows in the observer's health record
  (:427-462); zero intra-segment bytes and build-once programs (:366-396);
  traced equals untraced; run twice bitwise; no host read inside a
  segment (Python-level reads trapped; on the card the sync debug mode,
  tests/test_torch_dist_cuda.py).

The scenarios run at ``capacity_margin=1.0`` (C = 32 and 24 instead of 88
and 48): a segment's trips run every pair of the full touch tables, which
costs the CPU's plain pair loops C², and a padded slot is masked.
"""

import contextlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from repro.sph import timebins as rtb
import repro_torch.sph as P
from repro_torch.sph import collectives as pcol
from repro_torch.sph import timebins as ptb
from repro_torch.sph.cellgrid import GridSpec, bin_particles, pair_arrays
from repro_torch.sph.convert import to_numpy
from torch_threads import one_torch_thread  # noqa: F401

NCYC = 4
SCENARIOS = {
    "sedov": dict(scenario="sedov",
                  scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
                  physics=P.SPHConfig(alpha_visc=1.0, cfl=0.15),
                  dt_max=0.02, max_depth=4),
    "kelvin_helmholtz": dict(
        scenario="kelvin_helmholtz",
        scenario_params={"n_side": 5, "v_shear": 0.5, "seed": 0},
        physics=P.SPHConfig(alpha_visc=1.0, cfl=0.2), dt_max=0.01,
        max_depth=3),
    # tests/test_conformance.py:280-291: deepens inside cycle 1
    "hot_sedov": dict(scenario="sedov",
                      scenario_params={"n_side": 6, "e0": 30.0, "seed": 0},
                      physics=P.SPHConfig(alpha_visc=1.0, cfl=0.3),
                      dt_max=0.01, max_depth=3),
}
STAT_KEYS = ("t", "dt_max", "depth", "substeps", "force_substeps",
             "updates", "global_equiv_updates", "pair_tasks",
             "global_equiv_pair_tasks", "halo_exported_slots",
             "halo_full_slots", "nranks", "residency")


def spec(name: str, ranks: int = 4, mode: str = "auto", **kw):
    return P.SimulationSpec(**SCENARIOS[name], integrator="timebin",
                            backend="distributed", ranks=ranks,
                            transport="collective", transport_mode=mode,
                            residency="device", capacity_margin=1.0, **kw)


def flat(state) -> dict:
    out = to_numpy(state)
    out.update(out.pop("cells"))
    return out


def bitwise(a: dict, b: dict, label: str = ""):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (label, k)
        assert a[k].tobytes() == b[k].tobytes(), (label, k)


def stats_equal(a: dict, b: dict, label: str = ""):
    for k in STAT_KEYS:
        assert a[k] == b[k], (label, k, a[k], b[k])
    np.testing.assert_array_equal(a["bin_hist"], b["bin_hist"],
                                  err_msg=label)


def trajectory(sim, ncycles: int = NCYC):
    stats, states = [], []
    for _ in range(ncycles):
        stats.append(sim.step())
        states.append(flat(sim.engine.state))
    return stats, states


_HOST = {}


def host_run(name: str, mode: str = "auto", ranks: int = 4):
    """The host-scheduled resident run of ``name`` (cached per module)."""
    key = (name, mode, ranks)
    if key not in _HOST:
        sim = P.build_simulation(spec(name, ranks, mode), device="cpu")
        _HOST[key] = (trajectory(sim), sim.engine.bins_refreshes)
    return _HOST[key]


# ------------------------------------------------------ the ladder helpers
def test_trailing_zeros_table_equals_reference():
    for nsub in (1, 2, 8, 16, 1024):
        got = ptb.trailing_zeros_table(nsub)
        np.testing.assert_array_equal(got, rtb.trailing_zeros_table(nsub))
        assert got.dtype == np.int32
        depth = int(np.log2(nsub))
        assert [max(depth - int(got[n]), 0) for n in range(1, nsub + 1)] \
            == [ptb.active_level(n, depth) for n in range(1, nsub + 1)]


def _limit_on_device(bins, mask, ci, cj, delta, max_depth):
    return pcol.limit_bins(
        torch.from_numpy(bins), torch.from_numpy(mask),
        torch.from_numpy(ci.astype(np.int64)),
        torch.from_numpy(cj.astype(np.int64)),
        torch.ones(len(ci)), bin_delta=delta, max_depth=max_depth).numpy()


def _graph(kind: str, size: int, rng):
    """A pair list: the periodic half stencil of a ``size``³ grid, or a
    chain of ``8·size`` cells with a few random chords (long paths, so a
    deep value travels as far as ``max_depth`` allows)."""
    if kind == "grid":
        ci, cj, _ = pair_arrays(GridSpec(box=1.0, ncells_side=size,
                                         capacity=4))
        return ci, cj, size ** 3
    n = 8 * size
    ci = np.concatenate([np.arange(n), np.arange(n - 1),
                         rng.integers(0, n, size)])
    cj = np.concatenate([np.arange(n), np.arange(1, n),
                         rng.integers(0, n, size)])
    return ci.astype(np.int32), cj.astype(np.int32), n


@settings(max_examples=80, deadline=None)
@given(hst.integers(0, 2 ** 31 - 1), hst.sampled_from(["grid", "chain"]),
       hst.integers(2, 5), hst.integers(1, 3), hst.integers(1, 12),
       hst.floats(0.0, 0.9), hst.floats(0.005, 1.0))
def test_limiter_sweeps_reach_the_fixpoint(seed, kind, size, delta,
                                           max_depth, empty, deep):
    """A fixed ceil(max_depth / bin_delta) sweeps give the floors of the
    host limiter's fixpoint (its convergence loop), whatever the bins (a
    ``deep`` share of them nonzero: sparse deep bins travel furthest), the
    empty cells (whose negative deep values never converge fast) and the
    pair graph."""
    rng = np.random.default_rng(seed)
    ci, cj, ncells = _graph(kind, size, rng)
    mask = rng.random((ncells, 4)) >= empty
    spike = rng.random((ncells, 4)) < deep
    bins = np.where(mask & spike,
                    rng.integers(0, max_depth + 1, (ncells, 4)),
                    0).astype(np.int32)
    want = ptb.limit_neighbour_bins(bins, mask, ci, cj, delta=delta,
                                    max_bin=max_depth)
    got = _limit_on_device(bins, mask, ci, cj, delta, max_depth)
    np.testing.assert_array_equal(got, np.where(mask, want, 0))
    # the reference's limiter gives the same floors
    np.testing.assert_array_equal(
        want, rtb.limit_neighbour_bins(bins, mask, ci, cj, delta=delta,
                                       max_bin=max_depth))


@pytest.mark.parametrize("delta", [0, -1])
def test_limiter_without_positive_delta_runs_the_host_cap(delta):
    rng = np.random.default_rng(3)
    ci, cj, _ = pair_arrays(GridSpec(box=1.0, ncells_side=3, capacity=4))
    mask = rng.random((27, 4)) > 0.3
    bins = np.where(mask, rng.integers(0, 6, (27, 4)), 0).astype(np.int32)
    assert pcol.limiter_sweeps(6, delta) == 256
    want = ptb.limit_neighbour_bins(bins, mask, ci, cj, delta=delta,
                                    max_bin=6)
    np.testing.assert_array_equal(
        _limit_on_device(bins, mask, ci, cj, delta, 6),
        np.where(mask, want, 0))


@pytest.mark.parametrize("n", [1, 7, 64, 1000, 4097])
def test_tensor_tree_fold_bitwise_numpy(n):
    rng = np.random.default_rng(n)
    m = (rng.random(n) * (rng.random(n) > 0.2)).astype(np.float32)
    u = (rng.random(n) * 1e3).astype(np.float32)
    want = ptb.tree_sum(m * u)
    got = ptb.tree_sum(torch.from_numpy(m) * torch.from_numpy(u))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.numpy().tobytes() == np.float32(want).tobytes()
    mw = ptb.mass_weighted_mean_u(torch.from_numpy(m.reshape(-1, 1)),
                                  torch.from_numpy(u.reshape(-1, 1)))
    assert mw.numpy().tobytes() == np.float32(
        ptb.mass_weighted_mean_u(m.reshape(-1, 1), u.reshape(-1, 1))
    ).tobytes()


def test_crossing_sentinel_is_bin_particles():
    """Cell ids and wrapped positions of ``cell_ids`` against
    ``bin_particles`` (which re-bins with them), at the box's edges:
    just below ``box``, ``box``, 0, −0.0, subnormals of both signs, tiny
    negatives and a cell edge."""
    box, ns = 1.0, 5
    edge = [np.nextafter(np.float32(box), np.float32(0)), np.float32(box),
            0.0, -0.0, 1e-40, -1e-40, -1e-8, np.float32(0.2),
            np.nextafter(np.float32(0.2), np.float32(0)), 0.6, -0.3, 1.7]
    rng = np.random.default_rng(0)
    pos = rng.random((400, 3)).astype(np.float32)
    e = np.asarray(edge, np.float32)
    pos[:len(e) ** 2, 0] = np.repeat(e, len(e))
    pos[:len(e) ** 2, 1] = np.tile(e, len(e))
    pos[len(e) ** 2:len(e) ** 2 + len(e), 2] = e
    spec = GridSpec(box=box, ncells_side=ns, capacity=8)
    zeros = np.zeros(len(pos), np.float32)
    cells, perm = bin_particles(spec, pos, np.zeros_like(pos), zeros + 1,
                                zeros, zeros + 0.1, device="cpu")
    want_cell = np.empty(len(pos), np.int64)
    for c, k in zip(*np.nonzero(perm >= 0)):
        want_cell[perm[c, k]] = c
    got_cell, posw = pcol.cell_ids(torch.from_numpy(pos), box, ns,
                                   torch.tensor(np.float32(box / ns)))
    np.testing.assert_array_equal(got_cell.numpy(), want_cell)
    assert posw.numpy().tobytes() == np.mod(pos, np.float32(box)).tobytes()
    valid = perm >= 0
    assert cells.pos.numpy()[valid].tobytes() == \
        posw.numpy()[perm[valid]].tobytes()
    # the sentinel also flags a position the re-bin would rewrite
    moved = posw.numpy().view(np.int32) != pos.view(np.int32)
    assert moved[:len(e) ** 2].any() and not moved[len(e) ** 2 + 20:].any()


def test_rebin_without_crossing_is_the_identity():
    sim = P.build_simulation(spec("sedov", ranks=2), device="cpu")
    sim.step()
    eng = sim.engine
    before, perm = flat(eng.state), eng.perm.copy()
    eng._rebin_state()
    bitwise(flat(eng.state), before)
    np.testing.assert_array_equal(eng.perm, perm)


# ------------------------------------------------------ the plan program
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_plan_program_equals_host_plan(ranks):
    """The plan program on the scattered state of an engine after one
    cycle against the host's ``_plan_cycle`` and prologue on the same
    state: bins, dt_max, depth, nsub, u_floor, the histogram and the
    half-kicked vel/u/t_start, all exact, halo rows their owner's."""
    sim = P.build_simulation(spec("sedov", ranks), device="cpu")
    sim.step()
    eng = sim.engine
    plan = eng._get_plan()
    res = eng._scatter_resident(plan)
    tables, consts, sig = eng._segment_tables(plan)
    prog = eng._plan_program(sig, 1 << eng.max_depth)
    names = eng._CELL_FIELDS + eng._AUX_FIELDS + ("time",)
    upd, scal, flags = prog({k: res[k] for k in names}, tables, consts)
    ctx = eng._cycle_prologue()
    assert int(flags["crossed"]) == 0 and int(flags["capacity"]) == 0
    assert scal["dt_max"].dtype == torch.float32
    assert float(scal["dt_max"]) == ctx["dt_max_c"]
    assert int(scal["depth"]) == ctx["depth"]
    assert int(scal["nsub"]) == ctx["nsub"]
    assert float(scal["u_floor"]) == np.float32(ctx["u_floor"])
    np.testing.assert_array_equal(flags["hist"].numpy()[:ctx["depth"] + 1],
                                  ctx["hist"])
    assert int(flags["hist"][ctx["depth"] + 1:].sum()) == 0
    st = eng.state
    for name, want in (("bins", st.bins), ("vel", st.cells.vel),
                       ("u", st.cells.u), ("t_start", st.t_start)):
        got = upd[name]
        for r in range(plan.nranks):
            own, hal = plan.owned[r], plan.halo[r]
            assert got[r, :len(own)].numpy().tobytes() == \
                want[own].numpy().tobytes(), (name, r)
            assert got[r, plan.K:plan.K + len(hal)].numpy().tobytes() == \
                want[hal].numpy().tobytes(), (name, r, "halo")


def test_plan_program_flags_a_crossing_and_the_capacity():
    sim = P.build_simulation(spec("sedov", 2), device="cpu")
    sim.step()
    eng = sim.engine
    plan = eng._get_plan()
    res = eng._scatter_resident(plan)
    tables, consts, sig = eng._segment_tables(plan)
    names = eng._CELL_FIELDS + eng._AUX_FIELDS + ("time",)
    state = {k: res[k].clone() for k in names}
    r, row = 0, 0
    k = int(torch.nonzero(state["mask"][r, row])[0])
    cell = plan.owned[r][row]
    # one particle of the row's cell moved into the opposite cell
    state["pos"][r, row, k] = torch.remainder(
        state["pos"][r, row, k] + 0.5 * eng.box, eng.box)
    _, scal, flags = eng._plan_program(sig, 1)(state, tables, consts)
    assert int(flags["crossed"]) == 1, cell
    assert int(flags["capacity"]) == int(int(scal["nsub"]) > 1) == 1


# ---------------------------------------------------- cycles and segments
def test_one_scan_cycle_equals_one_host_cycle():
    """State, stats and the telemetry rows (counts, values, per-cell
    work) of one cycle, bit for bit."""
    runs = []
    for sched in ("host", "device"):
        sim = P.build_simulation(spec("sedov", schedule=sched),
                                 device="cpu")
        sim.engine.device_metrics_enabled = True
        runs.append((sim.step(), sim.engine))
    (a, ha), (b, da) = runs
    stats_equal(a, b)
    assert b["schedule"] == "device" and b["segment_cycles"] == 1
    bitwise(flat(da.state), flat(ha.state))
    for x, y in zip(da.device_metrics_last, ha.device_metrics_last):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for k in ("cells", "per_rank"):
        np.testing.assert_array_equal(da.device_cell_work_last[k],
                                      ha.device_cell_work_last[k])
    assert da.device_metrics_pulls == ha.device_metrics_pulls == 1
    assert da.segments == 1 and da.segment_aborts == 0


@pytest.mark.parametrize("name,K,mode", [
    ("sedov", 1, "ppermute"), ("sedov", 4, "allgather"),
    ("kelvin_helmholtz", 1, "allgather"),
    ("kelvin_helmholtz", 4, "ppermute")])
def test_trajectory_bitwise_host_schedule(name, K, mode):
    """NCYC cycles in K-cycle segments: the state at each segment boundary
    and every cycle's stats equal the host schedule's. The shear flow
    crosses a cell inside its first 4-cycle segment, so that segment
    aborts on the crossing flag and replays; the blast does not."""
    (hstats, hstates), _ = host_run(name, mode)
    sim = P.build_simulation(spec(name, mode=mode, schedule="device",
                                  segment_cycles=K), device="cpu")
    stats, states = trajectory(sim)
    eng = sim.engine
    for c in range(NCYC):
        stats_equal(stats[c], hstats[c], f"{name} K={K} cycle {c}")
        assert stats[c]["schedule"] == "device"
        assert stats[c]["segment_cycles"] == K
        if (c + 1) % K == 0:
            bitwise(states[c], hstates[c], f"{name} K={K} cycle {c}")
    assert eng.segments == NCYC // K
    if name == "kelvin_helmholtz" and K == 4:
        assert eng.segment_aborts == 1
        assert eng.segment_flags_last["crossed"] > 0
        assert all(s["replayed"] for s in stats)
    else:
        assert eng.segment_aborts == 0
        assert not any(s.get("replayed") for s in stats)


def test_mid_segment_deepening_absorbed():
    """The hot Sedov deepens a bin inside cycle 1 (the host schedule
    refreshes its bins mirror for it); a 4-cycle segment takes it on the
    device: no abort, no intra-segment byte, bitwise state."""
    (hstats, hstates), refreshes = host_run("hot_sedov")
    assert refreshes >= 1
    sim = P.build_simulation(spec("hot_sedov", schedule="device",
                                  segment_cycles=4), device="cpu")
    stats, states = trajectory(sim)
    eng = sim.engine
    for c in range(NCYC):
        stats_equal(stats[c], hstats[c], f"hot cycle {c}")
    bitwise(states[-1], hstates[-1], "hot")
    assert eng.segment_aborts == 0 and eng.segments == 1
    assert eng.transfers.intra_bytes == {}


def _poison_vel(eng) -> None:
    """NaN one real particle's velocity component, in place."""
    vel = eng.state.cells.vel.clone()
    c, p = np.argwhere(eng.state.cells.mask.numpy() > 0)[0]
    vel[c, p, 0] = float("nan")
    eng.state = eng.state._replace(
        cells=eng.state.cells._replace(vel=vel))


def test_nan_sentinel_trips_and_replays_bitwise():
    runs = []
    for sched, ob in (("host", False),
                      ("device", {"device_metrics": True})):
        sim = P.build_simulation(spec("sedov", schedule=sched, observe=ob),
                                 device="cpu")
        sim.step()
        if ob:
            rec0 = sim.observer.records[-1]
            assert rec0["health"] is not None
            assert rec0["health"]["tripped"] is False
        _poison_vel(sim.engine)
        got = []
        with np.errstate(invalid="ignore"):
            for _ in range(2):
                sim.step()
                got.append(flat(sim.engine.state))
        runs.append((sim, got))
    (_, want), (sim, got) = runs
    eng = sim.engine
    assert eng.segment_aborts == 2 and eng.segments == 3
    assert eng.segment_flags_last["sentinels"] > 0
    rec = sim.observer.records[-1]
    assert rec["health"]["tripped"] is True
    assert rec["health"]["flags"].get("flag_nan", 0) > 0
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_zero_intra_bytes_and_programs_built_once():
    sim = P.build_simulation(spec("sedov", schedule="device",
                                  segment_cycles=2), device="cpu")
    for _ in range(NCYC):
        sim.step()
    eng = sim.engine
    tr = eng.transfers.stats()
    assert tr["intra_state_bytes"] == 0 and eng.transfers.intra_bytes == {}
    assert tr["boundary_events"]["segment_tables"] > 0
    assert tr["boundary_events"]["segment_stats"] == eng.segments == 2
    for name, c in eng.probe.counts().items():
        if name.startswith("program:"):
            assert c == 1, (name, c)
    assert {k[0] for k in eng.program_keys} == {"cycle_scan",
                                                "segment_plan"}
    builds = eng._transport.programs.builds
    assert builds == 2
    for _ in range(2):                  # another segment: nothing built
        sim.step()
    assert eng._transport.programs.builds == builds
    assert all(c == 1 for name, c in eng.probe.counts().items()
               if name.startswith("program:"))
    assert eng.transfers.intra_bytes == {}


def test_traced_equals_untraced_and_run_twice():
    got = []
    for ob in (False, True, False):
        sim = P.build_simulation(spec("sedov", schedule="device",
                                      segment_cycles=2, observe=ob),
                                 device="cpu")
        stats = [sim.step() for _ in range(2)]
        got.append((stats, flat(sim.engine.state), sim))
    (s0, a, _), (s1, b, traced), (s2, c, _) = got
    bitwise(b, a, "traced")
    bitwise(c, a, "twice")
    for x, y, z in zip(s0, s1, s2):
        stats_equal(x, y)
        stats_equal(x, z)
    names = {s.name for s in traced.observer.tracer.spans}
    assert {"cycle_scan", "segment_plan", "segment_tables"} <= names
    assert "fused_substep" not in names
    assert len(traced.observer.records) == 2


_HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
               "__float__", "__index__", "nonzero")


@contextlib.contextmanager
def _no_host_reads():
    """Python-level reads of a tensor's value raise (the CPU stand-in for
    the card's sync debug mode)."""
    saved = {n: getattr(torch.Tensor, n) for n in _HOST_READS}

    def trap(name):
        def read(*a, **k):
            raise AssertionError(f"host read inside a segment: {name}")
        return read
    try:
        for n in _HOST_READS:
            setattr(torch.Tensor, n, trap(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def test_no_host_read_inside_a_segment():
    sim = P.build_simulation(spec("sedov", schedule="device",
                                  segment_cycles=2), device="cpu")
    eng = sim.engine
    entered = []

    @contextlib.contextmanager
    def guard():
        entered.append(1)
        with _no_host_reads():
            yield
    eng._segment_guard = guard
    ref = P.build_simulation(spec("sedov", schedule="device",
                                  segment_cycles=2), device="cpu")
    for _ in range(2):
        stats_equal(sim.step(), ref.step())
    assert entered == [1] and eng.segment_aborts == 0
    bitwise(flat(eng.state), flat(ref.engine.state))
    # the trap does trap
    with pytest.raises(AssertionError, match="host read"):
        with _no_host_reads():
            torch.ones(2).sum().item()
