"""Port parity: the device residency of the time-bin × distributed quadrant
(``residency="device"``, ``schedule="host"``: ``repro_torch.sph.
dist_timebins``' resident path, ``sph/collectives.py``'s fused sub-step,
``distributed/transport.ResidentBuffers`` and the in-program telemetry rows
of ``observability/device_metrics.py``).

The reference's own fused path fails under this jax (``ValueError: pvary``
inside ``shard_map``), so the oracle is the reference's contract
(tests/test_conformance.py:9-15): device residency is bit for bit host
residency, which tests/test_torch_dist_timebins.py holds bit for bit to the
port's local ladder and within tolerance to the reference. Here:

* ``ResidentBuffers``' ledger: what ``put``, ``pull`` (a slice records only
  the slice) and ``update`` record;
* ``measure_substep`` / ``measure_cells`` against the reference's functions
  (run in JAX on the CPU, outside ``shard_map``) on the same numpy inputs:
  counts equal, values within 1e-6; ``combine`` on tensors equals it on
  numpy; ``stack_incoming`` equals the incoming table of the stacked list;
* ``_split_force_pass`` bit for bit the unsplit pass, and one fused
  sub-step (and the closing one) bit for bit host residency's per-rank
  phases and exchanges from the same scattered state;
* two-cycle trajectories on the conformance scenarios (Sedov at n_side 6,
  Kelvin–Helmholtz at 5; tests/test_conformance.py:47-60) at 1, 2 and 4
  ranks in both collective modes: state and stats bit for bit host
  residency, and within rtol 1e-4 / atol 1e-4 of scale of the reference's
  host residency;
* the transfer discipline (tests/test_conformance.py:226-245) and reuse
  over a third cycle; the hot-Sedov bins refresh (:280); the 4-rank
  telemetry rows and per-cell identities (:551-620); traced bit for bit
  untraced; run twice bit for bit.
"""

import numpy as np
import pytest
import torch

import repro.sph as R
from repro.observability import device_metrics as rdm
import repro_torch.sph as P
from repro_torch.distributed.transport import ResidentBuffers, TransferProbe
from repro_torch.observability import device_metrics as pdm
from repro_torch.sph import collectives as pcol
from repro_torch.sph import timebins as ptb
from repro_torch.sph.cellgrid import (PairList, ParticleCells,
                                      incoming_table, gather_table,
                                      stack_incoming)
from repro_torch.sph.convert import to_numpy
from repro_torch.sph.engine import _force_pass, f32
from repro_torch.sph.timebins import (STATE_AUX_FIELDS, STATE_CELL_FIELDS,
                                      TimeBinState, _substep_density_phase,
                                      active_level)
from torch_threads import one_torch_thread  # noqa: F401

NCYCLES = 2
SCENARIOS = {
    "sedov": dict(scenario="sedov",
                  scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
                  alpha=1.0, cfl=0.15, dt_max=0.02, max_depth=4),
    "kelvin_helmholtz": dict(
        scenario="kelvin_helmholtz",
        scenario_params={"n_side": 5, "v_shear": 0.5, "seed": 0},
        alpha=1.0, cfl=0.2, dt_max=0.01, max_depth=3),
}
COUNTS = ("depth", "substeps", "force_substeps", "updates", "pair_tasks",
          "global_equiv_updates", "global_equiv_pair_tasks",
          "halo_exported_slots", "halo_full_slots", "nranks")
FIELDS = STATE_CELL_FIELDS + STATE_AUX_FIELDS


def _specs(name, **dist):
    kw = dict(SCENARIOS[name])
    phys = dict(alpha_visc=kw.pop("alpha"), cfl=kw.pop("cfl"))
    dist = dict(dict(integrator="timebin", backend="distributed", ranks=4,
                     transport="collective"), **dist)
    return (R.SimulationSpec(physics=R.SPHConfig(**phys), **kw, **dist),
            P.SimulationSpec(physics=P.SPHConfig(**phys), **kw, **dist))


def _flat(state) -> dict:
    out = to_numpy(state)
    out.update(out.pop("cells"))
    return out


def _ref_flat(state) -> dict:
    out = {k: np.asarray(v) for k, v in state._asdict().items()
           if k != "cells"}
    out.update({k: np.asarray(v) for k, v in state.cells._asdict().items()})
    return out


def _bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _close(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)


def _run(spec, cycles: int = NCYCLES):
    sim = P.build_simulation(spec, device="cpu")
    stats = [sim.step() for _ in range(cycles)]
    return sim, stats


# ----------------------------------------------------------- ledger, rows
def test_resident_buffers_ledger():
    probe = TransferProbe()
    res = ResidentBuffers(probe)
    host = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    res.put("u", host, lambda a: torch.from_numpy(a))
    on_dev = torch.ones((2, 5), dtype=torch.int32)
    res.put("bins", on_dev, lambda t: t.clone())
    assert probe.boundary_bytes == {"u": host.nbytes, "bins": 40}
    # a slice pull records only the slice's bytes
    row = res.pull("bins", boundary=False, index=1)
    np.testing.assert_array_equal(row, np.ones(5, np.int32))
    assert probe.intra_bytes == {"bins": 20}
    owned = res.pull("u", index=(slice(None), slice(0, 2)),
                     device=torch.device("cpu"))
    assert isinstance(owned, torch.Tensor) and owned.shape == (2, 2, 3)
    torch.testing.assert_close(owned, torch.from_numpy(host[:, :2]))
    assert probe.boundary_bytes["u"] == host.nbytes + 2 * 2 * 3 * 4
    # update adopts a program's outputs without a transfer
    before = probe.stats()
    res.update({"u": torch.zeros((2, 5, 3))})
    assert probe.stats() == before and float(res["u"].abs().sum()) == 0.0
    assert probe.intra_state_bytes() == 0
    assert probe.total_bytes() == host.nbytes + 40 + 20 + 48


def _rows(seed: int, R_: int = 3, K: int = 5, C: int = 8, bad=None):
    rng = np.random.default_rng(seed)
    mask = (rng.random((R_, K, C)) < 0.7).astype(np.float32)
    mask[:, 0, 0] = 1.0
    active = ((rng.random((R_, K, C)) < 0.5) * mask).astype(np.float32)
    vel = rng.normal(size=(R_, K, C, 3)).astype(np.float32)
    u = rng.random((R_, K, C)).astype(np.float32) + 0.1
    mass = (rng.random((R_, K, C)) * mask).astype(np.float32)
    rho = rng.random((R_, K, C)).astype(np.float32) + 0.5
    if bad == "nan":
        vel[1, 0, 0, 2] = np.nan
    elif bad == "inf":
        u[2, 0, 0] = np.inf
    elif bad == "neg_rho":
        rho[0, 0, 0] = -1.0
        active[0, 0, 0] = 1.0
    ints = {k: rng.integers(0, 50, R_).astype(np.int32) for k in (
        "live_pairs", "pair_int", "pair_cut", "exch_slots", "exch_bytes",
        "deepened", "woken", "kicked")}
    return dict(mask=mask, active=active, vel=vel, u=u, mass=mass,
                rho=rho), ints


@pytest.mark.parametrize("bad", [None, "nan", "inf", "neg_rho"])
def test_measure_substep_equals_reference(bad):
    arrays, ints = _rows(3, bad=bad)
    counts, values = pdm.measure_substep(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        **{k: torch.from_numpy(v) for k, v in ints.items()})
    assert counts.dtype == torch.int32 and values.dtype == torch.float32
    assert counts.shape == (3, pdm.N_COUNTS)
    assert values.shape == (3, pdm.N_VALUES)
    assert pdm.COUNT_COLUMNS == rdm.COUNT_COLUMNS
    assert pdm.VALUE_COLUMNS == rdm.VALUE_COLUMNS
    for r in range(3):
        rc, rv = rdm.measure_substep(
            **{k: v[r] for k, v in arrays.items()},
            **{k: v[r] for k, v in ints.items()})
        np.testing.assert_array_equal(counts[r].numpy(), np.asarray(rc))
        np.testing.assert_allclose(values[r].numpy(), np.asarray(rv),
                                   rtol=1e-6, equal_nan=True)
    if bad:
        assert int(counts[:, pdm.COUNT_INDEX[f"flag_{bad}"]].sum()) == 1


@pytest.mark.parametrize("mode", ["ppermute", "allgather"])
def test_measure_cells_equals_reference(mode):
    rng = np.random.default_rng(7)
    R_, K, H, C, B = 3, 6, 4, 8, 16
    nrows = K + H
    mask = (rng.random((R_, K, C)) < 0.6).astype(np.float32)
    ci = rng.integers(0, K, (R_, B)).astype(np.int32)
    cj = rng.integers(0, nrows, (R_, B)).astype(np.int32)
    swap = rng.random((R_, B)) < 0.3         # some pairs owned on the j side
    ci, cj = np.where(swap, cj, ci), np.where(swap, ci, cj)
    cj = np.where(swap, rng.integers(0, K, (R_, B)), cj).astype(np.int32)
    pmask = (np.arange(B) < rng.integers(4, B, (R_, 1))).astype(np.float32)
    shape = (R_, 2, 8) if mode == "ppermute" else (R_, 8)
    rows = rng.integers(K, nrows, shape).astype(np.int32)
    valid = (rng.random(shape) < 0.5).astype(np.float32)
    nexch = 2 if mode == "ppermute" else 1
    got = pdm.measure_cells(
        nrows=nrows, K=K, mask=torch.from_numpy(mask),
        pmask=torch.from_numpy(pmask), ci=torch.from_numpy(ci),
        cj=torch.from_numpy(cj), exch_rows=torch.from_numpy(rows),
        exch_valid=torch.from_numpy(valid), nexch=nexch)
    assert got.shape == (R_, nrows, pdm.N_CELL_COLS)
    assert pdm.CELL_COLUMNS == rdm.CELL_COLUMNS
    for r in range(R_):
        want = rdm.measure_cells(nrows=nrows, K=K, mask=mask[r],
                                 pmask=pmask[r], ci=ci[r], cj=cj[r],
                                 exch_rows=rows[r], exch_valid=valid[r],
                                 nexch=nexch)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                   rtol=1e-6)
    # no exchange tables: the exchange column stays zero
    bare = pdm.measure_cells(nrows=nrows, K=K, mask=torch.from_numpy(mask),
                             pmask=torch.from_numpy(pmask),
                             ci=torch.from_numpy(ci),
                             cj=torch.from_numpy(cj))
    assert float(bare[..., pdm.CELL_INDEX["exchange"]].abs().sum()) == 0.0


def test_combine_on_tensors_equals_numpy():
    rng = np.random.default_rng(1)
    rows = [(rng.integers(0, 9, (2, pdm.N_COUNTS)).astype(np.int32),
             rng.normal(size=(2, pdm.N_VALUES)).astype(np.float32))
            for _ in range(4)]
    acc_np = rows[0]
    acc_t = tuple(torch.from_numpy(a) for a in rows[0])
    for c, v in rows[1:]:
        acc_np = pdm.combine(acc_np, (c, v))
        acc_t = pdm.combine(acc_t, (torch.from_numpy(c),
                                    torch.from_numpy(v)))
        assert isinstance(acc_t[1], torch.Tensor)
    np.testing.assert_array_equal(acc_t[0].numpy(), acc_np[0])
    np.testing.assert_array_equal(acc_t[1].numpy(), acc_np[1])
    ref = rows[0]
    for c, v in rows[1:]:
        ref = rdm.combine(ref, (c, v))
    np.testing.assert_array_equal(acc_np[1], ref[1])


def test_stack_incoming_equals_table_of_stacked_list():
    """Ranks' tables of different widths, each over its live prefix,
    stacked: the table ``gather_table`` makes of the stacked list's live
    entries, padded with the zero row; ``every_row`` lists every row."""
    rng = np.random.default_rng(5)
    L, P_, n = 3, 16, 10
    ci = rng.integers(0, n, (L, P_))
    cj = rng.integers(0, n, (L, P_))
    nlive = [16, 9, 0]
    tabs = [incoming_table(ci[l], cj[l], n, nlive[l]) for l in range(L)]
    rows, table = stack_incoming(tabs, P_, n)
    live = np.arange(P_)[None] < np.asarray(nlive)[:, None]
    keys = np.concatenate([(ci + n * np.arange(L)[:, None])[live],
                           (cj + n * np.arange(L)[:, None])[live]])
    pos = np.arange(L * P_).reshape(L, P_)
    want_rows, want = gather_table(
        keys, np.concatenate([pos[live], L * P_ + pos[live]]), L * n,
        2 * L * P_)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(table[:, :want.shape[1]], want)
    assert (table[:, want.shape[1]:] == 2 * L * P_).all()
    rows2, table2 = stack_incoming(tabs, P_, n, width=32, every_row=True)
    assert table2.shape == (L * n, 32)
    np.testing.assert_array_equal(rows2, np.arange(L * n))
    np.testing.assert_array_equal(table2[rows, :table.shape[1]], table)


# ------------------------------------------ split pass, one fused sub-step
@pytest.fixture(scope="module")
def engine4():
    """A 4-rank device-residency engine on the conformance Sedov after one
    cycle (real bins), its next cycle opened and its state scattered both
    ways."""
    _, spec = _specs("sedov", residency="device")
    sim = P.build_simulation(spec, device="cpu")
    sim.step()
    eng = sim.engine
    ctx = eng._cycle_prologue()
    return eng, ctx


def _level_tables(eng, ctx, final: bool):
    plan = ctx["plan"]
    if final:
        slots = plan.ship_slots(list(plan.cut))
        tables, sig = eng._fused_tables(plan, None, slots, "fused_final",
                                        None)
        return 0, ctx["nsub"], None, slots, tables, sig
    bins_h, mask_h = ctx["bins_host"], ctx["mask_host"]
    wake = eng._wake_floor(bins_h, mask_h)
    for n in range(1, ctx["nsub"]):
        level = active_level(n, ctx["depth"])
        act = ((bins_h >= level) | (bins_h < wake[:, None])) & (mask_h > 0)
        if act.any():
            break
    cells = act.any(axis=1)
    slots = plan.ship_slots(eng._exchange_set(plan, cells))
    w = np.zeros((plan.nranks, plan.K + plan.H), np.int32)
    for r in range(plan.nranks):
        own, hal = plan.owned[r], plan.halo[r]
        w[r, :len(own)] = wake[own]
        w[r, plan.K:plan.K + len(hal)] = wake[hal]
    tables, sig = eng._fused_tables(plan, cells, slots, "fused_sub", w,
                                    level=level)
    return level, n, cells, slots, tables, sig


def _flat_state(res, nranks, nrows):
    fl = lambda t: t.reshape((nranks * nrows,) + tuple(t.shape[2:]))
    return TimeBinState(
        cells=ParticleCells(**{k: fl(res[k]) for k in STATE_CELL_FIELDS}),
        time=res["time"].repeat_interleave(nrows)[:, None],
        **{k: fl(res[k]) for k in STATE_AUX_FIELDS})


def test_split_force_pass_bitwise_unsplit(engine4):
    eng, ctx = engine4
    plan = ctx["plan"]
    nranks, nrows = plan.nranks, plan.K + plan.H
    _, _, _, _, tbl, sig = _level_tables(eng, ctx, final=True)
    res = eng._scatter_resident(plan)
    st = _flat_state(res, nranks, nrows)
    B = sig[3]
    first = (torch.arange(nranks) * nrows)[:, None]
    pairs = PairList(ci=(tbl["ci"] + first).to(torch.int32).reshape(-1),
                     cj=(tbl["cj"] + first).to(torch.int32).reshape(-1),
                     shift=tbl["shift"].reshape(-1, 3),
                     incoming=(tbl["in_rows"], tbl["in_table"]))
    pmask = tbl["pmask"].reshape(-1)
    pre = _substep_density_phase(st, pairs, pmask, st.cells.mask,
                                 cfg=eng.cfg)
    t = eng._transport
    assert t.mode == "ppermute"
    prog = pcol.build_permute_program(t.rounds, nranks, nrows,
                                      tbl["e_pack"].shape[-1], 4)
    stk = lambda x: x.reshape((nranks, nrows) + tuple(x.shape[1:]))
    post = [o.reshape(x.shape) for o, x in zip(
        prog(tbl["e_pack"], tbl["e_unpack"], tbl["e_valid"],
             *[stk(x) for x in pre]), pre)]
    assert not torch.equal(pre[0], post[0])     # the exchange wrote halos
    # (rho, omega, press, cs) → the pass's (rho, press, omega, cs)
    order = lambda f: (f[0], f[2], f[1], f[3])
    offs = (torch.arange(nranks) * B)[:, None]
    flat_pos = lambda pos, valid: torch.where(valid > 0, pos + offs,
                                              0).reshape(-1)
    got = pcol._split_force_pass(
        st.cells, pairs, pmask, order(pre), order(post),
        flat_pos(tbl["int_pos"], tbl["int_valid"]),
        tbl["int_valid"].reshape(-1),
        flat_pos(tbl["cut_pos"], tbl["cut_valid"]),
        tbl["cut_valid"].reshape(-1), cfg=eng.cfg)
    want = _force_pass(st.cells, pairs, *order(post), eng.cfg,
                       pair_mask=pmask)
    assert int((tbl["int_valid"] > 0).sum()) > 0
    assert int((tbl["cut_valid"] > 0).sum()) > 0
    for g, w in zip(got, want):
        assert g.view(torch.int32).equal(w.view(torch.int32))


def _host_phases(eng, ctx, n, level, cells, slots, final):
    """Host residency's per-rank phases and exchanges of one sub-step from
    the scattered state: the stacked result."""
    plan = ctx["plan"]
    dev = eng.device
    states = eng._scatter_state(plan)
    dt_d = f32(n * ctx["dt_min"], dev)
    dt_max = f32(ctx["dt_max_c"], dev)
    subs, _ = eng._rank_pair_subsets(plan, cells)
    wake = eng._wake_floor(ctx["bins_host"], ctx["mask_host"])
    phase1 = []
    for r in range(plan.nranks):
        states[r] = eng._drift(states[r], dt_d)
        sub, pmask, _ = subs[r]
        if final:
            got = eng._final_density(states[r], sub, pmask, cfg=eng.cfg)
        else:
            wf = np.zeros(plan.K + plan.H, np.int32)
            wf[:len(plan.owned[r])] = wake[plan.owned[r]]
            wf[plan.K:plan.K + len(plan.halo[r])] = wake[plan.halo[r]]
            wf = torch.from_numpy(wf)
            got = eng._sub_density(states[r], sub, pmask, level, wf,
                                   cfg=eng.cfg)
            got = got[1:] + (got[0], wf)
        phase1.append(list(got))
    fields = eng._transport.exchange(
        slots, [[phase1[r][f] for r in range(plan.nranks)]
                for f in range(4)])
    for r in range(plan.nranks):
        sub, pmask, _ = subs[r]
        rho, om, pr, cs = (fields[f][r] for f in range(4))
        if final:
            states[r] = ptb._final_force_phase(
                states[r], sub, pmask, rho, om, pr, cs, dt_max, cfg=eng.cfg)
        else:
            act, wf = phase1[r][4], phase1[r][5]
            states[r], _ = ptb._substep_force_phase(
                states[r], sub, pmask, act, rho, om, pr, cs, wf, dt_max,
                ctx["depth"], f32(ctx["u_floor"], dev), cfg=eng.cfg)
    if not final:
        names = ("vel", "u", "bins", "t_start", "accel", "dudt")
        fields = [[getattr(states[r].cells, nm) if nm in ("vel", "u")
                   else getattr(states[r], nm) for r in range(plan.nranks)]
                  for nm in names]
        out = eng._transport.exchange(slots, fields)
        for r in range(plan.nranks):
            states[r] = states[r]._replace(
                cells=states[r].cells._replace(vel=out[0][r], u=out[1][r]),
                bins=out[2][r], t_start=out[3][r], accel=out[4][r],
                dudt=out[5][r])
    stacked = {k: torch.stack([getattr(s.cells, k) for s in states])
               for k in STATE_CELL_FIELDS}
    stacked.update({k: torch.stack([getattr(s, k) for s in states])
                    for k in STATE_AUX_FIELDS})
    stacked["time"] = torch.stack([s.time for s in states])
    return stacked


@pytest.mark.parametrize("final", [False, True])
def test_one_fused_substep_equals_host_phases(engine4, final):
    eng, ctx = engine4
    plan = ctx["plan"]
    level, n, cells, slots, tables, sig = _level_tables(eng, ctx, final)
    assert slots.total > 0                  # a real exchange in both
    res = eng._scatter_resident(plan)
    dev = eng.device
    scalars = {"dt_drift": f32(n * ctx["dt_min"], dev), "level": level,
               "dt_max": f32(ctx["dt_max_c"], dev), "depth": ctx["depth"],
               "u_floor": f32(ctx["u_floor"], dev)}
    prog = eng._fused_program(sig, final=final)
    state_in = {k: res[k] for k in FIELDS + ("time",)}
    out, changed, met = prog(state_in, tables, scalars, metrics=True)
    _, changed_off, met_off = prog(state_in, tables, scalars)
    assert met_off is None and torch.equal(changed, changed_off)
    want = _host_phases(eng, ctx, n, level, cells, slots, final)
    assert out.keys() == want.keys()
    for k in want:
        assert out[k].dtype == want[k].dtype, k
        assert out[k].contiguous().view(-1).view(torch.uint8).equal(
            want[k].contiguous().view(-1).view(torch.uint8)), k
    # the changed flag: an owned row's bin deepened on that rank
    K = plan.K
    deep = (want["bins"][:, :K] != res["bins"][:, :K]).flatten(1).any(1)
    assert changed.tolist() == deep.to(torch.int32).tolist()
    assert met["counts"].shape == (plan.nranks, pdm.N_COUNTS)
    assert met["cells"].shape == (plan.nranks, K + plan.H, pdm.N_CELL_COLS)


# ------------------------------------------------------------ trajectories
_HOST: dict = {}
_REF: dict = {}
_DEV: dict = {}


def _dev_run(name, ranks, mode):
    """A device-residency run, cached: its simulation (which later tests
    step on), and after NCYCLES its state, stats, probe counts and
    transfer ledger."""
    key = (name, ranks, mode)
    if key not in _DEV:
        sim, stats = _run(_specs(name, ranks=ranks, transport_mode=mode,
                                 residency="device")[1])
        eng = sim.engine
        _DEV[key] = dict(sim=sim, flat=_flat(sim.state), stats=stats,
                         counts=eng.probe.counts(),
                         transfers=eng.transfers.stats())
    return _DEV[key]


def _host_run(name, ranks):
    key = (name, ranks)
    if key not in _HOST:
        sim, stats = _run(_specs(name, ranks=ranks)[1])
        _HOST[key] = (_flat(sim.state), stats)
    return _HOST[key]


def _ref_run(name):
    """The reference's host residency over the host wire at 4 ranks (its
    rank counts and wires are bit for bit each other by its contract)."""
    if name not in _REF:
        spec = _specs(name, transport="host")[0]
        sim = R.build_simulation(spec)
        stats = [sim.step() for _ in range(NCYCLES)]
        _REF[name] = (_ref_flat(sim.state), stats)
    return _REF[name]


@pytest.mark.parametrize("name,ranks,mode", [
    ("sedov", 1, "ppermute"), ("sedov", 1, "allgather"),
    ("sedov", 2, "ppermute"), ("sedov", 2, "allgather"),
    ("sedov", 4, "ppermute"), ("sedov", 4, "allgather"),
    ("kelvin_helmholtz", 4, "allgather")])
def test_trajectory_bitwise_host_residency(name, ranks, mode):
    run = _dev_run(name, ranks, mode)
    sim, stats, got = run["sim"], run["stats"], run["flat"]
    want, want_stats = _host_run(name, ranks)
    _bitwise(got, want)
    for a, b in zip(stats, want_stats):
        for k in COUNTS + ("t", "dt_max"):
            assert a[k] == b[k], k
        np.testing.assert_array_equal(a["bin_hist"], b["bin_hist"])
        assert a["residency"] == "device" and b["residency"] == "host"
    tr = sim.engine.transport_stats()
    assert tr["mode"] == mode and tr["residency"] == "device"
    # … and within the pinned tolerance of the reference's host residency
    ref, ref_stats = _ref_run(name)
    m = ref["mask"] > 0
    for k in ("mask", "bins", "t_start", "time", "h", "mass"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["pos"][m], ref["pos"][m], atol=1e-6)
    for k in ("vel", "u", "accel", "dudt", "rho", "omega"):
        _close(got[k][m], ref[k][m], 1e-4, k)
    for a, b in zip(stats, ref_stats):
        for k in ("depth", "force_substeps", "updates", "pair_tasks"):
            assert a[k] == b[k], k


# ------------------------------------------------------ transfer discipline
def _assert_resident_discipline(eng, interior_substeps: int):
    """tests/test_conformance.py:226-245, on the port's engine."""
    stats = eng.transfers.stats()
    assert stats["intra_state_bytes"] == 0, stats
    assert set(eng.transfers.intra_bytes) <= {"tables", "flags", "bins"}
    assert (eng.transfers.intra_events.get("bins", 0) == 0) \
        == (eng.bins_refreshes == 0)
    for f in ("pos", "vel", "u", "bins"):
        assert stats["boundary_bytes"].get(f, 0) > 0, f
    for name, c in eng.probe.counts().items():
        if name.startswith("program:"):
            assert c == 1, (name, c)
    assert any(k[0] == "fused_force" for k in eng.program_keys) \
        == (interior_substeps > 0)
    assert any(k[0] == "fused_final" for k in eng.program_keys)


@pytest.mark.parametrize("ranks", [1, 4])
def test_resident_transfer_discipline_and_reuse(ranks):
    run = _dev_run("sedov", ranks, "ppermute")
    sim, stats = run["sim"], run["stats"]
    interior = sum(s["force_substeps"] - 1 for s in stats)
    assert interior > 0
    eng = sim.engine
    _assert_resident_discipline(eng, interior)
    # the per-rank phase programs never ran: only the fused ones
    counts = eng.probe.counts()
    assert all(counts[k] == 0 for k in ("drift", "density", "force",
                                        "final_density", "final_force"))
    assert eng._transport.exchanges == 0
    if ranks > 1:
        assert eng.halo_exported_slots > 0
    builds = eng._transport.programs.builds
    compiles = eng.probe.total_compiles()
    sim.step()                                  # stable bins: full reuse
    assert eng._transport.programs.builds == builds
    assert eng.probe.total_compiles() == compiles
    assert eng.transfers.stats()["intra_state_bytes"] == 0


def _hot_sedov(ranks: int, residency: str = "device"):
    """tests/test_conformance.py:280: a blast that deepens bins mid-cycle."""
    return P.SimulationSpec(
        scenario="sedov", scenario_params={"n_side": 6, "e0": 30.0,
                                           "seed": 0},
        physics=P.SPHConfig(alpha_visc=1.0, cfl=0.3),
        dt_max=0.01, max_depth=3, integrator="timebin",
        backend="distributed", ranks=ranks,
        transport="collective", residency=residency)


def test_hot_sedov_bins_refresh_per_event():
    sim = P.build_simulation(_hot_sedov(4), device="cpu")
    host = P.build_simulation(_hot_sedov(4, "host"), device="cpu")
    host.engine.device_metrics_enabled = True
    sim.step()
    host.step()
    eng = sim.engine
    _bitwise(_flat(sim.state), _flat(host.state))
    assert eng.bins_refreshes == 1
    # one bins row pulled per rank that deepened (the host ladder's
    # deepen_events count those ranks' owned rows that changed)
    deepened = int((host.engine.device_metrics_last[0][
        :, pdm.COUNT_INDEX["deepen_events"]] > 0).sum())
    assert eng.transfers.intra_events.get("bins", 0) == deepened == 4
    assert eng.transfers.stats()["intra_state_bytes"] == 0
    lone = P.build_simulation(_hot_sedov(1), device="cpu")
    lone.step()
    assert lone.engine.bins_refreshes == 1
    assert lone.engine.transfers.intra_events.get("bins", 0) == 1


# -------------------------------------------------------------- telemetry
@pytest.fixture(scope="module")
def observed4():
    _, spec = _specs("sedov", residency="device", transport_mode="ppermute",
                     observe=True)
    sim, _ = _run(spec)
    return sim


def test_four_rank_metrics_rows(observed4):
    """tests/test_conformance.py:551-584: per-rank work from the fused
    rows, owned rows only, one ledgered pull a cycle, measured work fed to
    the cost model."""
    sim = observed4
    _bitwise(_flat(sim.state), _host_run("sedov", 4)[0])
    eng = sim.engine
    counts, values = eng.device_metrics_last
    assert counts.shape == (4, pdm.N_COUNTS)
    assert values.shape == (4, pdm.N_VALUES)
    rec = sim.observer.records[-1]
    dmx = rec["device_metrics"]
    assert len(dmx["per_rank_work"]) == 4
    assert all(w > 0 for w in dmx["per_rank_work"])
    assert rec["device_imbalance"] >= 1.0
    drift = counts[:, pdm.COUNT_INDEX["drift_active"]]
    subs = counts[:, pdm.COUNT_INDEX["substeps"]]
    nreal = int((_flat(sim.state)["mask"] > 0).sum())
    assert (subs == subs[0]).all() and subs[0] > 0
    assert drift.sum() == subs[0] * nreal
    # the last cycle's kicks: every alive particle at the closing step
    assert counts[:, pdm.COUNT_INDEX["force_active"]].sum() >= nreal
    assert eng.transfers.stats()["boundary_events"]["metrics"] == NCYCLES
    assert {"density", "force"} <= set(rec["cost_ratios"])
    assert rec["cost_calibration"] is not None
    assert "bucket_events" in rec and "health" in rec


def test_four_rank_per_cell_identities(observed4):
    """tests/test_conformance.py:587-620: per-rank per-cell sums equal the
    in-program value columns, halo rows fold onto owners."""
    eng = observed4.engine
    cw = eng.device_cell_work_last
    assert cw is not None and list(cw["columns"]) == list(pdm.CELL_COLUMNS)
    cells = np.asarray(cw["cells"], np.float64)
    per_rank = np.asarray(cw["per_rank"], np.float64)
    assert per_rank.shape[0] == 4
    counts, values = (np.asarray(a) for a in eng.device_metrics_last)
    cix = pdm.CELL_INDEX
    for kind in ("density", "force", "exchange"):
        np.testing.assert_allclose(
            per_rank[:, cix[kind]],
            values[:, pdm.VALUE_INDEX[f"{kind}_units"]], rtol=1e-6,
            err_msg=kind)
    np.testing.assert_allclose(per_rank[:, cix["drift"]],
                               counts[:, pdm.COUNT_INDEX["drift_active"]],
                               rtol=1e-6)
    np.testing.assert_allclose(cells.sum(axis=0), per_rank.sum(axis=0),
                               rtol=1e-6)
    assert (cells >= 0).all() and per_rank[:, cix["exchange"]].sum() > 0
    rec = observed4.observer.records[-1]
    assert rec["cell_work"]["ncells"] == cells.shape[0]
    assert rec["advisor"] is not None
    assert rec["advisor"]["advised_imbalance"] \
        <= rec["advisor"]["current_imbalance"] + 1e-9


def test_traced_bitwise_untraced(observed4):
    plain = _dev_run("sedov", 4, "ppermute")
    _bitwise(_flat(observed4.state), plain["flat"])
    assert observed4.engine.probe.counts() == plain["counts"]
    names = {s.name for s in observed4.observer.tracer.spans}
    assert {"scatter", "fused_substep", "fused_final", "gather"} <= names
    assert "metrics" not in plain["transfers"]["boundary_events"]


def test_run_twice_bitwise():
    first = _dev_run("kelvin_helmholtz", 4, "allgather")
    _, spec = _specs("kelvin_helmholtz", residency="device",
                     transport_mode="allgather")
    again, stats = _run(spec)
    _bitwise(first["flat"], _flat(again.state))
    assert [s["halo_exported_slots"] for s in first["stats"]] \
        == [s["halo_exported_slots"] for s in stats]


def test_device_schedule_still_raises_item_11b2():
    """The device schedule (ROADMAP queue 1 item 11b-2, once a raise) on
    the conformance Sedov at 4 ranks: one cycle bit for bit this file's
    host-scheduled resident cycle, with equal stats (at
    ``capacity_margin=1.0``: the trips run the full touch tables, and the
    CPU's plain pair loops cost C²)."""
    _, spec = _specs("sedov", residency="device", capacity_margin=1.0)
    host = P.build_simulation(spec, device="cpu")
    dev = P.build_simulation(spec.with_(schedule="device"), device="cpu")
    a, b = host.step(), dev.step()
    for k in COUNTS + ("t", "dt_max"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["bin_hist"], b["bin_hist"])
    _bitwise(_flat(dev.state), _flat(host.state))
    assert b["schedule"] == "device" and dev.engine.segment_aborts == 0
    assert dev.engine.transfers.intra_bytes == {}
