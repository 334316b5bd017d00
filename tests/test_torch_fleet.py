"""Port parity: fleet serving (``repro_torch.fleet``) against ``repro.fleet``.

* **Signatures:** the port's ``signature_key`` equals the reference's
  letter for letter (value-only parameters shared, shape parameters and
  engine fields split, insertion order canonicalised).
* **Queue, batcher, pool:** the reference's contracts
  (``tests/test_fleet.py``): bounded admission, deadline sweeps on submit,
  poll and claim, duplicate ids, grouping, no-shrink buckets, ``max_batch``
  chunks, buffer reuse.
* **Lanes:** the stacked pair list's incoming table equals
  ``incoming_table`` of the stacked ``ci``/``cj``; a stacked init and step
  are bit for bit each lane's single init and step.
* **Batched parity:** five heterogeneous requests (the reference's
  ``test_heterogeneous_fleet_bitwise``) are bit for bit the port's
  ``sequential_reference``, and within rtol 1e-4 / atol 1e-4 of each
  field's scale of the reference's ``FleetRunner(fleet_devices=1)`` on the
  same specs (the pair sums round differently in the two packages);
  heterogeneous step counts; a lane that falls off its batch; the launch
  accounting (one density and one force pass per stacked init or step,
  ``2·steps`` per shape group).
* **Routes, entry points, tracing, expiry:** the time-bin quadrant and
  ``use_pallas`` are served sequentially; wobbling waves build the
  reference's entry points once each; the reference's validators accept
  the port's trace and flight bundle; ``fleet_devices > 1`` raises; the
  CLI exits 0 on the CPU.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro.sph as R
import repro_torch.sph as P
from repro.fleet import FleetRunner as RefFleetRunner
from repro.fleet import split_scenario_params as ref_split
from repro_torch.fleet import (AdmissionError, FleetRunner, RequestQueue,
                               RequestState, SignatureBatcher,
                               TransferBufferPool, lanes, sequential_reference,
                               split_scenario_params)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's conformance fixtures (tests/test_conformance.py:47-60)
# without the time-bin fields, as tests/test_fleet.py's _spec builds them
SCENARIOS = {
    "sedov": dict(scenario="sedov",
                  scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
                  physics=dict(alpha_visc=1.0, cfl=0.15)),
    "kelvin_helmholtz": dict(scenario="kelvin_helmholtz",
                             scenario_params={"n_side": 5, "v_shear": 0.5,
                                              "seed": 0},
                             physics=dict(alpha_visc=1.0, cfl=0.2)),
}
FIELDS = ("pos", "vel", "mass", "u", "h")


def _spec(pkg, scenario, **overrides):
    kw = dict(SCENARIOS[scenario])
    params = dict(kw.pop("scenario_params"))
    params.update(overrides.pop("scenario_params", {}))
    physics = pkg.SPHConfig(**dict(kw.pop("physics"),
                                   **overrides.pop("physics", {})))
    kw.update(overrides)
    return pkg.SimulationSpec(scenario_params=params, physics=physics, **kw)


def _port(scenario, **overrides):
    return _spec(P, scenario, **overrides)


def _runner(**kw):
    return FleetRunner(device="cpu", **kw)


def _served_ok(reqs):
    assert all(r.state.value == "done" for r in reqs), \
        [(r.request_id, r.error) for r in reqs]


def _assert_bitwise(got, want, what=""):
    assert got.particles.keys() == want.particles.keys()
    for k in got.particles:
        np.testing.assert_array_equal(got.particles[k], want.particles[k],
                                      err_msg=f"{what}: {k} not bitwise")
    assert got.t == want.t, what


# ------------------------------------------------------------- signatures
SIGNATURE_CASES = {
    "sedov": ("sedov", {}),
    "sedov_value_params": ("sedov",
                           {"scenario_params": {"e0": 2.5, "seed": 9}}),
    "sedov_shape_param": ("sedov", {"scenario_params": {"n_side": 4}}),
    "timebin": ("sedov", {"integrator": "timebin", "max_depth": 4}),
    "physics": ("sedov", {"physics": {"alpha_visc": 0.5}}),
    "distributed": ("sedov", {"backend": "distributed", "ranks": 4,
                              "halo": "ring"}),
    "dt_rebin": ("sedov", {"dt": 0.004, "rebin_every": 2}),
    "kelvin_helmholtz": ("kelvin_helmholtz",
                         {"scenario_params": {"v_shear": 0.8, "seed": 3}}),
    "observe": ("kelvin_helmholtz", {"observe": True}),
}


@pytest.mark.parametrize("case", sorted(SIGNATURE_CASES))
def test_signature_key_equals_reference(case):
    scenario, kw = SIGNATURE_CASES[case]
    ref, port = _spec(R, scenario, **dict(kw)), _spec(P, scenario, **dict(kw))
    assert repr(port.physics) == repr(ref.physics)
    assert port.signature_key() == ref.signature_key()
    assert repr(port.program_signature()) == repr(ref.program_signature())


@pytest.mark.parametrize("scenario,params", [
    ("sedov", {"n_side": 5, "e0": 2.0, "seed": 7}),
    ("clustered", {"n": 300, "n_halos": 3, "seed": 1}),
    ("not_registered", {"a": 1, "b": [1, 2]}),
])
def test_split_scenario_params_equals_reference(scenario, params):
    assert split_scenario_params(scenario, params) == \
        ref_split(scenario, params)


def test_signature_relations():
    base = _port("sedov")
    assert base.signature_key() == \
        _port("sedov", scenario_params={"e0": 2.5, "seed": 9}).signature_key()
    assert base.signature_key() != \
        _port("sedov", scenario_params={"n_side": 4}).signature_key()
    assert base.signature_key() != \
        _port("sedov", integrator="timebin").signature_key()
    assert base.signature_key() != \
        _port("sedov", physics={"alpha_visc": 0.5}).signature_key()
    a = P.SimulationSpec(scenario="sedov",
                         scenario_params={"n_side": 5, "e0": 1.0, "seed": 3})
    b = P.SimulationSpec(scenario="sedov",
                         scenario_params={"seed": 3, "n_side": 5, "e0": 1.0})
    assert a == b and hash(a) == hash(b)
    assert a.program_signature() == b.program_signature()
    assert a.signature_key() == b.signature_key()
    assert len({a: 0, b: 1}) == 1


# ------------------------------------------------------------------ queue
def test_admission_bounded():
    runner = _runner(max_inflight=2)
    runner.submit(_port("sedov"))
    runner.submit(_port("sedov"))
    with pytest.raises(AdmissionError):
        runner.submit(_port("sedov"))


def test_deadline_expiry_fires_callback():
    runner = _runner()
    seen = []
    req = runner.submit(_port("sedov"), deadline=0.0, callback=seen.append)
    time.sleep(0.01)
    assert runner.queue.expire() == [req]
    assert req.state is RequestState.EXPIRED
    assert isinstance(req.error, TimeoutError)
    assert seen == [req]


def test_duplicate_request_id_rejected():
    runner = _runner()
    runner.submit(_port("sedov"), request_id="r1")
    with pytest.raises(ValueError):
        runner.submit(_port("sedov"), request_id="r1")


def test_expiry_fires_on_poll_without_claim():
    runner = _runner(observe=True)
    seen = []
    req = runner.submit(_port("sedov"), deadline=0.0, callback=seen.append)
    time.sleep(0.01)
    stats = runner.poll()
    assert req.state is RequestState.EXPIRED and seen == [req]
    assert stats["queue"]["expired"] == 1
    assert runner.terminal_status == {"expired": 1}
    assert [s for s in runner.tracer.spans if s.name == "expired"]


def test_expiry_fires_on_next_submit():
    runner = _runner(max_inflight=1)
    seen = []
    stale = runner.submit(_port("sedov"), deadline=0.0, callback=seen.append)
    time.sleep(0.01)
    fresh = runner.submit(_port("sedov"))
    assert stale.state is RequestState.EXPIRED and seen == [stale]
    assert fresh.state is RequestState.QUEUED
    assert runner.terminal_status == {"expired": 1}


def test_requeue_returns_claimed_requests_to_the_head():
    q = RequestQueue()
    a, b = q.submit(_port("sedov")), q.submit(_port("sedov"))
    claimed = q.take_ready()
    assert [r.state for r in claimed] == [RequestState.RUNNING] * 2
    c = q.submit(_port("sedov"))
    q.requeue(claimed)
    assert q.take_ready() == [a, b, c]


# ---------------------------------------------------------------- batcher
def _reqs(n, **overrides):
    q = RequestQueue()
    return [q.submit(_port("sedov", **overrides)) for _ in range(n)]


def test_batcher_groups_by_signature():
    q = RequestQueue()
    reqs = [q.submit(_port("sedov")), q.submit(_port("kelvin_helmholtz")),
            q.submit(_port("sedov", scenario_params={"e0": 3.0}))]
    batches = SignatureBatcher().form(reqs)
    assert [b.size for b in batches] == [2, 1]


def test_batcher_buckets_never_shrink():
    b = SignatureBatcher()
    sizes = [bb.bucket for bb in (b.form(_reqs(7)) + b.form(_reqs(3))
                                  + b.form(_reqs(5)))]
    assert sizes == [8, 8, 8]


@pytest.mark.parametrize("min_bucket,n,bucket,chunks", [
    (4, 3, 4, [3]), (1, 10, 4, [4, 4, 2])])
def test_batcher_min_bucket_and_max_batch(min_bucket, n, bucket, chunks):
    b = SignatureBatcher(min_bucket=min_bucket,
                         max_batch=4 if n > 4 else 64)
    batches = b.form(_reqs(n))
    assert [bb.size for bb in batches] == chunks
    assert batches[0].bucket == bucket
    assert batches[0].pad == bucket - chunks[0]


# ------------------------------------------------------------ result pool
def test_pool_reuses_buffers_per_shape():
    pool = TransferBufferPool()
    a = pool.take(np.arange(6, dtype=np.float32))
    assert pool.stats() == {"hits": 0, "misses": 1, "resident": 0}
    pool.give(a)
    b = pool.take(torch.ones(6))             # a tensor goes through the host
    assert b is a and b[0] == 1.0 and pool.stats()["hits"] == 1
    pool.give(b)
    assert pool.take(np.zeros(5, np.float32)) is not a
    assert pool.stats()["misses"] == 2


# ------------------------------------------------------------------ lanes
def _members(specs):
    from repro_torch.fleet.runner import _build_member
    q = RequestQueue()
    return [_build_member(q.submit(s)) for s in specs]


@pytest.mark.parametrize("bucket", [1, 3, 4])
def test_stacked_pair_list_equals_incoming_table(bucket):
    from repro_torch.sph.cellgrid import incoming_table
    for scen, side in (("sedov", 6), ("uniform", 9)):
        (m,) = _members([P.SimulationSpec(
            scenario=scen, scenario_params={"n_side": side})])
        nc = m.gspec.ncells
        st = lanes.stack_pair_list(m.pairs, bucket, nc)
        P0 = m.pairs.ci.shape[0]
        for lane in range(bucket):
            sl = slice(lane * P0, (lane + 1) * P0)
            assert torch.equal(st.ci[sl].long(), m.pairs.ci.long() + lane * nc)
            assert torch.equal(st.cj[sl].long(), m.pairs.cj.long() + lane * nc)
            assert torch.equal(st.shift[sl], m.pairs.shift)
        cells, table = incoming_table(st.ci.numpy(), st.cj.numpy(),
                                      bucket * nc)
        np.testing.assert_array_equal(st.incoming[0].numpy(), cells)
        np.testing.assert_array_equal(st.incoming[1].numpy(), table)
        assert st.incoming[1].shape[1] == m.pairs.incoming[1].shape[1]


def _bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def test_stacked_init_and_step_bitwise_single_lanes():
    from repro_torch.sph.engine import cfl_timestep, f32, init_state, step
    specs = [_port("sedov",
                   scenario_params={"n_side": 5, "e0": e, "seed": s})
             for e, s in ((1.0, 0), (1.7, 1), (0.6, 2))]
    ms = _members(specs)
    cfg, nc, bucket = specs[0].physics, ms[0].gspec.ncells, 4
    pairs = lanes.stack_pair_list(ms[0].pairs, bucket, nc)
    order = ms + [ms[0]]
    st = lanes.lane_init(lanes.stack_cells([m.cells for m in order]), pairs,
                         cfg, lanes.lane_times([0.0] * bucket))
    dts = lanes.lane_cfl(st, cfg, bucket)
    st = lanes.lane_step(st, pairs, dts, 1.0, cfg)
    for i, m in enumerate(order):
        single = init_state(m.cells, m.pairs, cfg)
        dt = float(cfl_timestep(single, cfg))
        assert dts[i].item() == dt
        single = step(single, m.pairs, f32(dt, "cpu"), 1.0, cfg)
        lane = lanes.take_lane(st.cells, i, nc)
        for k in range(len(lane)):
            assert _bits(lane[k], single.cells[k]), (i, k)
        for name in ("accel", "dudt", "rho"):
            assert _bits(getattr(st, name)[i * nc:(i + 1) * nc],
                         getattr(single, name)), (i, name)
        assert _bits(st.time[i], single.time)


# ------------------------------------------------------- batched parity
HETERO = [("sedov", {"e0": 1.0, "seed": 0}), ("sedov", {"e0": 1.7, "seed": 1}),
          ("sedov", {"e0": 0.6, "seed": 2}),
          ("kelvin_helmholtz", {"v_shear": 0.5, "seed": 0}),
          ("kelvin_helmholtz", {"v_shear": 0.8, "seed": 3})]
STEPS = 3


@pytest.fixture(scope="module")
def hetero_fleets():
    """The reference's heterogeneous fleet served by both packages."""
    runner = _runner()
    reqs = [runner.submit(_port(s, scenario_params=p), n_steps=STEPS)
            for s, p in HETERO]
    runner.drain()
    ref = RefFleetRunner(fleet_devices=1)
    ref_reqs = [ref.submit(_spec(R, s, scenario_params=p), n_steps=STEPS)
                for s, p in HETERO]
    ref.drain()
    return runner, reqs, ref_reqs


def test_heterogeneous_fleet_bitwise_sequential(hetero_fleets):
    runner, reqs, _ = hetero_fleets
    _served_ok(reqs)
    assert all(r.result.batched for r in reqs)
    assert [(g["lanes"], g["bucket"]) for g in runner.groups] == \
        [(3, 4), (2, 2)]
    for r in reqs:
        _assert_bitwise(r.result, sequential_reference(r.spec, r.n_steps,
                                                       device="cpu"),
                        r.request_id)


def test_heterogeneous_fleet_matches_reference_fleet(hetero_fleets):
    _, reqs, ref_reqs = hetero_fleets
    _served_ok(ref_reqs)
    for r, q in zip(reqs, ref_reqs):
        assert r.spec.signature_key() == q.spec.signature_key()
        assert (r.result.batched, r.result.batch_size, r.result.bucket,
                r.result.steps) == (q.result.batched, q.result.batch_size,
                                    q.result.bucket, q.result.steps)
        for k in FIELDS:
            got = r.result.particles[k]
            want = np.asarray(q.result.particles[k])
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=f"{r.request_id}: {k}")
        assert r.result.t == pytest.approx(q.result.t, rel=1e-4)
        assert r.result.energy == pytest.approx(q.result.energy, rel=1e-4)


def _count_passes(monkeypatch):
    """Count the pair passes' wrapper calls (on the CPU the wrappers run
    the plain versions and count no launches)."""
    from repro_torch.kernels.sph_pair import ops
    calls = {"density": 0, "force": 0}

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(ops, "density_pair_cells",
                        counted("density", ops.density_pair_cells))
    monkeypatch.setattr(ops, "force_pair", counted("force", ops.force_pair))
    return calls


def test_heterogeneous_step_counts_and_passes(monkeypatch):
    """Members with different n_steps finish at their own horizon; the
    group runs one stacked init and one stacked pass per step and re-init:
    2·max(steps) passes, whatever the lane count."""
    calls = _count_passes(monkeypatch)
    runner = _runner()
    nsteps = [2, 4, 3]
    reqs = [runner.submit(_port("sedov", scenario_params={
                "n_side": 5, "e0": 1.0 + i, "seed": i}), n_steps=n)
            for i, n in enumerate(nsteps)]
    runner.drain()
    _served_ok(reqs)
    (g,) = runner.groups
    assert (g["steps"], g["passes"], g["fell_off"]) == (4, 8, 0)
    assert calls == {"density": 8, "force": 8}
    for r, n in zip(reqs, nsteps):
        assert r.result.steps == n
        _assert_bitwise(r.result, sequential_reference(r.spec, n,
                                                       device="cpu"))
    assert calls == {"density": 8 + sum(2 * n + 1 for n in nsteps),
                     "force": 8 + sum(2 * n + 1 for n in nsteps)}


def _converge(n_side=6, speed=0.0, seed=0):
    """A uniform lattice moving towards the centre of cell 0."""
    ic = P.uniform_ic(n_side, seed=seed)
    ic["vel"] = (-(ic["pos"] - 0.25) * speed).astype(np.float32)
    return ic


def test_lane_whose_capacity_grows_falls_off_bitwise(monkeypatch):
    """A lane whose re-bin outgrows the group's capacity finishes alone,
    bit for bit its single run; the others stay batched."""
    from repro_torch.fleet import signature as sig
    from repro_torch.sph import api
    monkeypatch.setitem(api.SCENARIOS, "converge_for_test", _converge)
    monkeypatch.setitem(sig.SHAPE_PARAM_KEYS, "converge_for_test",
                        ("n_side",))
    calls = _count_passes(monkeypatch)
    runner = _runner()
    reqs = [runner.submit(P.SimulationSpec(
                scenario="converge_for_test",
                scenario_params={"speed": s}, dt=0.01, capacity_margin=1.0),
                n_steps=3)
            for s in (0.0, 20.0, 0.5)]
    runner.drain()
    _served_ok(reqs)
    (g,) = runner.groups
    assert g["fell_off"] == 1 and runner.sequential_runs == 1
    assert [r.result.batched for r in reqs] == [True, False, True]
    assert calls["density"] == calls["force"] == \
        g["passes"] + g["fell_off_passes"]
    assert g["passes"] == 2 * g["steps"]
    for r in reqs:
        _assert_bitwise(r.result, sequential_reference(r.spec, r.n_steps,
                                                       device="cpu"),
                        r.request_id)


@pytest.mark.parametrize("kw", [
    dict(integrator="timebin", dt_max=0.02, max_depth=4),
    dict(physics={"use_pallas": True})])
def test_other_routes_served_sequentially(kw):
    spec = _port("sedov", **kw)
    runner = _runner()
    req = runner.submit(spec, n_steps=1)
    runner.drain()
    _served_ok([req])
    assert not req.result.batched and runner.sequential_runs == 1
    sim = P.build_simulation(spec, device="cpu")
    sim.step()
    assert req.result.energy == pytest.approx(sim.diagnostics()[0],
                                              rel=1e-6)


# --------------------------------------------------------- compile counts
def test_wobbling_arrivals_build_each_entry_point_once():
    """Waves of 3, 7, 5, 8: buckets 4 and 8, so the reference's two
    (step, cfl) entry-point pairs, each seeing one input signature."""
    runner = _runner()
    i = 0
    for wave in (3, 7, 5, 8):
        for _ in range(wave):
            runner.submit(_port("sedov", scenario_params={
                "n_side": 5, "seed": i, "e0": 1.0 + 0.01 * i}), n_steps=1)
            i += 1
        runner.drain()
    assert runner.queue.stats()["done"] == 23
    key = _spec(R, "sedov", scenario_params={"n_side": 5}).signature_key()
    shape = runner.groups[0]["shape_key"]
    assert runner.compile_counts() == {
        f"program:{(name, key, shape, b, 1)}": 1
        for b in (4, 8) for name in ("fleet_step", "fleet_cfl")}
    runner.assert_compile_discipline()
    assert set(runner.batcher.policy._bucket.values()) == {8}
    assert runner.stats()["padding_lanes"] == 1 + 1 + 3 + 0


def test_second_same_signature_fleet_builds_nothing():
    runner = _runner()
    for _ in range(2):
        for i in range(2):
            runner.submit(_port("kelvin_helmholtz",
                                scenario_params={"seed": i}), n_steps=1)
        runner.drain()
    assert runner.programs.builds == 2          # one step + one cfl
    runner.assert_compile_discipline()


# ------------------------------------------------------------------ trace
def test_trace_rows_named_by_request_id(tmp_path):
    from repro.observability.sinks import validate_chrome_trace
    runner = _runner(observe=True)
    reqs = [runner.submit(_port("sedov", scenario_params={"seed": i}),
                          n_steps=2) for i in range(2)]
    runner.drain()
    _served_ok(reqs)
    doc = runner.export_trace(str(tmp_path / "trace.json"))
    assert validate_chrome_trace(doc) == []
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    assert set(names.values()) == {r.request_id for r in reqs}
    slices = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(slices) == 4 and all(
        e["args"].get("request_id") in names.values() for e in slices)


# ---------------------------------------------------- terminal visibility
def test_expired_sweep_counts_traces_and_dumps(tmp_path):
    from repro.observability.flight import validate_bundle
    runner = _runner(observe=True, flight_dir=str(tmp_path))
    ok = runner.submit(_port("sedov"), n_steps=1)
    dead = runner.submit(_port("sedov"), n_steps=1, deadline=0.0)
    time.sleep(0.01)
    runner.drain()
    assert ok.state is RequestState.DONE
    assert dead.state is RequestState.EXPIRED
    assert runner.terminal_status == {"done": 1, "expired": 1}
    assert runner.stats()["terminal_status"] == runner.terminal_status
    spans = [s for s in runner.tracer.spans if s.name == "expired"]
    assert len(spans) == 1
    assert spans[0].attrs["request_id"] == dead.request_id
    assert "deadline" in spans[0].attrs["error"]
    assert len(runner.flight_dumps) == 1
    manifest = validate_bundle(runner.flight_dumps[0])
    assert manifest["reason"].startswith("expired")
    assert manifest["expired"] == [dead.request_id]


def test_no_flight_dump_without_flight_dir():
    runner = _runner()
    runner.submit(_port("sedov"), n_steps=1, deadline=0.0)
    time.sleep(0.01)
    runner.drain()
    assert runner.flight_dumps == []
    assert runner.terminal_status == {"expired": 1}


# ---------------------------------------------------- devices and the CLI
def test_fleet_devices_beyond_one_raise():
    with pytest.raises(ValueError, match="one card"):
        FleetRunner(fleet_devices=4, device="cpu")
    assert _runner(fleet_devices=1).fleet_devices == 1


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch.fleet.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetRunner()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--requests", "1"])


def test_cli_exits_zero_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    trace = tmp_path / "trace.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.fleet", "--device", "cpu",
         "--scenario", "mixed", "--requests", "6", "--steps", "2",
         "--waves", "2", "--check-parity",
         "--assert-compiles", "--trace-out", str(trace)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert '"mismatches": []' in res.stdout and trace.exists()
