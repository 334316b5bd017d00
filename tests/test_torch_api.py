"""The port's front door and its isolation from the reference.

* ``SimulationSpec`` and ``SPHConfig`` have exactly the reference's fields
  and defaults, so one spec means the same run in both packages.
* Entry points run on the CUDA device unless told otherwise, and raise
  without one; all four quadrants build; ``observe`` coerces as the
  reference's does.
* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of
  the reference package ``repro`` (the training modules included).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.sph as R
import repro_torch.sph as P
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = type(f.default_factory())
        else:
            out[f.name] = None
    return out


def test_spec_fields_equal_reference():
    ref, port = _fields(R.SimulationSpec), _fields(P.SimulationSpec)
    assert list(port) == list(ref)
    for k in ref:
        if k == "physics":
            continue
        assert port[k] == ref[k], k
    assert _fields(P.SPHConfig) == _fields(R.SPHConfig)


def test_spec_validates_like_reference():
    for bad in (dict(integrator="leapfrog"), dict(backend="mpi"),
                dict(scenario="nope"), dict(halo="tree"),
                dict(residency="device"), dict(schedule="device"),
                dict(segment_cycles=0)):
        with pytest.raises(ValueError):
            R.SimulationSpec(**bad)
        with pytest.raises(ValueError):
            P.SimulationSpec(**bad)


def test_frozen_params_canonical():
    a = P.SimulationSpec(scenario_params={"n_side": 6, "e0": 1.0})
    b = P.SimulationSpec(scenario_params={"e0": 1.0, "n_side": 6})
    assert a == b and hash(a) == hash(b)
    assert dict(a.scenario_params) == {"e0": 1.0, "n_side": 6}
    assert a.with_(dt=0.1).dt == 0.1


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    spec = P.SimulationSpec(scenario="uniform", scenario_params={"n_side": 4})
    with pytest.raises(RuntimeError, match="CUDA"):
        P.build_simulation(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.build_simulation(spec.with_(integrator="timebin"))


@pytest.mark.parametrize("integrator", ["global", "timebin"])
def test_distributed_backends_raise(integrator):
    """Both distributed quadrants are ported: each raises only where the
    card is asked for and absent, and runs on the CPU when asked to."""
    spec = P.SimulationSpec(scenario="uniform", scenario_params={"n_side": 4},
                            integrator=integrator, backend="distributed",
                            dt=1e-3, dt_max=2e-3, max_depth=2, ranks=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.build_simulation(spec)
    sim = P.build_simulation(spec, device="cpu")
    sim.step()
    e, p = sim.diagnostics()
    assert np.isfinite(e) and np.all(np.isfinite(p))
    cells = sim.state if integrator == "global" else sim.state.cells
    assert cells.pos.device.type == "cpu"
    assert all(bool(torch.isfinite(t).all()) for t in cells)


def test_observe_coerces_like_reference():
    """``observe`` takes a bool, a mapping of ``ObserveSpec`` fields or an
    ``ObserveSpec``, and coerces them as the reference does; anything else
    is the reference's ``ValueError``."""
    from repro.observability import ObserveSpec as RObs
    from repro_torch.observability import ObserveSpec as PObs
    assert [f.name for f in dataclasses.fields(PObs)] \
        == [f.name for f in dataclasses.fields(RObs)]
    for ob in (False, True, {"trace": False}, {"flight_dir": "x",
                                               "flight_cycles": 3}):
        got = P.SimulationSpec(observe=ob).observe
        want = R.SimulationSpec(observe=ob).observe
        assert isinstance(got, PObs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ospec = PObs(enabled=True, device_metrics=False)
    assert P.SimulationSpec(observe=ospec).observe is ospec
    for bad in (3.14, "yes", None):
        with pytest.raises(ValueError, match="observe") as got:
            P.SimulationSpec(observe=bad)
        with pytest.raises(ValueError, match="observe") as want:
            R.SimulationSpec(observe=bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("integrator", ["global", "timebin"])
def test_build_and_run_on_cpu(integrator):
    spec = P.SimulationSpec(scenario="uniform", scenario_params={"n_side": 4},
                            integrator=integrator, dt=1e-3, dt_max=2e-3,
                            max_depth=2)
    sim = P.build_simulation(spec, device="cpu")
    log = sim.run(2e-3)
    assert log["t"][-1] >= 2e-3 * (1 - 1e-5)
    e, p = sim.diagnostics()
    assert np.isfinite(e) and np.all(np.isfinite(p))
    assert sim.state.cells.pos.device.type == "cpu"


def test_custom_scenario_registry():
    @P.register_scenario("tiny_uniform_for_test")
    def _tiny(**kw):
        return P.uniform_ic(3, **kw)
    ic = P.make_ic("tiny_uniform_for_test", seed=2)
    assert ic["pos"].shape == (27, 3)
    with pytest.raises(KeyError):
        P.make_ic("not_registered")


_ISOLATION = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
for m in ("repro_torch.distributed.transport", "repro_torch.sph.collectives",
          "repro_torch.sph.dist_timebins", "repro_torch.sph.adaptive",
          "repro_torch.observability.metrics",
          "repro_torch.observability.sinks",
          "repro_torch.observability.device_metrics",
          "repro_torch.observability.flight",
          "repro_torch.observability.costs",
          "repro_torch.observability.observer",
          "repro_torch.observability.__main__",
          "repro_torch.analysis.report", "repro_torch.analysis.roofline",
          "repro_torch.fleet", "repro_torch.fleet.signature",
          "repro_torch.fleet.queue", "repro_torch.fleet.batcher",
          "repro_torch.fleet.lanes", "repro_torch.fleet.runner",
          "repro_torch.fleet.__main__",
          "repro_torch.configs.seamless_m4t_large_v2",
          "repro_torch.configs.internvl2_2b",
          "repro_torch.models.moe", "repro_torch.configs.mixtral_8x7b",
          "repro_torch.configs.mixtral_8x22b",
          "repro_torch.train", "repro_torch.train.optimizer",
          "repro_torch.train.data", "repro_torch.train.checkpoint",
          "repro_torch.train.train_step", "repro_torch.train.loop",
          "repro_torch.launch.train", "repro_torch.distributed.compression",
          "repro_torch.kernels.flash_attention.ops"):
    assert m in sys.modules, m
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "repro" or k.startswith("repro.")
             or k == "ml_dtypes" or k.startswith("ml_dtypes."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = _ISOLATION.format(src=os.path.join(ROOT, "src"), root=ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
