"""Fleet serving on the card.

A batch of four Sedov 10³ requests (different blast energies and seeds,
one signature) served as lanes on the CUDA device: each request is bit for
bit the same spec run alone on the card (``sequential_reference``); each
pair kernel launches ``2·steps`` times for the shape group (one stacked
init, ``steps − 1`` stacked re-inits, ``steps`` batched steps), whatever
its lanes, against ``2·steps + 1`` per request run alone; and the card's
fleet equals the CPU's (the plain versions, which
tests/test_torch_fleet.py holds against the JAX reference) within 1e-4 of
each field's scale, as ``chip_smoke.py``'s ``card_vs_cpu`` phases hold the
engines.

This file imports no JAX, so it runs on the card as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.fleet import FleetRunner, sequential_reference
from repro_torch.kernels.sph_pair import kernel as K
from repro_torch.sph import SimulationSpec, SPHConfig
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 3
LANES = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def specs(n_side: int = 10):
    return [SimulationSpec(scenario="sedov",
                           scenario_params={"n_side": n_side, "seed": i,
                                            "e0": 1.0 + 0.1 * i},
                           physics=SPHConfig(alpha_visc=1.0, cfl=0.15))
            for i in range(LANES)]


def serve(device):
    runner = FleetRunner(device=device)
    reqs = [runner.submit(s, n_steps=STEPS) for s in specs()]
    runner.drain()
    assert all(r.result is not None and r.result.batched for r in reqs), \
        [(r.request_id, r.error) for r in reqs]
    return runner, reqs


def launches():
    return (K.density_pair_cells.launches, K.force_pair.launches,
            K.density_pair.launches)


@pytest.mark.cuda
def test_cuda_lanes_bitwise_single_runs_and_launch_counts(cuda_device):
    K.reset_launches()
    runner, reqs = serve(cuda_device)
    (group,) = runner.groups
    assert (group["lanes"], group["bucket"], group["steps"]) == \
        (LANES, LANES, STEPS)
    assert launches() == (2 * STEPS, 2 * STEPS, 0)
    runner.assert_compile_discipline()
    K.reset_launches()
    for r in reqs:
        ref = sequential_reference(r.spec, STEPS, device=cuda_device)
        for k, a in r.result.particles.items():
            assert a.tobytes() == ref.particles[k].tobytes(), \
                (r.request_id, k)
        assert r.result.t == ref.t
    n = (2 * STEPS + 1) * LANES
    assert launches() == (n, n, 0)


@pytest.mark.cuda
def test_cuda_fleet_matches_cpu(cuda_device):
    _, card = serve(cuda_device)
    _, cpu = serve("cpu")
    for a, b in zip(card, cpu):
        for k, x in a.result.particles.items():
            y = b.result.particles[k].astype(np.float64)
            scale = max(float(np.abs(y).max()), 1e-30)
            assert float(np.abs(x - y).max()) <= 1e-4 * scale, \
                (a.request_id, k)
