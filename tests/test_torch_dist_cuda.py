"""The two distributed quadrants on the card.

**Global × distributed.**
Four ranks stacked on the one CUDA device, Sedov 10³ (4³ cells, C = 48):
each step launches ``density_pair_cells`` once and ``force_pair`` once for
all ranks' plan entries; the two halo schemes give the same bits; two runs
give the same bits; and the card's run equals the CPU's (the kernels'
plain versions, which tests/test_torch_distributed.py holds against the
JAX reference) within 1e-4 of each field's scale, as ``chip_smoke.py``'s
``card_vs_cpu`` phase holds the local paths.

**Time-bin × distributed**, Sedov 10³, 4 ranks, depth 4: a cycle launches
``density_pair_cells`` and ``force_pair`` once per rank per force
sub-step (``nranks × force_substeps`` each) and the block entry never; the
collective wire in both modes gives the host wire's bits; the run is bit
for bit the local ladder's on the card; and the card's run equals the
CPU's within 1e-4 of each field's scale, counts exactly. Traced
(``observe=True``) runs are bit for bit untraced ones, with the same
launches, on the local ladder and over the ranks.

This file imports no JAX, so it runs on the card as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels.sph_pair import kernel as K
from repro_torch.sph import SimulationSpec, SPHConfig, build_simulation
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def spec(halo: str = "ring", n_side: int = 10, ranks: int = 4):
    return SimulationSpec(scenario="sedov",
                          scenario_params={"n_side": n_side},
                          physics=SPHConfig(alpha_visc=1.0, cfl=0.15),
                          integrator="global", backend="distributed",
                          ranks=ranks, halo=halo, dt=1e-4)


def run(device, **kw):
    """Build, take STEPS steps; the final stacked state on the host."""
    sim = build_simulation(spec(**kw), device=device)
    for _ in range(STEPS):
        sim.step()
    e = sim.engine
    return [t.cpu() for t in tuple(e.dcells) + (e.accel, e.dudt, e.rho)]


def bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("halo", ["allgather", "ring"])
def test_cuda_dist_step_launches_each_pair_kernel_once(cuda_device, halo):
    sim = build_simulation(spec(halo), device=cuda_device)
    K.reset_launches()
    sim.step()
    assert (K.density_pair_cells.launches, K.force_pair.launches,
            K.density_pair.launches) == (1, 1, 0)


@pytest.mark.cuda
def test_cuda_allgather_equals_ring_and_runs_twice_bitwise(cuda_device):
    a = run(cuda_device, halo="allgather")
    b = run(cuda_device, halo="ring")
    c = run(cuda_device, halo="ring")
    assert bits_equal(a, b)
    assert bits_equal(b, c)


@pytest.mark.cuda
def test_cuda_matches_cpu(cuda_device):
    card, cpu = run(cuda_device), run("cpu")
    for x, y in zip(card, cpu):
        x, y = x.double().numpy(), y.double().numpy()
        scale = max(float(np.abs(y).max()), 1e-30)
        assert float(np.abs(x - y).max()) <= 1e-4 * scale


# ------------------------------------------------ time-bin × distributed
def tb_spec(n_side: int = 10, **kw):
    kw.setdefault("ranks", 4)
    return SimulationSpec(scenario="sedov",
                          scenario_params={"n_side": n_side},
                          physics=SPHConfig(alpha_visc=1.0, cfl=0.15),
                          integrator="timebin", backend="distributed",
                          max_depth=4, **kw)


def tb_run(device, cycles: int = 2, **kw):
    """Build, run ``cycles`` cycles; (stats, state fields on the host)."""
    sim = build_simulation(tb_spec(**kw), device=device)
    stats = [sim.step() for _ in range(cycles)]
    st = sim.state
    fields = [t.cpu() for t in tuple(st.cells) + tuple(st[1:])]
    return stats, fields


COUNT_KEYS = ("depth", "substeps", "force_substeps", "updates",
              "pair_tasks", "halo_exported_slots", "halo_full_slots")


@pytest.mark.cuda
def test_cuda_timebin_cycle_launch_counts(cuda_device):
    sim = build_simulation(tb_spec(), device=cuda_device)
    K.reset_launches()
    st = sim.step()
    n = 4 * st["force_substeps"]
    assert st["force_substeps"] > 1
    assert (K.density_pair_cells.launches, K.force_pair.launches,
            K.density_pair.launches) == (n, n, 0)


@pytest.mark.cuda
def test_cuda_timebin_wires_bitwise_and_local_ladder(cuda_device):
    sa, a = tb_run(cuda_device, transport="host")
    sb, b = tb_run(cuda_device, transport="collective",
                   transport_mode="ppermute")
    sc, c = tb_run(cuda_device, transport="collective",
                   transport_mode="allgather")
    assert bits_equal(a, b) and bits_equal(a, c)
    for x, y, z in zip(sa, sb, sc):
        assert [x[k] for k in COUNT_KEYS] == [y[k] for k in COUNT_KEYS] \
            == [z[k] for k in COUNT_KEYS]
    sim = build_simulation(tb_spec().with_(backend="local", ranks=None),
                           device=cuda_device)
    for _ in range(2):
        sim.step()
    st = sim.state
    assert bits_equal(a, [t.cpu() for t in tuple(st.cells) + tuple(st[1:])])


@pytest.mark.cuda
def test_cuda_timebin_matches_cpu(cuda_device):
    (sa, card), (sb, cpu) = tb_run(cuda_device), tb_run("cpu")
    for x, y in zip(sa, sb):
        assert [x[k] for k in COUNT_KEYS] == [y[k] for k in COUNT_KEYS]
    for x, y in zip(card, cpu):
        x, y = x.double().numpy(), y.double().numpy()
        scale = max(float(np.abs(y).max()), 1e-30)
        assert float(np.abs(x - y).max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["local", "distributed"])
def test_cuda_tracing_is_invisible(cuda_device, backend):
    """``observe=True`` on the card: the fences only wait, so the traced
    ladder is bit for bit the untraced one, with the same pair-kernel
    launches (and, distributed, the same program signatures); the traced
    distributed run passes ``python -m repro_torch.observability``'s
    checks."""
    from repro_torch.observability.__main__ import check_run
    spec = tb_spec(transport="collective")
    if backend == "local":
        spec = spec.with_(backend="local", ranks=None)
    runs = []
    for observe in (False, True):
        sim = build_simulation(spec.with_(observe=observe),
                               device=cuda_device)
        K.reset_launches()
        for _ in range(2):
            sim.step()
        st = sim.state
        runs.append((sim, [t.cpu() for t in tuple(st.cells) + tuple(st[1:])],
                     (K.density_pair_cells.launches, K.force_pair.launches)))
    (plain, a, la), (traced, b, lb) = runs
    assert bits_equal(a, b) and la == lb and la[1] > 0
    if backend == "distributed":
        assert traced.engine.probe.counts() == plain.engine.probe.counts()
        doc = traced.observer.export_chrome_trace(os.devnull)
        assert check_run(traced, doc, 4, 2) == []
