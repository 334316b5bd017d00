"""Port parity: the port's copy of ``core/`` against the reference's.

``repro_torch.core`` is host-side planning in numpy, a whole copy of
``repro.core``: the same inputs must give the same task graphs, partitions
(the same ``np.random.Generator`` draws in the same order), communication
plans and schedules, exactly. ``build_taskgraph`` (``sph/engine.py``) is
held to the reference's on Sedov 6³ and 8³ cell grids, with the time-bin
keywords too.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as PC
from repro.sph.cellgrid import bin_particles as ref_bin
from repro.sph.cellgrid import build_pair_list as ref_pairs
from repro.sph.cellgrid import choose_grid as ref_grid
from repro.sph.engine import build_taskgraph as ref_build_taskgraph
from repro_torch.sph.cellgrid import bin_particles, build_pair_list, \
    choose_grid
from repro_torch.sph.engine import build_taskgraph
from repro_torch.sph.ic import sedov_ic
from torch_threads import one_torch_thread  # noqa: F401

MODULES = ("taskgraph", "scheduler", "partition", "cost_model",
           "comm_planner", "decompose")


@pytest.mark.parametrize("name", MODULES)
def test_core_modules_are_whole_copies(name):
    """Each module is the reference's source, line for line."""
    ref = importlib.import_module(f"repro.core.{name}")
    port = importlib.import_module(f"repro_torch.core.{name}")
    assert inspect.getsource(port) == inspect.getsource(ref)


def test_core_exports_equal_reference():
    assert PC.__all__ == RC.__all__


def _grids(n_side: int):
    """The reference's and the port's grid, pair list and occupancy for
    Sedov ``n_side``³ (``capacity_margin=3.0``, the spec's default)."""
    ic = sedov_ic(n_side, seed=0)
    args = (ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"])
    hmax = float(ic["h"].max())
    rs = ref_grid(ic["box"], hmax, len(ic["pos"]), capacity_margin=3.0)
    ps = choose_grid(ic["box"], hmax, len(ic["pos"]), capacity_margin=3.0)
    rc, _ = ref_bin(rs, *args)
    pc, _ = bin_particles(ps, *args, device="cpu")
    ref = (rs, ref_pairs(rs), np.asarray(rc.mask.sum(axis=1)))
    port = (ps, build_pair_list(ps), pc.mask.sum(1))
    return ref, port


def _tasks(g):
    return [(t.tid, t.kind, t.resources, t.writes, t.cost, t.rank,
             t.payload, t.active, sorted(g.dependencies(t.tid)),
             sorted(g.dependents(t.tid)), sorted(g.conflicts(t.tid)))
            for t in g.tasks.values()]


def _taskgraph_kwargs(variant: str, ncells: int):
    rng = np.random.default_rng(ncells)
    if variant == "plain":
        return {}
    if variant == "level":
        return dict(cell_bins=rng.integers(-1, 4, ncells), level=2)
    return dict(occupancy_by_bin=rng.integers(0, 5, (ncells, 4)),
                time_average=True)


@pytest.mark.parametrize("variant", ["plain", "level", "time_average"])
@pytest.mark.parametrize("n_side", [6, 8])
def test_build_taskgraph_matches_reference(n_side, variant):
    (rs, rp, rocc), (ps, pp, pocc) = _grids(n_side)
    kw = _taskgraph_kwargs(variant, rs.ncells)
    ref = ref_build_taskgraph(rs, rp, rocc, **kw)
    port = build_taskgraph(ps, pp, pocc, **kw)
    assert _tasks(port) == _tasks(ref)
    assert port.cell_graph() == ref.cell_graph()
    assert port.total_cost() == ref.total_cost()
    assert port.critical_path() == ref.critical_path()


def _random_graph(mod, n=150, radius=0.2, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3))
    edges = {}
    for i in range(n):
        d = np.linalg.norm(pos - pos[i], axis=1)
        for j in np.nonzero((d < radius) & (np.arange(n) > i))[0]:
            edges[(i, int(j))] = 1.0 / (d[j] + 1e-3)
    return mod.Graph.from_edges(n, edges, rng.random(n) + 0.1), pos


def _same_result(a, b):
    np.testing.assert_array_equal(a.assignment, b.assignment)
    assert a.nparts == b.nparts
    assert a.edge_cut == b.edge_cut
    np.testing.assert_array_equal(a.part_loads, b.part_loads)
    assert a.imbalance == b.imbalance


@pytest.mark.parametrize("nparts", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_graph_matches_reference(seed, nparts):
    gr, _ = _random_graph(RC, seed=seed)
    gp, _ = _random_graph(PC, seed=seed)
    _same_result(PC.partition_graph(gp, nparts, seed=seed),
                 RC.partition_graph(gr, nparts, seed=seed))


@pytest.mark.parametrize("nranks", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompose_cells_matches_reference(seed, nranks):
    (rs, rp, rocc), (ps, pp, pocc) = _grids(10)
    rg = ref_build_taskgraph(rs, rp, rocc)
    pg = build_taskgraph(ps, pp, pocc)
    ref = RC.decompose_cells(rg, rs.ncells, nranks, seed=seed)
    port = PC.decompose_cells(pg, ps.ncells, nranks, seed=seed)
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    _same_result(port.partition, ref.partition)


def test_evaluate_and_geometric_match_reference():
    gr, pos = _random_graph(RC, seed=3)
    gp, _ = _random_graph(PC, seed=3)
    part = np.random.default_rng(4).integers(0, 5, gr.n)
    _same_result(PC.evaluate(gp, part, 5), RC.evaluate(gr, part, 5))
    for k in (2, 3, 8):
        np.testing.assert_array_equal(PC.partition_geometric(pos, k),
                                      RC.partition_geometric(pos, k))


def _comm_stats(s):
    return (s.messages, s.total_bytes, s.per_pair, s.per_pair_bytes,
            s.mean_message_bytes)


@pytest.mark.parametrize("nranks", [2, 4])
def test_comm_planner_matches_reference(nranks):
    (rs, rp, rocc), (ps, pp, pocc) = _grids(8)
    nc = rs.ncells
    cell_bytes = [64.0 * (1 + c % 3) for c in range(nc)]
    phases = {"density_pair": "density", "force_pair": "force"}
    rdist, rdec = RC.decompose_with_comm(ref_build_taskgraph(rs, rp, rocc),
                                         nc, nranks, cell_bytes=cell_bytes,
                                         phases=phases)
    pdist, pdec = PC.decompose_with_comm(build_taskgraph(ps, pp, pocc), nc,
                                         nranks, cell_bytes=cell_bytes,
                                         phases=phases)
    np.testing.assert_array_equal(pdec.assignment, rdec.assignment)
    assert _comm_stats(pdec.comm) == _comm_stats(rdec.comm)
    assert _tasks(pdist) == _tasks(rdist)
    _, edges = rdist.cell_graph()
    freq = np.linspace(0.1, 1.0, nc)
    for f in (None, freq):
        assert _comm_stats(PC.pairwise_stats_from_partition(
            edges, pdec.assignment, cell_bytes, f)) == _comm_stats(
            RC.pairwise_stats_from_partition(edges, rdec.assignment,
                                             cell_bytes, f))
    rng = np.random.default_rng(nranks)
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 6, (30, 2))
             if a != b]
    assert PC.ppermute_rounds(pairs, 6) == RC.ppermute_rounds(pairs, 6)
    for radius in (1, 2):
        assert (PC.plan_halo_1d(axis="x", radius=radius).perms(5)
                == RC.plan_halo_1d(axis="x", radius=radius).perms(5))


def _sim_result(r):
    return (r.makespan, r.per_rank_busy, r.per_rank_idle, r.messages,
            r.message_bytes, r.ranks, r.threads, r.timeline)


@pytest.mark.parametrize("synchronous", [False, True])
def test_scheduler_matches_reference(synchronous):
    (rs, rp, rocc), (ps, pp, pocc) = _grids(6)
    rg = ref_build_taskgraph(rs, rp, rocc)
    pg = build_taskgraph(ps, pp, pocc)
    assert rg.auto_conflicts() == pg.auto_conflicts()
    for by_kind in (True, False):
        assert (PC.wave_schedule(pg, by_kind=by_kind)
                == RC.wave_schedule(rg, by_kind=by_kind))
    costs = [t.cost for t in rg.tasks.values()]
    assert PC.balance_wave(costs, 4) == RC.balance_wave(costs, 4)
    assert PC.makespan_lower_bound(pg, 4) == RC.makespan_lower_bound(rg, 4)
    # the executor simulation of a 2-rank decomposition with its comm tasks
    cell_bytes = [128.0] * rs.ncells
    rdist, _ = RC.decompose_with_comm(rg, rs.ncells, 2, cell_bytes=cell_bytes)
    pdist, _ = PC.decompose_with_comm(pg, ps.ncells, 2, cell_bytes=cell_bytes)
    kw = dict(ranks=2, threads=2, synchronous=synchronous,
              record_timeline=True)
    assert (_sim_result(PC.AsyncExecutorSim(pdist, **kw).run())
            == _sim_result(RC.AsyncExecutorSim(rdist, **kw).run()))


def test_timebin_graphs_and_decompose_helpers_match_reference():
    (rs, rp, rocc), (ps, pp, pocc) = _grids(8)
    nc = rs.ncells
    rng = np.random.default_rng(7)
    obb = rng.integers(0, 6, (nc, 4))
    bins = rng.integers(-1, 4, nc)
    rg = ref_build_taskgraph(rs, rp, rocc, cell_bins=bins, level=2)
    pg = build_taskgraph(ps, pp, pocc, cell_bins=bins, level=2)
    assert (PC.wave_schedule(pg, active_only=True)
            == RC.wave_schedule(rg, active_only=True))
    one_rank = np.zeros(nc, np.int64)
    kw = dict(ranks=1, threads=3, active_only=True)
    assert (_sim_result(PC.AsyncExecutorSim(
        PC.assign_tasks(pg, one_rank), **kw).run())
        == _sim_result(RC.AsyncExecutorSim(
            RC.assign_tasks(rg, one_rank), **kw).run()))
    np.testing.assert_array_equal(PC.timebin_node_weights(obb),
                                  RC.timebin_node_weights(obb))
    part = rng.integers(0, 3, nc)
    np.testing.assert_array_equal(PC.rank_bin_occupancy(part, obb, 3),
                                  RC.rank_bin_occupancy(part, obb, 3))
    assert (PC.bin_occupancy_imbalance(part, obb, 3)
            == RC.bin_occupancy_imbalance(part, obb, 3))
    ref = RC.decompose_cells(rg, nc, 3, occupancy_by_bin=obb)
    port = PC.decompose_cells(pg, nc, 3, occupancy_by_bin=obb)
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    costs = list(rng.random(12) + 0.5)
    for contiguous in (True, False):
        np.testing.assert_array_equal(
            PC.decompose_layers(costs, 3, contiguous=contiguous),
            RC.decompose_layers(costs, 3, contiguous=contiguous))


def test_cost_model_matches_reference():
    rcm, pcm = RC.CostModel(rates={}), PC.CostModel(rates={})
    for kind in ("sort", "ghost", "kick", "density_self", "density_pair",
                 "force_self", "force_pair"):
        for n, m in ((1, 0), (37, 0), (12, 40)):
            assert pcm.units(kind, n, m) == rcm.units(kind, n, m)
        occ = [3, 0, 5, 2]
        assert (pcm.timebin_units(kind, occ, occ[::-1], max_bin=3)
                == rcm.timebin_units(kind, occ, occ[::-1], max_bin=3))
    for cm in (rcm, pcm):
        cm.update("density_pair", 40, 40, 2e-4)
        cm.observe("force_pair", 1000.0, 3e-4)
    assert pcm.measured_vs_modelled() == rcm.measured_vs_modelled()
    seq = dict(batch=2, seq=64, d_model=256)
    for fn, kw in (("attention_cost", dict(batch=2, q_len=64, kv_len=64,
                                           d_model=256, n_heads=4, n_kv=2,
                                           head_dim=64, window=32)),
                   ("mlp_cost", dict(seq, d_ff=1024)),
                   ("moe_cost", dict(seq, d_ff=512, num_experts=8,
                                     top_k=2)),
                   ("mamba_cost", dict(seq, d_state=16))):
        assert (dataclasses.astuple(getattr(PC, fn)(**kw))
                == dataclasses.astuple(getattr(RC, fn)(**kw))), fn
    assert PC.model_flops_6nd(1e9, 1e6) == RC.model_flops_6nd(1e9, 1e6)
    assert PC.model_flops_2nd(1e9, 1e6) == RC.model_flops_2nd(1e9, 1e6)
    assert (PC.cell_activation_frequency([1, 2, 3], 2)
            == RC.cell_activation_frequency([1, 2, 3], 2))
