"""Strong-scaling experiment (paper Figs. 5/6/8 at laptop scale), on the
PyTorch/CUDA port's planning library.

Sweeps rank counts over the clustered task graph and prints the speed-up
and parallel-efficiency columns for async (SWIFT) vs bulk-synchronous
execution — CSV ready for plotting. The claim is a property of the
*schedule*: with task-based decomposition, work-balanced partitioning and
asynchronous communication, parallel efficiency stays high across the
sweep while the bulk-synchronous baseline falls away. The executor is the
discrete-event simulation of ``repro_torch.core`` over the real task graph
of a clustered-IC SPH step, per-task costs in seconds (2 ns an
interaction), paper-era network parameters (1.5 µs latency, 5 GB/s).

The sweep is host planning (numpy) by nature: it launches nothing on a
device. ``--device`` is resolved as every entry point of the port resolves
it (the CUDA device unless ``--device cpu``), and the clustered IC's cell
occupancy is binned there and checked against the refined graph's.

Run:  python examples_torch/sph_strong_scaling.py [n_particles]
      [--ranks 1,2,4,...] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

PHASES = {"sort": "p0", "density_self": "p1", "density_pair": "p1",
          "ghost": "p2", "force_self": "p3", "force_pair": "p3",
          "kick": "p4", "send": "comm", "recv": "comm"}


def clustered_taskgraph(n_particles, seed=0, *, base_side=6, threshold=48,
                        rate=2e-9):
    """Clustered-IC task graph over the §3.1-refined (split) cell set:
    (task graph, leaves, per-leaf occupancy, the IC). Costs are seconds
    (``rate`` s an interaction)."""
    from repro_torch.core import TaskGraph
    from repro_torch.sph import clustered_ic
    from repro_torch.sph.adaptive import refined_cell_graph

    ic = clustered_ic(n_particles, seed=seed)
    _node_w, edges, leaves = refined_cell_graph(
        ic["pos"], ic["box"], base_side, threshold=threshold, max_levels=5)
    n_ngb = 48.0
    g = TaskGraph()
    occ = np.array([leaf.occupancy for leaf in leaves], dtype=np.int64)

    def self_cost(o):
        return rate * min(0.5 * o * o, n_ngb * o)

    def pair_cost(a, b):
        return rate * min(a * b, n_ngb * min(a, b))

    def per_cell(kind, scale):
        return [g.add_task(kind, resources=(c,), writes=(c,),
                           cost=max(rate * scale * occ[c], 1e-9))
                for c in range(len(leaves))]

    sort, ghost, kick = (per_cell("sort", 2), per_cell("ghost", 1),
                         per_cell("kick", 1))
    for c in range(len(leaves)):
        d = g.add_task("density_self", resources=(c,), writes=(c,),
                       cost=max(self_cost(occ[c]), 1e-9))
        f = g.add_task("force_self", resources=(c,), writes=(c,),
                       cost=max(self_cost(occ[c]), 1e-9))
        g.add_dependency(d, sort[c])
        g.add_dependency(ghost[c], d)
        g.add_dependency(f, ghost[c])
        g.add_dependency(kick[c], f)
    for (a, b), _w in edges.items():
        d = g.add_task("density_pair", resources=(a, b), writes=(a, b),
                       cost=max(pair_cost(occ[a], occ[b]), 1e-9))
        f = g.add_task("force_pair", resources=(a, b), writes=(a, b),
                       cost=max(pair_cost(occ[a], occ[b]), 1e-9))
        for c in (a, b):
            g.add_dependency(d, sort[c])
            g.add_dependency(ghost[c], d)
            g.add_dependency(f, ghost[c])
            g.add_dependency(kick[c], f)
    return g, len(leaves), occ, ic


def run(n_particles, ranks_list, dev, threads=2):
    """One row a (ranks, mode): makespan (µs) and parallel efficiency
    against the async makespan at the first rank count."""
    import torch
    from repro_torch.core import AsyncExecutorSim, decompose_with_comm
    from repro_torch.sph.cellgrid import bin_particles, choose_grid

    g, ncells, occupancy, ic = clustered_taskgraph(n_particles)
    # the IC binned on the device: every particle lands in a cell
    spec = choose_grid(ic["box"], float(ic["h"].max()), n_particles)
    cells, _ = bin_particles(spec, ic["pos"], ic["vel"], ic["mass"], ic["u"],
                             ic["h"], device=dev)
    binned = int(cells.mask.sum())
    assert binned == n_particles == int(occupancy.sum()), \
        (binned, n_particles, int(occupancy.sum()))
    del cells
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cell_bytes = [float(max(o, 1)) * 64.0 for o in occupancy]
    rows = []
    t1 = None
    for ranks in ranks_list:
        if ranks == 1:
            dist = g
            for t in dist.tasks.values():
                object.__setattr__(t, "rank", 0)
        else:
            dist, _ = decompose_with_comm(g, ncells, ranks,
                                          cell_bytes=cell_bytes,
                                          phases=PHASES)
        kw = dict(ranks=ranks, threads=threads, latency=1.5e-6,
                  bandwidth=5e9)
        m_async = AsyncExecutorSim(dist, **kw).run()
        m_sync = AsyncExecutorSim(dist, synchronous=True, **kw).run()
        if t1 is None:
            t1 = m_async.makespan        # serial-ish reference at ranks=1
        for mode, m in (("async", m_async), ("sync", m_sync)):
            rows.append((ranks, mode, round(m.makespan * 1e6, 1),
                         min(t1 / (m.makespan * ranks), 1.0)))
    return rows, ncells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_particles", nargs="?", type=int, default=8000)
    ap.add_argument("--ranks", default="1,2,4,8,16,32,64,128",
                    help="comma-separated rank counts")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    ranks_list = tuple(int(r) for r in args.ranks.split(","))
    rows, ncells = run(args.n_particles, ranks_list, dev)
    print(f"{args.n_particles} particles, {ncells} leaf cells, binned on "
          f"{dev}")
    print("\nranks,mode,makespan_us,efficiency")
    for ranks, mode, us, eff in rows:
        print(f"{ranks},{mode},{us},{eff:.3f}")


if __name__ == "__main__":
    main()
