"""SWIFT's three contributions as a composable library: the port's copy.

C1: task-based parallelism  -> taskgraph, scheduler
C2: graph-partition domain decomposition -> partition, decompose
C3: fully asynchronous communication -> comm_planner (+ sph/distributed)

Host-side planning in numpy and the standard library, as in the reference:
each module is a whole copy of its counterpart in ``repro.core``, so the
same inputs give the same task graphs, assignments and schedules (the same
``np.random.Generator`` draws in the same order). The port keeps its own
copy rather than importing the reference.
"""

from .taskgraph import Task, TaskGraph, TaskGraphError
from .scheduler import (AsyncExecutorSim, SimResult, balance_wave,
                        makespan_lower_bound, wave_schedule)
from .partition import (Graph, PartitionResult, evaluate, partition_geometric,
                        partition_graph)
from .cost_model import (CostModel, LayerCost, attention_cost,
                         cell_activation_frequency, mamba_cost, mlp_cost,
                         moe_cost, model_flops_2nd, model_flops_6nd,
                         timebin_frequency)
from .comm_planner import (CommStats, HaloPlan, insert_comm_tasks,
                           pairwise_stats_from_partition, plan_halo_1d,
                           ppermute_rounds)
from .decompose import (Decomposition, assign_tasks, bin_occupancy_imbalance,
                        decompose_cells, decompose_layers,
                        decompose_with_comm, rank_bin_occupancy,
                        timebin_node_weights)

__all__ = [
    "Task", "TaskGraph", "TaskGraphError",
    "AsyncExecutorSim", "SimResult", "balance_wave", "makespan_lower_bound",
    "wave_schedule",
    "Graph", "PartitionResult", "evaluate", "partition_geometric",
    "partition_graph",
    "CostModel", "LayerCost", "attention_cost", "cell_activation_frequency",
    "mamba_cost", "mlp_cost", "moe_cost", "model_flops_2nd",
    "model_flops_6nd", "timebin_frequency",
    "CommStats", "HaloPlan", "insert_comm_tasks",
    "pairwise_stats_from_partition", "plan_halo_1d", "ppermute_rounds",
    "Decomposition", "assign_tasks", "bin_occupancy_imbalance",
    "decompose_cells", "decompose_layers", "decompose_with_comm",
    "rank_bin_occupancy", "timebin_node_weights",
]
