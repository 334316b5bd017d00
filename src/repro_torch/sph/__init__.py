"""SPH substrate of the port: physics, cell grid, engines, API.

Enter through ``SimulationSpec`` + ``build_simulation`` (``api.py``), as
in the reference; ``build_simulation(..., device=None)`` runs on the CUDA
device and raises if there is none, ``device="cpu"`` runs the plain
PyTorch path. The global × distributed engine
(``distributed.DistSimulation``) stacks its ranks on that one device; the
time-bin × distributed engine (``dist_timebins.DistTimeBinSimulation``)
keeps one extended state per rank on it.
"""

from .api import (SCENARIOS, FrozenParams, SimulationSpec, build_simulation,
                  make_ic, register_scenario)
from .cellgrid import (GridSpec, PairList, ParticleCells, bin_particles,
                       build_pair_list, choose_grid, unbin)
from .dist_timebins import (DistTimeBinSimulation, build_rank_plan,
                            halo_export_schedule)
from .distributed import (DistPlan, DistSimulation, build_dist_plan,
                          make_dist_step)
from .engine import (SPHConfig, SPHState, Simulation, build_taskgraph,
                     cfl_timestep, cfl_timestep_particles,
                     compute_accelerations, init_state, step)
from .ic import clustered_ic, kelvin_helmholtz_ic, sedov_ic, uniform_ic
from .physics import (GAMMA, cfl_timestep_block, density_block, eos_pressure,
                      force_block, ghost_update, smoothing_length_update,
                      sound_speed)
from .smoothing import dw_dh, get_kernel, w_cubic, w_wendland_c2
from .timebins import (TimeBinSimulation, TimeBinState, active_level,
                       assign_bins, bin_timestep, timebin_init)

__all__ = [
    "SCENARIOS", "FrozenParams", "SimulationSpec", "build_simulation",
    "make_ic", "register_scenario",
    "GridSpec", "PairList", "ParticleCells", "bin_particles",
    "build_pair_list", "choose_grid", "unbin",
    "DistTimeBinSimulation", "build_rank_plan", "halo_export_schedule",
    "DistPlan", "DistSimulation", "build_dist_plan", "make_dist_step",
    "SPHConfig", "SPHState", "Simulation", "build_taskgraph", "cfl_timestep",
    "cfl_timestep_particles", "compute_accelerations", "init_state", "step",
    "clustered_ic", "kelvin_helmholtz_ic", "sedov_ic", "uniform_ic",
    "GAMMA", "cfl_timestep_block", "density_block", "eos_pressure",
    "force_block", "ghost_update", "smoothing_length_update", "sound_speed",
    "dw_dh", "get_kernel", "w_cubic", "w_wendland_c2",
    "TimeBinSimulation", "TimeBinState", "active_level", "assign_bins",
    "bin_timestep", "timebin_init",
]
