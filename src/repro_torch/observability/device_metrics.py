"""Telemetry rows of the single-host ladder (numpy copy of the host-side
pieces of ``repro.observability.device_metrics``).

Two fixed-shape buffers per rank: ``counts`` (sub-step executions, active
particles per phase, live pair counts, exchange slots, deepening / wake
events, health sentinel trips) and ``values`` (per-phase work units and a
state fingerprint), plus per-cell work vectors. The single-host ladder
builds them from host scalars it already holds. The in-program builders
(``measure_substep``, ``measure_cells``) wait for the distributed slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DEVICE_METRICS_VERSION = 2

COUNT_COLUMNS: Tuple[str, ...] = (
    "substeps",         # sub-step program executions folded into this row
    "drift_active",     # particles drifted (alive mask count)
    "density_active",   # particles active in the density phase
    "force_active",     # particles kicked in the force phase
    "pair_int",         # live interior pair blocks
    "pair_cut",         # live cut (halo-crossing) pair blocks
    "exch_slots",       # halo slots shipped across both exchanges
    "exch_bytes",       # bytes moved through the exchanges
    "deepen_events",    # owned rows whose time bin deepened mid-cycle
    "wake_events",      # cells woken above the current ladder level
    "flag_nan",         # sub-steps on which any state value went NaN
    "flag_inf",         # ... or infinite
    "flag_neg_rho",     # ... or produced a non-positive density
)
VALUE_COLUMNS: Tuple[str, ...] = (
    "density_units",    # live pair blocks worked in the density phase
    "force_units",      # live pair blocks worked in the force phase
    "exchange_units",   # shipped halo slots (send/recv work units)
    "kick_units",       # particles integrated by the kick
    "energy_total",     # fingerprint: sum m·(u + v²/2) over alive rows
    "momentum_abs",     # fingerprint: |Σ m·v|
    "max_speed",        # fingerprint: max |v| over alive rows
    "min_rho",          # fingerprint: min density over alive rows
)
N_COUNTS = len(COUNT_COLUMNS)
N_VALUES = len(VALUE_COLUMNS)

# Per-cell work vectors (device-metrics version 2), integer valued.
CELL_COLUMNS: Tuple[str, ...] = (
    "drift",      # alive particles drifted in this cell's rows
    "density",    # live pair blocks attributed to this cell (density)
    "force",      # live pair blocks attributed to this cell (force)
    "exchange",   # halo slots unpacked for this cell (recv-side units)
)
N_CELL_COLS = len(CELL_COLUMNS)
CELL_INDEX = {name: i for i, name in enumerate(CELL_COLUMNS)}

COUNT_INDEX = {name: i for i, name in enumerate(COUNT_COLUMNS)}
VALUE_INDEX = {name: i for i, name in enumerate(VALUE_COLUMNS)}
_CI = COUNT_INDEX
_VI = VALUE_INDEX


def zero_rows(nranks: int = 1):
    """Host-side zero accumulator: ``(counts, values)`` numpy buffers of
    shape ``(nranks, N_COUNTS)`` / ``(nranks, N_VALUES)``."""
    counts = np.zeros((nranks, N_COUNTS), np.int64)
    values = np.zeros((nranks, N_VALUES), np.float64)
    values[..., _VI["min_rho"]] = np.inf
    return counts, values


def zero_cell_work(ncells: int, nranks: int = 1):
    """Host-side zero accumulator for per-cell attribution: a global
    ``(ncells, N_CELL_COLS)`` float64 buffer plus a per-rank
    ``(nranks, N_CELL_COLS)`` totals buffer."""
    return (np.zeros((ncells, N_CELL_COLS), np.float64),
            np.zeros((nranks, N_CELL_COLS), np.float64))


def host_row(**named) -> Tuple[np.ndarray, np.ndarray]:
    """One 1-D ``(counts, values)`` row from host-side python scalars.
    Unnamed columns default to zero (``min_rho`` to +inf)."""
    counts = np.zeros(N_COUNTS, np.int64)
    values = np.zeros(N_VALUES, np.float64)
    values[_VI["min_rho"]] = np.inf
    for k, v in named.items():
        if k in _CI:
            counts[_CI[k]] = int(v)
        elif k in _VI:
            values[_VI[k]] = float(v)
        else:
            raise KeyError(f"unknown device-metrics column {k!r}")
    return counts, values


def state_health(mask, vel, u, rho, mass, counts, values, rank: int = 0,
                 active=None) -> None:
    """Fill one rank's sentinel flags + fingerprint columns in place from
    host (numpy) state arrays."""
    alive = np.asarray(mask) > 0
    vel = np.asarray(vel)
    u = np.asarray(u)
    rho = np.asarray(rho)
    mass = np.asarray(mass)
    counts[rank, _CI["flag_nan"]] += int(
        np.isnan(vel[alive]).any() or np.isnan(u[alive]).any()
        or np.isnan(rho[alive]).any())
    counts[rank, _CI["flag_inf"]] += int(
        np.isinf(vel[alive]).any() or np.isinf(u[alive]).any()
        or np.isinf(rho[alive]).any())
    neg = alive & (rho <= 0)
    if active is not None:
        neg &= np.asarray(active) > 0
    counts[rank, _CI["flag_neg_rho"]] += int(neg.any())
    m = np.where(alive, mass, 0.0)
    speed = np.sqrt((vel * vel).sum(axis=-1))
    values[rank, _VI["energy_total"]] = float(
        (m * (u + 0.5 * speed * speed)).sum())
    values[rank, _VI["momentum_abs"]] = float(np.sqrt(
        ((m[..., None] * vel).sum(axis=tuple(range(vel.ndim - 1)))
         ** 2).sum()))
    values[rank, _VI["max_speed"]] = float(speed[alive].max()) \
        if alive.any() else 0.0
    values[rank, _VI["min_rho"]] = float(rho[alive].min()) \
        if alive.any() else np.inf
