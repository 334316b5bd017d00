"""Telemetry rows (numpy copy of the host-side pieces of
``repro.observability.device_metrics``).

Two fixed-shape buffers per rank: ``counts`` (sub-step executions, active
particles per phase, live pair counts, exchange slots, deepening / wake
events, health sentinel trips) and ``values`` (per-phase work units and a
state fingerprint), plus per-cell work vectors. The host-residency engines
build them from host scalars they already hold and adopt one accumulated
row a cycle (``device_metrics_last``); the observer digests it with
:func:`summarize`, :func:`fingerprint` and :func:`phase_units`. The
reference's in-program row functions (``measure_substep``, ``measure_cells``)
run only inside its fused device-residency programs, which the port does
not have yet (ROADMAP queue 1, item 11b).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

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

# how each value column folds across sub-steps within one cycle
_V_ACCUM: Tuple[str, ...] = ("sum", "sum", "sum", "sum",
                             "last", "last", "max", "min")
_FLAG_COLUMNS = ("flag_nan", "flag_inf", "flag_neg_rho")
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


def fold_cell_rows(cell_rows, owned: Sequence[np.ndarray],
                   halo: Sequence[np.ndarray], ncells: int,
                   K: int) -> Dict[str, object]:
    """Fold pulled per-rank extended-row buffers onto global cells.

    ``cell_rows`` is the stacked ``(nranks, nrows, N_CELL_COLS)`` device
    output; ``owned[r]``/``halo[r]`` map rank ``r``'s rows to global cell
    ids (owned rows from 0, halo rows from the shared owned-slot count
    ``K``). Halo rows only ever carry exchange units, which fold onto
    the *owner* cell's global entry — each shipped slot is counted
    exactly once. Returns the engine's ``device_cell_work_last``
    contract dict.
    """
    rows = np.asarray(cell_rows, np.float64)
    nranks = rows.shape[0]
    cells = np.zeros((ncells, N_CELL_COLS), np.float64)
    per_rank = np.zeros((nranks, N_CELL_COLS), np.float64)
    for r in range(nranks):
        own = np.asarray(owned[r], np.int64)
        hal = np.asarray(halo[r], np.int64) if r < len(halo) else \
            np.zeros(0, np.int64)
        np.add.at(cells, own, rows[r, :len(own)])
        if len(hal):
            np.add.at(cells, hal, rows[r, K:K + len(hal)])
        per_rank[r] = rows[r].sum(axis=0)
    return {"columns": list(CELL_COLUMNS), "cells": cells,
            "per_rank": per_rank}


def cell_work_record(cell_work: Optional[Dict[str, object]]) \
        -> Optional[Dict[str, object]]:
    """Compact per-record shape for metrics schema v3: columns, per-rank
    totals and global totals (the full per-cell vector stays on the
    engine — JSONL records would balloon at ncells scale)."""
    if not cell_work:
        return None
    per_rank = np.asarray(cell_work["per_rank"], np.float64)
    cells = np.asarray(cell_work["cells"], np.float64)
    return {
        "columns": list(cell_work["columns"]),
        "per_rank": [[float(x) for x in row] for row in per_rank.tolist()],
        "totals": [float(x) for x in cells.sum(axis=0).tolist()],
        "ncells": int(cells.shape[0]),
    }


def combine(acc, row):
    """Fold one sub-step row into a cycle accumulator (numpy rows).

    Counts add; work-unit values add; fingerprint values take the
    latest/extremum per ``_V_ACCUM``.
    """
    counts, values = acc
    rc, rv = row
    counts = counts + np.asarray(rc, counts.dtype)
    rv = np.asarray(rv, values.dtype)
    sel_sum = np.asarray([a == "sum" for a in _V_ACCUM])
    sel_last = np.asarray([a == "last" for a in _V_ACCUM])
    sel_max = np.asarray([a == "max" for a in _V_ACCUM])
    out = np.where(sel_sum, values + rv,
                   np.where(sel_last, rv,
                            np.where(sel_max, np.maximum(values, rv),
                                     np.minimum(values, rv))))
    return counts, out


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


# ------------------------------------------------------------- host summary
def _clean(x: float) -> Optional[float]:
    return None if (x is None or not math.isfinite(x)) else float(x)


def summarize(counts, values) -> Dict[str, object]:
    """Host-side digest of a pulled ``(nranks, N)`` metrics row pair.

    The per-record shape exported under ``device_metrics`` in the
    metrics records: raw per-rank columns plus the derived per-rank work
    (density+force units), the work imbalance (max/mean — SWIFT's
    figure of merit), and the sentinel flags.
    """
    c = np.atleast_2d(np.asarray(counts))
    v = np.atleast_2d(np.asarray(values))
    per_rank_work = (v[:, _VI["density_units"]]
                     + v[:, _VI["force_units"]]).astype(float)
    mean = float(per_rank_work.mean()) if per_rank_work.size else 0.0
    imb = float(per_rank_work.max() / mean) if mean > 0 else None
    flags = {name: int(c[:, _CI[name]].sum()) for name in _FLAG_COLUMNS}
    return {
        "version": DEVICE_METRICS_VERSION,
        "count_columns": list(COUNT_COLUMNS),
        "value_columns": list(VALUE_COLUMNS),
        "counts": c.astype(int).tolist(),
        "values": [[_clean(x) for x in row] for row in v.tolist()],
        "per_rank_work": per_rank_work.tolist(),
        "imbalance": imb,
        "flags": flags,
        "tripped": any(flags.values()),
    }


def fingerprint(values) -> List[Dict[str, Optional[float]]]:
    """Per-rank compact state fingerprint from a pulled values row."""
    v = np.atleast_2d(np.asarray(values))
    keys = ("energy_total", "momentum_abs", "max_speed", "min_rho")
    return [{k: _clean(row[_VI[k]]) for k in keys} for row in v.tolist()]


def phase_units(summary: Dict[str, object]) -> Dict[str, float]:
    """Total per-phase work units from a ``summarize()`` dict — what the
    observer feeds into the cost ledger."""
    vals = np.asarray(summary["values"], dtype=object)
    cols = list(summary["value_columns"])

    def col(name: str) -> float:
        i = cols.index(name)
        return float(sum(0.0 if x is None else float(x)
                         for x in vals[:, i]))

    return {"density": col("density_units"), "force": col("force_units"),
            "exchange": col("exchange_units"), "kick": col("kick_units")}
