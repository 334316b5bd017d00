"""Program signatures: which requests may share one batch.

Port of ``repro.fleet.signature``, line for line. Two requests can ride
the same stacked entry point exactly when every property that fixes the
program agrees: the quadrant (integrator × backend) and its engine policy,
the physics config (:class:`~repro_torch.sph.engine.SPHConfig`, whose repr
is the reference's), and the scenario *shape* — particle count, grid
geometry, pair-list length. Scenario parameters that only change *values*
(blast energy, shear velocity, RNG seed, …) do not enter the signature: a
Sedov request with ``e0=1.0`` and one with ``e0=0.7`` are the same program
over different data, which is what batching wants.

The split between shape-affecting and value-only scenario parameters is
declared per scenario in :data:`SHAPE_PARAM_KEYS`; unknown scenarios fall
back to treating *every* parameter as shape-affecting.

``signature(spec)`` returns a hashable tuple; ``signature_key(spec)`` a
short stable hex digest for logs, program-cache keys and trace attrs —
letter for letter the reference's for the same spec.
"""

from __future__ import annotations

import hashlib
from typing import Any, Mapping, Tuple

# scenario-parameter names that change array shapes or compiled structure
# (anything not listed is value-only and batches freely). ``box`` changes
# the grid geometry; ``n_side``/``n`` the particle count; ``n_target`` the
# smoothing length and hence cell size via choose_grid.
SHAPE_PARAM_KEYS = {
    "uniform": ("n_side", "box", "n_target"),
    "sedov": ("n_side", "box", "n_target"),
    "kelvin_helmholtz": ("n_side", "box", "n_target"),
    "clustered": ("n", "box", "n_halos", "clustered_fraction", "n_target"),
}

# spec fields that never reach a compiled program: observability wiring is
# managed by the fleet itself and ``scenario_params`` is split separately.
_NON_PROGRAM_FIELDS = ("observe", "scenario_params")


def canonical(value: Any) -> Any:
    """Recursively convert ``value`` to a canonical hashable form.

    Mappings become sorted ``(key, value)`` tuples, sequences become
    tuples, numpy scalars collapse to Python scalars, arrays to
    (shape, dtype, bytes). Insertion order therefore never leaks into
    hashes or signatures.
    """
    if isinstance(value, Mapping):
        return tuple(sorted((str(k), canonical(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(canonical(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return tuple(sorted(map(canonical, value), key=repr))
    if hasattr(value, "shape") and hasattr(value, "tobytes"):   # ndarray
        import numpy as np
        a = np.asarray(value)
        return ("ndarray", a.shape, str(a.dtype), a.tobytes())
    if hasattr(value, "item") and not isinstance(value, (int, float, str,
                                                         bool, bytes)):
        try:
            return value.item()                                 # np scalar
        except Exception:
            pass
    return value


def split_scenario_params(scenario: str, params: Mapping[str, Any]
                          ) -> Tuple[tuple, tuple]:
    """(shape_params, value_params) as canonical sorted tuples."""
    keys = SHAPE_PARAM_KEYS.get(scenario)
    items = sorted((str(k), canonical(v)) for k, v in dict(params).items())
    if keys is None:                 # unknown scenario: all shape-affecting
        return tuple(items), ()
    shape = tuple(kv for kv in items if kv[0] in keys)
    value = tuple(kv for kv in items if kv[0] not in keys)
    return shape, value


def signature(spec) -> tuple:
    """The compiled-program signature of a :class:`SimulationSpec`.

    Hashable, order-independent, equal for any two specs whose compiled
    entry points are interchangeable (same quadrant, physics, engine
    policy and scenario *shape*; value-only scenario params excluded).
    """
    import dataclasses
    fields = {}
    for f in dataclasses.fields(spec):
        if f.name in _NON_PROGRAM_FIELDS:
            continue
        fields[f.name] = canonical(getattr(spec, f.name))
    shape_params, _values = split_scenario_params(
        spec.scenario, spec.scenario_params)
    return (("quadrant", fields.pop("integrator"), fields.pop("backend")),
            ("scenario", fields.pop("scenario"), shape_params),
            tuple(sorted(fields.items())))


def signature_key(spec) -> str:
    """Short stable digest of :func:`signature` for logs and cache keys."""
    return hashlib.sha1(repr(signature(spec)).encode()).hexdigest()[:12]
