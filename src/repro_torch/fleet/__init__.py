"""Fleet serving: many simulation requests, batched by program signature.

Port of ``repro.fleet``. A request stream of frozen
:class:`~repro_torch.sph.api.SimulationSpec` s is admitted by
:class:`~repro_torch.fleet.queue.RequestQueue`, grouped by program
signature (:mod:`repro_torch.fleet.signature`) into no-shrink batch
buckets (:mod:`repro_torch.fleet.batcher`), and each
``("global", "local")`` batch is served by
:class:`~repro_torch.fleet.runner.FleetRunner` as lanes stacked into one
cell array (:mod:`repro_torch.fleet.lanes`): each step launches each
Hopper pair kernel once for the whole batch.

``python -m repro_torch.fleet --scenario sedov --requests 64`` is the
serving entry point.

Import discipline: :mod:`repro_torch.sph.api` lazily imports
:mod:`repro_torch.fleet.signature` (spec canonicalisation + signatures),
and :mod:`repro_torch.fleet.queue` imports the spec back — so this package
must not eagerly import its queue/batcher/runner modules. They load on
attribute access.
"""

from __future__ import annotations

from . import signature as signature                       # cycle-free
from .signature import SHAPE_PARAM_KEYS, signature_key, split_scenario_params

_LAZY = {
    "RequestQueue": "queue",
    "FleetRequest": "queue",
    "FleetResult": "queue",
    "RequestState": "queue",
    "AdmissionError": "queue",
    "SignatureBatcher": "batcher",
    "Batch": "batcher",
    "FleetRunner": "runner",
    "TransferBufferPool": "runner",
    "sequential_reference": "runner",
}

__all__ = ["SHAPE_PARAM_KEYS", "signature", "signature_key",
           "split_scenario_params", *sorted(_LAZY)]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
