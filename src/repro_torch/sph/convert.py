"""State carried across between the reference and the port.

The system has no weights: what carries across is its state. These
functions turn the reference's state — ``ParticleCells``, ``PairList``,
``SPHState`` and ``TimeBinState``, read field by field by name, each field
anything ``np.asarray`` accepts (the reference's arrays included) — into
the port's tensors on a given device, and turn the port's state back into
numpy. ``bins`` stays int32, ``ci``/``cj`` int32, every other field
float32, and ``time`` a 0-d float32 tensor.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .cellgrid import PairList, ParticleCells, make_pair_list
from .engine import SPHState
from .timebins import STATE_AUX_FIELDS, STATE_CELL_FIELDS, TimeBinState

_INT_FIELDS = ("bins",)


def _get(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(value, name: str, device) -> torch.Tensor:
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    a = np.asarray(value)
    if a.dtype != dtype:
        raise TypeError(f"{name}: expected {np.dtype(dtype)}, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def cells_to_torch(src: Any, device=None) -> ParticleCells:
    """A reference ``ParticleCells`` (or mapping) as the port's."""
    return ParticleCells(**{k: _tensor(_get(src, k), k, device)
                            for k in STATE_CELL_FIELDS})


def pairs_to_torch(src: Any, ncells: int, device=None) -> PairList:
    """A reference ``PairList`` (or mapping) as the port's, with the
    incoming table the port's passes sum through."""
    ci = np.asarray(_get(src, "ci"))
    cj = np.asarray(_get(src, "cj"))
    if ci.dtype != np.int32 or cj.dtype != np.int32:
        raise TypeError("ci/cj: expected int32")
    return make_pair_list(ci, cj, np.asarray(_get(src, "shift")), ncells,
                          device)


def sph_state_to_torch(src: Any, device=None) -> SPHState:
    """A reference ``SPHState`` (or mapping) as the port's."""
    return SPHState(cells=cells_to_torch(_get(src, "cells"), device),
                    accel=_tensor(_get(src, "accel"), "accel", device),
                    dudt=_tensor(_get(src, "dudt"), "dudt", device),
                    rho=_tensor(_get(src, "rho"), "rho", device),
                    time=_tensor(_get(src, "time"), "time", device))


def timebin_state_to_torch(src: Any, device=None) -> TimeBinState:
    """A reference ``TimeBinState`` (or mapping) as the port's."""
    aux = {k: _tensor(_get(src, k), k, device) for k in STATE_AUX_FIELDS}
    return TimeBinState(cells=cells_to_torch(_get(src, "cells"), device),
                        time=_tensor(_get(src, "time"), "time", device),
                        **aux)


def to_numpy(state: Any) -> Dict[str, Any]:
    """Any of the four state types (the port's or the reference's) as a
    nested dict of numpy arrays, by field name; a pair list's incoming
    table is left out."""
    out: Dict[str, Any] = {}
    for name, value in state._asdict().items():
        if name == "incoming":
            continue
        if hasattr(value, "_asdict"):
            out[name] = to_numpy(value)
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out
