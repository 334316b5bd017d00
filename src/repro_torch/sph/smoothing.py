"""SPH smoothing kernels W(r, h) and dW/dr (port of ``repro.sph.smoothing``).

Compact support of radius ``h``: W(r, h) = 0 for r >= h. All kernels are
3-D and normalised so that ∫ W d³r = 1.

Powers are written as the reference's ``x ** n`` evaluates them in f32
(x³ = x·(x·x), x⁴ = (x·x)·(x·x)), so the port rounds at the same places;
the CUDA kernels (``kernels/sph_pair/csrc``) spell out the same sequence.
"""

from __future__ import annotations

import math

import torch

_CUBIC_NORM_3D = 8.0 / math.pi       # × h⁻³, for q = r/h in [0, 1]
_WENDLAND_C2_NORM_3D = 21.0 / (2.0 * math.pi)


def _rdiv(c: float, x):
    """c / x as a true division (PyTorch evaluates ``float / tensor`` as
    ``reciprocal(x) * c``, which rounds twice)."""
    return torch.full_like(x, c) / x


def _cube(x):
    return x * (x * x)


def _pow4(x):
    x2 = x * x
    return x2 * x2


def w_cubic(r, h):
    """M4 cubic spline, support radius h."""
    q = r / h
    sigma = _rdiv(_CUBIC_NORM_3D, h * h * h)
    w1 = 1.0 - 6.0 * q * q + 6.0 * q * q * q          # q <= 1/2
    w2 = 2.0 * _cube(1.0 - q)                          # 1/2 < q <= 1
    w = torch.where(q <= 0.5, w1, w2)
    return torch.where(q < 1.0, sigma * w, 0.0)


def dwdr_cubic(r, h):
    q = r / h
    sigma = _rdiv(_CUBIC_NORM_3D, _pow4(h))
    d1 = -12.0 * q + 18.0 * q * q
    omq = 1.0 - q
    d2 = -6.0 * (omq * omq)
    d = torch.where(q <= 0.5, d1, d2)
    return torch.where(q < 1.0, sigma * d, 0.0)


def w_wendland_c2(r, h):
    """Wendland C2, support radius h."""
    q = r / h
    sigma = _rdiv(_WENDLAND_C2_NORM_3D, h * h * h)
    w = _pow4(1.0 - q) * (4.0 * q + 1.0)
    return torch.where(q < 1.0, sigma * w, 0.0)


def dwdr_wendland_c2(r, h):
    q = r / h
    sigma = _rdiv(_WENDLAND_C2_NORM_3D, _pow4(h))
    d = -20.0 * q * _cube(1.0 - q)
    return torch.where(q < 1.0, sigma * d, 0.0)


_KERNELS = {
    "cubic": (w_cubic, dwdr_cubic),
    "wendland_c2": (w_wendland_c2, dwdr_wendland_c2),
}


def get_kernel(name: str):
    """Return (W, dW/dr) callables."""
    try:
        return _KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; have {list(_KERNELS)}")


def dw_dh(r, h, name: str = "cubic"):
    """∂W/∂h = −(3W + r·dW/dr)/h (3-D scaling identity)."""
    w_fn, dwdr_fn = get_kernel(name)
    return -(3.0 * w_fn(r, h) + r * dwdr_fn(r, h)) / h
