"""Initial conditions (numpy copy of ``repro.sph.ic``; outputs are bitwise
equal to the reference's for the same arguments).

The paper's tests resample z=0.5 EAGLE outputs — highly clustered particle
distributions whose densities span 8 orders of magnitude (Fig. 3). Without
the EAGLE data we generate a statistically similar proxy: a hierarchical
Gaussian-mixture clustering (halos with NFW-ish radial profiles placed on a
large-scale web) over a uniform background, which reproduces the *load
imbalance structure* the paper's decomposition is tested against. Uniform
ICs are provided for conservation tests.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def uniform_ic(n_side: int, *, box: float = 1.0, temperature: float = 1.0,
               jitter: float = 0.05, seed: int = 0,
               n_target: float = 48.0) -> Dict[str, np.ndarray]:
    """Jittered-lattice uniform gas at rest."""
    rng = np.random.default_rng(seed)
    g = (np.arange(n_side) + 0.5) / n_side
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + jitter * rng.standard_normal(pos.shape) / n_side) % 1.0
    pos *= box
    n = len(pos)
    spacing = box / n_side
    h = np.full(n, spacing * (3.0 * n_target / (4.0 * np.pi)) ** (1 / 3))
    return {
        "pos": pos.astype(np.float32),
        "vel": np.zeros((n, 3), np.float32),
        "mass": np.full(n, (box ** 3) / n, np.float32),
        "u": np.full(n, temperature, np.float32),
        "h": h.astype(np.float32),
        "box": box,
    }


def sedov_ic(n_side: int, *, box: float = 1.0, e0: float = 1.0,
             u_background: float = 1e-6, r_inject: float | None = None,
             jitter: float = 0.02, seed: int = 0,
             n_target: float = 48.0) -> Dict[str, np.ndarray]:
    """Sedov–Taylor point explosion: cold uniform gas + central energy spike.

    The blast energy ``e0`` is deposited, kernel-weighted, into the
    particles within ``r_inject`` of the box centre. The resulting internal
    energy contrast (~``e0 / u_background`` per unit mass) drives a sound
    speed — and hence CFL time-step — contrast of order sqrt(contrast):
    with the defaults the central particles demand steps >3 decades shorter
    than the quiescent background, the scenario hierarchical time bins
    exist for. Energy conservation against the analytic Sedov solution is
    the standard accuracy check.
    """
    ic = uniform_ic(n_side, box=box, temperature=u_background,
                    jitter=jitter, seed=seed, n_target=n_target)
    pos = ic["pos"]
    centre = np.full(3, box / 2.0, np.float32)
    if r_inject is None:
        r_inject = 2.0 * box / n_side        # a couple of lattice spacings
    d = pos - centre
    d -= box * np.round(d / box)             # min-image
    r = np.linalg.norm(d, axis=1)
    sel = r < r_inject
    if not sel.any():
        sel = np.argsort(r)[:1]              # degenerate: nearest particle
        w = np.ones(1)
    else:
        w = 1.0 - (r[sel] / r_inject) ** 2   # smooth central weighting
    w = w / w.sum()
    u = ic["u"].astype(np.float64)
    u[sel] += e0 * w / ic["mass"][sel]
    ic["u"] = u.astype(np.float32)
    return ic


def kelvin_helmholtz_ic(n_side: int, *, box: float = 1.0,
                        v_shear: float = 0.5, u0: float = 1.0,
                        perturb: float = 0.05, modes: int = 2,
                        layer_width: float = 0.05, jitter: float = 0.02,
                        seed: int = 0,
                        n_target: float = 48.0) -> Dict[str, np.ndarray]:
    """Kelvin–Helmholtz shear layer: the classic mixing-instability test.

    A density-matched 3-D setup (equal-mass particles on one lattice, so no
    spurious surface tension from a density jump): the central slab
    |z − box/2| < box/4 streams at +v_shear in x, the outer gas at
    −v_shear, with a smooth tanh transition of width ``layer_width`` and a
    sinusoidal v_z seed perturbation localised at the two interfaces
    (Price 2008-style). Pressure is uniform (same u everywhere), so the
    only dynamics is the shear instability rolling up the interfaces —
    a scenario whose *activity structure* (interfaces deepen their time
    bins first) exercises the time-bin machinery differently from a
    point blast.
    """
    ic = uniform_ic(n_side, box=box, temperature=u0, jitter=jitter,
                    seed=seed, n_target=n_target)
    pos = ic["pos"]
    z = pos[:, 2] / box
    x = pos[:, 0] / box
    # smooth shear profile: +v in the central slab, -v outside
    d_lo = (z - 0.25) / max(layer_width, 1e-6)
    d_hi = (z - 0.75) / max(layer_width, 1e-6)
    profile = 0.5 * (np.tanh(d_lo) - np.tanh(d_hi)) * 2.0 - 1.0
    vx = v_shear * profile
    # interface-localised v_z seed (both interfaces, opposite phases)
    vz = perturb * v_shear * np.sin(2.0 * np.pi * modes * x) * (
        np.exp(-(d_lo ** 2)) + np.exp(-(d_hi ** 2)))
    vel = np.zeros_like(pos)
    vel[:, 0] = vx
    vel[:, 2] = vz
    ic["vel"] = vel.astype(np.float32)
    return ic


def clustered_ic(n: int, *, box: float = 1.0, n_halos: int = 32,
                 clustered_fraction: float = 0.8, seed: int = 0,
                 temperature: float = 1.0,
                 n_target: float = 48.0) -> Dict[str, np.ndarray]:
    """EAGLE-like clustered proxy: halos + filaments + uniform background.

    Halo masses follow a power law (few big, many small); particle radii
    within a halo follow r ~ U^2 (centrally concentrated), giving local
    densities spanning many orders of magnitude, as in the paper's Fig. 3.
    """
    rng = np.random.default_rng(seed)
    n_clust = int(n * clustered_fraction)
    n_bg = n - n_clust

    # halo centres on a rough filamentary web: random walk between anchors
    centres = rng.random((n_halos, 3)) * box
    mass_pl = rng.pareto(1.5, n_halos) + 1.0
    halo_p = mass_pl / mass_pl.sum()
    counts = rng.multinomial(n_clust, halo_p)
    scales = 0.02 * box * (mass_pl / mass_pl.max()) ** (1 / 3) + 0.004 * box

    chunks = []
    for c, cnt, s in zip(centres, counts, scales):
        if cnt == 0:
            continue
        r = s * rng.random(cnt) ** 2.0          # centrally concentrated
        d = rng.standard_normal((cnt, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
        chunks.append(c + r[:, None] * d)
    clustered = (np.concatenate(chunks, 0) if chunks
                 else np.empty((0, 3)))
    bg = rng.random((n_bg, 3)) * box
    pos = np.concatenate([clustered, bg], 0) % box
    n = len(pos)

    # per-particle h from local density estimate: kNN distance proxy via a
    # coarse grid count (cheap, only sets the *initial* h)
    gridn = max(int(np.ceil(n ** (1 / 3) / 2)), 4)
    idx = np.clip((pos / box * gridn).astype(int), 0, gridn - 1)
    flat = (idx[:, 0] * gridn + idx[:, 1]) * gridn + idx[:, 2]
    counts_g = np.bincount(flat, minlength=gridn ** 3)
    local = counts_g[flat] / (box / gridn) ** 3
    h = (3.0 * n_target / (4.0 * np.pi * np.maximum(local, 1e-12))) ** (1 / 3)
    h = np.clip(h, box / 512, box / 4)

    return {
        "pos": pos.astype(np.float32),
        "vel": np.zeros((n, 3), np.float32),
        "mass": np.full(n, (box ** 3) / n, np.float32),
        "u": np.full(n, temperature, np.float32),
        "h": h.astype(np.float32),
        "box": box,
    }
