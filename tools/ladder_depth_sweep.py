"""Sweep the time-bin ladder's max_depth on Sedov and watch for divergence.

    python3 tools/ladder_depth_sweep.py [n_side=64] [depths=10,8,6,4] \\
        [seconds_per_depth=150]

For each max_depth, builds ``chip_smoke.py``'s time-bin Sedov run
(``chip_smoke.sedov_spec``) on the CUDA device (it stops if there is none)
and runs up to two cycles, checking the real particles' fields after
every sub-step, drift and closing kick. Prints one JSON line per 100
sub-steps (sub-step seconds, largest u and speed, deepest bin), one per
cycle (the cycle stats, wall seconds, sub-step seconds, relative energy
drift), and, where a real particle's field first goes non-finite, the
phase, the sub-step and the fields involved; that depth then stops.
"""

import json
import os
import sys
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import sedov_spec  # noqa: E402
from repro_torch.sph import build_simulation  # noqa: E402


class Diverged(Exception):
    pass


def nonfinite(st):
    """Counts of non-finite entries per field, over real particles."""
    m = st.cells.mask > 0
    out = {}
    fields = dict(st._asdict(), **st.cells._asdict())
    for k, v in fields.items():
        if k in ("cells", "time"):
            continue
        bad = ~torch.isfinite(v.float())
        if bad.dim() == 3:
            bad = bad.any(-1)
        n = int((bad & m).sum())
        if n:
            out[k] = n
    return out


def run(n_side: int, depth: int, t_limit: float) -> None:
    sim = build_simulation(sedov_spec(n_side, max_depth=depth), device="cuda")
    eng = sim.engine
    calls = {"n": 0, "seconds": 0.0}
    sub0, drift0, final0 = eng._sub, eng._drift, eng._final

    def check(tag, st, **extra):
        bad = nonfinite(st)
        if bad:
            print(json.dumps({"nonfinite": tag, "substep_call": calls["n"],
                              **extra, "fields": bad}), flush=True)
            raise Diverged

    def sub(state, pl, pm, level, wf, dtm, d, uf):
        t0 = time.perf_counter()
        st, nact = sub0(state, pl, pm, level, wf, dtm, d, uf)
        torch.cuda.synchronize()
        calls["seconds"] += time.perf_counter() - t0
        calls["n"] += 1
        check("substep", st, level=level, depth=d, nact=int(nact),
              live_pairs=int(pm.sum()))
        if calls["n"] % 100 == 0:
            c, m = st.cells, st.cells.mask > 0
            print(json.dumps({
                "substeps_done": calls["n"], "substep_s": calls["seconds"],
                "max_u": float(c.u[m].max()),
                "max_speed": float(c.vel.norm(dim=-1)[m].max()),
                "max_bin": int(st.bins.max()), "t": float(st.time)}),
                flush=True)
        return st, nact

    def drift(state, dt):
        st = drift0(state, dt)
        check("drift", st)
        return st

    def final(state, pl, pm, dtm):
        st = final0(state, pl, pm, dtm)
        check("final", st)
        return st

    eng._sub, eng._drift, eng._final = sub, drift, final
    e0, _ = sim.diagnostics()
    t_start = time.perf_counter()
    for c in range(2):
        if time.perf_counter() - t_start > t_limit:
            print(json.dumps({"skipped_cycle": c, "reason": "time"}),
                  flush=True)
            break
        calls.update(n=0, seconds=0.0)
        t0 = time.perf_counter()
        st = sim.step()
        e, _ = sim.diagnostics()
        print(json.dumps({
            "cycle": c, "wall_s": time.perf_counter() - t0,
            "substep_s": calls["seconds"],
            **{k: (v.tolist() if hasattr(v, "tolist") else v)
               for k, v in st.items()},
            "energy_drift": abs(e - e0) / abs(e0)}), flush=True)


def main(n_side: int = 64, depths=(10, 8, 6, 4), t_limit: float = 150.0):
    if not torch.cuda.is_available():
        raise SystemExit("ladder_depth_sweep: needs a CUDA device")
    warnings.simplefilter("ignore", DeprecationWarning)
    for d in depths:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "n_side": n_side, "max_depth": d}), flush=True)
        try:
            run(n_side, d, t_limit)
        except Diverged:
            pass
        torch.cuda.empty_cache()


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 64,
         tuple(int(x) for x in args[1].split(",")) if len(args) > 1
         else (10, 8, 6, 4),
         float(args[2]) if len(args) > 2 else 150.0)
