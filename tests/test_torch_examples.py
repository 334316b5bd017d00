"""The port's examples (``examples_torch/``), each the counterpart of a
reference script under ``examples/``, run end to end on the CPU.

Each script runs in a subprocess of its own with ``--device cpu`` at its
smallest size, all six at once (each on two threads), and must exit 0,
print its reference's columns, and import neither JAX nor the reference
package ``repro`` (the subprocess lists the modules it loaded). On the
card ``chip_smoke.py`` runs them without ``--device``.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")

# a runner that executes the script as __main__ and then prints the
# top-level packages of every module it loaded
_RUNNER = """
import json, runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
print("LOADED " + json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

# script: (arguments at its smallest size, lines its output must hold)
CASES = {
    "quickstart.py": ([], ["=== 3. graph partition", "async makespan",
                           "10 steps: |ΔE|/E", "done."]),
    "sedov_blast.py": (["6", "1", "--max-depth", "4"],
                       ["cycle       t  depth  upd_frac  dE_rel   r_shock  "
                        "r_sedov", "bins:", "total particle updates"]),
    "sph_strong_scaling.py": (["800", "--ranks", "1,2"],
                              ["ranks,mode,makespan_us,efficiency",
                               "1,async,", "2,sync,"]),
    "fleet_serve.py": (["--trace", "{tmp}/fleet_trace.json"],
                       ["fleet: 12 requests", "rows are request_ids"]),
    "serve_lm.py": ([], ["served 5/12 requests"]),
    "train_lm.py": (["--steps", "2", "--batch", "2", "--seq", "16",
                     "--n-layers", "1", "--ckpt", "{tmp}/ckpt"],
                    ["model: ", "step     1  loss", "loss: "]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example started at once; {script: (rc, stdout, stderr)}."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    procs = {}
    for script, (args, _) in CASES.items():
        tmp = str(tmp_path_factory.mktemp(script.split(".")[0]))
        argv = [a.format(tmp=tmp) for a in args] + ["--device", "cpu"]
        procs[script] = subprocess.Popen(
            [sys.executable, "-c", _RUNNER, os.path.join(EXAMPLES, script),
             *argv], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for script, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[script] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu_without_jax_or_the_reference(runs, script):
    rc, stdout, stderr = runs[script]
    assert rc == 0, stderr[-3000:]
    for line in CASES[script][1]:
        assert line in stdout, (line, stdout[-2000:])
    loaded = json.loads(stdout.rsplit("LOADED ", 1)[1])
    assert "repro_torch" in loaded and "torch" in loaded
    assert not {"jax", "jaxlib", "repro"} & set(loaded), loaded


def test_every_reference_example_has_a_port():
    """One port a script of ``examples/``, by name."""
    ref = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                 if f.endswith(".py"))
    assert ref == sorted(CASES)
    assert sorted(f for f in os.listdir(EXAMPLES)
                  if f.endswith(".py")) == ref
