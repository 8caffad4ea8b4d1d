"""What a run may load: never JAX or the JAX package, and the reference
never the program."""
import os
import subprocess
import sys

from benchmark.lib import harness

REFERENCE_ONLY = r'''
import sys, json
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark.lib import density, harness
for job in ("yt", "nci"):
    harness.load_module({root!r} + "/benchmark/jobs/%s.py" % job, "j" + job)
from benchmark.reference import nci, yt
cfg = json.load(open({root!r} + "/benchmark/configs/nacl-b1-256.json"))
cfg["grid"] = [24, 24, 24]
for sp in cfg["density"]["species"].values():
    sp["core_width"] = sp["valence_width"] = 1.2
rho = density.make_pool(cfg, 1, 1, "cpu")[0]
yt.basins(rho, cfg["structure"]["lattice_bohr"])
nci.nci(rho, cfg["structure"]["lattice_bohr"])
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(top))
'''


def test_reference_and_jobs_load_neither_the_program_nor_jax():
    p = subprocess.run([sys.executable, "-c",
                        REFERENCE_ONLY.format(root=harness.ROOT)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"critic2_tpu_torch", "critic2_tpu", "jax",
                         "jaxlib", "flax"}


def test_a_run_loads_no_jax_and_no_jax_package(tiny_bench):
    """The whole run on the CPU in a fresh process, the program included."""
    bd, _ = tiny_bench
    code = (f"import sys, time; sys.path.insert(0, {harness.ROOT!r})\n"
            "from benchmark.lib import harness\n"
            f"c = harness.Cell.load('nacl-b1-256-tiny.yt', bench_dir={bd!r})\n"
            "r = harness.run_cell(c, 9, 0.2, False, 'cpu', "
            "time.perf_counter())\n"
            "assert r['correct'], r\n"
            "assert 'critic2_tpu_torch' in sys.modules\n"
            "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
