"""What a run may load: never JAX or the JAX package, and the reference
and the data models never the program."""
import glob
import os
import subprocess
import sys

from test_benchmark_extend import TOY_CONFIG, TOY_MODEL

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


DATA_MODELS = r'''
import glob, json, sys
sys.path.insert(0, {root!r})
from benchmark.lib import harness
for path in sorted(glob.glob({root!r} + "/benchmark/data/*.py")):
    harness.load_module(path, "d_" + path.split("/")[-1][:-3])
toy = harness.data_model({cfg!r}, {toy_dir!r})
toy.check_pool({cfg!r}, toy.make_pool({cfg!r}, 2 ** 35 + 1, 2, "cpu"), 1)
print(json.dumps([harness.forbidden_modules(),
                  sorted(m for m in sys.modules
                         if m.split(".")[0] == harness.PROGRAM)]))
'''


def test_data_models_load_neither_the_program_nor_jax(tmp_path):
    """Every data/<model>.py of the benchmark, and the toy model of the
    extension test, loaded and (the toy) run in a fresh process."""
    os.makedirs(tmp_path / "data")
    with open(tmp_path / "data" / "toy_states.py", "w") as fh:
        fh.write(TOY_MODEL)
    code = DATA_MODELS.format(root=harness.ROOT, cfg=TOY_CONFIG,
                              toy_dir=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[[], []]"
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "data", "*.py")):
        with open(path) as fh:
            text = fh.read()
        for name in (*harness.FORBIDDEN, harness.PROGRAM):
            assert f"import {name}" not in text, (path, name)
            assert f"from {name}" not in text, (path, name)


def test_a_data_model_that_loads_the_program_is_refused(tmp_path):
    os.makedirs(tmp_path / "data")
    with open(tmp_path / "data" / "leaky.py", "w") as fh:
        fh.write("import critic2_tpu_torch.ops.yt_pass\n")
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r})\n"
            "from benchmark.lib import harness\n"
            "harness.data_model({'density': {'model': 'leaky'}}, "
            f"{str(tmp_path)!r})\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode != 0
    assert "loads ['critic2_tpu_torch']" in p.stderr
