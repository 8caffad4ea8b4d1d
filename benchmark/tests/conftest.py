"""Shared fixtures of the benchmark's tests.

Run them from the repository root:

    python -m pytest benchmark/tests -q          # CPU: the card tests skip
    python -m pytest benchmark/tests -q -m card  # on the card

Tests that need the card carry the `card` marker and take the `card`
fixture, which decides inside the test whether there is one.
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "benchmark")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(name: str, grid, widen: float = 0.0) -> dict:
    """A configuration of the benchmark at a test grid: `widen` sets a
    floor (bohr) under every Gaussian width, so coarse grids resolve
    them."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["grid"] = list(grid)
    for sp in cfg["density"]["species"].values():
        sp["core_width"] = max(sp["core_width"], widen)
        sp["valence_width"] = max(sp["valence_width"], widen * 1.3)
    return cfg


# cells whose job kind, traffic and limits are in place but which
# BENCHMARK.json does not hold yet; their tiny twins are tested all the same
SHELVED = [{"name": "nacl-b1-256.topology", "config": "nacl-b1-256",
            "traffic": "topology", "chips": 1, "why": "shelved"},
           {"name": "anthracene-x23.nci", "config": "anthracene-x23",
            "traffic": "nci", "chips": 1, "why": "shelved"}]

TINY = {"nacl-b1-256": ((32, 32, 32), 0.9),
        "anthracene-x23": ((96, 72, 128), 0.0)}


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark in which every cell `<config>.<traffic>` has
    a twin `<config>-tiny.<traffic>` at a test grid, with the cell's own
    traffic, job, limits and metrics. Returns (benchmark dir, spec)."""
    root = tmp_path / "checkout"
    bd = root / "benchmark"
    shutil.copytree(BENCH, bd, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for name, (grid, widen) in TINY.items():
        with open(bd / "configs" / f"{name}-tiny.json", "w") as fh:
            json.dump(tiny_config(name, grid, widen), fh)
    for w in list(spec["workloads"]) + SHELVED:
        twin = dict(w, name=f"{w['config']}-tiny.{w['traffic']}",
                    config=w["config"] + "-tiny")
        spec["workloads"].append(twin)
        shutil.copy(bd / "limits" / f"{w['name']}.json",
                    bd / "limits" / f"{twin['name']}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(twin["name"])
    with open(root / "BENCHMARK.json", "w") as fh:
        json.dump(spec, fh)
    return str(bd), spec
