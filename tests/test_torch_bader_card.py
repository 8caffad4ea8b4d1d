"""The near-grid walk's CUDA kernel against its plain version, on the card.

The file imports no JAX, so that it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_bader_card.py -q

Without a CUDA device every test skips (the CPU tests hold the plain
version to the benchmark's reference: tests/test_torch_bader_reference.py).
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib import density, harness
from critic2_tpu_torch.analysis import bader
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.ops import bader_walk
from critic2_tpu_torch.utils import trace

# (configuration, grid or None for its own, seed, pool item, clamp): the
# hematite densities of the benchmark cell whose walks hold walkers caught
# in four-step cycles (6 and 7 of them stop at the cap when a walker
# remembers only its previous point), one without, rock salt on a cubic
# grid, and hematite with its low density clamped to an exact zero
# plateau
CASES = {
    "hematite-cycles-6": ("hematite-r3c", None, 2500000102, 1, False),
    "hematite-cycles-7": ("hematite-r3c", None, 2500000107, 0, False),
    "hematite": ("hematite-r3c", None, 2500000103, 2, False),
    "rock-salt-128": ("nacl-b1-256", (128, 128, 128), 2500000111, 0, False),
    "hematite-plateau": ("hematite-r3c", (81, 81, 216), 2500000112, 0, True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _case(name, dev):
    config, grid, seed, item, clamp = CASES[name]
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           config + ".json")) as fh:
        cfg = json.load(fh)
    if grid is not None:
        cfg["grid"] = list(grid)
    rho = density.make_pool(cfg, seed, item + 1, dev)[item]
    if clamp:
        rho = torch.where(rho < 0.25 * rho.mean(), 0.0, rho)
    st = cfg["structure"]
    c = crystal_from_arrays(np.asarray(st["lattice_bohr"]), st["x_frac"],
                            st["species_of"],
                            [(s["name"], s["z"]) for s in st["species"]])
    shape = tuple(rho.shape)
    lat2car, offs, dists = bader._lattice_metric(c, shape)
    car2lat = np.linalg.inv(lat2car)
    return rho, (car2lat @ car2lat.T).tolist(), offs, 1.0 / dists, \
        4 * max(shape) + 64


def _walk(fn, rho, *args):
    with trace.recording() as rec:
        roots = fn(rho, *args)
    return roots, rec.read()["counters"]


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_walk_is_the_plain_walk_bitwise(card, name, dtype):
    rho, G, offs, invd, maxiter = _case(name, card)
    rho = rho.to(getattr(torch, dtype))
    n0 = bader_walk.launches["bader_walk"]
    got, ck = _walk(bader_walk.neargrid_walk, rho, G, offs, invd, maxiter)
    assert bader_walk.launches["bader_walk"] == n0 + 1
    want, cp = _walk(bader_walk.neargrid_walk_plain, rho, G, offs, invd,
                     maxiter)
    assert torch.equal(got, want)
    assert ck["bader.capped"] == cp["bader.capped"]
    assert ck["bader.segments"] == 0 and ck["bader.blocks"] == 1
    # the kernel takes each walker's own steps, the plain version whole
    # segments of the live walkers
    assert 0 < ck["bader.walker_steps"] <= cp["bader.walker_steps"]
    # the walk's memory of 8 points sends the four-step cycles on
    assert ck["bader.capped"] == 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["hematite-cycles-6", "hematite-cycles-7"])
def test_kernel_walk_with_a_memory_of_one_is_the_plain_walk(card, name,
                                                            monkeypatch):
    """The guard of the previous point alone (the JAX package's): the
    walkers in four-step cycles go on to the cap, in the kernel as in the
    plain walk."""
    monkeypatch.setattr(bader_walk, "WALK_MEMORY", 1)
    rho, G, offs, invd, maxiter = _case(name, card)
    got, ck = _walk(bader_walk.neargrid_walk, rho, G, offs, invd, maxiter)
    want, cp = _walk(bader_walk.neargrid_walk_plain, rho, G, offs, invd,
                     maxiter)
    assert torch.equal(got, want)
    assert ck["bader.capped"] == cp["bader.capped"] \
        == int(name.rsplit("-", 1)[1])
