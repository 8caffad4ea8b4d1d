"""The record of intgrid(method="bader") (critic2_tpu_torch/utils/
trace.py) on the CPU, on the small hematite grid of
test_torch_bader_reference: the Bader spans nest under `intgrid`, the
walk's counters against counts taken independently, and the labels bit
for bit the same with the record on and off. Pure torch: nothing here
compiles JAX."""
import numpy as np
import pytest
import torch

from critic2_tpu_torch.analysis import bader
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.ops import bader_walk
from critic2_tpu_torch.utils import trace
from test_torch_bader_reference import bader_run, hematite

torch.set_num_threads(1)

SPANS = ("bader.walk", "bader.basins", "bader.sums")


@pytest.fixture(scope="module")
def case():
    """One intgrid(method="bader") call with the record off and one with
    it on, whose near-grid steps are watched: the live walkers of every
    call of _neargrid_step."""
    cfg, rho = hematite()
    off = bader_run(cfg, rho)
    seen = []
    step = bader_walk._neargrid_step

    def watched(state, *args):
        seen.append(int(state[0].shape[0]))
        return step(state, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(bader_walk, "_neargrid_step", watched)
    try:
        trace.reset()
        with trace.recording() as rec:
            on = bader_run(cfg, rho)
    finally:
        mp.undo()
    return {"off": off, "on": on, "rec": rec.read(), "seen": seen,
            "N": rho.numel()}


def test_the_bader_spans_nest_under_intgrid(case):
    spans = case["rec"]["spans"]
    root, = [sp for sp in spans if sp[3] == -1]
    assert root[0] == "intgrid"
    mine = [sp for sp in spans if sp[0].startswith("bader.")]
    assert sorted(sp[0] for sp in mine) == sorted(SPANS)
    for name, t0, t1, _, call in mine:
        assert root[1] <= t0 <= t1 <= root[2] and call == root[4], name
    walk, = [sp for sp in mine if sp[0] == "bader.walk"]
    basins, = [sp for sp in mine if sp[0] == "bader.basins"]
    sums, = [sp for sp in mine if sp[0] == "bader.sums"]
    assert walk[2] <= basins[1] and basins[2] <= sums[1]
    assert case["rec"]["dropped"] == 0
    assert trace.read()["spans"] == []          # off again after the block


def test_the_walk_counters(case):
    c = case["rec"]["counters"]
    seen = case["seen"]
    # each call of _neargrid_step advances its live walkers one step
    assert c["bader.walker_steps"] == sum(seen)
    assert c["bader.segments"] * bader_walk.WALK_SEGMENT == len(seen)
    assert c["bader.blocks"] == 1 and seen[0] == case["N"]
    assert c["bader.capped"] == 0
    # the walk's two constant tensors, a read of the leavers a segment
    # and one of the stayers after each segment that some leave (the live
    # count drops after it, or it is the last one and no walker is
    # capped), unique and its readback, the sums' readback
    live = seen[::bader_walk.WALK_SEGMENT]
    arrivals = sum(b < a for a, b in zip(live, live[1:])) + 1
    assert c["host_syncs"] == 2 + c["bader.segments"] + arrivals + 2 + 1


def test_labels_are_the_same_with_the_record_on_and_off(case):
    a, b = case["off"].decomp, case["on"].decomp
    assert torch.equal(a.labels_d, b.labels_d)
    assert (a.iattr == b.iattr).all()
    assert (case["off"].charges == case["on"].charges).all()


def test_the_on_grid_route_records_the_same_spans():
    cfg, rho = hematite()
    st = cfg["structure"]
    c = crystal_from_arrays(np.asarray(st["lattice_bohr"]), st["x_frac"],
                            st["species_of"],
                            [(s["name"], s["z"]) for s in st["species"]])
    with trace.recording() as rec:
        res = bader.bader_integrate(c, rho, method="ongrid", device="cpu")
        res.integrate(torch.ones(rho.numel(), dtype=rho.dtype))
    names = [sp[0] for sp in rec.read()["spans"]]
    assert names == list(SPANS)
    assert "bader.segments" not in rec.read()["counters"]
