"""The record of one deloc_wannier call (critic2_tpu_torch/utils/
trace.py) on the CPU: every named span under the root span `deloc`, the
group and support counts, the complex128 flop count by its formula, and
the walls of `stats` as before; the device's image shifts and spread
screening against the host's rules. Pure torch: nothing here compiles JAX."""
import numpy as np
import pytest
import torch

from critic2_tpu_torch.analysis.deloc import (_attractor_shifts,
                                              _screening, deloc_wannier)
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.fields.field import Field
from critic2_tpu_torch.fields.grid3 import Grid3
from critic2_tpu_torch.fields.qe import QEData
from critic2_tpu_torch.system import System
from critic2_tpu_torch.utils import trace
from test_torch_deloc_reference import small_pool

torch.set_num_threads(1)

DELOC_SPANS = {"deloc.support", "deloc.wannier", "deloc.mask", "deloc.sij",
               "deloc.fa", "deloc.readback"}


@pytest.fixture(scope="module")
def case():
    """A small rock-salt item of the benchmark's data model, its YT
    decomposition, and one recorded deloc_wannier call with WANCUT 4."""
    cfg, pool = small_pool(3100000421)
    item = pool[0]
    qe = QEData.from_arrays(item["at"], item["nk"], item["n"], item["kpt"],
                            item["wk"], item["ek"], item["occ"],
                            item["ngk"], item["igk_k"], item["nl"], None,
                            item["evc"])
    rho = qe.density()
    qe.attach_wannier([item["u"]], [item["centres_ang"]],
                      [item["spreads_ang2"]], [item["rlatt_ang"]])
    st = cfg["structure"]
    c = crystal_from_arrays(np.asarray(st["lattice_bohr"]), st["x_frac"],
                            st["species_of"],
                            [(s["name"], s["z"]) for s in st["species"]])
    s = System.from_structure(c, device="cpu")
    s.load_field(Field.from_grid(c, Grid3(rho, qe=qe)))
    res = intgrid(s, method="yt")
    stats = {}
    trace.reset()
    with trace.recording() as rec:
        out = deloc_wannier(s.crystal, res.decomp, qe, useu=True,
                            wancut=4.0, device="cpu", stats=stats)
    return {"qe": qe, "decomp": res.decomp, "crystal": s.crystal,
            "rec": rec.read(), "stats": stats, "out": out}


def test_every_named_span_nests_under_deloc(case):
    spans = case["rec"]["spans"]
    root = spans[0]
    assert root[0] == "deloc" and root[3] == -1
    assert [sp for sp in spans if sp[3] == -1] == [root]
    assert {sp[4] for sp in spans} == {root[4]}
    for name, t0, t1, _, _ in spans[1:]:
        assert root[1] <= t0 <= t1 <= root[2], name
    mine = {sp[0]: sp for sp in spans if sp[0].startswith("deloc.")}
    assert set(mine) == DELOC_SPANS
    for sp in mine.values():
        assert sp[3] == 0, sp[0]
    # the forward YT solves keep their own spans, inside deloc.support
    sup = mine["deloc.support"]
    solves = [sp for sp in spans if sp[0] == "yt.solve"]
    assert len(solves) == case["decomp"].nattr == 8
    assert all(sup[1] <= sp[1] <= sp[2] <= sup[2] for sp in solves)
    assert case["rec"]["dropped"] == 0
    # the record is off again after the block
    n = len(trace.read()["spans"])
    assert n == 0


def _host_shifts(crystal, decomp, a, idx):
    """The image shift of each support point by Crystal.shortest_vector on
    the host: p = nint(x - c2x(shortest(x)))."""
    x = np.stack(np.unravel_index(idx, decomp.shape), 1) \
        / np.asarray(decomp.shape) - np.asarray(decomp.xattr)[a]
    xs = crystal.shortest_vector(x)
    return np.rint(x - xs @ np.linalg.inv(crystal.m_x2c).T).astype(int)


def test_device_shifts_and_screening_match_the_host_rules(case):
    crystal, decomp, qe = case["crystal"], case["decomp"], case["qe"]
    for a in range(decomp.nattr):
        idx, _ = decomp.basin_support(a)
        p = _attractor_shifts(crystal, decomp.shape,
                              np.asarray(decomp.xattr)[a],
                              torch.as_tensor(idx))
        np.testing.assert_array_equal(p.numpy(),
                                      _host_shifts(crystal, decomp, a, idx))
    # the screening against a row-by-row minimum image on the host
    nk, nb = np.asarray(qe.nk), 32
    pos = ((qe.center[0, :nb][None] + qe.rvectors()[:, None])
           .reshape(-1, 3) / nk)
    spr = np.tile(qe.spread[0, :nb], qe.nlat)
    keep = _screening(crystal, nk, pos, spr, 4.0, torch.device("cpu"),
                      rows=100).numpy()
    m = np.asarray(crystal.m_x2c) * nk[None, :]
    cand = np.stack(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    for i in range(0, len(pos), 37):
        dx = pos - pos[i]
        dx -= np.rint(dx)
        d = np.sqrt(((((dx[:, None] + cand[None]) @ m.T) ** 2).sum(-1))
                    .min(1))
        np.testing.assert_array_equal(keep[i], d <= (spr + spr[i]) * 4.0)
    assert 0 < keep.sum() < keep.size


def test_counters_by_their_formulas(case):
    qe, decomp, cnt = case["qe"], case["decomp"], case["rec"]["counters"]
    sizes, ngroups = [], 0
    for a in range(decomp.nattr):
        idx, _ = decomp.basin_support(a)
        p = _host_shifts(case["crystal"], decomp, a, idx)
        ngroups += len(np.unique(p, axis=0))
        sizes.append(idx.size)
    assert cnt["deloc.groups"] == ngroups
    assert cnt["deloc.support_points"] == sum(sizes)
    nb, nks, nlat = 32, qe.nks, qe.nlat
    N, nmo, nattr = int(np.prod(decomp.shape)), nlat * 32, decomp.nattr
    npwx = qe.igk_k.shape[1]
    flops = (nb * (8 * nks * nb * npwx + 8 * nlat * nks * N)
             + 8 * nmo * nmo * sum(sizes)
             + 8 * nlat * nattr * nattr * nmo * nmo)
    assert cnt["deloc.zgemm_flops"] == flops
    assert cnt["host_syncs"] > ngroups
    assert cnt["yt.solves"] == nattr


def test_stats_still_filled(case):
    assert set(case["stats"]) == {"support", "wannier", "sij", "fa"}
    assert all(v > 0 for v in case["stats"].values())
    assert case["out"].fa.shape == (1, 8, 8, 8)
