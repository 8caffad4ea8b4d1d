"""The benchmark's deloc job on the CPU against its plain reference, and
the pwc / chk readers against the in-memory builds they call.

A small copy of the configuration nacl-b1-wannier-k4 (the same rock-salt
cell and 32 bands; grid 24^3, nk 2x2x2, ecutwfc 12.4 Ry, about 900 plane
waves a k-point, exponents lowered so the small sphere holds the
functions): the job's timed call (QEData.from_arrays -> density ->
attach_wannier -> intgrid YT -> deloc_wannier with WANCUT 4) against
benchmark/reference/deloc.py, which finds the density, the basin
weights, the Wannier values and the translations by routes of its own.
Pure torch: nothing here compiles JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib import harness
from critic2_tpu_torch.fields.qe import (FortranFile, QEData, read_pwc,
                                         read_wannier_chk)

torch.set_num_threads(1)

GAP = 1e-10


def small_config(nk=(2, 2, 2)) -> dict:
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "nacl-b1-wannier-k4.json")) as fh:
        cfg = json.load(fh)
    cfg["grid"] = [24, 24, 24]
    m = cfg["density"]
    m["nk"] = list(nk)
    m["ecutwfc_ry"], m["ecutrho_ry"] = 12.4, 49.6
    m["species"] = {"Na": {"s": 0.33, "p": 0.16},
                    "Cl": {"s": 0.28, "p": 0.13}}
    return cfg


def small_pool(seed, npool=1, cfg=None):
    cfg = cfg or small_config()
    data = harness.data_model(cfg)
    pool = data.make_pool(cfg, seed, npool, "cpu")
    data.check_pool(cfg, pool, seed)
    return cfg, pool


def _job():
    return harness.load_module(os.path.join(harness.BENCH_DIR, "jobs",
                                            "deloc.py"), "bench_job_deloc")


@pytest.mark.parametrize("seed", [3100000401, 2 ** 33 + 17])
def test_job_matches_the_plain_reference(seed):
    cfg, pool = small_pool(seed)
    job = _job()
    ctx = harness.Context(cfg=cfg, traffic={}, device="cpu")
    out = job.run(ctx, pool[0])
    ans = job.reference(ctx, pool[0], torch.float64)
    assert np.array_equal(np.sort(out["iattr"]), ans["iattr"])
    assert len(ans["iattr"]) == 8
    nums = job.compare(ctx, out, ans)
    assert nums["attractors_unmatched"] == 0
    for k in ("fa_gap", "li_gap", "population_gap_e"):
        assert nums[k] <= GAP, (k, nums[k])
    # the populations hold the cell's electrons; LI never exceeds them
    assert out["population"].sum() == pytest.approx(64.0, abs=1e-9)
    assert np.all(out["li"] <= out["population"])


def _write_pwc(path, item):
    """The item in pw2critic.x's record layout (read_pwc's walk)."""
    evc = item["evc"].cpu().numpy()
    nspin, nks, nbnd, npwx = evc.shape
    with FortranFile(path, "wb") as fh:
        fh.write_record(np.int32(1))                         # version
        fh.write_record(np.array([2, 8], np.int32))          # nsp, nat
        fh.write_record(b"Na  Cl  ")                         # atm
        fh.write_record(np.array([1] * 4 + [2] * 4, np.int32))
        fh.write_record(np.zeros(24))                        # tau
        fh.write_record(np.asarray(item["at"]).flatten(order="F"))
        fh.write_record(np.array([nks, nbnd, nspin, 0], np.int32))
        fh.write_record(np.asarray(item["nk"], np.int32))
        fh.write_record(np.asarray(item["n"], np.int32))
        fh.write_record(np.array([npwx, len(item["nl"])], np.int32))
        fh.write_record(np.asarray(item["kpt"]).reshape(-1))
        fh.write_record(np.asarray(item["wk"]))
        fh.write_record(np.asarray(item["ek"]).reshape(-1))
        fh.write_record(np.asarray(item["occ"]).reshape(-1))
        fh.write_record(np.asarray(item["ngk"], np.int32))
        fh.write_record(np.asarray(item["igk_k"], np.int32).reshape(-1))
        fh.write_record(np.asarray(item["nl"], np.int32))
        for s in range(nspin):
            for ik in range(nks):
                for ib in range(nbnd):
                    fh.write_record(evc[s, ik, ib, :item["ngk"][ik]])


def _write_chk(path, item, nbnd):
    """The item's wannier90 data in the .chk record layout
    (read_wannier_chk's walk)."""
    u = np.asarray(item["u"])
    nks, nw = u.shape[0], u.shape[1]
    nk = np.asarray(item["nk"])
    kf = np.asarray(item["kpt"]) @ np.asarray(item["at"])
    rl = np.asarray(item["rlatt_ang"])
    with FortranFile(path, "wb") as fh:
        fh.write_record(b" " * 33)                           # header
        fh.write_record(np.int32(nbnd))
        fh.write_record(np.int32(0))                         # excluded bands
        fh.write_record(b"")
        fh.write_record(rl.flatten(order="F"))
        fh.write_record((2 * np.pi * np.linalg.inv(rl).T).flatten(order="F"))
        fh.write_record(np.int32(nks))
        fh.write_record(nk.astype(np.int32))
        fh.write_record(kf.reshape(-1))
        fh.write_record(np.int32(8))                         # nntot
        fh.write_record(np.int32(nw))
        fh.write_record(b" " * 20)                           # checkpoint
        fh.write_record(np.int32(0))                         # disentangled
        fh.write_record(u.transpose(0, 2, 1).reshape(-1))
        fh.write_record(np.zeros(2, np.complex128))          # m matrix
        fh.write_record(np.asarray(item["centres_ang"]).reshape(-1))
        fh.write_record(np.asarray(item["spreads_ang2"]))


def test_readers_equal_the_in_memory_builds_bit_for_bit(tmp_path):
    _, pool = small_pool(3100000411)
    item = pool[0]
    pwc, chk = str(tmp_path / "x.pwc"), str(tmp_path / "x.chk")
    _write_pwc(pwc, item)
    _write_chk(chk, item, item["evc"].shape[2])
    qf, rf = read_pwc(pwc, device="cpu")
    read_wannier_chk(qf, chk)
    qm = QEData.from_arrays(item["at"], item["nk"], item["n"], item["kpt"],
                            item["wk"], item["ek"], item["occ"],
                            item["ngk"], item["igk_k"], item["nl"], None,
                            item["evc"], fpwc=pwc)
    rm = qm.density()
    qm.attach_wannier([item["u"]], [item["centres_ang"]],
                      [item["spreads_ang2"]], [item["rlatt_ang"]])
    assert torch.equal(rf, rm)
    assert torch.equal(qf.evc, qm.evc)
    for k in ("nks", "nbnd", "nspin", "gamma_only", "n", "nlm", "fpwc",
              "iswan"):
        assert getattr(qf, k) == getattr(qm, k), k
    for k in ("nk", "at", "kpt", "wk", "ek", "occ", "ngk", "igk_k", "nl",
              "nbndw", "center", "spread", "u"):
        a, b = getattr(qf, k), getattr(qm, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # the same states through either route give the same Wannier images
    assert torch.equal(qf.wannier_home(0, 5), qm.wannier_home(0, 5))
