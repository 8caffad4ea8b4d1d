"""The port's pwc reader, Wannier functions, delocalization indices and
state cubes against the JAX package.

The synthetic pwc and wannier90 chk files of tests/test_deloc.py (8^3
grid, nbnd 2) go through both packages: nk 2x1x1 for the slice (pwc ->
intgrid YT -> deloc_wannier with the U rotation) and the non-cubic nk
2x1x3, which would show a swap of the k-grid axes or of the lattice
vector order. Tolerances, port against JAX: the density 1e-12 relative,
Wannier functions 1e-12, Sij and Fa 1e-10; populations against the YT
basin populations 5e-6 e, as the JAX test holds them.
"""
import os

import numpy as np
import pytest
import torch

import test_deloc
from test_torch_lapw import _no_jax_cache_writes  # noqa: F401 (autouse)
from critic2_tpu.analysis.deloc import deloc_wannier as jax_deloc
from critic2_tpu.analysis.yt import yt_integrate as jax_yt
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.qe import read_pwc as jax_read_pwc
from critic2_tpu.fields.qe import read_wannier_chk as jax_read_chk
from critic2_tpu_torch import System, convert
from critic2_tpu_torch.analysis.deloc import (deloc_wannier, read_fachk,
                                              read_sijchk, write_fachk,
                                              write_sijchk)
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.analysis.rhoplot import cube_states
from critic2_tpu_torch.fields.qe import read_pwc, read_wannier_chk

torch.set_num_threads(1)

A = 6.0
N = (8, 8, 8)


def _crystal():
    return Crystal(m_x2c=np.eye(3) * A,
                   x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.75, 0.75]]),
                   species_of=np.array([0, 0]), species=[Species("He", 2)])


def _unitaries(nks, nw, seed):
    rng = np.random.default_rng(seed)
    u = np.empty((nks, nw, nw), np.complex128)
    for ik in range(nks):
        m = rng.normal(size=(nw, nw)) + 1j * rng.normal(size=(nw, nw))
        u[ik] = np.linalg.qr(m)[0]
    return u


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    """nk 2x1x1 with a chk: both packages read it, run YT and deloc with
    the U rotation once."""
    d = tmp_path_factory.mktemp("pwc")
    at = np.eye(3) * A
    path = str(d / "test.pwc")
    _, kf, _, _ = test_deloc.write_pwc(path, at, (2, 1, 1), 2, N)
    chk = str(d / "test.chk")
    rng = np.random.default_rng(4)
    test_deloc.write_chk(chk, 2, 2, (2, 1, 1), kf, at, _unitaries(2, 2, 3),
                         centers=rng.uniform(0, 1, (2, 3)),
                         spreads=rng.uniform(0.5, 1.5, 2))
    c = _crystal()
    jq, jrho = jax_read_pwc(path)
    jax_read_chk(jq, chk)
    jd = jax_yt(c, jrho)
    jres = jax_deloc(c, jd, jq, useu=True)
    pop_yt = jd.integrate(jrho.reshape(-1)) * c.volume / jrho.size
    return {"path": path, "chk": chk, "crystal": c, "jq": jq, "jrho": jrho,
            "jres": jres, "pop_yt": pop_yt}


@pytest.fixture(scope="module")
def noncubic(tmp_path_factory):
    """nk 2x1x3: the density and every Wannier image from both
    packages."""
    d = tmp_path_factory.mktemp("pwc3")
    path = str(d / "nc.pwc")
    test_deloc.write_pwc(path, np.eye(3) * A, (2, 1, 3), 2, N, seed=9)
    jq, jrho = jax_read_pwc(path)
    W = [np.asarray(jq.wannier_home(0, b, useu=False)) for b in range(2)]
    return {"path": path, "jq": jq, "jrho": jrho, "W": W}


def _port_system(path, chk=None):
    c = convert.crystal_from_arrays(**convert.crystal_to_arrays(_crystal()))
    s = System.from_structure(c, device="cpu")
    s.load_field(path, **({"file2": chk} if chk else {}))
    return s


@pytest.mark.parametrize("case", ["slice", "noncubic"])
def test_read_pwc_matches_jax(case, slice_, noncubic):
    fx = slice_ if case == "slice" else noncubic
    qe, rho = read_pwc(fx["path"], device="cpu")
    assert rho.dtype == torch.float64 and rho.is_contiguous()
    jrho = fx["jrho"]
    assert np.abs(rho.numpy() - jrho).max() <= 1e-12 * np.abs(jrho).max()
    a, b = convert.qedata_to_arrays(qe), convert.qedata_to_arrays(fx["jq"])
    for k in ("nk", "kpt", "wk", "ek", "occ", "ngk", "igk_k", "nl", "evc"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["n"] == b["n"] and a["nks"] == b["nks"]
    # the density holds fspin * nbnd electrons per cell
    assert float(rho.sum()) * A ** 3 / rho.numel() == pytest.approx(4.0,
                                                                    abs=1e-9)


def test_noncubic_wannier_images_match_jax(noncubic):
    """nk 2x1x3: rvectors in the ilat = k3 + nk3 (k2 + nk2 k1) order and
    each band's lattice images, Bloch stacks and k-phases as the JAX
    package builds them."""
    qe, _ = read_pwc(noncubic["path"], device="cpu")
    np.testing.assert_array_equal(qe.rvectors(), noncubic["jq"].rvectors())
    assert qe.rvectors()[1].tolist() == [0, 0, 1]
    for b in range(2):
        W = qe.wannier_home(0, b, useu=False)
        assert tuple(W.shape) == (6,) + N
        np.testing.assert_allclose(W.numpy(), noncubic["W"][b], rtol=0,
                                   atol=1e-12)
        u = qe.bloch_on_grid(0, b, useu=False).numpy()
        ju = np.asarray(noncubic["jq"].bloch_on_grid(0, b, useu=False))
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-12)


def test_chk_reader_matches_jax(slice_):
    qe, _ = read_pwc(slice_["path"], device="cpu")
    read_wannier_chk(qe, slice_["chk"])
    a, b = convert.qedata_to_arrays(qe), convert.qedata_to_arrays(slice_["jq"])
    assert a["iswan"] and b["iswan"]
    for k in ("u", "center", "spread", "nbndw", "nk"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a QEData carried across from the JAX package gives the same states
    q2 = convert.qedata_from_arrays(**b, device="cpu")
    np.testing.assert_allclose(q2.wannier_home(0, 1).numpy(),
                               qe.wannier_home(0, 1).numpy(), atol=1e-14)


@pytest.fixture(scope="module")
def port_deloc(slice_):
    """The port's slice: pwc + chk through Field.from_file, intgrid YT,
    deloc_wannier(useu=True)."""
    s = _port_system(slice_["path"], slice_["chk"])
    res = intgrid(s, method="yt")
    qe = s.ref.grid.qe
    stats = {}
    out = deloc_wannier(s.crystal, res.decomp, qe, useu=True, device="cpu",
                        stats=stats)
    return {"system": s, "intres": res, "res": out, "stats": stats}


def test_deloc_slice_matches_jax(slice_, port_deloc):
    res, jres = port_deloc["res"], slice_["jres"]
    a = convert.deloc_to_arrays(res)
    b = convert.deloc_to_arrays(jres)
    np.testing.assert_allclose(a["xattr"], b["xattr"], atol=1e-12)
    np.testing.assert_allclose(a["sij"][0], b["sij"][0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(a["fa"], b["fa"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(a["li"], b["li"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(a["rvec"], b["rvec"])
    # sum rules: the U rotation keeps the YT basin populations
    np.testing.assert_allclose(res.population(), slice_["pop_yt"],
                               atol=5e-6)
    assert res.population().sum() == pytest.approx(4.0, abs=1e-6)
    assert np.all(res.li() <= res.population() + 1e-12)
    assert set(port_deloc["stats"]) == {"support", "wannier", "sij", "fa"}
    assert res.table().startswith("# LI/DI")


def test_deloc_without_u_and_with_wancut(slice_, port_deloc):
    """useu=False keeps the populations; wancut=4 (the reference's
    default) only drops overlaps, so each Sij entry is the exact one or
    zero."""
    s = port_deloc["system"]
    qe, decomp = s.ref.grid.qe, port_deloc["intres"].decomp
    plain = deloc_wannier(s.crystal, decomp, qe, useu=False, device="cpu")
    np.testing.assert_allclose(plain.population(), slice_["pop_yt"],
                               atol=5e-6)
    cut = deloc_wannier(s.crystal, decomp, qe, useu=True, wancut=4.0,
                        device="cpu")
    full = port_deloc["res"].sij[0]
    kept = cut.sij[0] != 0
    np.testing.assert_allclose(cut.sij[0][kept], full[kept], atol=1e-14)
    assert np.abs(cut.sij[0][~kept]).max(initial=0.0) == 0.0


def test_deloc_checkpoints_round_trip(port_deloc, tmp_path):
    res = port_deloc["res"]
    write_fachk(str(tmp_path / "fa.npz"), res)
    back = read_fachk(str(tmp_path / "fa.npz"))
    np.testing.assert_array_equal(back.fa, res.fa)
    np.testing.assert_array_equal(back.li(), res.li())
    write_sijchk(str(tmp_path / "sij.npz"), res)
    np.testing.assert_array_equal(read_sijchk(str(tmp_path / "sij.npz"))
                                  ["sij0"], res.sij[0])
    agg = res.aggregate(np.zeros(res.nattr, dtype=int), 1)
    assert agg.population()[0] == pytest.approx(res.population().sum())


def test_cube_states_unk_psink_rebuild_the_density(slice_, tmp_path):
    """UNK and PSINK agree through the Bloch phase, and the occupation
    weighted |psi_nk|^2 sum rebuilds the pwc density; the re/im cube
    pair lands on disk."""
    s = _port_system(slice_["path"])
    qe = s.ref.grid.qe
    n1, n2, n3 = N
    i, j, k = np.meshgrid(np.arange(n1), np.arange(n2), np.arange(n3),
                          indexing="ij")
    acc = np.zeros(N)
    for ik in range(qe.nks):
        kpt = qe.kpt[ik]
        ph = np.exp(2j * np.pi * (kpt[0] * i / n1 + kpt[1] * j / n2
                                  + kpt[2] * k / n3))
        for b in range(qe.nbnd):
            u, _ = cube_states(s, "unk", b + 1, ik=ik + 1, write=False)
            psi, _ = cube_states(s, "psink", b + 1, ik=ik + 1, write=False)
            np.testing.assert_allclose(psi.numpy(), u.numpy() * ph,
                                       atol=1e-12)
            acc += qe.occ[ik, b] * np.abs(psi.numpy()) ** 2
    acc *= 2.0 / (abs(np.linalg.det(qe.at)) * qe.wk.sum())
    np.testing.assert_allclose(acc, slice_["jrho"], atol=1e-10)
    _, files = cube_states(s, "psink", 1, ik=1, fileroot=str(tmp_path / "st"))
    assert len(files) == 2 and all(os.path.exists(p) for p in files)


def test_cube_states_wannier_and_mlwf_supercells(slice_, tmp_path):
    """WANNIER and MLWF lay the JAX package's lattice images out cell copy
    by cell copy on the nk supercell, MLWF with the chk's U rotation."""
    s = _port_system(slice_["path"], slice_["chk"])
    jq = slice_["jq"]
    nk, n = tuple(int(v) for v in jq.nk), N

    def assemble(W):
        S = np.empty((nk[0] * n[0], nk[1] * n[1], nk[2] * n[2]), complex)
        for r1, r2, r3 in jq.rvectors():
            jl = ((((-r1) % nk[0]) * nk[1] + ((-r2) % nk[1])) * nk[2]
                  + ((-r3) % nk[2]))
            S[r1 * n[0]:(r1 + 1) * n[0], r2 * n[1]:(r2 + 1) * n[1],
              r3 * n[2]:(r3 + 1) * n[2]] = W[jl]
        return S

    written = []
    for kind, useu in (("wannier", False), ("mlwf", True)):
        S, files = cube_states(s, kind, 2, fileroot=str(tmp_path / "w"),
                               write=(kind == "wannier"))
        written += files
        ref = assemble(np.asarray(jq.wannier_home(0, 1, useu=useu)))
        np.testing.assert_allclose(S.numpy(), ref, rtol=0, atol=1e-12)
    assert len(written) == 2
    with open(written[0]) as fh:
        lines = fh.readlines()
    assert int(lines[2].split()[0]) == jq.nlat * 2
    assert int(lines[3].split()[0]) == nk[0] * n[0]
