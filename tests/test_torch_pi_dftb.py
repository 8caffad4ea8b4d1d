"""The port's aiPI and DFTB+ fields against the JAX package.

aiPI: the He/Li ions of tests/test_pi.py in a 12 bohr cell; DFTB+: the
one-orbital H crystal of tests/test_dftb.py, at Gamma with real
eigenvectors and at two k-points with complex ones. Each fixture makes
one JAX evaluation at nder=2 and the same call on the port; the Field
level (System.load_field_pi, Field.from_file of detailed.xml) and the
DFTB+ kinetic-energy functions of expressions are held to the JAX
package's as well. Tolerances: values 1e-12 relative, derivatives and
DFTB+ quantities 1e-10.
"""
import numpy as np
import pytest
import torch

import test_dftb
import test_pi
from test_torch_lapw import _no_jax_cache_writes  # noqa: F401 (autouse)
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JaxField
from critic2_tpu.fields.pi import PiField as JaxPi
from critic2_tpu.system import System as JaxSystem
from critic2_tpu_torch import System, convert
from critic2_tpu_torch.fields.dftb import (DftbField, read_detailed_xml,
                                           read_eigenvec_bin,
                                           read_hsd_basis)
from critic2_tpu_torch.fields.pi import PiField, read_ion

torch.set_num_threads(1)


def _port(c):
    return convert.crystal_from_arrays(**convert.crystal_to_arrays(c))


def _close(a, b, tol, rel=False):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max() if rel else 1.0
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


# ---------------------------------------------------------------- aiPI

@pytest.fixture(scope="module")
def pi(tmp_path_factory):
    d = tmp_path_factory.mktemp("pi")
    (d / "he.ion").write_text(test_pi.ION_HE)
    (d / "li.ion").write_text(test_pi.ION_LI)
    ions = {"He": str(d / "he.ion"), "Li": str(d / "li.ion")}
    c = Crystal(m_x2c=np.eye(3) * 12.0,
                x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.5, 0.5]]),
                species_of=np.array([0, 1]),
                species=[Species("He", 2), Species("Li", 3)])
    pts = np.random.default_rng(1).uniform(0, 12, size=(24, 3))
    jpi = JaxPi.from_files(c, ions)
    jref = [np.asarray(v) for v in jpi.eval(pts)]
    r = JaxField(crystal=c, type="pi", pi=jpi).grd(pts, nder=2)
    return {"ions": ions, "crystal": c, "pts": pts, "ref": jref,
            "field": [np.asarray(v) for v in (r.f, r.gf, r.hf)]}


def test_pi_reader_and_tables_match(pi):
    for path in pi["ions"].values():
        a, b = read_ion(path), test_pi.read_ion(path)
        assert a["nsto"] == b["nsto"] and a["naos"] == b["naos"]
        np.testing.assert_array_equal(a["xnsto"], b["xnsto"])
    t = PiField.from_files(_port(pi["crystal"]), pi["ions"], device="cpu")
    j = JaxPi.from_files(pi["crystal"], pi["ions"])
    np.testing.assert_array_equal(t.cutoff, j.cutoff)
    np.testing.assert_array_equal(t.atpos.numpy(), np.asarray(j.atpos))
    np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))


@pytest.mark.parametrize("nder", [0, 2])
def test_pi_eval_matches_jax(pi, nder):
    t = PiField.from_files(_port(pi["crystal"]), pi["ions"], device="cpu")
    rho, g, h = (v.numpy() for v in t.eval(pi["pts"], nder=nder))
    _close(rho, pi["ref"][0], 1e-12, rel=True)
    _close(g, pi["ref"][1], 1e-10)
    if nder == 2:
        _close(h, pi["ref"][2], 1e-10)
    else:
        assert not h.any()


def test_pi_field_and_eval_fn_match_jax(pi):
    """System.load_field_pi: Field.grd equals the JAX package's, and
    eval_fn carries the same Hessian in the package's SYM6 order."""
    s = System.from_structure(_port(pi["crystal"]), device="cpu")
    fid = s.load_field_pi(pi["ions"])
    assert s.ref.type == "pi" and fid == 1
    r = s.ref.grd(pi["pts"], nder=2)
    jf, jg, jh = pi["field"]
    _close(r.f.numpy(), jf, 1e-12, rel=True)
    _close(r.gf.numpy(), jg, 1e-10)
    _close(r.hf.numpy(), jh, 1e-10)
    f, gf, h6 = s.ref.eval_fn(nder=2, clamp_nuclei=False)(
        torch.as_tensor(pi["pts"].T))
    hf = r.hf.numpy()
    _close(h6.numpy(), hf[:, [0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]].T,
           1e-14)


def test_pi_blocks_give_the_same_numbers(pi, monkeypatch):
    """A point block smaller than the batch changes no number."""
    from critic2_tpu_torch.fields import pi as pimod

    t = PiField.from_files(_port(pi["crystal"]), pi["ions"], device="cpu")
    whole = t.eval(pi["pts"])
    monkeypatch.setattr(pimod, "PAIR_ELEMENTS",
                        5 * t.atpos.shape[0] * max(t.nn.shape[1], 9))
    for a, b in zip(t.eval(pi["pts"]), whole):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- DFTB+

def _dftb_files(d, isreal):
    test_dftb.write_hsd(d / "wfc.hsd")
    if isreal:
        test_dftb.write_xml(d / "detailed.xml", [(np.zeros(3), 1.0)],
                            np.full((1, 1, 1), 2.0), True)
        test_dftb.write_bin(d / "eigenvec.bin", [np.array([1.0])], True)
    else:
        kpts = [(np.zeros(3), 0.5), (np.array([0.5, 0.25, 0.0]), 0.5)]
        occ = np.zeros((1, 2, 1))
        occ[0, 0, 0], occ[0, 1, 0] = 2.0, 1.0
        test_dftb.write_xml(d / "detailed.xml", kpts, occ, False)
        test_dftb.write_bin(d / "eigenvec.bin",
                            [np.array([1.0 + 0j]),
                             np.array([0.6 + 0.8j])], False)
    return [str(d / f) for f in ("detailed.xml", "eigenvec.bin", "wfc.hsd")]


EXPRS = ("gkin(1)", "kkin(1)", "elf(1)", "lol(1)")


@pytest.fixture(scope="module", params=["real", "complex"])
def dftb(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("dftb")
    files = _dftb_files(d, request.param == "real")
    c = Crystal(m_x2c=np.diag([test_dftb.A] * 3), x_frac=np.zeros((1, 3)),
                species_of=np.array([0]), species=[Species("H", 1)])
    pts = np.random.default_rng(3).random((20, 3)) * test_dftb.A
    js = JaxSystem.from_structure(c)
    js.load_field(files[0], file2=files[1], file3=files[2])
    ref = [np.asarray(v) for v in js.ref.dftb.eval(pts, nder=2)]
    r = js.ref.grd(pts, nder=2)
    exprs = {e: np.asarray(js.eval_expr(e, pts)) for e in EXPRS}
    return {"files": files, "crystal": c, "pts": pts, "ref": ref,
            "field": [np.asarray(v) for v in (r.f, r.gf, r.hf)],
            "exprs": exprs, "isreal": request.param == "real"}


def test_dftb_readers_match(dftb):
    xml, binf, hsd = dftb["files"]
    a, b = read_detailed_xml(xml), test_dftb.read_detailed_xml(xml)
    assert a["isreal"] == b["isreal"] == dftb["isreal"]
    np.testing.assert_array_equal(a["kpts"], b["kpts"])
    np.testing.assert_array_equal(a["occ"], b["occ"])
    ev = read_eigenvec_bin(binf, 1, 1, a["nkpt"], 1, a["isreal"])
    np.testing.assert_array_equal(ev, test_dftb.read_eigenvec_bin(
        binf, 1, 1, a["nkpt"], 1, a["isreal"]))
    orb = read_hsd_basis(hsd)[1][0]
    np.testing.assert_array_equal(orb.coef, test_dftb.read_hsd_basis(hsd)
                                  [1][0].coef)


def test_dftb_eval_matches_jax(dftb):
    t = DftbField.from_files(_port(dftb["crystal"]), *dftb["files"],
                             device="cpu")
    rho, g, H, gk = (v.numpy() for v in t.eval(dftb["pts"], nder=2,
                                               block=7))
    jr, jg, jh, jgk = dftb["ref"]
    _close(rho, jr, 1e-12, rel=True)
    _close(g, jg, 1e-10)
    _close(H, jh, 1e-10)
    _close(gk, jgk, 1e-10)
    # nder=1 leaves the Hessian zero and the rest unchanged
    r1, g1, h1, k1 = t.eval(dftb["pts"], nder=1)
    assert not h1.any()
    _close(g1.numpy(), jg, 1e-10)


def test_dftb_field_and_expressions_match_jax(dftb):
    """Field.from_file of detailed.xml (file2/file3) and the kinetic
    energy functions of expressions (gkin, kkin, elf, lol)."""
    s = System.from_structure(_port(dftb["crystal"]), device="cpu")
    xml, binf, hsd = dftb["files"]
    s.load_field(xml, file2=binf, file3=hsd)
    assert s.ref.type == "dftb"
    r = s.ref.grd(dftb["pts"], nder=2)
    jf, jg, jh = dftb["field"]
    _close(r.f.numpy(), jf, 1e-12, rel=True)
    _close(r.gf.numpy(), jg, 1e-10)
    _close(r.hf.numpy(), jh, 1e-10)
    for e in EXPRS:
        v = s.eval_expr(e, dftb["pts"]).numpy()
        _close(v, dftb["exprs"][e], 1e-10, rel=True)
    elf = s.eval_expr("elf(1)", dftb["pts"]).numpy()
    assert np.all((elf >= 0) & (elf <= 1))
