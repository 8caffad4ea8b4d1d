"""Carry state across from the JAX package as plain numpy arrays.

A structure travels as m_x2c (3,3), x_frac (ncel,3), species_of (ncel,),
species [(name, Z)] and, for a molecule, ismolecule / molx0 / molborder;
a grid field as its (n1,n2,n3) array; a critical-point list as one array
per attribute (the bond/ring-path graph included); a Bader result, an
integration result's rows and a qtree result likewise; a molecular
wavefunction as its primitive arrays (atpos, atz, icenter, itype, e,
cmo, occ, the EDF arrays, wfntyp, nalpha); a QE pwc state set (with its
wannier90 data) and a delocalization result likewise. From them
the port builds its own Crystal, Field and System, so both packages
compute on identical inputs. Nothing here imports the JAX package: the
caller reads the arrays off its objects (``crystal_to_arrays`` works on
either package's Crystal, since both carry the same attributes).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import FDTYPE, resolve_device
from .crystal.crystal import Crystal, Species


def crystal_to_arrays(crystal) -> dict:
    """The numpy form of a Crystal of either package."""
    return {"m_x2c": np.array(crystal.m_x2c, dtype=float),
            "x_frac": np.array(crystal.x_frac, dtype=float),
            "species_of": np.array(crystal.species_of, dtype=int),
            "species": [(str(s.name), int(s.z)) for s in crystal.species],
            "ismolecule": bool(crystal.ismolecule),
            "molx0": (None if crystal.molx0 is None
                      else np.array(crystal.molx0, dtype=float)),
            "molborder": np.array(crystal.molborder, dtype=float)}


def crystal_from_arrays(m_x2c, x_frac, species_of, species,
                        ismolecule: bool = False, molx0=None,
                        molborder=(0.0, 0.0, 0.0)) -> Crystal:
    """The port's Crystal from the numpy form."""
    return Crystal(m_x2c=np.array(m_x2c, dtype=float),
                   x_frac=np.array(x_frac, dtype=float),
                   species_of=np.array(species_of, dtype=int),
                   species=[Species(str(n), int(z)) for n, z in species],
                   ismolecule=bool(ismolecule),
                   molx0=None if molx0 is None else np.array(molx0,
                                                             dtype=float),
                   molborder=np.array(molborder, dtype=float))


def system_from_arrays(m_x2c, x_frac, species_of, species, grid=None,
                       name: str = "grid", device=None,
                       interp: str | None = None, **molecule):
    """The port's System: promolecular field 0 and, when `grid` is given,
    that grid as field 1 (the reference field) with interpolation mode
    `interp` (the grid default when None), all on `device` (cuda by
    default). `molecule` takes ismolecule / molx0 / molborder."""
    from .fields.field import Field
    from .fields.grid3 import Grid3
    from .system import System

    c = crystal_from_arrays(m_x2c, x_frac, species_of, species, **molecule)
    s = System.from_structure(c, device=device)
    if grid is not None:
        g = Grid3(torch.tensor(np.asarray(grid), dtype=FDTYPE,
                               device=resolve_device(device)))
        if interp is not None:
            g.setmode(interp)
        s.load_field(Field.from_grid(c, g, name=name))
    return s


def cplist_to_arrays(cpl) -> dict:
    """The numpy form of a critical-point list of either package: one
    array per CP attribute, in list order."""
    cps = cpl.cps
    return {"typ": np.array([cp.typ for cp in cps], dtype=int),
            "x": np.array([cp.x for cp in cps], dtype=float).reshape(-1, 3),
            "r": np.array([cp.r for cp in cps], dtype=float).reshape(-1, 3),
            "f": np.array([cp.f for cp in cps], dtype=float),
            "gfmod": np.array([cp.gfmod for cp in cps], dtype=float),
            "del2f": np.array([cp.del2f for cp in cps], dtype=float),
            "eig": np.array([np.asarray(cp.eig) for cp in cps],
                            dtype=float).reshape(-1, 3),
            "mult": np.array([cp.mult for cp in cps], dtype=int),
            "isnuc": np.array([cp.isnuc for cp in cps], dtype=bool),
            "name": np.array([cp.name for cp in cps], dtype=str),
            # the graph of makegraph; CPs without paths read -1 / 0 / 0
            "ipath": np.array([_or(cp, "ipath", [-1, -1]) for cp in cps],
                              dtype=int).reshape(-1, 2),
            "brpathlen": np.array([_or(cp, "brpathlen", [0.0, 0.0])
                                   for cp in cps], dtype=float).reshape(-1, 2),
            "brvec": np.array([_or(cp, "brvec", np.zeros(3)) for cp in cps],
                              dtype=float).reshape(-1, 3)}


def _or(obj, attr, default):
    value = getattr(obj, attr, None)
    return default if value is None else value


def bader_to_arrays(res) -> dict:
    """The numpy form of a BaderResult of either package."""
    return {"labels": np.asarray(res.labels, dtype=np.int64),
            "iattr": np.asarray(res.iattr, dtype=np.int64),
            "xattr": np.asarray(res.xattr, dtype=float).reshape(-1, 3),
            "nattr": int(res.nattr)}


def integration_to_arrays(intres) -> dict:
    """The numpy form of an IntegrationResult's rows, of either package."""
    rows = intres.rows
    return {"name": np.array([r.name for r in rows], dtype=str),
            "atom": np.array([r.atom for r in rows], dtype=int),
            "xfrac": np.array([r.xfrac for r in rows],
                              dtype=float).reshape(-1, 3),
            "volume": np.array([r.volume for r in rows], dtype=float),
            "pop": np.array([r.pop for r in rows], dtype=float),
            "attr_map": np.array(intres.attr_map, dtype=int)}


_WFN_ARRAYS = ("atpos", "atz", "icenter", "itype", "e", "cmo", "occ",
               "edf_icenter", "edf_itype", "edf_e", "edf_c")


def wavefunction_to_arrays(wfn) -> dict:
    """The numpy form of a Wavefunction of either package (copies; the
    EDF arrays are None without an EDF core density)."""
    out = {k: (None if getattr(wfn, k) is None
               else np.array(getattr(wfn, k))) for k in _WFN_ARRAYS}
    out.update(wfntyp=str(wfn.wfntyp), nalpha=int(wfn.nalpha),
               source=str(wfn.source))
    return out


def wavefunction_from_arrays(atpos, atz, icenter, itype, e, cmo, occ,
                             wfntyp: str = "rhf", nalpha: int = 0,
                             source: str = "", edf_icenter=None,
                             edf_itype=None, edf_e=None, edf_c=None):
    """The port's Wavefunction from the numpy form."""
    from .fields.wfn import Wavefunction

    def opt(a, dt):
        return None if a is None else np.array(a, dtype=dt)

    return Wavefunction(
        atpos=np.array(atpos, dtype=float), atz=np.array(atz, dtype=int),
        icenter=np.array(icenter, dtype=np.int32),
        itype=np.array(itype, dtype=np.int32), e=np.array(e, dtype=float),
        cmo=np.array(cmo, dtype=float), occ=np.array(occ, dtype=float),
        wfntyp=str(wfntyp), nalpha=int(nalpha), source=str(source),
        edf_icenter=opt(edf_icenter, np.int32),
        edf_itype=opt(edf_itype, np.int32), edf_e=opt(edf_e, float),
        edf_c=opt(edf_c, float))


def qtree_to_arrays(res) -> dict:
    """The numpy form of a QtreeResult of either package."""
    return {"names": np.array(res.names, dtype=str),
            "pops": np.array(res.pops, dtype=float),
            "volumes": np.array(res.volumes, dtype=float),
            "nlevels": int(res.nlevels), "ntraced": int(res.ntraced),
            "nrefined": int(res.nrefined)}


_QE_ARRAYS = ("nk", "at", "kpt", "wk", "ek", "occ", "ngk", "igk_k", "nl",
              "nlm", "evc", "nbndw", "center", "spread", "u")


def _host(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


def qedata_to_arrays(qe) -> dict:
    """The numpy form of a QEData of either package: the pwc arrays (the
    plane-wave coefficients `evc` included) and the wannier90 U
    matrices, centres and spreads (None where no chk was read)."""
    out = {k: _host(getattr(qe, k)) for k in _QE_ARRAYS}
    out.update(nks=int(qe.nks), nbnd=int(qe.nbnd), nspin=int(qe.nspin),
               gamma_only=bool(qe.gamma_only),
               n=tuple(int(v) for v in qe.n), fpwc=str(qe.fpwc),
               iswan=bool(qe.iswan))
    return out


def qedata_from_arrays(nks, nk, nbnd, nspin, gamma_only, n, at, kpt, wk,
                       ek, occ, ngk, igk_k, nl, nlm, evc, fpwc="",
                       iswan=False, nbndw=None, center=None, spread=None,
                       u=None, device=None):
    """The port's QEData from the numpy form, its coefficients on
    `device` (cuda by default)."""
    from .fields.qe import QEData

    return QEData(
        nks=int(nks), nk=np.array(nk, dtype=np.int64), nbnd=int(nbnd),
        nspin=int(nspin), gamma_only=bool(gamma_only),
        n=tuple(int(v) for v in n), at=np.array(at, dtype=float),
        kpt=np.array(kpt, dtype=float), wk=np.array(wk, dtype=float),
        ek=np.array(ek, dtype=float), occ=np.array(occ, dtype=float),
        ngk=np.array(ngk, dtype=np.int64),
        igk_k=np.array(igk_k, dtype=np.int64),
        nl=np.array(nl, dtype=np.int64),
        nlm=None if nlm is None else np.array(nlm, dtype=np.int64),
        evc=torch.as_tensor(np.asarray(evc, dtype=np.complex128),
                            device=resolve_device(device)),
        fpwc=str(fpwc), iswan=bool(iswan),
        nbndw=(np.zeros(2, np.int64) if nbndw is None
               else np.array(nbndw, dtype=np.int64)),
        center=None if center is None else np.array(center, dtype=float),
        spread=None if spread is None else np.array(spread, dtype=float),
        u=None if u is None else np.array(u, dtype=np.complex128))


def deloc_to_arrays(res) -> dict:
    """The numpy form of a DelocResult of either package."""
    return {"nspin": int(res.nspin), "fspin": float(res.fspin),
            "nk": np.array(res.nk, dtype=np.int64),
            "nbndw": np.array(res.nbndw, dtype=np.int64),
            "sij": [np.array(s) for s in res.sij],
            "fa": np.array(res.fa, dtype=float),
            "xattr": np.array(res.xattr, dtype=float),
            "rvec": np.array(res.rvec, dtype=np.int64),
            "li": np.array(res.li(), dtype=float),
            "population": np.array(res.population(), dtype=float)}
