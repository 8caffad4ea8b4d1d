"""Abinit binary header parser and _DEN/_POT/_ELF grid reader.

Role of the reference abinit_private (src/abinit_private.f90:32,
src/abinit_private@proc.f90:185-780 hdr_io/hdr_io_1/hdr_io_2) and
read_abinit (src/grid3mod@proc.f90:536-574): parse the versioned Fortran
header of abinit binary output files (headforms 22-57 legacy, >=80
modern), then read the first (n1,n2,n3) density record.

Pure host-side I/O; the grid goes to the device via Grid3.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

_LEGACY_FORMS = (22, 23, 34, 40, 41, 42, 44, 53, 56, 57)


class _Rec:
    """Cursor over one Fortran record's payload bytes."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def take(self, dtype, count=1):
        dt = np.dtype(dtype)
        out = np.frombuffer(self.raw, dtype=dt, count=count, offset=self.pos)
        self.pos += dt.itemsize * count
        return out if count != 1 else out[0]

    def skip(self, nbytes):
        self.pos += nbytes

    @property
    def nbytes(self):
        return len(self.raw)


def _records(fh):
    while True:
        head = fh.read(4)
        if len(head) < 4:
            return
        n = int(np.frombuffer(head, np.int32)[0])
        raw = fh.read(n)
        tail = fh.read(4)
        if len(tail) < 4 or int(np.frombuffer(tail, np.int32)[0]) != n:
            raise ValueError("corrupt Fortran record in abinit file")
        yield _Rec(raw)


@dataclass
class AbinitHeader:
    codvsn: str = ""
    headform: int = 0
    fform: int = 0
    natom: int = 0
    ntypat: int = 0
    nspden: int = 1
    nsppol: int = 1
    usepaw: int = 0
    ngfft: np.ndarray = dfield(default_factory=lambda: np.zeros(3, np.int64))
    rprimd: np.ndarray = dfield(default_factory=lambda: np.eye(3))
    xred: np.ndarray | None = None            # (natom, 3)
    typat: np.ndarray | None = None           # (natom,) 1-based
    znucltypat: np.ndarray | None = None      # (ntypat,)
    etot: float = 0.0
    fermie: float = 0.0


def read_header(fh) -> AbinitHeader:
    """Parse the abinit header; leaves `fh` positioned at the first data
    record. Mirrors hdr_io_1 (legacy) and hdr_io_2 (headform>=80)."""
    recs = _records(fh)
    h = AbinitHeader()

    r = next(recs)
    # first record: codvsn(6|8) + headform + fform, or codvsn + fform (pre-2.0)
    slen = r.nbytes - 8
    if slen in (6, 8):
        h.codvsn = r.take("S%d" % slen).decode(errors="replace").strip()
        h.headform = int(r.take(np.int32))
        h.fform = int(r.take(np.int32))
    elif r.nbytes - 4 in (6, 8):
        h.codvsn = r.take("S%d" % (r.nbytes - 4)).decode(errors="replace").strip()
        h.fform = int(r.take(np.int32))
        if h.fform not in (1, 2, 51, 52, 101, 102):
            raise ValueError(f"unsupported old abinit fform {h.fform}")
        h.headform = 22
    else:
        raise ValueError("unrecognized abinit first record")
    if h.headform not in _LEGACY_FORMS and h.headform < 80:
        raise ValueError(f"unsupported abinit headform {h.headform}")

    hf = h.headform
    r = next(recs)
    i32 = lambda n=1: r.take(np.int32, n)  # noqa: E731
    f64 = lambda n=1: r.take(np.float64, n)  # noqa: E731
    if hf >= 80:
        bantot, _date, _intxc, _ixc = (int(v) for v in i32(4))
        h.natom = int(i32())
        h.ngfft = np.asarray(i32(3), np.int64)
        nkpt = int(i32())
        h.nspden = int(i32())
        _nspinor = int(i32())
        h.nsppol = int(i32())
        nsym = int(i32())
        npsp = int(i32())
        h.ntypat = int(i32())
        _occopt, _pertcase, usepaw = (int(v) for v in i32(3))
        h.usepaw = usepaw
        f64(4)                                   # ecut, ecutdg, ecutsm, ecut_eff
        f64(3)                                   # qptn
        h.rprimd = np.asarray(f64(9)).reshape(3, 3, order="F")
        f64(3)                                   # stmbias, tphysel, tsmear
        _usewvl = int(i32())
        nshiftk_orig, nshiftk, mband = (int(v) for v in i32(3))
    else:
        bantot, _date, _intxc, _ixc = (int(v) for v in i32(4))
        h.natom = int(i32())
        h.ngfft = np.asarray(i32(3), np.int64)
        nkpt = int(i32())
        if hf == 22:
            h.nsppol = int(i32())
            nsym = int(i32())
            h.ntypat = int(i32())
            npsp = h.ntypat
            f64(3)                               # acell
            f64()                                # ecut_eff
        else:
            h.nspden = int(i32())
            _nspinor = int(i32())
            h.nsppol = int(i32())
            nsym = int(i32())
            if hf == 23:
                h.ntypat = int(i32())
                npsp = h.ntypat
                _occopt = int(i32())
                f64(3)                           # acell
                f64()                            # ecut_eff
            else:
                npsp = int(i32())
                h.ntypat = int(i32())
                _occopt = int(i32())
                if hf >= 41:
                    _pertcase = int(i32())
                if hf >= 44:
                    h.usepaw = int(i32())
                if hf >= 40:
                    f64()                        # ecut
                if hf >= 44:
                    f64()                        # ecutdg
                if hf >= 40:
                    f64()                        # ecutsm
                f64()                            # ecut_eff
                if hf >= 41:
                    f64(3)                       # qptn
        h.rprimd = np.asarray(f64(9)).reshape(3, 3, order="F")
        if hf >= 42:
            f64()                                # stmbias
        if hf >= 40:
            f64(2)                               # tphysel, tsmear
        if hf >= 57:
            i32()                                # usewvl

    # third record: per-kpt / symmetry / types arrays
    r = next(recs)
    if hf >= 80:
        r.skip(4 * nkpt)                                  # istwfk
        nband = r.take(np.int32, nkpt * h.nsppol)
        r.skip(4 * nkpt)                                  # npwarr
        r.skip(4 * npsp)                                  # so_psp
        r.skip(4 * nsym)                                  # symafm
        r.skip(4 * 9 * nsym)                              # symrel
        h.typat = np.atleast_1d(np.asarray(r.take(np.int32, h.natom), np.int64))
        r.skip(8 * 3 * nkpt)                              # kptns
        r.skip(8 * mband * nkpt * h.nsppol)               # occ3d
        r.skip(8 * 3 * nsym)                              # tnons
        h.znucltypat = np.atleast_1d(np.asarray(r.take(np.float64, h.ntypat)))
        r.skip(8 * nkpt)                                  # wtk
        # final record: residm, xred, etot, fermie, amu
        r = next(recs)
        r.skip(8)
        h.xred = np.atleast_1d(np.asarray(r.take(np.float64, 3 * h.natom))).reshape(h.natom, 3)
        h.etot = float(r.take(np.float64))
        h.fermie = float(r.take(np.float64))
        next(recs)                                        # kptopt/…/shiftk
        for _ in range(npsp):
            next(recs)                                    # psp title records
        if h.usepaw == 1:
            _skip_pawrhoij(recs, h, hf)
    else:
        old3 = hf in (22, 23, 34)
        if old3:
            nband = r.take(np.int32, nkpt * h.nsppol)
            r.skip(4 * nkpt)                              # npwarr
            r.skip(4 * 9 * nsym)                          # symrel
            h.typat = np.atleast_1d(np.asarray(r.take(np.int32, h.natom), np.int64))
            if not (hf == 22 and h.fform in (1, 51, 101)):
                r.skip(4 * nkpt)                          # istwfk
            r.skip(8 * 3 * nkpt)                          # kptns
            r.skip(8 * bantot)                            # occ
            r.skip(8 * 3 * nsym)                          # tnons
            h.znucltypat = np.atleast_1d(np.asarray(r.take(np.float64, h.ntypat)))
        else:
            r.skip(4 * nkpt)                              # istwfk
            nband = r.take(np.int32, nkpt * h.nsppol)
            r.skip(4 * nkpt)                              # npwarr
            r.skip(4 * npsp)                              # so_psp
            r.skip(4 * nsym)                              # symafm
            r.skip(4 * 9 * nsym)                          # symrel
            h.typat = np.atleast_1d(np.asarray(r.take(np.int32, h.natom), np.int64))
            r.skip(8 * 3 * nkpt)                          # kptns
            r.skip(8 * bantot)                            # occ
            r.skip(8 * 3 * nsym)                          # tnons
            h.znucltypat = np.atleast_1d(np.asarray(r.take(np.float64, h.ntypat)))
            if hf >= 50:
                r.skip(8 * nkpt)                          # wtk
        for _ in range(npsp):
            next(recs)                                    # psp records
        r = next(recs)                                    # final record
        r.skip(8)                                         # residm
        h.xred = np.atleast_1d(np.asarray(r.take(np.float64, 3 * h.natom))).reshape(h.natom, 3)
        h.etot = float(r.take(np.float64))
        if hf != 22:
            h.fermie = float(r.take(np.float64))
        if h.usepaw == 1:
            _skip_pawrhoij(recs, h, hf)
    return h


def _skip_pawrhoij(recs, h, hf):
    """Skip the PAW rhoij records (pawrhoij_io layout)."""
    next(recs)
    next(recs)


def read_den(path: str):
    """(header, grid (n1,n2,n3)) from an abinit _DEN/_POT/_ELF file; the
    first data record is the total density (read_abinit,
    src/grid3mod@proc.f90:536-574)."""
    with open(path, "rb") as fh:
        h = read_header(fh)
        n1, n2, n3 = (int(v) for v in h.ngfft)
        for r in _records(fh):
            if r.nbytes >= 8 * n1 * n2 * n3:
                g = np.asarray(r.take(np.float64, n1 * n2 * n3))
                return h, np.ascontiguousarray(
                    g.reshape((n1, n2, n3), order="F"))
        raise ValueError(f"no grid data record in {path}")


def read_structure_seed(path: str):
    """CrystalSeed from an abinit binary header (role of read_abinit in
    crystalseedmod)."""
    from ..crystal.seed import CrystalSeed
    from ..crystal.crystal import Species
    from .. import param

    with open(path, "rb") as fh:
        h = read_header(fh)
    zs = [int(round(z)) for z in h.znucltypat]
    species = [Species(name=param.ELEMENTS[z] if z < len(param.ELEMENTS)
                       else str(z), z=z) for z in zs]
    return CrystalSeed(m_x2c=h.rprimd, x_frac=h.xred,
                       species_of=h.typat - 1, species=species)
