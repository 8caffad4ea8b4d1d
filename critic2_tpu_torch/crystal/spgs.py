"""Space-group symbol database: symbol -> operations and ops -> symbol.

Role of the reference spgs module (src/spgs.f90:18-76): a database of
306 space-group settings in the Shmueli encoding (Acta Cryst. A40
(1984) 559) mapping Hermann-Mauguin symbols to symmetry operations.
The table itself (symbols, encoded generators, aliases, ITA numbers)
is International Tables DATA, extracted to data/spgs.json by
tools/extract_spgs.py; this module reimplements the decoder
(reference spgs_parse, src/spgs.f90:804-970), the group closure
(spgs_generate :972-1008) and adds the inverse lookup the reference
lacks: identifying the symbol of a DETECTED operation set (the
reference only goes symbol -> ops). The table is read by path from the
JAX package's data directory.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .. import param

__all__ = ["SpgsSetting", "setting", "symbol_to_id", "nsettings",
           "identify_from_ops"]

_I3 = np.eye(3, dtype=int)

# generator rotation matrices of the Shmueli encoding
# (reference spgs_parse select case, src/spgs.f90:857-940)
_GEN = {
    "1A": _I3,
    "2A": np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]]),
    "2B": np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]]),
    "2C": np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]]),
    "2D": np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]]),
    "2E": np.array([[0, -1, 0], [-1, 0, 0], [0, 0, -1]]),
    "2F": np.array([[1, -1, 0], [0, -1, 0], [0, 0, -1]]),
    "2G": np.array([[1, 0, 0], [1, -1, 0], [0, 0, -1]]),
    "3Q": np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]]),
    "3C": np.array([[0, -1, 0], [1, -1, 0], [0, 0, 1]]),
    "4C": np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]]),
    "6C": np.array([[1, -1, 0], [1, 0, 0], [0, 0, 1]]),
}

# centering vectors in 12ths (reference spgs_parse :813-855)
_CENT = {
    "P": [(0, 0, 0)],
    "A": [(0, 0, 0), (0, 6, 6)],
    "B": [(0, 0, 0), (6, 0, 6)],
    "C": [(0, 0, 0), (6, 6, 0)],
    "I": [(0, 0, 0), (6, 6, 6)],
    "F": [(0, 0, 0), (0, 6, 6), (6, 0, 6), (6, 6, 0)],
    "R": [(0, 0, 0), (4, 8, 8), (8, 4, 4)],
}

_SYS = {"A": "triclinic", "M": "monoclinic", "O": "orthorhombic",
        "T": "tetragonal", "R": "rhombohedral", "H": "hexagonal",
        "C": "cubic"}


@lru_cache(maxsize=1)
def _db():
    with open(os.path.join(param.DATA_DIR, "spgs.json")) as fh:
        return json.load(fh)


def nsettings() -> int:
    return len(_db()["short"])


@dataclass
class SpgsSetting:
    id: int                      # 1-based setting index (1..306)
    ita_number: int              # ITA space-group number (1..230)
    short: str                   # short Hermann-Mauguin symbol
    system: str
    centering: str               # P/A/B/C/I/F/R
    centrosymmetric: bool
    rotations: np.ndarray        # (nq, 3, 3) int, quotient group
    translations: np.ndarray     # (nq, 3) float fractional
    cenvs: np.ndarray            # (ncv, 3) float fractional

    def full_ops(self):
        """All (rot, trans) including centering: (nq*ncv, 3, 3)/(.., 3)."""
        R = np.repeat(self.rotations, len(self.cenvs), axis=0)
        T = (self.translations[:, None, :]
             + self.cenvs[None, :, :]).reshape(-1, 3) % 1.0
        return R, T


def _decode(longstr: str):
    """Decode a Shmueli generator string to (gens, orders, cent, sys,
    inv) with translations in 12ths (reference spgs_parse)."""
    cent = longstr[0]
    sysl = longstr[1]
    inv = longstr[2] == "C"
    gens = [(np.array(_I3), np.zeros(3, dtype=int))]
    orders = [1]
    i = 3
    while i < len(longstr) and longstr[i] == "$":
        proper = longstr[i + 1] == "P"
        code = longstr[i + 2:i + 4]
        order = int(longstr[i + 2])
        if not proper and order % 2 == 1:
            order *= 2
        W = np.array(_GEN[code])
        if code == "1A" and proper:
            i += 8
            continue
        if not proper:
            W = -W
        t = np.array([int(longstr[i + 4]), int(longstr[i + 5]),
                      int(longstr[i + 6])])
        if t[2] == 5:          # encoding quirk (reference :955-957)
            t[2] = 10
        gens.append((W, t))
        orders.append(order)
        i += 7
    return gens, orders, cent, sysl, inv


def _mult(a, b):
    """Compose ops (W, w) in 12ths: (Wa Wb, Wa wb + wa) mod 12."""
    return a[0] @ b[0], (a[0] @ b[1] + a[1]) % 12


def _close(gens, orders, cent):
    """Group closure from generators (reference spgs_generate uses
    nested order-bounded loops; a BFS closure is equivalent).
    Translations are canonicalized modulo the centering vectors so the
    result is the quotient group (coset representatives)."""
    cvs = [np.asarray(c, dtype=int) for c in _CENT[cent]]

    def canon(w):
        return min(tuple((w - c) % 12) for c in cvs)

    ops = {}

    def add(W, w):
        ops[(W.tobytes(), canon(w))] = (W.copy(),
                                        np.asarray(canon(w), dtype=int))

    # NOTE: the encoding's generator list already contains the
    # inversion when the group is centrosymmetric (improper "I1A" with
    # its own location); adding a second (-I|0) would generate pure
    # non-lattice translations and blow up the group.
    add(*gens[0])
    frontier = [gens[0]]
    allgens = list(gens)
    while frontier:
        new = []
        for a in frontier:
            for g in allgens[1:]:
                W, w = _mult(a, g)
                key = (W.tobytes(), canon(w))
                if key not in ops:
                    add(W, w)
                    new.append((W, w))
        frontier = new
        if len(ops) > 48:
            raise RuntimeError("space-group closure did not terminate")
    return [v for v in ops.values()]


@lru_cache(maxsize=None)
def setting(sid: int) -> SpgsSetting:
    """Expand setting `sid` (1-based, 1..306)."""
    db = _db()
    longstr = db["long"][sid - 1]
    gens, orders, cent, sysl, inv = _decode(longstr)
    ops = _close(gens, orders, cent)
    R = np.stack([o[0] for o in ops])
    T = np.stack([o[1] for o in ops]) / 12.0
    cv = np.asarray(_CENT[cent], dtype=float) / 12.0
    return SpgsSetting(
        id=sid, ita_number=db["ita_number"][sid - 1],
        short=db["short"][sid - 1], system=_SYS[sysl],
        centering=cent, centrosymmetric=inv,
        rotations=R, translations=T, cenvs=cv)


def symbol_to_id(symbol: str) -> int | None:
    """Resolve a Hermann-Mauguin symbol (or alias) to a setting id
    (reference spgs_driver master-list + alias lookup,
    src/spgs.f90:739-759)."""
    db = _db()
    s = " ".join(symbol.strip().lower().split())
    try:
        return db["short"].index(s) + 1
    except ValueError:
        pass
    return db["aliases"].get(s)


def _op_set_key(R, T, denom=24):
    """Hashable canonical form of an op set: sorted (W, w) with w on a
    1/denom grid."""
    ws = np.rint(np.asarray(T) * denom).astype(int) % denom
    items = sorted((r.tobytes(), tuple(w))
                   for r, w in zip(np.asarray(R, dtype=int), ws))
    return tuple(items)


def identify_from_ops(rotations, translations, symprec: float = 1e-4):
    """Name a detected space group: find the setting whose full op set
    equals {W | t + (W - I) p} for some origin shift p.

    rotations (nop, 3, 3) int and translations (nop, 3) must be the
    FULL coset set in the conventional basis (centering included), as
    produced by crystal.symmetry. Returns the matching SpgsSetting or
    None. Origin shifts are scanned on the 1/24 grid, which contains
    every ITA origin choice (1/12ths and the 1/8ths of the diamond
    groups are both in 1/24)."""
    R = np.asarray(np.rint(rotations), dtype=int)
    T = np.asarray(translations, dtype=float) % 1.0
    nop = len(R)
    Rkey = sorted(r.tobytes() for r in R)

    # candidate settings: same op count and identical rotation multiset
    cands = []
    for sid in range(1, nsettings() + 1):
        st = setting(sid)
        if len(st.rotations) * len(st.cenvs) != nop:
            continue
        Rf, Tf = st.full_ops()
        if sorted(r.astype(int).tobytes() for r in Rf) != Rkey:
            continue
        cands.append((st, Rf, Tf))
    if not cands:
        return None

    # detected ops grouped by rotation for the origin-shift test
    for st, Rf, Tf in cands:
        # origin shift p on the 1/24 grid: t_det = t_set + (W - I) p
        grid = np.arange(24) / 24.0
        P = np.stack(np.meshgrid(grid, grid, grid,
                                 indexing="ij"), -1).reshape(-1, 3)
        # build per-rotation translation sets from the detected ops
        det = {}
        for r, t in zip(R, T):
            det.setdefault(r.tobytes(), []).append(t)
        ok_all = np.ones(len(P), dtype=bool)
        for r, t0 in zip(Rf, Tf):
            dts = np.asarray(det[r.astype(int).tobytes()])   # (m, 3)
            shift = ((np.asarray(r, dtype=float) - np.eye(3)) @ P.T).T
            # t_det - t_set - (W - I) p  must be integral for SOME t_det
            cand = (dts[None, :, :] - t0[None, None, :]
                    - shift[:, None, :])
            cand = np.abs(cand - np.rint(cand)).max(-1)       # (nP, m)
            ok_all &= (cand < 10 * symprec).any(-1)
            if not ok_all.any():
                break
        if ok_all.any():
            return st
    return None
