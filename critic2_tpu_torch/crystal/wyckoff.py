"""Wyckoff letter assignment from the spglib site-symmetry database.

Role of the reference's vendored spglib Wyckoff machinery
(src/spglib/site_symmetry.c get_Wyckoff_notation :360-423,
sitesym_database.c): per hall setting, each Wyckoff position is stored
as ONE first-position operator (W|w) packed base 45^3 x 24^3 plus the
site-symmetry order; an atom belongs to the position whose operator
fixes exactly |G|/num_sitesym of its orbit points. Letters count from
'a' in reversed database order. The packed tables are extracted data
(data/wyckoff.json via tools/extract_wyckoff.py).

Setting resolution: spglib knows which hall setting the standardized
cell is in; here the structure is already in the setting the symmetry
detector matched, so every hall setting of the identified ITA group is
TRIED and the first one that assigns a letter to every orbit wins
(wrong-setting candidates fail the orbit test)."""
from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

from .. import param

__all__ = ["wyckoff_letters"]


@lru_cache(maxsize=1)
def _db():
    with open(os.path.join(param.DATA_DIR, "wyckoff.json")) as fh:
        return json.load(fh)


def _halls_of(ita_number: int):
    to_hall = _db()["spacegroup_to_hall"]
    lo = to_hall[ita_number - 1]
    hi = to_hall[ita_number] if ita_number < 230 else 531
    return range(lo, hi)


def _decode(index: int):
    """(rot (3,3) int, trans (3,), num_sitesym) of entry `index`
    (reference ssmdb_get_coordinate, sitesym_database.c:1140-1178)."""
    d = _db()
    enc = d["coordinates_first"][index]
    rot_enc = enc % 91125
    rows = [rot_enc // 2025, (rot_enc % 2025) // 45, rot_enc % 45]
    rot = np.array([[r // 9 - 2, (r % 9) // 3 - 1, r % 3 - 1]
                    for r in rows])
    trans_enc = enc // 91125
    trans = np.array([trans_enc // 576, (trans_enc % 576) // 24,
                      trans_enc % 24]) / 24.0
    return rot, trans, d["num_sitesym"][index]


def _overlap(a, b, m_x2c, symprec):
    d = a - b
    d -= np.rint(d)
    return np.linalg.norm(m_x2c @ d) < symprec


def wyckoff_letters(rotations, translations, x_frac, ita_number,
                    m_x2c, symprec: float = 1e-4):
    """Wyckoff letters for each position in x_frac (n, 3).

    rotations/translations: the FULL detected operation set in the
    structure's own (conventional) basis. Returns (letters, hall) with
    letters a list of single characters, or (None, 0) when no hall
    setting of the group assigns all positions."""
    R = np.asarray(np.rint(rotations), dtype=int)
    T = np.asarray(translations, dtype=float)
    nops = len(R)
    m_x2c = np.asarray(m_x2c, dtype=float)
    pw = _db()["position_wyckoff"]

    x_frac = np.atleast_2d(np.asarray(x_frac, dtype=float))
    # orbits of each position under the ops
    orbits = []
    for x in x_frac:
        pos_rot = (R @ x) + T                     # (nops, 3)
        orbits.append(pos_rot)

    for hall in _halls_of(ita_number):
        i0, n = pw[hall], pw[hall + 1] - pw[hall]
        if n <= 0:
            continue
        # the FIRST entry of each hall block is the general position
        # with num_sitesym = 1, so nops must divide consistently
        letters = []
        ok_all = True
        for orb in orbits:
            letter = None
            for i in range(n):
                rot, trans, nss = _decode(i0 + i)
                if nops % nss:
                    continue
                want = nops // nss
                for j in range(nops):
                    # count orbit members overlapping orb[j] that the
                    # candidate operator fixes (reference :392-411)
                    at_orbit = 0
                    for k in range(nops):
                        if not _overlap(orb[j], orb[k], m_x2c, symprec):
                            continue
                        img = rot @ orb[k] + trans
                        if _overlap(orb[k], img, m_x2c, symprec):
                            at_orbit += 1
                    if at_orbit == want:
                        letter = chr(ord("a") + (n - i - 1))
                        break
                if letter is not None:
                    break
            if letter is None:
                ok_all = False
                break
            letters.append(letter)
        if ok_all:
            return letters, hall
    return None, 0
