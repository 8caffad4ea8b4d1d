"""CIF structure reader (pure Python).

Role of the reference's vendored ciftbx (src/ciftbx/, F77, 10 kLoC) +
read_cif (src/crystalseedmod@proc.f90): parse a CIF data block - cell
parameters, symmetry operations, atom-site loop - and expand the
symmetry-equivalent positions to the full cell.

Host-side I/O by design (SURVEY.md S2.3); handles the CIF subset the
reference's tests exercise: loops, quoted values, semicolon text blocks,
parenthetical uncertainties, symop strings, occupancies.
"""
from __future__ import annotations

import re

import numpy as np

from .. import param
from ..crystal.cell import m_x2c_from_cellpar
from ..crystal.seed import CrystalSeed
from ..crystal.crystal import Species

__all__ = ["read_cif", "parse_symop", "validate_cif"]

_DIC = None


def _cif_dict():
    """The CIF core dictionary tag table ({tag: ddl1-type}), extracted
    from the reference's dat/cif/cif_core.dic (v2.4.3) by
    tools/extract_cif_dict.py - the same dictionary ciftbx validates
    against. Read by path from the JAX package's data directory."""
    global _DIC
    if _DIC is None:
        import json
        import os

        path = os.path.join(param.DATA_DIR, "cif_core_tags.json")
        with open(path) as fh:
            _DIC = json.load(fh)
    return _DIC


_NUMB_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?(\(\d+\))?$")


def validate_cif(path: str) -> list:
    """Validate a CIF file against the core dictionary: unknown tags
    and non-numeric values in numb-typed tags are reported as warning
    strings (empty list = clean).  The ciftbx role
    (reference dict_ validation, src/ciftbx/)."""
    dic = _cif_dict()
    text = open(path, errors="replace").read()
    warns = []

    def check_value(tag, val):
        if dic.get(tag) == "numb" and val not in ("?", "."):
            if not _NUMB_RE.match(val):
                warns.append(f"non-numeric value '{val}' for numb-typed "
                             f"tag {tag}")

    for bname, btoks in _split_blocks(_tokenize(text)):
        tags, loops = _parse_block(btoks)
        seen = set(tags)
        for cols, rows in loops:
            seen.update(cols)
            for row in rows:
                for tag, val in row.items():
                    check_value(tag, val)
        for tag, val in tags.items():
            check_value(tag, val)
        for tag in sorted(seen):
            # non-core namespaces the dictionary does not govern
            # (mmCIF/_pdbx, _geom_*_publ_flag-style locals are still
            # core; publication/journal tags are)
            if tag not in dic:
                warns.append(f"tag {tag} not in the CIF core dictionary")
    return warns


def _tokenize(text):
    """CIF tokens: tags, values, loop_ markers; handles quotes and
    semicolon text fields."""
    tokens = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(";"):
            # multiline text field
            body = [line[1:]]
            i += 1
            while i < len(lines) and not lines[i].startswith(";"):
                body.append(lines[i])
                i += 1
            tokens.append("\n".join(body))
            i += 1
            continue
        line = line.split("#")[0]
        j = 0
        while j < len(line):
            ch = line[j]
            if ch.isspace():
                j += 1
                continue
            if ch in "'\"":
                k = line.find(ch, j + 1)
                while k != -1 and k + 1 < len(line) and \
                        not line[k + 1].isspace():
                    k = line.find(ch, k + 1)
                if k == -1:
                    k = len(line)
                tokens.append(line[j + 1:k])
                j = k + 1
            else:
                k = j
                while k < len(line) and not line[k].isspace():
                    k += 1
                tokens.append(line[j:k])
                j = k
        i += 1
    return tokens


def _num(s):
    """CIF number with optional (uncertainty)."""
    m = re.match(r"^([-+0-9.eEdD]+)(\(\d+\))?$", s.strip())
    if not m:
        raise ValueError(f"bad CIF number {s!r}")
    return float(m.group(1).replace("D", "E").replace("d", "e"))


def parse_symop(s):
    """'x, y+1/2, -z' -> (rot (3,3), trans (3,))."""
    rot = np.zeros((3, 3))
    trans = np.zeros(3)
    for i, part in enumerate(s.lower().replace(" ", "").split(",")):
        # split into signed terms
        for term in re.findall(r"[+-]?[^+-]+", part):
            sign = -1.0 if term.startswith("-") else 1.0
            t = term.lstrip("+-")
            if t in ("x", "y", "z"):
                rot[i, "xyz".index(t)] += sign
                continue
            m = re.match(r"^(\d+)/(\d+)([xyz])?$", t)
            if m and m.group(3):
                rot[i, "xyz".index(m.group(3))] += \
                    sign * float(m.group(1)) / float(m.group(2))
            elif m:
                trans[i] += sign * float(m.group(1)) / float(m.group(2))
            else:
                m2 = re.match(r"^([0-9.]+)(?:\*?([xyz]))?$", t)
                if m2 and m2.group(2):
                    rot[i, "xyz".index(m2.group(2))] += sign * float(m2.group(1))
                elif m2:
                    trans[i] += sign * float(m2.group(1))
                else:
                    raise ValueError(f"cannot parse symop term {term!r}")
    return rot, trans


def _norm_tag(t):
    """Normalize a CIF tag: lowercase, and mmCIF-style dotted names
    (`_atom_site.fract_x`) fold onto the classic underscore form
    (`_atom_site_fract_x`) so both dialects hit the same lookups."""
    return t.lower().replace(".", "_")


def _split_blocks(tokens):
    """Split the token stream into (name, tokens) data blocks.  A CIF
    with no data_ header is one anonymous block (ciftbx data_ accepts
    any block; reference read_cif takes the first,
    src/crystalseedmod@proc.f90 read_cif).  Multiline text-field
    tokens are data values - a 'data_...' line INSIDE one must not
    start a new block."""
    blocks = []
    cur_name, cur = "", []
    for t in tokens:
        if t.lower().startswith("data_") and len(t) >= 5 and "\n" not in t:
            if cur or blocks or cur_name:
                blocks.append((cur_name, cur))
            cur_name, cur = t[5:], []
        else:
            cur.append(t)
    blocks.append((cur_name, cur))
    # drop an empty anonymous leader (file starts with data_)
    if len(blocks) > 1 and blocks[0] == ("", []):
        blocks = blocks[1:]
    return blocks


def _parse_block(tokens):
    """One data block -> dict of tags and list-of-dict loops."""
    tags = {}
    loops = []
    i = 0
    n = len(tokens)
    while i < n:
        t = tokens[i]
        low = t.lower()
        if low.startswith("data_"):
            i += 1
            continue
        if low == "loop_":
            i += 1
            cols = []
            while i < n and tokens[i].startswith("_"):
                cols.append(_norm_tag(tokens[i]))
                i += 1
            rows = []
            while i < n and not tokens[i].startswith("_") and \
                    tokens[i].lower() not in ("loop_",) and \
                    not tokens[i].lower().startswith("data_"):
                rows.append(tokens[i:i + len(cols)])
                i += len(cols)
            loops.append((cols, [dict(zip(cols, r)) for r in rows
                                 if len(r) == len(cols)]))
            continue
        if t.startswith("_"):
            if i + 1 < n:
                tags[_norm_tag(t)] = tokens[i + 1]
            i += 2
            continue
        i += 1
    return tags, loops


def _ops_from_spg_tags(tags):
    """Symmetry ops from space-group name/number tags via the Shmueli
    settings DB (the reference resolves the same tags through spgs,
    src/crystalseedmod@proc.f90 read_cif + src/spgs.f90:739)."""
    from ..crystal import spgs

    sid = None
    for key in ("_symmetry_space_group_name_h-m",
                "_space_group_name_h-m_alt"):
        sym = tags.get(key)
        if sym and sym not in ("?", "."):
            sid = spgs.symbol_to_id(sym)
            if sid:
                break
    if sid is None:
        for key in ("_space_group_it_number",
                    "_symmetry_int_tables_number"):
            v = tags.get(key)
            if v and v not in ("?", "."):
                ita = int(_num(v))
                db = spgs._db()
                try:
                    sid = db["ita_number"].index(ita) + 1
                except ValueError:
                    pass
                break
    if sid is None:
        return []
    st = spgs.setting(sid)
    R, T = st.full_ops()
    return [(R[i].astype(float), T[i]) for i in range(len(R))]


def read_cif(path: str, block: int | str = 0) -> CrystalSeed:
    """Read data block `block` (index or data_ name) of a CIF file.

    Beyond the clean-file subset, this covers the ciftbx behaviors the
    reference relies on (src/ciftbx/ + read_cif,
    src/crystalseedmod@proc.f90): multiple data blocks, '?'/'.'
    unknown values, and space-group recovery from the H-M symbol or
    ITA number (via the Shmueli spgs DB) when no symop loop exists."""
    text = open(path, errors="replace").read()
    blocks = _split_blocks(_tokenize(text))
    if isinstance(block, str):
        names = [b[0].lower() for b in blocks]
        if block.lower() not in names:
            raise ValueError(f"no data_{block} block in {path} "
                             f"(have: {[b[0] for b in blocks]})")
        btoks = blocks[names.index(block.lower())][1]
    else:
        # skip blocks without a cell (e.g. publication-metadata blocks)
        withcell = [b for b in blocks
                    if any(t.lower() == "_cell_length_a" for t in b[1])]
        pick = withcell if withcell else blocks
        if block >= len(pick):
            raise ValueError(f"CIF block {block} out of range "
                             f"({len(pick)} blocks in {path})")
        btoks = pick[block][1]
    tags, loops = _parse_block(btoks)

    aa = [_num(tags[f"_cell_length_{k}"]) * param.ANGSTROM_TO_BOHR
          for k in "abc"]
    bb = [_num(tags[f"_cell_angle_{k}"]) for k in ("alpha", "beta", "gamma")]
    m = m_x2c_from_cellpar(aa, bb)

    # symmetry operations
    ops = []
    for cols, rows in loops:
        for key in ("_symmetry_equiv_pos_as_xyz",
                    "_space_group_symop_operation_xyz"):
            if key in cols:
                ops = [parse_symop(r[key]) for r in rows]
        if ops:
            break
    if not ops:
        for key in ("_symmetry_equiv_pos_as_xyz",
                    "_space_group_symop_operation_xyz"):
            if key in tags:
                ops = [parse_symop(tags[key])]
    if not ops:
        # recover the group from the H-M symbol or ITA number
        # (reference: ciftbx tags + spgs lookup, src/spgs.f90:739)
        ops = _ops_from_spg_tags(tags)
    if not ops:
        ops = [(np.eye(3), np.zeros(3))]

    # atom sites
    sites = None
    for cols, rows in loops:
        if "_atom_site_fract_x" in cols:
            sites = rows
            break
    if sites is None:
        raise ValueError(f"no atom sites in {path}")

    species: list[Species] = []
    spmap = {}
    frac, spof = [], []
    for r in sites:
        lbl = r.get("_atom_site_type_symbol")
        if not lbl or lbl in ("?", "."):
            lbl = r.get("_atom_site_label")
        z = param.symbol_to_z(lbl)
        xyz = [r["_atom_site_fract_x"], r["_atom_site_fract_y"],
               r["_atom_site_fract_z"]]
        if any(v in ("?", ".") for v in xyz):
            continue                       # unknown position (ciftbx '?')
        x = np.array([_num(v) for v in xyz])
        key = (lbl.rstrip("0123456789+-"), z)
        if key not in spmap:
            spmap[key] = len(species)
            species.append(Species(key[0], z))
        # expand by symmetry, dedupe
        for rot, tr in ops:
            xx = (rot @ x + tr) % 1.0
            xx[xx > 1 - 1e-6] = 0.0
            dup = False
            for f0 in frac:
                d = xx - f0
                d -= np.rint(d)
                if np.linalg.norm(d @ m.T) < 1e-3:
                    dup = True
                    break
            if not dup:
                frac.append(xx)
                spof.append(spmap[key])

    return CrystalSeed(m_x2c=m, x_frac=np.asarray(frac),
                       species_of=np.asarray(spof), species=species,
                       name=path)
