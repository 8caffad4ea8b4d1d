"""Structure readers -> CrystalSeed -> Crystal.

Role of the reference's crystalseedmod (src/crystalseedmod.f90): parse
structure files into a seed, then construct the Crystal. Formats in this
module: VASP POSCAR/CONTCAR/CHGCAR headers, Gaussian cube and bincube,
xyz, SHELX, QE input/output, DFTB+ gen, abinit, xsf/axsf, CRYSTAL
output, Gaussian log, SIESTA STRUCT, WIEN2k struct, elk GEOMETRY.OUT,
the pwc header and the molecular wavefunction formats, the inline
CRYSTAL/MOLECULE environment, and format auto-detection
(struct_detect_format, src/crystalseedmod@proc.f90:3113); CIF lives in
io/cif.py. Host code (NumPy); the parsers are the JAX package's, token
for token, so both packages build the same Crystal from the same file.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field as dfield

import numpy as np

from .. import param
from .cell import m_x2c_from_cellpar
from .crystal import Crystal, Species


@dataclass
class CrystalSeed:
    m_x2c: np.ndarray | None = None
    x_frac: np.ndarray | None = None     # fractional atom coords
    species_of: np.ndarray | None = None
    species: list = dfield(default_factory=list)
    ismolecule: bool = False
    name: str = ""
    border: float = 10.0                 # molecule cell border (bohr)
    cubic: bool = False

    def to_crystal(self) -> Crystal:
        if self.ismolecule:
            return _molecule_to_crystal(self)
        return Crystal(
            m_x2c=self.m_x2c,
            x_frac=np.mod(self.x_frac, 1.0),
            species_of=self.species_of,
            species=self.species,
            ismolecule=False,
        )


def _molecule_to_crystal(seed: CrystalSeed) -> Crystal:
    """Embed a molecule in a big empty cell (reference molx0/molborder
    semantics, src/crystalmod.f90:85-88)."""
    cart = np.atleast_2d(np.asarray(seed.x_frac, dtype=float))  # here: cartesian!
    lo = cart.min(axis=0) - seed.border
    hi = cart.max(axis=0) + seed.border
    side = hi - lo
    if seed.cubic:
        side = np.full(3, side.max())
    m = np.diag(side)
    frac = (cart - lo) / side
    c = Crystal(
        m_x2c=m,
        x_frac=frac,
        species_of=seed.species_of,
        species=seed.species,
        ismolecule=True,
        molx0=lo,
    )
    c.molborder = np.maximum(seed.border * 0.5, 0.0) / side
    return c


WFN_EXTENSIONS = (".wfn", ".wfx", ".fchk", ".fch", ".fck", ".molden",
                  ".molden.input")


def is_wfn_path(path: str) -> bool:
    """True for a molecular wavefunction file name."""
    return str(path).lower().endswith(WFN_EXTENSIONS)


def _num(s: str) -> float:
    """Numeric token with arithmetic (the library files use '1/3',
    sometimes quoted; reference eval_next runs the full expression
    evaluator on the unquoted token)."""
    s = s.strip("'\"")
    try:
        return float(s)
    except ValueError:
        if re.fullmatch(r"[0-9.+\-*/eE()]+", s):
            return float(eval(s, {"__builtins__": {}}, {}))
        raise


def _parse_symm_op(s: str):
    """Parse a Jones-faithful triplet ('-x, y+1/2, -z') into (R, t)
    (reference SYMM keyword, src/crystalseedmod@proc.f90:176-183 with
    spgs-style op decoding)."""
    comps = s.replace(" ", "").lower().split(",")
    if len(comps) != 3 or not all(
            re.fullmatch(r"[xyz0-9+\-*/.]*", c) for c in comps):
        raise ValueError(f"bad SYMM op: {s}")
    R = np.zeros((3, 3))
    t = np.zeros(3)
    for i, comp in enumerate(comps):
        def f(vx, vy, vz, expr=comp):
            return float(eval(expr, {"__builtins__": {}},
                              {"x": vx, "y": vy, "z": vz}))
        t[i] = f(0.0, 0.0, 0.0)
        for j in range(3):
            e = [0.0, 0.0, 0.0]
            e[j] = 1.0
            R[i, j] = f(*e) - t[i]
    return R, t % 1.0


def _expand_ops(xs, species_of, ops, symprec=1e-5):
    """Expand representative atoms by (R, t) op list, deduped."""
    out_x, out_s = [], []
    for x, s in zip(xs, species_of):
        for R, t in ops:
            y = (R @ np.asarray(x, dtype=float) + t) % 1.0
            if not any(s == so and
                       np.linalg.norm((y - xo + 0.5) % 1.0 - 0.5) < symprec
                       for xo, so in zip(out_x, out_s)):
                out_x.append(y)
                out_s.append(s)
    return np.asarray(out_x), np.asarray(out_s, dtype=int)


def parse_crystal_env(lines, mol: bool = False,
                      unit_scale: float | None = None) -> CrystalSeed:
    """Parse the inline CRYSTAL ... ENDCRYSTAL / MOLECULE ... ENDMOLECULE
    input environment (reference parse_crystal_env / parse_molecule_env,
    src/crystalseedmod@proc.f90:40-460): CELL a b c al be ga [ANG|BOHR],
    CARTESIAN [scale] <3 rows> ENDCARTESIAN, SPG symbol, SYMM triplet,
    NEQ x y z At / At x y z / Z x y z atom lines; molecules take
    Cartesian coordinates (default angstrom) and CUBIC/BORDER b.

    `lines` is an iterator of raw input lines; consumption stops at
    ENDCRYSTAL/ENDMOLECULE/END.
    """
    m_x2c = None
    cart_frame = False
    xs, spof, species = [], [], []
    spmap = {}
    symm_ops = []
    spg_id = None
    border, cubic = 10.0, False
    default_scale = (param.ANGSTROM_TO_BOHR if mol else 1.0) \
        if unit_scale is None else unit_scale
    endkw = ("end", "endmolecule" if mol else "endcrystal")

    for raw in lines:
        t = raw.split("#")[0].strip()
        if not t:
            continue
        toks = t.split()
        kw = toks[0].lower()
        if kw in endkw:
            break
        if kw == "cell":
            vals = [_num(v) for v in toks[1:7]]
            sc = default_scale
            if len(toks) > 7:
                u = toks[7].lower()
                sc = param.ANGSTROM_TO_BOHR if u in ("ang", "angstrom") \
                    else 1.0
            m_x2c = m_x2c_from_cellpar([v * sc for v in vals[:3]], vals[3:])
        elif kw == "cartesian":
            scal = _num(toks[1]) if len(toks) > 1 else 1.0
            ascal = default_scale
            rows = []
            for raw2 in lines:
                t2 = raw2.split("#")[0].strip().lower()
                if not t2:
                    continue
                if t2 in ("ang", "angstrom"):
                    ascal = param.ANGSTROM_TO_BOHR
                elif t2 in ("bohr", "au"):
                    ascal = 1.0
                elif t2 in ("end", "endcartesian"):
                    break
                else:
                    rows.append([_num(v) for v in t2.split()[:3]])
            m_x2c = np.asarray(rows).T * scal * ascal   # columns = vectors
            cart_frame = True
        elif kw in ("spg", "spgr"):
            from . import spgs
            spg_id = spgs.symbol_to_id(" ".join(toks[1:]))
        elif kw == "symm":
            symm_ops.append(_parse_symm_op(" ".join(toks[1:])))
        elif kw in ("cubic", "cube") and mol:
            cubic = True
        elif kw == "border" and mol:
            border = _num(toks[1])
        else:
            # atom line: NEQ x y z At | At x y z | Z x y z
            if kw == "neq":
                x = [_num(v) for v in toks[1:4]]
                name = toks[4]
            else:
                try:
                    z = int(toks[0])
                    name = param.z_to_symbol(z)
                except ValueError:
                    name = toks[0]
                x = [_num(v) for v in toks[1:4]]
            unit = toks[-1].lower() if toks[-1].lower() in (
                "ang", "angstrom", "bohr", "au") else None
            x = np.asarray(x, dtype=float)
            if mol:
                sc = param.ANGSTROM_TO_BOHR if unit in (
                    None, "ang", "angstrom") else 1.0
                if unit_scale is not None and unit is None:
                    sc = unit_scale
                x = x * sc
            elif unit is not None:
                if not cart_frame:
                    raise ValueError("cartesian atom coords need "
                                     "CARTESIAN lattice vectors")
                sc = param.ANGSTROM_TO_BOHR if unit in ("ang", "angstrom") \
                    else 1.0
                x = np.linalg.solve(m_x2c, x * sc)
            key = name.capitalize()
            if key not in spmap:
                z = param.symbol_to_z(key)
                if z <= 0:
                    raise ValueError(f"unknown atomic symbol {name}")
                spmap[key] = len(species)
                species.append(Species(key, z))
            xs.append(x)
            spof.append(spmap[key])

    if not xs:
        raise ValueError("no atoms in the inline structure environment")
    xs = np.asarray(xs, dtype=float)
    spof = np.asarray(spof, dtype=int)
    if mol:
        return CrystalSeed(x_frac=xs, species_of=spof, species=species,
                           ismolecule=True, border=border, cubic=cubic)
    if m_x2c is None:
        raise ValueError("inline CRYSTAL needs CELL or CARTESIAN")
    ops = [(np.eye(3), np.zeros(3))] + list(symm_ops) if symm_ops else []
    if spg_id is not None:
        from . import spgs
        R, T = spgs.setting(spg_id).full_ops()
        ops += list(zip(R, T))
    if ops:
        xs, spof = _expand_ops(np.mod(xs, 1.0), spof, ops)
    return CrystalSeed(m_x2c=m_x2c, x_frac=np.mod(xs, 1.0),
                       species_of=spof, species=species)


# ---------------------------------------------------------------------------
# format detection
# ---------------------------------------------------------------------------
def detect_format(path: str) -> str:
    base = os.path.basename(path)
    lower = base.lower()
    ext = os.path.splitext(lower)[1].lstrip(".")
    if lower in ("poscar", "contcar") or \
            lower.startswith(("poscar", "contcar")) or \
            lower.endswith((".poscar", ".contcar")):
        return "poscar"
    if lower.startswith(("chgcar", "chg", "elfcar", "aeccar")):
        return "vasp-grid"
    if ext in ("cube",):
        return "cube"
    if ext in ("bincube",):
        return "bincube"
    if ext == "xyz":
        return "xyz"
    if ext == "cif":
        return "cif"
    if ext in ("vasp",):
        return "poscar"
    if ext == "xsf":
        return "xsf"
    if ext == "axsf":
        return "axsf"
    if ext in ("struct_out", "struct_in"):
        return "siesta"
    if ext == "log":
        return "gaussian-log"
    if ext in ("wfn", "wfx", "fchk", "fch", "fck", "molden"):
        return "wfn"
    if lower in ("geometry.out",):
        return "elk-geometry"
    if ext in ("in",):
        return "qe-in"
    if ext in ("out", "scf"):
        # .out is shared by QE and the CRYSTAL code: a QE output has a
        # "Program PWSCF ..." line (reference is_espresso,
        # src/crystalseedmod@proc.f90:4712-4734)
        if ext == "scf" or _is_espresso(path):
            return "qe-out"
        return "crystal-out"
    if ext == "struct":
        return "wien"
    if ext == "gen":
        return "dftb-gen"
    if ext in ("res", "ins", "16"):
        return "shelx"
    if ext == "pwc":
        return "pwc"
    up = base.upper()
    if up.endswith(("_DEN", "_POT", "_ELF", "_VHA", "_VHXC", "_VXC",
                    "_GDEN1", "_GDEN2", "_GDEN3", "_LDEN", "_KDEN",
                    "_PAWDEN")) or ".DEN" in up:
        return "abinit"
    raise ValueError(f"cannot detect structure format of {path}")


def read_structure(path: str, mol: bool | None = None) -> Crystal:
    """Read a structure file, auto-detecting the format."""
    fmt = detect_format(path)
    if fmt in ("poscar", "vasp-grid"):
        return read_poscar(path).to_crystal()
    if fmt == "cube":
        return read_cube_structure(path).to_crystal()
    if fmt == "xyz":
        return read_xyz(path).to_crystal()
    if fmt == "cif":
        from ..io.cif import read_cif
        return read_cif(path).to_crystal()
    if fmt == "xsf":
        return read_xsf_structure(path).to_crystal()
    if fmt == "wfn":
        return read_wfn_structure(path).to_crystal()
    if fmt == "wien":
        return read_wien_structure(path).to_crystal()
    if fmt == "elk-geometry":
        return read_elk_geometry(path).to_crystal()
    if fmt == "qe-in":
        return read_qe_in(path).to_crystal()
    if fmt == "qe-out":
        return read_qe_out(path).to_crystal()
    if fmt == "dftb-gen":
        return read_dftb_gen(path).to_crystal()
    if fmt == "shelx":
        return read_shelx(path).to_crystal()
    if fmt == "abinit":
        return read_abinit_structure(path).to_crystal()
    if fmt == "bincube":
        return read_bincube_structure(path).to_crystal()
    if fmt == "pwc":
        return read_pwc_structure(path).to_crystal()
    if fmt == "siesta":
        return read_siesta_struct(path).to_crystal()
    if fmt == "axsf":
        return read_axsf_structure(path).to_crystal()
    if fmt == "crystal-out":
        return read_crystal_out(path).to_crystal()
    if fmt == "gaussian-log":
        return read_gaussian_log(path).to_crystal()
    raise NotImplementedError(f"structure format {fmt} not implemented yet")


def _is_espresso(path: str) -> bool:
    """True if the .out file is a Quantum ESPRESSO output (reference
    is_espresso, src/crystalseedmod@proc.f90:4712-4734)."""
    try:
        with open(path, errors="replace") as f:
            for ln in f:
                t = ln.split()
                if (len(t) >= 2 and t[0].lower() == "program"
                        and t[1].lower().startswith("pwscf")):
                    return True
    except OSError:
        pass
    return False


def _species_from_z(zs) -> tuple[np.ndarray, list]:
    """(species_of, species) from a per-atom Z list, first-appearance
    ordered."""
    spmap, species, spof = {}, [], []
    for z in zs:
        z = int(z)
        if z not in spmap:
            spmap[z] = len(species)
            species.append(Species(param.z_to_symbol(z), z))
        spof.append(spmap[z])
    return np.asarray(spof, dtype=int), species


def read_bincube_structure(path: str) -> CrystalSeed:
    """Structure from a binary cube header (reference read_bincube,
    src/crystalseedmod@proc.f90:1222-1309): Fortran unformatted records
    (nat, x0(3)), (nstep(3), rmat(3,3)), then nat x (iz, q, x(3))."""
    from ..fields.qe import FortranFile

    fh = FortranFile(path)
    rec = fh.read_record()
    nat = int(np.frombuffer(rec[:4], np.int32)[0])
    x0 = np.frombuffer(rec[4:28], np.float64)
    rec = fh.read_record()
    nstep = np.frombuffer(rec[:12], np.int32).astype(int)
    rmat = np.frombuffer(rec[12:84], np.float64).reshape(3, 3, order="F")
    m_x2c = rmat * nstep[None, :]        # column i scaled by nstep(i)
    zs, cart = [], []
    for _ in range(nat):
        rec = fh.read_record()
        iz = int(np.frombuffer(rec[:4], np.int32)[0])
        x = np.frombuffer(rec[12:36], np.float64)
        if iz > 0:
            zs.append(iz)
            cart.append(x - x0)
    fh.close()
    frac = np.asarray(cart) @ np.linalg.inv(m_x2c).T
    spof, species = _species_from_z(zs)
    return CrystalSeed(m_x2c=m_x2c, x_frac=frac % 1.0, species_of=spof,
                       species=species, name=os.path.basename(path))


def read_pwc_structure(path: str) -> CrystalSeed:
    """Structure from a QE pwc header (reference read_pwc,
    src/crystalseedmod@proc.f90:2854-2921): records version /
    (nsp, nat) / atm names / ityp / tau (cart) / at."""
    from ..fields.qe import FortranFile

    fh = FortranFile(path)
    fh.read_record()                               # version
    nsp, nat = (int(v) for v in fh.read_record(np.int32)[:2])
    atm = fh.read_record()                         # nsp * 3-char names
    w = len(atm) // nsp
    names = [atm[i * w:(i + 1) * w].decode().strip() for i in range(nsp)]
    ityp = fh.read_record(np.int32)[:nat].astype(int)
    tau = fh.read_record(np.float64)[:3 * nat].reshape(3, nat,
                                                       order="F").T
    at = fh.read_record(np.float64)[:9].reshape(3, 3, order="F")
    fh.close()
    frac = tau @ np.linalg.inv(at).T
    species = [Species(nm, param.symbol_to_z(nm)) for nm in names]
    return CrystalSeed(m_x2c=at, x_frac=frac % 1.0,
                       species_of=ityp - 1, species=species,
                       name=os.path.basename(path))


def read_siesta_struct(path: str) -> CrystalSeed:
    """siesta STRUCT_IN/STRUCT_OUT (reference read_siesta,
    src/crystalseedmod@proc.f90:2485-2551): 3 lattice rows (ang), nat,
    then (ispecies, Z, x_frac) per atom."""
    with open(path) as f:
        toks = f.read().split()
    r = np.array([float(v) for v in toks[:9]]).reshape(3, 3) \
        * param.ANGSTROM_TO_BOHR
    nat = int(toks[9])
    spof = np.empty(nat, dtype=int)
    zs = {}
    frac = np.empty((nat, 3))
    p = 10
    for i in range(nat):
        ispc = int(toks[p]); z = int(toks[p + 1])
        frac[i] = [float(v) for v in toks[p + 2:p + 5]]
        spof[i] = ispc - 1
        zs[ispc - 1] = z
        p += 5
    species = [Species(param.z_to_symbol(zs[i]), zs[i])
               for i in range(max(zs) + 1)]
    return CrystalSeed(m_x2c=r.T, x_frac=frac % 1.0, species_of=spof,
                       species=species, name=os.path.basename(path))


def read_axsf_structure(path: str, step: int = 1) -> CrystalSeed:
    """Animated xsf: PRIMVEC + numbered PRIMCOORD animation steps; read
    step `step` (reference read_axsf,
    src/crystalseedmod@proc.f90:2926-3083, nudge 0)."""
    return read_xsf_structure(path, step=step)


def read_crystal_out(path: str) -> CrystalSeed:
    """CRYSTAL(the code) output (reference read_crystalout,
    src/crystalseedmod@proc.f90:2351-2482): last DIRECT LATTICE VECTORS
    CARTESIAN COMPONENTS block (ang) + CARTESIAN COORDINATES -
    PRIMITIVE CELL atom table."""
    with open(path, errors="replace") as f:
        lines = f.readlines()
    iscrystal = False
    r = None
    names, cart = [], []
    i = 0
    while i < len(lines):
        ln = lines[i]
        if "CRYSTAL CALCULATION" in ln:
            iscrystal = True
        elif "DIRECT LATTICE VECTORS CARTESIAN COMPONENTS" in ln:
            r = np.array([[float(v) for v in lines[i + 2 + k].split()[:3]]
                          for k in range(3)]) * param.ANGSTROM_TO_BOHR
            i += 4
            continue
        elif "CARTESIAN COORDINATES - PRIMITIVE CELL" in ln:
            j = i + 4
            names, cart = [], []
            while j < len(lines) and lines[j].strip():
                t = lines[j].split()
                names.append(t[2])
                cart.append([float(v) for v in t[3:6]])
                j += 1
            i = j
            continue
        i += 1
    if not iscrystal:
        raise ValueError("only CRYSTAL calculations supported "
                         "(no MOLECULE/SLAB/POLYMER)")
    if r is None:
        raise ValueError("no lattice vectors in CRYSTAL output")
    cart = np.asarray(cart) * param.ANGSTROM_TO_BOHR
    m_x2c = r.T
    frac = cart @ np.linalg.inv(m_x2c).T
    uniq, spof, species = {}, [], []
    for nm in names:
        key = nm.capitalize()
        if key not in uniq:
            uniq[key] = len(species)
            species.append(Species(key, param.symbol_to_z(key)))
        spof.append(uniq[key])
    return CrystalSeed(m_x2c=m_x2c, x_frac=frac % 1.0,
                       species_of=np.asarray(spof, dtype=int),
                       species=species, name=os.path.basename(path))


def read_gaussian_log(path: str) -> CrystalSeed:
    """Molecule from a Gaussian output: the last Standard/Input
    orientation table (reference wfn_read_log_geometry,
    src/wfn_private@proc.F90)."""
    with open(path, errors="replace") as f:
        lines = f.readlines()
    start = None
    for i, ln in enumerate(lines):
        if ("Standard orientation:" in ln or "Input orientation:" in ln):
            start = i
    if start is None:
        raise ValueError("no orientation table in Gaussian output")
    zs, cart = [], []
    for ln in lines[start + 5:]:
        if ln.lstrip().startswith("---"):
            break
        t = ln.split()
        zs.append(int(t[1]))
        cart.append([float(v) for v in t[-3:]])
    spof, species = _species_from_z(zs)
    return CrystalSeed(x_frac=np.asarray(cart) * param.ANGSTROM_TO_BOHR,
                       species_of=spof, species=species, ismolecule=True,
                       name=os.path.basename(path))


def read_elk_geometry(path: str) -> CrystalSeed:
    """Crystal from an elk GEOMETRY.OUT (reference read_elk,
    src/crystalseedmod@proc.f90 elk branch)."""
    from ..fields.elk import read_geometry

    geo = read_geometry(path)
    spmap, species, spof, xf = {}, [], [], []
    for isp, posl in enumerate(geo["pos_frac"]):
        nm = geo["species"][isp]
        sym = "".join(c for c in nm if c.isalpha())[:2].capitalize()
        z = param.symbol_to_z(sym) or param.symbol_to_z(sym[:1]) or 0
        if isp not in spmap:
            spmap[isp] = len(species)
            species.append(Species(sym, z))
        for p in posl:
            xf.append(np.mod(p, 1.0))
            spof.append(spmap[isp])
    return CrystalSeed(m_x2c=geo["x2c"], x_frac=np.asarray(xf),
                       species_of=np.asarray(spof), species=species,
                       name=path)


def read_wien_structure(path: str) -> CrystalSeed:
    """WIEN2k .struct reader (reference read_wien,
    src/crystalseedmod@proc.f90:1313-1510). The cell frame is br1^T so
    Cartesian coordinates agree with the WienField evaluator; centering
    copies (F/B/C lattices) are expanded into the conventional cell."""
    from ..fields.wien import read_struct

    st = read_struct(path)
    lattic = st["lattic"]
    cen = [np.zeros(3)]
    if lattic[0] == "F":
        cen += [np.array([0.5, 0.5, 0.0]), np.array([0.0, 0.5, 0.5]),
                np.array([0.5, 0.0, 0.5])]
    elif lattic[0] == "B":
        cen += [np.array([0.5, 0.5, 0.5])]
    elif lattic[:3] == "CXY":
        cen += [np.array([0.5, 0.5, 0.0])]
    elif lattic[:3] == "CYZ":
        cen += [np.array([0.0, 0.5, 0.5])]
    elif lattic[:3] == "CXZ":
        cen += [np.array([0.5, 0.0, 0.5])]

    jatom_of = np.concatenate(
        [np.full(st["multw"][j], j) for j in range(st["nat"])])
    spmap, species, spof, xf = {}, [], [], []
    for iat, x in enumerate(st["pos_frac"]):
        z = int(round(st["znuc"][jatom_of[iat]]))
        name = st["names"][jatom_of[iat]] or param.z_to_symbol(z)
        if z not in spmap:
            spmap[z] = len(species)
            species.append(Species(param.z_to_symbol(z) or name, z))
        for cv in cen:
            xf.append(np.mod(x + cv, 1.0))
            spof.append(spmap[z])
    return CrystalSeed(m_x2c=st["br1"].T, x_frac=np.asarray(xf),
                       species_of=np.asarray(spof), species=species,
                       name=path)


def read_wfn_structure(path: str, border: float = 10.0) -> CrystalSeed:
    """Molecule geometry from a wavefunction file (reference MOLECULE
    file.{wfn,wfx,fchk}, src/crystalseedmod.f90 read_mol)."""
    from ..fields.wfn import Wavefunction

    w = Wavefunction.from_file(path)
    spmap, species, spof = {}, [], []
    for z in w.atz:
        z = int(z)
        if z not in spmap:
            spmap[z] = len(species)
            species.append(Species(param.z_to_symbol(z), z))
        spof.append(spmap[z])
    return CrystalSeed(x_frac=np.asarray(w.atpos),
                       species_of=np.asarray(spof), species=species,
                       ismolecule=True, name=path, border=border)


# ---------------------------------------------------------------------------
# VASP POSCAR / CHGCAR header
# ---------------------------------------------------------------------------
def read_potcar(path: str) -> list[str]:
    """Species names from a VASP POTCAR: the second word of each
    dataset's first line, datasets delimited by 'End of Dataset'
    (reference read_potcar, src/crystalseedmod@proc.f90:3277-3326)."""
    names = []
    with open(path, errors="replace") as f:
        at_head = True
        for line in f:
            if at_head:
                toks = line.split()
                if len(toks) >= 2:
                    names.append(toks[1])
                elif toks:
                    names.append(toks[0])
                at_head = False
            elif line.strip() == "End of Dataset":
                at_head = True
    return names


def read_poscar(path: str, species_names: list[str] | None = None) -> CrystalSeed:
    """POSCAR/CONTCAR/CHGCAR-header reader (v5+ with symbol line, or
    VASP-4 counts-only with species from a sibling POTCAR — reference
    read_vasp + read_potcar, src/crystalseedmod@proc.f90:3277)."""
    with open(path) as f:
        lines = f.read().splitlines()
    title = lines[0].strip()
    scale = float(lines[1].split()[0])
    lat = np.array([[float(x) for x in lines[2 + i].split()[:3]] for i in range(3)])
    if scale < 0:  # negative scale = target volume
        vol = abs(np.linalg.det(lat))
        scale = (-scale / vol) ** (1.0 / 3.0)
    lat = lat * scale * param.ANGSTROM_TO_BOHR
    # species symbols line (v5) or direct counts (v4)
    toks = lines[5].split()
    if all(t.isdigit() for t in toks):
        counts = [int(t) for t in toks]
        if species_names is None:
            potcar = os.path.join(os.path.dirname(path) or ".", "POTCAR")
            if os.path.exists(potcar):
                names = read_potcar(potcar)
                if len(names) >= len(counts):
                    species_names = names[: len(counts)]
        if species_names is None:
            species_names = [f"X{i}" for i in range(len(counts))]
        iline = 6
    else:
        species_names = toks
        counts = [int(t) for t in lines[6].split()]
        iline = 7
    sel = lines[iline].strip().lower()
    if sel.startswith("s"):  # selective dynamics
        iline += 1
        sel = lines[iline].strip().lower()
    cartesian = sel.startswith(("c", "k"))
    iline += 1
    nat = sum(counts)
    pos = np.array(
        [[float(x) for x in lines[iline + i].split()[:3]] for i in range(nat)]
    )
    if cartesian:
        pos = (pos * scale * param.ANGSTROM_TO_BOHR) @ np.linalg.inv(lat).T
    species = [Species(name=s, z=param.symbol_to_z(s)) for s in species_names]
    species_of = np.concatenate(
        [np.full(c, i, dtype=int) for i, c in enumerate(counts)]
    )
    return CrystalSeed(
        m_x2c=lat.T,  # columns = lattice vectors
        x_frac=pos,
        species_of=species_of,
        species=species,
        name=title,
    )


# ---------------------------------------------------------------------------
# Gaussian cube
# ---------------------------------------------------------------------------
def parse_cube_header(path: str):
    """Returns (x0, voxel_vectors (3,3 columns), n (3,), atoms zs, atom
    cartesians, nval) - all in bohr (cube native units)."""
    with open(path) as f:
        f.readline()
        f.readline()
        toks = f.readline().split()
        nat = int(toks[0])
        x0 = np.array([float(t) for t in toks[1:4]])
        n = np.zeros(3, dtype=int)
        vox = np.zeros((3, 3))
        for i in range(3):
            toks = f.readline().split()
            n[i] = int(toks[0])
            vox[:, i] = [float(t) for t in toks[1:4]]
        ismo = nat < 0
        nat = abs(nat)
        zs = np.zeros(nat, dtype=int)
        pos = np.zeros((nat, 3))
        for i in range(nat):
            toks = f.readline().split()
            zs[i] = int(toks[0])
            pos[i] = [float(t) for t in toks[2:5]]
        offset = f.tell()
    return x0, vox, n, zs, pos, ismo, offset


def read_cube_structure(path: str) -> CrystalSeed:
    x0, vox, n, zs, pos, _, _ = parse_cube_header(path)
    m = vox * n[None, :]  # lattice vectors = voxel vectors * counts (columns)
    frac = (pos - x0) @ np.linalg.inv(m).T
    uniq = sorted(set(zs.tolist()))
    species = [Species(name=param.z_to_symbol(z), z=z) for z in uniq]
    spmap = {z: i for i, z in enumerate(uniq)}
    species_of = np.array([spmap[z] for z in zs], dtype=int)
    return CrystalSeed(
        m_x2c=m, x_frac=frac, species_of=species_of, species=species,
        name=os.path.basename(path),
    )


# ---------------------------------------------------------------------------
# xyz (molecule)
# ---------------------------------------------------------------------------
def read_xyz(path: str, border: float = 10.0, cubic: bool = False) -> CrystalSeed:
    with open(path) as f:
        nat = int(f.readline().split()[0])
        f.readline()
        names, pos = [], []
        for _ in range(nat):
            toks = f.readline().split()
            names.append(toks[0])
            pos.append([float(t) for t in toks[1:4]])
    pos = np.array(pos) * param.ANGSTROM_TO_BOHR
    uniq = []
    for s in names:
        if s not in uniq:
            uniq.append(s)
    species = [Species(name=s, z=param.symbol_to_z(s)) for s in uniq]
    spmap = {s: i for i, s in enumerate(uniq)}
    return CrystalSeed(
        x_frac=pos,  # cartesian; converted by _molecule_to_crystal
        species_of=np.array([spmap[s] for s in names], dtype=int),
        species=species,
        ismolecule=True,
        border=border,
        cubic=cubic,
        name=os.path.basename(path),
    )


# ---------------------------------------------------------------------------
# xsf structure
# ---------------------------------------------------------------------------
def read_xsf_structure(path: str, step: int = 1) -> CrystalSeed:
    """xsf/axsf structure; for animated files `step` picks the 1-based
    PRIMCOORD animation step (reference read_xsf/read_axsf,
    src/crystalseedmod@proc.f90:2680-2851,2926-3083)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    lat = None
    names, pos = [], []
    nblock = 0
    while i < len(lines):
        ln = lines[i].upper()
        if ln.startswith("PRIMVEC"):
            lat = np.array(
                [[float(x) for x in lines[i + 1 + k].split()[:3]] for k in range(3)]
            ) * param.ANGSTROM_TO_BOHR
            i += 4
        elif ln.startswith("PRIMCOORD"):
            nblock += 1
            nat = int(lines[i + 1].split()[0])
            if nblock == step:
                names, pos = [], []
                for k in range(nat):
                    toks = lines[i + 2 + k].split()
                    names.append(toks[0])
                    pos.append([float(t) for t in toks[1:4]])
            i += 2 + nat
        else:
            i += 1
    if not names:
        raise ValueError(f"no PRIMCOORD step {step} in {path}")
    if lat is None:
        raise ValueError(f"no PRIMVEC in {path}")
    pos = np.array(pos) * param.ANGSTROM_TO_BOHR
    frac = pos @ np.linalg.inv(lat.T).T
    uniq = []
    for s in names:
        if s not in uniq:
            uniq.append(s)
    species = [
        Species(name=str(s), z=param.symbol_to_z(str(s)) if not str(s).isdigit()
                else int(s)) for s in uniq
    ]
    for sp in species:
        if sp.z == 0 and sp.name.isdigit():
            sp.z = int(sp.name)
    spmap = {s: i for i, s in enumerate(uniq)}
    return CrystalSeed(
        m_x2c=lat.T,
        x_frac=frac,
        species_of=np.array([spmap[s] for s in names], dtype=int),
        species=species,
        name=os.path.basename(path),
    )


# ---------------------------------------------------------------------------
# SHELX .res/.ins (reference read_shelx, src/crystalseedmod@proc.f90:732-1112)
# ---------------------------------------------------------------------------

_SHELX_CEN = {
    1: [(0, 0, 0)],
    2: [(0, 0, 0), (0.5, 0.5, 0.5)],
    3: [(0, 0, 0), (2 / 3, 1 / 3, 1 / 3), (1 / 3, 2 / 3, 2 / 3)],
    4: [(0, 0, 0), (0.5, 0.5, 0), (0, 0.5, 0.5), (0.5, 0, 0.5)],
    5: [(0, 0, 0), (0, 0.5, 0.5)],
    6: [(0, 0, 0), (0.5, 0, 0.5)],
    7: [(0, 0, 0), (0.5, 0.5, 0)],
}

_SHELX_IGNORE = {
    "abin", "acta", "afix", "anis", "ansc", "ansr", "basf", "bind", "bloc",
    "bond", "bump", "cgls", "chiv", "conf", "conn", "damp", "dang", "defs",
    "delu", "dfix", "disp", "eadp", "eqiv", "exti", "exyz", "flat", "fmap",
    "free", "fvar", "grid", "hfix", "hklf", "hope", "htab", "isor", "laue",
    "list", "l.s.", "merg", "mole", "more", "move", "mpla", "ncsy", "neut",
    "omit", "part", "plan", "prig", "rem", "resi", "rigu", "rtab", "sadi",
    "same", "shel", "simu", "size", "spec", "stir", "sump", "swat", "temp",
    "time", "twin", "twst", "wght", "wigl", "wpdb", "xnpd", "zerr",
}


def read_shelx(path: str) -> CrystalSeed:
    """SHELX .res/.ins: CELL + LATT centerings + SYMM ops + SFAC species,
    atoms expanded over the symmetry found in the file."""
    from ..io.cif import parse_symop

    cell = None
    cen = list(_SHELX_CEN[1])
    iscent = True                      # LATT default is 1 (P, centrosymmetric)
    ops = [(np.eye(3), np.zeros(3))]
    spc = []
    atoms = []                         # (isp, x)
    name = os.path.basename(path)

    lines = open(path, errors="replace").read().splitlines()
    # join continuation lines ending in '='
    joined, buf = [], ""
    for ln in lines:
        s = buf + ln
        if s.rstrip().endswith("="):
            buf = s.rstrip()[:-1]
            continue
        buf = ""
        joined.append(s)

    for ln in joined:
        t = ln.split("!")[0].split()
        if not t:
            continue
        kw = t[0].lower()[:4]
        if kw == "titl":
            name = " ".join(t[1:]) or name
        elif kw == "cell":
            v = [float(x) for x in t[1:8]]
            aa = np.array(v[1:4]) * param.ANGSTROM_TO_BOHR
            cell = m_x2c_from_cellpar(aa, v[4:7])
        elif kw == "latt":
            ilat = int(t[1])
            cen = list(_SHELX_CEN[abs(ilat)])
            iscent = ilat > 0
        elif kw == "symm":
            rot, tr = parse_symop(" ".join(t[1:]).lower())
            if np.allclose(rot, np.eye(3)):
                if not np.allclose(tr, 0):
                    cen.append(tuple(tr))           # pure translation
            else:
                ops.append((rot, tr))
        elif kw == "sfac":
            for w in t[1:]:
                z = param.symbol_to_z(w)
                if not z:
                    break
                spc.append(Species(w.capitalize(), z))
        elif kw in ("unit", "frag", "fend") or kw in _SHELX_IGNORE:
            continue
        elif kw == "end":
            break
        elif param.symbol_to_z(''.join(c for c in t[0] if c.isalpha())):
            if len(t) >= 5:
                try:
                    isp = int(t[1])
                    x = np.array([float(v) for v in t[2:5]])
                except ValueError:
                    continue
                if not (1 <= isp <= max(len(spc), 99)):
                    raise ValueError("atom type not in SFAC list")
                atoms.append((isp - 1, x))
    if cell is None:
        raise ValueError(f"no CELL card in {path}")
    if not spc or not atoms:
        raise ValueError(f"no SFAC/atoms in {path}")

    if iscent:
        ops = ops + [(-r, t) for (r, t) in ops]

    frac, spof = [], []
    for isp, x in atoms:
        for rot, tr in ops:
            for cv in cen:
                xx = (rot @ x + tr + np.asarray(cv)) % 1.0
                xx[xx > 1 - 1e-6] = 0.0
                dup = any(np.linalg.norm(((xx - f0) - np.rint(xx - f0))
                                         @ cell.T) < 1e-3 for f0 in frac)
                if not dup:
                    frac.append(xx)
                    spof.append(isp)
    return CrystalSeed(m_x2c=cell, x_frac=np.asarray(frac),
                       species_of=np.asarray(spof, dtype=int),
                       species=spc, name=name)


# ---------------------------------------------------------------------------
# Quantum ESPRESSO pw.x input/output (reference read_espresso,
# src/crystalseedmod@proc.f90 qe branches)
# ---------------------------------------------------------------------------

def _qe_ibrav_cell(ibrav: int, celldm) -> np.ndarray:
    """QE Bravais lattice vectors (rows) in bohr from celldm (QE
    Doc/INPUT_PW ibrav conventions)."""
    a = celldm[1]
    b = celldm[2] * a
    c = celldm[3] * a
    if ibrav == 1:
        v = np.eye(3) * a
    elif ibrav == 2:
        v = a / 2 * np.array([[-1, 0, 1], [0, 1, 1], [-1, 1, 0]], float)
    elif ibrav == 3:
        v = a / 2 * np.array([[1, 1, 1], [-1, 1, 1], [-1, -1, 1]], float)
    elif ibrav == 4:
        v = np.array([[a, 0, 0], [-a / 2, a * np.sqrt(3) / 2, 0], [0, 0, c]])
    elif ibrav == 5:
        cg = celldm[4]
        tx = np.sqrt((1 - cg) / 2)
        ty = np.sqrt((1 - cg) / 6)
        tz = np.sqrt((1 + 2 * cg) / 3)
        v = a * np.array([[tx, -ty, tz], [0, 2 * ty, tz], [-tx, -ty, tz]])
    elif ibrav == -5:
        # trigonal, threefold axis along (111) (reference qe_latgen,
        # src/crystalseedmod@proc.f90:4851)
        t1 = np.sqrt(1 + 2 * celldm[4])
        t2 = np.sqrt(1 - celldm[4])
        u = a * (t1 - 2 * t2) / 3
        w = a * (t1 + t2) / 3
        v = np.array([[u, w, w], [w, u, w], [w, w, u]])
    elif ibrav == 6:
        v = np.diag([a, a, c])
    elif ibrav == 7:
        v = np.array([[a / 2, -a / 2, c / 2], [a / 2, a / 2, c / 2],
                      [-a / 2, -a / 2, c / 2]])
    elif ibrav == 8:
        v = np.diag([a, b, c])
    elif ibrav == 9:
        v = np.array([[a / 2, b / 2, 0], [-a / 2, b / 2, 0], [0, 0, c]])
    elif ibrav == 10:
        v = np.array([[a / 2, 0, c / 2], [a / 2, b / 2, 0], [0, b / 2, c / 2]])
    elif ibrav == 11:
        v = np.array([[a / 2, b / 2, c / 2], [-a / 2, b / 2, c / 2],
                      [-a / 2, -b / 2, c / 2]])
    elif ibrav == 12:
        cg = celldm[4]
        sg = np.sqrt(1 - cg * cg)
        v = np.array([[a, 0, 0], [b * cg, b * sg, 0], [0, 0, c]])
    elif ibrav == -12:
        # simple monoclinic, unique axis b (reference qe_latgen,
        # src/crystalseedmod@proc.f90:4927)
        cb = celldm[4]
        sb = np.sqrt(1 - cb * cb)
        v = np.array([[a, 0, 0], [0, b, 0], [c * cb, 0, c * sb]])
    elif ibrav == 13:
        cg = celldm[4]
        sg = np.sqrt(1 - cg * cg)
        v = np.array([[a / 2, 0, -c / 2], [b * cg, b * sg, 0],
                      [a / 2, 0, c / 2]])
    elif ibrav == 14:
        ca, cb, cg = celldm[4], celldm[5], celldm[6]
        sg = np.sqrt(1 - cg * cg)
        v = np.array([
            [a, 0, 0],
            [b * cg, b * sg, 0],
            [c * cb, c * (ca - cb * cg) / sg,
             c * np.sqrt(1 + 2 * ca * cb * cg - ca**2 - cb**2 - cg**2) / sg]])
    else:
        raise NotImplementedError(f"QE ibrav {ibrav}")
    return v


def read_qe_in(path: str) -> CrystalSeed:
    """pw.x input: &system namelist + CELL_PARAMETERS/ATOMIC_POSITIONS."""
    text = open(path, errors="replace").read()
    lines = text.splitlines()

    def _nml(key, default=None):
        m = re.search(rf"{key}\s*=\s*([^,\s/]+)", text, re.I)
        return m.group(1) if m else default

    ibrav = int(_nml("ibrav", "0"))
    nat = int(_nml("nat", "0"))
    celldm = np.zeros(7)
    for i in range(1, 7):
        m = re.search(rf"celldm\((\s*{i}\s*)\)\s*=\s*([-\d.eEdD+]+)", text)
        if m:
            celldm[i] = float(m.group(2).replace("d", "e").replace("D", "E"))
    for key, i in (("A", 1), ("B", 2), ("C", 3)):
        m = re.search(rf"(?<![\w]){key}\s*=\s*([-\d.eEdD+]+)", text)
        if m and celldm[i] == 0:
            celldm[i] = float(m.group(1).replace("d", "e")) \
                * param.ANGSTROM_TO_BOHR
    if celldm[1] and celldm[2] > 10:     # A,B,C given absolute
        celldm[2] /= celldm[1]
        celldm[3] /= celldm[1]
    alat = celldm[1]

    lat = None
    atoms, aunits = [], "alat"
    i = 0
    while i < len(lines):
        t = lines[i].split()
        if not t:
            i += 1
            continue
        kw = t[0].upper()
        if kw.startswith("CELL_PARAMETERS"):
            unit = (t[1] if len(t) > 1 else "bohr").strip("{}()").lower()
            lat = np.array([[float(v) for v in lines[i + 1 + j].split()[:3]]
                            for j in range(3)])
            if unit.startswith("ang"):
                lat *= param.ANGSTROM_TO_BOHR
            elif unit.startswith("alat"):
                lat *= alat
            i += 4
            continue
        if kw.startswith("ATOMIC_POSITIONS"):
            aunits = (t[1] if len(t) > 1 else "alat").strip("{}()").lower()
            for j in range(nat):
                w = lines[i + 1 + j].split()
                atoms.append((w[0], [float(v) for v in w[1:4]]))
            i += 1 + nat
            continue
        i += 1

    if lat is None:
        lat = _qe_ibrav_cell(ibrav, celldm)
    if alat == 0:
        alat = np.linalg.norm(lat[0])
    return _qe_seed(path, lat, atoms, aunits, alat)


def _qe_seed(path, lat, atoms, aunits, alat) -> CrystalSeed:
    pos = np.array([p for _, p in atoms], dtype=float)
    if aunits.startswith("crystal"):
        frac = pos
    else:
        if aunits.startswith("ang"):
            pos = pos * param.ANGSTROM_TO_BOHR
        elif aunits.startswith("alat"):
            pos = pos * alat
        frac = pos @ np.linalg.inv(lat)
    names = [n for n, _ in atoms]
    uniq = list(dict.fromkeys(names))
    species = [Species(s, param.symbol_to_z(
        "".join(c for c in s if c.isalpha()))) for s in uniq]
    spmap = {s: i for i, s in enumerate(uniq)}
    return CrystalSeed(m_x2c=lat.T, x_frac=np.mod(frac, 1.0),
                       species_of=np.array([spmap[n] for n in names]),
                       species=species, name=os.path.basename(path))


def read_qe_out(path: str) -> CrystalSeed:
    """pw.x output: last structure printed (vc-relax aware)."""
    lines = open(path, errors="replace").read().splitlines()
    alat = None
    lat = None
    atoms, aunits = [], "alat"
    i = 0
    while i < len(lines):
        ln = lines[i]
        if "lattice parameter (alat)" in ln:
            alat = float(ln.split("=")[1].split()[0])
        elif "crystal axes:" in ln:
            lat = np.array([[float(v) for v in
                             lines[i + 1 + j].split("(")[-1].split(")")[0]
                             .split()] for j in range(3)]) * alat
        elif ln.strip().startswith("site n.") and "positions" in ln:
            aunits = "crystal" if "cryst. coord" in ln else "alat"
            atoms = []
            j = i + 1
            while j < len(lines) and "tau(" in lines[j]:
                w = lines[j].split()
                xyz = lines[j].split("(")[-1].split(")")[0].split()
                atoms.append((w[1], [float(v) for v in xyz]))
                j += 1
            i = j
            continue
        elif ln.strip().startswith("CELL_PARAMETERS"):
            unit = ln.split("(")[-1].split(")")[0].strip().lower()
            scale = param.ANGSTROM_TO_BOHR if unit.startswith("ang") else (
                float(unit.split("=")[1]) if "alat" in unit else 1.0)
            lat = np.array([[float(v) for v in lines[i + 1 + j].split()[:3]]
                            for j in range(3)]) * scale
            i += 4
            continue
        elif ln.strip().startswith("ATOMIC_POSITIONS"):
            aunits = ln.split("(")[-1].split(")")[0].strip().lower()
            atoms = []
            j = i + 1
            while j < len(lines):
                w = lines[j].split()
                if len(w) < 4:
                    break
                try:
                    atoms.append((w[0], [float(v) for v in w[1:4]]))
                except ValueError:
                    break
                j += 1
            i = j
            continue
        i += 1
    if lat is None or not atoms:
        raise ValueError(f"no structure found in QE output {path}")
    return _qe_seed(path, lat, atoms, aunits, alat or 1.0)


def read_dftb_gen(path: str) -> CrystalSeed:
    """DFTB+ .gen: C (cluster), S (supercell cartesian), F (fractional);
    coordinates in angstrom (reference read_dftbp, crystalseedmod)."""
    lines = [ln for ln in open(path, errors="replace").read().splitlines()
             if ln.split("#")[0].strip()]
    t = lines[0].split()
    nat, mode = int(t[0]), t[1].upper()
    names = lines[1].split()
    spof, pos = [], []
    for j in range(nat):
        w = lines[2 + j].split()
        spof.append(int(w[1]) - 1)
        pos.append([float(v) for v in w[2:5]])
    pos = np.array(pos) * param.ANGSTROM_TO_BOHR
    species = [Species(s, param.symbol_to_z(s)) for s in names]
    if mode == "C":
        seed = CrystalSeed(ismolecule=True, name=os.path.basename(path))
        # reuse molecule embedding via read_xyz-style path
        m = np.eye(3) * (pos.max() - pos.min() + 20.0)
        frac = (pos - pos.min(0) + 10.0) @ np.linalg.inv(m)
        return CrystalSeed(m_x2c=m, x_frac=frac,
                           species_of=np.array(spof), species=species,
                           ismolecule=True, name=os.path.basename(path))
    lat = np.array([[float(v) for v in lines[3 + nat + j].split()[:3]]
                    for j in range(3)]) * param.ANGSTROM_TO_BOHR
    if mode == "F":
        frac = pos / param.ANGSTROM_TO_BOHR     # F coords are fractional
    else:
        frac = pos @ np.linalg.inv(lat)
    return CrystalSeed(m_x2c=lat.T, x_frac=np.mod(frac, 1.0),
                       species_of=np.array(spof), species=species,
                       name=os.path.basename(path))


def read_abinit_structure(path: str) -> CrystalSeed:
    from ..io.abinit import read_structure_seed

    return read_structure_seed(path)
