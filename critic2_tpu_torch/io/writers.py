"""Structure writers (reference WRITE keyword,
src/crystalmod@proc.f90 write_* family, ~18 formats).

Implemented: xyz, POSCAR/VASP, CIF, XSF, Quantum ESPRESSO pw.x input,
Gaussian gjf, critic2-style .cri, escher-compatible m. All host-side.
"""
from __future__ import annotations

import numpy as np

from .. import param

__all__ = ["write_structure", "write_xyz", "write_poscar", "write_cif",
           "write_xsf", "write_qe_in", "write_gjf", "write_cri"]


def write_structure(crystal, path: str, fmt: str | None = None):
    if fmt is None:
        low = path.lower()
        if low.endswith("elk.in"):
            fmt = "elk"
        elif low.endswith("poscar") or low.endswith("contcar"):
            fmt = "poscar"
        else:
            extmap = {"xyz": "xyz", "cif": "cif", "xsf": "xsf",
                      "vasp": "poscar", "abin": "abinit", "gin": "gulp",
                      "gulp": "gulp", "lammps": "lammps", "gen": "gen",
                      "d12": "d12", "m": "escher", "db": "db",
                      "tess": "tessel", "fdf": "siesta-fdf",
                      "struct_in": "siesta-struct", "hsd": "dftbp-hsd",
                      "obj": "3dmodel", "ply": "3dmodel",
                      "off": "3dmodel", "in": "qe", "gjf": "gjf",
                      "cri": "cri"}
            ext = low.rsplit(".", 1)[-1] if "." in low else ""
            fmt = extmap.get(ext)
    if fmt is None:
        raise ValueError(f"cannot infer write format for {path}")
    return {"xyz": write_xyz, "poscar": write_poscar, "cif": write_cif,
            "xsf": write_xsf, "qe": write_qe_in, "gjf": write_gjf,
            "cri": write_cri, "abinit": write_abinit,
            "elk": write_elk_in, "gulp": write_gulp,
            "lammps": write_lammps, "gen": write_dftb_gen,
            "d12": write_d12, "escher": write_escher, "db": write_db,
            "tessel": write_tessel, "siesta-fdf": write_siesta_fdf,
            "siesta-struct": write_siesta_struct,
            "dftbp-hsd": write_dftbp_hsd, "3dmodel": write_3dmodel,
            }[fmt](crystal, path)


def _names_cart(c):
    names = [c.species[s].name for s in c.species_of]
    cart = np.asarray(c.x_cart)
    if c.ismolecule and c.molx0 is not None:
        cart = cart + np.asarray(c.molx0)
    return names, cart * param.BOHR_TO_ANGSTROM


def write_xyz(c, path: str):
    names, cart = _names_cart(c)
    with open(path, "w") as f:
        f.write(f"{c.ncel}\nwritten by critic2-tpu\n")
        for nm, r in zip(names, cart):
            f.write(f"{nm:<3s} {r[0]:15.9f} {r[1]:15.9f} {r[2]:15.9f}\n")


def write_mol_fragment(frag, path: str, fmt: str | None = None):
    """Write an atom-subset fragment (nanoparticle, molecular motif,
    supercell selection) as a molecular xyz/gjf/cml file (reference
    write_mol, src/crystalmod@proc.f90:3615-3882)."""
    c = frag.crystal
    if fmt is None:
        fmt = path.rsplit(".", 1)[-1].lower()
    names = [c.species[s].name for s in np.asarray(c.species_of)[frag.at_idx]]
    cart = frag.x_cart
    if getattr(c, "ismolecule", False) and c.molx0 is not None:
        cart = cart + np.asarray(c.molx0)
    cart = cart * param.BOHR_TO_ANGSTROM
    with open(path, "w") as f:
        if fmt == "xyz":
            f.write(f"{frag.n}\nwritten by critic2-tpu\n")
            for nm, r in zip(names, cart):
                f.write(f"{nm:<3s} {r[0]:15.9f} {r[1]:15.9f} "
                        f"{r[2]:15.9f}\n")
        elif fmt == "gjf":
            f.write("#p b3lyp sto-3g\n\nwritten by critic2-tpu\n\n0 1\n")
            for nm, r in zip(names, cart):
                f.write(f"{nm} {r[0]:15.9f} {r[1]:15.9f} {r[2]:15.9f}\n")
            f.write("\n")
        elif fmt == "cml":
            f.write("<?xml version=\"1.0\" encoding=\"UTF-8\"?>\n"
                    "<molecule>\n <atomArray>\n")
            for i, (nm, r) in enumerate(zip(names, cart)):
                f.write(f"  <atom id=\"a{i + 1}\" elementType=\"{nm}\" "
                        f"x3=\"{r[0]:.9f}\" y3=\"{r[1]:.9f}\" "
                        f"z3=\"{r[2]:.9f}\"/>\n")
            f.write(" </atomArray>\n</molecule>\n")
        else:
            raise ValueError(f"unsupported molecular write format {fmt}")


def write_poscar(c, path: str):
    m = np.asarray(c.m_x2c).T * param.BOHR_TO_ANGSTROM   # rows = vectors
    order = np.argsort(c.species_of, kind="stable")
    counts = {}
    for s in c.species_of:
        counts[s] = counts.get(s, 0) + 1
    uniq = sorted(counts)
    with open(path, "w") as f:
        f.write("written by critic2-tpu\n1.0\n")
        for row in m:
            f.write(f"  {row[0]:18.12f} {row[1]:18.12f} {row[2]:18.12f}\n")
        f.write(" ".join(c.species[s].name for s in uniq) + "\n")
        f.write(" ".join(str(counts[s]) for s in uniq) + "\n")
        f.write("Direct\n")
        for i in order:
            x = c.x_frac[i]
            f.write(f"  {x[0]:18.12f} {x[1]:18.12f} {x[2]:18.12f}\n")


def write_cif(c, path: str):
    aa = np.asarray(c.aa) * param.BOHR_TO_ANGSTROM
    bb = np.asarray(c.bb)
    with open(path, "w") as f:
        f.write("data_critic2_tpu\n")
        for k, v in zip("abc", aa):
            f.write(f"_cell_length_{k} {v:.10f}\n")
        for k, v in zip(("alpha", "beta", "gamma"), bb):
            f.write(f"_cell_angle_{k} {v:.6f}\n")
        f.write("_symmetry_space_group_name_H-M 'P 1'\n")
        f.write("loop_\n_symmetry_equiv_pos_as_xyz\n'x,y,z'\n")
        f.write("loop_\n_atom_site_label\n_atom_site_type_symbol\n"
                "_atom_site_fract_x\n_atom_site_fract_y\n_atom_site_fract_z\n")
        counts = {}
        for i, s in enumerate(c.species_of):
            nm = c.species[s].name
            counts[nm] = counts.get(nm, 0) + 1
            x = c.x_frac[i]
            f.write(f"{nm}{counts[nm]} {nm} {x[0]:.10f} {x[1]:.10f} "
                    f"{x[2]:.10f}\n")


def write_xsf(c, path: str):
    m = np.asarray(c.m_x2c).T * param.BOHR_TO_ANGSTROM
    names, cart = _names_cart(c)
    zs = c.zatoms
    with open(path, "w") as f:
        if c.ismolecule:
            f.write("MOLECULE\nATOMS\n")
            for z, r in zip(zs, cart):
                f.write(f"{z:4d} {r[0]:15.9f} {r[1]:15.9f} {r[2]:15.9f}\n")
            return
        f.write("CRYSTAL\nPRIMVEC\n")
        for row in m:
            f.write(f"  {row[0]:15.9f} {row[1]:15.9f} {row[2]:15.9f}\n")
        f.write(f"PRIMCOORD\n{c.ncel} 1\n")
        for z, r in zip(zs, cart):
            f.write(f"{z:4d} {r[0]:15.9f} {r[1]:15.9f} {r[2]:15.9f}\n")


def write_qe_in(c, path: str):
    m = np.asarray(c.m_x2c).T * param.BOHR_TO_ANGSTROM
    names, cart = _names_cart(c)
    uniq = sorted({c.species[s].name for s in c.species_of})
    with open(path, "w") as f:
        f.write("&control\n calculation='scf'\n/\n&system\n ibrav=0\n"
                f" nat={c.ncel}\n ntyp={len(uniq)}\n/\n&electrons\n/\n")
        f.write("ATOMIC_SPECIES\n")
        for nm in uniq:
            f.write(f"{nm} 1.0 {nm}.UPF\n")
        f.write("CELL_PARAMETERS angstrom\n")
        for row in m:
            f.write(f"  {row[0]:18.12f} {row[1]:18.12f} {row[2]:18.12f}\n")
        f.write("ATOMIC_POSITIONS crystal\n")
        for i, s in enumerate(c.species_of):
            x = c.x_frac[i]
            f.write(f"{c.species[s].name} {x[0]:18.12f} {x[1]:18.12f} "
                    f"{x[2]:18.12f}\n")


def write_gjf(c, path: str):
    names, cart = _names_cart(c)
    with open(path, "w") as f:
        f.write("#p b3lyp sto-3g\n\nwritten by critic2-tpu\n\n0 1\n")
        for nm, r in zip(names, cart):
            f.write(f"{nm} {r[0]:14.8f} {r[1]:14.8f} {r[2]:14.8f}\n")
        f.write("\n")


def write_cri(c, path: str):
    aa = np.asarray(c.aa)
    bb = np.asarray(c.bb)
    with open(path, "w") as f:
        f.write("crystal\n" if not c.ismolecule else "molecule\n")
        f.write(f" cell {aa[0]:.10f} {aa[1]:.10f} {aa[2]:.10f} "
                f"{bb[0]:.6f} {bb[1]:.6f} {bb[2]:.6f}\n")
        for i, s in enumerate(c.species_of):
            x = c.x_frac[i]
            f.write(f" neq {x[0]:.10f} {x[1]:.10f} {x[2]:.10f} "
                    f"{c.species[s].name}\n")
        f.write("endcrystal\n" if not c.ismolecule else "endmolecule\n")


def write_abinit(c, path: str):
    """abinit structure block (reference write_abinit,
    src/crystalmod@proc.f90): acell/angdeg/typat/xred."""
    gpq = np.asarray(c.m_x2c).T @ np.asarray(c.m_x2c)
    aa = np.sqrt(np.diag(gpq))
    bb = [np.degrees(np.arccos(gpq[1, 2] / (aa[1] * aa[2]))),
          np.degrees(np.arccos(gpq[0, 2] / (aa[0] * aa[2]))),
          np.degrees(np.arccos(gpq[0, 1] / (aa[0] * aa[1])))]
    spof = np.asarray(c.species_of)
    with open(path, "w") as fh:
        fh.write("acell " + " ".join(f"{v:.10f}" for v in aa) + "\n")
        fh.write("angdeg " + " ".join(f"{v:.10f}" for v in bb) + "\n")
        fh.write(f"ntypat {len(c.species)}\n")
        fh.write("znucl " + " ".join(str(s.z) for s in c.species) + "\n")
        fh.write(f"natom {c.ncel}\n")
        fh.write("typat " + " ".join(
            f"{(spof == i).sum()}*{i + 1}"
            for i in range(len(c.species))) + "\n")
        fh.write("xred\n")
        order = np.argsort(spof, kind="stable")
        for i in order:
            fh.write("  " + " ".join(f"{v:.10f}"
                                     for v in c.x_frac[i]) + "\n")


def write_elk_in(c, path: str):
    """elk.in structure block (reference write_elk)."""
    spof = np.asarray(c.species_of)
    with open(path, "w") as fh:
        fh.write("tasks\n0\n\nxctype\n20\n\navec\n")
        m = np.asarray(c.m_x2c)
        for i in range(3):
            fh.write("  " + " ".join(f"{v:.10f}" for v in m[:, i]) + "\n")
        fh.write("\nsppath\n'./'\n\natoms\n")
        fh.write(f"  {len(c.species)}\n")
        for i, sp in enumerate(c.species):
            fh.write(f"  '{sp.name}.in'\n")
            idx = np.where(spof == i)[0]
            fh.write(f"  {len(idx)}\n")
            for j in idx:
                fh.write("  " + " ".join(f"{v:.10f}"
                                         for v in c.x_frac[j])
                         + " 0.0 0.0 0.0\n")
        fh.write("\nngridk\n  4 4 4\n\nrgkmax\n  7.0\n")


def write_gulp(c, path: str):
    """GULP input (reference write_gulp): cell + fractional atoms."""
    from ..crystal.cell import cellpar_from_m_x2c

    aa, bb = cellpar_from_m_x2c(c.m_x2c)
    names = [c.species[s].name for s in c.species_of]
    with open(path, "w") as fh:
        fh.write("eem\ncell " + " ".join(
            f"{v * param.BOHR_TO_ANGSTROM:.9f}" for v in aa)
            + " " + " ".join(f"{v:.5f}" for v in bb) + "\n")
        fh.write("fractional\n")
        for n, x in zip(names, np.asarray(c.x_frac)):
            fh.write(f"{n:<5s} " + " ".join(f"{v:.9f}" for v in x) + "\n")


def write_lammps(c, path: str):
    """LAMMPS data file (reference write_lammps; orthogonal cells, as
    in the reference)."""
    m = np.asarray(c.m_x2c)
    if abs(m[0, 1]) > 1e-12 or abs(m[0, 2]) > 1e-12 or \
            abs(m[1, 2]) > 1e-12:
        raise ValueError("write_lammps: non-orthogonal cells not "
                         "implemented (as in the reference)")
    cart = np.asarray(c.x_cart) * param.BOHR_TO_ANGSTROM
    with open(path, "w") as fh:
        fh.write("LAMMPS data file created by critic2-tpu.\n\n")
        fh.write(f"{c.ncel:9d} atoms\n")
        fh.write(f"{len(c.species):9d} atom types\n\n")
        for lo, hi, tag in ((0.0, m[0, 0], "xlo xhi"),
                            (0.0, m[1, 1], "ylo yhi"),
                            (0.0, m[2, 2], "zlo zhi")):
            fh.write(f"{lo:16.9f} {hi * param.BOHR_TO_ANGSTROM:16.9f} "
                     f"{tag}\n")
        fh.write("\nMasses\n\n")
        for i, sp in enumerate(c.species):
            fh.write(f"{i + 1} {param.atomic_mass(sp.z):10.4f}\n")
        fh.write("\nAtoms\n\n")
        for i in range(c.ncel):
            fh.write(f"{i + 1:7d} {int(c.species_of[i]) + 1:4d} "
                     + " ".join(f"{v:15.8f}" for v in cart[i]) + "\n")


def write_dftb_gen(c, path: str):
    """DFTB+ .gen file (S/F lattice formats)."""
    names = [sp.name for sp in c.species]
    with open(path, "w") as fh:
        kind = "C" if c.ismolecule else "F"
        fh.write(f"{c.ncel} {kind}\n")
        fh.write(" ".join(names) + "\n")
        xs = (np.asarray(c.x_cart) * param.BOHR_TO_ANGSTROM
              if c.ismolecule else np.asarray(c.x_frac))
        for i in range(c.ncel):
            fh.write(f"{i + 1:6d} {int(c.species_of[i]) + 1:3d} "
                     + " ".join(f"{v:18.10e}" for v in xs[i]) + "\n")
        if not c.ismolecule:
            fh.write("0.0 0.0 0.0\n")
            m = np.asarray(c.m_x2c) * param.BOHR_TO_ANGSTROM
            for i in range(3):
                fh.write(" ".join(f"{v:18.10e}" for v in m[:, i]) + "\n")


def write_d12(c, path: str, dosym: bool = True):
    """CRYSTAL d12 input (reference write_d12,
    src/crystalmod@proc.f90:4378-4470): space-group number + the
    holohedry-reduced cell parameter list + nonequivalent atoms, or the
    P1 fallback (all 6 parameters, all atoms) without symmetry."""
    b2a = param.BOHR_TO_ANGSTROM
    aa = np.asarray(c.aa) * b2a
    bb = np.asarray(c.bb)
    irhomb = 0
    spgnum = 1
    xmin = list(aa) + list(bb)
    idx = range(c.ncel)
    frac = np.asarray(c.x_frac)
    if dosym and not c.ismolecule:
        _, ita = c.spg_name()
        sg = c.spacegroup
        if ita:
            spgnum = int(ita)
            cs = getattr(sg, "crystal_system", "triclinic")
            if cs == "monoclinic":
                off = [float(b) for b in bb if abs(b - 90.0) > 1e-5]
                xmin = list(aa) + [off[0] if off else 90.0]
            elif cs == "orthorhombic":
                xmin = list(aa)
            elif cs == "tetragonal":
                xmin = [aa[0], aa[2]]
            elif cs in ("trigonal", "rhombohedral"):
                n90 = int(np.sum(np.abs(bb - 90.0) < 0.1))
                n120 = int(np.sum(
                    np.abs(np.sin(np.radians(bb)) - np.sqrt(3) / 2) < 1e-2))
                if n90 == 2 and n120 == 1:
                    xmin = [aa[0], aa[2]]          # hexagonal axes
                else:
                    xmin = [aa[0], bb[0]]          # rhombohedral axes
                    irhomb = 1
            elif cs == "hexagonal":
                xmin = [aa[0], aa[2]]
            elif cs == "cubic":
                xmin = [aa[0]]
            idx = list(np.asarray(sg.irr_idx))
        else:
            spgnum = 1
    with open(path, "w") as fh:
        fh.write("Title\nCRYSTAL\n")
        fh.write(f"0 {irhomb} 0\n{spgnum}\n")
        fh.write(" ".join(f"{v:15.8f}" for v in xmin) + "\n")
        fh.write(f"{len(list(idx))}\n")
        for i in idx:
            z = c.species[c.species_of[i]].z
            fh.write(f"{z} " + " ".join(f"{v:15.8f}" for v in frac[i])
                     + "\n")
        fh.write("SETPRINT\n1\n3 1\nEND\nxx basis xx\n99 0\nEND\n"
                 "SHRINK\n4 4\nTOLDEE\n7\nEND\n")


def write_escher(c, path: str):
    """escher octave struct script (reference write_escher,
    src/crystalmod@proc.f90:4494-4565)."""
    m = np.asarray(c.m_x2c)
    gt = m.T @ m
    with open(path, "w") as fh:
        fh.write("cr = struct();\n")
        fh.write(f'cr.name = "{getattr(c, "name", "") or "crystal"}";\n')
        fh.write("cr.a = [" + " ".join(f"{v:.14e}" for v in c.aa) + "];\n")
        fh.write("cr.b = [" + " ".join(
            f"{np.radians(v):.14e}" for v in c.bb) + "];\n")
        fh.write(f"cr.nat = {c.ncel};\n")
        fh.write(f"cr.ntyp = {len(c.species)};\n")
        fh.write("cr.r = [\n")
        for i in range(3):
            fh.write("  " + " ".join(f"{v:.14e}" for v in m[:, i]) + "\n")
        fh.write("  ];\n")
        fh.write("cr.g = [\n")
        for i in range(3):
            fh.write("  " + " ".join(f"{v:.14e}" for v in gt[:, i]) + "\n")
        fh.write("  ];\n")
        fh.write(f"cr.omega = {c.volume:.14e};\n")
        fh.write("cr.ztyp = [" + " ".join(str(sp.z) for sp in c.species)
                 + "];\n")
        fh.write("cr.attyp = {" + ",".join(f'"{sp.name}"'
                                           for sp in c.species) + "};\n")
        fh.write("cr.typ = [" + " ".join(str(int(s) + 1)
                                         for s in c.species_of) + "];\n")
        fh.write("cr.x = [\n")
        for x in np.asarray(c.x_frac):
            fh.write("  " + " ".join(f"{v:.14e}" for v in x) + "\n")
        fh.write("  ];\n")


def write_db(c, path: str):
    """dcp db input (reference write_db,
    src/crystalmod@proc.f90:4568-4588)."""
    b2a = param.BOHR_TO_ANGSTROM
    with open(path, "w") as fh:
        fh.write("type crystal_energy\nkpts 4\ncrys\n")
        fh.write(" ".join(f"{v * b2a:18.10f}" for v in c.aa)
                 + " " + " ".join(f"{v:18.10f}" for v in c.bb) + "\n")
        for i in range(c.ncel):
            sp = c.species[c.species_of[i]]
            fh.write(f"{param.z_to_symbol(sp.z)} "
                     + " ".join(f"{v:18.10f}"
                                for v in np.asarray(c.x_frac)[i]) + "\n")
        fh.write("end\n")


def write_tessel(c, path: str):
    """tessel scene script (reference write_tessel,
    src/crystalmod@proc.f90:4262-4310)."""
    import os

    root = os.path.splitext(os.path.basename(path))[0]
    sg = None if c.ismolecule else c.spacegroup
    with open(path, "w") as fh:
        fh.write("set camangle 75 -10 45\n")
        fh.write("set background background {color rgb <1,1,1>}\n")
        fh.write("set use_planes .false.\n")
        fh.write("set ball_texture finish{specular 0.2 roughness 0.1 "
                 "reflection 0.1}\n")
        fh.write("set equalscale noscale\n")
        fh.write("molecule\n  crystal\n    symmatrix seitz\n")
        fh.write("     cen  0.000000000000 0.000000000000 "
                 "0.000000000000\n     #\n")
        rots = (sg.rotations if sg is not None
                else np.eye(3, dtype=int)[None])
        trs = (sg.translations if sg is not None else np.zeros((1, 3)))
        for R, t in zip(rots, trs):
            for k in range(3):
                fh.write("     " + " ".join(f"{v:5.2f}" for v in R[k])
                         + f" {t[k]:15.12f}\n")
            fh.write("     #\n")
        fh.write("     endsymmatrix\n")
        fh.write("     cell " + " ".join(f"{v:12.8f}" for v in c.aa)
                 + " " + " ".join(f"{v:12.8f}" for v in c.bb) + "\n")
        fh.write("     crystalbox  -2.30 -2.30 -2.30 2.30 2.30 2.30\n")
        fh.write("     clippingbox -0.020 -0.020 -0.020 "
                 "1.020 1.020 1.020\n")
        reps = (np.asarray(sg.irr_idx) if sg is not None
                else np.arange(c.ncel))
        for i in reps:
            fh.write("     neq "
                     + " ".join(f"{v:12.8f}"
                                for v in np.asarray(c.x_frac)[i])
                     + f" {c.species[c.species_of[i]].name:>10s}\n")
        fh.write("  endcrystal\n")
        fh.write("  unitcell radius 0.01 rgb 1.0 0.5 0.5 many\n")
        fh.write("  molmotif allmaincell jmol\n")
        fh.write(f"  off {root}.off\n  vrml {root}.wrl\n"
                 f"  povray {root}.pov\nendmolecule\n")
        fh.write(f"# run povray -D -UV +I{root}.pov +O{root}.png "
                 "+W2000 +H2000 +A\nend\n")


def write_siesta_fdf(c, path: str):
    """siesta input fdf (reference write_siesta_fdf,
    src/crystalmod@proc.f90)."""
    b2a = param.BOHR_TO_ANGSTROM
    with open(path, "w") as fh:
        fh.write("# fdf file created by critic2-tpu.\n\n")
        fh.write("SystemName crystal\nSystemLabel crystal\n\n")
        fh.write(f"NumberOfSpecies {len(c.species):3d}\n")
        fh.write(f"NumberOfAtoms {c.ncel:6d}\n")
        fh.write("%block Chemical_Species_Label\n")
        for i, sp in enumerate(c.species):
            fh.write(f"{i + 1:3d}{sp.z:3d} "
                     f"{param.z_to_symbol(sp.z).lower()}\n")
        fh.write("%endblock Chemical_Species_Label\n\n")
        fh.write("LatticeConstant 1.0 ang\n%block LatticeParameters\n")
        fh.write(" ".join(f"{v * b2a:16.10f}" for v in c.aa) + " "
                 + " ".join(f"{v:16.8f}" for v in c.bb) + "\n")
        fh.write("%endblock LatticeParameters\n")
        fh.write("AtomicCoordinatesFormat Fractional\n")
        fh.write("%block AtomicCoordinatesAndAtomicSpecies\n")
        frac = np.asarray(c.x_frac)
        for isp in range(len(c.species)):
            for j in range(c.ncel):
                if int(c.species_of[j]) == isp:
                    fh.write(" ".join(f"{v:18.12f}" for v in frac[j])
                             + f" {isp + 1:3d}\n")
        fh.write("%endblock AtomicCoordinatesAndAtomicSpecies\n\n")
        fh.write("XC.functional GGA\nXC.authors PBE\n"
                 "SpinPolarized .false.\nMaxSCFIterations 100\n"
                 "MeshCutoff 100. Ry\nDM.NumberPulay 3\n")


def write_siesta_struct(c, path: str):
    """siesta STRUCT_IN (reference write_siesta_in,
    src/crystalmod@proc.f90): inverse of crystal/seed.py
    read_siesta_struct."""
    b2a = param.BOHR_TO_ANGSTROM
    m = np.asarray(c.m_x2c) * b2a
    with open(path, "w") as fh:
        for i in range(3):
            fh.write(" ".join(f"{v:20.12f}" for v in m[:, i]) + "\n")
        fh.write(f" {c.ncel}\n")
        frac = np.asarray(c.x_frac)
        for isp in range(len(c.species)):
            for j in range(c.ncel):
                if int(c.species_of[j]) == isp:
                    fh.write(f"{isp + 1:3d} {c.species[isp].z:3d} "
                             + " ".join(f"{v:20.12f}" for v in frac[j])
                             + "\n")


# DFTB+ 3rd-order Hubbard derivatives and max angular momentum per Z
# (reference write_dftbp_hsd tables, src/crystalmod@proc.f90)
_HSD_HDERIV = {1: -0.1857, 6: -0.1492, 7: -0.1535, 8: -0.1575,
               9: -0.1623, 11: -0.0454, 12: -0.02, 15: -0.14, 16: -0.11,
               17: -0.0697, 19: -0.0339, 20: -0.0340, 30: -0.03,
               35: -0.0573, 53: -0.0433}
_HSD_MAXANG = {1: "s", 6: "p", 7: "p", 8: "p", 9: "p", 11: "p", 12: "p",
               15: "d", 16: "d", 17: "d", 19: "p", 20: "p", 30: "d",
               35: "d", 53: "d"}


def write_dftbp_hsd(c, path: str):
    """DFTB+ hsd input with embedded gen geometry (reference
    write_dftbp_hsd, src/crystalmod@proc.f90)."""
    import os as _os
    import tempfile

    tmp = tempfile.NamedTemporaryFile("r", suffix=".gen", delete=False)
    try:
        write_dftb_gen(c, tmp.name)
        gentxt = open(tmp.name).read()
    finally:
        _os.unlink(tmp.name)
    with open(path, "w") as fh:
        fh.write("Geometry = GenFormat {\n")
        fh.write(gentxt)
        fh.write("}\n\nDriver = ConjugateGradient {\n"
                 "       MovedAtoms = 1:-1\n"
                 "       MaxForceComponent = 1e-5\n"
                 "       MaxSteps = 3000\n"
                 "       LatticeOpt = Yes\n"
                 '       OutputPrefix = "geo_end"\n}\n\n')
        fh.write("Hamiltonian = DFTB{\n  ThirdOrderFull = Yes\n"
                 "  SCC = Yes\n  SCCTolerance = 1e-7\n"
                 "  MaxSCCIterations = 125\n  MaxAngularMomentum = {\n")
        for sp in c.species:
            fh.write(f"    {param.z_to_symbol(sp.z)} = "
                     f"{_HSD_MAXANG.get(sp.z, 'x')}\n")
        fh.write("  }\n  SlaterKosterFiles = Type2FileNames {\n"
                 '    Prefix = "xxx"\n    Separator = "-"\n'
                 '    Suffix = ".skf"\n    LowerCaseTypeName = No\n  }\n')
        if not c.ismolecule:
            fh.write("  KPointsAndWeights = SupercellFolding {\n"
                     "    4 0 0 \n    0 4 0\n    0 0 4\n"
                     "    0.5 0.5 0.5\n  }\n")
        fh.write("  DampXH = Yes\n  DampXHExponent = 4.2\n"
                 "  HubbardDerivs {\n")
        for sp in c.species:
            fh.write(f"    {param.z_to_symbol(sp.z)} = "
                     f"{_HSD_HDERIV.get(sp.z, 0.0):.4f}\n")
        fh.write("  }\n}\n\nOptions {\n  WriteDetailedXML = Yes\n}\n\n"
                 "ParserOptions {\n  ParserVersion = 4\n}\n\n")


def write_3dmodel(c, path: str, fmt: str | None = None, ix=(1, 1, 1),
                  docell: bool = False, molmotif: bool = False):
    """Ball-and-stick 3D model of the structure to obj/ply/off
    (reference write_3dmodel, src/crystalmod@proc.f90:3884-4040):
    covalent-radius spheres + bond sticks for ix cell copies, optional
    unit-cell frame sticks."""
    from .graphics import Scene

    sc = Scene()
    m = np.asarray(c.m_x2c)
    cart = np.asarray(c.x_cart)
    rcov = np.asarray([param.covalent_radius(c.species[s].z)
                       for s in c.species_of])
    shifts = [np.array([i, j, k], dtype=float)
              for i in range(ix[0]) for j in range(ix[1])
              for k in range(ix[2])]
    allx, allr = [], []
    for sh in shifts:
        off = m @ sh
        for i in range(c.ncel):
            allx.append(cart[i] + off)
            allr.append(rcov[i])
    allx = np.asarray(allx)
    for x, r in zip(allx, allr):
        sc.ball(x, 0.6 * r)
    # sticks between covalently bonded pairs (rfac as the reference)
    for i in range(len(allx)):
        for j in range(i + 1, len(allx)):
            d = np.linalg.norm(allx[i] - allx[j])
            if 1e-6 < d < 1.4 * (allr[i] + allr[j]):
                sc.stick(allx[i], allx[j])
    if docell:
        corners = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                   (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
        edges = [(0, 1), (0, 2), (0, 3), (1, 4), (1, 5), (2, 4),
                 (2, 6), (3, 5), (3, 6), (4, 7), (5, 7), (6, 7)]
        cc = [m @ np.asarray(x, dtype=float) for x in corners]
        for a, b in edges:
            sc.stick(cc[a], cc[b], r=0.03)
    sc.write(path)
    return sc
