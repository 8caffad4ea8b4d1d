"""Keyword-driven CLI: the critic2 input-script surface.

Role of the reference main program (src/critic2.F90:102-558): a REPL
reading keyword commands (CRYSTAL, LOAD, AUTO, YT, NCIPLOT, POINT, ...),
with unknown lines falling through to expression-variable assignment
(:553-556) and syntax errors skipping the line instead of aborting
(ferror syntax mode, src/tools_io.f90:56).

Run: ``python -m critic2_tpu_torch.cli input.cri [-q] [--cpu]`` or pipe
on stdin. The REPL runs on cuda (it raises when CUDA is missing); --cpu
runs it on the CPU. Analysis results that come back as tensors pass
through `_host` before numpy touches them.
"""
from __future__ import annotations

import os
import shlex
import sys
import time

import numpy as np
import torch

from .config import resolve_device
from .system import System

__all__ = ["Repl", "main"]


class CliError(Exception):
    pass


def _host(x):
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Repl:
    def __init__(self, out=None, quiet: bool = False, device=None):
        self.device = resolve_device(device)   # every System built here
        self.sy: System | None = None
        self.out = out or sys.stdout
        self.quiet = quiet
        self.cpl = None
        self.nwarns = 0
        self.fileroot = "critic2"   # ROOT prefix for derived output files
        # variables assigned before any CRYSTAL/MOLECULE line; folded into
        # system.vars when a system appears
        self.pending_vars: dict[str, float] = {}
        # runtime settings (role of critic_setvariables,
        # src/global.f90:97-184 / src/global@proc.f90)
        self.opts = {
            "units": None,           # None = default (bohr cryst / ang mol)
            "symprec": 1e-5,
            "nosym": False,
            "bondfactor": 1.4,
            "ode_gradeps": 1e-7,
            "int_radquad": "gauleg",
            "int_nr": 50,
            "int_abserr": 1e-10,
            "int_relerr": 1e-7,
            "meshtype": "becke",
            "meshlevel": "normal",
            "prune_distance": -1.0,
        }

    # ------------------------------------------------------------------
    def write(self, *args):
        print(*args, file=self.out)

    def warn(self, msg):
        self.nwarns += 1
        self.write(f"!! warning: {msg}")

    def need_system(self):
        if self.sy is None:
            raise CliError("no structure loaded (use CRYSTAL/MOLECULE)")
        return self.sy

    # ------------------------------------------------------------------
    def run_script(self, text: str):
        lines = iter(text.splitlines())
        for raw in lines:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            if not self.quiet:
                self.write(f"%% {raw.rstrip()}")
            try:
                self.dispatch(line, lines)
            except CliError as exc:
                self.warn(str(exc))
            except (NotImplementedError, FileNotFoundError, ValueError,
                    KeyError) as exc:
                self.warn(f"{type(exc).__name__}: {exc}")

    # ------------------------------------------------------------------
    def dispatch(self, line: str, lines):
        toks = shlex.split(line)
        kw = toks[0].lower()
        rest = toks[1:]
        handler = getattr(self, f"cmd_{kw}", None)
        if handler is not None:
            from .utils import runlog, trace

            if runlog.sink():
                t0 = time.perf_counter()
                with trace.recording() as rec:
                    try:
                        out = handler(rest, lines)
                    finally:
                        runlog.log(kw, wall_s=time.perf_counter() - t0,
                                   args=rest, nwarns=self.nwarns,
                                   **rec.summary())
                return out
            return handler(rest, lines)
        if "=" in line and not line.lower().startswith(tuple(
                k[4:] for k in dir(self) if k.startswith("cmd_"))):
            name, _, expr = line.partition("=")
            name = name.strip()
            if name.isidentifier():
                sy = self.sy
                if sy is not None:
                    val = float(_host(
                        sy.eval_expr(expr.strip(), np.zeros((1, 3))))[0])
                    sy.vars[name] = val
                else:
                    from .arithmetic import eval_const
                    val = eval_const(expr.strip(), self.pending_vars)
                    self.pending_vars[name] = val
                self.write(f"{name} = {val}")
                return
        raise CliError(f"unknown keyword: {toks[0]}")

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------
    def cmd_crystal(self, args, lines):
        if not args:
            # inline CRYSTAL ... ENDCRYSTAL environment (reference
            # parse_crystal_env, src/crystalseedmod@proc.f90:40-290)
            from . import param
            from .crystal.seed import parse_crystal_env

            sc = {"ang": param.ANGSTROM_TO_BOHR,
                  "bohr": 1.0}.get(self.opts["units"])
            seed = parse_crystal_env(lines, mol=False, unit_scale=sc)
            self.sy = System.from_structure(seed.to_crystal(),
                                            device=self.device)
            self.sy.vars.update(self.pending_vars)
            c = self.sy.crystal
            self.write(f"+ crystal: <input> | {c.ncel} atoms | "
                       f"volume {c.volume:.4f} bohr^3")
            return
        if args[0].lower() == "library":
            # CRYSTAL LIBRARY entry (reference read_library)
            from .crystal.library import load_library_entry

            seed = load_library_entry(
                " ".join(args[1:]), mol=False,
                path=self.opts.get("clib"))
            self.sy = System.from_structure(seed.to_crystal(),
                                            device=self.device)
            self.sy.vars.update(self.pending_vars)
            c = self.sy.crystal
            self.write(f"+ crystal: library {seed.name} | {c.ncel} atoms"
                       f" | volume {c.volume:.4f} bohr^3")
            return
        self.sy = System.from_structure(args[0], device=self.device)
        self.sy.vars.update(self.pending_vars)
        c = self.sy.crystal
        self.write(f"+ crystal: {args[0]} | {c.ncel} atoms | "
                   f"volume {c.volume:.4f} bohr^3")
        try:
            from .crystal.fragment import list_molecules

            frags, ismol = list_molecules(c)
            if ismol:
                self.write(f"+ molecular crystal: {len(frags)} "
                           "molecule(s) per cell")
        except Exception:       # connectivity report is best-effort
            pass

    def cmd_molecule(self, args, lines):
        if not args:
            # inline MOLECULE ... ENDMOLECULE environment (reference
            # parse_molecule_env, src/crystalseedmod@proc.f90:293-460)
            from .crystal.seed import parse_crystal_env

            seed = parse_crystal_env(lines, mol=True)
            self.sy = System.from_structure(seed.to_crystal(),
                                            device=self.device)
            self.sy.vars.update(self.pending_vars)
            self.write(f"+ molecule: <input> | {self.sy.crystal.ncel} "
                       "atoms")
            args = ["<input>"]
        elif args[0].lower() == "library":
            from .crystal.library import load_library_entry

            seed = load_library_entry(" ".join(args[1:]), mol=True,
                                      path=self.opts.get("mlib"))
            self.sy = System.from_structure(seed.to_crystal(),
                                            device=self.device)
            self.sy.vars.update(self.pending_vars)
            self.write(f"+ molecule: library {seed.name} | "
                       f"{self.sy.crystal.ncel} atoms")
        else:
            self.sy = System.from_structure(
                args[0], mol=True, device=self.device) \
                if args[0].endswith(".xyz") \
                else System.from_structure(args[0], device=self.device)
            self.sy.vars.update(self.pending_vars)
            self.write(f"+ molecule: {args[0]} | "
                       f"{self.sy.crystal.ncel} atoms")
        try:
            from .crystal.sympg import molecular_point_group

            c = self.sy.crystal
            pos = np.asarray(c.x_frac) @ np.asarray(c.m_x2c).T
            zs = np.asarray([c.species[s].z for s in c.species_of])
            sym, _ = molecular_point_group(pos, zs)
            self.write(f"+ point group: {sym}")
        except Exception:       # naming is best-effort, never fatal
            pass

    # ------------------------------------------------------------------
    # fields
    # ------------------------------------------------------------------
    def cmd_load(self, args, lines):
        sy = self.need_system()
        if not args:
            raise CliError("LOAD needs a file or AS expr")
        name = None
        if "id" in [a.lower() for a in args]:
            i = [a.lower() for a in args].index("id")
            name = args[i + 1]
            args = args[:i] + args[i + 2:]
        def _fid(tok):
            t = tok.lstrip("$")
            return int(t) if t.lstrip("-").isdigit() else t

        def _shape_of(toks):
            low = [t.lower() for t in toks]
            if "sizeof" in low:
                i = low.index("sizeof")
                g = sy.field(_fid(toks[i + 1]))
                return tuple(g.grid.n)
            for i in range(len(toks) - 2):
                if all(t.isdigit() for t in toks[i:i + 3]):
                    return tuple(int(v) for v in toks[i:i + 3])
            return None

        if args[0].lower() == "pi" or args[0].lower().endswith(".ion"):
            toks = args[1:] if args[0].lower() == "pi" else args
            ions = {}
            i = 0
            while i < len(toks):
                if toks[i].lower().endswith(".ion") and i + 1 < len(toks):
                    ions[toks[i + 1]] = toks[i]
                    i += 2
                else:
                    i += 1
            fid = sy.load_field_pi(ions, name=name)
        elif args[0].lower() == "copy":
            fid = sy.load_field_as("copy", src=_fid(args[1]), name=name)
        elif args[0].lower() == "as":
            sub = args[1].lower()
            rest = args[2:]
            low = [t.lower() for t in rest]
            if sub in ("lap", "grad", "pot", "hxx1", "hxx2", "hxx3"):
                fid = sy.load_field_as(sub, src=_fid(rest[0]), name=name,
                                       isry="ry" in low)
            elif sub == "clm":
                fid = sy.load_field_as(f"clm {rest[0].lower()}",
                                       src=_fid(rest[1]), src2=_fid(rest[2]),
                                       name=name)
            elif sub in ("core", "promolecular"):
                frag = None
                if "fragment" in low:
                    frag = rest[low.index("fragment") + 1]
                fid = sy.load_field_as(sub, shape=_shape_of(rest),
                                       fragment=frag, name=name)
            elif sub == "ghost":
                fid = sy.load_field_expr(rest[0], name=name, ghost=True)
            else:
                expr = args[1]
                fid = sy.load_field_expr(expr, name=name,
                                         shape=_shape_of(args[2:]),
                                         ghost="ghost" in
                                         [a.lower() for a in args[2:]])
        else:
            interp = None
            for mode in ("trilinear", "tricubic", "trispline", "nearest"):
                if mode in [a.lower() for a in args[1:]]:
                    interp = mode
            kw = {}
            # LAPW fields take two files: LOAD x.clmsum x.struct;
            # QE takes LOAD x.pwc [y.chk [z.chk]] (spin-down chk);
            # DFTB+ takes LOAD detailed.xml eigenvec.bin wfc.hsd
            # (reference ifformat_dftb, src/fieldseedmod@proc.f90)
            if len(args) > 1 and args[1].lower().endswith((".struct",
                                                           ".out", ".chk",
                                                           ".bin")):
                kw["file2"] = args[1]
                if len(args) > 2 and args[2].lower().endswith((".chk",
                                                               ".hsd")):
                    kw["file3"] = args[2]
            fid = sy.load_field(args[0], name=name, **kw)
            if interp:
                sy.field(fid).set_options(interp=interp)
        f = sy.field(fid)
        # post-load options (reference fieldseed_parse_options,
        # src/fieldseedmod@proc.f90:463-): CORE/NOCORE, TYPNUC,
        # NORMALIZE n
        low = [a.lower() for a in args]
        if "core" in low:
            f.usecore = True
        if "nocore" in low:
            f.usecore = False
        if "typnuc" in low:
            f.typnuc = int(args[low.index("typnuc") + 1])
        if "normalize" in low and f.type == "grid":
            nwant = float(args[low.index("normalize") + 1])
            cur = float(f.grid.f.sum()) \
                * sy.crystal.volume / f.grid.f.numel()
            f.grid.f = f.grid.f * (nwant / cur)
            self.write(f"+ normalized: {cur:.6f} -> {nwant:.6f} e")
        self.write(f"+ field {fid} <- {f.name} (type {f.type})"
                   + (f" grid {tuple(f.grid.n)}" if f.type == "grid" else ""))

    # ------------------------------------------------------------------
    # settings keywords (critic_setvariables, src/global@proc.f90)
    # ------------------------------------------------------------------
    def cmd_units(self, args, lines):
        u = args[0].lower()
        if u.startswith(("bohr", "au", "a.u")):
            self.opts["units"] = "bohr"
        elif u.startswith(("ang", "angs")):
            self.opts["units"] = "ang"
        else:
            raise CliError(f"unknown units {args[0]}")

    def cmd_radii(self, args, lines):
        """RADII {at r}...: override covalent radii used for the bond
        network (reference atmcov assignment,
        src/global@proc.f90:596-619); r in the current input units."""
        from . import param

        scale = (param.ANGSTROM_TO_BOHR
                 if self.opts.get("units", "bohr") == "ang" else 1.0)
        for i in range(0, len(args) - 1, 2):
            at = args[i]
            z = int(at) if at.lstrip("+-").isdigit() else \
                param.symbol_to_z(at)
            if z < 1:
                raise CliError(f"unknown element {at!r} in RADII")
            param.set_covalent_radius(z, float(args[i + 1]) * scale)

    def cmd_symprec(self, args, lines):
        self.opts["symprec"] = float(args[0])
        if self.sy is not None:
            self.sy.crystal.symprec = self.opts["symprec"]
            self.sy.crystal._sg = None

    def cmd_nosym(self, args, lines):
        self.opts["nosym"] = True
        if self.sy is not None:
            self.sy.crystal.nosym = True
            self.sy.crystal._sg = None

    cmd_nosymm = cmd_nosym

    def cmd_sym(self, args, lines):
        if args and args[0].lstrip("-").isdigit() and int(args[0]) < 0:
            return self.cmd_nosym(args[1:], lines)
        self.opts["nosym"] = False
        if self.sy is not None:
            self.sy.crystal.nosym = False
            self.sy.crystal._sg = None
            c = self.sy.crystal
            sg = c.spacegroup
            self.write(f"+ symmetry: {sg.nops} operations | "
                       f"{sg.crystal_system} | {sg.nneq} non-equivalent "
                       "atoms")
            name, ita = c.spg_name()
            if name:
                self.write(f"+ space group: {name} (ITA no. {ita})")
                letters = c.wyckoffs()
                if letters:
                    reps = np.asarray(sg.irr_idx)
                    mult = np.asarray(sg.mult)
                    tags = [f"{c.species[c.species_of[r]].name}:"
                            f"{m}{w}" for r, m, w in
                            zip(reps, mult, letters)]
                    self.write("+ wyckoff positions: " + " ".join(tags))

    cmd_symm = cmd_sym

    def cmd_bondfactor(self, args, lines):
        self.opts["bondfactor"] = float(args[0])
        if self.sy is not None:
            self.sy.crystal._nstar = None

    def cmd_ode_mode(self, args, lines):
        low = [a.lower() for a in args]
        if "gradeps" in low:
            self.opts["ode_gradeps"] = float(args[low.index("gradeps") + 1])
        # METHOD/MAXSTEP accepted for surface parity (single batched
        # BS23 stepper on device; reference steppers are a CPU concept)

    def cmd_int_radial(self, args, lines):
        low = [a.lower() for a in args]
        if "type" in low:
            t = low[low.index("type") + 1]
            self.opts["int_radquad"] = "qags" if t in ("qags", "qng", "qag") \
                else "gauleg"
        if "nr" in low:
            self.opts["int_nr"] = int(args[low.index("nr") + 1])
        if "abserr" in low:
            self.opts["int_abserr"] = float(args[low.index("abserr") + 1])
        if "relerr" in low:
            self.opts["int_relerr"] = float(args[low.index("relerr") + 1])

    def cmd_cub_abs(self, args, lines):
        """CUB_ABS f: qtree cubature absolute error per tetrahedron
        (reference CUB_ABS, src/global@proc.f90 setvariables)."""
        self.opts["cub_abs"] = float(args[0])

    def cmd_cub_rel(self, args, lines):
        """CUB_REL f (reference CUB_REL)."""
        self.opts["cub_rel"] = float(args[0])

    def cmd_keastnum(self, args, lines):
        """KEASTNUM n: qtree Keast rule order (reference KEASTNUM)."""
        self.opts["keastnum"] = int(args[0])

    def cmd_minl(self, args, lines):
        """MINL n: qtree minimum subdivision level before the corner
        uniformity test is trusted (reference QTREE_MINL,
        src/global@proc.f90:529, default 4)."""
        self.opts["qtree_minl"] = int(args[0])

    cmd_qtree_minl = cmd_minl               # the reference keyword name

    def cmd_cub_mpts(self, args, lines):
        """CUB_MPTS n: qtree adaptive-cubature evaluation budget
        (reference CUB_MPTS, the CUBPACK MAXPTS role); maps to the
        refinement queue's max candidate count."""
        self.opts["cub_mpts"] = int(args[0])

    def cmd_precisecube(self, args, lines):
        """PRECISECUBE: E22.14 cube values (reference default,
        src/global@proc.f90:90)."""
        from . import config
        config.PRECISECUBE = True

    def cmd_standardcube(self, args, lines):
        """STANDARDCUBE: 1p,e12.5 cube values (reference
        src/global@proc.f90:591)."""
        from . import config
        config.PRECISECUBE = False

    def cmd_gradeps(self, args, lines):
        """GRADEPS f: gradient-path |grad| termination threshold
        (reference gradeps under ODE_MODE, src/global@proc.f90)."""
        self.opts["ode_gradeps"] = float(args[0])

    def cmd_integ_mode(self, args, lines):
        """INTEG_MODE [level] n: n in 1..10 -> Keast rule n; 11 ->
        corner sum (reference INTEG_MODE, src/global@proc.f90)."""
        vals = [int(a) for a in args if a.lstrip("-").isdigit()]
        mode = vals[-1] if vals else 0
        if mode == 11 or mode == -1:
            self.opts["qtree_integ"] = "corner"
        elif 1 <= mode <= 10:
            self.opts["qtree_integ"] = "keast"
            self.opts["keastnum"] = mode
        else:
            self.warn(f"unknown INTEG_MODE {mode}")

    def cmd_ws_origin(self, args, lines):
        """WS_ORIGIN x y z: qtree WS-cell origin; mapped to the nearest
        atom (reference ws_origin, src/global.f90:176)."""
        x = np.array([float(a) for a in args[:3]])
        sy = self.need_system()
        d = sy.crystal.x_frac - x[None, :]
        d -= np.round(d)
        dc = np.linalg.norm(d @ np.asarray(sy.crystal.m_x2c).T, axis=1)
        self.opts["qtree_origin"] = int(np.argmin(dc))
        self.write(f"+ ws_origin -> atom {self.opts['qtree_origin'] + 1}")

    def cmd_autosph(self, args, lines):
        """AUTOSPH n: beta-sphere determination method - both map to
        the verified-shrink auto spheres (reference setsph_lvl/autosph)."""
        self.opts.pop("sphfactor", None)

    def cmd_meshtype(self, args, lines):
        low = [a.lower() for a in args]
        if low and low[0] in ("becke", "franchini"):
            self.opts["meshtype"] = low[0]
        for lv in ("small", "normal", "good", "verygood", "amazing"):
            if lv in low:
                self.opts["meshlevel"] = lv

    def cmd_prune_distance(self, args, lines):
        self.opts["prune_distance"] = float(args[0])

    def cmd_library(self, args, lines):
        """LIBRARY CRYSTAL path | LIBRARY MOLECULE path: override the
        structure library files (reference critic_setvariables LIBRARY,
        src/global@proc.f90)."""
        if len(args) >= 2 and args[0].lower() in ("crystal", "molecule"):
            key = "clib" if args[0].lower() == "crystal" else "mlib"
            self.opts[key] = args[1]
            self.write(f"+ {args[0].lower()} library: {args[1]}")
        else:
            raise CliError("LIBRARY CRYSTAL/MOLECULE path")

    def _unit_scale(self):
        """Input-coordinate factor to bohr for cartesian inputs."""
        from . import param

        u = self.opts["units"]
        if u == "ang":
            return param.ANGSTROM_TO_BOHR
        if u == "bohr":
            return 1.0
        return param.ANGSTROM_TO_BOHR if (
            self.sy is not None and self.sy.crystal.ismolecule) else 1.0

    # ------------------------------------------------------------------
    # cell transforms / identification
    # ------------------------------------------------------------------
    def cmd_newcell(self, args, lines):
        """NEWCELL x11..x33 | PRIMITIVE | NIGGLI | DELAUNAY (reference
        src/crystalmod.f90:163-167)."""
        from .crystal.transform import (newcell, niggli_reduce,
                                        primitive_cell)
        from .crystal.wscell import reduced_basis

        sy = self.need_system()
        c = sy.crystal
        low = [a.lower() for a in args]
        if not args:
            raise CliError("NEWCELL needs a matrix or keyword")
        if low[0] in ("primitive", "primstd"):
            cnew = primitive_cell(c, symprec=self.opts["symprec"])
        elif low[0] == "niggli":
            _, T = niggli_reduce(np.asarray(c.m_x2c))
            cnew = newcell(c, T)
        elif low[0] == "delaunay":
            T = np.rint(reduced_basis(np.asarray(c.m_x2c))).astype(int)
            cnew = newcell(c, T.T if abs(np.linalg.det(T.T)) > 1e-9 else T)
        elif low[0] == "standard":
            cnew = primitive_cell(c, symprec=self.opts["symprec"])
        else:
            from .arithmetic import eval_const

            # tokens are expressions (1/2, sqrt(2), ...) like the
            # reference's eval_next; trailing INV/INVERSE applies the
            # inverse transform (src/struct_drivers@proc.f90:1977)
            doinv = low[-1] in ("inv", "inverse")
            nums = args[:-1] if doinv else args
            vals = [float(eval_const(v, sy.vars)) for v in nums]
            if len(vals) == 3:
                M = np.diag(vals)
            elif len(vals) >= 9:
                M = np.array(vals[:9]).reshape(3, 3)
            else:
                raise CliError("NEWCELL needs 3 or 9 numbers")
            if doinv:
                M = np.linalg.inv(M)
            cnew = newcell(c, M)
        nfields = len([k for k in sy.fields if k != 0])
        self.sy = System.from_structure(cnew, device=self.device)
        self.sy.vars.update(self.pending_vars)
        self.cpl = None
        msg = f"+ NEWCELL: {cnew.ncel} atoms | volume {cnew.volume:.4f}"
        if nfields:
            msg += f" (dropped {nfields} loaded fields)"
        self.write(msg)

    def cmd_identify(self, args, lines):
        """IDENTIFY [file.xyz] | IDENTIFY ... ENDIDENTIFY block: match
        points against the atom/CP list (reference struct_identify)."""
        sy = self.need_system()
        from . import param

        pts = []
        if args and len(args) >= 3 and all(
                a.replace(".", "").replace("-", "").replace("e", "")
                .replace("+", "").isdigit() for a in args[:3]):
            # inline point(s): IDENTIFY x y z [x y z ...]
            vals = [float(v) for v in args]
            pts = np.asarray(vals).reshape(-1, 3)
            cart = sy.crystal.ismolecule
            if cart:
                pts = pts * self._unit_scale()
        elif args:
            path = args[0]
            with open(path) as fh:
                n = int(fh.readline().split()[0])
                fh.readline()
                for _ in range(n):
                    t = fh.readline().split()
                    pts.append([float(v) for v in t[1:4]])
            pts = np.asarray(pts) * param.ANGSTROM_TO_BOHR
            cart = True
        else:
            for raw in lines:
                t = raw.split("#")[0].split()
                if not t:
                    continue
                if t[0].lower().startswith("endidentify") or \
                        t[0].lower() == "end":
                    break
                pts.append([float(v) for v in t[:3]])
            pts = np.asarray(pts)
            cart = sy.crystal.ismolecule
            if cart:
                pts = pts * self._unit_scale()
        if len(pts) == 0:
            return
        icrd = param.ICRD_CART if cart else param.ICRD_CRYS
        pts = np.asarray(pts, dtype=float)
        if cart and sy.crystal.ismolecule:
            # user molecule frame -> internal frame (reference shifts by
            # molx0, src/crystalmod@proc.f90 struct_identify)
            pts = pts - np.asarray(sy.crystal.molx0)
        ids, dist = sy.crystal.identify_atom(pts, icrd=icrd,
                                             distmax=1e-2)
        self.write("# point  ->  atom (dist, bohr)")
        for k, (i, d) in enumerate(zip(np.atleast_1d(ids),
                                       np.atleast_1d(dist))):
            nm = (sy.crystal.species[sy.crystal.species_of[i]].name
                  if i >= 0 else "--")
            self.write(f"  {k + 1:4d}  {nm:>4s} {int(i) + 1 if i >= 0 else -1:4d}"
                       f"  {d:.6f}")

    def cmd_zpsp(self, args, lines):
        """ZPSP At1 q1 [At2 q2 ...]: pseudopotential charges for core
        augmentation (reference Q/ZPSP keyword,
        src/struct_drivers@proc.f90)."""
        sy = self.need_system()
        from .param import symbol_to_z

        zp = getattr(sy, "zpsp", None) or {}
        i = 0
        while i + 1 < len(args):
            sym = args[i]
            z = int(sym) if sym.isdigit() else symbol_to_z(sym)
            zp[z] = int(float(args[i + 1]))
            i += 2
        sy.zpsp = zp
        for f in sy.fields.values():
            f.zpsp = dict(zp)
            f._coreenv = None
        self.write("+ zpsp: " + " ".join(f"{z}:{q}" for z, q in zp.items()))

    def cmd_q(self, args, lines):
        """Q At1 q1 ...: point charges per species (Ewald)."""
        sy = self.need_system()
        from .param import symbol_to_z

        qs = getattr(sy, "qat", None) or {}
        i = 0
        while i + 1 < len(args):
            sym = args[i]
            z = int(sym) if sym.isdigit() else symbol_to_z(sym)
            qs[z] = float(args[i + 1])
            i += 2
        sy.qat = qs

    cmd_qat = cmd_q

    def cmd_nocore(self, args, lines):
        sy = self.need_system()
        sy.zpsp = {}
        for f in sy.fields.values():
            f.zpsp = {}
            f.usecore = False
            f._coreenv = None

    def cmd_unload(self, args, lines):
        self.need_system().unload_field(
            int(args[0]) if args[0].isdigit() else args[0])

    def cmd_reference(self, args, lines):
        sy = self.need_system()
        sy.set_reference(int(args[0]) if args[0].isdigit() else args[0])
        self.write(f"+ reference field: {sy.iref}")

    def cmd_setfield(self, args, lines):
        """SETFIELD [id] [TRILINEAR|TRICUBIC|TRISPLINE|NEAREST]
        [CORE|NOCORE] [TYPNUC t] (reference setfield ->
        fieldseed_parse_options, src/fieldseedmod@proc.f90:463-)."""
        sy = self.need_system()
        fid = int(args[0]) if args and args[0].isdigit() else sy.iref
        opts = [a.lower() for a in args[1:]]
        f = sy.field(fid)
        for mode in ("trilinear", "tricubic", "trispline", "nearest"):
            if mode in opts:
                f.set_options(interp=mode)
        if "core" in opts:
            f.usecore = True
        if "nocore" in opts:
            f.usecore = False
        if "typnuc" in opts:
            f.typnuc = int(args[1 + opts.index("typnuc") + 1])

    # ------------------------------------------------------------------
    # point properties / plots
    # ------------------------------------------------------------------
    def cmd_point(self, args, lines):
        """POINT x y z [FIELD id|expr] [ALL] (reference rhoplot_point,
        src/rhoplot@proc.f90:68-146; ALL evaluates every loaded
        field)."""
        from .analysis import rhoplot

        sy = self.need_system()
        x = [float(v) for v in args[:3]]
        low = [a.lower() for a in args]
        fids = [None]
        if "field" in low:
            raw_tok = args[low.index("field") + 1]
            tok = raw_tok.lstrip("$")
            if tok.lstrip("-").isdigit():
                fids = [int(tok)]
            else:
                try:
                    sy.field(tok)
                    fids = [tok]
                except KeyError:
                    # arbitrary expression at the point (reference
                    # rhoplot_point expression branch,
                    # src/rhoplot@proc.f90:101-120)
                    cart = np.asarray(x) @ np.asarray(
                        sy.crystal.m_x2c).T
                    v = float(_host(
                        sy.eval_expr(raw_tok, cart[None, :]))[0])
                    self.write(f"  {raw_tok} = {v:.10e}")
                    return
        elif "all" in low:
            fids = sorted(sy.fields.keys(), key=str)
        for fid in fids:
            if fid is not None:
                self.write(f"+ field {fid}:")
            rep = rhoplot.point(sy, x, field=fid)
            self.write(str(rep))
        if sy.pointprops:
            cart = np.asarray(x) @ np.asarray(sy.crystal.m_x2c).T
            for expr in sy.pointprops:
                try:
                    v = float(_host(sy.eval_expr(expr,
                                                 cart[None, :]))[0])
                    self.write(f"  {expr}: {v:.8e}")
                except Exception as exc:  # noqa: BLE001
                    self.warn(f"pointprop {expr!r}: {exc}")

    def cmd_line(self, args, lines):
        """LINE x0.. x1.. [npts] [FIELD id|expr]
        [F|GX..GZ|GMOD|HXX..HZZ|LAP] [FILE out] (reference
        rhoplot_line, src/rhoplot@proc.f90:148-354)."""
        from .analysis import rhoplot

        sy = self.need_system()
        x0 = [float(v) for v in args[:3]]
        x1 = [float(v) for v in args[3:6]]
        npts = int(args[6]) if len(args) > 6 and args[6].isdigit() \
            else 201
        low = [a.lower() for a in args]
        file = None
        if "file" in low:
            file = args[low.index("file") + 1]
        what = "f"
        field = None
        if "field" in low:
            tok = args[low.index("field") + 1]
            if tok.lstrip("$").lstrip("-").isdigit():
                field = int(tok.lstrip("$"))
            else:
                what = tok
        sel = {"f", "gx", "gy", "gz", "gmod", "lap", "hxx", "hxy",
               "hxz", "hyy", "hyz", "hzz"}
        for a in low[6:]:
            if a in sel:
                what = a[1:] if a.startswith("h") else a
        t, dist, vals = rhoplot.line(sy, x0, x1, npts, field=field,
                                     what=what, file=file)
        self.write(f"+ LINE: {npts} points, {what} in "
                   f"[{vals.min():.6e}, {vals.max():.6e}]"
                   + (f" -> {file}" if file else ""))

    def cmd_plane(self, args, lines):
        """PLANE x0 y0 z0 x1 y1 z1 x2 y2 z2 [NPTS nx ny] [FIELD id]
        [F|GX|...|LAP] [FILE root] [CONTOUR [LOG] [n]] [RELIEF]
        [COLORMAP] (reference rhoplot_plane,
        src/rhoplot@proc.f90:645-...)."""
        from .analysis import rhoplot

        sy = self.need_system()
        vals = [float(v) for v in args[:9]]
        x0, x1, x2 = vals[0:3], vals[3:6], vals[6:9]
        low = [a.lower() for a in args]
        nx = ny = 101
        if "npts" in low:
            i = low.index("npts")
            nx, ny = int(args[i + 1]), int(args[i + 2])
        field = None
        if "field" in low:
            field = args[low.index("field") + 1]
        what = "f"
        for w in ("f", "gx", "gy", "gz", "gmod", "lap"):
            if w in low[9:]:
                what = w
        file = None
        if "file" in low:
            file = args[low.index("file") + 1]
        emit = None
        nctr = 20
        logscale = False
        for mode in ("contour", "relief", "colormap"):
            if mode in low:
                emit = mode
                i = low.index(mode)
                if i + 1 < len(low) and low[i + 1] == "log":
                    logscale = True
                    i += 1
                if i + 1 < len(args) and args[i + 1].isdigit():
                    nctr = int(args[i + 1])
        if emit and not file:
            file = "plane.dat"
        u, v, pv = rhoplot.plane(sy, x0, x1, x2, nx, ny, field=field,
                                 what=what, file=file, emit=emit,
                                 nctr=nctr, logscale=logscale)
        self.write(f"+ PLANE: {nx}x{ny}, {what} in "
                   f"[{pv.min():.6e}, {pv.max():.6e}]"
                   + (f" -> {file}" if file else ""))

    def cmd_grdvec(self, args, lines):
        """GRDVEC x0.. x1.. x2.. [NPTS nx ny] [NSEED n] [FILE root] —
        or the reference block form GRDVEC ... ENDGRDVEC with PLANE,
        NPTS, FILE, CP id, CPALL, BCPALL, RBCPALL sub-keywords
        (reference grdvec, src/rhoplot@proc.f90:~1800)."""
        from .analysis import rhoplot

        sy = self.need_system()
        low = [a.lower() for a in args]
        kw = {}
        file = None
        vals = None
        cpfilter = None
        if args and not args[0].lower() in ("plane", "file"):
            vals = [float(v) for v in args[:9]]
        else:
            # block form
            if not args:
                for raw in lines:
                    t = raw.split("#")[0].split()
                    if not t:
                        continue
                    k = t[0].lower()
                    if k in ("endgrdvec", "end"):
                        break
                    if k == "plane":
                        vals = [float(v) for v in t[1:10]]
                    elif k == "npts":
                        kw["nx"], kw["ny"] = int(t[1]), int(t[2])
                    elif k == "file":
                        file = t[1]
                    elif k == "cpall":
                        cpfilter = (-3, -1, 1, 3)
                    elif k == "bcpall":
                        # bond CPs only (rhoplot@proc.f90:1166-1168)
                        cpfilter = (-1,)
                    elif k == "rbcpall":
                        # bond + ring CPs (rhoplot@proc.f90:1192-1203)
                        cpfilter = (-1, 1)
                    elif k == "cp":
                        cpfilter = ("id", int(t[1]) - 1)
                    else:
                        self.warn(f"GRDVEC: ignored option {t[0]}")
            low = []
        if vals is None:
            raise CliError("GRDVEC needs a PLANE")
        if "npts" in low:
            i = low.index("npts")
            kw["nx"], kw["ny"] = int(args[i + 1]), int(args[i + 2])
        if "nseed" in low:
            kw["nseed"] = int(args[low.index("nseed") + 1])
        if "file" in low:
            file = args[low.index("file") + 1]
        cpl = self.cpl
        if cpl is not None and cpfilter is not None:
            from .analysis.autocp import CPList

            if cpfilter and cpfilter[0] == "id":
                cps = [cpl.cps[cpfilter[1]]]
            else:
                cps = [cp for cp in cpl.cps if cp.typ in cpfilter]
            cpl = CPList(crystal=cpl.crystal, cps=cps)
        ctr, paths = rhoplot.grdvec(sy, vals[0:3], vals[3:6], vals[6:9],
                                    cpl=cpl, file=file, **kw)
        self.write(f"+ GRDVEC: {len(paths)} paths"
                   + (f" -> {file}" if file else ""))

    def cmd_cube(self, args, lines):
        """CUBE [x0 y0 z0 x1 y1 z1 | CELL] [GRID n1 n2 n3] [FILE out]
        [FIELD id|expr] [F|GX..GZ|GMOD|HXX..HZZ|LAP] [HEADER]
        [MLWF ibnd | WANNIER ibnd | UNK ibnd ik | PSINK ibnd ik
         [SPIN s]]
        (reference rhoplot_cube, src/rhoplot@proc.f90:356-645; Wannier/
        Bloch dumps use the rotate_qe_evc/get_qe_wnr machinery,
        src/grid3mod@proc.f90:1440-1577; output extension selects
        cube/bincube/xsf/CHGCAR)."""
        from .analysis import rhoplot

        sy = self.need_system()
        n = None
        file = None
        what = "f"
        origin = (0.0, 0.0, 0.0)
        lengths = None
        header = False
        step = None
        state = None            # (kind, ibnd, ik)
        spin = 0
        fieldid = None
        sel = {"f", "gx", "gy", "gz", "gmod", "lap",
               "hxx", "hxy", "hxz", "hyy", "hyz", "hzz"}
        i = 0
        while i < len(args):
            a = args[i].lower()
            if a in ("mlwf", "wannier", "unk", "psink"):
                nidx = 2 if a in ("unk", "psink") else 1
                try:
                    idxs = [int(v) for v in args[i + 1:i + 1 + nidx]]
                except (ValueError, IndexError):
                    raise CliError(f"CUBE {a.upper()} needs {nidx} "
                                   "integer index(es)")
                state = (a, idxs[0], idxs[1] if nidx == 2 else None)
                i += 1 + nidx
                continue
            if a == "spin":
                spin = int(args[i + 1]) - 1
                i += 2
                continue
            if a == "grid":
                # use the reference field's own grid dims (reference
                # dogrid branch); "GRID n1 n2 n3" also accepted
                if i + 3 < len(args) and all(
                        v.isdigit() for v in args[i + 1:i + 4]):
                    n = tuple(int(v) for v in args[i + 1:i + 4]); i += 4
                else:
                    if sy.ref.type == "grid":
                        n = tuple(int(v) for v in sy.ref.grid.f.shape)
                    i += 1
            elif a == "cell":
                origin, lengths = (0.0, 0.0, 0.0), None; i += 1
            elif a == "header":
                header = True; i += 1
            elif a == "file":
                file = args[i + 1]; i += 2
            elif a == "field":
                what = args[i + 1]; i += 2
            elif a in sel:
                what = a[1:] if a.startswith("h") else a; i += 1
            else:
                v = []
                for x in args[i:i + 6]:
                    try:
                        v.append(float(x))
                    except ValueError:
                        break
                if len(v) >= 6:         # x0 x1 fractional ranges
                    origin = tuple(v[:3])
                    lengths = tuple(b - a0
                                    for a0, b in zip(v[:3], v[3:6]))
                    i += 6
                elif len(v) >= 3 and all(
                        float(x).is_integer() for x in v[:3]):
                    n = tuple(int(x) for x in v[:3]); i += 3
                elif v:                 # single number: step in bohr
                    step = v[0]; i += 1
                else:
                    i += 1
        if state is not None:
            kind, ibnd, ik = state
            # FIELD selects the pwc-loaded grid; bare derivative
            # selectors don't apply to state dumps
            fld = None if what in sel or what == "f" else what
            root = (file.rsplit(".", 1)[0] if file
                    else self.fileroot or "states")
            _, paths = rhoplot.cube_states(
                sy, kind, ibnd, ik=ik, spin=spin, field=fld,
                fileroot=root)
            for p in paths:
                self.write(f"+ CUBE {kind.upper()} -> {p}")
            return
        if n is None:
            if step is not None:
                lens = np.linalg.norm(np.asarray(sy.crystal.m_x2c)
                                      * (np.asarray(lengths)
                                         if lengths is not None
                                         else 1.0), axis=0)
                n = tuple(int(round(ln / step)) + 1 for ln in lens)
            else:
                n = (64, 64, 64)
        if header:
            # HEADER: geometry-only cube, zero data (reference :389)
            data = np.zeros((2, 2, 2))
            if file:
                rhoplot.write_grid_file(sy.crystal, data, file,
                                        origin=origin,
                                        lengths=lengths or (1, 1, 1))
            self.write(f"+ CUBE header -> {file}")
            return
        data = rhoplot.cube(sy, n=n, origin=origin, lengths=lengths,
                            what=what, file=file)
        self.write(f"+ CUBE {n}: [{data.min():.6e}, {data.max():.6e}]"
                   + (f" -> {file}" if file else ""))

    # ------------------------------------------------------------------
    # analysis drivers
    # ------------------------------------------------------------------
    def cmd_auto(self, args, lines):
        """AUTO [GRADEPS e] [CPEPS e] [NUCEPS e] [NUCEPSH e] [DRY]
        [SEED WS|PAIR|TRIPLET|LINE|SPHERE|OH|POINT|MESH [DEPTH n]
        [RADIUS r] [NPTS n] [NTHETA n] [NPHI n] [NR n] [X0 x y z]]
        [CLIP CUBE x0 x1 | CLIP SPHERE x0 rad] [GRAPH]
        (reference autocritic options, src/autocp@proc.f90:155-445)."""
        from .analysis.autocp import Seed, autocp, makegraph

        sy = self.need_system()
        low = [a.lower() for a in args]
        kw = {}
        for key, name in (("gradeps", "gfnormeps"), ("cpeps", "cpeps"),
                          ("nuceps", "nuceps"), ("nucepsh", "nucepsh"),
                          ("epsdegen", "hdegen")):
            if key in low:
                kw[name] = float(args[low.index(key) + 1])
        if "clip" in low:
            i = low.index("clip")
            kind = low[i + 1]
            vals = [float(v) for v in args[i + 2:i + 2 + (6 if kind ==
                                                          "cube" else 4)]]
            kw["clip"] = ((kind, vals[0:3], vals[3:6]) if kind == "cube"
                          else (kind, vals[0:3], vals[3]))
        seeds = []
        i = 0
        while i < len(low):
            if low[i] == "seed" and i + 1 < len(low):
                styp = low[i + 1]
                skw = {}
                j = i + 2
                while j < len(low):
                    if low[j] in ("depth", "npts", "ntheta", "nphi", "nr"):
                        skw[low[j]] = int(args[j + 1])
                        j += 2
                    elif low[j] in ("radius", "dist"):
                        skw["rad" if low[j] == "radius" else "dist"] = \
                            float(args[j + 1])
                        j += 2
                    elif low[j] == "x0":
                        skw["x0"] = [float(v) for v in args[j + 1:j + 4]]
                        j += 4
                    else:
                        break
                try:
                    seeds.append(Seed(typ=styp, **skw))
                except TypeError:
                    seeds.append(Seed(typ=styp))
                i = j
                continue
            i += 1
        if seeds:
            kw["seeds"] = seeds
        if "dry" in low:
            from .analysis.autocp import gen_seeds, init_cplist

            xs = gen_seeds(sy.crystal, seeds or [
                Seed(typ="pair" if sy.crystal.ismolecule else "ws")],
                device=sy.device)
            self.write(f"+ AUTO DRY: {len(xs)} seeds generated")
            self.cpl = init_cplist(sy)
            return
        self.cpl = autocp(sy, **kw)
        n, b, r, c = self.cpl.counts()
        self.write(f"+ AUTO: {len(self.cpl.cps)} CPs "
                   f"(n={n} b={b} r={r} c={c}); "
                   f"Poincare-Hopf sum = {self.cpl.poincare_hopf()}")
        if "graph" in [a.lower() for a in args]:
            makegraph(sy, self.cpl)
            self.write("+ AUTO: bond-path graph built")

    def cmd_auto_chk(self, args, lines):
        from .utils.chk import load_cplist, save_cplist

        sy = self.need_system()
        if args and args[0].lower() == "save":
            save_cplist(self.cpl, args[1])
            self.write(f"+ CP checkpoint -> {args[1]}")
        elif args and args[0].lower() == "load":
            self.cpl = load_cplist(sy, args[1])
            self.write(f"+ CP checkpoint <- {args[1]} "
                       f"({len(self.cpl.cps)} CPs)")
        else:
            raise CliError("AUTO_CHK SAVE/LOAD file")

    def cmd_cpreport(self, args, lines):
        if self.cpl is None:
            raise CliError("no CP list (run AUTO)")
        low = [a.lower() for a in args]
        if low and low[0] == "shells":
            # reference CPREPORT SHELLS n -> critshell
            # (src/autocp@proc.f90:826-829, :962-1051)
            from .analysis.autocp import critshell

            n = int(args[1]) if len(args) > 1 else 10
            dist, nneig, wcp = critshell(self.need_system(), self.cpl, n)
            self.write("# cp  shell   dist(bohr)  mult  neighbor-cp")
            for i, cp in enumerate(self.cpl.cps):
                for sl in range(n):
                    if dist[i, sl] > 1e29:
                        break
                    self.write(f"{cp.name:>5s} {sl + 1:5d}  "
                               f"{dist[i, sl]:11.6f} {nneig[i, sl]:5d}"
                               f" {wcp[i, sl]:5d}")
            return
        if low and low[0] in ("long", "verylong"):
            # reference cp_long_report/:1567 and cp_vlong_report/:1626
            from .analysis.autocp import cp_long_report, cp_vlong_report

            fn = cp_long_report if low[0] == "long" else cp_vlong_report
            self.write(fn(self.need_system(), self.cpl))
            return
        if low and low[0] == "short":
            low = low[1:]
            args = args[1:]
        # file output: obj/ply/off scenes (reference CPREPORT writers)
        if args and args[0].lower().endswith((".obj", ".ply", ".off")):
            from .analysis.flux import cpreport_scene

            graph = "graph" in [a.lower() for a in args[1:]]
            cpreport_scene(self.need_system(), self.cpl, args[0],
                           graph=graph)
            self.write(f"+ CPREPORT scene -> {args[0]}")
            return
        self.write("# name  type      f            |grad f|      del2 f"
                   "        position (frac)")
        for cp in self.cpl.cps:
            t = {-3: "(3,-3)", -1: "(3,-1)", 1: "(3,1)", 3: "(3,3)"}[cp.typ]
            self.write(f"{cp.name:>5s} {t:>7s} {cp.f: .6e} {cp.gfmod: .6e}"
                       f" {cp.del2f: .6e}  {cp.x[0]:.6f} {cp.x[1]:.6f}"
                       f" {cp.x[2]:.6f}")

    def _write_wcubes(self, sy, res):
        """WCUBE: per-row basin weight grids as cube files (reference
        int_gridbasins wcube branch, src/integration@proc.f90:2463-2482)."""
        from .io.cube import write_cube

        c = sy.crystal
        shape = res.grid_shape
        xmat = np.asarray(c.m_x2c) @ np.diag(1.0 / np.asarray(shape))
        zs = np.asarray(c.zatoms)
        pos = np.asarray(c.x_frac) @ np.asarray(c.m_x2c).T
        amap = np.asarray(res.attr_map)
        for row in range(len(res.rows)):
            w = np.zeros(shape)
            for a in np.where(amap == row)[0]:
                w += res.decomp.weights(int(a))
            fn = f"{self.fileroot}_wcube_{row + 1:02d}.cube"
            write_cube(fn, w, np.zeros(3), xmat, zs, pos,
                       comment2=f"basin weight {res.rows[row].name}")
        self.write(f"+ Weights written to {self.fileroot}_wcube_*.cube")

    def _write_basins(self, sy, res, fmt, nwant):
        """BASINS [fmt] [n]: basin surfaces around each attractor row
        (reference int_gridbasins, src/integration@proc.f90:2380-2460;
        here via the IAS ray-bisection surface of bisect.basinplot)."""
        from .analysis.bisect import basinplot

        rows = res.rows if nwant < 0 else res.rows[:1] \
            if nwant == 0 else [r for r in res.rows if r.idx == nwant]
        for r in rows:
            fn = f"{self.fileroot}_basin_{r.idx:02d}.{fmt}"
            basinplot(sy, np.asarray(r.xfrac), level=2, file=fn)
        self.write(f"+ Basin surfaces written to "
                   f"{self.fileroot}_basin_*.{fmt}")

    def cmd_yt(self, args, lines):
        self._intgrid("yt", args)

    def cmd_bader(self, args, lines):
        self._intgrid("bader", args)

    def _intgrid(self, method, args):
        """YT/BADER keyword options (reference intgrid_driver,
        src/integration@proc.f90:96-160): NNM, NOATOMS, RATOM r, WCUBE,
        BASINS [obj|ply|off] [n], DISCARD expr; BADER adds ONGRID."""
        from .analysis.integration import intgrid

        sy = self.need_system()
        kw = {"nnm": False}
        wcube = False
        basins_fmt, basins_n = None, -1
        i = 0
        while i < len(args):
            a = args[i].lower()
            if a == "nnm":
                kw["nnm"] = True
            elif a == "noatoms":
                kw["noatoms"] = True
            elif a == "ratom":
                kw["nnm"] = True
                kw["ratom"] = float(args[i + 1]) * self._unit_scale()
                i += 1
            elif a == "wcube":
                wcube = True
            elif a == "basins":
                basins_fmt = "obj"
                if i + 1 < len(args) and args[i + 1].lower() in (
                        "obj", "ply", "off"):
                    basins_fmt = args[i + 1].lower()
                    i += 1
                if i + 1 < len(args) and args[i + 1].lstrip("-").isdigit():
                    basins_n = int(args[i + 1])
                    i += 1
            elif a == "discard":
                kw["discard"] = args[i + 1]
                i += 1
            elif a == "ongrid" and method == "bader":
                kw["bader_method"] = "ongrid"
            i += 1
        res = intgrid(sy, method=method, **kw)
        self.write(f"+ {method.upper()}: {res.nattr_raw} attractors")
        self.write(res.table())
        lmax = getattr(sy, "multipole_lmax", None)
        if lmax is not None:
            from .analysis.integration import multipoles
            from .ops.rlm import nlm

            mp = multipoles(sy, res, lmax=lmax)
            self.write(f"# atomic multipoles Q_lm (lmax={lmax}, "
                       "-m..m per l)")
            for r, row in zip(res.rows, mp):
                self.write(f"  {r.name:>4s} " + " ".join(
                    f"{v: .6e}" for v in row[:nlm(min(lmax, 2))]))
        if wcube:
            self._write_wcubes(sy, res)
        if basins_fmt is not None:
            self._write_basins(sy, res, basins_fmt, basins_n)
        for req in getattr(sy, "deloc_requests", []):
            from .analysis.deloc import deloc_wannier

            f = sy.field(req["fid"])
            if f.type != "grid" or f.grid.qe is None:
                self.write(f"! DELOC: field {req['fid']} has no QE data")
                continue
            d = deloc_wannier(sy.crystal, res.decomp, f.grid.qe,
                              useu=req["useu"] and f.grid.qe.iswan,
                              wancut=req["wancut"], device=sy.device)
            names = [r.name for r in res.rows]
            agg = d.aggregate(res.attr_map, len(res.rows))
            self.write(agg.table(names))

    def cmd_nciplot(self, args, lines):
        from .analysis.nci import nciplot

        sy = self.need_system()
        kw = {}
        oname = "nci"
        for raw in lines:
            sub = raw.split("#")[0].strip()
            if not sub:
                continue
            t = sub.split()
            k = t[0].lower()
            if k == "endnciplot" or k == "end":
                break
            if k == "oname":
                oname = t[1]
            elif k == "cutoffs":
                kw["rhocut"], kw["dimcut"] = float(t[1]), float(t[2])
            elif k == "cutplot":
                kw["rhoplot"], kw["dimplot"] = float(t[1]), float(t[2])
            elif k == "nstep":
                kw["nstep"] = tuple(int(v) for v in t[1:4])
            elif k == "increments":
                kw["xinc"] = float(t[1])
            elif k == "onlyneg":
                kw["onlyneg"] = True
            elif k == "rhoparam":
                kw["rhoparam"] = float(t[1])
            elif k == "rhoparam2":
                kw["rhoparam2"] = float(t[1])
            elif k == "void":
                kw["rho_void"] = float(t[1])
            elif k == "srhorange":
                # sign(l2)*rho window for the dat pairs (reference
                # src/nci@proc.f90:240-255)
                vals = [float(v) for v in t[1:3]]
                kw["srhorange"] = (min(vals), max(vals)) \
                    if len(vals) == 2 else (-abs(vals[0]), abs(vals[0]))
            elif k == "nochk":
                pass                      # checkpoint files are not used
            elif k == "molmotif":
                kw["molmotif"] = True
            elif k == "fragment":
                # FRAGMENT file.xyz | FRAGMENT ... ENDFRAGMENT block of
                # Cartesian coords (angstrom), matched to cell atoms
                frags = kw.setdefault("fragments", [])
                if len(t) > 1:
                    coords = []
                    with open(t[1]) as fh:
                        nat = int(fh.readline().split()[0])
                        fh.readline()
                        for _ in range(nat):
                            w = fh.readline().split()
                            coords.append([float(v) for v in w[1:4]])
                else:
                    coords = []
                    for raw2 in lines:
                        t2 = raw2.split("#")[0].split()
                        if not t2:
                            continue
                        if t2[0].lower() in ("endfragment", "end"):
                            break
                        coords.append([float(v) for v in t2[:3]])
                from . import param as _p

                pts = np.asarray(coords) * _p.ANGSTROM_TO_BOHR
                if sy.crystal.ismolecule:
                    pts = pts - np.asarray(sy.crystal.molx0)
                ids, _ = sy.crystal.identify_atom(
                    pts, icrd=_p.ICRD_CART, distmax=0.5)
                frags.append([int(i) for i in np.atleast_1d(ids)
                              if i >= 0])
            else:
                self.warn(f"NCIPLOT: ignored option {t[0]}")
        res = nciplot(sy, oname=oname, write_files=True, **kw)
        self.write(f"+ NCIPLOT: grid {res.crho.shape}, "
                   f"{res.ndat} dat points, files: "
                   + " ".join(res.files))

    def cmd_molcalc(self, args, lines):
        from .analysis.molcalc import (molcalc_hf, molcalc_integral,
                                       molcalc_nelec, molcalc_peach)

        sy = self.need_system()
        if args and args[0].lower() == "peach":
            # block: lines "imo1 [->] imo2 k" until END/ENDMOLCALC
            # (reference molcalc_peach input loop)
            trans = []
            for raw in lines:
                t = raw.split("#")[0].strip()
                if not t:
                    continue
                if t.lower() in ("end", "endmolcalc"):
                    break
                toks = [x for x in t.replace("->", " ").split()]
                if len(toks) != 3:
                    raise CliError(f"bad PEACH line: {raw!r}")
                trans.append((int(toks[0]), int(toks[1]),
                              float(toks[2])))
            lam = molcalc_peach(sy, trans)
            self.write(f"+ PEACH = {lam:.3f}")
        elif not args or args[0].lower() == "nelec":
            v = molcalc_nelec(sy)
            self.write(f"+ MOLCALC NELEC = {v:.8f}")
        elif args[0].lower() == "hf":
            res = molcalc_hf(sy)
            self.write(f"+ MOLCALC HF: E = {res['E_total']:.9f} Ha "
                       f"(E1 {res['E1']:.6f}, J {res['E_J']:.6f}, "
                       f"K {res['E_K']:.6f}, NN {res['E_nn']:.6f})")
        else:
            v = molcalc_integral(sy, " ".join(args))
            self.write(f"+ MOLCALC integral = {v:.10e}")

    def cmd_root(self, args, lines):
        """ROOT <prefix>: default output-file prefix (reference
        fileroot, src/critic2.F90:412-417)."""
        if not args:
            raise CliError("ROOT needs a prefix string")
        self.fileroot = args[0]
        self.write(f"+ root = {args[0]}")

    def cmd_molcell(self, args, lines):
        """MOLCELL [border]: molecular-cell border in fractional units
        (reference struct_molcell, src/critic2.F90:125-128)."""
        sy = self.need_system()
        if not sy.crystal.ismolecule:
            raise CliError("MOLCELL is molecules-only")
        b = float(args[0]) if args else 0.1
        sy.crystal.molborder = b
        self.write(f"+ molcell border = {b}")

    def cmd_atomlabel(self, args, lines):
        """ATOMLABEL template: rename species; %aid = species index,
        %s = symbol (reference struct_atomlabel)."""
        sy = self.need_system()
        if not args:
            raise CliError("ATOMLABEL needs a template")
        tmpl = args[0]
        for i, sp in enumerate(sy.crystal.species):
            sp.name = (tmpl.replace("%aid", str(i + 1))
                       .replace("%s", sp.name))
        self.write("+ species relabeled: "
                   + " ".join(sp.name for sp in sy.crystal.species))

    def cmd_sphfactor(self, args, lines):
        """SPHFACTOR [z|at] f: qtree beta-sphere factor (reference
        qtree_setsphfactor, src/critic2.F90:406-410)."""
        if len(args) == 1:
            self.opts["sphfactor"] = {0: float(args[0])}
        else:
            self.opts.setdefault("sphfactor", {})[args[0]] =                 float(args[1])
        self.write(f"+ sphfactor = {self.opts['sphfactor']}")

    def cmd_clearsymm(self, args, lines):
        """CLEARSYM/CLEARSYMM: drop all symmetry operations - the
        structure becomes P1 with every atom inequivalent (reference
        struct_clearsym, src/struct_drivers.f90:54)."""
        sy = self.need_system()
        c = sy.crystal
        c.nosym = True
        c._sg = None                     # rebuilt lazily as P1
        self.write("* CLEARSYM: cleared symmetry; structure is now P1 "
                   f"({c.ncel} inequivalent atoms)")

    cmd_clearsym = cmd_clearsymm

    def cmd_run(self, args, lines):
        """RUN/SYSTEM <command>: shell escape (reference
        src/critic2.F90:535-536)."""
        import subprocess

        cmd = " ".join(args)
        r = subprocess.run(cmd, shell=True, capture_output=True,
                           text=True)
        if r.stdout:
            self.write(r.stdout.rstrip())
        if r.returncode != 0:
            self.warn(f"RUN exited with {r.returncode}: "
                      f"{r.stderr.strip()[:200]}")

    cmd_system = cmd_run

    def cmd_temp(self, args, lines):
        pass                     # reference: testing no-op

    def cmd_testrmt(self, args, lines):
        """TESTRMT: muffin-tin continuity check for LAPW fields
        (reference src/critic2.F90:505-512, wien/elk tolap): sample
        each atom's RMT sphere just inside and outside and report the
        maximum relative density jump."""
        from .ops.lebedev import lebedev

        sy = self.need_system()
        f = sy.ref
        if f.type not in ("wien", "elk"):
            raise CliError("TESTRMT needs a WIEN2k/elk reference field")
        c = sy.crystal
        mt = f.mt
        rmt_of = _host(mt.rmt_of)
        atpos = _host(getattr(mt, "atpos", c.x_cart))
        dirs, _ = lebedev(26)
        eps = 1e-4
        worst = 0.0
        for ia in range(len(rmt_of)):
            x0 = atpos[ia]
            pin = x0[None, :] + (rmt_of[ia] * (1 - eps)) * dirs
            pout = x0[None, :] + (rmt_of[ia] * (1 + eps)) * dirs
            vin = _host(f.grd(pin, nder=0).f)
            vout = _host(f.grd(pout, nder=0).f)
            rel = np.abs(vin - vout) / np.maximum(np.abs(vin), 1e-14)
            worst = max(worst, float(rel.max()))
        self.write(f"+ TESTRMT: max relative rho jump at RMT = "
                   f"{worst:.3e}")

    def cmd_bundleplot(self, args, lines):
        """BUNDLEPLOT x y z [DELTA d] [NPTS n] [FILE f.obj]: bundle of
        gradient paths from a small sphere around the point (reference
        bundleplot, src/bisect.f90)."""
        from .analysis.flux import fluxprint

        sy = self.need_system()
        x0 = np.asarray([float(v) for v in args[:3]])
        low = [a.lower() for a in args]
        delta = 0.1
        npts = 8
        file = None
        if "delta" in low:
            delta = float(args[low.index("delta") + 1])
        if "npts" in low:
            npts = int(args[low.index("npts") + 1])
        if "file" in low:
            file = args[low.index("file") + 1]
        from .ops.ode import trace_paths_recorded

        rng = np.random.default_rng(0)
        d = rng.standard_normal((npts, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        seeds = _host(sy.crystal.x2c(x0))[None, :] + delta * d
        scene = fluxprint(sy, seeds, iup=1, file=None)
        fn = sy.ref.eval_fn(nder=1)
        down, _, _ = trace_paths_recorded(
            fn, torch.as_tensor(seeds, dtype=torch.float64,
                                device=sy.device), nrec=300, iup=-1)
        for p in down:
            scene.path(p, color=(0.1, 0.4, 0.9))
        if file:
            scene.write(file)
        self.write(f"+ BUNDLEPLOT: {npts} up+down paths, delta={delta}"
                   + (f" -> {file}" if file else ""))

    def cmd_benchmark(self, args, lines):
        sy = self.need_system()
        n = int(args[0]) if args else 10000
        rng = np.random.default_rng(0)
        pts = rng.random((n, 3)) @ np.asarray(sy.crystal.m_x2c).T
        fn = sy.ref.eval_fn(nder=2)
        xT = torch.as_tensor(pts.T, device=sy.device)

        def sync():
            if sy.device.type == "cuda":
                torch.cuda.synchronize(sy.device)

        fn(xT)
        sync()
        t0 = time.perf_counter()
        fn(xT)
        sync()
        dt = time.perf_counter() - t0
        self.write(f"+ BENCHMARK: {n} evals in {dt:.4f} s "
                   f"({n / dt:.0f} evals/s)")

    # ------------------------------------------------------------------
    # grid reductions (reference SUM/MIN/MAX/MEAN/COUNT)
    # ------------------------------------------------------------------
    def _gridred(self, op, args):
        sy = self.need_system()
        fid = int(args[0]) if args else sy.iref
        f = sy.field(fid)
        if f.type != "grid":
            raise CliError(f"{op.upper()} needs a grid field")
        g = _host(f.grid.f)
        val = {"sum": g.sum, "min": g.min, "max": g.max, "mean": g.mean,
               "count": lambda: int((g > (float(args[1]) if len(args) > 1
                                          else 0.0)).sum())}[op]()
        self.write(f"+ {op.upper()}({fid}) = {val}")

    def cmd_sum(self, args, lines):
        self._gridred("sum", args)

    def cmd_min(self, args, lines):
        self._gridred("min", args)

    def cmd_max(self, args, lines):
        self._gridred("max", args)

    def cmd_mean(self, args, lines):
        self._gridred("mean", args)

    def cmd_count(self, args, lines):
        self._gridred("count", args)

    # ------------------------------------------------------------------
    def cmd_qtree(self, args, lines):
        from .analysis.qtree import qtree_integrate

        sy = self.need_system()
        low = [a.lower() for a in args]
        maxl = int(args[0]) if args and args[0].isdigit() else 3
        kw = {}
        if "keast" in low:
            kw["integ"] = "keast"
            nxt = low.index("keast") + 1
            if nxt < len(args) and args[nxt].isdigit():
                kw["keastnum"] = int(args[nxt])
        if "sphfactor" in low:
            kw["sphfactor"] = float(args[low.index("sphfactor") + 1])
        elif self.opts.get("sphfactor"):
            # standalone SPHFACTOR keyword set earlier (reference
            # qtree_setsphfactor, src/critic2.F90:406-410)
            kw["sphfactor"] = float(
                list(self.opts["sphfactor"].values())[0])
        # standalone settings keywords (reference setvariables):
        # CUB_ABS/CUB_REL/KEASTNUM/INTEG_MODE/WS_ORIGIN
        for opt, kwname in (("cub_abs", "cub_abs"), ("cub_rel", "cub_rel"),
                            ("keastnum", "keastnum"),
                            ("qtree_integ", "integ"),
                            ("qtree_minl", "minl"),
                            ("cub_mpts", "max_queue"),
                            ("qtree_origin", "origin_atom")):
            if opt in self.opts and kwname not in kw:
                kw[kwname] = self.opts[opt]
        res = qtree_integrate(sy, maxl=maxl, **kw)
        self.write(f"+ QTREE (maxl={maxl}): {res.ntraced} paths traced")
        self.write(res.table())

    def cmd_integrals(self, args, lines):
        """INTEGRALS [GAULEG nr | QAGS] [CP id] [RBETA r] [LEVEL n]
        (reference bisection INTEGRALS, src/bisect@proc.f90)."""
        from .analysis.bisect import basin_integral

        sy = self.need_system()
        low = [a.lower() for a in args]
        kw = {"radquad": self.opts["int_radquad"], "nr": self.opts["int_nr"],
              "abserr": self.opts["int_abserr"],
              "relerr": self.opts["int_relerr"]}
        icp = 0
        if "gauleg" in low:
            i = low.index("gauleg")
            if i + 1 < len(args) and args[i + 1].isdigit():
                kw["nr"] = int(args[i + 1])
        if "qags" in low:
            kw["radquad"] = "qags"
        if "cp" in low:
            icp = int(args[low.index("cp") + 1]) - 1
        if "rbeta" in low:
            kw["rbeta"] = float(args[low.index("rbeta") + 1])
        if "level" in low:
            kw["level"] = int(args[low.index("level") + 1])
        x0 = (self.cpl.cps[icp].x if self.cpl is not None
              else sy.crystal.x_frac[icp])
        q = basin_integral(sy, x0, **kw)
        self.write(f"+ INTEGRALS cp {icp + 1}: {q:.8f}")

    def cmd_sphereintegrals(self, args, lines):
        """SPHEREINTEGRALS [CP id] [R r] [LEBEDEV|GAULEG deg]."""
        from .analysis.bisect import sphere_integral

        sy = self.need_system()
        low = [a.lower() for a in args]
        icp = 0
        r = 1.0
        deg = 29
        if "cp" in low:
            icp = int(args[low.index("cp") + 1]) - 1
        if "r" in low:
            r = float(args[low.index("r") + 1])
        for k in ("lebedev", "gauleg"):
            if k in low and low.index(k) + 1 < len(args):
                deg = int(args[low.index(k) + 1])
        x0 = (self.cpl.cps[icp].x if self.cpl is not None
              else sy.crystal.x_frac[icp])
        q = sphere_integral(sy, x0, r, deg=deg)
        self.write(f"+ SPHEREINTEGRALS cp {icp + 1} r {r}: {q:.8f}")

    def cmd_hirshfeld(self, args, lines):
        from .analysis.hirshfeld import hirshfeld_charges

        res = hirshfeld_charges(self.need_system())
        self.write("* Hirshfeld atomic charges")
        self.write(res.table())

    def cmd_xdm(self, args, lines):
        from .analysis.xdm import xdm_grid, xdm_qe, xdm_wfn

        sy = self.need_system()
        if args and args[0].upper() == "QE":
            # XDM QE [BETWEEN i... AND j...] - coefficients from the QE
            # output the crystal was read from (reference xdm_qe,
            # src/xdm@proc.f90:751)
            between = and_ = path = None
            tail = list(args[1:])
            if tail and tail[0].upper() not in ("BETWEEN", "AND"):
                path = tail.pop(0)      # explicit pw.x output path
            rest = [a.upper() for a in tail]
            if "BETWEEN" in rest:
                bi = rest.index("BETWEEN")
                ai = rest.index("AND") if "AND" in rest else len(rest)
                between = [int(v) for v in rest[bi + 1:ai]]
                and_ = [int(v) for v in rest[ai + 1:]] if ai < len(rest) \
                    else None
            res = xdm_qe(sy, path=path, between=between, and_=and_)
        else:
            kw = {}
            if len(args) >= 2:
                try:
                    kw["a1"] = float(args[0])
                    kw["a2_ang"] = float(args[1])
                except ValueError:
                    pass
            # molecular wavefunction reference -> mesh variant
            # (reference xdm_wfn, src/xdm@proc.f90:1014)
            if sy.ref.type == "wfn":
                res = xdm_wfn(sy, **kw)
            else:
                res = xdm_grid(sy, **kw)
        self.write(f"+ XDM: Evdw = {res.energy:.10e} Ha")
        for nn, v in res.ehadd.items():
            self.write(f"  Evdw{nn} = {v:.10e} Ha")
        if res.volumes is not None:
            self.write("# i  V            Vfree        alpha        "
                       "C6(ii)")
            for q in range(len(res.volumes)):
                self.write(f"{q + 1:4d} {res.volumes[q]:12.6f} "
                           f"{res.vfree[q]:12.6f} {res.alpha[q]:12.6f} "
                           f"{res.c6[q, q]:12.6f}")

    def cmd_stm(self, args, lines):
        from .analysis.stm import stm

        sy = self.need_system()
        mode = "current"
        level = None
        if args and args[0].lower() in ("current", "height"):
            mode = args[0].lower()
            if len(args) > 1:
                level = float(args[1])
        res = stm(sy, mode=mode, level=level)
        self.write(f"+ STM {mode}: image {res.image.shape}, "
                   f"range [{res.image.min():.6e}, {res.image.max():.6e}]")

    def cmd_powder(self, args, lines):
        """POWDER [TH2INI t] [TH2END t] [LAMBDA l] [FPOL f] [SIGMA s]
        [NPTS n] [ROOT name] (reference struct_powder,
        src/struct_drivers@proc.f90; writes <root>_xrd.dat)."""
        from .analysis.struct import powder

        sy = self.need_system()
        low = [a.lower() for a in args]
        kw = {}
        for key, name, cast in (("th2ini", "th2ini", float),
                                ("th2end", "th2end", float),
                                ("lambda", "lambda_ang", float),
                                ("l", "lambda_ang", float),
                                ("fpol", "fpol", float),
                                ("sigma", "sigma", float),
                                ("npts", "npts", int)):
            if key in low:
                kw[name] = cast(args[low.index(key) + 1])
        root = args[low.index("root") + 1] if "root" in low \
            else self.fileroot
        pat = powder(sy.crystal, **kw)
        np.savetxt(f"{root}_xrd.dat", np.stack([pat.t, pat.ih], axis=1),
                   fmt="%15.7E", header="2theta intensity")
        self.write("# 2theta   intensity (top peaks)"
                   f"   [profile -> {root}_xrd.dat]")
        order = np.argsort(-pat.peaks_i)[:10]
        for idx in sorted(order, key=lambda t: pat.peaks_t[t]):
            h, k, l = pat.peaks_hkl[idx]
            self.write(f"{pat.peaks_t[idx]:9.4f} "
                       f"{100 * pat.peaks_i[idx] / pat.peaks_i.max():9.3f}"
                       f"   ({h} {k} {l})")

    def cmd_rdf(self, args, lines):
        """RDF [RINI r] [REND r] [SIGMA s] [NPTS n] [ROOT name]
        (reference struct_rdf; writes <root>_rdf.dat)."""
        from .analysis.struct import rdf

        sy = self.need_system()
        low = [a.lower() for a in args]
        kw = {}
        if args and args[0].replace(".", "").isdigit():
            kw["rend"] = float(args[0])
        for key, cast in (("rini", float), ("rend", float),
                          ("sigma", float), ("npts", int)):
            if key in low:
                kw[key] = cast(args[low.index(key) + 1])
        root = args[low.index("root") + 1] if "root" in low \
            else self.fileroot
        pat = rdf(sy.crystal, **kw, device=self.device)
        np.savetxt(f"{root}_rdf.dat", np.stack([pat.t, pat.ih], axis=1),
                   fmt="%15.7E", header="r(bohr) RDF")
        self.write(f"+ RDF: {len(pat.t)} points to "
                   f"{kw.get('rend', 25.0)} bohr, max {pat.ih.max():.4f}"
                   f" -> {root}_rdf.dat")

    def cmd_compare(self, args, lines):
        """COMPARE [POWDER|RDF|RMSD] [SIGMA s] [LAMBDA l] [TH2INI/END t]
        file1 file2 ... ('.' = the current structure; reference
        struct_compare, src/struct_drivers@proc.f90:1062-1311)."""
        from .analysis.struct import compare
        from .crystal.seed import read_structure

        method = None
        kw = {}
        files = []
        i = 0
        while i < len(args):
            a = args[i].lower()
            if a in ("powder", "rdf", "rmsd"):
                method = a
            elif a in ("sigma", "lambda", "th2ini", "th2end", "rend"):
                key = {"lambda": "lambda_ang"}.get(a, a)
                kw[key] = float(args[i + 1]); i += 1
            elif a == ".":
                files.append(None)
            else:
                files.append(args[i])
            i += 1
        crystals = [self.need_system().crystal if f is None
                    else read_structure(f) for f in files]
        if not any(f is None for f in files) and self.sy is not None \
                and len(crystals) < 2:
            crystals.insert(0, self.sy.crystal)
        if len(crystals) < 2:
            raise CliError("COMPARE needs at least two structures")
        d = compare(crystals, method=method, device=self.device, **kw)
        label = method or ("rmsd" if crystals[0].ismolecule else
                           "powdiff")
        self.write(f"+ COMPARE ({label.upper()}):")
        for row in d:
            self.write("  " + " ".join(f"{v:10.6f}" for v in row))

    def cmd_write(self, args, lines):
        """WRITE file.ext [ix iy iz] [BORDER] [MOLMOTIF] [ONEMOTIF]
        [CELL] [SPHERE r [x0 y0 z0]] [CUBE r [x0 y0 z0]] — molecular
        formats (xyz/gjf/cml) and 3d models (obj/ply/off) take the
        atom-selection options; everything else writes the unit cell
        (reference struct_write, src/struct_drivers@proc.f90:390-530)."""
        from .arithmetic import eval_const
        from .io.writers import write_structure

        sy = self.need_system()
        c = sy.crystal
        path = args[0]
        ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
        rest = args[1:]

        def num(i):
            return float(eval_const(rest[i], sy.vars))

        if ext in ("xyz", "gjf", "cml", "obj", "ply", "off") and rest:
            from .crystal.fragment import (listatoms_cells,
                                           listatoms_sphcub,
                                           list_molecules, Fragment)
            ix = [1, 1, 1]
            doborder = molmotif = onemotif = docell = False
            rsph = rcub = None
            x0 = np.zeros(3)
            i = 0
            while i < len(rest):
                w = rest[i].lower()
                if w == "border":
                    doborder = True
                elif w == "molmotif":
                    molmotif = True
                elif w == "onemotif":
                    onemotif = True
                elif w in ("cell", "molcell"):
                    docell = True
                elif w in ("sphere", "cube"):
                    r = num(i + 1)
                    i += 1
                    if i + 3 < len(rest):
                        try:
                            x0 = np.array([num(i + 1), num(i + 2),
                                           num(i + 3)])
                            i += 3
                        except Exception:
                            pass
                    r = r * self._unit_scale()
                    if c.ismolecule:
                        x0 = c.c2x(x0 * self._unit_scale()
                                   - np.asarray(c.molx0))
                    if w == "sphere":
                        rsph = r
                    else:
                        rcub = r
                else:
                    try:
                        ix = [int(rest[i]), int(rest[i + 1]),
                              int(rest[i + 2])]
                        i += 2
                    except (ValueError, IndexError):
                        raise CliError(f"unknown WRITE option: {rest[i]}")
                i += 1
            if rsph is not None or rcub is not None:
                fr = listatoms_sphcub(c, rsph=rsph, xsph=x0,
                                      rcub=rcub, xcub=x0)
            else:
                fr = listatoms_cells(c, ix, doborder)
            if onemotif:
                frags, _ = list_molecules(c)
                fr = Fragment.merge(frags)
            elif molmotif:
                from .crystal.fragment import complete_molmotif
                fr = complete_molmotif(c, fr)
            if ext in ("xyz", "gjf", "cml"):
                from .io.writers import write_mol_fragment
                write_mol_fragment(fr, path, fmt=ext)
            else:
                from .io.writers import write_3dmodel
                write_3dmodel(c, path, fmt=ext, ix=ix, docell=docell)
            self.write(f"+ WRITE ({fr.n} atoms) -> {path}")
            return
        write_structure(c, path)
        self.write(f"+ WRITE -> {path}")

    def cmd_ewald(self, args, lines):
        from .analysis.ewald import ewald_energy

        sy = self.need_system()
        q = None
        if sy.vars.get("__charges__") is not None:
            q = sy.vars["__charges__"]
        e = ewald_energy(sy.crystal, q, device=sy.device)
        self.write(f"+ EWALD energy = {e:.10f} Ha "
                   "(charges = Z unless Q set)")

    def cmd_environ(self, args, lines):
        """ENVIRON [DIST d] [POINT x y z | ATOM id] [BY spname]
        [SHELLS]: neighbor environments around atoms or a point
        (reference struct_environ, src/struct_drivers@proc.f90; shells
        group neighbors at the same distance and species)."""
        sy = self.need_system()
        c = sy.crystal
        low = [a.lower() for a in args]
        rmax = 10.0
        if args and args[0].replace(".", "").isdigit():
            rmax = float(args[0])
        if "dist" in low:
            rmax = float(args[low.index("dist") + 1])
        byname = args[low.index("by") + 1].capitalize() \
            if "by" in low else None
        shells = "shells" in low
        centers = []
        if "point" in low:
            i = low.index("point")
            x = np.asarray([float(v) for v in args[i + 1:i + 4]])
            if c.ismolecule:
                x = x * self._unit_scale() - np.asarray(c.molx0)
                x = c.c2x(x)
            centers = [("point", x)]
        elif "atom" in low:
            ia = int(args[low.index("atom") + 1]) - 1
            centers = [(f"atom {ia + 1} "
                        f"({c.species[c.species_of[ia]].name})",
                        np.asarray(c.x_frac[ia]))]
        else:
            reps = (np.asarray(c.spacegroup.irr_idx)
                    if not c.ismolecule and c.spacegroup.irr_idx
                    is not None else range(c.ncel))
            centers = [(f"atom {int(i) + 1} "
                        f"({c.species[c.species_of[int(i)]].name})",
                        np.asarray(c.x_frac[int(i)])) for i in reps]
        for label, x in centers:
            eid, dist, _ = c.list_near_atoms(x, up2d=rmax)
            self.write(f"+ ENVIRON {label}: {len(eid)} neighbors "
                       f"within {rmax:.4f} bohr")
            agg = {}
            for e, d in zip(eid, dist):
                if d < 1e-10:
                    continue
                nm = c.species[c.species_of[int(e)]].name
                if byname and nm != byname:
                    continue
                key = (round(float(d), 5), nm) if shells \
                    else (float(d), nm, len(agg))
                if key in agg:
                    agg[key][2] += 1
                else:
                    agg[key] = [float(d), nm, 1]
            groups = sorted(agg.values(), key=lambda g: (g[0], g[1]))
            if shells:
                self.write("#  shell   dist(bohr)  species  n")
                for q, (d, nm, n) in enumerate(groups[:30]):
                    self.write(f"  {q + 1:5d} {d:12.6f} {nm:>8s} {n:3d}")
            else:
                self.write("#     dist(bohr)  species")
                for d, nm, n in groups[:30]:
                    for _ in range(n):
                        self.write(f"   {d:12.6f} {nm:>8s}")

    def cmd_coord(self, args, lines):
        from .analysis.struct import coordination

        sy = self.need_system()
        coord = coordination(sy.crystal)
        for i, n in enumerate(coord):
            nm = sy.crystal.species[sy.crystal.species_of[i]].name
            self.write(f"  {i + 1:4d} {nm:>4s}  coordination {n}")

    def cmd_packing(self, args, lines):
        from .analysis.struct import packing_ratio

        self.write(f"+ PACKING ratio = "
                   f"{packing_ratio(self.need_system().crystal):.4f} %")

    def cmd_basinplot(self, args, lines):
        """BASINPLOT [CUBE|TRIANG|SPHERE lvl] [OBJ|PLY|OFF] [CP id]
        [x y z] (reference basinplot, src/bisect@proc.f90: defaults to
        every nonequivalent maximum; CP selects one; the level sets the
        sphere-triangulation subdivision)."""
        from .analysis.bisect import basinplot

        sy = self.need_system()
        low = [a.lower() for a in args]
        fmt = "obj"
        for f3 in ("obj", "ply", "off"):
            if f3 in low:
                fmt = f3
        level = 2
        for kwd in ("cube", "triang", "sphere"):
            if kwd in low:
                i = low.index(kwd)
                if i + 1 < len(args) and args[i + 1].isdigit():
                    level = int(args[i + 1])
        centers = []
        if "cp" in low:
            icp = int(args[low.index("cp") + 1]) - 1
            src = (self.cpl.cps[icp].x if self.cpl is not None
                   else sy.crystal.x_frac[icp])
            centers = [(icp + 1, np.asarray(src))]
        else:
            nums = [a for a in args if a.replace(".", "").replace(
                "-", "").isdigit()]
            if len(nums) >= 3 and "cube" not in low and \
                    "triang" not in low and "sphere" not in low:
                centers = [(1, np.asarray([float(v)
                                           for v in nums[:3]]))]
        if not centers:
            if self.cpl is not None:
                typnuc = sy.ref.typnuc
                centers = [(i + 1, cp.x) for i, cp in
                           enumerate(self.cpl.cps) if cp.typ == typnuc]
            else:
                centers = [(i + 1, x) for i, x in
                           enumerate(np.asarray(sy.crystal.x_frac))]
        for idx, x in centers:
            file = f"{self.fileroot}-cp{idx}.{fmt}"
            _, faces, r = basinplot(sy, x, level=level, file=file)
            self.write(f"+ BASINPLOT cp {idx}: {len(faces)} faces, r in"
                       f" [{r.min():.4f}, {r.max():.4f}] -> {file}")

    def cmd_fluxprint(self, args, lines):
        from .analysis.flux import fluxprint

        sy = self.need_system()
        x = np.array([[float(v) for v in args[:3]]])
        file = args[3] if len(args) > 3 else "flux.obj"
        fluxprint(sy, sy.crystal.x2c(x), file=file)
        self.write(f"+ FLUXPRINT -> {file}")

    def cmd_molcalc_expr(self, args, lines):
        return self.cmd_molcalc(args, lines)

    def cmd_pointprop(self, args, lines):
        """POINTPROP name|expr | CLEAR: named built-ins (GTF, VTF, HTF,
        *_KIR, GKIN, KKIN, LAG, ELF, VIR, HE, LOL, LOL_KIR, STRESS)
        register the chem function on the reference field (reference
        systemmod pointprop, src/systemmod@proc.f90:926-1063)."""
        sy = self.need_system()
        if args and args[0].lower() == "clear":
            sy.pointprops.clear()
            return
        named = {"gtf", "vtf", "htf", "gtf_kir", "vtf_kir", "htf_kir",
                 "gkin", "kkin", "lag", "elf", "vir", "he", "lol",
                 "lol_kir", "stress"}
        if len(args) == 1 and args[0].lower() in named:
            sy.pointprops.append(f"{args[0].lower()}()")
        else:
            sy.pointprops.append(" ".join(args))

    def cmd_integrable(self, args, lines):
        """INTEGRABLE fid|expr [F|FVAL|GMOD|LAP|LAPVAL] [NAME label]
        [MULTIPOLE|MULTIPOLES lmax] [DELOC ...] | CLEAR (reference
        systemmod propty parser, src/systemmod@proc.f90:771-924)."""
        sy = self.need_system()
        if args and args[0].lower() == "clear":
            sy.integrables.clear()
            if hasattr(sy, "deloc_requests"):
                sy.deloc_requests.clear()
            sy.multipole_lmax = None
            return
        low = [a.lower() for a in args]
        if "deloc" in low:
            fid = int(args[0]) if args[0].lstrip("-").isdigit() else args[0]
            req = {"fid": fid, "useu": "nou" not in low, "wancut": None}
            if "wancut" in low:
                req["wancut"] = float(args[low.index("wancut") + 1])
            if not hasattr(sy, "deloc_requests"):
                sy.deloc_requests = []
            sy.deloc_requests.append(req)
            return
        if "multipole" in low or "multipoles" in low:
            i = low.index("multipole" if "multipole" in low
                          else "multipoles")
            sy.multipole_lmax = int(args[i + 1]) if i + 1 < len(args) \
                else 4
            return
        # derivative selector on a field id -> expression with modifier
        selmap = {"f": "", "fval": ":v", "gmod": ":g", "lap": ":l",
                  "lapval": ":lv"}
        name = None
        if "name" in low:
            i = low.index("name")
            name = args[i + 1]
            args = args[:i] + args[i + 2:]
            low = low[:i] + low[i + 2:]
        if args and (args[0].lstrip("-").isdigit()
                     or args[0] in getattr(sy, "field_names", {})):
            mod = ""
            for a in low[1:]:
                if a in selmap:
                    mod = selmap[a]
            expr = f"${args[0]}{mod}"
        else:
            expr = " ".join(args)
        sy.integrables.append((expr, name) if name else expr)

    def cmd_list(self, args, lines):
        sy = self.need_system()
        for fid, f in sorted(sy.fields.items(), key=lambda kv: str(kv[0])):
            mark = "*" if fid == sy.iref else " "
            self.write(f" {mark} {fid}: {f.name} ({f.type})")

    def cmd_reset(self, args, lines):
        self.sy = None
        self.cpl = None

    def cmd_clear(self, args, lines):
        self.cmd_reset(args, lines)

    def cmd_echo(self, args, lines):
        self.write(" ".join(args))

    def cmd_end(self, args, lines):
        raise StopIteration

    def cmd_exit(self, args, lines):
        raise StopIteration


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    quiet = "-q" in argv
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a not in ("-q", "--cpu")]
    repl = Repl(quiet=quiet, device=device)
    if argv:
        text = open(argv[0]).read()
        # default output prefix = input basename (reference fileroot,
        # src/critic2.F90:412-417); ROOT overrides
        repl.fileroot = os.path.splitext(argv[0])[0]
    else:
        text = sys.stdin.read()
    try:
        repl.run_script(text)
    except StopIteration:
        pass
    if not quiet:
        repl.write(f"CRITIC2-TPU ended ({repl.nwarns} warnings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
