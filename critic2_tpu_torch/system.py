"""The System: one crystal + scalar fields.

Role of the reference systemmod (src/systemmod.f90): hold a Crystal and a
set of loaded fields, track the reference field, and evaluate
expressions over the fields. All fields of a system live on one device,
chosen when the system is built.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from .config import resolve_device


@dataclass
class System:
    crystal: object = None
    fields: dict = dfield(default_factory=dict)   # id (int|str) -> Field
    iref: int | None = None                        # reference field id
    aliases: dict = dfield(default_factory=dict)
    vars: dict = dfield(default_factory=dict)      # expression variables
    pointprops: list = dfield(default_factory=list)
    integrables: list = dfield(default_factory=list)
    device: torch.device = None
    zpsp: dict = dfield(default_factory=dict)     # system-level ZPSP

    @classmethod
    def from_structure(cls, path_or_crystal, *, device=None, **kw):
        """System around a Crystal or a structure file (any format of
        crystal/seed.read_structure, which takes `kw`; a molecule of a
        wavefunction file - .wfn, .wfx, .fchk/.fch/.fck, .molden - takes
        `border=`, the bohr of vacuum around it), with the promolecular
        density loaded as field 0. Runs on cuda unless `device` says
        otherwise. Load a grid or the wavefunction itself with
        load_field(path)."""
        from .crystal.crystal import Crystal
        from .crystal.seed import (is_wfn_path, read_structure,
                                   read_wfn_structure)
        from .fields.field import Field

        if isinstance(path_or_crystal, Crystal):
            c = path_or_crystal
        elif is_wfn_path(path_or_crystal):
            kw.pop("mol", None)
            c = read_wfn_structure(path_or_crystal, **kw).to_crystal()
        else:
            c = read_structure(path_or_crystal, **kw)
        s = cls(crystal=c, device=resolve_device(device))
        s.fields[0] = Field.promolecular(c, name="rho0", device=s.device)
        return s

    @classmethod
    def from_wavefunction(cls, wfn, border: float = 10.0, name: str = "",
                          *, device=None):
        """System around an in-memory Wavefunction (no file): embeds the
        molecule in a border-padded cell (reference molx0/molborder
        semantics) and loads the wfn as field 1, the reference. Species
        are ordered by atomic number."""
        from . import param
        from .crystal.crystal import Species
        from .crystal.seed import CrystalSeed
        from .fields.field import Field

        zs = np.asarray(wfn.atz, dtype=int)
        uniq = sorted(set(int(z) for z in zs))
        spmap = {z: i for i, z in enumerate(uniq)}
        seed = CrystalSeed(
            x_frac=np.asarray(wfn.atpos, float),    # cartesian for mols
            species_of=np.array([spmap[int(z)] for z in zs]),
            species=[Species(param.ELEMENTS[z] if z < len(param.ELEMENTS)
                             else f"Z{z}", z) for z in uniq],
            ismolecule=True, border=border, name=name or wfn.source)
        c = seed.to_crystal()
        s = cls.from_structure(c, device=device)
        s.load_field(Field.from_wavefunction(c, wfn, name=name or "wfn",
                                             device=s.device))
        s.iref = 1
        return s

    def load_field(self, source, fid=None, name=None, **kw):
        """Load a field from a file path (cube) or an existing Field."""
        from .fields.field import Field

        if fid is None:
            fid = max([k for k in self.fields if isinstance(k, int)],
                      default=0) + 1
        if isinstance(source, Field):
            f = source
        else:
            f = Field.from_file(self.crystal, source, device=self.device,
                                **kw)
        if name:
            f.name = name
            self.aliases[name] = fid
        self.fields[fid] = f
        if self.iref is None or self.iref == 0:
            self.iref = fid
        return fid

    @property
    def ref(self):
        """The reference field (field 0 if nothing else is loaded)."""
        return self.fields[self.iref if self.iref is not None else 0]

    def resolve_fid(self, fid):
        """Resolve a field reference: int id, alias name, or numeric str."""
        if isinstance(fid, str):
            if fid in self.aliases:
                return self.aliases[fid]
            if fid.isdigit():
                return int(fid)
            raise KeyError(f"unknown field {fid!r}")
        return fid

    def field(self, fid):
        return self.fields[self.resolve_fid(fid)]

    def set_reference(self, fid):
        self.iref = self.resolve_fid(fid)

    def unload_field(self, fid):
        fid = self.resolve_fid(fid)
        del self.fields[fid]
        self.aliases = {k: v for k, v in self.aliases.items() if v != fid}
        if self.iref == fid:
            self.iref = max((k for k in self.fields if isinstance(k, int)
                             and k != 0), default=None)

    # ------------------------------------------------------------------
    # expressions (reference systemmod eval, src/systemmod.f90:196)
    # ------------------------------------------------------------------
    def eval_expr(self, expr: str, points_cart):
        """An expression at Cartesian points (N, 3): (N,) f64 tensor on
        the system's device."""
        from .arithmetic import eval_expr

        return eval_expr(expr, self, points_cart)

    def load_field_expr(self, expr: str, fid=None, name=None,
                        shape=None, ghost: bool = False):
        """LOAD AS "expr": rasterize on a grid (default: reference grid
        size or `shape`), or keep as a ghost field when ghost=True
        (reference ifformat_as / ifformat_ghost, src/param.F90:132-165).
        The nodes are built and evaluated on the system's device, 65,536
        a call."""
        from .analysis.integration import _grid_points
        from .arithmetic import compile_expr
        from .config import FDTYPE, resolve_device
        from .fields.field import Field
        from .fields.grid3 import Grid3

        dev = resolve_device(self.device)
        if ghost:
            f = Field.ghost(self.crystal, compile_expr(expr, self),
                            name=name or expr, device=dev)
            return self.load_field(f, fid=fid, name=name)
        if shape is None:
            ref = self.fields.get(self.iref) if self.iref else None
            shape = tuple(ref.grid.n) if (ref is not None and
                                          ref.type == "grid") else (64, 64, 64)
        shape = tuple(int(v) for v in shape)
        fn = compile_expr(expr, self)
        N = int(np.prod(shape))
        out = torch.empty(N, dtype=FDTYPE, device=dev)
        block = 1 << 16
        for lo in range(0, N, block):
            hi = min(N, lo + block)
            out[lo:hi] = fn(_grid_points(self.crystal, shape, lo, hi,
                                         FDTYPE, dev))
        f = Field.from_grid(self.crystal, Grid3(out.reshape(shape)),
                            name=name or expr)
        return self.load_field(f, fid=fid, name=name)

    def identify_fragment_from_xyz(self, path: str):
        """Atom indices (0-based, cell list) matching the positions in an
        xyz file (angstrom cartesian; reference
        identify_fragment_from_xyz, src/fragmentmod@proc.f90)."""
        from . import param

        idx = []
        with open(path) as fh:
            nat = int(fh.readline().split()[0])
            fh.readline()
            for _ in range(nat):
                t = fh.readline().split()
                xc = np.array([float(v) for v in t[1:4]]) \
                    * param.ANGSTROM_TO_BOHR
                i, _ = self.crystal.identify_atom(
                    xc, icrd=param.ICRD_CART, distmax=1e-2)
                if i < 0:
                    raise ValueError(f"fragment atom not in crystal: {t}")
                idx.append(int(i))
        return np.asarray(idx, dtype=int)

    def load_field_as(self, kind: str, src=None, src2=None, fid=None,
                      name=None, shape=None, isry: bool = False,
                      fragment=None):
        """Computed-field LOADs (reference ifformat_as_* formats,
        src/param.F90:132-165; load_as_fftgrid
        src/fieldmod@proc.f90:560-612), built on the system's device:

        kind: 'lap' | 'grad' | 'pot' | 'hxx1' | 'hxx2' | 'hxx3' (FFT
        grids of grid field `src`), 'clm add' | 'clm sub' (grid sum /
        difference of fields src, src2), 'core' (promolecular core
        density grid using the system zpsp), 'promolecular' (promolecular
        density grid, optionally of a fragment given as cell-atom
        indices or as an xyz file), 'copy' (duplicate of field src)."""
        import copy

        from .fields.field import Field
        from .fields.grid3 import Grid3

        kind = kind.lower()
        m = self.crystal.m_x2c

        def grid_of(fidx):
            f = self.field(fidx)
            if f.type != "grid":
                raise ValueError(f"LOAD AS {kind.upper()} needs a grid field")
            return f.grid

        if kind in ("lap", "grad", "pot", "hxx1", "hxx2", "hxx3"):
            g = grid_of(src)
            if kind == "lap":
                out = g.laplacian(m)
            elif kind == "grad":
                out = g.gradrho(m)
            elif kind == "pot":
                out = g.pot(m, isry=isry)
            else:
                out = g.hxx(m, int(kind[3]) - 1)
            f = Field.from_grid(self.crystal, out,
                                name=name or f"<{kind}:{src}>")
        elif kind in ("clm add", "clm sub"):
            g1, g2 = grid_of(src), grid_of(src2)
            if tuple(g1.n) != tuple(g2.n):
                raise ValueError("CLM fields have different grid sizes")
            sign = 1.0 if kind.endswith("add") else -1.0
            f = Field.from_grid(self.crystal, Grid3(g1.f + sign * g2.f),
                                name=name or f"<{kind}:{src},{src2}>")
        elif kind == "core":
            if not self.zpsp:
                raise ValueError("LOAD AS CORE requires ZPSP settings")
            f = self._promolecular_grid_field(shape, zpsp=self.zpsp,
                                              name=name or "<core>")
        elif kind == "promolecular":
            frag = None
            if fragment is not None:
                frag = self.identify_fragment_from_xyz(fragment) \
                    if isinstance(fragment, str) else np.asarray(fragment)
            f = self._promolecular_grid_field(
                shape, fragment=frag, name=name or "<promolecular>")
        elif kind == "copy":
            f = copy.copy(self.field(src))
            f.name = name or f"<copy:{src}>"
        else:
            raise ValueError(f"unknown LOAD AS kind {kind}")
        return self.load_field(f, fid=fid, name=name)

    def load_field_pi(self, ion_files: dict, fid=None, name=None):
        """aiPI field from {species name or index: .ion file}
        (reference LOAD PI, src/fieldseedmod@proc.f90:86-87,240-255), on
        the system's device."""
        from .fields.field import Field
        from .fields.pi import PiField

        pf = PiField.from_files(self.crystal, ion_files, device=self.device)
        f = Field(crystal=self.crystal, type="pi", pi=pf,
                  name=name or "<pi>")
        return self.load_field(f, fid=fid, name=name)

    def _promolecular_grid_field(self, shape, zpsp=None, fragment=None,
                                 name=""):
        from .analysis.integration import _rasterize_env
        from .fields.field import Field
        from .fields.grid3 import Grid3
        from .fields.promol import PromolEnv

        if shape is None:
            ref = self.fields.get(self.iref) if self.iref is not None else None
            shape = tuple(ref.grid.n) if (ref is not None and
                                          ref.type == "grid") else (64, 64, 64)
        env = PromolEnv(self.crystal, zpsp=zpsp, fragment=fragment,
                        device=self.device)
        return Field.from_grid(
            self.crystal, Grid3(_rasterize_env(self.crystal, env, shape)),
            name=name)
