"""Scalar field: a crystal plus one evaluation backend.

Role of the reference fieldmod (src/fieldmod.f90). The port carries the
grid and promolecular types; ``eval_fn`` is the batched SoA evaluator
that rasterization uses. Per batch (mirrors the reference):
  1. Cartesian -> fractional, wrap to the main cell (periodic)
  2. backend evaluation (device)
  3. optional core augmentation (promolecular core tables, zpsp)
  4. nucleus clamp: zero the gradient on nuclei
The other field types (wfn, wien, elk, pi, dftb, ghost) are not ported
yet and raise NotImplementedError; grid interpolation is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from .grid3 import Grid3, detect_grid_format
from .promol import PromolEnv, promolecular_soa


def linmap(A, v):
    """Apply a small host-constant matrix A (m, k) to batched rows v (k, ...)
    as unrolled scalar multiply-adds, skipping zero entries."""
    A = np.asarray(A)
    rows = []
    for i in range(A.shape[0]):
        acc = None
        for j in range(A.shape[1]):
            a = float(A[i, j])
            if a == 0.0:
                continue
            term = a * v[j]
            acc = term if acc is None else acc + term
        rows.append(acc if acc is not None else torch.zeros_like(v[0]))
    return torch.stack(rows)


@dataclass
class Field:
    crystal: object
    type: str       # 'grid' | 'promol'
    grid: Grid3 | None = None
    promol: PromolEnv | None = None
    name: str = ""
    usecore: bool = False
    zpsp: dict = dfield(default_factory=dict)
    _coreenv: PromolEnv | None = None
    _evalfns: dict = dfield(default_factory=dict)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def promolecular(cls, crystal, name="rho0", fragment=None,
                     device=None) -> "Field":
        return cls(crystal=crystal, type="promol",
                   promol=PromolEnv(crystal, fragment=fragment,
                                    device=device), name=name)

    @classmethod
    def from_grid(cls, crystal, grid: Grid3, name="", **kw) -> "Field":
        return cls(crystal=crystal, type="grid", grid=grid, name=name, **kw)

    @classmethod
    def from_file(cls, crystal, path: str, fmt: str | None = None,
                  name: str = "", device=None, **kw) -> "Field":
        if fmt is None:
            try:
                fmt = detect_grid_format(path)
            except ValueError:
                fmt = None
        if fmt != "cube":
            raise NotImplementedError(
                f"field format {fmt or path} is not ported to the torch "
                "package yet (cube only)")
        g = Grid3.from_file(path, fmt=fmt, device=device)
        return cls.from_grid(crystal, g, name=name or path, **kw)

    @property
    def device(self) -> torch.device:
        return self.grid.f.device if self.type == "grid" \
            else self.promol.device

    # ------------------------------------------------------------------
    def set_options(self, core: bool | None = None,
                    zpsp: dict | None = None):
        if zpsp is not None:
            self.zpsp = dict(zpsp)
        if core is not None:
            self.usecore = core
        self._evalfns.clear()
        self._coreenv = None
        return self

    @property
    def coreenv(self) -> PromolEnv | None:
        if not (self.usecore and self.zpsp):
            return None
        if self._coreenv is None:
            self._coreenv = PromolEnv(self.crystal, zpsp=self.zpsp,
                                      device=self.device)
        return self._coreenv

    # ------------------------------------------------------------------
    def eval_fn(self, nder: int = 2, clamp_nuclei: bool = True):
        """SoA closure xT (3, N) cart -> (f (N,), gf (3, N), h6 (6, N)),
        cached per (nder, clamp_nuclei)."""
        key = (nder, clamp_nuclei)
        if key not in self._evalfns:
            self._evalfns[key] = self._build_eval_fn(nder, clamp_nuclei)
        return self._evalfns[key]

    def _build_eval_fn(self, nder: int, clamp_nuclei: bool):
        if self.type != "promol":
            raise NotImplementedError(
                f"eval_fn for {self.type} fields is not ported to the torch "
                "package yet")
        c = self.crystal
        m_c2x = np.asarray(c.m_c2x)
        m_x2c = np.asarray(c.m_x2c)
        promol = self.promol
        env = self.coreenv
        dev, dt = promol.atpos.device, promol.atpos.dtype

        imgsT = None
        if clamp_nuclei and c.ncel > 0:
            at = np.asarray(c.x_cart)
            if not c.ismolecule:
                shifts = np.array(
                    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=float)
                at = (at[None, :, :] + (shifts @ m_x2c.T)[:, None, :]
                      ).reshape(-1, 3)
            imgsT = torch.as_tensor(at.T, dtype=dt, device=dev)

        def fn(xT):
            wx = linmap(m_c2x, xT)
            wx = wx - torch.floor(wx)
            wc = linmap(m_x2c, wx)
            f, gf, h6 = promolecular_soa(wc, promol.atpos, promol.atspc,
                                         promol.tab, nder=nder)
            if env is not None:
                cf, cg, ch6 = promolecular_soa(wc, env.atpos, env.atspc,
                                               env.tab, nder=nder)
                f, gf, h6 = f + cf, gf + cg, h6 + ch6
            if imgsT is not None and nder >= 1:
                d2 = ((wc[:, :, None] - imgsT[:, None, :]) ** 2).sum(0)
                isnuc = d2.min(dim=1).values < 1e-10
                gf = torch.where(isnuc[None, :], torch.zeros_like(gf), gf)
            return f, gf, h6

        return fn
