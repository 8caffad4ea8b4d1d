"""MOLCALC: expression integrals over molecular meshes.

Role of the reference molcalc (src/molcalc@proc.F90:30-110): integrate an
arithmetic expression over the Becke mesh of the current molecule; NELEC
integrates the reference density; PEACH computes the Peach-Helgaker-
Tozer excitation overlap; HF the Hartree-Fock total energy.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from .mesh import becke_mesh

__all__ = ["molcalc_integral", "molcalc_nelec", "molcalc_peach",
           "molcalc_hf"]


def molcalc_integral(system, expr: str, lvl: str = "good",
                     block: int = 1 << 17,
                     weights_dtype=np.float32) -> float:
    """Integral of `expr` over the Becke mesh of the system's molecule,
    on the system's device (cuda unless the system was built for
    another).

    weights_dtype selects the Becke partition-weight precision; the f32
    default is the fast-build route (the per-point f32 relative weight
    error, ~1e-7 with random sign, cancels in quadrature). Pass
    np.float64 for reference-exact weights.

    A bare `$field` reference to a plain molecular wavefunction takes
    the direct value-only route (reference fillmesh density integral,
    src/meshmod@proc.f90:407): an all-f64 nder=0 density sweep, summed
    against the weights in f64 on the device."""
    dev = resolve_device(system.device)
    m = becke_mesh(system.crystal, lvl, weights_dtype=weights_dtype,
                   device=dev)
    w = torch.as_tensor(np.asarray(m.w, np.float64), dtype=FDTYPE,
                        device=dev)
    bare = re.fullmatch(r"\$(\w+)", expr.strip())
    f = None
    if bare is not None:
        try:
            f = system.field(bare.group(1))
        except (KeyError, ValueError):
            f = None
    if f is not None and f.type == "wfn" and f.coreenv is None:
        rho = f.wfn.rho_eval_soa(m.x.T, nder=0, device=f.device)[0]
        return float(w @ rho.to(dev))
    from ..arithmetic import compile_expr

    fn = compile_expr(expr, system, periodic=False)
    acc = torch.zeros((), dtype=FDTYPE, device=dev)
    for lo in range(0, m.n, block):
        xT = torch.as_tensor(np.ascontiguousarray(m.x[lo:lo + block].T),
                             dtype=FDTYPE, device=dev)
        acc = acc + w[lo:lo + xT.shape[1]] @ fn(xT)
    return float(acc)


def molcalc_nelec(system, lvl: str = "good") -> float:
    """Integrated number of electrons of the reference field."""
    ref = system.iref if system.iref is not None else 0
    return molcalc_integral(system, f"${ref}", lvl=lvl)


def molcalc_peach(system, transitions, lvl: str = "good",
                  block: int = 1 << 14) -> float:
    """PEACH excitation overlap Lambda (Peach et al., JCP 128 (2008)
    044118; reference molcalc_peach, src/molcalc@proc.F90:105-...):
    Lambda = sum_t k_t^2 O_t / sum_t k_t^2 with
    O_t = integral |phi_i| |phi_a| over the Becke mesh.

    transitions: iterable of (imo1, imo2, k) with 1-based MO indices."""
    dev = resolve_device(system.device)
    f = system.ref
    if f.type != "wfn":
        raise ValueError("PEACH needs a molecular wavefunction "
                         "reference field")
    m = becke_mesh(system.crystal, lvl, device=dev)
    trans = [(int(i), int(a), float(k)) for i, a, k in transitions]
    if not trans:
        raise ValueError("no MO transitions given")
    oia = np.zeros(len(trans))
    for lo in range(0, m.n, block):
        pts = m.x[lo:lo + block]
        mo = f.wfn.mo_values(pts, device=f.device).abs()     # (M, B)
        w = torch.as_tensor(m.w[lo:lo + pts.shape[0]], dtype=FDTYPE,
                            device=mo.device)
        for t, (i, a, k) in enumerate(trans):
            oia[t] += float((mo[i - 1] * mo[a - 1] * w).sum())
    k2 = np.array([k * k for _, _, k in trans])
    return float((k2 * oia).sum() / k2.sum())


def molcalc_hf(system, block: int = 96) -> dict:
    """Hartree-Fock total energy of the reference wavefunction
    (reference molcalc_hfenergy via libCINT,
    src/molcalc@proc.F90:238-404; here via ops/mdint McMurchie-Davidson
    integrals), computed on the system's device."""
    from ..ops.mdint import rhf_energy

    f = system.ref
    if f.type != "wfn":
        raise ValueError("MOLCALC HF needs a wavefunction reference field")
    return rhf_energy(f.wfn, block=block,
                      device=resolve_device(system.device))
