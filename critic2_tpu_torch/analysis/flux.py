"""FLUXPRINT: 3D gradient-path plotting, and CPREPORT scene output.

Role of the reference flux (src/flux@proc.f90:59-135) and the CPREPORT
file writers (src/autocp@proc.f90:787-957): emit ball-and-stick scenes of
the structure, the CP list, and gradient paths to obj/ply/off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..io.graphics import Scene
from ..ops.ode import trace_paths_recorded

__all__ = ["fluxprint", "cpreport_scene", "write_cml"]

_CPCOLOR = {-3: (0.2, 0.7, 0.2), -1: (0.9, 0.1, 0.1),
            1: (0.9, 0.9, 0.1), 3: (0.2, 0.2, 0.9)}


def _add_structure(scene, crystal, ballsize=0.5):
    from .. import param

    cart = np.asarray(crystal.x_cart)
    zs = crystal.zatoms
    for r, z in zip(cart, zs):
        rad = max(0.3, 0.6 * param.covalent_radius(int(z)))
        grey = 0.3 + 0.5 * (z % 5) / 5.0
        scene.ball(r, r=rad, color=(grey, 0.4, 1.0 - grey))
    for i, j, lvec in crystal.bonds():
        p0 = cart[i]
        p1 = crystal.x2c(crystal.x_frac[j] + lvec)
        scene.stick(p0, p1)


def cpreport_scene(system, cpl, file: str, graph: bool = True,
                   cpballsize: float = 0.25):
    """Write the CP list (+ structure, + bond paths) as a 3D scene."""
    resolve_device(system.device)
    scene = Scene()
    c = system.crystal
    _add_structure(scene, c)
    for cp in cpl.cps:
        if cp.isnuc:
            continue
        scene.ball(cp.r, r=cpballsize, color=_CPCOLOR[cp.typ])
    if graph:
        bcps = [cp for cp in cpl.cps if cp.typ == -1]
        if bcps:
            f = system.ref
            fn = f.eval_fn(nder=1)
            for cp in bcps:
                if cp.brvec is None:
                    continue
                seeds = np.stack([cp.r + 0.01 * cp.brvec,
                                  cp.r - 0.01 * cp.brvec])
                paths, _, _ = trace_paths_recorded(
                    fn, torch.as_tensor(seeds, dtype=FDTYPE,
                                        device=f.device), nrec=200, iup=1)
                for p in paths:
                    scene.path(p)
    scene.write(file)
    return scene


def write_cml(system, path_points, file):
    """CML path writer (reference flux cml output,
    src/flux@proc.f90:683-691, 799-812): the structure's atoms plus the
    gradient-path points as Xz pseudo-atoms; fractional coordinates for
    crystals, Angstrom x3/y3/z3 for molecules."""
    from .. import param

    c = system.crystal
    lines = ['<molecule>', ' <atomArray>']
    zs = np.asarray(c.zatoms)
    sym = [c.species[s].name for s in np.asarray(c.species_of)]
    for i in range(c.ncel):
        if c.ismolecule:
            x = (np.asarray(c.x_cart[i])
                 + (np.asarray(c.molx0) if c.molx0 is not None else 0.0)) \
                * param.BOHR_TO_ANGSTROM
            lines.append(f'  <atom id="s{i + 1}" elementType="{sym[i]}" '
                         f'x3="{x[0]:.10f}" y3="{x[1]:.10f}" '
                         f'z3="{x[2]:.10f}"/>')
        else:
            x = np.asarray(c.x_frac[i])
            lines.append(f'  <atom id="s{i + 1}" elementType="{sym[i]}" '
                         f'xFract="{x[0]:.10f}" yFract="{x[1]:.10f}" '
                         f'zFract="{x[2]:.10f}"/>')
    k = 0
    for pts in path_points:
        for x in np.atleast_2d(pts):
            k += 1
            if c.ismolecule:
                xm = (x + (np.asarray(c.molx0) if c.molx0 is not None
                           else 0.0)) * param.BOHR_TO_ANGSTROM
                lines.append(f'  <atom id="a{k}" elementType="Xz" '
                             f'x3="{xm[0]:.10f}" y3="{xm[1]:.10f}" '
                             f'z3="{xm[2]:.10f}"/>')
            else:
                xf = np.asarray(c.c2x(x))
                lines.append(f'  <atom id="a{k}" elementType="Xz" '
                             f'xFract="{xf[0]:.10f}" '
                             f'yFract="{xf[1]:.10f}" '
                             f'zFract="{xf[2]:.10f}"/>')
    lines += [' </atomArray>', '</molecule>', '']
    with open(file, 'w') as fh:
        fh.write('\n'.join(lines))


def _nucleus_targets(c):
    """Nuclei (and their periodic images for crystals) as trace
    termination targets: uphill gradient paths end at nuclei (reference
    gradient termination, src/fieldmod@proc.f90:2194-2210), and early
    capture also spares the recorded tracer its full step budget."""
    at = np.asarray(c.x_cart)
    if c.ismolecule or c.ncel == 0:
        return at
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], dtype=float)
    return ((at[None, :, :]
             + (shifts @ np.asarray(c.m_x2c).T)[:, None, :])
            .reshape(-1, 3))


def fluxprint(system, seeds_cart, iup: int = 1, file: str | None = None,
              nrec: int = 300, structure: bool = True) -> Scene:
    """Trace and plot gradient paths from Cartesian seed points
    (reference fluxprint, src/flux@proc.f90:59). Output format follows
    the file extension: obj/ply/off scenes or cml."""
    resolve_device(system.device)
    scene = Scene()
    if structure:
        _add_structure(scene, system.crystal)
    f = system.ref
    fn = f.eval_fn(nder=1)
    c = system.crystal
    tgt = _nucleus_targets(c) if iup > 0 else None
    if tgt is not None and len(tgt) == 0:
        tgt = None
    rt = np.full(len(tgt), 0.2) if tgt is not None else None
    # downhill molecular paths terminate on leaving the molecular cell
    # (reference gradient termination, src/fieldmod@proc.f90:2158-2175)
    # - without this every path burns the full nrec budget wandering
    # the exponential tail
    mol = c.ismolecule and iup < 0
    paths, _, _ = trace_paths_recorded(
        fn, torch.as_tensor(np.atleast_2d(seeds_cart), dtype=FDTYPE,
                            device=f.device), nrec=nrec, iup=iup,
        targets=tgt, rterm=rt,
        m_c2x=c.m_c2x if mol else None,
        molborder=c.molborder if mol else None)
    scene.pathpts = paths        # raw trajectories for programmatic use
    for p in paths:
        scene.path(p, color=(0.9, 0.4, 0.1) if iup > 0 else (0.1, 0.4, 0.9))
    if file:
        if file.lower().endswith(".cml"):
            write_cml(system, paths, file)
        else:
            scene.write(file)
    return scene
