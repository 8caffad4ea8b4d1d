"""AUTO: automatic critical-point search.

Role of the reference autocp (src/autocp@proc.f90 `autocritic`): generate
seeds (WS-cell barycentric subdivision, atom pairs/triplets, lines,
spheres, octahedron subdivision, single points), run a Newton search from
every seed, deduplicate into the CP list with classification, and check
the Poincare-Hopf sum.

Decomposition: seed generation and CP bookkeeping are host NumPy; the
Newton searches run as ONE device batch over all seeds (ops/newton.py)
instead of the reference's OpenMP loop over sequential scalar searches
(src/autocp@proc.f90:690-723).

Dedup is symmetry-aware: a candidate is rejected if any image of its
space-group orbit matches an existing CP, and its multiplicity is the
orbit size (reference addcp/symeqv, src/fieldmod@proc.f90:1876-2016).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from itertools import permutations

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops.eig3 import rsindex
from ..ops.newton import newton_batch

__all__ = ["Seed", "CP", "CPList", "autocp", "seed_ws", "gen_seeds",
           "init_cplist", "makegraph", "cell_cp_list", "cp_long_report",
           "cp_vlong_report", "critshell"]


@dataclass
class Seed:
    """One seeding strategy (reference seed_, src/autocp@proc.f90:78-90)."""

    typ: str = "ws"            # ws|pair|triplet|line|sphere|oh|point
    depth: int = 1
    x0: np.ndarray = dfield(default_factory=lambda: np.zeros(3))  # cryst
    x1: np.ndarray = dfield(default_factory=lambda: np.zeros(3))
    rad: float = -1.0
    dist: float = 15.0
    npts: int = 1
    nr: int = 0
    ntheta: int = 0
    nphi: int = 0


@dataclass
class CP:
    x: np.ndarray               # fractional position
    r: np.ndarray               # Cartesian position
    typ: int                    # signature: -3 ncp, -1 bcp, +1 rcp, +3 ccp
    f: float
    gfmod: float
    del2f: float
    eig: np.ndarray             # Hessian eigenvalues (ascending)
    isnuc: bool = False
    mult: int = 1
    name: str = ""
    ipath: list = None          # graph: connected CP ids per direction
    brpathlen: list = None      # bond/ring path lengths
    brvec: np.ndarray = None    # path take-off eigenvector

    @property
    def typind(self) -> int:
        return (self.typ + 3) // 2


@dataclass
class CPList:
    crystal: object
    cps: list = dfield(default_factory=list)

    def counts(self):
        """(n, b, r, c) counts over the cell list (with multiplicities)."""
        out = [0, 0, 0, 0]
        for cp in self.cps:
            out[cp.typind] += cp.mult
        return tuple(out)

    def poincare_hopf(self) -> int:
        n, b, r, c = self.counts()
        return n - b + r - c

    def nearest(self, xfrac):
        """(index, distance) of the nearest CP to fractional point xfrac."""
        if not self.cps:
            return -1, np.inf
        d = self.crystal.distance(
            np.repeat(np.atleast_2d(xfrac), len(self.cps), axis=0),
            np.stack([cp.x for cp in self.cps]),
        )
        i = int(np.argmin(d))
        return i, float(d[i])


# ---------------------------------------------------------------------------
# seed generation (host)
# ---------------------------------------------------------------------------
def _barycentric_subdivide(verts: np.ndarray, depth: int, out: list):
    """Emit the barycenter of this simplex and recursively of all its
    barycentric children (reference barycentric_divide,
    src/autocp@proc.f90:1352-1530: each k-simplex splits into k!
    flag-chain children p_m = mean(v_sigma(1..m)))."""
    out.append(verts.mean(axis=0))
    if depth == 0:
        return
    k = len(verts)
    if k == 1:
        return
    for sigma in permutations(range(k)):
        child = np.stack(
            [verts[list(sigma[: m + 1])].mean(axis=0) for m in range(k)]
        )
        _barycentric_subdivide(child, depth - 1, out)


def seed_ws(crystal, x0=(0.0, 0.0, 0.0), depth: int = 1, rad: float = -1.0):
    """Cached wrapper: the WS subdivision depends only on the crystal
    geometry, not the field - repeated AUTO runs (e.g. per-field) reuse
    the host-side seed generation (~0.4 s at depth 2)."""
    key = (tuple(np.round(np.asarray(x0, float), 12)), depth, rad)
    cache = getattr(crystal, "_ws_seed_cache", None)
    if cache is None:
        cache = crystal._ws_seed_cache = {}
    if key not in cache:
        cache[key] = _seed_ws_impl(crystal, x0, depth, rad)
    return cache[key]


def _seed_ws_impl(crystal, x0=(0.0, 0.0, 0.0), depth: int = 1,
                  rad: float = -1.0):
    """Seeds from recursive barycentric subdivision of the WS cell
    (reference styp_ws, src/autocp@proc.f90:356-369 + getiws,
    src/crystalmod@proc.f90): tetrahedra (origin, face center, vertex,
    edge midpoint), each subdivided; seeds at the barycenters of every
    element (vertices, edges, faces, body) of every level."""
    ws = crystal.ws
    x0c = crystal.x2c(np.asarray(x0, dtype=float))
    out = []
    for face, verts_idx in zip(ws.faces, range(len(ws.faces))):
        poly = ws.vertices[face]
        center = poly.mean(axis=0)
        nv = len(poly)
        for j in range(nv):
            p1 = poly[j]
            p2 = poly[(j + 1) % nv]
            mid = 0.5 * (p1 + p2)
            for apex in (p1, p2):
                tet = np.stack([np.zeros(3), center, apex, mid]) + x0c
                if rad > 0:
                    tet = x0c + (tet - x0c) * rad
                vol = abs(np.linalg.det(tet[1:] - tet[0])) / 6.0
                if vol < 1e-5:
                    continue
                # vertices (dim 1)
                out.extend(tet)
                # edges, faces, body with barycentric subdivision
                for dim, combos in (
                    (2, [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]),
                    (3, [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]),
                    (4, [(0, 1, 2, 3)]),
                ):
                    for cmb in combos:
                        _barycentric_subdivide(tet[list(cmb)], depth, out)
    seeds = crystal.c2x(np.array(out))
    return seeds


def gen_seeds(crystal, seeds: list[Seed], device=None) -> np.ndarray:
    """Build the full fractional seed array from the strategies (mesh
    seeds build their Becke mesh's weights on `device`, cuda by
    default)."""
    xs = []
    cart = crystal.x_cart
    for s in seeds:
        if s.typ == "ws":
            xs.append(seed_ws(crystal, s.x0, s.depth, s.rad))
        elif s.typ == "pair":
            for i1 in range(crystal.ncel):
                for i2 in range(crystal.ncel):
                    if i1 == i2:
                        continue
                    if np.linalg.norm(cart[i1] - cart[i2]) > s.dist:
                        continue
                    for k in range(1, s.npts + 1):
                        t = k / (s.npts + 1.0)
                        xs.append(
                            (crystal.x_frac[i1]
                             + t * (crystal.x_frac[i2] - crystal.x_frac[i1]))[None]
                        )
        elif s.typ == "triplet":
            for i1 in range(crystal.ncel):
                for i2 in range(crystal.ncel):
                    if i1 == i2 or np.linalg.norm(cart[i1] - cart[i2]) > s.dist:
                        continue
                    for i3 in range(crystal.ncel):
                        if i3 in (i1, i2):
                            continue
                        if (np.linalg.norm(cart[i1] - cart[i3]) > s.dist
                                or np.linalg.norm(cart[i2] - cart[i3]) > s.dist):
                            continue
                        xs.append(((crystal.x_frac[i1] + crystal.x_frac[i2]
                                    + crystal.x_frac[i3]) / 3.0)[None])
        elif s.typ == "line":
            ts = np.linspace(0.0, 1.0, s.npts)
            xs.append(s.x0[None, :] + ts[:, None] * (s.x1 - s.x0)[None, :])
        elif s.typ == "sphere":
            # reference :418-458: theta shells with doubling phi counts
            pts = []
            x1 = crystal.x2c(s.x0)
            dth = np.pi / 2.0 / s.ntheta
            theta = dth
            nphiact = s.nphi
            for _ in range(s.ntheta):
                for i2 in range(nphiact):
                    phi = i2 * 2.0 * np.pi / nphiact
                    for i3 in range(1, s.nr + 1):
                        r = s.rad * i3 / s.nr
                        for th in (theta, np.pi - theta):
                            pts.append(
                                x1 + r * np.array([
                                    np.sin(th) * np.cos(phi),
                                    np.sin(th) * np.sin(phi),
                                    np.cos(th),
                                ])
                            )
                theta += dth
                nphiact *= 2
            xs.append(crystal.c2x(np.array(pts)))
        elif s.typ == "oh":
            # recursive octahedron subdivision of the unit sphere
            pts = _sphere_triangulation(s.depth)
            x1 = crystal.x2c(s.x0)
            out = []
            for k in range(1, s.nr + 1):
                r = s.rad * k / s.nr
                out.append(x1 + r * pts)
            xs.append(crystal.c2x(np.concatenate(out)))
        elif s.typ == "point":
            xs.append(np.atleast_2d(np.asarray(s.x0, dtype=float)))
        elif s.typ == "mesh":
            # molecular integration mesh nodes as seeds (reference
            # styp_mesh, src/autocp@proc.f90:498-500)
            from .mesh import becke_mesh

            m = becke_mesh(crystal, getattr(s, "level", None) or "small",
                           device=device)
            xs.append(crystal.c2x(m.x))
        else:
            raise ValueError(f"unknown seed type {s.typ}")
    if not xs:
        return np.zeros((0, 3))
    return np.concatenate([np.atleast_2d(x) for x in xs], axis=0)


def _sphere_triangulation(depth: int) -> np.ndarray:
    """Vertices of a recursively subdivided octahedron projected on the
    unit sphere (role of minisurf spheretriang, src/surface.f90)."""
    verts = [
        np.array(v, dtype=float)
        for v in [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                  (0, 0, -1)]
    ]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(depth):
        newfaces = []
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for (i, j, k) in faces:
            a, b, c = midpoint(i, j), midpoint(j, k), midpoint(k, i)
            newfaces += [(i, a, c), (a, j, b), (c, b, k), (a, b, c)]
        faces = newfaces
    return np.unique(np.round(np.stack(verts), 12), axis=0)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
def _screened(f) -> bool:
    """Whether the field is a molecular wavefunction large enough for
    the screened evaluator (the dense one holds (P, N) temporaries)."""
    return (f.type == "wfn" and f.coreenv is None
            and f.wfn.npri >= f.wfn.SCREEN_NPRI)


def _newton_screened(w, cart, gfnormeps, maxit, n_chunk: int = 512,
                     margin: float = 3.0, seg: int = 30, device=None):
    """Newton CP refinement through the screened GTO evaluator.

    Two stages, both chunked spatially (fields/wfn.screen_plan); several
    chunks advance together through their block tables (one batched
    evaluation, lanes kept in place):

    1. f32 sweep to an f32-reachable gradient floor, in segments of
       `seg` iterations with global compaction + re-planning between
       segments: surviving seeds are re-chunked at their CURRENT
       positions (which also refreshes block tables the seeds walked
       out of), and seeds outside the escape sphere
       |x| > max|atpos| + 10 are dropped. Without the segmenting, a
       handful of never-converging lanes keep every chunk running the
       full iteration budget.
    2. f64 polish: stage-1 candidates are clustered on a cpeps/2
       rounding grid (duplicate seeds converge to duplicate CPs by the
       thousands), ONE representative per cluster is polished to the
       true gfnormeps with fresh block tables, and every member inherits
       its representative's polished position (the downstream cpeps
       dedup merges them regardless)."""
    dev = resolve_device(device)
    rmax = float(np.linalg.norm(np.asarray(w.atpos), axis=1).max() + 10.0)

    def _pass(points, nit, dtype, eps):
        order, xstack, bidx, N = w.screen_plan(points, n_chunk=n_chunk,
                                               margin=margin)
        G = w.sweep_group(n_chunk, bidx.shape[1], 2)
        xs, convs = [], []
        for lo in range(0, len(xstack), G):
            shim = w.screened_shim(bidx[lo:lo + G], nder=2, dtype=dtype,
                                   device=dev)
            x0 = torch.as_tensor(
                xstack[lo:lo + G].transpose(0, 2, 1).reshape(-1, 3),
                dtype=FDTYPE, device=dev)
            xx, cc, _ = newton_batch(shim, x0, gfnormeps=eps, maxit=nit,
                                     compact=False)
            xs.append(xx.cpu().numpy())
            convs.append(cc.cpu().numpy())
        inv = np.argsort(order)
        return np.concatenate(xs)[:N][inv], np.concatenate(convs)[:N][inv]

    x = np.array(cart, dtype=float, copy=True)
    N0 = len(x)
    conv = np.zeros(N0, bool)
    alive = np.ones(N0, bool)
    eps32 = max(gfnormeps, 1e-4)
    left = maxit
    while left > 0 and alive.any():
        idx = np.flatnonzero(alive)
        xs, cs = _pass(x[idx], seg, torch.float32, eps32)
        x[idx] = xs
        esc = np.linalg.norm(xs, axis=1) > rmax
        conv[idx] = cs & ~esc
        alive[idx] = ~cs & ~esc
        left -= seg
    # lanes that ran out of f32 budget near a CP (the f32 gradient
    # noise floor scales with the local density) still join the polish
    # set; the f64 stage is the arbiter of convergence
    cand = conv | alive
    if not cand.any():
        return x, conv
    ci = np.flatnonzero(cand)
    key = np.round(x[ci] / 5e-3).astype(np.int64)
    _, rep, inv_g = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    inv_g = inv_g.reshape(-1)
    xr, cr = _pass(x[ci[rep]], 20, None, gfnormeps)
    x[ci] = xr[inv_g]
    conv[ci] = cr[inv_g]
    return x, conv


def init_cplist(system) -> CPList:
    """Atoms enter the CP list as nuclear maxima (reference init_cplist,
    src/fieldmod@proc.f90:1402)."""
    c = system.crystal
    f = system.ref
    cpl = CPList(crystal=c)
    if c.ncel:
        res = f.grd(c.x_cart, nder=2)
        fv = res.f.cpu().numpy()
        lap = res.del2f.cpu().numpy()
        eigs = rsindex(res.hf)[0].cpu().numpy()
        for i in range(c.ncel):
            cpl.cps.append(
                CP(x=c.x_frac[i].copy(), r=c.x_cart[i].copy(),
                   typ=f.typnuc, f=float(fv[i]), gfmod=0.0,
                   del2f=float(lap[i]), eig=eigs[i], isnuc=True,
                   name=c.species[c.species_of[i]].name)
            )
    return cpl


def autocp(system, seeds: list[Seed] | None = None, gfnormeps: float = 1e-12,
           cpeps: float = 1e-2, nuceps: float | None = None,
           nucepsh: float | None = None, hdegen: float = 1e-8,
           maxit: int = 200, discard=None, cpl: CPList | None = None,
           chunk: int = 65536, verbose: bool = False,
           clip=None) -> CPList:
    """Run the automatic CP search on the system's reference field.

    Defaults mirror the reference (src/autocp@proc.f90:125-148): WS seed
    for crystals / atom-pair seed for molecules; gfnormeps 1e-12, cpeps
    1e-2 bohr, nuceps 0.1 bohr (or 2*max grid step for grid fields),
    nucepsh 0.2 bohr. Runs on the system's device (cuda unless the
    system was built for another).
    """
    resolve_device(system.device)
    c = system.crystal
    f = system.ref
    if seeds is None:
        seeds = [Seed(typ="pair" if c.ismolecule else "ws")]
    if nuceps is None:
        if f.type == "grid":
            nuceps = 2.0 * float(np.max(np.asarray(c.aa) / np.asarray(f.grid.n)))
            nucepsh = nuceps if nucepsh is None else nucepsh
        else:
            nuceps = 1e-1
    if nucepsh is None:
        nucepsh = 2e-1

    xseed = gen_seeds(c, seeds, device=system.device)
    if len(xseed) == 0:
        return cpl or init_cplist(system)

    # prune: wrap into the main cell; molecules: clip to molcell border
    xseed = np.mod(xseed, 1.0)
    if clip is not None:
        # CLIP CUBE x0 x1 / CLIP SPHERE x0 rad, crystallographic coords
        # (reference iclip, src/autocp@proc.f90:44-46, :594-655)
        kind = clip[0].lower()
        if kind == "cube":
            lo = np.minimum(np.asarray(clip[1], float),
                            np.asarray(clip[2], float))
            hi = np.maximum(np.asarray(clip[1], float),
                            np.asarray(clip[2], float))
            keep = np.all((xseed >= lo) & (xseed <= hi), axis=1)
        elif kind == "sphere":
            d = np.asarray(c.distance(
                xseed, np.tile(np.asarray(clip[1], float),
                               (len(xseed), 1))))
            keep = d <= float(clip[2])
        else:
            raise ValueError(f"unknown clip kind {clip[0]}")
        xseed = xseed[keep]
    if c.ismolecule:
        b = c.molborder
        keep = np.all((xseed >= b) & (xseed <= 1.0 - b), axis=1)
        xseed = xseed[keep]
    if len(xseed) == 0:
        return cpl or init_cplist(system)
    # dedup seeds (reference uses uniqc)
    xseed = np.unique(np.round(xseed, 10), axis=0)
    cart = c.x2c(xseed)

    if verbose:
        print(f"autocp: {len(cart)} seeds")

    # --- batched Newton on device, chunked to bound memory; large
    # molecular wavefunctions go through the screened evaluator ---
    if _screened(f):
        xfin, conv = _newton_screened(f.wfn, cart, gfnormeps, maxit,
                                      device=f.device)
    else:
        fn = f.eval_fn(nder=2)
        xs, convs = [], []
        for lo in range(0, len(cart), chunk):
            x0 = torch.as_tensor(cart[lo:lo + chunk], dtype=FDTYPE,
                                 device=f.device)
            xx, cc, _ = newton_batch(fn, x0, gfnormeps=gfnormeps,
                                     maxit=maxit)
            xs.append(xx.cpu().numpy())
            convs.append(cc.cpu().numpy())
        xfin = np.concatenate(xs)
        conv = np.concatenate(convs)
    xfin = xfin[conv]
    if verbose:
        print(f"autocp: {len(xfin)} converged")
    if len(xfin) == 0:
        return cpl or init_cplist(system)

    # evaluate all converged candidates once for classification
    res = f.grd(xfin, nder=2)
    eigs, rr, ss = rsindex(res.hf, eps=hdegen)
    eigs = eigs.cpu().numpy()
    rr = rr.cpu().numpy()
    ss = ss.cpu().numpy()
    fv = res.f.cpu().numpy()
    gm = res.gfmod.cpu().numpy()
    lap = res.del2f.cpu().numpy()

    # --- host dedup & add (reference addcp, src/fieldmod@proc.f90:1876);
    # symmetry-aware: a candidate is rejected if ANY image of its orbit
    # matches an existing CP, and its multiplicity is the orbit size.
    # Vectorized: "orbit(cand) near cp" == "cand near orbit(cp)" (the ops
    # form a group), so candidates are screened against the images of the
    # accepted list in batch instead of per-candidate orbit loops ---
    cpl = cpl or init_cplist(system)
    zs = c.zatoms
    sg = None if c.ismolecule else c.spacegroup

    xc_all = c.c2x(xfin)
    xc_all -= np.floor(xc_all)
    # |grad f| < gfnormeps fixes a position only to rounding noise, so a
    # CP on a lattice plane lands within ~1e-15 of it on either side; put
    # it on the plane, or a symmetry image of a point at +1e-16 wraps to
    # 1 - 1e-16 and CPREPORT LONG prints 1.00000000 for 0
    xc_all[(xc_all < 1e-10) | (xc_all > 1.0 - 1e-10)] = 0.0

    alive = np.ones(len(xc_all), dtype=bool)
    if c.ismolecule:
        b = c.molborder
        alive &= np.all((xc_all >= b) & (xc_all <= 1.0 - b), axis=1)
    alive &= rr == 3                                 # degenerate out
    # near a nucleus? (vectorized identify_atom)
    if c.ncel:
        nid, dnuc = c.identify_atom(xc_all, distmax=max(nuceps, nucepsh))
        nid = np.atleast_1d(np.asarray(nid))
        dnuc = np.atleast_1d(np.asarray(dnuc))
        isnuc = (nid >= 0) & (
            (dnuc < nuceps)
            | ((zs[np.clip(nid, 0, None)] == 1) & (dnuc < nucepsh)))
        alive &= ~isnuc

    def _images(x):
        """All symmetry images of fractional point x (with duplicates)."""
        if sg is None:
            return np.atleast_2d(x)
        return (np.einsum("oij,j->oi", sg.rotations.astype(float), x)
                + sg.translations) % 1.0

    # screen against the existing CP list (nuclei etc.): candidates near
    # any image of any existing CP are duplicates
    if np.any(alive) and cpl.cps:
        imgs = np.concatenate([_images(cp.x) for cp in cpl.cps])
        alive[alive] &= c.distmat(xc_all[alive], imgs,
                                  cutoff=cpeps).min(axis=1) >= cpeps

    for i in np.nonzero(alive)[0]:
        if not alive[i]:
            continue
        xc = xc_all[i]
        if discard is not None and discard(xfin[i]):
            alive[i] = False
            continue
        imgs = _images(xc)
        # orbit size = number of distinct images (multiplicity)
        if len(imgs) > 1:
            dmm = c.distmat(imgs, imgs, cutoff=cpeps)
            mult = int(round(len(imgs) / np.mean(
                (dmm < cpeps).sum(axis=1))))
        else:
            mult = 1
        cpl.cps.append(
            CP(x=xc, r=c.x2c(xc), typ=int(ss[i]), f=float(fv[i]),
               gfmod=float(gm[i]), del2f=float(lap[i]), eig=eigs[i],
               mult=mult)
        )
        # kill every remaining candidate inside this orbit
        rest = np.nonzero(alive)[0]
        dd = c.distmat(xc_all[rest], imgs, cutoff=cpeps).min(axis=1)
        alive[rest[dd < cpeps]] = False

    # names: n1, b1, r1, c1, ... in type order of addition
    counters = [0, 0, 0, 0]
    letters = "nbrc"
    for cp in cpl.cps:
        if not cp.name:
            counters[cp.typind] += 1
            cp.name = f"{letters[cp.typind]}{counters[cp.typind]}"
        elif cp.isnuc:
            counters[0] += 1

    # sort: by type (ncp, bcp, rcp, ccp), nuclei first (reference sortcps)
    cpl.cps.sort(key=lambda cp: (cp.typind, not cp.isnuc))
    return cpl


def makegraph(system, cpl: CPList, change: float = 1e-2,
              rterm: float = 0.1):
    """Build the bond-path / ring-path graph (reference makegraph,
    src/autocp@proc.f90:1734-1877).

    For each BCP, trace uphill from +-change along the positive-eigenvalue
    eigenvector to the connected maxima; for each RCP, downhill along the
    negative-eigenvalue eigenvector to the connected cages. All paths of
    one kind run as one batched device trace (ops/ode.trace_paths)
    instead of the reference's per-CP OpenMP loop. Fills cp.brvec,
    cp.brpathlen and cp.ipath (indices into cpl.cps; -1 =
    escaped/unknown).
    """
    from ..ops.eig3 import eigh3
    from ..ops.ode import trace_paths

    resolve_device(system.device)
    c = system.crystal
    f = system.ref

    def _targets(typ_sel):
        idx = [i for i, cp in enumerate(cpl.cps) if cp.typ == typ_sel]
        if not idx:
            return np.zeros((0, 3)), np.zeros(0, dtype=int)
        if c.ismolecule:
            return (np.array([cpl.cps[i].r for i in idx]),
                    np.array(idx))
        # expand each representative to its full symmetry orbit, then to
        # the 27 neighboring cells (reference cpcel list)
        sg = c.spacegroup
        pos, ids = [], []
        for i in idx:
            orb = sg.orbit(cpl.cps[i].x)
            pos.append(orb)
            ids.extend([i] * len(orb))
        pos = np.concatenate(pos)
        ids = np.asarray(ids)
        shifts = np.array([[i, j, k] for i in (-1, 0, 1)
                           for j in (-1, 0, 1) for k in (-1, 0, 1)])
        imgs = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
        return c.x2c(imgs), np.tile(ids, len(shifts))

    screened = _screened(f)
    fn = None if screened else f.eval_fn(nder=2)
    for typ, iup, ttyp in ((-1, 1, f.typnuc), (1, -1, -f.typnuc)):
        sel = [i for i, cp in enumerate(cpl.cps) if cp.typ == typ]
        if not sel:
            continue
        hf = f.grd(np.array([cpl.cps[i].r for i in sel]), nder=2).hf
        v = eigh3(hf)[1].cpu().numpy()
        # BCP: positive-eigenvalue direction (column 2); RCP: most
        # negative (column 0)
        vec = v[:, :, 2] if typ == -1 else v[:, :, 0]
        seeds, owner, sgn = [], [], []
        for k, i in enumerate(sel):
            for s in (+1.0, -1.0):
                seeds.append(cpl.cps[i].r + s * change * vec[k])
                owner.append(i)
                sgn.append(s)
        tgt, tgt_ids = _targets(ttyp)
        kw = dict(iup=iup, targets=tgt if len(tgt) else None,
                  rterm=np.full(len(tgt), rterm) if len(tgt) else None,
                  m_c2x=c.m_c2x if c.ismolecule else None,
                  molborder=c.molborder if c.ismolecule else None)
        if screened:
            from ..ops.ode import trace_paths_screened

            # one group for all seeds, as wide as the screened
            # evaluator's memory budget allows: the tracer is
            # launch-bound, and a path that crawls into a saddle on a
            # symmetry plane holds its whole group for all mstep attempts
            # (768-atom H2 tile on an H100: 256-seed groups took 32,448
            # attempts and 233 s, eight of them running all 4,000; one
            # group takes 4,032 attempts and 40 s)
            w = f.wfn
            wide = w.SWEEP_BYTES // (w._screen()["Pp"] * 8 * 30)
            _, status, termid, plen, _ = trace_paths_screened(
                w, np.array(seeds), device=f.device,
                n_chunk=int(max(256, min(len(seeds), wide))), **kw)
        else:
            _, status, termid, plen, _ = trace_paths(
                fn, torch.as_tensor(np.array(seeds), dtype=FDTYPE,
                                    device=f.device), **kw)
        status = status.cpu().numpy()
        termid = termid.cpu().numpy()
        plen = plen.cpu().numpy()
        for j, i in enumerate(owner):
            cp = cpl.cps[i]
            if cp.ipath is None:
                cp.ipath = [-1, -1]
                cp.brpathlen = [0.0, 0.0]
                cp.brvec = vec[sel.index(i)]
            d = 0 if sgn[j] > 0 else 1
            cp.brpathlen[d] = float(plen[j])
            if status[j] == 0 and termid[j] >= 0:
                cp.ipath[d] = int(tgt_ids[termid[j]])
    return cpl


def cell_cp_list(system, cpl: CPList):
    """Complete (cell) CP list: every symmetry image of every
    nonequivalent CP, with the generating operation (reference cpcel,
    built in addcp, src/fieldmod@proc.f90:1876-1960).

    Returns a list of (ineq, x_frac (3,), opidx) tuples."""
    c = system.crystal
    out = []
    if c.ismolecule or getattr(c, "spacegroup", None) is None:
        return [(i, np.asarray(cp.x, dtype=float), 0)
                for i, cp in enumerate(cpl.cps)]
    sg = c.spacegroup
    for i, cp in enumerate(cpl.cps):
        xs, ops = sg.orbit_ops(np.asarray(cp.x, dtype=float))
        out.extend((i, x, int(op)) for x, op in zip(xs, ops))
    return out


def cp_long_report(system, cpl: CPList) -> str:
    """CPREPORT LONG: the complete cell CP list with symmetry-operation
    provenance and the bcp/rcp connectivity table (reference
    cp_long_report, src/autocp@proc.f90:1567-1623)."""
    letters = "nbrc"
    lines = ["* Complete CP list",
             "# (x symbols are the non-equivalent representatives)",
             "#  cp   ncp  typ   position (cryst. coords.)       op."]
    cel = cell_cp_list(system, cpl)
    for icel, (ineq, x, op) in enumerate(cel):
        neq = "x" if op == 0 else " "
        cp = cpl.cps[ineq]
        lines.append(f"{neq} {icel + 1:<6d} {ineq + 1:<4d} "
                     f"{letters[cp.typind]}  "
                     f"{x[0]:12.8f} {x[1]:12.8f} {x[2]:12.8f}  {op + 1:3d}")
    lines.append("")
    lines.append("* Complete CP list, bcp and rcp connectivity table")
    lines.append("# cp   ncp  typ   position (cryst. coords.)"
                 "         end1  end2")
    for icel, (ineq, x, op) in enumerate(cel):
        cp = cpl.cps[ineq]
        base = (f"{icel + 1:<6d} {ineq + 1:<4d} {letters[cp.typind]}  "
                f"{x[0]:13.8f} {x[1]:13.8f} {x[2]:13.8f}")
        if abs(cp.typ) == 1 and cp.ipath:
            e1 = cp.ipath[0] + 1 if cp.ipath[0] is not None else 0
            e2 = (cp.ipath[1] + 1 if len(cp.ipath) > 1
                  and cp.ipath[1] is not None else 0)
            base += f"  {e1:4d}  {e2:4d}"
        lines.append(base)
    return "\n".join(lines)


def cp_vlong_report(system, cpl: CPList) -> str:
    """CPREPORT VERYLONG: per-CP property blocks + the flatness
    rho_min/rho_{b,max} (reference cp_vlong_report,
    src/autocp@proc.f90:1626-1664)."""
    c = system.crystal
    lines = ["* Additional properties at the critical points"]
    minden, maxbden = 1e30, 1e-30
    for i, cp in enumerate(cpl.cps):
        lines.append(f"+ Critical point no. {i + 1} ({cp.name})")
        if not c.ismolecule:
            lines.append("  Crystallographic coordinates: "
                         + " ".join(f"{v:.10f}" for v in cp.x))
        lines.append("  Cartesian coordinates (bohr): "
                     + " ".join(f"{v:.10f}" for v in cp.r))
        lines.append(f"  Field value (f): {cp.f:.9e}")
        lines.append(f"  Gradient norm (|grad f|): {cp.gfmod:.9e}")
        lines.append(f"  Laplacian (del2 f): {cp.del2f:.9e}")
        lines.append("  Hessian eigenvalues: "
                     + " ".join(f"{v:.9e}" for v in np.asarray(cp.eig)))
        if cp.typ == -1 and abs(cp.eig[1]) > 1e-30:
            lines.append(f"  Ellipticity (l_1/l_2 - 1): "
                         f"{cp.eig[0] / cp.eig[1] - 1.0:.9e}")
        minden = min(minden, cp.f)
        if cp.typ == -1:
            maxbden = max(maxbden, cp.f)
    if not c.ismolecule:
        fness = minden / maxbden if maxbden > 1e-12 else 0.0
        lines.append(f"+ Flatness (rho_min / rho_b,max): {fness:.6f}")
    return "\n".join(lines)


def critshell(system, cpl: CPList, shmax: int = 10):
    """Shells of critical points around each nonequivalent CP
    (reference critshell, src/autocp@proc.f90:962-1051): for every CP,
    the shmax nearest distinct CP-CP distances, their multiplicities
    and the shell member's CP index. Returns (dist (ncp, shmax),
    nneig (ncp, shmax), wcp (ncp, shmax)); unused slots hold 1e30/0."""
    c = system.crystal
    # complete (cell) CP list: expand nonequivalent CPs by symmetry orbit
    sg = c.spacegroup
    cell_x, cell_idx = [], []
    for i, cp in enumerate(cpl.cps):
        xs = np.mod(sg.rotations @ cp.x + sg.translations, 1.0)
        seen = []
        for x in xs:
            if not any(np.linalg.norm((x - y + 0.5) % 1.0 - 0.5) < 1e-5
                       for y in seen):
                seen.append(x)
        cell_x.extend(seen)
        cell_idx.extend([i] * len(seen))
    cell_x = np.asarray(cell_x)
    cell_idx = np.asarray(cell_idx)

    lvecs = (np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                  indexing="ij"), -1).reshape(-1, 3)
             if not c.ismolecule else np.zeros((1, 3)))
    ncp = len(cpl.cps)
    dist = np.full((ncp, shmax), 1e30)
    nneig = np.zeros((ncp, shmax), dtype=int)
    wcp = np.zeros((ncp, shmax), dtype=int)
    m = np.asarray(c.m_x2c)
    for i, cp in enumerate(cpl.cps):
        x0 = m @ cp.x
        allx = (cell_x[:, None, :] + lvecs[None, :, :]).reshape(-1, 3)
        alli = np.repeat(cell_idx, len(lvecs))
        d = np.linalg.norm(allx @ m.T - x0, axis=1)
        order = np.argsort(d)
        for k in order:
            d2 = d[k]
            if d2 < 1e-12:
                continue
            placed = False
            for sl in range(shmax):
                if abs(d2 - dist[i, sl]) < 1e-8:
                    nneig[i, sl] += 1
                    placed = True
                    break
                if d2 < dist[i, sl]:
                    dist[i, sl + 1:] = dist[i, sl:-1]
                    nneig[i, sl + 1:] = nneig[i, sl:-1]
                    wcp[i, sl + 1:] = wcp[i, sl:-1]
                    dist[i, sl] = d2
                    nneig[i, sl] = 1
                    wcp[i, sl] = alli[k] + 1
                    placed = True
                    break
            if not placed:
                break
    return dist, nneig, wcp
