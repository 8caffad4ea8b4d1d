"""QTREE: basin integration by gradient-path coloring of a tetrahedral
partition of the Wigner-Seitz cell.

Role of the reference qtree family (src/qtree*.f90, ~5 kLoC): partition
the WS cell into the symmetry-irreducible tetrahedra (c%getiws,
src/crystalmod.f90:176), recursively subdivide to level maxl, assign
each node to a basin by tracing its gradient path (termination colors),
and integrate properties inside uniformly colored tetrahedra by corner
sums, Keast rules, or adaptive CUBPACK cubature
(src/qtree_tetrawork.f90:36-107), with beta spheres around nuclei.

Decomposition (as in the JAX package):
- the recursion becomes LEVELS of batched work - at each level every
  active (mixed-color) tetrahedron subdivides 8-fold and all new node
  colors resolve in batched gradient-path traces (ops/ode);
- the symmetry reduction keeps one representative per orbit of the
  origin atom's site point group and replays each retired contribution
  through the orbit's atom permutations (the role of getiws +
  tetrahedron multiplicities);
- CUBPACK's adaptive error control becomes a host refinement queue:
  each uniform tetrahedron is integrated with a Keast rule pair
  (high/low order); those with |hi - lo| above tolerance subdivide and
  re-enter the queue, all evaluations batched on the device;
- beta spheres (auto radii verified by surface traces) integrate by
  Gauss-Legendre radial x Lebedev angular quadrature, and the
  tetrahedral cubature masks sphere interiors;
- charges are reported per symmetry orbit.

The bookkeeping (colour cache, queue, orbit replay) is host numpy in
float64, line for line the JAX package's, so both trace the same set of
points. Field evaluations, the sphere masks and the per-tetrahedron Keast
reductions run on the system's device. Batches are not padded: the JAX
package pads to powers of two only to bound its recompiles.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, EDTYPE, resolve_device
from ..ops.ode import trace_paths

__all__ = ["qtree_integrate", "QtreeResult"]


def _sphere_mask_dev(ptsT, tgtT, rads):
    """(inside_any (N,) bool, kmin (N,), dmin (N,)) of points (3, N)
    against the 27-cell target images (3, K), on the device."""
    d2 = ((ptsT[:, :, None] - tgtT[:, None, :]) ** 2).sum(0)    # (N, K)
    dmin2, k = d2.min(dim=1)
    inside = (d2 <= (rads[None, :] ** 2)).any(dim=1)
    return inside, k, torch.sqrt(dmin2)


def _masked_keast_reduce(fv, outs, qw):
    """((fv*outs*qw).sum(1), (outs*qw).sum(1)) on the device."""
    return (fv * outs * qw).sum(dim=1), (outs * qw).sum(dim=1)


def _ws_tetrahedra(crystal):
    """Tetrahedralize the WS cell: origin + fan triangles of each facet
    (reference c%getiws, src/crystalmod.f90:176)."""
    ws = crystal.ws
    tets = []
    for face in ws.faces:
        v = ws.vertices[face]
        c = v.mean(axis=0)
        for t in range(len(v)):
            a, b = v[t], v[(t + 1) % len(v)]
            tets.append(np.stack([np.zeros(3), c, a, b]))
    return np.asarray(tets)          # (T, 4, 3) Cartesian around origin


def _subdivide(tets):
    """8-fold subdivision of tetrahedra (T,4,3) -> (8T,4,3).

    PARENT-MAJOR order: children of parent i occupy rows 8i..8i+7, so
    per-parent payloads (colors, orbit-group ids) carry over with
    np.repeat(x, 8). (A type-major concatenation here once scrambled
    the refinement queue's colors across parents in the JAX package -
    9.8 e of a 31.6-e cell tagged with other basins' colors.)"""
    a, b, c, d = tets[:, 0], tets[:, 1], tets[:, 2], tets[:, 3]
    ab = 0.5 * (a + b); ac = 0.5 * (a + c); ad = 0.5 * (a + d)
    bc = 0.5 * (b + c); bd = 0.5 * (b + d); cd = 0.5 * (c + d)
    subs = [
        (a, ab, ac, ad), (ab, b, bc, bd), (ac, bc, c, cd), (ad, bd, cd, d),
        (ab, ac, ad, bd), (ab, ac, bc, bd), (ac, ad, bd, cd),
        (ac, bc, bd, cd),
    ]
    kids = np.stack([np.stack(s, axis=1) for s in subs], axis=1)
    return kids.reshape(-1, 4, 3)


def _tet_volume(tets):
    e1 = tets[:, 1] - tets[:, 0]
    e2 = tets[:, 2] - tets[:, 0]
    e3 = tets[:, 3] - tets[:, 0]
    return np.abs(np.einsum("ti,ti->t", np.cross(e1, e2), e3)) / 6.0


def _site_ops(crystal, iat, tol=1e-6):
    """Site point group of cell atom iat: list of (R_cart (3,3),
    atom_perm (ncel+1,)) for every space-group op that fixes the site.
    atom_perm maps a basin color to the color of the symmetry image;
    the trailing entry keeps the unresolved color (-1) fixed."""
    sg = crystal.spacegroup
    m = np.asarray(crystal.m_x2c)
    minv = np.linalg.inv(m)
    xf = np.asarray(crystal.x_frac)
    n = len(xf)
    ops = []
    for R, t in zip(np.asarray(sg.rotations), np.asarray(sg.translations)):
        d = R @ xf[iat] + t - xf[iat]
        d -= np.round(d)
        if np.linalg.norm(m @ d) > 1e-4:
            continue
        # atom permutation under the op: atom j's image coincides with
        # atom perm[j] (mod lattice)
        img = (xf @ R.T + t[None, :])
        perm = np.empty(n + 1, dtype=int)
        for j in range(n):
            dd = xf - img[j]
            dd -= np.round(dd)
            perm[j] = int(np.argmin(np.linalg.norm(dd @ m.T, axis=1)))
        perm[n] = n                                  # the -1 bucket
        ops.append((m @ R @ minv, perm))
    return ops


def _reduce_tets(tets, ops, tol=1e-5):
    """Group the (origin-relative) tetrahedra into orbits of the site
    point group. Returns (rep_tets (G,4,3), orbit_perms: list of lists
    of atom permutations - one per distinct orbit member)."""
    def key(T):
        v = np.round(T / tol).astype(np.int64)
        return tuple(sorted(map(tuple, v)))

    canon = {}
    for idx, T in enumerate(tets):
        k = min(key((Rc @ T.T).T) for Rc, _ in ops)
        canon.setdefault(k, []).append(idx)

    reps, orbit_perms = [], []
    for k, members in canon.items():
        T = tets[members[0]]
        reps.append(T)
        seen = {}
        for Rc, perm in ops:
            kk = key((Rc @ T.T).T)
            if kk not in seen:
                seen[kk] = perm
        orbit_perms.append(list(seen.values()))
    return np.asarray(reps), orbit_perms


@dataclass
class QtreeResult:
    names: list
    pops: np.ndarray
    volumes: np.ndarray
    nlevels: int
    ntraced: int
    nrefined: int = 0

    def table(self):
        lines = ["# i  atom       volume            pop"]
        for q, (nm, v, p) in enumerate(
                zip(self.names, self.volumes, self.pops), 1):
            lines.append(f"{q:4d}  {nm:>4s}  {v:14.8f}  {p:14.8f}")
        return "\n".join(lines)


def _f32_tracer(f, precision):
    """Gradient evaluator for the f32 and mixed trace precisions: the
    grid in float32, outputs returned in float64 (the tracer's state is
    float64), cached on the field per grid object."""
    from ..fields.field import Field
    from ..fields.grid3 import Grid3

    cache = getattr(f, "_qtree_trace_fn", None)
    if cache is None or cache.get("_grid_id") != id(f.grid):
        cache = f._qtree_trace_fn = {"_grid_id": id(f.grid)}
    if precision not in cache:
        fld32 = Field.from_grid(f.crystal, Grid3(f.grid.f.to(EDTYPE),
                                                 mode=f.grid.mode),
                                name="_qtree_trace32")
        fn32 = fld32.eval_fn(nder=1)

        def fn(xT):
            fv, gf, h6 = fn32(xT.to(EDTYPE))
            return fv.to(FDTYPE), gf.to(FDTYPE), h6.to(FDTYPE)

        cache[precision] = fn
    return cache[precision]


def qtree_integrate(system, maxl: int = 3, minl: int = 4,
                    origin_atom: int | None = None,
                    block: int = 1 << 13, field_block: int = 1 << 16,
                    integ: str = "keast",
                    keastnum: int = 7, keastlow: int = 4,
                    cub_abs: float = 1e-7, cub_rel: float = 1e-6,
                    maxrefine: int = 8, max_queue: int = 1 << 16,
                    usesym: bool = True, precision: str = "f64",
                    sphfactor: float | None = None,
                    stats: dict | None = None) -> QtreeResult:
    """Basin populations/volumes of the reference field by qtree coloring,
    on the system's device (cuda unless the system was built for another).

    The WS cell is centered on an atom (default: atom 0, the reference
    ws_origin); colors come from batched uphill traces to the nuclei.

    minl: minimum subdivision level BEFORE the 4-corner uniformity test
    is trusted (reference minl, default 4, src/global@proc.f90:148; here
    minl clamps to maxl so shallow runs stay usable). Levels < minl
    always subdivide and skip the corner traces.
    integ: "keast" (adaptive Keast-pair cubature with host refinement,
    the CUBPACK role - rules `keastnum`/`keastlow`, tolerances
    cub_abs/cub_rel per tetrahedron) or "corner" (plain corner sum,
    reference integ_corner_sum, src/qtree_tetrawork.f90:107).
    usesym reduces the tetrahedra to site-point-group orbit
    representatives (reference getiws) and replays contributions
    through the orbit atom permutations.
    sphfactor=None (the default) starts each atom's beta sphere at
    0.8 * rnn/2 and shrinks it by 25% until every surface gradient path
    terminates at its own nucleus; sphfactor > 0 freezes radius =
    sphfactor * rnn/2; sphfactor = 0 disables spheres.
    block: most lanes a trace call takes; field_block: most points a
    field evaluation takes.
    precision: "f64" (default) traces on the float64 field; "mixed"
    and "f32" evaluate the gradient on a float32 copy of a tricubic or
    trilinear grid and retrace, in f64, the lanes that fail to resolve.
    Lanes that resolve to the WRONG basin under f32 noise near a
    separatrix are kept, so validate such charges against an exact
    case. The two are one route here: the port's tracer keeps its
    state, direction and step control in float64 either way.
    stats: a dict that, when given, receives the host-clock seconds of
    the parts ("trace_s": colour traces; "cubature_s": retiring uniform
    tetrahedra, the Keast queue or corner sums; "boundary_s": the
    deepest level's Keast-node split, its traces excluded; "sphere_s":
    the beta-sphere integrals). Every part ends in a host read, so the
    device is drained at each clock reading.
    """
    resolve_device(system.device)
    c = system.crystal
    f = system.ref
    dev = f.device
    clock = {} if stats is None else stats
    for k in ("trace_s", "cubature_s", "boundary_s", "sphere_s"):
        clock.setdefault(k, 0.0)

    @contextmanager
    def timed(key):
        t0 = time.perf_counter()
        yield
        clock[key] += time.perf_counter() - t0
    fn64 = f.eval_fn(nder=1)    # traces use the gradient only
    fn = fn64
    if (precision in ("f32", "mixed") and f.type == "grid"
            and f.grid.mode in ("tricubic", "trilinear")):
        fn = _f32_tracer(f, precision)
    retrace = fn is not fn64
    fnv = f.eval_fn(nder=0)     # cubature uses values only
    iat = 0 if origin_atom is None else origin_atom
    x0 = np.asarray(c.x_cart[iat])
    nat = c.ncel

    def dev64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=FDTYPE,
                               device=dev)

    tets0 = _ws_tetrahedra(c)                     # origin-relative
    if usesym and not c.ismolecule:
        ops = _site_ops(c, iat)
        reps, orbit_perms = _reduce_tets(tets0, ops)
    else:
        reps = tets0
        orbit_perms = [[np.arange(nat + 1)]] * len(tets0)
    tets = reps + x0[None, None, :]
    gidx = np.arange(len(tets))                   # orbit-group index

    # targets: nuclei images
    pos = np.asarray(c.x_frac)
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)])
    imgs = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    tgt = c.x2c(imgs)
    tgt_ids = np.tile(np.arange(nat), len(shifts))

    color_cache: dict = {}
    ntraced = 0

    # beta spheres: radius per cell atom (reference AUTOSPH/SPHFACTOR)
    sphrad = None
    if sphfactor is None or sphfactor > 0:
        allpos = np.asarray(c.x_frac)
        sphrad = np.empty(nat)
        for i in range(nat):
            d = c.distance(np.delete(allpos, i, axis=0), allpos[i])
            dmin = float(np.min(d)) if np.size(d) else float(np.min(c.aa))
            sphrad[i] = (sphfactor if sphfactor else 0.8) * 0.5 * dmin

    def _traced_colors(pts, rt):
        """Batched traces -> colors, `block` lanes a call. (gradeps
        stays at the production 1e-7: a looser gradient floor retires
        traces mid-path in flat low-density regions of smooth fields.)"""
        with timed("trace_s"):
            return _traced_colors_untimed(pts, rt)

    def _traced_colors_untimed(pts, rt):
        def _one_pass(pp, fnx):
            xf_, status, termid, _, _ = trace_paths(
                fnx, dev64(pp), iup=1, targets=tgt, rterm=rt, mstep=600)
            st = status.cpu().numpy()
            ti = termid.cpu().numpy()
            cc = np.where((st == 0) & (ti >= 0),
                          tgt_ids[np.clip(ti, 0, len(tgt_ids) - 1)], -1)
            # gradient-zero finishers (saddles/nuclei): classify by
            # final-position proximity (the reference nudges corners
            # for the same reason, src/qtree_gpaths)
            gz = cc < 0
            if gz.any():
                xg = xf_.cpu().numpy()[gz]
                d = np.linalg.norm(xg[:, None, :] - tgt[None, :, :],
                                   axis=2)
                kbest = d.argmin(axis=1)
                okm = d[np.arange(len(xg)), kbest] < 0.5
                cc[np.nonzero(gz)[0][okm]] = tgt_ids[kbest[okm]]
            return cc

        cols = np.empty(len(pts), dtype=int)
        for lo in range(0, len(pts), block):
            cols[lo:lo + block] = _one_pass(pts[lo:lo + block], fn)
        if retrace:
            # mixed primary pass: lanes that failed to resolve (f32 gmod
            # noise can false-trigger the gradient-zero stop in flat
            # regions) retrace from their seeds at full f64
            bad = np.nonzero(cols < 0)[0]
            for lo in range(0, len(bad), block):
                sel = bad[lo:lo + block]
                cols[sel] = _one_pass(pts[sel], fn64)
        return cols

    # beta-sphere verification (reference find_beta / tetrahedral-grid
    # branch, src/qtree@proc.f90:816,963): shrink each auto radius
    # until every surface gradient path terminates at its own nucleus
    if sphfactor is None and sphrad is not None:
        from ..ops.lebedev import lebedev

        dirs, _ = lebedev(26)
        rt_small = np.full(len(tgt), 0.2)
        xc_at = np.asarray(c.x_cart)
        for _ in range(5):
            pts = (xc_at[:, None, :]
                   + sphrad[:, None, None] * dirs[None, :, :]).reshape(-1, 3)
            cols = _traced_colors(pts, rt_small).reshape(nat, len(dirs))
            ntraced += pts.shape[0]
            bad = (cols != np.arange(nat)[:, None]).any(axis=1)
            if not bad.any():
                break
            sphrad[bad] *= 0.75

    # traces terminate at the beta-sphere surface when spheres are
    # active; else at the reference's default 0.2-bohr capture radius
    rt_trace = (sphrad[tgt_ids] if sphrad is not None
                else np.full(len(tgt), 0.2))

    tgtT_d = dev64(tgt.T)
    rads_d = dev64(sphrad[tgt_ids] if sphrad is not None
                   else np.zeros(len(tgt)))

    def _sphere_info_dev(pts):
        """Device (inside_any, kmin, dmin), field_block points at a time."""
        parts = [_sphere_mask_dev(dev64(pts[lo:lo + field_block].T),
                                  tgtT_d, rads_d)
                 for lo in range(0, len(pts), field_block)]
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([q[i] for q in parts]) for i in range(3))

    def colors_of(points, seeds=None):
        """Basin color per point, cached by (ROUNDED RAW position,
        nudge-direction OCTANT): a corner shared by several tetrahedra
        on the same side of a separatrix is traced ONCE (the reference's
        color_allocate stores one color per grid point,
        src/qtree_basic.f90). `seeds` optionally supplies per-point trace
        START positions (the callers' centroid nudge, which unsticks
        zero-gradient symmetry corners); the octant of seed - point joins
        the key because a corner lying exactly ON a separatrix takes the
        basin of its nudge side."""
        nonlocal ntraced
        if seeds is None:
            seeds = points
            keys = [tuple(np.round(p, 8)) for p in points]
        else:
            dirs = np.sign(np.round(np.asarray(seeds) - np.asarray(points),
                                    9)).astype(np.int8)
            keys = [tuple(np.round(p, 8)) + tuple(d)
                    for p, d in zip(points, dirs)]
        if sphrad is not None:
            # inside-any-sphere check on the device (beta spheres are
            # disjoint, so "inside any" == "inside the nearest")
            ins_d, km_d, _ = _sphere_info_dev(points)
            inside = ins_d.cpu().numpy()
            kb = km_d.cpu().numpy()
            for i in np.nonzero(inside)[0]:
                color_cache.setdefault(keys[i], int(tgt_ids[kb[i]]))
        need, seen = [], set()
        for i, k in enumerate(keys):
            if k not in color_cache and k not in seen:
                seen.add(k)
                need.append(i)
        if need:
            cols = _traced_colors(seeds[need], rt_trace)
            ntraced += len(need)
            for i, idx in enumerate(need):
                color_cache[keys[idx]] = cols[i]
        return np.array([color_cache[k] for k in keys])

    pops = np.zeros(nat + 1)
    vols = np.zeros(nat + 1)
    nrefined = 0

    def _field_at_dev(pts_flat):
        """Field values at points (N, 3), field_block points an
        evaluation, left on the device."""
        outs = [fnv(dev64(pts_flat[lo:lo + field_block].T))[0]
                for lo in range(0, len(pts_flat), field_block)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _field_at(pts_flat):
        return _field_at_dev(pts_flat).cpu().numpy()

    def _outside_spheres(pts):
        """1.0 where the point lies outside every atom's beta sphere
        (min-image via the 27-cell target images), else 0.0."""
        ins, _, _ = _sphere_info_dev(pts)
        return np.where(ins.cpu().numpy(), 0.0, 1.0)

    def _keast_contrib(tets_, rule):
        """Keast-rule (integral, volume) per tetrahedron. With beta
        spheres active, sphere interiors are excluded from the cubature
        (they integrate by radial quadrature instead); the volume is then
        the same rule applied to the exterior indicator, so pops and
        vols stay consistent. Only the (T,) sums leave the device."""
        from ..ops.quadrature import keast_points

        qpts, qw = keast_points(tets_, rule)
        T, nq = qw.shape
        fv = _field_at_dev(qpts.reshape(-1, 3)).reshape(T, nq)
        if sphrad is not None:
            ins, _, _ = _sphere_info_dev(qpts.reshape(-1, 3))
            outs = (~ins).to(FDTYPE).reshape(T, nq)
        else:
            outs = torch.ones((T, nq), dtype=FDTYPE, device=dev)
        cs, vs = _masked_keast_reduce(fv, outs, dev64(qw))
        return cs.cpu().numpy(), vs.cpu().numpy()

    def _sphere_integrals(nrad: int = 64, nang: int = 170):
        """Beta-sphere interiors by Gauss-Legendre radial x Lebedev
        angular quadrature - the nuclear cusp never reaches the
        tetrahedral cubature (reference sphere integration role)."""
        from ..ops.lebedev import lebedev

        sph, wang = lebedev(nang)          # wang sums to 1
        xg, wg = np.polynomial.legendre.leggauss(nrad)
        for a in range(nat):
            R = sphrad[a]
            r = 0.5 * R * (xg + 1.0)
            wr = 0.5 * R * wg * 4.0 * np.pi * r * r
            pts = (np.asarray(c.x_cart[a])[None, None, :]
                   + r[:, None, None] * sph[None, :, :]).reshape(-1, 3)
            fv = _field_at(pts).reshape(nrad, len(sph))
            pops[a] += float((fv @ wang) @ wr)
            vols[a] += 4.0 / 3.0 * np.pi * R ** 3

    def accumulate(contrib, volc, col, grp):
        """Retire contributions, replaying each through its orbit's
        atom permutations (the getiws multiplicity role)."""
        colb = np.where(col < 0, nat, col)
        for g in np.unique(grp):
            sel = grp == g
            for perm in orbit_perms[g]:
                np.add.at(pops, perm[colb[sel]], contrib[sel])
                np.add.at(vols, perm[colb[sel]], volc[sel])

    def retire(tets_, col, grp):
        """Integrate uniformly colored tetrahedra."""
        with timed("cubature_s"):
            _retire(tets_, col, grp)

    def _retire(tets_, col, grp):
        nonlocal nrefined
        if len(tets_) == 0:
            return
        if integ == "corner":
            vol = _tet_volume(tets_)
            fv = _field_at(tets_.reshape(-1, 3)).reshape(-1, 4)
            accumulate(vol * fv.mean(axis=1), vol, col, grp)
            return
        # adaptive Keast-pair refinement queue (CUBPACK role), error
        # budgeted: when a depth exceeds max_queue candidates only the
        # worst-error max_queue/8 refine further and the rest retire
        # with the high-order estimate
        cur_t, cur_c, cur_g = tets_, col, grp
        depth = 0
        while len(cur_t):
            hi, volhi = _keast_contrib(cur_t, keastnum)
            lo, _ = _keast_contrib(cur_t, keastlow)
            err = np.abs(hi - lo)
            ok = (err <= cub_abs) | (err <= cub_rel * np.abs(hi))
            if sphrad is not None and depth >= 3:
                # sphere-boundary discontinuity: the Keast pair keeps
                # disagreeing on tets crossing a beta-sphere surface no
                # matter how deep; 3 halvings localize the shell, then
                # the masked high-order estimate retires
                co = _outside_spheres(cur_t.reshape(-1, 3)).reshape(-1, 4)
                crossing = (co.min(axis=1) == 0.0) & (co.max(axis=1) == 1.0)
                ok = ok | crossing
            if depth >= maxrefine:
                ok = np.ones(len(cur_t), dtype=bool)
            elif (~ok).sum() * 8 > max_queue:
                worst = np.argsort(err)[-(max_queue // 8):]
                keep_bad = np.zeros(len(cur_t), dtype=bool)
                keep_bad[worst] = True
                ok = ok | ~keep_bad
            accumulate(hi[ok], volhi[ok], cur_c[ok], cur_g[ok])
            bad = ~ok
            nrefined += int(bad.sum())
            cur_t = _subdivide(cur_t[bad])
            cur_c = np.repeat(cur_c[bad], 8)
            cur_g = np.repeat(cur_g[bad], 8)
            depth += 1

    minl_eff = min(minl, maxl)
    level = 0
    while True:
        if level < minl_eff:
            # below minl the uniformity test is never consulted - no
            # traces needed here, every corner recurs at level minl
            tets = _subdivide(tets)
            gidx = np.repeat(gidx, 8)
            level += 1
            continue
        # trace seeds are nudged toward the centroid (corners on exact
        # symmetry points have zero gradient), but the color CACHE is
        # keyed on the raw corner so tets sharing a vertex share one
        # trace
        centers = tets.mean(axis=1, keepdims=True)
        seeds = tets + 1e-3 * (centers - tets)
        cols = colors_of(tets.reshape(-1, 3),
                         seeds.reshape(-1, 3)).reshape(-1, 4)
        uniform = (cols == cols[:, :1]).all(axis=1)
        retire(tets[uniform], cols[uniform, 0], gidx[uniform])
        tets = tets[~uniform]
        gidx = gidx[~uniform]
        if len(tets) == 0 or level >= maxl:
            if len(tets):
                t_in = clock["trace_s"]
                t0 = time.perf_counter()
                # deepest level: split the mixed (separatrix-crossing)
                # tetrahedra by TRACING the color of every Keast node -
                # the rule then integrates the exactly-masked field
                # (the reference's gradient-path point assignment inside
                # boundary tets, src/qtree_tetrawork.f90 paint/color)
                from ..ops.quadrature import keast_points

                qpts, qw = keast_points(tets, keastnum)
                fv = _field_at(qpts.reshape(-1, 3)).reshape(qw.shape)
                if sphrad is not None and integ != "corner":
                    outs = _outside_spheres(
                        qpts.reshape(-1, 3)).reshape(qw.shape)
                else:
                    outs = np.ones_like(fv)
                ncols = colors_of(qpts.reshape(-1, 3)).reshape(qw.shape)
                if (ncols < 0).any():
                    # unresolved nodes (paths that died at a CP/ridge):
                    # inherit the nearest corner's color rather than
                    # dropping their volume
                    cen = tets.mean(axis=1, keepdims=True)
                    ccols = colors_of(
                        tets.reshape(-1, 3),
                        (tets + 1e-3 * (cen - tets)).reshape(-1, 3)
                    ).reshape(-1, 4)
                    d = np.linalg.norm(qpts[:, :, None, :]
                                       - tets[:, None, :, :], axis=3)
                    near = np.take_along_axis(
                        np.broadcast_to(ccols[:, None, :], d.shape)
                        .reshape(-1, 4),
                        d.argmin(axis=2).reshape(-1, 1), axis=1
                    ).reshape(qw.shape)
                    ncols = np.where(ncols < 0, near, ncols)
                for col in np.unique(ncols):
                    m = (ncols == col) * outs
                    accumulate((fv * qw * m).sum(axis=1),
                               (qw * m).sum(axis=1),
                               np.full(len(tets), col, dtype=int), gidx)
                clock["boundary_s"] += (time.perf_counter() - t0
                                        - (clock["trace_s"] - t_in))
            break
        tets = _subdivide(tets)
        gidx = np.repeat(gidx, 8)
        level += 1

    if sphrad is not None and integ != "corner":
        with timed("sphere_s"):
            _sphere_integrals()

    if usesym and not c.ismolecule:
        # report per symmetry orbit: equivalent atoms share one basin
        # charge (the reference integrates and prints nneq atoms)
        orb = np.asarray(c.spacegroup.orbit_of)
        for o in np.unique(orb):
            sel = np.nonzero(orb == o)[0]
            pops[sel] = pops[sel].mean()
            vols[sel] = vols[sel].mean()

    names = [c.species[c.species_of[q]].name for q in range(nat)]
    return QtreeResult(names=names, pops=pops[:nat], volumes=vols[:nat],
                       nlevels=level, ntraced=ntraced, nrefined=nrefined)
