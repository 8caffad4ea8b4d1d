"""Molecular integration meshes (Becke and Franchini weights).

Role of the reference meshmod (src/meshmod@proc.f90:78-231): per-atom
radial x angular product grids with Becke's fuzzy-cell partition weights
(JCP 88, 2547), radial maps rmesh_postg (r = rmid q/(1-q), rmid =
Z^(-1/3)) and rmesh_franchini, size tables z2nr/z2nang per quality level.
The angular factor is the reference's own Lebedev-Laikov rules
(ops/lebedev).

Mesh points are generated on the host (numpy); the partition weights are
computed on the device: the dense Becke product over (points, atoms,
atoms) in chunks that bound the mu tensor, and above _KNN_NAT_MIN atoms
the mu-threshold neighbour truncation (top-K by the switching argument,
on the device). Meshes come back as host numpy (x, w).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import EDTYPE, FDTYPE, resolve_device

__all__ = ["Mesh", "becke_mesh", "franchini_mesh", "z2nr", "z2nang",
           "product_sphere", "rmesh_postg"]

# Franchini zeta per element (J. Comput. Chem. 34 (2013) 1819 SI),
# as used by the reference rmesh_franchini
_FR_ZETA = np.array([
    0.8, 0.9, 1.8, 1.4, 1.3, 1.1, 0.9, 0.9, 0.9, 0.9,
    1.4, 1.3, 1.3, 1.2, 1.1, 1.0, 1.0, 1.0, 1.5, 1.4,
    1.3, 1.2, 1.2, 1.2, 1.2, 1.2, 1.2, 1.1, 1.1, 1.1,
    1.1, 1.0, 0.9, 0.9, 0.9, 0.9, 1.4, 1.4, 1.1, 1.3,
    1.0, 1.2, 0.9, 0.9, 0.9, 1.0, 0.9, 1.0, 1.0, 1.3,
    1.2, 1.2, 0.9, 1.0, 1.7, 1.5, 1.5, 1.3, 1.3, 1.4,
    1.8, 1.4, 1.2, 1.3, 1.3, 1.4, 1.1, 1.1, 1.2, 1.6,
    1.4, 1.3, 1.2, 1.0, 1.0, 0.9, 1.3, 1.2, 1.2, 1.0,
    1.2, 1.2, 1.1, 1.2, 1.1, 2.1, 2.2, 1.8, 1.7, 1.3,
    1.4, 1.2, 1.2, 1.3, 1.4, 1.4, 1.7, 1.9, 1.9, 2.0,
    2.0, 1.6, 2.0])

_LVL = {"small": 1, "normal": 2, "good": 3, "vgood": 4, "amazing": 5,
        "ultra": 6}  # ultra: beyond the reference's 5 levels
                     # (src/meshmod@proc.f90 z2nr/z2nang stop at
                     # "amazing"); pushes mesh NELEC error under the
                     # 1e-6 basin-charge bar

_KNN_NAT_MIN = 65       # above this, the O(N nat^2) dense Becke path
                        # is replaced by the mu-threshold truncation

_MU_CUT = 0.85    # atoms with switching argument mu_pj <= -_MU_CUT are
                  # excluded from a point's Becke product: near mu = -1
                  # the 4x-iterated polynomial converges as e' = 1.5e^2
                  # (e = 1+mu), so e = 0.15 -> |1 - s| ~ 3e-11 per
                  # excluded atom - a provable per-point bound


def z2nr(z: int, lvl: int = 3) -> int:
    """Radial node count (reference z2nr)."""
    nr = 15
    for thr, val in ((2, 20), (10, 25), (18, 35), (36, 60), (54, 85),
                     (86, 110)):
        if z > thr:
            nr = val
    fac = {1: 2.37, 2: 3.08, 3: 3.42, 4: 4.27, 5: 6.72,
           6: 10.1}[lvl]
    return int(np.ceil(nr * fac))


def z2nang(z: int, lvl: int = 3) -> int:
    """Angular node-count target (reference z2nang; Lebedev sizes)."""
    return {1: 110, 2: 194, 3: 302, 4: 590, 5: 770, 6: 1202}[lvl]


def product_sphere(degree: int):
    """Gauss-Legendre(cos theta) x uniform(phi) sphere rule exact to the
    given polynomial degree; weights sum to 1."""
    nt = (degree + 1) // 2 + 1
    np_phi = degree + 1
    xt, wt = np.polynomial.legendre.leggauss(nt)
    phi = 2 * np.pi * (np.arange(np_phi) + 0.5) / np_phi
    ct = xt[:, None]
    st = np.sqrt(1 - ct ** 2)
    x = (st * np.cos(phi)[None, :]).ravel()
    y = (st * np.sin(phi)[None, :]).ravel()
    z = np.broadcast_to(ct, (nt, np_phi)).ravel()
    w = np.broadcast_to(wt[:, None] / (2 * np_phi), (nt, np_phi)).ravel()
    return np.stack([x, y, z], axis=1), w


def rmesh_postg(n: int, z: int):
    """Radial nodes/weights (reference rmesh_postg): r = rmid q/(1-q)
    on a uniform q in (0,1); weights include 4 pi r^2 dr/dq."""
    rmid = 1.0 / z ** (1.0 / 3.0)
    h = 1.0 / (n + 1)
    q = h * np.arange(1, n + 1)
    r = rmid * q / (1.0 - q)
    w = 4.0 * np.pi * h * r ** 2 * rmid / (1.0 - q) ** 2
    return r, w


@dataclass
class Mesh:
    x: np.ndarray       # (n, 3) Cartesian bohr
    w: np.ndarray       # (n,) quadrature weights (include Becke partition)

    @property
    def n(self):
        return len(self.w)

    def integrate(self, values) -> float:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        return float(np.asarray(values) @ self.w)


def _tdtype(dtype) -> torch.dtype:
    return FDTYPE if np.dtype(dtype) == np.float64 else EDTYPE


def _becke_poly(mu):
    """s = (1 - f(f(f(f(mu))))) / 2, Becke's 4-times iterated step."""
    f = mu
    for _ in range(4):
        f = 1.5 * f - 0.5 * f ** 3
    return 0.5 * (1.0 - f)


def _becke_weights(points, atpos):
    """Becke fuzzy-cell weights (N, nat) of points (N, 3) w.r.t. atoms
    (nat, 3), tensors of one dtype and device."""
    d = torch.linalg.norm(points[:, None, :] - atpos[None, :, :], dim=-1)
    rr = torch.linalg.norm(atpos[:, None, :] - atpos[None, :, :], dim=-1)
    rr = torch.where(rr < 1e-14, torch.ones_like(rr), rr)
    mu = (d[:, :, None] - d[:, None, :]) / rr[None, :, :]
    s = _becke_poly(mu)
    nat = atpos.shape[0]
    eye = torch.eye(nat, dtype=torch.bool, device=points.device)
    s = torch.where(eye[None, :, :], torch.ones_like(s), s)
    P = torch.prod(s, dim=2)                   # (N, nat) cell products
    return P / P.sum(dim=1, keepdim=True)


def _becke_weights_knn(points, atpos, nbr):
    """Becke cell weights restricted to each point's nbr (N, k) atom
    set; returns (N, k) weights aligned with nbr. The caller selects
    nbr by the switching argument mu (see _becke_parent_weights_knn):
    an atom excluded at mu <= -MU_CUT has s -> 1 within ~3e-11, so
    truncating the product changes the partition by < nat * 3e-11 at
    O(N k^2) instead of O(N nat^2) cost."""
    ap = atpos[nbr]                                         # (N, k, 3)
    d = torch.linalg.norm(points[:, None, :] - ap, dim=-1)  # (N, k)
    rr = torch.linalg.norm(ap[:, :, None, :] - ap[:, None, :, :], dim=-1)
    rr = torch.where(rr < 1e-14, torch.ones_like(rr), rr)
    mu = (d[:, :, None] - d[:, None, :]) / rr
    s = _becke_poly(mu)
    k = nbr.shape[1]
    eye = torch.eye(k, dtype=torch.bool, device=points.device)
    s = torch.where(eye[None, :, :], torch.ones_like(s), s)
    P = torch.prod(s, dim=2)
    return P / P.sum(dim=1, keepdim=True)


def _becke_weights_chunked(x, atpos, dtype=np.float64,
                           block: int | None = None,
                           mu_budget_bytes: int = 1 << 30,
                           device=None) -> np.ndarray:
    """Becke cell weights (N, nat) as numpy, chunked on the device so the
    (N, nat, nat) mu tensor stays near mu_budget_bytes (the chunk scales
    with the atom count). dtype=np.float32 is the fast-build route: the
    per-point f32 relative weight error (~1e-7, random sign) cancels in
    quadrature sums."""
    dev = resolve_device(device)
    tdt = _tdtype(dtype)
    atj = torch.as_tensor(np.asarray(atpos, float), dtype=tdt, device=dev)
    n = len(x)
    nat = int(atj.shape[0])
    if block is None:
        per_pt = max(1, nat * nat * np.dtype(dtype).itemsize)
        block = 1 << max(10, min(19, int(np.log2(
            max(1, mu_budget_bytes // per_pt)))))
    out = np.empty((n, nat), dtype)
    for lo in range(0, n, block):
        chunk = torch.as_tensor(np.asarray(x[lo:lo + block], float),
                                dtype=tdt, device=dev)
        out[lo:lo + len(chunk)] = _becke_weights(chunk, atj).cpu().numpy()
    return out


def _franchini_weights(x, vp0, pos_env, fscal):
    d = torch.linalg.norm(x[:, None, :] - pos_env[None, :, :], dim=-1)
    vp = fscal[None, :] * torch.exp(-2.0 * d) \
        / torch.clamp(d, min=1e-10) ** 3
    vpsum = torch.maximum(vp.sum(1), vp0)
    return vp0 / torch.clamp(vpsum, min=1e-40)


def rmesh_franchini(n: int, z: int):
    """Franchini radial map (reference rmesh_franchini):
    r = zeta/ln2 (1+q) ln(2/(1-q)) on Gauss-Legendre q in (-1,1)."""
    zeta = _FR_ZETA[min(max(z, 1), len(_FR_ZETA)) - 1]
    q, w = np.polynomial.legendre.leggauss(n)
    log2 = np.log(2.0)
    r = zeta / log2 * (1.0 + q) * np.log(2.0 / (1.0 - q))
    wr = (4.0 * np.pi * r ** 2 * w * zeta / log2
          * (np.log(2.0 / (1.0 - q)) + (1.0 + q) / (1.0 - q)))
    return r, wr


def franchini_mesh(crystal, lvl="good", rthres: float = 12.0,
                   device=None) -> Mesh:
    """Periodic molecular-style mesh with Franchini weights (reference
    genmesh_franchini, src/meshmod@proc.f90:231-370): per-atom radial x
    angular nodes, cell weight vp = fscal exp(-2r)/r^3 normalized by the
    max over the promolecular-style sum within rthres; fscal = 0.3 for H.
    Works for crystals. Weights on `device` (cuda by default)."""
    from ..ops.lebedev import lebedev

    dev = resolve_device(device)
    if isinstance(lvl, str):
        lvl = _LVL[lvl]
    c = crystal
    zs = np.asarray(c.zatoms)
    # atom images within rthres of the cell for the weight denominators
    pos_env, spc_env, _ = c.atomic_environment(rthres) \
        if not c.ismolecule else (np.asarray(c.x_cart),
                                  np.asarray(c.species_of),
                                  np.arange(c.ncel))
    z_env = np.array([c.species[s].z for s in spc_env], dtype=float)
    fscal_env = np.where(z_env == 1, 0.3, 1.0)

    def t(a):
        return torch.as_tensor(np.asarray(a, float), dtype=FDTYPE,
                               device=dev)

    pos_env_t, fscal_t = t(pos_env), t(fscal_env)
    xs, ws = [], []
    atpos = np.asarray(c.x_cart)
    for i, z in enumerate(zs):
        if z < 1:
            continue
        nr = z2nr(int(z), lvl)
        sph, wang = lebedev(z2nang(int(z), lvl))
        r, wr = rmesh_franchini(nr, int(z))
        fscal = 0.3 if z == 1 else 1.0
        pts = atpos[i][None, None, :] + r[:, None, None] * sph[None, :, :]
        pts = pts.reshape(-1, 3)
        vp0 = fscal * np.exp(-2.0 * r) / np.maximum(r, 1e-10) ** 3
        vp0 = np.repeat(vp0, len(sph))
        wgt = _franchini_weights(t(pts), t(vp0), pos_env_t,
                                 fscal_t).cpu().numpy()
        wtot = (wr[:, None] * wang[None, :]).ravel() * wgt
        xs.append(pts)
        ws.append(wtot)
    return Mesh(x=np.concatenate(xs), w=np.concatenate(ws))


def becke_mesh(crystal, lvl="good", weights_dtype=np.float64,
               device=None) -> Mesh:
    """Generate the Becke molecular mesh (reference genmesh_becke); the
    partition weights are computed on `device` (cuda by default).

    Cached per (crystal, lvl, weights dtype): drivers re-integrate
    several properties over the same mesh. weights_dtype=np.float32 is
    the fast-build route (see _becke_weights_chunked). Meshes of
    _KNN_NAT_MIN atoms or more, or at level amazing and above, are also
    kept on disk in the temporary directory, under a file name of the
    port's own keyed by a hash of (positions, Z, lvl, dtype)."""
    dev = resolve_device(device)
    if isinstance(lvl, str):
        lvl = _LVL[lvl]
    key = (lvl, np.dtype(weights_dtype).name)
    cache = getattr(crystal, "_becke_mesh_cache", None)
    if cache is None:
        cache = {}
        try:
            crystal._becke_mesh_cache = cache
        except Exception:       # frozen dataclass: skip caching
            cache = None
    if cache is not None and key in cache:
        return cache[key]
    m = None
    disk = None
    if len(np.asarray(crystal.x_cart)) >= _KNN_NAT_MIN or lvl >= 5:
        disk = becke_cache_path(crystal, lvl, weights_dtype)
        if os.path.exists(disk):
            try:
                with np.load(disk) as dat:
                    m = Mesh(x=dat["x"], w=dat["w"])
            except Exception:
                m = None
    if m is None:
        m = _becke_mesh_build(crystal, lvl, weights_dtype, dev)
        if disk is not None:
            try:
                np.savez(disk + ".tmp.npz", x=m.x, w=m.w)
                os.replace(disk + ".tmp.npz", disk)
            except Exception:
                pass
    if cache is not None:
        cache[key] = m
    return m


def becke_cache_path(crystal, lvl: int, weights_dtype=np.float64) -> str:
    """The disk-cache file of a Becke mesh: critic2_torch_becke_<hash>.npz
    in the temporary directory (a name the JAX package's cache never
    uses, so neither package reads the other's mesh back)."""
    import hashlib
    import tempfile

    hsh = hashlib.sha256()
    hsh.update(np.round(np.asarray(crystal.x_cart), 9).tobytes())
    hsh.update(np.asarray(crystal.zatoms).tobytes())
    hsh.update(f"{lvl}:{np.dtype(weights_dtype).name}".encode())
    return os.path.join(tempfile.gettempdir(),
                        f"critic2_torch_becke_{hsh.hexdigest()[:16]}.npz")


def _becke_mesh_points(crystal, lvl: int):
    """The radial x Lebedev product points of the Becke mesh (no
    partition weights): (x (N,3), wraw (N,), parent (N,) atom ids)."""
    from ..ops.lebedev import lebedev

    atpos = np.asarray(crystal.x_cart)
    zs = np.asarray(crystal.zatoms)
    xs, ws, parents = [], [], []
    for i, z in enumerate(zs):
        if z < 1:
            continue
        nr = z2nr(int(z), lvl)
        sph, wang = lebedev(z2nang(int(z), lvl))
        r, wr = rmesh_postg(nr, int(z))
        pts = atpos[i][None, None, :] + r[:, None, None] * sph[None, :, :]
        wt = wr[:, None] * wang[None, :]
        xs.append(pts.reshape(-1, 3))
        ws.append(wt.ravel())
        parents.append(np.full(wt.size, i))
    return np.concatenate(xs), np.concatenate(ws), np.concatenate(parents)


def _mu_need_counts(points, atposf, rr, par, mu_cut):
    """Per-point count of atoms with switching argument mu > -mu_cut
    (the parent itself counts, at mu = +inf)."""
    B = points.shape[0]
    d = torch.linalg.norm(points[:, None, :] - atposf[None, :, :], dim=2)
    dp = torch.gather(d, 1, par[:, None])[:, 0]
    rrp = rr[par]
    mu = (dp[:, None] - d) / torch.where(rrp < 1e-14,
                                         torch.ones_like(rrp), rrp)
    mu[torch.arange(B, device=points.device), par] = float("inf")
    return (mu > -mu_cut).sum(dim=1)


def _knn_parent_weight_fused(points64, pointsw, atposf, atposw, rr, par,
                             K: int):
    """mu-threshold neighbour selection (top-K by mu, on the device)
    fused with the Becke parent-weight evaluation. points64/atposf carry
    the f64 geometry for the mu ranking; pointsw/atposw carry the weight
    dtype (f32 fast-build or f64)."""
    B = points64.shape[0]
    dev = points64.device
    d = torch.linalg.norm(points64[:, None, :] - atposf[None, :, :], dim=2)
    dp = torch.gather(d, 1, par[:, None])[:, 0]
    rrp = rr[par]
    mu = (dp[:, None] - d) / torch.where(rrp < 1e-14,
                                         torch.ones_like(rrp), rrp)
    ar = torch.arange(B, device=dev)
    mu[ar, par] = float("inf")
    nat = atposf.shape[0]
    if K >= nat:
        nbr = torch.arange(nat, device=dev).expand(B, nat)
    else:
        nbr = torch.topk(mu, K, dim=1).indices
    ppos = torch.argmax((nbr == par[:, None]).to(torch.int32), dim=1)
    bw = _becke_weights_knn(pointsw, atposw, nbr)
    return bw[ar, ppos]


def _becke_parent_weights_knn(x, atpos, parent, dtype=np.float64,
                              block: int = 1 << 14,
                              mu_cut: float = _MU_CUT,
                              device=None) -> np.ndarray:
    """Parent-atom Becke weight per mesh point via the mu-threshold
    neighbour truncation (used at _KNN_NAT_MIN atoms and above). Each
    point keeps the atoms with switching argument mu_pj > -mu_cut (the
    parent has mu = +inf); points are sorted by their required neighbour
    count and processed in blocks whose K is the block max quantized to
    8 * 2^m (nat once it passes nat/2, where the truncation is empty,
    i.e. exact). Blocks shrink as K grows so the (B, K, K) pair tensor
    stays near 1.5 GB. The host only sorts and scatters."""
    dev = resolve_device(device)
    nat = len(atpos)
    atposf = np.asarray(atpos, float)
    rr = np.linalg.norm(atposf[:, None, :] - atposf[None, :, :], axis=2)
    n = len(x)
    xf = np.asarray(x, float)
    tdt = _tdtype(dtype)
    at64 = torch.as_tensor(atposf, dtype=FDTYPE, device=dev)
    atw = at64.to(tdt)
    rrt = torch.as_tensor(rr, dtype=FDTYPE, device=dev)
    part = torch.as_tensor(np.asarray(parent, np.int64), device=dev)
    xt = torch.as_tensor(xf, dtype=FDTYPE, device=dev)

    need = torch.empty(n, dtype=torch.int64, device=dev)
    for lo in range(0, n, block):
        need[lo:lo + block] = _mu_need_counts(xt[lo:lo + block], at64, rrt,
                                              part[lo:lo + block], mu_cut)
    need = need.cpu().numpy()
    order = np.argsort(need, kind="stable")
    out = np.empty(n, dtype)
    pair_budget = 1.5e9
    isz = np.dtype(dtype).itemsize
    lo = 0
    while lo < n:
        # fixed point: K is the block max's quantized level, bK the
        # largest pow-2 block whose (bK, K, K) tensor fits the budget;
        # shrinking bK drops the highest-need points (the order is
        # need-ascending), so K never grows and the loop terminates
        bK = block
        while True:
            idx = order[lo:lo + bK]
            kmax = int(need[idx].max())
            K = nat if kmax > nat // 2 else min(
                nat, 8 << max(0, int(np.ceil(np.log2(max(1, kmax) / 8)))))
            bK_ok = min(block, max(256, 1 << int(np.floor(np.log2(
                max(256.0, pair_budget / (K * K * isz)))))))
            if bK <= bK_ok:
                break
            bK = bK_ok
        it = torch.as_tensor(idx, device=dev)
        p64 = xt[it]
        out[idx] = _knn_parent_weight_fused(
            p64, p64.to(tdt), at64, atw, rrt, part[it], int(K)).cpu().numpy()
        lo += bK
    return out


def _becke_mesh_build(crystal, lvl: int, weights_dtype=np.float64,
                      device=None) -> Mesh:
    x, wraw, parent = _becke_mesh_points(crystal, lvl)
    atpos = np.asarray(crystal.x_cart)
    if len(atpos) >= _KNN_NAT_MIN:
        wpar = _becke_parent_weights_knn(x, atpos, parent,
                                         dtype=weights_dtype, device=device)
    else:
        bw = _becke_weights_chunked(x, atpos, dtype=weights_dtype,
                                    device=device)
        wpar = bw[np.arange(len(x)), parent]
    w = wraw * wpar
    return Mesh(x=x, w=w)

