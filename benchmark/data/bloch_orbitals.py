"""Data model `bloch_orbitals`: the Kohn-Sham states of a plane-wave
calculation and their wannier90 rotations, as pw2critic.x and a wannier90
.chk hand them to critic2, made from the seed.

Per pool item, on the configuration's crystal, k-point grid and cutoffs:
- the Bloch sums over the atoms of normalised atom-centred Gaussian s and
  p functions (one s and three p a species' shell), their exponents set
  per species and each drawn within +-jitter per item; the plane-wave
  coefficients are the functions' analytic Fourier transforms on each
  k-point's sphere |k+G|^2 < ecutwfc (Ry), Loewdin-orthonormalised per
  k-point, then mixed by a random unitary V(k): the arbitrary gauge in
  which a DFT code returns the states. They are `evc`, complex128 on the
  device, in the pwc layout (nspin, nks, nbnd, npwx);
- the pwc index arrays: the dense G list (|G|^2 < ecutrho, sorted by
  length) with its Miller indices `miller`, `nl` (1-based Fortran-flat
  grid index of each G), `igk_k` (1-based G index of each plane wave of
  each k-point, zero past `ngk`), the Cartesian k-points `kpt` (kpt @ at
  is crystallographic), QE's `wk` (summing to 2) and `occ` (k weight
  times occupation 1: every band is filled);
- the wannier90 data: U(k) = V(k)^H exp(i eps H_k) with H_k a random
  Hermitian matrix, so the Wannier functions are nearly, not exactly, the
  orthonormalised orbitals; centres (angstrom, Cartesian: the orbitals'
  atoms) and spreads (angstrom^2: the Gaussians' <r^2>), and the lattice
  as rows in angstrom.

The grid and k-point arrays are the same for every item of a pool and
shared by them. `check_pool` holds each item to the model's guarantees
with the plain reference (benchmark/reference/deloc.py): the electrons,
the crystal's symmetry, one attractor at each nucleus and nowhere else,
and unitary U(k). It loads nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.lib import density as two_gaussians
from benchmark.reference import deloc as ref_deloc

BOHR_TO_ANGSTROM = 0.52917720859
# a sphere of radius sqrt(ecutwfc) keeps all but this share of each
# function's norm
NORM_LOSS = 1e-6
ELECTRON_RTOL = 1e-10
UNITARY_ATOL = 1e-12
SYM_RTOL = 1e-10


def lattice(cfg) -> np.ndarray:
    """(3, 3) lattice vectors as columns, bohr."""
    return np.asarray(cfg["structure"]["lattice_bohr"], dtype=float)


def orbitals(cfg, x_frac=None) -> list:
    """[(atom, species, kind)] in band order: per atom, its s then p_x,
    p_y, p_z; kind is "s" or 0, 1, 2 (the p direction)."""
    st = cfg["structure"]
    x = np.asarray(st["x_frac"] if x_frac is None else x_frac, dtype=float)
    out = []
    for t in range(len(x)):
        sp = st["species"][st["species_of"][t]]["name"]
        out += [(t, sp, "s"), (t, sp, 0), (t, sp, 1), (t, sp, 2)]
    return out


def _tail(q_over_sigma: float, dof: int) -> float:
    """Share of a dof-dimensional Gaussian's squared norm beyond radius
    q_over_sigma standard deviations (chi survival, dof 3 or 5)."""
    t = q_over_sigma
    base = math.erfc(t / math.sqrt(2.0)) + math.sqrt(2.0 / math.pi) * t \
        * math.exp(-0.5 * t * t)
    if dof == 3:
        return base
    return base + math.sqrt(2.0 / math.pi) * t ** 3 / 3.0 \
        * math.exp(-0.5 * t * t)


def draw(cfg, seed: int, npool: int) -> list:
    """Per item: ({species: {"s": alpha, "p": alpha}} in bohr^-2, the
    numpy generator of the item's gauges)."""
    m = cfg["density"]
    qmax = math.sqrt(float(m["ecutwfc_ry"]))
    out = []
    for i in range(npool):
        rng = np.random.default_rng([abs(int(seed)), int(seed < 0), i])
        ex = {}
        for name, e in sorted(m["species"].items()):
            ex[name] = {}
            for shell in ("s", "p"):
                a = float(e[shell]) * (1.0 + float(m["jitter"])
                                       * rng.uniform(-1.0, 1.0))
                # |FT|^2 of an s (p) Gaussian: 3 (5) degrees, sigma^2 = a
                if _tail(qmax / math.sqrt(a), 3 if shell == "s" else 5) \
                        > NORM_LOSS:
                    raise ValueError(f"{name} {shell} exponent {a} loses "
                                     f"more than {NORM_LOSS} of its norm")
                ex[name][shell] = a
        out.append((ex, rng))
    return out


def plane_waves(cfg) -> dict:
    """The k-point grid and the pwc index arrays of the configuration."""
    m = cfg["density"]
    at = lattice(cfg)
    n = np.asarray(cfg["grid"], dtype=np.int64)
    nk = np.asarray(m["nk"], dtype=np.int64)
    binv = np.linalg.inv(at)                    # rows: b_j / (2 pi)
    # the dense G list: |G|^2 < ecutrho (Ry = bohr^-2), sorted by length
    gcut = float(m["ecutrho_ry"])
    hmax = [int(math.ceil(math.sqrt(gcut) * np.linalg.norm(at[:, i])
                          / (2 * math.pi))) + 1 for i in range(3)]
    mil = np.stack(np.meshgrid(*[np.arange(-h, h + 1) for h in hmax],
                               indexing="ij"), -1).reshape(-1, 3)
    g2 = ((2 * math.pi * mil @ binv) ** 2).sum(1)
    keep = g2 < gcut
    mil, g2 = mil[keep], g2[keep]
    order = np.lexsort((mil[:, 2], mil[:, 1], mil[:, 0], g2))
    mil, g2 = mil[order], g2[order]
    if np.any(2 * np.abs(mil).max(0) >= n):
        raise ValueError(f"grid {n.tolist()} does not hold the G sphere "
                         f"of {gcut} Ry")
    nl = 1 + (mil[:, 0] % n[0]) + n[0] * ((mil[:, 1] % n[1])
                                          + n[1] * (mil[:, 2] % n[2]))
    # Monkhorst-Pack, unshifted, C order over (k1, k2, k3)
    kf = np.stack(np.meshgrid(*[np.arange(v) / v for v in nk],
                              indexing="ij"), -1).reshape(-1, 3)
    wcut = float(m["ecutwfc_ry"])
    ig = []
    for k in kf:
        q2 = ((2 * math.pi * (k[None, :] + mil) @ binv) ** 2).sum(1)
        sel = np.flatnonzero(q2 < wcut)
        ig.append(sel[np.argsort(q2[sel], kind="stable")])
    ngk = np.array([len(v) for v in ig], dtype=np.int64)
    igk = np.zeros((len(kf), int(ngk.max())), dtype=np.int64)
    for i, v in enumerate(ig):
        igk[i, :len(v)] = v + 1
    nks = len(kf)
    wk = np.full(nks, 2.0 / nks)
    return {"at": at, "nk": nk, "n": n, "kf": kf, "kpt": kf @ binv,
            "wk": wk, "miller": mil, "nl": nl, "ngk": ngk, "igk_k": igk}


def _coefficients(cfg, pw, ex, x_frac, ik, device) -> torch.Tensor:
    """(ngk, nbnd) plane-wave coefficients of the Bloch sums at k-point
    ik: FT of each normalised Gaussian at q = k + G times exp(-i q.tau),
    over sqrt(Omega)."""
    at = pw["at"]
    vol = abs(float(np.linalg.det(at)))
    ng = int(pw["ngk"][ik])
    mil = pw["miller"][pw["igk_k"][ik, :ng] - 1]
    f = pw["kf"][ik][None, :] + mil                      # (ng, 3) frac
    q = torch.as_tensor(2 * math.pi * f @ np.linalg.inv(at),
                        device=device)                   # (ng, 3) bohr^-1
    q2 = (q * q).sum(1)
    fr = torch.as_tensor(f, device=device)
    cols = []
    x = np.asarray(x_frac, dtype=float)
    for t, sp, kind in orbitals(cfg, x):
        a = ex[sp]["s" if kind == "s" else "p"]
        # exp(-i q . tau) = exp(-2 pi i (k + G) . x_frac)
        ph = torch.exp(-2j * math.pi * (fr @ torch.as_tensor(
            x[t], device=device)))
        g = (math.pi / a) ** 1.5 * torch.exp(-q2 / (4.0 * a))
        if kind == "s":
            c = (2 * a / math.pi) ** 0.75 * g
        else:
            # p: N x exp(-a r^2), N = (2a/pi)^(3/4) 2 sqrt(a); its FT is
            # N (-i q_x / 2a) (pi/a)^(3/2) exp(-q^2/4a)
            c = (2 * a / math.pi) ** 0.75 * 2 * math.sqrt(a) \
                * (-1j * q[:, kind] / (2 * a)) * g
        cols.append(c * ph / math.sqrt(vol))
    return torch.stack(cols, 1)


def _unitary(rng, n) -> np.ndarray:
    z = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))[None, :]


def _hermitian_exp(rng, n, eps) -> np.ndarray:
    """exp(i eps H), H Hermitian with entries of variance 1/n."""
    z = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) \
        / math.sqrt(2.0 * n)
    h = 0.5 * (z + z.conj().T)
    lam, vec = np.linalg.eigh(h)
    return (vec * np.exp(1j * eps * lam)[None, :]) @ vec.conj().T


def make_item(cfg, pw, ex, rng, device, x_frac=None) -> dict:
    """One item from its exponents and generator; x_frac moves the atoms
    the functions sit on (default: the configuration's)."""
    m = cfg["density"]
    x = np.asarray(cfg["structure"]["x_frac"] if x_frac is None
                   else x_frac, dtype=float)
    orbs = orbitals(cfg, x)
    nb = len(orbs)
    if nb != int(m["bands"]):
        raise ValueError(f"{nb} orbitals for {m['bands']} bands")
    nks = len(pw["kf"])
    npwx = pw["igk_k"].shape[1]
    evc = torch.zeros((1, nks, nb, npwx), dtype=torch.complex128,
                      device=device)
    u = np.empty((nks, nb, nb), dtype=np.complex128)
    for ik in range(nks):
        c = _coefficients(cfg, pw, ex, x, ik, device)    # (ng, nb)
        s = (c.conj().T @ c).cpu().numpy()
        lam, vec = np.linalg.eigh(s)
        v = _unitary(rng, nb)
        # Loewdin S^(-1/2), then the gauge V(k): band j = sum_m V_mj phi_m
        rot = (vec * lam[None, :] ** -0.5) @ vec.conj().T @ v
        ng = int(pw["ngk"][ik])
        evc[0, ik, :, :ng] = (c @ torch.as_tensor(rot, device=device)).T
        u[ik] = v.conj().T @ _hermitian_exp(rng, nb, float(m["epsilon"]))
    at = pw["at"]
    cen = x @ at.T * BOHR_TO_ANGSTROM
    spread = np.array([(3.0 if kind == "s" else 5.0)
                       / (4.0 * ex[sp]["s" if kind == "s" else "p"])
                       for _, sp, kind in orbs]) * BOHR_TO_ANGSTROM ** 2
    return {"evc": evc, "at": at, "nk": pw["nk"], "n": pw["n"],
            "kpt": pw["kpt"], "wk": pw["wk"], "ek": np.zeros((nks, nb)),
            "occ": np.repeat(pw["wk"][:, None], nb, 1),
            "ngk": pw["ngk"], "igk_k": pw["igk_k"], "nl": pw["nl"],
            "miller": pw["miller"], "u": u,
            "centres_ang": cen[[t for t, _, _ in orbs]],
            "spreads_ang2": spread, "rlatt_ang": at.T * BOHR_TO_ANGSTROM,
            "exponents": ex}


def make_pool(cfg, seed: int, npool: int, device) -> list:
    """npool items from the seed (see the module's docstring)."""
    pw = plane_waves(cfg)
    return [make_item(cfg, pw, ex, rng, device)
            for ex, rng in draw(cfg, seed, npool)]


def electrons(cfg) -> float:
    """Electrons of the cell: every band doubly filled."""
    return 2.0 * int(cfg["density"]["bands"])


def check(cfg, item) -> dict:
    """Hold one item to the model's guarantees; returns the readings,
    raises ValueError on a breach."""
    st = cfg["structure"]
    shape = tuple(int(v) for v in cfg["grid"])
    out = {}
    eye = np.eye(item["u"].shape[1])
    out["unitary_gap"] = float(max(
        np.abs(uk @ uk.conj().T - eye).max() for uk in item["u"]))
    if not out["unitary_gap"] <= UNITARY_ATOL:
        raise ValueError(f"U(k) is unitary only to {out['unitary_gap']!r}")
    rho = ref_deloc.density(item, torch.float64)
    vol = abs(float(np.linalg.det(lattice(cfg))))
    z = electrons(cfg)
    out["electrons"] = float(rho.sum()) * vol / float(np.prod(shape))
    if not abs(out["electrons"] - z) <= ELECTRON_RTOL * z:
        raise ValueError(f"the states hold {out['electrons']!r} electrons, "
                         f"the cell {z}")
    # every operation of the crystal maps the density onto itself
    flat = rho.reshape(-1)
    N = flat.numel()
    idx = torch.arange(N, device=rho.device)
    ijk = (idx // (shape[1] * shape[2]), (idx // shape[2]) % shape[1],
           idx % shape[2])
    strides = (shape[1] * shape[2], shape[2], 1)
    worst = torch.zeros((), dtype=rho.dtype, device=rho.device)
    sym = st["symmetry"]
    for rot, tr in zip(sym["rotations"], sym["translations"]):
        A, b = two_gaussians._grid_map(rot, tr, shape)
        # integer sums written out: CUDA has no integer matmul
        j = sum(((sum(int(A[r, c]) * ijk[c] for c in range(3)) + int(b[r]))
                 % shape[r]) * strides[r] for r in range(3))
        worst = torch.maximum(worst, (flat[j] - flat).abs().max())
    out["sym_gap"] = float(worst) / float(flat.max())
    if not out["sym_gap"] <= SYM_RTOL:
        raise ValueError(f"the density breaks the crystal's symmetry by "
                         f"{out['sym_gap']!r} of its maximum")
    # the attractors by the reference's rule are the nuclei
    iattr = ref_deloc.attractors(rho, lattice(cfg))
    x = np.asarray(st["x_frac"], dtype=float) * np.asarray(shape)
    if not np.allclose(x, np.rint(x), atol=1e-9):
        raise ValueError("the atoms are not on grid points")
    xi = np.rint(x).astype(np.int64) % np.asarray(shape)
    nuclei = np.sort(np.ravel_multi_index(xi.T, shape))
    out["attractors"] = len(iattr)
    if not np.array_equal(np.sort(iattr), nuclei):
        raise ValueError(f"{len(iattr)} attractors, not the "
                         f"{len(nuclei)} nuclei")
    return out


def check_pool(cfg, pool, seed: int) -> list:
    """check() on every item, and no two items' states alike."""
    readings = [check(cfg, item) for item in pool]
    for i in range(len(pool)):
        for j in range(i):
            if torch.equal(pool[i]["evc"], pool[j]["evc"]):
                raise ValueError(f"items {j} and {i} of the pool are equal")
    return readings
