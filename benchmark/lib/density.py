"""The benchmark's densities: a smooth atom-centred stand-in for a DFT
code's total valence density on the configuration's grid.

Each species carries two normalised Gaussians, a core-like and a
valence-like one, whose electron counts add up to the species' valence
count. The seed draws, per species and per density of the pool, the core
share and both widths within +-jitter of the nominal values in the
configuration; one draw serves every atom of a species, so the crystal's
symmetry holds. The grid is made on the device by structure factors and
one inverse real FFT:

    rho(G) = (1/V) sum_atoms sum_g n_g exp(-|G|^2 s_g^2 / 2) exp(-i G.r)

so its grid sum times V/N is the electron count to rounding. `check`
holds each density to one maximum per atom, that count, the crystal's
symmetry and a positive minimum; set-up runs it on every density of the
pool.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# widths narrower than this many grid spacings are refused
MIN_WIDTH_SPACINGS = 2.0
# symmetry: largest |rho(g x) - rho(x)| as a share of max rho
SYM_RTOL = 1e-10
# electron count: |sum rho V/N - Z| as a share of Z
COUNT_RTOL = 1e-10
SYM_SAMPLE = 1 << 18


def lattice(cfg) -> np.ndarray:
    """(3, 3) lattice vectors as columns, bohr."""
    return np.asarray(cfg["structure"]["lattice_bohr"], dtype=float)


def grid_spacing(cfg) -> float:
    """Largest grid spacing along an axis, bohr."""
    a = lattice(cfg)
    n = np.asarray(cfg["grid"], dtype=float)
    return float(max(np.linalg.norm(a[:, i]) / n[i] for i in range(3)))


def electrons(cfg) -> float:
    st = cfg["structure"]
    val = {s["name"]: s["valence"] for s in st["species"]}
    return float(sum(val[st["species"][i]["name"]] for i in st["species_of"]))


def draw(cfg, seed: int, npool: int) -> list:
    """Per density of the pool: {species: (n_core, s_core, n_val, s_val)}
    drawn from the seed."""
    model = cfg["density"]
    jit = float(model["jitter"])
    hmin = MIN_WIDTH_SPACINGS * grid_spacing(cfg)
    rng = np.random.default_rng(int(seed))
    out = []
    for _ in range(npool):
        one = {}
        for sp in cfg["structure"]["species"]:
            nom = model["species"][sp["name"]]
            f = rng.uniform(1.0 - jit, 1.0 + jit, size=3)
            share = nom["core_share"] * f[0]
            sc, sv = nom["core_width"] * f[1], nom["valence_width"] * f[2]
            if min(sc, sv) < hmin or not 0.0 < share < 1.0:
                raise ValueError(f"{sp['name']}: widths {sc:.4f}, {sv:.4f} "
                                 f"bohr or core share {share:.4f} out of "
                                 f"range (widths >= {hmin:.4f} bohr)")
            z = float(sp["valence"])
            one[sp["name"]] = (z * share, sc, z * (1.0 - share), sv)
        out.append(one)
    return out


def _structure_factors(cfg, device):
    """|G|^2 on the rfft half grid and, per species, sum_atoms
    exp(-i G.r) (complex128), built from 1-D phase vectors."""
    st = cfg["structure"]
    n1, n2, n3 = (int(v) for v in cfg["grid"])
    a = lattice(cfg)
    b = 2.0 * math.pi * np.linalg.inv(a)          # rows: reciprocal vectors
    gmet = torch.as_tensor(b @ b.T, dtype=torch.float64, device=device)
    h = torch.fft.fftfreq(n1, 1.0 / n1, dtype=torch.float64, device=device)
    k = torch.fft.fftfreq(n2, 1.0 / n2, dtype=torch.float64, device=device)
    ll = torch.arange(n3 // 2 + 1, dtype=torch.float64, device=device)
    m = (h[:, None, None], k[None, :, None], ll[None, None, :])
    g2 = sum(gmet[i, j] * m[i] * m[j] for i in range(3) for j in range(3))
    x = np.asarray(st["x_frac"], dtype=float)
    sf = {}
    for si, sp in enumerate(st["species"]):
        acc = torch.zeros(g2.shape, dtype=torch.complex128, device=device)
        for xa in x[np.asarray(st["species_of"]) == si]:
            e = [torch.exp(-2j * math.pi * float(xa[i]) * v.to(
                torch.complex128)) for i, v in enumerate((h, k, ll))]
            acc += (e[0][:, None] * e[1][None, :])[:, :, None] \
                * e[2][None, None, :]
        sf[sp["name"]] = acc
    return g2, sf


def make_pool(cfg, seed: int, npool: int, device) -> list:
    """npool float64 (n1, n2, n3) densities on `device`, from the seed."""
    shape = tuple(int(v) for v in cfg["grid"])
    vol = abs(float(np.linalg.det(lattice(cfg))))
    npts = float(np.prod(shape))
    g2, sf = _structure_factors(cfg, device)
    pool = []
    for params in draw(cfg, seed, npool):
        spec = torch.zeros(g2.shape, dtype=torch.complex128, device=device)
        for name, (nc, sc, nv, sv) in params.items():
            ff = nc * torch.exp(-0.5 * sc * sc * g2) \
                + nv * torch.exp(-0.5 * sv * sv * g2)
            spec += ff * sf[name]
        pool.append(torch.fft.irfftn(spec * (npts / vol), s=shape))
        del spec
    return pool


def _grid_map(rot, tr, shape):
    """Index map of the fractional symmetry operation x -> R x + t on the
    grid: i' = A i + b (mod n); raises if the grid is not mapped onto
    itself."""
    n = np.asarray(shape, dtype=float)
    A = np.asarray(rot, dtype=float) * n[:, None] / n[None, :]
    b = np.asarray(tr, dtype=float) * n
    if not (np.allclose(A, np.rint(A), atol=1e-9)
            and np.allclose(b, np.rint(b), atol=1e-9)):
        raise ValueError("a symmetry operation does not map the grid onto "
                         "itself")
    return np.rint(A).astype(np.int64), np.rint(b).astype(np.int64)


def local_maxima(rho) -> torch.Tensor:
    """Flat indices of the points above all 26 neighbours (periodic)."""
    ismax = torch.ones(rho.shape, dtype=torch.bool, device=rho.device)
    for d in [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
              for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)]:
        ismax &= rho > torch.roll(rho, d, (0, 1, 2))
    return torch.nonzero(ismax.reshape(-1)).reshape(-1)


def check(cfg, rho, seed: int = 0) -> dict:
    """Hold one density to the generator's guarantees; returns the
    readings, raises ValueError on a breach."""
    st = cfg["structure"]
    shape = tuple(int(v) for v in cfg["grid"])
    a = lattice(cfg)
    vol = abs(float(np.linalg.det(a)))
    z = electrons(cfg)
    out = {}
    out["electrons"] = float(rho.sum()) * vol / float(np.prod(shape))
    if abs(out["electrons"] - z) > COUNT_RTOL * z:
        raise ValueError(f"density holds {out['electrons']!r} electrons, "
                         f"the cell {z}")
    out["min"] = float(rho.min())
    if not out["min"] > 0.0:
        raise ValueError(f"density minimum {out['min']!r} is not positive")
    # one maximum per atom, each the nearest grid maximum to its atom
    imax = local_maxima(rho).cpu().numpy()
    out["maxima"] = len(imax)
    x = np.asarray(st["x_frac"], dtype=float)
    if len(imax) != len(x):
        raise ValueError(f"{len(imax)} density maxima for {len(x)} atoms")
    xm = np.stack(np.unravel_index(imax, shape), 1) / np.asarray(shape)
    d = xm[:, None, :] - x[None, :, :]
    d -= np.rint(d)
    dist = np.linalg.norm(d @ a.T, axis=2)            # (maxima, atoms)
    nearest = dist.argmin(1)
    if len(set(nearest.tolist())) != len(x):
        raise ValueError("two density maxima share the nearest atom")
    out["max_offset_bohr"] = float(dist.min(1).max())
    # invariance under the crystal's operations, on a sample of points
    g = torch.Generator(device="cpu").manual_seed(int(seed) % (1 << 63))
    N = int(np.prod(shape))
    flat = rho.reshape(-1)
    idx = torch.randint(0, N, (min(N, SYM_SAMPLE),), generator=g).to(
        rho.device)
    ijk = (idx // (shape[1] * shape[2]), (idx // shape[2]) % shape[1],
           idx % shape[2])
    strides = (shape[1] * shape[2], shape[2], 1)
    worst = torch.zeros((), dtype=rho.dtype, device=rho.device)
    sym = st["symmetry"]
    for rot, tr in zip(sym["rotations"], sym["translations"]):
        A, b = _grid_map(rot, tr, shape)
        # integer sums written out: CUDA has no integer matmul
        j = sum(((sum(int(A[r, c]) * ijk[c] for c in range(3)) + int(b[r]))
                 % shape[r]) * strides[r] for r in range(3))
        worst = torch.maximum(worst, (flat[j] - flat[idx]).abs().max())
    worst = float(worst)
    out["sym_gap"] = worst / float(flat.max())
    if out["sym_gap"] > SYM_RTOL:
        raise ValueError(f"density breaks the crystal's symmetry by "
                         f"{out['sym_gap']!r} of its maximum")
    return out


def check_pool(cfg, pool, seed: int) -> list:
    """check() on every density, and no two densities alike."""
    readings = [check(cfg, rho, seed + i) for i, rho in enumerate(pool)]
    for i in range(len(pool)):
        for j in range(i):
            if torch.equal(pool[i], pool[j]):
                raise ValueError(f"densities {j} and {i} of the pool are "
                                 "equal")
    return readings
