"""Molecular integrals over primitive Cartesian Gaussians
(McMurchie-Davidson) and the RHF energy.

Role of the reference's optional libCINT hookup (molcalc HF,
src/molcalc@proc.F90:238-404; cint setup src/wfn_private@proc.F90:
1290-1356): overlap/kinetic/nuclear-attraction/ERI integrals over the
wavefunction's primitive basis and the Hartree-Fock total energy.

Implementation: McMurchie-Davidson Hermite expansion, batched over all
primitive pairs at once as f64 PyTorch ops on the device (the E/R
recursions unroll in Python over the small angular-momentum ranges). The
ERI matrix over symmetry-reduced primitive pairs is filled block by
block in device memory and consumed there as matrix contractions against
density and MO pair vectors. Supported angular momentum: l <= 5 (s, p,
d, f, g, h), the ceiling of the reference's primitive-type table
(src/wfn_private@proc.F90:2695-2705); higher shells raise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

__all__ = ["boys", "rhf_energy", "overlap_kinetic_nuclear", "eri_matrix"]


def _li():
    from ..fields.wfn import _LI

    return _LI


def _t(a, dev, dtype=FDTYPE):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# Boys function F_n(T), vectorized and stable
# ---------------------------------------------------------------------------
def boys(nmax: int, T):
    """F_n(T) for n = 0..nmax; T (...,) >= 0. Returns (nmax+1, ...).

    T < 18: downward recursion from a 70-term series at n = nmax + 12;
    T >= 18: F_0 = sqrt(pi/4T) erf(sqrt T) and upward recursion.
    """
    T = torch.as_tensor(T, dtype=FDTYPE)
    Tsafe = torch.clamp(T, min=1e-30)
    expT = torch.exp(-T)

    # series at high order:
    # F_m(T) = exp(-T) sum_k (2T)^k / (2m+1)(2m+3)...(2m+2k+1)
    mtop = nmax + 12
    term = torch.full_like(T, 1.0 / (2.0 * mtop + 1.0))
    acc = term
    t2 = 2.0 * torch.clamp(Tsafe, max=18.0)
    for k in range(1, 70):
        term = term * t2 / (2.0 * mtop + 2.0 * k + 1.0)
        acc = acc + term
    Ftop = expT * acc

    # downward: F_m = (2T F_{m+1} + exp(-T)) / (2m+1)
    Fs_down = [None] * (mtop + 1)
    Fs_down[mtop] = Ftop
    for m in range(mtop - 1, -1, -1):
        Fs_down[m] = (2.0 * Tsafe * Fs_down[m + 1] + expT) / (2.0 * m + 1.0)

    # upward from the exact F_0 (stable for 2T > 2n-1; used for T >= 18)
    F0_big = 0.5 * torch.sqrt(math.pi / Tsafe) * torch.special.erf(
        torch.sqrt(Tsafe))
    Fs_up = [F0_big]
    for m in range(nmax):
        Fs_up.append(((2.0 * m + 1.0) * Fs_up[m] - expT) / (2.0 * Tsafe))

    big = T >= 18.0
    return torch.stack([torch.where(big, Fs_up[m], Fs_down[m])
                        for m in range(nmax + 1)])


# ---------------------------------------------------------------------------
# Hermite expansion coefficients
# ---------------------------------------------------------------------------
def _E_tables(imax, jmax, a, b, A, B):
    """E_t^{ij} per direction for all pairs: {d: {(i, j, t): (npair,)}}.
    a, b (npair,); A, B (npair, 3) centers."""
    p = a + b
    mu = a * b / p
    E = {}
    for d in range(3):
        AB = A[:, d] - B[:, d]
        PA = -(b / p) * AB
        PB = (a / p) * AB
        tab = {(0, 0, 0): torch.exp(-mu * AB * AB)}

        def get(i, j, t):
            if t < 0 or t > i + j:
                return 0.0
            return tab[(i, j, t)]

        for i in range(imax + 1):
            for j in range(jmax + 1):
                if i == 0 and j == 0:
                    continue
                for t in range(i + j + 1):
                    if j == 0:
                        val = (get(i - 1, j, t - 1) / (2.0 * p)
                               + PA * get(i - 1, j, t)
                               + (t + 1) * get(i - 1, j, t + 1))
                    else:
                        val = (get(i, j - 1, t - 1) / (2.0 * p)
                               + PB * get(i, j - 1, t)
                               + (t + 1) * get(i, j - 1, t + 1))
                    tab[(i, j, t)] = val
        E[d] = tab
    return E


def _full_table(Ed, imax, jmax, tmax, npair, like):
    """The (imax+1, jmax+1, tmax+1, npair) table of one direction."""
    full = torch.zeros((imax + 1, jmax + 1, tmax + 1, npair),
                       dtype=FDTYPE, device=like.device)
    for (i, j, t), v in Ed.items():
        full[i, j, t] = v
    return full


def _select_E(E, li_a, li_b, imax, jmax, tmax):
    """Per-pair E arrays selected at the pair's angular momenta:
    returns (3, tmax+1, npair) with zeros past t > i+j. li_a, li_b
    (npair, 3) int64 tensors."""
    npair = li_a.shape[0]
    ar = torch.arange(npair, device=li_a.device)
    out = []
    for d in range(3):
        full = _full_table(E[d], imax, jmax, tmax, npair, li_a)
        out.append(full[li_a[:, d], li_b[:, d], :, ar].T)
    return torch.stack(out)


def _hermite_components(L):
    """All (t, u, v) with t+u+v <= L, ordered; returns list of tuples."""
    return [(t, u, v) for t in range(L + 1) for u in range(L + 1 - t)
            for v in range(L + 1 - t - u)]


def _R_tensor(L, p, PC, Fns):
    """Hermite Coulomb integrals R_{tuv} for all t+u+v <= L.

    p (...,); PC (..., 3); Fns (L+1, ...) Boys values of argument p|PC|^2.
    Returns dict (t,u,v) -> (...,). Recursion via auxiliary R^n.
    """
    Rn = {}
    for n in range(L + 1):
        Rn[(n, 0, 0, 0)] = (-2.0 * p) ** n * Fns[n]

    def build(n, t, u, v):
        key = (n, t, u, v)
        if key in Rn:
            return Rn[key]
        if t > 0:
            val = (t - 1) * build(n + 1, t - 2, u, v) if t > 1 else 0.0
            val = val + PC[..., 0] * build(n + 1, t - 1, u, v)
        elif u > 0:
            val = (u - 1) * build(n + 1, t, u - 2, v) if u > 1 else 0.0
            val = val + PC[..., 1] * build(n + 1, t, u - 1, v)
        else:
            val = (v - 1) * build(n + 1, t, u, v - 2) if v > 1 else 0.0
            val = val + PC[..., 2] * build(n + 1, t, u, v - 1)
        Rn[key] = val
        return val

    return {c: build(0, *c) for c in _hermite_components(L)}


def _powers(wfn):
    li = _li()[wfn.itype - 1]                     # (P, 3) powers
    lmax = int(li.max())
    if lmax > 5:
        raise NotImplementedError("molecular integrals support l <= 5 "
                                  "(s, p, d, f, g, h) for now")
    return li, lmax


def _all_pairs(wfn, dev):
    """Every ordered primitive pair (P*P of them): exponents, centres
    and powers of both members."""
    li, lmax = _powers(wfn)
    P = wfn.npri
    ii, jj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    ctr = np.asarray(wfn.atpos)[wfn.icenter]
    al = np.asarray(wfn.e, float)
    return (li, lmax, _t(al[ii], dev), _t(al[jj], dev), _t(ctr[ii], dev),
            _t(ctr[jj], dev), _t(li[ii], dev, torch.int64),
            _t(li[jj], dev, torch.int64))


# ---------------------------------------------------------------------------
# 1-electron integrals (full P x P)
# ---------------------------------------------------------------------------
def overlap_kinetic_nuclear(wfn, *, device=None):
    """S, T, V matrices over the primitives of a Wavefunction (P, P),
    f64 tensors on `device` (cuda by default)."""
    dev = resolve_device(device)
    li, lmax, a, b, A, B, la, lb = _all_pairs(wfn, dev)
    P = wfn.npri
    npair = a.shape[0]
    p = a + b
    ar = torch.arange(npair, device=dev)

    imax, jmax = lmax, lmax + 2                    # kinetic needs j+2
    E = _E_tables(imax, jmax, a, b, A, B)
    root = torch.sqrt(math.pi / p)
    full0 = []
    for d in range(3):
        f0 = torch.zeros((imax + 1, jmax + 1, npair), dtype=FDTYPE,
                         device=dev)
        for (i, j, t), v in E[d].items():
            if t == 0:
                f0[i, j] = v
        full0.append(f0)

    def S1(d, shift):
        """1-D overlaps at (i, j + shift)."""
        jn = lb[:, d] + shift
        jsel = torch.clamp(jn, 0, jmax)
        valid = (jn >= 0) & (jn <= jmax)
        out = full0[d][la[:, d], jsel, ar] * root
        return torch.where(valid, out, torch.zeros_like(out))

    Sx, Sy, Sz = S1(0, 0), S1(1, 0), S1(2, 0)
    S = (Sx * Sy * Sz).reshape(P, P)

    # 1-D kinetic: T_x = b(2j+1) S(i,j) - 2b^2 S(i,j+2) - j(j-1)/2 S(i,j-2)
    def T1(d):
        j = lb[:, d].to(FDTYPE)
        return (b * (2.0 * j + 1.0) * S1(d, 0)
                - 2.0 * b * b * S1(d, 2)
                - 0.5 * j * (j - 1.0) * S1(d, -2))

    T = (T1(0) * Sy * Sz + Sx * T1(1) * Sz + Sx * Sy * T1(2)).reshape(P, P)

    # nuclear attraction
    Ppos = (a[:, None] * A + b[:, None] * B) / p[:, None]
    comps = _hermite_components(2 * lmax)
    Esel = _select_E(E, la, lb, imax, jmax, imax + jmax)
    V = torch.zeros(npair, dtype=FDTYPE, device=dev)
    for z, xc in zip(wfn.atz, np.asarray(wfn.atpos)):
        PC = Ppos - _t(xc, dev)[None, :]
        Fns = boys(2 * lmax, p * (PC * PC).sum(1))
        R = _R_tensor(2 * lmax, p, PC, Fns)
        acc = 0.0
        for (t, u, v) in comps:
            acc = acc + Esel[0, t] * Esel[1, u] * Esel[2, v] * R[(t, u, v)]
        V = V - float(z) * (2.0 * math.pi / p) * acc
    return S, T, V.reshape(P, P)


def _rinv_setup(wfn, dev):
    li, lmax, a, b, A, B, la, lb = _all_pairs(wfn, dev)
    p = a + b
    E = _E_tables(lmax, lmax, a, b, A, B)
    Esel = _select_E(E, la, lb, lmax, lmax, 2 * lmax)
    comps = _hermite_components(2 * lmax)
    coef = [(c, Esel[0, c[0]] * Esel[1, c[1]] * Esel[2, c[2]])
            for c in comps]
    Ppos = (a[:, None] * A + b[:, None] * B) / p[:, None]
    return lmax, p, Ppos, coef


def _rinv_block(setup, pts):
    """<mu| 1/|r - c| |nu> for the points pts (c, 3): (c, P*P)."""
    lmax, p, Ppos, coef = setup
    PC = Ppos[None, :, :] - pts[:, None, :]        # (c, npair, 3)
    Fns = boys(2 * lmax, p[None, :] * (PC * PC).sum(-1))
    R = _R_tensor(2 * lmax, p[None, :], PC, Fns)
    acc = 0.0
    for c, e in coef:
        acc = acc + e[None, :] * R[c]
    return (2.0 * math.pi / p)[None, :] * acc


def _rinv_chunks(wfn, points, chunk, device=None):
    """(lo, (c, P, P) block) of rinv_pairs over the points, `chunk`
    points a block."""
    pts = points if isinstance(points, torch.Tensor) else \
        _t(np.asarray(points, float).reshape(-1, 3), resolve_device(device))
    pts = pts.to(FDTYPE).reshape(-1, 3)
    setup = _rinv_setup(wfn, pts.device)
    P = wfn.npri
    for lo in range(0, pts.shape[0], chunk):
        blk = _rinv_block(setup, pts[lo:lo + chunk])
        yield lo, blk.reshape(-1, P, P)


def rinv_pairs(wfn, points, chunk: int = 8, *, device=None):
    """Batched <mu| 1/|r - c| |nu> over primitives, (B, P, P) f64 tensor
    on the points' device (a numpy input goes to `device`, cuda by
    default).

    The electron-repulsion-at-a-point integrals behind MEP and the
    Slater potential (reference mep/uslater,
    src/wfn_private@proc.F90:2231-2309 and :2311-2420, which call
    libCINT's CINT1e_rinv; here the same McMurchie-Davidson E x R
    assembly as the nuclear-attraction term, with the charge center at
    each evaluation point and no -Z factor)."""
    return torch.cat([blk for _, blk in
                      _rinv_chunks(wfn, points, chunk, device)])


# ---------------------------------------------------------------------------
# 2-electron integrals and the RHF energy
# ---------------------------------------------------------------------------
def _pair_data(wfn, dev):
    li, lmax = _powers(wfn)
    P = wfn.npri
    iu, ju = np.triu_indices(P)
    ctr = np.asarray(wfn.atpos)[wfn.icenter]
    al = np.asarray(wfn.e, float)
    a, b = _t(al[iu], dev), _t(al[ju], dev)
    A, B = _t(ctr[iu], dev), _t(ctr[ju], dev)
    p = a + b
    Ppos = (a[:, None] * A + b[:, None] * B) / p[:, None]
    E = _E_tables(lmax, lmax, a, b, A, B)
    Esel = _select_E(E, _t(li[iu], dev, torch.int64),
                     _t(li[ju], dev, torch.int64), lmax, lmax, 2 * lmax)
    comps = _hermite_components(2 * lmax)
    # Hermite charges (ncomp, npair)
    om = torch.stack([Esel[0, t] * Esel[1, u] * Esel[2, v]
                      for (t, u, v) in comps])
    return iu, ju, p, Ppos, om, comps, 2 * lmax


def _R_step(cur, PQ, t, u, v):
    """One level of the Hermite recursion R_{tuv} from the level above
    it (cur), for a component with t+u+v > 0."""
    if t > 0:
        val = PQ[..., 0] * cur.get((t - 1, u, v), 0.0)
        if t > 1:
            val = val + (t - 1) * cur.get((t - 2, u, v), 0.0)
    elif u > 0:
        val = PQ[..., 1] * cur.get((t, u - 1, v), 0.0)
        if u > 1:
            val = val + (u - 1) * cur.get((t, u - 2, v), 0.0)
    else:
        val = PQ[..., 2] * cur.get((t, u, v - 1), 0.0)
        if v > 1:
            val = val + (v - 1) * cur.get((t, u, v - 2), 0.0)
    return val


def _block_prelude(pA, PA, pB, PB, L2):
    alpha = pA[:, None] * pB[None, :] / (pA[:, None] + pB[None, :])
    PQ = PA[:, None, :] - PB[None, :, :]
    T = alpha * (PQ * PQ).sum(-1)
    Fns = boys(L2, T)
    pref = 2.0 * math.pi ** 2.5 / (pA[:, None] * pB[None, :]
                                   * torch.sqrt(pA[:, None] + pB[None, :]))
    return alpha, PQ, T, Fns, pref


def _make_eri_block(comps):
    """ERI block function for the given Hermite component list: the
    component loops unroll in Python, and the R tensor builds level by
    level with on-the-fly contraction, so that only two recursion levels
    are ever alive."""
    L2 = 2 * max(sum(c) for c in comps)
    # m+n component pairs grouped by combined component
    grouped = {}
    for m, cm in enumerate(comps):
        for n, cn in enumerate(comps):
            c = (cm[0] + cn[0], cm[1] + cn[1], cm[2] + cn[2])
            sgn = (-1.0) ** sum(cn)
            grouped.setdefault(c, []).append((m, n, sgn))

    def block_fn(pA, PA, omA, pB, PB, omB):
        alpha, PQ, T, Fns, pref = _block_prelude(pA, PA, pB, PB, L2)
        # level n = L2 down to 1; keep only the current level
        cur = {(0, 0, 0): (-2.0 * alpha) ** L2 * Fns[L2]}
        for n in range(L2 - 1, 0, -1):
            nxt = {}
            for c in _hermite_components(L2 - n):
                nxt[c] = (_R_step(cur, PQ, *c) if sum(c) else
                          (-2.0 * alpha) ** n * Fns[n])
            cur = nxt

        out = torch.zeros_like(T)
        for c, terms in grouped.items():
            R0 = _R_step(cur, PQ, *c) if sum(c) else Fns[0]
            W = 0.0
            for (m, n, sgn) in terms:
                W = W + sgn * omA[m][:, None] * omB[n][None, :]
            out = out + W * R0
        return pref * out

    return block_fn


def _make_eri_block_gather(comps):
    """Gather/einsum ERI block for high angular momentum: all combined R
    components stack into one tensor and each bra component contracts
    against a gathered slice - a few large ops instead of thousands of
    outer products."""
    L2 = 2 * max(sum(c) for c in comps)
    all_c = _hermite_components(L2)
    cindex = {c: i for i, c in enumerate(all_c)}
    nm = len(comps)
    G = np.zeros((nm, nm), dtype=np.int64)
    for m, cm in enumerate(comps):
        for n, cn in enumerate(comps):
            G[m, n] = cindex[(cm[0] + cn[0], cm[1] + cn[1],
                              cm[2] + cn[2])]
    signs = np.array([(-1.0) ** sum(c) for c in comps])

    def block_fn(pA, PA, omA, pB, PB, omB):
        alpha, PQ, T, Fns, pref = _block_prelude(pA, PA, pB, PB, L2)
        R = _R_tensor(L2, alpha, PQ, Fns)
        R_all = torch.stack([R[c] for c in all_c])     # (NCC, nA, nB)
        omBs = omB * _t(signs, omB.device)[:, None]     # (nm, nB)
        Gt = _t(G, omB.device, torch.int64)
        out = torch.zeros_like(T)
        for m in range(nm):
            part = torch.einsum("nab,nb->ab", R_all[Gt[m]], omBs)
            out = out + omA[m][:, None] * part
        return pref * out

    return block_fn


def eri_matrix(wfn, block: int | None = None, *, device=None):
    """Symmetric-pair ERI matrix M[(p<=q),(r<=s)] = (pq|rs), an f64
    tensor in the memory of `device` (cuda by default)."""
    dev = resolve_device(device)
    iu, ju, p, Ppos, om, comps, Lc2 = _pair_data(wfn, dev)
    npair = len(iu)
    if Lc2 > 8:
        block = block or 16
        block_fn = _make_eri_block_gather(comps)
    else:
        block = block or 64
        block_fn = _make_eri_block(comps)
    M = torch.empty((npair, npair), dtype=FDTYPE, device=dev)
    for lo in range(0, npair, block):
        sl = slice(lo, min(lo + block, npair))
        M[sl] = block_fn(p[sl], Ppos[sl], om[:, sl], p, Ppos, om)
    return M


def rhf_energy(wfn, block: int = 256, *, device=None):
    """HF total energy from the wavefunction's MO coefficients
    (no SCF: the fchk orbitals are already converged). Returns a dict
    with E_total, E1, E_J, E_K, E_nn (floats); everything is computed on
    `device` (cuda by default) in f64.

    RHF and fractional closed-shell occupations use the spin-summed
    exchange factor occ_i occ_j / 4; UHF restricts exchange to
    same-spin pairs (alpha MOs first, wfn.nalpha of them) with factor
    occ_i occ_j / 2 (reference molcalc_hfenergy is RHF-only,
    src/molcalc@proc.F90:243-299 - UHF is an extension here).
    """
    from ..fields.wfn import _full_f32

    dev = resolve_device(device)
    uhf = wfn.wfntyp == "uhf"
    with _full_f32(True):
        S, T, V = overlap_kinetic_nuclear(wfn, device=dev)
        C = _t(wfn.cmo, dev)                           # (M, P) occupied
        occ = _t(wfn.occ, dev)
        Pmat = torch.einsum("m,mp,mq->pq", occ, C, C)  # total density
        E1 = float((Pmat * (T + V)).sum())

        M = eri_matrix(wfn, block=block, device=dev)
        iu, ju = np.triu_indices(wfn.npri)
        iut, jut = _t(iu, dev, torch.int64), _t(ju, dev, torch.int64)
        w = _t(np.where(iu == ju, 1.0, 2.0), dev)

        # Coulomb: 1/2 sum P_pq P_rs (pq|rs)
        u = Pmat[iut, jut] * w
        E_J = 0.5 * float(u @ (M @ u))

        # Exchange: -1/4 sum P_pr P_qs (pq|rs), via occupied MO pairs:
        # E_K = -sum_{ordered ij} occ_i occ_j / 4 (ij|ij)  [RHF]
        nmo = wfn.nmo
        I, J = np.triu_indices(nmo)
        occn = np.asarray(wfn.occ, float)
        if uhf:
            spin = (np.arange(nmo) >= wfn.nalpha).astype(int)
            same = spin[I] == spin[J]
            I, J = I[same], J[same]
            base = occn[I] * occn[J] / 2.0
        else:
            base = occn[I] * occn[J] / 4.0
        factors = _t(np.where(I == J, 1.0, 2.0) * base, dev)
        Ci = C[_t(I, dev, torch.int64)]
        Cj = C[_t(J, dev, torch.int64)]
        Bm = Ci[:, iut] * Cj[:, jut] + Ci[:, jut] * Cj[:, iut]
        Bm = torch.where((iut == jut)[None, :], 0.5 * Bm, Bm)
        K_ij = ((Bm @ M) * Bm).sum(1)
        E_K = -float(factors @ K_ij)

    # nuclear repulsion
    E_nn = 0.0
    for i in range(len(wfn.atz)):
        for j in range(i + 1, len(wfn.atz)):
            E_nn += float(wfn.atz[i]) * float(wfn.atz[j]) / float(
                np.linalg.norm(wfn.atpos[i] - wfn.atpos[j]))

    E = E1 + E_J + E_K + E_nn
    return {"E_total": E, "E1": E1, "E_J": E_J, "E_K": E_K, "E_nn": E_nn}
