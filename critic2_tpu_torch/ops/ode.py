"""Batched gradient-path tracing (device).

Role of the reference gradient/adaptive_stepper
(src/fieldmod@proc.f90:2076-2399): trace dx/ds = +-grad f / |grad f| with
the Bogacki-Shampine 2(3) embedded pair (the reference default,
src/global@proc.f90:104-107: step 0.3, maxerr 1e-4, gradeps 1e-7),
terminating at attractor points (nuclei / CPs of the right type, within
min(0.1, h/2)), at new CPs (|grad| < gradeps), on step collapse, or on
leaving the molecular cell.

Decomposition: the reference traces one path at a time inside OpenMP
loops; here all paths advance in lockstep with per-trajectory step sizes,
accept/reject masks and termination states - each iteration is one BS23
attempt costing three batched field evaluations for every live lane.

Loop structure (one stepper, built like ops/newton.py): segments of
`chunk` attempts are enqueued on the device with no host read inside a
segment; the host reads the `done` mask once per segment. When at most
half the working lanes are still live, the finished lanes' results are
scattered into preallocated output tensors and the live lanes are
gathered, exactly, into a smaller working batch - all on the device.
Lanes are independent, so the result does not depend on the packing.

Precision: tracing is float64. The unit direction is gf / (|gf| + 1e-80)
and the guard is zero in float32, so float32 seeds or evaluators are
refused at entry.

Status codes: 0 = reached attractor (termid >= 0), 1 = converged to a
gradient zero away from the list, 2 = step collapse/bounce, 3 = left the
molecular cell, 4 = ran out of steps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["trace_paths", "trace_paths_recorded", "trace_paths_screened",
           "STAT_ATTRACTOR",
           "STAT_NEWCP", "STAT_STUCK", "STAT_ESCAPED", "STAT_MAXSTEP",
           "STAT_OOR"]

STAT_ATTRACTOR = 0
STAT_NEWCP = 1
STAT_STUCK = 2
STAT_ESCAPED = 3
STAT_MAXSTEP = 4
STAT_OOR = 5      # left a screened chunk's validity sphere (resumable:
                  # trace_paths_screened re-plans and continues)

COMPACT_MIN = 256          # working batches at or below this never pack
TARGET_BLOCK = 1 << 26     # most (lane, target) distances formed at once


@dataclass
class _Setup:
    """What one trace holds fixed: the evaluator, the targets and the
    stepper's tolerances."""

    eval_fn: object
    sgn: float
    tT: torch.Tensor | None      # (3, K) targets
    rt: torch.Tensor | None      # (K,) termination radii
    m_c2x: torch.Tensor | None   # molecular-cell escape (downhill only)
    molborder: torch.Tensor | None
    ecent: torch.Tensor | None   # (3,) centre of the escape sphere
    erad: float
    hini: float
    maxerr: float
    gradeps: float

    def direction(self, xT):
        _, gf, _ = self.eval_fn(xT)
        gmod = torch.sqrt((gf * gf).sum(0))
        return self.sgn * gf / (gmod + 1e-80)[None, :], gmod

    def nearest_target(self, xT):
        """(index, distance) of each lane's nearest target; the (N, K)
        distance matrix is formed TARGET_BLOCK entries at a time."""
        K = self.tT.shape[1]
        step = max(1, TARGET_BLOCK // K)
        ks, ds = [], []
        for lo in range(0, xT.shape[1], step):
            x = xT[:, lo:lo + step]
            d2 = ((x[:, :, None] - self.tT[:, None, :]) ** 2).sum(0)
            dmin, k = d2.min(dim=1)
            ks.append(k)
            ds.append(torch.sqrt(dmin))
        if len(ks) == 1:
            return ks[0], ds[0]
        return torch.cat(ks), torch.cat(ds)


def _attempt(su: _Setup, st):
    """One BS23 attempt over the whole working batch: st -> st."""
    xT, h, done, status, termid, plen, d1, gmod = st

    def mark(mask, code, status):
        return torch.where(mask, torch.full_like(status, code), status)

    # termination: gradient zero (new CP)
    cp_now = (gmod < su.gradeps) & ~done
    status = mark(cp_now, STAT_NEWCP, status)
    done = done | cp_now

    # termination: attractor proximity
    if su.tT is not None:
        k, dist = su.nearest_target(xT)
        hit = (dist <= torch.maximum(su.rt[k], 0.5 * h.abs())) & ~done
        xT = torch.where(hit[None, :], su.tT[:, k], xT)
        plen = torch.where(hit, plen + dist, plen)
        termid = torch.where(hit, k, termid)
        status = mark(hit, STAT_ATTRACTOR, status)
        done = done | hit

    # termination: left the molecular cell (downhill only)
    if su.m_c2x is not None and su.sgn < 0:
        wx = su.m_c2x @ xT
        out = ((wx < su.molborder[:, None]) |
               (wx > 1.0 - su.molborder[:, None])).any(0) & ~done
        status = mark(out, STAT_ESCAPED, status)
        done = done | out

    # pause: left the screened chunk's validity sphere (the block table
    # no longer covers the field here) - resumable
    if su.ecent is not None:
        oor = (((xT - su.ecent[:, None]) ** 2).sum(0)
               > su.erad * su.erad) & ~done
        status = mark(oor, STAT_OOR, status)
        done = done | oor

    # BS23 attempt (FSAL: d1 is the direction at xT)
    d2_, _ = su.direction(xT + 0.5 * h[None, :] * d1)
    d3_, _ = su.direction(xT + 0.75 * h[None, :] * d2_)
    xnew = xT + h[None, :] * (2.0 / 9.0 * d1 + 1.0 / 3.0 * d2_
                              + 4.0 / 9.0 * d3_)
    d4_, gmod4 = su.direction(xnew)
    errv = h[None, :] * (-5.0 / 72.0 * d1 + 1.0 / 12.0 * d2_
                         + 1.0 / 9.0 * d3_ - 1.0 / 8.0 * d4_)
    nerr = torch.sqrt((errv * errv).sum(0))

    accept = (nerr < su.maxerr) & ~done
    grow = accept & (nerr < su.maxerr / 10.0)
    step_len = torch.sqrt(((xnew - xT) ** 2).sum(0))
    plen = torch.where(accept, plen + step_len, plen)
    xT = torch.where(accept[None, :], xnew, xT)
    d1 = torch.where(accept[None, :], d4_, d1)
    gmod = torch.where(accept, gmod4, gmod)
    h = torch.where(grow, torch.clamp((1.6 * h).abs(), max=su.hini), h)
    h = torch.where(~accept & ~done,
                    0.9 * h * su.maxerr / torch.clamp(nerr, min=1e-30), h)

    # step collapse
    stuck = (h.abs() < 1e-12) & ~done
    status = mark(stuck, STAT_STUCK, status)
    done = done | stuck

    return xT, h, done, status, termid, plen, d1, gmod


def _start(eval_fn, x0, iup, targets, rterm, hini, maxerr, gradeps, m_c2x,
           molborder, escape, h0=None, plen0=None):
    """Check the inputs and build the fixed setup and the initial state."""
    if not isinstance(x0, torch.Tensor) or x0.dtype != torch.float64:
        raise TypeError("trace_paths needs float64 seeds as a tensor "
                        "(N, 3): the direction guard |grad| + 1e-80 "
                        "vanishes in float32")
    dev = x0.device
    xT0 = x0.T.contiguous()
    N = xT0.shape[1]

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    have_t = targets is not None and len(targets) > 0
    su = _Setup(eval_fn=eval_fn, sgn=float(iup),
                tT=f64(targets).T.contiguous() if have_t else None,
                rt=f64(rterm) if have_t else None,
                m_c2x=f64(m_c2x) if m_c2x is not None else None,
                molborder=f64(molborder) if m_c2x is not None else None,
                ecent=f64(escape[0]) if escape is not None else None,
                erad=float(escape[1]) if escape is not None else 0.0,
                hini=float(hini), maxerr=float(maxerr),
                gradeps=float(gradeps))
    d1, gmod = su.direction(xT0)
    if d1.dtype != torch.float64:
        raise TypeError("trace_paths needs a float64 evaluator")
    st = (xT0,
          torch.full((N,), float(hini), dtype=torch.float64, device=dev)
          if h0 is None else f64(h0),
          torch.zeros(N, dtype=torch.bool, device=dev),
          torch.full((N,), STAT_MAXSTEP, dtype=torch.int32, device=dev),
          torch.full((N,), -1, dtype=torch.int64, device=dev),
          torch.zeros(N, dtype=torch.float64, device=dev)
          if plen0 is None else f64(plen0),
          d1, gmod)
    return su, st


def trace_paths(eval_fn, x0, iup: int = 1, targets=None, rterm=None,
                hini: float = 0.3, maxerr: float = 1e-4,
                gradeps: float = 1e-7, mstep: int = 4000,
                m_c2x=None, molborder=None, h0=None, chunk: int = 16,
                loop: str | None = None, compact: bool = True,
                escape=None, plen0=None):
    """Trace gradient paths from Cartesian seeds x0 (N, 3), a float64
    tensor on the device the evaluator lives on. `loop` is accepted and
    ignored: the port has one loop form.

    eval_fn: SoA evaluator (3, N) -> (f, gf (3, N), h6).
    iup: +1 uphill (to maxima), -1 downhill.
    targets: (K, 3) Cartesian attractor points incl. periodic images, or
    None; rterm: (K,) termination radius per target (reference
    min(rbetadef, h/2) when no beta sphere is set).
    m_c2x/molborder: enable molecular-cell escape detection (iup == -1).
    h0 / plen0: optional per-trajectory initial step and path length
    (resume support).
    escape: optional (centre (3,), radius): lanes that leave the sphere
    pause with STAT_OOR (the screened tracer's validity sphere).
    compact: between segments, pack the still-live trajectories once at
    most half the working lanes are live. Straggler paths (separatrix
    ridge crawlers whose step collapses to the local feature size)
    otherwise keep the full batch evaluating for the whole mstep budget.
    Returns (x (N, 3), status (N,) int32, termid (N,) int64, plen (N,),
    h (N,)), tensors on the device of x0.
    """
    su, st = _start(eval_fn, x0, iup, targets, rterm, hini, maxerr,
                    gradeps, m_c2x, molborder, escape, h0, plen0)
    N = x0.shape[0]
    dev = x0.device
    # results of the lanes packed out of the working batch
    out = (torch.empty((3, N), dtype=torch.float64, device=dev),
           torch.empty(N, dtype=torch.float64, device=dev),
           torch.empty(N, dtype=torch.int32, device=dev),
           torch.empty(N, dtype=torch.int64, device=dev),
           torch.empty(N, dtype=torch.float64, device=dev))
    order = torch.arange(N, device=dev)   # original index per working lane

    def flush(st, sel):
        """Scatter the working lanes `sel` into the output tensors."""
        xT, h, _, status, termid, plen = st[:6]
        for o, v in zip(out, (xT, h, status, termid, plen)):
            o[..., order[sel]] = v[..., sel]

    it = 0
    while it < mstep:
        n = min(chunk, mstep - it)
        for _ in range(n):
            st = _attempt(su, st)
        it += n
        done = st[2]
        nwork = done.shape[0]
        nlive = nwork - int(done.sum())       # the one host read
        if nlive == 0:
            break
        if (compact and it < mstep and nwork > COMPACT_MIN
                and nlive <= nwork // 2):
            fin = torch.nonzero(done)[:, 0]
            live = torch.nonzero(~done)[:, 0]
            flush(st, fin)
            order = order[live]
            st = tuple(v[..., live] for v in st)
    flush(st, slice(None))
    xT, h, status, termid, plen = out
    return xT.T, status, termid, plen, h


def trace_paths_recorded(eval_fn, x0, nrec: int = 400, iup: int = 1,
                         targets=None, rterm=None, hini: float = 0.3,
                         maxerr: float = 1e-4, gradeps: float = 1e-7,
                         m_c2x=None, molborder=None, chunk: int = 50,
                         loop: str | None = None):
    """Like trace_paths but records the trajectory (host-side pruning of
    repeated tail points). Returns (paths list of (L_i, 3) numpy arrays,
    status, termid as numpy arrays). Runs nrec bounded attempts; use for
    plotting (FLUXPRINT/GRDVEC), not for termination-critical work.

    The position after every attempt is written on the device into one
    preallocated (nrec + 1, 3, N) tensor, read back once at the end."""
    su, st = _start(eval_fn, x0, iup, targets, rterm, hini, maxerr,
                    gradeps, m_c2x, molborder, None)
    N = x0.shape[0]
    rec = torch.empty((nrec + 1, 3, N), dtype=torch.float64,
                      device=x0.device)
    rec[0] = st[0]
    it = 0
    while it < nrec:
        for _ in range(min(chunk, nrec - it)):
            st = _attempt(su, st)
            it += 1
            rec[it] = st[0]
        if bool(st[2].all()):             # the one host read of a segment
            break
    arr = rec[:it + 1].permute(0, 2, 1).cpu().numpy()   # (steps+1, N, 3)
    paths = []
    for i in range(N):
        p = arr[:, i, :]
        keep = np.ones(len(p), bool)
        keep[1:] = np.linalg.norm(np.diff(p, axis=0), axis=1) > 1e-12
        paths.append(p[keep])
    return paths, st[3].cpu().numpy(), st[4].cpu().numpy()


def trace_paths_screened(wfn, x0, iup: int = 1, targets=None, rterm=None,
                         hini: float = 0.3, maxerr: float = 1e-4,
                         gradeps: float = 1e-7, mstep: int = 4000,
                         m_c2x=None, molborder=None, n_chunk: int = 256,
                         margin: float = 8.0, max_rounds: int = 12,
                         dtype=None, device=None):
    """trace_paths through the screened GTO evaluator (large molecules).

    Seeds x0 (N, 3) are grouped spatially (fields/wfn.screen_plan); each
    group traces with its own block table inside an ESCAPE SPHERE of
    radius chunk_radius + margin, where the truncated field is exact to
    the screening threshold. Paths that leave their sphere pause with
    STAT_OOR and are re-grouped at their current positions for the next
    round, carrying step size and path length - the batch analogue of
    the reference rebuilding its near-atom list every evaluation
    (src/wfn_private@proc.F90:2070). Runs on `device` (cuda by default).

    Returns (x (N, 3), status, termid, plen, h) like trace_paths, as
    tensors on the device."""
    from ..config import resolve_device

    dev = resolve_device(device)
    x = np.array(np.asarray(x0, float), copy=True).reshape(-1, 3)
    N = len(x)
    h = np.full(N, float(hini))
    plen = np.zeros(N)
    stat = np.full(N, STAT_OOR, np.int32)
    term = np.full(N, -1, np.int64)
    pend = np.arange(N)

    for _ in range(max_rounds):
        if len(pend) == 0:
            break
        order, xstack, bidx, Np = wfn.screen_plan(x[pend], n_chunk=n_chunk,
                                                  margin=margin)
        nxt = []
        for i in range(len(xstack)):
            lo = i * n_chunk
            js = np.arange(lo, min(lo + n_chunk, Np))
            gidx = pend[order[js]]
            pts = xstack[i].T                  # (n, 3) padded
            ecent = pts.mean(0)
            rc = np.linalg.norm(pts - ecent, axis=1).max()
            shim = wfn.screened_shim(bidx[i], nder=1, dtype=dtype,
                                     device=dev)
            h0 = np.full(len(pts), hini)
            p0 = np.zeros(len(pts))
            h0[:len(js)] = h[gidx]
            p0[:len(js)] = plen[gidx]
            xx, ss, tt, pp, hh = trace_paths(
                shim, torch.as_tensor(pts, dtype=torch.float64, device=dev),
                iup=iup, targets=targets, rterm=rterm, hini=hini,
                maxerr=maxerr, gradeps=gradeps, mstep=mstep, m_c2x=m_c2x,
                molborder=molborder, h0=h0, plen0=p0,
                escape=(ecent, rc + margin - min(1.0, 0.25 * margin)))
            ss = ss.cpu().numpy()[:len(js)]
            x[gidx] = xx.cpu().numpy()[:len(js)]
            h[gidx] = hh.cpu().numpy()[:len(js)]
            plen[gidx] = pp.cpu().numpy()[:len(js)]
            stat[gidx] = ss
            term[gidx] = tt.cpu().numpy()[:len(js)]
            nxt.append(gidx[ss == STAT_OOR])
        pend = np.concatenate(nxt) if nxt else np.zeros(0, int)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    return (t(x, torch.float64), t(stat, torch.int32), t(term, torch.int64),
            t(plen, torch.float64), t(h, torch.float64))
