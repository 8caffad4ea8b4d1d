"""Yu-Trinkle grid basin integration on PyTorch / CUDA.

Role of the reference yt (src/yt@proc.f90:34-369, JCP 134, 064111): local
maxima of the grid density become attractors, points whose uphill flux
goes entirely to one basin inherit it, and boundary points receive
fractional weights w_i(b) = sum_k chi_ik w_k(b), chi_ik ~ A_k (rho_k -
rho_i) / l_k over the Wigner-Seitz facet neighbours of the grid lattice.

As in the JAX package, the sequential sorted sweep is reformulated as the
fixpoint of s = f + R s, where R applies the flux tensor over K fixed
lattice offsets. R is nilpotent in sorted order, so the fixpoint is exact.
Two directions of the same recurrence cover all consumers:

  * integrate(f): the ADJOINT sweep s = f + R^T s pushes f-mass uphill;
    the basin sums are s at the attractors.
  * weights(b)/labels: the FORWARD sweep w = onehot_b + R w floods basin-b
    membership downhill.

The solve (`_solve_sweep`) takes one of two routes:
  * tensors on CUDA: f32 Gauss-Seidel sweeps through the yt_gs_pass kernel
    plus one f64 refinement whose residual f + R s goes through the
    yt_pass kernel; the sweeps run along the grid axis that `_sweep_axis`
    picks from the neighbour offsets;
  * tensors on the CPU: the f64 Jacobi fixpoint by torch.rolls
    (`_xla_sweep`, named after its JAX counterpart).

Tie-breaking at plateaus replicates the reference: "uphill" means lower
rank in the stable descending sort, and a point whose positive-flux set is
empty attaches all its weight to its lowest-ranked uphill neighbour
(src/yt@proc.f90:149-156).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops.yt_pass import yt_gs_pass, yt_pass
from ..utils import trace

__all__ = ["yt_integrate", "yt_f32_guarded", "YTResult"]

_DIMS = (0, 1, 2)


def _grid_ws_neighbors(crystal, shape):
    """WS facet data of the grid-point lattice (reference yt builds an aux
    'grid lattice' crystal, src/yt@proc.f90:93-103).

    Returns (offsets (K,3) int, wts (K,) = A_k/l_k)."""
    from ..crystal.wscell import wigner_seitz

    m = np.asarray(crystal.m_x2c) @ np.diag(
        1.0 / np.asarray(shape, dtype=float))
    ws = wigner_seitz(m)
    offs = np.asarray(ws.ineighx, dtype=np.int32)
    lens = np.linalg.norm(ws.ineighc, axis=1)
    return offs, np.asarray(ws.areas) / lens


def _neg(o):
    return tuple(-int(v) for v in o)


def _sweep_axis(offs) -> int:
    """The grid axis the Gauss-Seidel solve sweeps along: of axes 0 and 1,
    the one with fewer cross-plane neighbours that also step within the
    plane, ties to 0.

    A sweep pair resolves an uphill chain whose cross-plane steps turn
    back along the sweep axis at most once, while in-plane steps cost
    nothing (each plane is solved to its fixpoint). A cross-plane
    neighbour with an in-plane step lets a chain climb within the planes
    by zig-zagging across them, one turn per step, so the pairs grow with
    the grid. Cubic and orthorhombic grid lattices have none along any
    axis (0); anthracene's monoclinic one has two along axis 0 and none
    along its unique axis 1 (1)."""
    def mixed(a):
        return sum(1 for o in offs
                   if o[a] and any(o[b] for b in range(3) if b != a))
    return 1 if mixed(1) < mixed(0) else 0


def _flux_tensors(rho3, wts, offs):
    """Per-neighbour normalized uphill flux chi (K,)+shape, plus the
    attractor mask. chi_k[x] is the weight fraction point x sends to its
    neighbour x+o_k; rows sum to 1 except at attractors (all-zero).

    "Uphill" is the stable-descending-sort order without the sort:
    rank_k < rank_x iff rho_k > rho_x, or rho_k == rho_x and idx_k < idx_x,
    so the ranks collapse to K rolled compares."""
    shape = tuple(rho3.shape)
    dev, dt = rho3.device, rho3.dtype
    K = len(offs)
    idx3 = torch.arange(int(np.prod(shape)), dtype=torch.int64,
                        device=dev).reshape(shape)
    zero = torch.zeros((), dtype=dt, device=dev)
    out = torch.empty((K,) + shape, dtype=dt, device=dev)
    anyhi = torch.zeros(shape, dtype=torch.bool, device=dev)
    tot = torch.zeros(shape, dtype=dt, device=dev)
    # lowest-ranked uphill neighbour: plateau fallback target
    best_rho = torch.full(shape, -float("inf"), dtype=dt, device=dev)
    best_idx = torch.zeros(shape, dtype=torch.int64, device=dev)
    best_k = torch.full(shape, -1, dtype=torch.int64, device=dev)
    for k, o in enumerate(offs):
        rho_k = torch.roll(rho3, _neg(o), _DIMS)
        idx_k = torch.roll(idx3, _neg(o), _DIMS)
        hi = (rho_k > rho3) | ((rho_k == rho3) & (idx_k < idx3))
        chi = torch.where(hi, float(wts[k]) * (rho_k - rho3), zero)
        chi = torch.clamp(chi, min=0.0)
        out[k] = chi
        tot = tot + chi
        anyhi |= hi
        upd = hi & ((rho_k > best_rho)
                    | ((rho_k == best_rho) & (idx_k < best_idx)))
        best_rho = torch.where(upd, rho_k, best_rho)
        best_idx = torch.where(upd, idx_k, best_idx)
        best_k = torch.where(upd, k, best_k)
    haspos = tot > 0
    inv = torch.where(haspos, 1.0 / torch.where(haspos, tot, 1.0), zero)
    one = torch.ones((), dtype=dt, device=dev)
    for k in range(K):
        fallback = torch.where(best_k == k, one, zero)
        out[k] = torch.where(haspos, out[k] * inv, fallback)
    return out, ~anyhi


def _shifted(chi, offs, dtype):
    """chi'_k = roll(chi_k, o_k) cast to `dtype` (cast first, so the roll
    moves the narrower words): the adjoint operand of the kernels."""
    out = torch.empty(chi.shape, dtype=dtype, device=chi.device)
    for k, o in enumerate(offs):
        out[k] = torch.roll(chi[k].to(dtype), tuple(int(v) for v in o),
                            _DIMS)
    return out


def _apply_R(chiP, s, offs, adjoint=True):
    """One application of the flux operator (torch.rolls, any dtype).
    adjoint: out[x] = sum_k roll(chi_k * s, +o_k) (mass pushed uphill);
    forward: out[x] = sum_k chi_k * roll(s, -o_k) (membership downhill)."""
    acc = torch.zeros_like(s)
    for k, o in enumerate(offs):
        sh = tuple(int(v) for v in o)
        if adjoint:
            acc = acc + torch.roll(chiP[k] * s, sh, (1, 2, 3))
        else:
            acc = acc + chiP[k] * torch.roll(s, _neg(sh), (1, 2, 3))
    return acc


def _xla_sweep(chiP, f3, offs, adjoint=True):
    """Exact fixpoint of s = f + R s by Jacobi passes of torch.rolls. R is
    nilpotent in sorted order -> exact bitwise convergence after depth
    passes (one host sync per pass for the stationarity test)."""
    s = f3
    while True:
        s_new = f3 + _apply_R(chiP, s, offs, adjoint=adjoint)
        trace.count("host_syncs")
        if torch.equal(s_new, s):
            return s_new
        s = s_new


def _gs_pairs(chiP32, s, f3, offs, adjoint, npair, axis=0):
    """npair forward+backward Gauss-Seidel sweep pairs along `axis`
    through the yt_gs_pass kernel; returns (s, last pair's
    changed-anything flag as a device tensor, so no sync happens here)."""
    flag = None
    for _ in range(npair):
        s, c1 = yt_gs_pass(chiP32, s, f3, offs=offs, adjoint=adjoint,
                           backward=False, axis=axis)
        s, c2 = yt_gs_pass(chiP32, s, f3, offs=offs, adjoint=adjoint,
                           backward=True, axis=axis)
        flag = c1[0, 0] + c2[0, 0]
    return s, flag


def _kernel_sweep(chiP32, f3, offs, adjoint, axis=0):
    """f32 fixpoint by Gauss-Seidel sweep pairs along `axis` until a pair
    changes nothing: 4 pairs first (they resolve typical atomic-basin
    fields), then 2 at a time, one flag read per batch."""
    s, flag = _gs_pairs(chiP32, f3, f3, offs, adjoint, npair=4, axis=axis)
    npairs = 4
    maxpair = sum(f3.shape[1:]) + 16
    while True:
        trace.count("host_syncs")
        if int(flag) == 0 or npairs >= maxpair:
            return s
        s, flag = _gs_pairs(chiP32, s, f3, offs, adjoint, npair=2,
                            axis=axis)
        npairs += 2


def _solve_sweep(chiP, chiP32, chiR, f3, offs, adjoint=True, nrefine=1,
                 rtol=1e-11, axis=0):
    """Solve (I - R) s = f at f64 accuracy.

    chiP32 None: the f64 Jacobi fixpoint (_xla_sweep). Otherwise the kernel
    route: f32 Gauss-Seidel solves along grid axis `axis` (chiP32: f32
    flux, shifted for the adjoint) with f64 iterative refinement, the
    residual r = f + R s - s evaluated by yt_pass with chiR (the f64 flux,
    shifted for the adjoint); a kernel-route solve along an axis other
    than 0 counts one `yt.off_axis_solves`.
    The optimistic path queues solve + residual + correction solve and
    reads both convergence flags in ONE sync; when a flag trips it falls
    back to the flag-stepped loop (one `yt.fallbacks` count a trip)."""
    trace.count("yt.solves")
    with trace.span("yt.solve"):
        if chiP32 is None:
            return _xla_sweep(chiP, f3, offs, adjoint=adjoint)
        if axis:
            trace.count("yt.off_axis_solves")
        if nrefine == 1:
            f32a = f3.to(torch.float32)
            s1, flag1 = _gs_pairs(chiP32, f32a, f32a, offs, adjoint, npair=4,
                                  axis=axis)
            s1 = s1.to(f3.dtype)
            r = yt_pass(chiR, s1, f3, offs=offs, adjoint=adjoint) - s1
            r32 = r.to(torch.float32)
            e, flag2 = _gs_pairs(chiP32, r32, r32, offs, adjoint, npair=4,
                                 axis=axis)
            out = s1 + e.to(f3.dtype)
            trace.count("host_syncs")
            if int((flag1 != 0) | (flag2 != 0)) == 0:   # one host sync
                return out
            trace.count("yt.fallbacks")
        with trace.span("yt.fallback"):
            s = _kernel_sweep(chiP32, f3.to(torch.float32), offs,
                              adjoint, axis).to(f3.dtype)
            for i in range(nrefine):
                r = yt_pass(chiR, s, f3, offs=offs, adjoint=adjoint) - s
                if i > 0:
                    trace.count("host_syncs", 2)
                    fscale = float(f3.abs().max()) + 1e-300
                    if float(r.abs().max()) <= rtol * fscale:
                        break
                s = s + _kernel_sweep(chiP32, r.to(torch.float32), offs,
                                      adjoint, axis).to(f3.dtype)
            return s


@dataclass
class YTResult:
    crystal: object
    shape: tuple
    nattr: int
    xattr: np.ndarray            # (nattr, 3) fractional attractor positions
    iattr: np.ndarray            # (nattr,) flat grid index of each attractor
    _chiP: torch.Tensor = None   # (K,)+shape normalized uphill flux
    _offs: tuple = None          # K x (3,) neighbour offsets
    _labels: np.ndarray = None   # lazy (n1,n2,n3) int32 argmax-weight basin
    _nboundary: int = None       # lazy count of fractional-weight points
    _chiP32s: torch.Tensor = None  # lazy f32 shifted flux (adjoint sweeps)
    _chiP32f: torch.Tensor = None  # lazy f32 flux (forward sweeps)
    _chiP64s: torch.Tensor = None  # lazy f64 shifted flux (adjoint residual)

    def _kernel_ok(self) -> bool:
        """The kernel route serves f64 decompositions on a CUDA device."""
        return self._chiP.is_cuda and self._chiP.dtype == torch.float64

    def _chis(self, adjoint):
        """(f32 sweep operand, residual operand) of the kernel route, or
        (None, None) for the plain f64 route."""
        if not self._kernel_ok():
            return None, None
        if not adjoint:
            if self._chiP32f is None:
                self._chiP32f = self._chiP.to(torch.float32)
            return self._chiP32f, self._chiP
        if self._chiP32s is None:
            self._chiP32s = _shifted(self._chiP, self._offs, torch.float32)
        if self._chiP64s is None:
            self._chiP64s = _shifted(self._chiP, self._offs, torch.float64)
        return self._chiP32s, self._chiP64s

    def _index(self, flat):
        """Grid index tensors (i1, i2, i3) of flat indices, on the device
        (three copies from pageable host memory, each a host sync)."""
        trace.count("host_syncs", 3)
        return tuple(torch.as_tensor(i, device=self._chiP.device)
                     for i in np.unravel_index(flat, self.shape))

    def _solve(self, f3, adjoint):
        with trace.span("yt.operands"):
            chi32, chiR = self._chis(adjoint)
        return _solve_sweep(self._chiP, chi32, chiR, f3, self._offs,
                            adjoint=adjoint, axis=_sweep_axis(self._offs))

    @property
    def labels(self) -> np.ndarray:
        """Basin per point by max weight (reference sweep assignment,
        src/yt@proc.f90:160). Lazy: charges never need labels."""
        if self._labels is None:
            self._compute_labels()
        return self._labels

    @property
    def nboundary(self) -> int:
        if self._nboundary is None:
            self._compute_labels()
        return self._nboundary

    def _basin_chunk(self, b0: int, nb: int) -> torch.Tensor:
        """(nb,)+shape weight grids of basins b0..b0+nb-1 (forward sweep)."""
        seed = torch.zeros((nb,) + self.shape, dtype=self._chiP.dtype,
                           device=self._chiP.device)
        i1, i2, i3 = self._index(self.iattr[b0:b0 + nb])
        seed[torch.arange(nb, device=seed.device), i1, i2, i3] = 1.0
        return self._solve(seed, adjoint=False)

    def _compute_labels(self, chunk: int = 8):
        dev = self._chiP.device
        wmax = torch.full(self.shape, -1.0, dtype=self._chiP.dtype,
                          device=dev)
        lab = torch.zeros(self.shape, dtype=torch.int32, device=dev)
        frac = torch.zeros(self.shape, dtype=torch.bool, device=dev)
        for b0 in range(0, self.nattr, chunk):
            nb = min(chunk, self.nattr - b0)
            w = self._basin_chunk(b0, nb)
            cmax, carg = w.max(0)
            upd = cmax > wmax
            lab = torch.where(upd, (b0 + carg).to(torch.int32), lab)
            wmax = torch.where(upd, cmax, wmax)
            frac |= ((w > 1e-15) & (w < 1.0 - 1e-12)).any(0)
        trace.count("host_syncs", 2)
        self._labels = lab.cpu().numpy()
        self._nboundary = int(frac.sum())

    def integrate(self, field_flat) -> np.ndarray:
        """sum_i w_i(b) f_i for each basin (NOT scaled by Omega/N).

        Accepts one integrand (N,) or a stack (nprops, N); the adjoint
        sweep batches all integrands in one solve."""
        f = torch.as_tensor(field_flat, device=self._chiP.device)
        single = f.dim() == 1 or tuple(f.shape) == self.shape
        f3 = f.reshape((1 if single else f.shape[0],) + self.shape)
        if not f3.is_floating_point():
            f3 = f3.to(self._chiP.dtype)
        s = self._solve(f3, adjoint=True)
        with trace.span("yt.readback"):
            i1, i2, i3 = self._index(self.iattr)
            trace.count("host_syncs")
            q = s[:, i1, i2, i3].cpu().numpy()
        return q[0] if single else q

    def weights(self, b: int) -> np.ndarray:
        """Full weight grid of basin b (dense; for WCUBE-style output)."""
        trace.count("host_syncs")
        return self._basin_chunk(int(b), 1)[0].cpu().numpy()

    def basin_support(self, a: int, tol: float = 1e-15):
        """(flat indices, weights) of every point with weight > tol in
        basin `a` (deloc Sij support; reference yt_weights consumers)."""
        w = self.weights(a).reshape(-1)
        idx = np.where(w > tol)[0]
        return idx, w[idx]


def _as_grid(rho, device, dtype=None):
    """rho as a tensor: a tensor keeps its device unless `device` is
    given; anything else goes to resolve_device(device) (cuda by default)."""
    if isinstance(rho, torch.Tensor):
        dev = rho.device if device is None else resolve_device(device)
        return rho.to(device=dev, dtype=dtype or rho.dtype)
    return torch.as_tensor(np.asarray(rho), dtype=dtype or FDTYPE,
                           device=resolve_device(device))


def yt_integrate(crystal, rho, block: int | None = None, *, device=None):
    """Run the YT decomposition of grid `rho` ((n1,n2,n3) tensor or array).

    Returns a YTResult; `integrate` gives the basin sums. `block` is
    accepted and ignored, as the JAX package ignores it."""
    rho3 = _as_grid(rho, device)
    shape = tuple(int(s) for s in rho3.shape)
    with trace.span("yt.neighbours"):
        offs_np, wts_np = _grid_ws_neighbors(crystal, shape)
    offs = tuple(tuple(int(v) for v in o) for o in offs_np)

    with trace.span("yt.flux"):
        chiP, is_attr = _flux_tensors(rho3, wts_np, offs)
        # nonzero's size and the two readbacks: three host syncs
        trace.count("host_syncs", 3)
        iattr_d = torch.nonzero(is_attr.reshape(-1)).reshape(-1)
        rho_at_d = rho3.reshape(-1)[iattr_d]
        iattr = iattr_d.cpu().numpy()
        rho_at = rho_at_d.cpu().numpy()
    with trace.span("yt.order"):
        nattr = len(iattr)
        iattr = iattr[np.lexsort((iattr, -rho_at))]
        i1, i2, i3 = np.unravel_index(iattr, shape)
        xattr = np.stack([i1 / shape[0], i2 / shape[1], i3 / shape[2]],
                         axis=1)
    return YTResult(crystal=crystal, shape=shape, nattr=nattr, xattr=xattr,
                    iattr=iattr, _chiP=chiP, _offs=offs)


def yt_f32_guarded(crystal, rho, guard_tol: float = 1e-6,
                   trip_frac: float = 0.25, device=None):
    """YT with an f32-CONSTRUCTED basin decomposition, audited against f64
    drift (see the JAX package's yt_f32_guarded for the derivation):

      * s = adjoint mass flow of rho through the f32 partition;
      * per-basin drift estimate e = (I - R32^T)^{-1} (R64^T - R32^T) s,
        read at the attractors.

    Falls back to the f64 construction when the attractor sets differ or
    max_b |e_b| > trip_frac * guard_tol.

    Returns (YTResult, audit dict with keys dtype/drift_est_e/nattr32/
    nattr64/tripped/reason)."""
    rho64 = _as_grid(rho, device, dtype=torch.float64)
    shape = tuple(int(s) for s in rho64.shape)
    N = int(np.prod(shape))
    res32 = yt_integrate(crystal, rho64.to(torch.float32))

    offs_np, wts_np = _grid_ws_neighbors(crystal, shape)
    offs = tuple(tuple(int(v) for v in o) for o in offs_np)
    chi64, isattr64 = _flux_tensors(rho64, wts_np, offs)
    nattr64 = int(isattr64.sum())

    dv = float(np.abs(np.linalg.det(np.asarray(crystal.m_x2c)))) / N
    audit = {"dtype": "f32", "nattr32": res32.nattr, "nattr64": nattr64,
             "tripped": False, "reason": "", "drift_est_e": float("nan")}

    def fallback(reason):
        audit["tripped"] = True
        audit["reason"] = reason
        audit["dtype"] = "f64"
        return yt_integrate(crystal, rho64), audit

    if nattr64 != res32.nattr:
        return fallback(f"attractor count changed "
                        f"({res32.nattr} f32 vs {nattr64} f64)")

    # adjoint mass flow of rho through the f32 partition
    f3 = rho64.reshape((1,) + shape)
    s = res32._solve(f3, adjoint=True)
    dRs = (_apply_R(chi64, s, offs, adjoint=True)
           - _apply_R(res32._chiP.to(torch.float64), s, offs, adjoint=True))
    e3 = res32._solve(dRs, adjoint=True)[0]
    i1, i2, i3 = res32._index(res32.iattr)
    drift = float(e3[i1, i2, i3].abs().max()) * dv
    audit["drift_est_e"] = drift
    if drift > trip_frac * guard_tol:
        return fallback(f"estimated basin-charge drift {drift:.3e} e > "
                        f"{trip_frac:g} * {guard_tol:g} e")
    return res32, audit
