"""ctypes bindings for the sequential C++ reference (native/critic2_native.cpp).

The library holds the qhull-equivalent geometry kernels (convex hull,
Wigner-Seitz cell) and the sequential host counterparts of the device
paths: the exact Yu-Trinkle sweep, tricubic evaluation, the NCI sweep,
the gradient-path colour tracer, the AUTO drain on grids and GTO
wavefunctions. It is the reference the card's results are held against,
so it runs on the host only: no function here takes a `device` or
launches anything on the card. Inputs may be numpy arrays or torch
tensors on any device (copied to host float64); results are numpy.

The source is the repository's one copy, read by path; `build()`
compiles it with g++ into critic2_tpu_torch/_build/, under a name that
carries a hash of the source and the flags, with the flags of the JAX
package's build, so both libraries compute the same bits. `hull` and
`ws_cell` fall back to NumPy when the library cannot be built; the other
functions raise. Build and check it:

    python -m critic2_tpu_torch.native
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

__all__ = ["available", "hull", "ws_cell", "yt_labels",
           "yt_charges", "tricubic_batch", "omp_threads", "build"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(_PKG), "native", "critic2_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]

_LIB = None
_TRIED_BUILD = False
_I, _L, _D = ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_DP, _IP = ctypes.POINTER(_D), ctypes.POINTER(_I)
# C signature of each entry point: (restype, argtypes)
_SIGS = {
    "c2n_hull": (_I, [_I, _DP, _IP, _I]),
    "c2n_ws_cell": (_I, [_DP, _IP, _DP, _DP, _IP, _I, _I]),
    "c2n_yt_labels": (_I, [_I, _I, _I, _DP, _I, _IP, _DP, _IP, _I]),
    "c2n_yt_charges": (_I, [_I, _I, _I, _DP, _I, _IP, _DP, _IP, _I, _DP,
                            _DP]),
    "c2n_tricubic_batch": (None, [_I, _I, _I, _DP, _L, _DP, _DP, _DP,
                                  _DP]),
    "c2n_nci_sweep": (_L, [_I, _I, _I, _DP, _DP, _D, _D]),
    "c2n_tricubic_values": (None, [_I, _I, _I, _DP, _L, _DP, _DP]),
    "c2n_trace_colors": (_L, [_I, _I, _I, _DP, _DP, _L, _DP, _I, _DP, _IP,
                              _DP, _D, _D, _D, _I, _IP]),
    "c2n_auto_drain": (_I, [_I, _I, _I, _DP, _DP, _L, _DP, _D, _D, _I,
                            _DP, _IP, _I]),
    "c2n_wfn_eval": (_L, [_L, _DP, _IP, _DP, _I, _DP, _DP, _L, _DP, _I,
                          _D, _DP, _DP, _DP]),
    "c2n_wfn_auto_drain": (_I, [_L, _DP, _IP, _DP, _I, _DP, _DP, _L, _DP,
                                _D, _D, _I, _D, _D, _DP, _IP, _I,
                                ctypes.POINTER(_L)]),
    "c2n_omp_threads": (_I, []),
}


def _host(a, dtype=np.float64) -> np.ndarray:
    """A C-contiguous host array of `dtype` from an array or a tensor on
    any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


def _rows(a, ncol: int = 3, dtype=np.float64) -> np.ndarray:
    """_host(a) checked to be (n, ncol): the C side reads ncol values a
    row."""
    a = _host(a, dtype)
    if a.ndim != 2 or a.shape[1] != ncol:
        raise ValueError(f"expected an (n, {ncol}) array, got {a.shape}")
    return a


def _grid(f) -> np.ndarray:
    f = _host(f)
    if f.ndim != 3:
        raise ValueError(f"expected an (n1, n2, n3) grid, got {f.shape}")
    return f


def _p(a):
    """The data pointer of a float64 or int32 array, or None."""
    if a is None:
        return None
    return a.ctypes.data_as(_DP if a.dtype == np.float64 else _IP)


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native reference library "
                           "is built from native/critic2_native.cpp")
    return path


def _lib_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libcritic2_native_{h.hexdigest()[:16]}.so")


def _load():
    """The loaded library, built first if it is missing (one attempt a
    process); None when it cannot be built."""
    global _LIB, _TRIED_BUILD
    if _LIB is not None:
        return _LIB
    try:
        out = _lib_path()
    except OSError:                     # no source in this tree
        return None
    if not os.path.exists(out):
        if _TRIED_BUILD:
            return None
        _TRIED_BUILD = True
        try:
            build()
        except Exception:
            return None
    lib = ctypes.CDLL(out)
    for name, (res, args) in _SIGS.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _LIB = lib
    return lib


def build():
    """Compile the native library from native/critic2_native.cpp. The
    output appears under its final name in one step, so concurrent
    builds never load a half-written file. Raises RuntimeError with
    g++'s output when the compile fails."""
    global _LIB
    out = _lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_cxx(), *CXX_FLAGS, SRC, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    _LIB = None
    return _load() is not None


def available() -> bool:
    return _load() is not None


def _need():
    """The loaded library; raises when it cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built "
                           "(python -m critic2_tpu_torch.native)")
    return lib


def hull(points):
    """Convex hull triangles of (n, 3) points (native if available)."""
    lib = _load()
    pts = _rows(points)
    if lib is not None:
        maxt = 8 * len(pts) + 64
        tris = np.zeros((maxt, 3), dtype=np.int32)
        nt = lib.c2n_hull(len(pts), _p(pts), _p(tris), maxt)
        if nt >= 0:
            return tris[:nt].copy()
    from .analysis.bisect import _hull_faces

    return _hull_faces(pts)


def ws_cell(m_x2c):
    """Wigner-Seitz facets of a lattice: (ineigh (nf,3), areas (nf,),
    verts (nv,3))."""
    lib = _load()
    m = _rows(m_x2c)
    if lib is not None:
        maxf, maxv = 64, 256
        ineigh = np.zeros((maxf, 3), dtype=np.int32)
        areas = np.zeros(maxf)
        verts = np.zeros((maxv, 3))
        nv = _I(0)
        # column-major 3x3 (columns = lattice vectors)
        mcol = np.ascontiguousarray(m.T.reshape(-1))
        nf = lib.c2n_ws_cell(_p(mcol), _p(ineigh), _p(areas), _p(verts),
                             ctypes.byref(nv), maxf, maxv)
        if nf >= 0:
            return ineigh[:nf].copy(), areas[:nf].copy(), \
                verts[:nv.value].copy()
    from .crystal.wscell import wigner_seitz

    ws = wigner_seitz(m)
    return np.asarray(ws.ineighx, dtype=np.int32), \
        np.asarray(ws.areas), np.asarray(ws.vertices)


def _yt(rho, offs, wts, field):
    """(labels, nattr, charges or None) of the sequential sweep."""
    lib = _need()
    rho = _grid(rho)
    offs = _rows(offs, dtype=np.int32)
    wts = _host(wts)
    if wts.shape != (len(offs),):
        raise ValueError(f"{len(offs)} offsets, weights {wts.shape}")
    labels = np.zeros(rho.shape, dtype=np.int32)
    maxattr = 1 << 20
    head = (*rho.shape, _p(rho), len(offs), _p(offs), _p(wts), _p(labels),
            maxattr)
    if field is None:
        nattr = lib.c2n_yt_labels(*head)
        charges = None
    else:
        field = _grid(field)
        if field.shape != rho.shape:
            raise ValueError(f"field {field.shape}, rho {rho.shape}")
        charges = np.zeros(maxattr)
        nattr = lib.c2n_yt_charges(*head, _p(field), _p(charges))
    if nattr < 0:
        raise RuntimeError("native yt sweep failed")
    return labels, int(nattr), charges


def yt_labels(rho, offs, wts):
    """Exact sequential Yu-Trinkle labels (native). rho (n1,n2,n3);
    offs (K,3) int; wts (K,). Returns (labels (n1,n2,n3), nattr)."""
    labels, nattr, _ = _yt(rho, offs, wts, None)
    return labels, nattr


def yt_charges(rho, offs, wts, field):
    """Exact sequential Yu-Trinkle basin integrals of `field` over the
    basins of `rho` with fractional boundary weights (the reference
    algorithm, src/yt@proc.f90:106-190). Returns (labels, charges), the
    charges not scaled by the volume element."""
    labels, nattr, charges = _yt(rho, offs, wts, field)
    return labels, charges[:nattr]


def tricubic_batch(f, xfrac):
    """Host tricubic value/gradient/Hessian for (N, 3) fractional points
    on grid f (n1,n2,n3): the math and conventions of ops/interp.
    interp_soa (derivatives d/dfrac), OpenMP across points. Returns
    (y (N,), grad (N,3), hess (N,6) in SYM6)."""
    lib = _need()
    f = _grid(f)
    x = _rows(xfrac)
    N = len(x)
    y = np.empty(N)
    grad = np.empty((N, 3))
    hess = np.empty((N, 6))
    lib.c2n_tricubic_batch(*f.shape, _p(f), N, _p(x), _p(y), _p(grad),
                           _p(hess))
    return y, grad, hess


def nci_sweep(f, m_c2x, rhocut: float = 0.2, dimcut: float = 2.0) -> int:
    """The NCI analysis on every node of periodic grid f: tricubic
    value/gradient/Hessian, Cartesian rotation, middle Hessian
    eigenvalue, RDG and the cutoff test (the reference hot loop
    src/nci@proc.f90:496-562), OpenMP across nodes. Returns the
    .dat-selection count."""
    lib = _need()
    f = _grid(f)
    m = _rows(m_c2x)
    return int(lib.c2n_nci_sweep(*f.shape, _p(f), _p(m), rhocut, dimcut))


def tricubic_values(f, xfrac):
    """Value-only host tricubic, one core, sequential (the reference
    grd(v,0) path computes no derivatives)."""
    lib = _need()
    f = _grid(f)
    x = _rows(xfrac)
    y = np.empty(len(x))
    lib.c2n_tricubic_values(*f.shape, _p(f), len(x), _p(x), _p(y))
    return y


def trace_colors(f, m_x2c, seeds_cart, tgt_cart, tgt_ids, rt,
                 hini: float = 0.3, maxerr: float = 1e-4,
                 gradeps: float = 1e-7, mstep: int = 600):
    """Sequential one-core gradient-path tracer with the capture and
    step-control semantics of ops/ode.trace_paths (reference per-thread
    adaptive_stepper, src/fieldmod@proc.f90:2076-2399, BS23 defaults
    src/global@proc.f90:104-107), one path at a time on the host
    tricubic. Returns (colors (N,) int: the target id captured, the
    nearest target within 0.5 bohr of a gradient-zero end, else -1;
    nevals)."""
    lib = _need()
    f = _grid(f)
    minv = np.ascontiguousarray(np.linalg.inv(_rows(m_x2c)))
    seeds = _rows(seeds_cart)
    tgt = _rows(tgt_cart)
    ids = _host(tgt_ids, np.int32)
    rts = np.ascontiguousarray(np.broadcast_to(_host(rt), (len(tgt),)))
    if ids.shape != (len(tgt),):
        raise ValueError(f"{len(tgt)} targets, ids {ids.shape}")
    cols = np.empty(len(seeds), dtype=np.int32)
    nev = lib.c2n_trace_colors(*f.shape, _p(f), _p(minv), len(seeds),
                               _p(seeds), len(tgt), _p(tgt), _p(ids),
                               _p(rts), hini, maxerr, gradeps, mstep,
                               _p(cols))
    return cols, int(nev)


def auto_drain(f, m_x2c, seeds_frac, gfnormeps: float = 1e-12,
               cpeps: float = 1e-2, maxit: int = 200,
               maxcp: int = 100000):
    """Sequential AUTO on a grid field: one seed at a time, Newton to
    |grad| < gfnormeps, min-image dedup at cpeps against the found list
    (no symmetry: every image reached is kept), signature from the
    Hessian (reference per-seed loop src/autocp@proc.f90:694-723, newton
    src/fieldmod@proc.f90:1832-1868, addcp :1876), one core. Returns
    (cps_frac (ncp,3), signatures (ncp,))."""
    lib = _need()
    f = _grid(f)
    m = _rows(m_x2c)
    seeds = _rows(seeds_frac)
    cps = np.empty((maxcp, 3))
    sig = np.empty(maxcp, dtype=np.int32)
    n = lib.c2n_auto_drain(*f.shape, _p(f), _p(m), len(seeds), _p(seeds),
                           gfnormeps, cpeps, maxit, _p(cps), _p(sig), maxcp)
    return cps[:n], sig[:n]


def _wfn_arrays(w):
    """Primitive/MO arrays of a Wavefunction in the native layout:
    (ctr (P,3), li (P,3) int32, alpha (P), CT (P,M) = cmo^T, occ (M))."""
    from .fields.wfn import _LI

    ctr = _host(_host(w.atpos)[_host(w.icenter, np.int64)])
    li = _host(_LI[_host(w.itype, np.int64) - 1], np.int32)
    alpha = _host(w.e)
    CT = _host(_host(w.cmo).T)
    occ = _host(w.occ)
    return ctr, li, alpha, CT, occ


def wfn_eval_seq(w, pts, nder: int = 2, lncut: float = 27.631):
    """Sequential one-core screened GTO evaluation, the host counterpart
    of Wavefunction.rho_eval_screened (reference per-point near-primitive
    evaluation, src/wfn_private@proc.F90:2032-2228, screening ball
    :3075-3145). Returns (rho (N,), grad (N,3)|None, hess (N,3,3)|None,
    nvisit)."""
    lib = _need()
    ctr, li, alpha, CT, occ = _wfn_arrays(w)
    P, M = CT.shape
    x = _rows(_host(pts).reshape(-1, 3))
    N = len(x)
    rho = np.empty(N)
    grad = np.empty((N, 3)) if nder >= 1 else None
    hess = np.empty((N, 3, 3)) if nder >= 2 else None
    nvisit = lib.c2n_wfn_eval(P, _p(ctr), _p(li), _p(alpha), M, _p(CT),
                              _p(occ), N, _p(x), nder, lncut, _p(rho),
                              _p(grad), _p(hess))
    return rho, grad, hess, int(nvisit)


def wfn_auto_drain(w, seeds_cart, gfnormeps: float = 1e-12,
                   cpeps: float = 1e-2, maxit: int = 200,
                   lncut: float = 27.631, rmax: float | None = None,
                   maxcp: int = 100000):
    """Sequential AUTO on a molecular GTO field: one seed at a time,
    Newton on the screened evaluator (a seed past rmax from the origin
    escapes), dedup, signature (src/autocp@proc.f90:694-723). Returns
    (cps_cart (ncp,3), signatures (ncp,), nevals)."""
    lib = _need()
    ctr, li, alpha, CT, occ = _wfn_arrays(w)
    P, M = CT.shape
    seeds = _rows(seeds_cart)
    if rmax is None:
        rmax = float(np.linalg.norm(_host(w.atpos), axis=1).max() + 10.0)
    cps = np.empty((maxcp, 3))
    sig = np.empty(maxcp, dtype=np.int32)
    nev = _L(0)
    n = lib.c2n_wfn_auto_drain(P, _p(ctr), _p(li), _p(alpha), M, _p(CT),
                               _p(occ), len(seeds), _p(seeds), gfnormeps,
                               cpeps, maxit, lncut, rmax, _p(cps), _p(sig),
                               maxcp, ctypes.byref(nev))
    return cps[:n], sig[:n], int(nev.value)


def omp_threads() -> int:
    """OpenMP thread count the native kernels run with (1 = serial)."""
    lib = _load()
    return int(lib.c2n_omp_threads()) if lib is not None else 1


if __name__ == "__main__":
    ok = build()
    print(f"native build: {'ok' if ok else 'FAILED'} {_lib_path()}, "
          f"{omp_threads()} OpenMP threads")
