"""The Yu-Trinkle flux-operator kernels: CUDA wrappers and plain versions.

One YT relaxation pass applies the uphill flux operator R to a stack of
scalar grids (analysis/yt.py):

  adjoint (charges):  out[p, x] = f[p, x] + sum_k chi'_k[x] s[p, x - o_k]
  forward (weights):  out[p, x] = f[p, x] + sum_k chi_k[x]  s[p, x + o_k]

where chi'_k = roll(chi_k, o_k) is the shifted flux tensor. Two kernels
replace the two Pallas kernels of critic2_tpu/ops/yt_pass.py:

  * yt_pass (csrc/yt_pass.cu): one Jacobi pass out = f + R s;
  * yt_gs_pass (csrc/yt_gs_pass.cu): one plane-ordered Gauss-Seidel sweep
    with an exact in-plane solve, plus an int32 changed-anything flag.

Each wrapper launches its CUDA kernel for tensors on a CUDA device (and
raises if it cannot) and computes its plain PyTorch version for tensors on
the CPU; nothing else picks between them. `launches` counts kernel
launches per wrapper. Both kernels take float32 and float64.
"""
from __future__ import annotations

import ctypes

import torch

from . import _ext

__all__ = ["yt_pass", "yt_gs_pass", "yt_pass_plain", "yt_gs_pass_plain",
           "launches", "reset_launches", "MAXK"]

MAXK = 14
launches = {"yt_pass": 0, "yt_gs_pass": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _disp(offs, adjoint):
    """Neighbour displacements d_k (the value x needs is s[x + d_k])."""
    sgn = -1 if adjoint else 1
    return [(sgn * int(o[0]), sgn * int(o[1]), sgn * int(o[2])) for o in offs]


def _gs_split(offs, adjoint):
    """(cross-plane [(k, d)] in summation order: d0 < 0 then d0 > 0, and
    in-plane [(k, d)]), as the Pallas kernel sums them."""
    disp = list(enumerate(_disp(offs, adjoint)))
    below = [(k, d) for k, d in disp if d[0] < 0]
    above = [(k, d) for k, d in disp if d[0] > 0]
    inplane = [(k, d) for k, d in disp if d[0] == 0]
    return below + above, inplane


def _roll(t, d, dims):
    """t shifted so that out[x] = t[x + d] (periodic)."""
    return torch.roll(t, tuple(-int(v) for v in d), dims)


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------
def yt_pass_plain(chiP, s, f3, *, offs, adjoint: bool = True):
    """out = f + R s with K torch.rolls (the kernel's term order)."""
    acc = f3
    for k, d in enumerate(_disp(offs, adjoint)):
        acc = acc + chiP[k] * _roll(s, d, (1, 2, 3))
    return acc


def yt_gs_pass_plain(chiP, s, f3, *, offs, adjoint: bool = True,
                     backward: bool = False):
    """One Gauss-Seidel sweep as a Python loop over planes with an in-plane
    while loop; returns (out, flag (1, 1) int32)."""
    n1 = s.shape[1]
    cross, inplane = _gs_split(offs, adjoint)
    out = torch.empty_like(s)
    changed = torch.zeros((), dtype=torch.bool, device=s.device)
    for i in (range(n1 - 1, -1, -1) if backward else range(n1)):
        base = f3[:, i]
        for k, d in cross:
            ii = i + d[0]
            swept = d[0] > 0 if backward else d[0] < 0
            src = out if (swept and 0 <= ii < n1) else s
            base = base + chiP[k, i] * _roll(src[:, ii % n1], d[1:], (1, 2))
        u = base
        if inplane:
            u = s[:, i]
            while True:
                un = base
                for k, d in inplane:
                    un = un + chiP[k, i] * _roll(u, d[1:], (1, 2))
                if torch.equal(un, u):
                    break
                u = un
        out[:, i] = u
        changed |= (u != s[:, i]).any()
    return out, changed.to(torch.int32).reshape(1, 1)


# ----------------------------------------------------------------------
# CUDA wrappers
# ----------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)


def _check(name, chiP, s, f3, offs):
    if not (chiP.is_cuda and s.is_cuda and f3.is_cuda):
        raise ValueError(f"{name}: chiP, s and f3 must all be on a CUDA "
                         "device (CPU tensors take the plain version)")
    if s.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {s.dtype}")
    if chiP.dtype != s.dtype or f3.dtype != s.dtype:
        raise TypeError(f"{name}: chiP, s and f3 must share one dtype")
    if s.dim() != 4 or f3.shape != s.shape:
        raise ValueError(f"{name}: s and f3 must be (P, n1, n2, n3)")
    if tuple(chiP.shape) != (len(offs),) + tuple(s.shape[1:]):
        raise ValueError(f"{name}: chiP must be (K, n1, n2, n3), K = "
                         f"len(offs) = {len(offs)}")
    if not 0 < len(offs) <= MAXK:
        raise ValueError(f"{name}: 1 <= K <= {MAXK}, got {len(offs)}")
    for t in (chiP, s, f3):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _ints(vals):
    vals = [int(v) for v in vals]
    return (ctypes.c_int * max(1, len(vals)))(*vals)


def _raise_on(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with CUDA "
                           f"error {err}")


def yt_pass(chiP, s, f3, *, offs, adjoint: bool = True):
    """One relaxation pass out = f + R s on a (P, n1, n2, n3) stack.

    chiP: (K, n1, n2, n3), ALREADY shifted (chi'_k) for the adjoint
    direction, unshifted chi_k for the forward one; offs: K (o0, o1, o2).
    """
    if s.device.type == "cpu":
        return yt_pass_plain(chiP, s, f3, offs=offs, adjoint=adjoint)
    _check("yt_pass", chiP, s, f3, offs)
    lib = _ext.load("yt_pass")
    fn = lib.yt_pass_f32 if s.dtype == torch.float32 else lib.yt_pass_f64
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _IP, _P]
    fn.restype = _I
    P, n1, n2, n3 = s.shape
    disp = _disp(offs, adjoint)
    out = torch.empty_like(s)
    with torch.cuda.device(s.device):
        err = fn(chiP.data_ptr(), s.data_ptr(), f3.data_ptr(),
                 out.data_ptr(), P, n1, n2, n3, len(disp),
                 _ints(v for d in disp for v in d),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on("yt_pass", err)
    launches["yt_pass"] += 1
    return out


def yt_gs_pass(chiP, s, f3, *, offs, adjoint: bool = True,
               backward: bool = False):
    """One plane-ordered Gauss-Seidel sweep of s = f + R s along axis 0.

    Conventions match yt_pass. Returns (out, flag): flag is a (1, 1) int32
    that is nonzero iff some point changed this sweep, so a full sweep
    with flag 0 proves s is the exact fixpoint."""
    if s.device.type == "cpu":
        return yt_gs_pass_plain(chiP, s, f3, offs=offs, adjoint=adjoint,
                                backward=backward)
    _check("yt_gs_pass", chiP, s, f3, offs)
    lib = _ext.load("yt_gs_pass")
    fn = (lib.yt_gs_pass_f32 if s.dtype == torch.float32
          else lib.yt_gs_pass_f64)
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _IP, _I, _IP, _P]
    fn.restype = _I
    P, n1, n2, n3 = s.shape
    cross, inplane = _gs_split(offs, adjoint)
    out = torch.empty_like(s)
    flag = torch.zeros((1, 1), dtype=torch.int32, device=s.device)
    scratch = torch.empty(3 * P * n2 * n3, dtype=s.dtype, device=s.device)
    chg = torch.zeros(3, dtype=torch.int32, device=s.device)
    with torch.cuda.device(s.device):
        err = fn(chiP.data_ptr(), s.data_ptr(), f3.data_ptr(),
                 out.data_ptr(), flag.data_ptr(), scratch.data_ptr(),
                 chg.data_ptr(), P, n1, n2, n3, int(backward),
                 len(cross), _ints(v for k, d in cross for v in (k, *d)),
                 len(inplane),
                 _ints(v for k, d in inplane for v in (k, d[1], d[2])),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on("yt_gs_pass", err)
    launches["yt_gs_pass"] += 1
    return out, flag
