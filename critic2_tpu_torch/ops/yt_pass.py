"""The Yu-Trinkle flux-operator kernels: CUDA wrappers and plain versions.

One YT relaxation pass applies the uphill flux operator R to a stack of
scalar grids (analysis/yt.py):

  adjoint (charges):  out[p, x] = f[p, x] + sum_k chi'_k[x] s[p, x - o_k]
  forward (weights):  out[p, x] = f[p, x] + sum_k chi_k[x]  s[p, x + o_k]

where chi'_k = roll(chi_k, o_k) is the shifted flux tensor. Two kernels
replace the two Pallas kernels of critic2_tpu/ops/yt_pass.py:

  * yt_pass (csrc/yt_pass.cu): one Jacobi pass out = f + R s;
  * yt_gs_pass (csrc/yt_gs_pass.cu): one plane-ordered Gauss-Seidel sweep
    with an exact in-plane solve, plus an int32 changed-anything flag. The
    sweep runs along grid axis 0 or 1 (`axis`): the planes are then (n2,
    n3) or (n1, n3), so z stays the contiguous row of a plane either way.
    The kernel solves each plane by rounds of block-Jacobi over tiles
    resident in shared memory and registers; `gs_plan` chooses the tile.

Each wrapper launches its CUDA kernel for tensors on a CUDA device (and
raises if it cannot) and computes its plain PyTorch version for tensors on
the CPU; nothing else picks between them. `launches` counts kernel
launches per wrapper. Both kernels take float32 and float64.

`gs_counts()` reads the schedule counters of one call, the last
yt_gs_pass call (grid barriers and block 0's local iterations of the
kernel; in-plane Jacobi iterations of the plain version); nothing reads
them unless asked. Each kernel call also hands its grid-barrier counter
to the program's record (utils/trace.py) as `yt_gs_pass.grid_barriers`,
which sums it across calls only when the record is read, and each launch
whose threads hold more than one tile point in registers counts one
`yt_gs_pass.multi_point_launches`.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _ext

__all__ = ["yt_pass", "yt_gs_pass", "yt_pass_plain", "yt_gs_pass_plain",
           "launches", "reset_launches", "gs_plan", "gs_counts", "MAXK"]

MAXK = 14
GS_MAXP = 8            # integrands per yt_gs_pass launch (register-held)
GS_MAX_PPT = 4         # tile points a thread holds in registers (f32, P <= 2)
GS_MIN_TILE = 256      # tile points below which a block's threads idle
launches = {"yt_pass": 0, "yt_gs_pass": 0}
# last yt_gs_pass call: the kernel's int64 device counters, or the plain
# version's per-plane in-plane Jacobi iterations
_last_counts = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


def gs_counts() -> dict:
    """Schedule counters of the last yt_gs_pass call (a host read).

    After a kernel launch: grid_barriers (= tile rounds summed over
    planes: a round ends in the kernel's only grid barrier),
    local_iters_block0 (block 0's in-tile Jacobi iterations summed over
    planes), and the plan: tile, tiles, pc (integrands per launch), res
    (the tile points' state held in registers), ppt (points a thread
    holds there, 0 without res) and the sweep's axis.
    After the plain version: jacobi_iters (per plane, in sweep order) and
    old_grid_barriers, what the global-Jacobi kernel schedule paid for the
    same sweep (one barrier per in-plane iteration and one per plane)."""
    c = _last_counts
    if "plain" in c:
        it = list(c["plain"])
        return {"jacobi_iters": it, "old_grid_barriers": sum(it) + len(it)}
    barriers, local = (int(x) for x in c["kernel"].tolist())
    return {"grid_barriers": barriers, "local_iters_block0": local,
            **c["plan"]}


def _disp(offs, adjoint):
    """Neighbour displacements d_k (the value x needs is s[x + d_k])."""
    sgn = -1 if adjoint else 1
    return [(sgn * int(o[0]), sgn * int(o[1]), sgn * int(o[2])) for o in offs]


def _gs_split(offs, adjoint, axis=0):
    """(cross-plane [(k, d)] in summation order: d0 < 0 then d0 > 0, and
    in-plane [(k, d)]), as the Pallas kernel sums them. d is in the
    sweep's axes: d0 across the planes, (d1, d2) in them, so along axis 1
    a displacement's steps along grid axes 0 and 1 trade places."""
    if axis not in (0, 1):
        raise ValueError(f"yt_gs_pass: sweeps along axis 0 or 1, not {axis} "
                         "(along axis 2 a plane's rows would be strided)")
    disp = list(enumerate(_disp(offs, adjoint)))
    if axis:
        disp = [(k, (d[1], d[0], d[2])) for k, d in disp]
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
                     backward: bool = False, axis: int = 0):
    """One Gauss-Seidel sweep along `axis` as a Python loop over planes
    with an in-plane while loop; returns (out, flag (1, 1) int32)."""
    cross, inplane = _gs_split(offs, adjoint, axis)
    result = out = torch.empty_like(s)
    # along axis 1, views whose axis 1 is the sweep's: plane i is [:, i]
    if axis:
        chiP, s, f3, out = (t.transpose(1, 2) for t in (chiP, s, f3, out))
    n1 = s.shape[1]
    changed = torch.zeros((), dtype=torch.bool, device=s.device)
    iters = []
    for i in (range(n1 - 1, -1, -1) if backward else range(n1)):
        base = f3[:, i]
        for k, d in cross:
            ii = i + d[0]
            swept = d[0] > 0 if backward else d[0] < 0
            src = out if (swept and 0 <= ii < n1) else s
            base = base + chiP[k, i] * _roll(src[:, ii % n1], d[1:], (1, 2))
        u = base
        n = 0
        if inplane:
            u = s[:, i]
            while True:
                un = base
                for k, d in inplane:
                    un = un + chiP[k, i] * _roll(u, d[1:], (1, 2))
                n += 1
                if torch.equal(un, u):
                    break
                u = un
        iters.append(n)
        out[:, i] = u
        changed |= (u != s[:, i]).any()
    _last_counts.clear()
    _last_counts["plain"] = iters
    return result, changed.to(torch.int32).reshape(1, 1)


def gs_halo(offs, adjoint: bool = True, axis: int = 0) -> int:
    """Halo width of yt_gs_pass's tiles: the largest in-plane |d1|, |d2|."""
    _, inplane = _gs_split(offs, adjoint, axis)
    return max((max(abs(d[1]), abs(d[2])) for _, d in inplane), default=0)


def gs_plan(P, n2, n3, h, ninp, itemsize, nsm, smem_max, threads,
            axis=0):
    """Tile plan of yt_gs_pass for P integrands on (n2, n3) planes (the
    grid's (n2, n3) in a sweep along axis 0, (n1, n3) along axis 1); the
    kernel only checks it against its layout.

    The (n2, n3) plane is cut into gy x gz tiles of ty x tz points (the
    last row and column of tiles may be ragged), one block each, with at
    most `nsm` tiles (one block per SM is co-resident) and at least
    GS_MIN_TILE points a tile where the plane allows. Among those tile
    grids it takes the fewest points a tile, then the shortest perimeter,
    then the longer rows (z is contiguous). A block keeps two halo'd
    Jacobi words per point and integrand and two int tables per halo'd
    point in shared memory (three along axis 1, whose grid offsets are not
    the exchange buffers'). A point's in-plane chi, base and value stay
    in registers (res) when ninp is 4 or 6 and each of the kernel's
    `threads` holds ppt = ceil(tile points / threads) of them: one at any
    pc, up to GS_MAX_PPT in float32 at pc <= 2 (at wider pc, or in
    float64, the kernel's registers would spill);
    else ninp chi words per point and one base word per point and
    integrand go in shared memory too (ppt 0). When the P integrands do
    not fit `smem_max` bytes together, or P exceeds GS_MAXP, they go in
    chunks of `pc` (one launch each).
    Returns dict(ty, tz, tiles, pc, res, ppt, smem); raises ValueError
    naming the limit when even one integrand does not fit."""
    target = max(1, min(nsm, -(-n2 * n3 // GS_MIN_TILE)))
    best = None
    for gy in range(1, min(n2, target) + 1):
        gz = min(n3, target // gy)
        ty, tz = -(-n2 // gy), -(-n3 // gz)
        key = (ty * tz, ty + tz, -tz)
        if best is None or key < best[0]:
            best = (key, ty, tz)
    _, ty, tz = best
    tiles = -(-n2 // ty) * -(-n3 // tz)
    area, halo = ty * tz, (ty + 2 * h) * (tz + 2 * h)
    need = -(-area // threads)      # points a thread
    for pc in range(min(P, GS_MAXP), 0, -1):
        res = ninp in (4, 6) and (need == 1 or (
            need <= GS_MAX_PPT and pc <= 2 and itemsize == 4))
        held = 0 if res else area   # points with chi and base in smem
        smem = (itemsize * (ninp * held + pc * held + 2 * pc * halo)
                + (12 if axis else 8) * halo)
        if smem <= smem_max:
            return dict(ty=ty, tz=tz, tiles=tiles, pc=pc, res=res,
                        ppt=need if res else 0, smem=smem)
    raise ValueError(
        f"yt_gs_pass: a {ty}x{tz} tile (halo {h}, {ninp} in-plane "
        f"neighbours) needs {smem} bytes of shared memory for one "
        f"integrand, above the {smem_max} a block may use; the {n2}x{n3} "
        f"plane is cut into at most {nsm} co-resident tiles")


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
    P, n1, n2, n3 = s.shape
    if n1 > 65535 or n1 * n2 * n3 >= 2**31:
        raise ValueError("yt_pass: the kernel takes n1 <= 65535 and fewer "
                         f"than 2^31 points an integrand, got {s.shape}")
    lib = _ext.load("yt_pass")
    fn = lib.yt_pass_f32 if s.dtype == torch.float32 else lib.yt_pass_f64
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _IP, _P]
    fn.restype = _I
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
               backward: bool = False, axis: int = 0):
    """One plane-ordered Gauss-Seidel sweep of s = f + R s along grid axis
    `axis` (0 or 1).

    Conventions match yt_pass. Returns (out, flag): flag is a (1, 1) int32
    that is nonzero iff some point changed this sweep, so a full sweep
    with flag 0 proves s is the exact fixpoint."""
    if s.device.type == "cpu":
        return yt_gs_pass_plain(chiP, s, f3, offs=offs, adjoint=adjoint,
                                backward=backward, axis=axis)
    _check("yt_gs_pass", chiP, s, f3, offs)
    lib = _ext.load("yt_gs_pass")
    P, n1, n2, n3 = s.shape
    cross, inplane = _gs_split(offs, adjoint, axis)
    h = gs_halo(offs, adjoint, axis)
    nu = n2 if axis == 0 else n1       # the planes' rows
    if axis and n1 * n2 * n3 >= 2**31:
        raise ValueError("yt_gs_pass: along axis 1 the kernel takes fewer "
                         f"than 2^31 points an integrand, got {s.shape}")
    with torch.cuda.device(s.device):
        nsm, smem_max, coop, threads = _gs_limits(lib)
        if not coop:
            raise RuntimeError("yt_gs_pass: the device has no cooperative "
                               "launch")
        # the kernel's static shared memory (one int) comes out of the
        # same per-block budget
        plan = gs_plan(P, nu, n3, h, len(inplane), s.element_size(), nsm,
                       smem_max - 16, threads, axis)
        fn = (lib.yt_gs_pass_f32 if s.dtype == torch.float32
              else lib.yt_gs_pass_f64)
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _IP, _I, _IP, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        pc = plan["pc"]
        out = torch.empty_like(s)
        flag = torch.zeros((1, 1), dtype=torch.int32, device=s.device)
        xbuf = torch.empty(2 * pc * nu * n3, dtype=s.dtype, device=s.device)
        chunks = range(0, P, pc)
        # each launch's round flags start from zeros
        chg = torch.zeros((len(chunks), 3), dtype=torch.int32,
                          device=s.device)
        counts = torch.zeros(2, dtype=torch.int64, device=s.device)
        cross_a = _ints(v for k, d in cross for v in (k, *d))
        inp_a = _ints(v for k, d in inplane for v in (k, d[1], d[2]))
        stride = n1 * n2 * n3 * s.element_size()
        for j, p0 in enumerate(chunks):
            err = fn(chiP.data_ptr(), s.data_ptr() + p0 * stride,
                     f3.data_ptr() + p0 * stride,
                     out.data_ptr() + p0 * stride, flag.data_ptr(),
                     xbuf.data_ptr(), chg[j].data_ptr(), counts.data_ptr(),
                     min(pc, P - p0), n1, n2, n3, axis, int(backward),
                     len(cross),
                     cross_a, len(inplane), inp_a, h, plan["ty"],
                     plan["tz"], plan["ppt"], plan["smem"],
                     torch.cuda.current_stream().cuda_stream)
            if err == _COOP_TOO_LARGE:
                raise RuntimeError(
                    f"yt_gs_pass: {plan['tiles']} tiles of "
                    f"{plan['ty']}x{plan['tz']} ({plan['smem']} bytes of "
                    "shared memory each) exceed the co-resident blocks")
            _raise_on("yt_gs_pass", err)
            launches["yt_gs_pass"] += 1
            if plan["ppt"] > 1:
                trace.count("yt_gs_pass.multi_point_launches")
    trace.count_device("yt_gs_pass.grid_barriers", counts, 0)
    _last_counts.clear()
    _last_counts["kernel"] = counts
    _last_counts["plan"] = dict(tile=(plan["ty"], plan["tz"]),
                                tiles=plan["tiles"], pc=pc, res=plan["res"],
                                ppt=plan["ppt"], axis=axis)
    return out, flag


_COOP_TOO_LARGE = 720          # cudaErrorCooperativeLaunchTooLarge
_limits = {}


def _gs_limits(lib):
    """(SMs, opt-in shared memory per block, cooperative launch) of the
    current device, queried once per device, and the kernel's threads per
    block."""
    dev = torch.cuda.current_device()
    if dev not in _limits:
        buf = (ctypes.c_int * 4)()
        lib.yt_gs_limits.argtypes = [_IP]
        lib.yt_gs_limits.restype = _I
        _raise_on("yt_gs_pass", lib.yt_gs_limits(buf))
        _limits[dev] = tuple(buf)
    return _limits[dev]
