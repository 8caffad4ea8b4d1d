"""The YT flux-operator kernels of the torch port against the JAX package.

On the CPU each wrapper computes its plain PyTorch version (the CUDA
kernels are held against those by chip_smoke.py on the card). The JAX side
is the XLA path the JAX package itself runs off-TPU: `f3 + _apply_R` for
one pass, `_xla_sweep` for the fixpoint.
"""
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.analysis import yt as jyt
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu_torch.analysis import yt as tyt
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.ops import yt_pass as ops

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CELLS = {"cubic": ([8.0, 8.0, 8.0], [90, 90, 90]),         # K = 6
         "triclinic": ([8.0, 7.0, 6.5], [75, 80, 70])}    # K = 14
# anthracene's angles (X23, P2_1/a): K = 8, two of the four cross-plane
# neighbours along axis 0 step within the plane, none along axis 1; only
# the cases of the sweep axis take it
LATTICES = dict(CELLS, monoclinic=([15.901, 11.320, 20.967],
                                   [90, 125.293, 90]))
SHAPE = (10, 9, 8)


def _flux(lattice, seed=5, shape=SHAPE):
    """(offs, chi (K,)+shape f64 numpy, f3 (2,)+shape) for a noisy
    two-Gaussian density on the given lattice."""
    m = m_x2c_from_cellpar(*LATTICES[lattice])
    c = crystal_from_arrays(m, [[0.25, 0.25, 0.25], [0.75, 0.7, 0.6]],
                            [0, 0], [("C", 6)])
    g = np.stack(np.meshgrid(*[np.arange(s) / s for s in shape],
                             indexing="ij"), -1)
    rho = np.zeros(shape)
    for site, amp in zip(c.x_frac, (1.0, 0.8)):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ m.T) ** 2).sum(-1))
    rng = np.random.default_rng(seed)
    rho += 1e-3 * rng.random(shape)
    offs_np, wts = tyt._grid_ws_neighbors(c, shape)
    offs = tuple(tuple(int(v) for v in o) for o in offs_np)
    chi, _ = tyt._flux_tensors(torch.as_tensor(rho), wts, offs)
    f3 = np.stack([np.ones(shape), rho])
    return offs, chi.numpy(), f3


def _operand(chi, offs, adjoint, dtype):
    """What the kernels take: chi shifted for the adjoint, else plain."""
    t = torch.as_tensor(chi)
    return tyt._shifted(t, offs, dtype) if adjoint else t.to(dtype)


@pytest.mark.parametrize("lattice", list(CELLS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [True, False])
def test_yt_pass_matches_jax_apply_R(lattice, dtype, adjoint):
    offs, chi, f3 = _flux(lattice)
    assert len(offs) == (6 if lattice == "cubic" else 14)
    s = np.random.default_rng(1).random(f3.shape)
    tdt = getattr(torch, dtype)
    ops.reset_launches()
    out = ops.yt_pass(_operand(chi, offs, adjoint, tdt),
                      torch.as_tensor(s, dtype=tdt),
                      torch.as_tensor(f3, dtype=tdt), offs=offs,
                      adjoint=adjoint)
    assert out.dtype == tdt
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert ops.launches == {"yt_pass": 0, "yt_gs_pass": 0}
    ref = np.asarray(jnp.asarray(f3, dtype) + jyt._apply_R(
        jnp.asarray(chi, dtype), jnp.asarray(s, dtype), offs=offs,
        adjoint=adjoint))
    # f32: one rounding per term, summed in another order
    rtol = 1e-6 if dtype == "float32" else 1e-13
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _gs_fixpoint(op, f3, offs, adjoint):
    s, flags = f3, []
    for _ in range(sum(f3.shape[1:]) + 16):
        s, c1 = ops.yt_gs_pass(op, s, f3, offs=offs, adjoint=adjoint,
                               backward=False)
        s, c2 = ops.yt_gs_pass(op, s, f3, offs=offs, adjoint=adjoint,
                               backward=True)
        flags.append((int(c1), int(c2)))
        if flags[-1] == (0, 0):
            return s, flags
    raise AssertionError("no Gauss-Seidel fixpoint")


@pytest.mark.parametrize("lattice", list(CELLS))
@pytest.mark.parametrize("adjoint", [True, False])
def test_yt_gs_pass_fixpoint_matches_jax_xla_sweep(lattice, adjoint):
    offs, chi, f3 = _flux(lattice)
    op = _operand(chi, offs, adjoint, torch.float64)
    s, flags = _gs_fixpoint(op, torch.as_tensor(f3), offs, adjoint)
    assert flags[0] != (0, 0)
    ref = np.asarray(jyt._xla_sweep(jnp.asarray(chi), jnp.asarray(f3),
                                    offs=offs, adjoint=adjoint))
    # both are exact fixpoints of the nilpotent system, reached by
    # different summation orders
    np.testing.assert_allclose(s.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("lattice", list(CELLS))
@pytest.mark.parametrize("backward", [False, True])
def test_yt_gs_pass_flag_zero_on_fixpoint(lattice, backward):
    offs, chi, f3 = _flux(lattice)
    op = _operand(chi, offs, True, torch.float64)
    f3t = torch.as_tensor(f3)
    s, _ = _gs_fixpoint(op, f3t, offs, True)
    out, flag = ops.yt_gs_pass(op, s, f3t, offs=offs, adjoint=True,
                               backward=backward)
    assert flag.shape == (1, 1) and flag.dtype == torch.int32
    assert int(flag) == 0
    assert torch.equal(out, s)
    # and a point off the fixpoint raises it
    s2 = s.clone()
    s2[1, 3, 4, 5] += 1.0
    _, flag = ops.yt_gs_pass(op, s2, f3t, offs=offs, adjoint=True,
                             backward=backward)
    assert int(flag) == 1


def _transposed(t):
    """t with grid axes 0 and 1 exchanged, contiguous."""
    return t.transpose(1, 2).contiguous()


@pytest.mark.parametrize("lattice", list(LATTICES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [True, False])
@pytest.mark.parametrize("backward", [False, True])
def test_yt_gs_pass_along_axis_1_is_axis_0_on_the_transposed_stack(
        lattice, dtype, adjoint, backward):
    offs, chi, f3 = _flux(lattice)
    tdt = getattr(torch, dtype)
    op = _operand(chi, offs, adjoint, tdt)
    f = torch.as_tensor(f3, dtype=tdt)
    s = torch.as_tensor(np.random.default_rng(3).random(f3.shape), dtype=tdt)
    out, flag = ops.yt_gs_pass(op, s, f, offs=offs, adjoint=adjoint,
                               backward=backward, axis=1)
    # the plain version of a sweep along axis 0 of the stack whose axes 0
    # and 1 are exchanged, with the offsets' steps exchanged alike
    swapped = tuple((o[1], o[0], o[2]) for o in offs)
    ref, ref_flag = ops.yt_gs_pass_plain(
        _transposed(op), _transposed(s), _transposed(f), offs=swapped,
        adjoint=adjoint, backward=backward)
    assert out.is_contiguous() and out.shape == s.shape
    assert torch.equal(out, _transposed(ref))
    assert int(flag) == int(ref_flag) == 1
    assert len(ops.gs_counts()["jacobi_iters"]) == SHAPE[1]
    # the in-plane neighbours of the sweep along axis 1
    _, inplane = ops._gs_split(offs, adjoint, axis=1)
    assert len(inplane) == {"cubic": 4, "triclinic": 6,
                            "monoclinic": 6}[lattice]
    assert ops.gs_halo(offs, adjoint, axis=1) == 1
    with pytest.raises(ValueError, match="axis 0 or 1"):
        ops.yt_gs_pass(op, s, f, offs=offs, adjoint=adjoint, axis=2)


def test_yt_gs_pass_one_sweep_semantics():
    """One forward sweep of the plain version equals a direct plane loop
    that reads swept planes below from `out`, the rest from old s."""
    offs, chi, f3 = _flux("triclinic")
    op = _operand(chi, offs, False, torch.float64)
    f3t = torch.as_tensor(f3)
    s = torch.as_tensor(np.random.default_rng(2).random(f3.shape))
    out, _ = ops.yt_gs_pass(op, s, f3t, offs=offs, adjoint=False)
    # residual of the swept planes against the GS update rule
    n1 = SHAPE[0]
    for i in range(n1):
        acc = f3t[:, i].clone()
        for k, o in enumerate(offs):
            j = i + o[0]
            src = out if (o[0] < 0 and j >= 0) or o[0] == 0 else s
            acc = acc + op[k, i] * torch.roll(src[:, j % n1],
                                              (-o[1], -o[2]), (1, 2))
        torch.testing.assert_close(out[:, i], acc, rtol=1e-13, atol=1e-13)


# ----------------------------------------------------------------------
# the yt_pass kernel's addressing, and its library yardstick
# ----------------------------------------------------------------------
CUBE = (12, 12, 12)
# displacements longer than the (3, 2, 5) grid's axes
WIDE = ((3, 0, -4), (-5, 2, 1), (0, -7, 6))


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pass_input(case, shape, P, dtype, adjoint):
    """(offs, operand, s, f) of a P-integrand pass: the flux of a noisy
    density on a lattice of CELLS, or random chi on WIDE displacements."""
    rng = np.random.default_rng(P)
    if case == "wide":
        offs = WIDE
        chi = rng.random((len(WIDE),) + shape)
        f3 = rng.random((2,) + shape)
    else:
        offs, chi, f3 = _flux(case, shape=shape)
        assert len(offs) == (6 if case == "cubic" else 14)
    tdt = getattr(torch, dtype)
    f = torch.as_tensor(np.concatenate([f3, rng.random((P,) + shape)])[:P],
                        dtype=tdt)
    s = torch.as_tensor(rng.random((P,) + shape), dtype=tdt)
    return offs, _operand(chi, offs, adjoint, tdt), s, f


def _kernel_addressing(chiP, s, f3, offs, adjoint):
    """out = f + R s by the CUDA kernel's addressing, emulated: each
    displacement reduced to [0, n) on its axis, a neighbour index wrapped
    by one compare and subtract, the neighbour's flat index a plane base
    plus an in-plane offset, the same K indices for every integrand, the
    terms added in the order k."""
    P, n1, n2, n3 = s.shape
    n = (n1, n2, n3)
    i, j, l = torch.meshgrid(*[torch.arange(v) for v in n], indexing="ij")
    sf = s.reshape(P, -1)
    acc = f3.reshape(P, -1)
    for k, d in enumerate(ops._disp(offs, adjoint)):
        ii, jj, ll = ((a + (v % m + m) % m) for a, v, m in
                      zip((i, j, l), d, n))
        ii, jj, ll = (torch.where(a >= m, a - m, a)
                      for a, m in zip((ii, jj, ll), n))
        nb = (ii * (n2 * n3) + (jj * n3 + ll)).reshape(-1)
        acc = acc + chiP[k].reshape(-1) * sf[:, nb]
    return acc.reshape(s.shape)


@pytest.mark.parametrize("case", ["cubic", "triclinic", "wide"])
@pytest.mark.parametrize("shape", [SHAPE, (3, 2, 5)])
@pytest.mark.parametrize("P", [1, 9])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [True, False])
def test_kernel_addressing_gives_the_plain_pass_bitwise(case, shape, P,
                                                         dtype, adjoint):
    offs, op, s, f = _pass_input(case, shape, P, dtype, adjoint)
    assert torch.equal(_kernel_addressing(op, s, f, offs, adjoint),
                       ops.yt_pass_plain(op, s, f, offs=offs,
                                         adjoint=adjoint))


@pytest.mark.parametrize("shape", [SHAPE, CUBE])
@pytest.mark.parametrize("lattice", list(CELLS))
@pytest.mark.parametrize("P", [1, 2, 9])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [True, False])
def test_flux_csr_product_is_the_plain_pass(chip_smoke, shape, lattice, P,
                                            dtype, adjoint):
    offs, op, s, f = _pass_input(lattice, shape, P, dtype, adjoint)
    N, K = int(np.prod(shape)), len(offs)
    R = chip_smoke.flux_csr(op, offs, adjoint)
    assert R.layout == torch.sparse_csr and R.shape == (N, N)
    assert R.crow_indices().dtype == R.col_indices().dtype == torch.int32
    col = R.col_indices().reshape(N, K)
    assert bool((col[:, 1:] > col[:, :-1]).all())    # sorted, distinct
    out = torch.sparse.addmm(f.reshape(P, N).T, R, s.reshape(P, N).T)
    plain = ops.yt_pass_plain(op, s, f, offs=offs, adjoint=adjoint)
    # the CSR product sums the K terms in column order and adds f last;
    # float32 rounds each of its K + 1 sums at 6e-8
    rtol = 1e-13 if dtype == "float64" else 1e-6
    ref = plain.reshape(P, N).T
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    # the plain pass takes each integrand on its own
    assert torch.equal(plain, torch.cat([
        ops.yt_pass_plain(op, s[p:p + 1], f[p:p + 1], offs=offs,
                          adjoint=adjoint) for p in range(P)]))


def test_wrappers_reject_mismatched_input():
    offs, chi, f3 = _flux("cubic")
    op = _operand(chi, offs, True, torch.float64)
    with pytest.raises(ValueError):
        ops._check("yt_pass", op, torch.as_tensor(f3),
                   torch.as_tensor(f3), offs)     # CPU tensors


# ----------------------------------------------------------------------
# the schedule the yt_gs_pass kernel relies on
# ----------------------------------------------------------------------
def _kernel_define(name):
    src = os.path.join(os.path.dirname(ops.__file__), os.pardir, "csrc",
                       "yt_gs_pass.cu")
    with open(src) as fh:
        return int(re.search(rf"#define {name} (\d+)", fh.read()).group(1))


# the kernel's cap on a tile's local iterations in one round
LOCAL_CAP = _kernel_define("YT_GS_LOCAL_CAP")


def _tile_round_sweep(chiP, s, f3, offs, adjoint, backward, tile,
                      cap=LOCAL_CAP, axis=0):
    """One sweep along `axis` by the CUDA kernel's schedule, emulated on
    the CPU.

    Each plane's in-plane system is solved by rounds of block-Jacobi over
    (ty, tz) tiles (ragged at the far edges): in a round every tile
    iterates by Jacobi with its halo (the neighbours' values at the round's
    start, wrapped periodically) held fixed until it is stationary or has
    taken `cap` iterations; the rounds end when every tile is stationary
    and no point within h of a tile's edge changed. All tiles iterate
    together: a stationary tile's Jacobi step is a no-op. Along axis 1 the
    planes are (n1, n3), (y, z) below their axes. Returns (out, flag,
    rounds per plane in sweep order)."""
    cross, inplane = ops._gs_split(offs, adjoint, axis)
    h = ops.gs_halo(offs, adjoint, axis)
    result = out = torch.empty_like(s)
    # along axis 1, views whose axis 1 is the sweep's: plane i is [:, i]
    if axis:
        chiP, s, f3, out = (t.transpose(1, 2) for t in (chiP, s, f3, out))
    P, n1, n2, n3 = s.shape
    ty, tz = tile
    y = torch.arange(n2)[:, None]
    z = torch.arange(n3)[None, :]
    ny = torch.clamp(n2 - y // ty * ty, max=ty)    # rows of y's tile
    nz = torch.clamp(n3 - z // tz * tz, max=tz)
    edge = ((y % ty < h) | (y % ty >= ny - h) | (z % tz < h)
            | (z % tz >= nz - h))
    # where x's neighbour x + d is read from: [u, u at the round's start]
    # flattened; the current u when x + d lies in x's own tile without
    # wrapping, else the frozen halo
    nbmap = []
    for _, d in inplane:
        yy, zz = y + d[1], z + d[2]
        inside = ((yy // ty == y // ty) & (yy >= 0) & (yy < n2)
                  & (zz // tz == z // tz) & (zz >= 0) & (zz < n3))
        flat = (yy % n2) * n3 + zz % n3
        nbmap.append((flat + torch.where(inside, 0, n2 * n3)).reshape(-1))
    nbmap = torch.stack(nbmap) if inplane else None
    changed = False
    rounds = []
    for i in (range(n1 - 1, -1, -1) if backward else range(n1)):
        base = f3[:, i]
        for k, d in cross:
            ii = i + d[0]
            swept = d[0] > 0 if backward else d[0] < 0
            src = out if (swept and 0 <= ii < n1) else s
            base = base + chiP[k, i] * ops._roll(src[:, ii % n1], d[1:],
                                                 (1, 2))
        u = s[:, i] if inplane else base
        nround = 0
        while True:
            start = u.reshape(P, -1)
            eany = False
            for it in range(1, cap + 1 if inplane else 0):
                nb = torch.cat([u.reshape(P, -1), start], 1)[:, nbmap]
                un = base
                for c, (k, _) in enumerate(inplane):
                    un = un + chiP[k, i] * nb[:, c].reshape(P, n2, n3)
                diff = un != u
                eany |= bool((diff & edge).any())
                if not diff.any():
                    break
                u = un
                eany |= it == cap           # a tile is not stationary yet
            nround += 1
            if not eany:
                break
        rounds.append(nround)
        out[:, i] = u
        changed |= bool((u != s[:, i]).any())
    return result, int(changed), rounds


def _case_input(lattice, P, dtype, adjoint):
    offs, chi, f3 = _flux(lattice)
    rng = np.random.default_rng(P)
    tdt = getattr(torch, dtype)
    f = torch.as_tensor(np.concatenate([f3, rng.random((P,) + SHAPE)])[:P],
                        dtype=tdt)
    return offs, _operand(chi, offs, adjoint, tdt), f


# (P, tile, cap): (3, 4) divides the (9, 8) plane, (4, 3) leaves ragged
# tiles on both axes, (9, 8) is one tile whose halo wraps onto itself; a
# cap of 2 local iterations a round stands for the kernel's cap on planes
# whose chains are longer than it
TILE_CASES = [(1, (4, 3), LOCAL_CAP), (2, (3, 4), LOCAL_CAP),
              (8, (4, 3), 2), (2, (9, 8), 2)]


@pytest.mark.parametrize("lattice", list(CELLS))
@pytest.mark.parametrize("adjoint", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
# each case along axis 0, then along axis 1, whose planes are (10, 8):
# there (9, 8) leaves a ragged second tile
@pytest.mark.parametrize("P, tile, cap, axis", [
    pytest.param(P, tile, cap, axis,
                 id=f"{P}-tile{j}-{cap}" + ("-axis1" if axis else ""))
    for axis in (0, 1) for j, (P, tile, cap) in enumerate(TILE_CASES)])
def test_tile_rounds_reach_the_plain_sweeps_bitwise(lattice, adjoint, dtype,
                                                    P, tile, cap, axis):
    offs, op, f = _case_input(lattice, P, dtype, adjoint)
    s_t = s_p = f
    for sweep in range(3):
        backward = sweep % 2 == 1
        s_t, flag_t, rounds = _tile_round_sweep(op, s_t, f, offs, adjoint,
                                                backward, tile, cap, axis)
        s_p, flag_p = ops.yt_gs_pass_plain(op, s_p, f, offs=offs,
                                           adjoint=adjoint,
                                           backward=backward, axis=axis)
        assert torch.equal(s_t, s_p), f"sweep {sweep}"
        assert flag_t == int(flag_p), f"sweep {sweep}"
        jacobi = ops.gs_counts()["jacobi_iters"]
        assert all(r <= j for r, j in zip(rounds, jacobi)), (rounds, jacobi)
        if sweep == 0:
            assert flag_t == 1 and max(jacobi) > 2


def test_gs_counts_of_the_plain_version():
    offs, op, f = _case_input("cubic", 2, "float64", True)
    ops.yt_gs_pass_plain(op, f, f, offs=offs)
    c = ops.gs_counts()
    assert len(c["jacobi_iters"]) == SHAPE[0]
    assert min(c["jacobi_iters"]) >= 1
    assert c["old_grid_barriers"] == sum(c["jacobi_iters"]) + SHAPE[0]


@pytest.mark.parametrize("lattice", list(CELLS))
def test_gs_halo_covers_the_in_plane_neighbours(lattice):
    offs, _, _ = _flux(lattice)
    for adjoint in (True, False):
        _, inplane = ops._gs_split(offs, adjoint)
        assert len(inplane) == (4 if lattice == "cubic" else 6)
        assert ops.gs_halo(offs, adjoint) == 1


H100 = dict(nsm=132, smem_max=232448,
            threads=_kernel_define("YT_GS_THREADS"))
# the most tile points a thread of the kernel holds in registers
MAX_PPT = _kernel_define("YT_GS_MAX_PPT")


@pytest.mark.parametrize("P, n2, n3, ninp, itemsize", [
    (2, 256, 256, 4, 4),      # the 256^3 slice's f32 sweeps
    (8, 256, 256, 6, 8),      # labels' chunk of 8 basins, f64, K = 14
    (2, 48, 48, 6, 4),
    (8, 50, 37, 4, 8),        # ragged on both axes
    (8, 512, 512, 6, 4),      # the integrands go in chunks
    (1, 9, 8, 4, 8),
    (12, 64, 64, 4, 4),       # more integrands than one launch holds
    (2, 270, 504, 4, 4),      # anthracene's plane: 3 points a thread
    (2, 264, 264, 6, 4),      # 2 points a thread, ninp 6
    (8, 270, 504, 4, 4),      # labels' chunk of 8 there: shared memory
    (2, 270, 504, 4, 8)])     # float64 there: shared memory
def test_gs_plan_fits_the_card(P, n2, n3, ninp, itemsize):
    plan = ops.gs_plan(P, n2, n3, 1, ninp, itemsize, **H100)
    ty, tz = plan["ty"], plan["tz"]
    gy, gz = -(-n2 // ty), -(-n3 // tz)
    assert plan["tiles"] == gy * gz <= H100["nsm"]
    # every tile holds at least one point: the grid covers the plane
    assert (gy - 1) * ty < n2 <= gy * ty and (gz - 1) * tz < n3 <= gz * tz
    assert 1 <= plan["pc"] <= min(P, ops.GS_MAXP)
    # points in registers where a block's threads hold at most MAX_PPT of
    # them a thread in float32 at a launch's P <= 2, or one a thread at
    # any P
    ppt = -(-ty * tz // H100["threads"])
    assert plan["res"] == (ninp in (4, 6) and (
        ppt == 1 or (ppt <= MAX_PPT and plan["pc"] <= 2 and itemsize == 4)))
    assert plan["ppt"] == (ppt if plan["res"] else 0)
    held = 0 if plan["res"] else ty * tz
    assert plan["smem"] == itemsize * (
        ninp * held + plan["pc"] * (held + 2 * (ty + 2) * (tz + 2))
    ) + 8 * (ty + 2) * (tz + 2)
    assert plan["smem"] <= H100["smem_max"]
    # along axis 1 a third int table: the grid offsets of the same tile
    plan1 = ops.gs_plan(P, n2, n3, 1, ninp, itemsize, **H100, axis=1)
    if (plan1["ty"], plan1["tz"], plan1["pc"]) == (ty, tz, plan["pc"]):
        assert plan1["smem"] == plan["smem"] + 4 * (ty + 2) * (tz + 2)
    assert plan1["smem"] <= H100["smem_max"]
    if P * n2 * n3 >= 2 * 256 * 256:
        assert plan["tiles"] >= 120        # the card is filled
    if (n2, n3) == (256, 256) and itemsize == 4:
        assert (ty, tz, plan["pc"], plan["ppt"]) == (16, 32, P, 1)
    if (P, n2) in ((8, 512), (12, 64)):
        assert plan["pc"] < P              # launched in chunks
    if (n2, n3) == (270, 504):
        assert (ty, tz, plan["tiles"]) == (45, 23, 132)
        assert plan["ppt"] == (3 if P <= 2 and itemsize == 4 else 0)
    if (n2, n3) == (264, 264):
        assert plan["res"] and plan["ppt"] == 2


@pytest.mark.parametrize("ninp", [4, 6, 8])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_gs_plan_keeps_ppt_within_the_kernel(ninp, itemsize):
    # every plan's ppt has a kernel instance: 1 at any P, up to the
    # kernel's compile-time maximum in float32 at P <= 2, 0 for shared
    # memory
    assert ops.GS_MAX_PPT == MAX_PPT
    for n in (8, 64, 200, 256, 264, 270, 300, 384, 504, 512, 640, 800):
        for n2, n3 in ((n, n), (n, 504), (270, n)):
            for P in (1, 2, 3, 8, 9):
                try:
                    plan = ops.gs_plan(P, n2, n3, 1, ninp, itemsize, **H100)
                except ValueError:
                    continue                # no tile fits shared memory
                assert 0 <= plan["ppt"] <= MAX_PPT
                assert plan["res"] == (plan["ppt"] > 0)
                assert plan["ppt"] <= 1 or (plan["pc"] <= 2
                                            and itemsize == 4)
                assert plan["ppt"] == 0 or ninp in (4, 6)


def test_gs_plan_raises_at_the_shared_memory_limit():
    with pytest.raises(ValueError, match="shared memory"):
        ops.gs_plan(1, 1024, 1024, 1, 6, 8, **H100)
