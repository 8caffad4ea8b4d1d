"""The YT flux-operator kernels of the torch port against the JAX package.

On the CPU each wrapper computes its plain PyTorch version (the CUDA
kernels are held against those by chip_smoke.py on the card). The JAX side
is the XLA path the JAX package itself runs off-TPU: `f3 + _apply_R` for
one pass, `_xla_sweep` for the fixpoint.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.analysis import yt as jyt
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu_torch.analysis import yt as tyt
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.ops import yt_pass as ops

CELLS = {"cubic": ([8.0, 8.0, 8.0], [90, 90, 90]),         # K = 6
         "triclinic": ([8.0, 7.0, 6.5], [75, 80, 70])}    # K = 14
SHAPE = (10, 9, 8)


def _flux(lattice, seed=5):
    """(offs, chi (K,)+SHAPE f64 numpy, f3 (2,)+SHAPE) for a noisy
    two-Gaussian density on the given lattice."""
    m = m_x2c_from_cellpar(*CELLS[lattice])
    c = crystal_from_arrays(m, [[0.25, 0.25, 0.25], [0.75, 0.7, 0.6]],
                            [0, 0], [("C", 6)])
    g = np.stack(np.meshgrid(*[np.arange(s) / s for s in SHAPE],
                             indexing="ij"), -1)
    rho = np.zeros(SHAPE)
    for site, amp in zip(c.x_frac, (1.0, 0.8)):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ m.T) ** 2).sum(-1))
    rng = np.random.default_rng(seed)
    rho += 1e-3 * rng.random(SHAPE)
    offs_np, wts = tyt._grid_ws_neighbors(c, SHAPE)
    offs = tuple(tuple(int(v) for v in o) for o in offs_np)
    chi, _ = tyt._flux_tensors(torch.as_tensor(rho), wts, offs)
    f3 = np.stack([np.ones(SHAPE), rho])
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


def test_wrappers_reject_mismatched_input():
    offs, chi, f3 = _flux("cubic")
    op = _operand(chi, offs, True, torch.float64)
    with pytest.raises(ValueError):
        ops._check("yt_pass", op, torch.as_tensor(f3),
                   torch.as_tensor(f3), offs)     # CPU tensors
