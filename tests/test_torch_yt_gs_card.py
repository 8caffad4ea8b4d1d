"""yt_gs_pass's CUDA kernel along grid axes 0 and 1 against its plain
version, on the card.

The file imports no JAX, so that it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_yt_gs_card.py -q

Without a CUDA device every test skips (the CPU tests hold the plain
versions themselves: tests/test_torch_yt_pass.py).
"""
import numpy as np
import pytest
import torch

from critic2_tpu_torch.analysis import yt
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
from critic2_tpu_torch.ops import yt_pass as ops

# anthracene's cell (X23, P2_1/a) with its a axis cut to 8 of the 384
# planes of the benchmark's 384 x 270 x 504 grid: the same grid lattice,
# K = 8; along axis 1 the planes are 8 x 504
ANTHRACENE_8 = ([15.901 * 8 / 384, 11.320, 20.967], [90, 125.293, 90])
# the same grid lattice with b cut to 8 of the 270 planes: along axis 1
# the full grid's 384 x 504 planes, cut as the benchmark's solve cuts them
ANTHRACENE_B8 = ([15.901, 11.320 * 8 / 270, 20.967], [90, 125.293, 90])
CUBIC = ([8.0, 8.0, 8.0], [90, 90, 90])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _operands(cell, shape, dev, seed=7):
    """(offs, f64 flux, (2,)+shape right-hand sides, a random state) of a
    noisy two-Gaussian density on the cell's lattice, on `dev`."""
    m = m_x2c_from_cellpar(*cell)
    c = crystal_from_arrays(m, [[0.25, 0.25, 0.25], [0.75, 0.7, 0.6]],
                            [0, 0], [("C", 6)])
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(n) / n for n in shape],
                             indexing="ij"), -1)
    rho = np.zeros(shape)
    for site, amp in zip(c.x_frac, (1.0, 0.8)):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ m.T) ** 2).sum(-1))
    rho = torch.as_tensor(rho + 1e-3 * rng.random(shape), device=dev)
    offs_np, wts = yt._grid_ws_neighbors(c, shape)
    offs = tuple(tuple(int(v) for v in o) for o in offs_np)
    chi, _ = yt._flux_tensors(rho, wts, offs)
    f = torch.stack([torch.ones_like(rho), rho])
    s = torch.as_tensor(rng.random((2,) + shape), device=dev)
    return offs, chi, f, s


@pytest.mark.card
# (the plan's tile and tiles where a case pins them, else None)
@pytest.mark.parametrize("cell, shape, axis, tiling", [
    (ANTHRACENE_8, (8, 270, 504), 1, None),
    (ANTHRACENE_8, (8, 270, 504), 0, (45, 23, 132)),
    # anthracene's solve: 132 tiles of 35 x 42 on its 384 x 504 planes,
    # 3 points a thread in float32, shared memory in float64
    (ANTHRACENE_B8, (384, 8, 504), 1, (35, 42, 132)),
    # planes of 50 x 37 along axis 1: 13 x 19 tiles, ragged on both axes
    (CUBIC, (50, 40, 37), 1, (13, 19, 8)),
    # planes of 21 x 45 along axis 1: 21 x 12 tiles, ragged along z
    (ANTHRACENE_8, (21, 19, 45), 1, (21, 12, 4))],
    ids=["anthracene-8x270x504-axis1", "anthracene-8x270x504-axis0",
         "anthracene-384x8x504-axis1", "cubic-ragged-axis1",
         "anthracene-ragged-axis1"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [True, False])
def test_kernel_sweeps_are_the_plain_sweeps_bitwise(card, cell, shape, axis,
                                                    tiling, dtype, adjoint):
    """A forward and a backward sweep from f, then one of each from a
    random state: every output and every flag bitwise equal."""
    offs, chi, f, s_rand = _operands(cell, shape, card)
    if cell is not CUBIC:
        assert len(offs) == 8 and yt._sweep_axis(offs) == 1
    tdt = getattr(torch, dtype)
    op = yt._shifted(chi, offs, tdt) if adjoint else chi.to(tdt)
    f, s_rand = f.to(tdt), s_rand.to(tdt)
    starts = [f, None, s_rand, s_rand]
    s_k = s_p = None
    for j, start in enumerate(starts):
        backward = j % 2 == 1
        a_k = s_k if start is None else start
        a_p = s_p if start is None else start
        s_k, flag_k = ops.yt_gs_pass(op, a_k, f, offs=offs, adjoint=adjoint,
                                     backward=backward, axis=axis)
        plan = ops.gs_counts()
        s_p, flag_p = ops.yt_gs_pass_plain(op, a_p, f, offs=offs,
                                           adjoint=adjoint,
                                           backward=backward, axis=axis)
        assert plan["axis"] == axis
        if tiling is not None:
            assert (*plan["tile"], plan["tiles"]) == tiling
        if shape in ((8, 270, 504), (384, 8, 504)) and tiling is not None:
            assert plan["ppt"] == (3 if dtype == "float32" else 0)
        assert int(flag_k) == int(flag_p), f"sweep {j}"
        assert torch.equal(s_k, s_p), (
            f"sweep {j}: max |diff| {float((s_k - s_p).abs().max()):.3e}, "
            f"plan {plan}")
    # the last state is off the fixpoint: its sweeps changed something
    assert int(flag_k) == 1
