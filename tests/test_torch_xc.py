"""The port's exchange-correlation kernels (ops/xc.py) against the JAX
package, on the CPU.

Every functional id of XC_IDS is evaluated by both packages on the same
inputs, made from a numpy seed, to 1e-12 relative. The id tables of
tests/test_xc.py (its limits and cross-functional identities) skip here
as a whole file, since its module needs the reference's h2o.wfx; they
run again on the port by calling those test functions with the JAX
module's xc_eval and _lambertw0 swapped for the port's.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import critic2_tpu.ops.xc as jxc
from critic2_tpu_torch.ops import xc as txc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_xc  # noqa: E402

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)


def _inputs(n=257):
    """rho over 12 decades, |grad rho| over the reduced-gradient range,
    tau from von Weizsaecker upward, laplacian of either sign."""
    rng = np.random.default_rng(2024)
    rho = 10.0 ** rng.uniform(-6, 1.5, n)
    s = 10.0 ** rng.uniform(-3, 1.2, n)
    grad = s * 2.0 * (3 * np.pi ** 2) ** (1 / 3) * rho ** (4 / 3)
    tau = grad ** 2 / (8 * rho) * rng.uniform(1.0, 3.0, n) \
        + 0.3 * (3 * np.pi ** 2) ** (2 / 3) * rho ** (5 / 3) \
        * rng.uniform(0.0, 2.0, n)
    lap = rng.normal(size=n) * rho
    return rho, grad, lap, 0.5 * tau


def test_the_id_table_is_the_reference_table():
    assert txc.XC_IDS == jxc.XC_IDS
    assert len(txc.XC_IDS) == 31


@pytest.mark.parametrize("fid", sorted(jxc.XC_IDS))
def test_functional_matches_jax(fid):
    """xc_eval(fid, ...) of both packages, 1e-10 relative (the two
    libraries' exp/log differ in the last bits, and a few correlation
    forms lose four digits to cancellation where t is large)."""
    args = _inputs()
    nargs = jxc._FUNCS[jxc.XC_IDS[fid]][1]
    ref = np.asarray(jxc.xc_eval(fid, *[jnp.asarray(a)
                                        for a in args[:nargs]]))
    got = txc.xc_eval(fid, *[torch.as_tensor(a) for a in args[:nargs]])
    assert got.dtype == torch.float64 and got.shape == (len(args[0]),)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=0)


def test_python_numbers_and_extra_arguments():
    """Scalars are lifted to f64 tensors; arguments beyond the family's
    count are ignored, as in the JAX package; an unknown id raises."""
    got = txc.xc_eval(101, torch.tensor([0.3], dtype=torch.float64), 0.2,
                       7.0, 9.0)
    ref = float(jxc.xc_eval(101, jnp.asarray([0.3]), jnp.asarray([0.2]))[0])
    assert abs(float(got[0]) - ref) <= 1e-15 * abs(ref)
    with pytest.raises(ValueError, match="unsupported"):
        txc.xc_eval(5, torch.tensor([0.3], dtype=torch.float64))
    with pytest.raises(ValueError, match="needs 2"):
        txc.xc_eval(101, torch.tensor([0.3], dtype=torch.float64))


def _port_xc_eval(fid, *args):
    return txc.xc_eval(fid, *[torch.as_tensor(np.asarray(a, float))
                              for a in args]).numpy()


def _port_lambertw0(x):
    return txc._lambertw0(torch.as_tensor(np.asarray(x, float))).numpy()


@pytest.mark.parametrize("case", ["test_extra_lda_gga_ids",
                                  "test_round4_gga_ids",
                                  "test_round5_gga_and_hybrid_ids",
                                  "test_round5_tranche6_ids"])
def test_id_tables_of_the_reference_tests_hold_on_the_port(case,
                                                            monkeypatch):
    """tests/test_xc.py:86-305, each limit and identity with its own
    tolerance, evaluated by the port."""
    monkeypatch.setattr(jxc, "xc_eval", _port_xc_eval)
    monkeypatch.setattr(jxc, "_lambertw0", _port_lambertw0)
    getattr(test_xc, case)()
