"""The port's sequential C++ reference (critic2_tpu_torch/native.py)
against the JAX package's bindings of the same source, bit for bit; the
port's own routes against it; and its build rules.

The JAX package's library is built here into a temporary directory with
that package's own build() (its flags, its source), so this file never
races tests/test_native.py for native/build/.
"""
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

from critic2_tpu import native as jnative
from critic2_tpu_torch import native
from critic2_tpu_torch.analysis.nci import nciplot
from critic2_tpu_torch.analysis.yt import _grid_ws_neighbors, yt_integrate
from critic2_tpu_torch.convert import crystal_from_arrays, system_from_arrays
from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
from critic2_tpu_torch.ops.interp import interp_soa

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

# tests/test_molden.py's H2/STO-3G text
H2_MOLDEN = textwrap.dedent("""\
    [Molden Format]
    [Atoms] AU
    H 1 1 0.0 0.0 0.0
    H 2 1 0.0 0.0 1.4
    [GTO]
    1 0
     s 3 1.00
      3.42525091 0.15432897
      0.62391373 0.53532814
      0.16885540 0.44463454

    2 0
     s 3 1.00
      3.42525091 0.15432897
      0.62391373 0.53532814
      0.16885540 0.44463454

    [MO]
    Sym= A1
    Ene= -0.578
    Spin= Alpha
    Occup= 2.0
      1 0.54893404
      2 0.54893404
    Sym= A2
    Ene= 0.671
    Spin= Alpha
    Occup= 0.0
      1 1.21146407
      2 -1.21146407
""")

A = 8.0                                    # cubic cell edge (bohr)
SITES = np.array([[0.25, 0.25, 0.25], [0.7, 0.67, 0.73]])


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both packages' libraries, or a skip when g++ is absent (as the
    JAX package's own tests skip)."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    out = str(tmp_path_factory.mktemp("jaxnative") / "libcritic2_native.so")
    saved = jnative._OUT, jnative._LIB, jnative._TRIED_BUILD
    jnative._OUT, jnative._LIB, jnative._TRIED_BUILD = out, None, False
    try:
        assert jnative.build()
    finally:
        jnative._OUT = saved[0]
    assert native.available()
    # two copies of one library in one process keep their own symbols
    assert jnative._LIB._name != native._LIB._name
    return jnative, native


def _grid(n, rng, noise=1e-3):
    """Two Gaussians on an n^3 grid of the cubic cell, plus noise."""
    m = np.eye(3) * A
    g = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    rho = np.zeros((n, n, n))
    for site, amp in zip(SITES, (1.0, 0.8)):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ m.T) ** 2).sum(-1))
    return rho + noise * rng.random((n, n, n))


def _crystal():
    return crystal_from_arrays(m_x2c_from_cellpar([A] * 3, [90] * 3),
                               SITES, [0, 0], [("C", 6)])


def _wavefunctions(tmp_path):
    from critic2_tpu.fields.wfn import Wavefunction as JW
    from critic2_tpu_torch.fields.wfn import Wavefunction as TW

    p = tmp_path / "h2.molden"
    p.write_text(H2_MOLDEN)
    return JW.read_molden(str(p)), TW.from_file(str(p))


def _case(name, rng, tmp_path):
    """(args for the JAX bindings, args for the port's, kwargs) of one
    function on seeded inputs."""
    if name == "hull":
        pts = rng.normal(size=(40, 3))
        return (pts,), (pts,), {}
    if name in ("ws_cell-cubic", "ws_cell-triclinic"):
        m = (np.eye(3) * 4.0 if name.endswith("cubic")
             else m_x2c_from_cellpar([5.0, 6.0, 7.0], [80.0, 95.0, 100.0]))
        return (m,), (m,), {}
    if name in ("yt_labels", "yt_charges"):
        rho = _grid(12, rng)
        offs, wts = _grid_ws_neighbors(_crystal(), rho.shape)
        args = (rho, offs, wts) + ((rho,) if name == "yt_charges" else ())
        return args, args, {}
    if name in ("tricubic_batch", "tricubic_values"):
        f = _grid(10, rng)
        x = rng.random((500, 3)) * 3.0 - 1.0
        return (f, x), (f, x), {}
    if name == "nci_sweep":
        g = np.abs(rng.random((16, 16, 16))) + 0.01
        return (g, np.eye(3) / A, 0.2, 2.0), (g, np.eye(3) / A, 0.2, 2.0), {}
    if name == "trace_colors":
        f = _grid(16, rng, noise=0.0)
        m = np.eye(3) * A
        seeds = rng.random((24, 3)) @ m.T
        shifts = np.array([[i, j, k] for i in (-1, 0, 1)
                           for j in (-1, 0, 1) for k in (-1, 0, 1)])
        tgt = ((SITES[None] + shifts[:, None]).reshape(-1, 3)) @ m.T
        ids = np.tile(np.arange(2), len(shifts))
        args = (f, m, seeds, tgt, ids, 0.2)
        return args, args, {"mstep": 300}
    if name == "auto_drain":
        f = _grid(16, rng, noise=0.0)
        seeds = rng.random((60, 3))
        return (f, np.eye(3) * A, seeds), (f, np.eye(3) * A, seeds), {}
    if name in ("wfn_eval_seq", "wfn_auto_drain"):
        jw, tw = _wavefunctions(tmp_path)
        if name == "wfn_eval_seq":
            x = rng.normal(size=(200, 3)) + [0.0, 0.0, 0.7]
            return (jw, x), (tw, x), {"nder": 2}
        seeds = (np.array([[0.0, 0.0, 0.7], [0.1, 0.0, 0.2],
                           [0.0, 0.1, 1.3]])
                 + 0.05 * rng.normal(size=(3, 3)))
        return (jw, seeds), (tw, seeds), {}
    assert name == "omp_threads"
    return (), (), {}


FUNCTIONS = ["hull", "ws_cell-cubic", "ws_cell-triclinic", "yt_labels",
             "yt_charges", "tricubic_batch", "tricubic_values", "nci_sweep",
             "trace_colors", "auto_drain", "wfn_eval_seq", "wfn_auto_drain",
             "omp_threads"]


def _as_torch(a):
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("inputs", ["numpy", "torch"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_port_native_bitwise_equals_jax_native(libs, name, inputs,
                                               tmp_path):
    """Each function of the port's bindings returns the JAX package's
    bindings' results bit for bit on the same seeded inputs, given numpy
    arrays or torch tensors."""
    jn, tn = libs
    rng = np.random.default_rng(FUNCTIONS.index(name))
    jargs, targs, kw = _case(name, rng, tmp_path)
    if inputs == "torch":
        targs = tuple(_as_torch(a) for a in targs)
    fn = name.split("-")[0]
    want = _leaves(getattr(jn, fn)(*jargs, **kw))
    got = _leaves(getattr(tn, fn)(*targs, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None or np.isscalar(b):
            assert a == b
        else:
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            assert np.array_equal(a, b), name
    if name == "hull":
        assert len(got[0]) > 0
    if name in ("auto_drain", "wfn_auto_drain"):
        assert len(got[0]) > 0


def test_yt_labels_and_charges_match_the_port(libs):
    """The port's yt_integrate against the sequential sweep: the same
    nattr and labels (tests/test_native.py's case), charges within 1e-9
    e (tests/test_torch_yt.py's bar)."""
    _, tn = libs
    rho = _grid(12, np.random.default_rng(0))
    c = _crystal()
    offs, wts = _grid_ws_neighbors(c, rho.shape)
    lab, nattr = tn.yt_labels(rho, offs, wts)
    res = yt_integrate(c, rho, block=256, device="cpu")
    assert nattr == res.nattr
    np.testing.assert_array_equal(lab, res.labels)
    lab2, q_seq = tn.yt_charges(torch.as_tensor(rho), offs, wts, rho)
    np.testing.assert_array_equal(lab2, lab)
    q = res.integrate(rho.reshape(-1))
    perm = lab.reshape(-1)[res.iattr]          # port basin -> native basin
    assert sorted(perm) == list(range(nattr))
    assert np.abs(q - q_seq[perm]).max() < 1e-9


def test_nci_count_matches_the_port(libs):
    """nciplot in f64 selects as many .dat points as the sequential
    NCI sweep (tests/test_native.py's case)."""
    _, tn = libs
    n = 24
    g = np.abs(np.random.default_rng(1).random((n, n, n))) + 0.01
    s = system_from_arrays(m_x2c=np.eye(3) * A, x_frac=[[0.0, 0.0, 0.0]],
                           species_of=[0], species=[("C", 6)], grid=g,
                           device="cpu")
    res = nciplot(s, rhocut=0.2, dimcut=2.0, precision="f64")
    assert res.ndat == tn.nci_sweep(g, np.eye(3) / A, 0.2, 2.0) > 0


def test_tricubic_matches_interp_soa(libs):
    """The host tricubic and ops/interp.interp_soa: one convention
    (d/dfrac, SYM6), values to rounding."""
    _, tn = libs
    rng = np.random.default_rng(2)
    f = _grid(10, rng)
    x = rng.random((300, 3))
    y, gr, h6 = tn.tricubic_batch(f, x)
    ty, tg, th = interp_soa(torch.as_tensor(f), torch.as_tensor(x.T))
    for a, b in ((y, ty), (gr, tg.T), (h6, th.T)):
        np.testing.assert_allclose(a, b.numpy(), rtol=0,
                                   atol=1e-12 * np.abs(a).max())


def test_geometry_falls_back_to_numpy_and_the_rest_raise(libs, monkeypatch):
    """Without the library, hull and ws_cell answer from the port's NumPy
    routes (the same facets); every other function raises."""
    _, tn = libs
    m = m_x2c_from_cellpar([5.0, 6.0, 7.0], [80.0, 95.0, 100.0])
    ineigh, areas, _ = tn.ws_cell(m)
    pts = np.random.default_rng(3).normal(size=(30, 3))
    tris = tn.hull(pts)
    monkeypatch.setattr(tn, "_load", lambda: None)
    fi, fa, _ = tn.ws_cell(m)
    ref = {tuple(v): a for v, a in zip(ineigh, areas)}
    assert len(fa) == len(ref)
    for v, a in zip(fi, fa):
        np.testing.assert_allclose(a, ref[tuple(v)], rtol=1e-8)
    ft = tn.hull(pts)
    assert sorted(map(sorted, ft.tolist())) == \
        sorted(map(sorted, tris.tolist()))
    assert not tn.available() and tn.omp_threads() == 1
    with pytest.raises(RuntimeError, match="native library not built"):
        tn.yt_labels(np.ones((4, 4, 4)), np.zeros((1, 3)), np.ones(1))
    with pytest.raises(RuntimeError, match="native library not built"):
        tn.tricubic_batch(np.ones((4, 4, 4)), np.zeros((1, 3)))


def test_library_name_tracks_source_and_flags(monkeypatch, tmp_path):
    """A changed source or a changed flag gives a new library name; the
    library lives under critic2_tpu_torch/_build/, never native/build/."""
    base = native._lib_path()
    assert os.path.dirname(base) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("critic2_tpu_torch",
                                                  "_build"))
    assert native.CXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17",
                                "-fopenmp"]
    src = tmp_path / "critic2_native.cpp"
    src.write_bytes(open(native.SRC, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(native, "SRC", str(src))
    edited = native._lib_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    flagged = native._lib_path()
    assert len({base, edited, flagged}) == 3


def test_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A failed compile raises with g++'s message and leaves no library
    under the source's name."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    src = tmp_path / "broken.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    assert not os.path.exists(native._lib_path())


@pytest.mark.parametrize("call", [
    lambda n: n.tricubic_batch(np.ones((4, 4, 4)), np.zeros((5, 2))),
    lambda n: n.tricubic_values(np.ones((4, 4)), np.zeros((5, 3))),
    lambda n: n.yt_labels(np.ones((4, 4, 4)), np.zeros((2, 3)), np.ones(3)),
    lambda n: n.yt_charges(np.ones((4, 4, 4)), np.zeros((1, 3)), np.ones(1),
                           np.ones((4, 4, 5))),
    lambda n: n.auto_drain(np.ones((4, 4, 4)), np.eye(3), np.zeros(3)),
    lambda n: n.trace_colors(np.ones((4, 4, 4)), np.eye(3), np.zeros((1, 3)),
                             np.zeros((2, 3)), [0], 0.2),
], ids=["points", "grid", "weights", "field", "seeds", "target-ids"])
def test_inputs_of_the_wrong_shape_raise(libs, call):
    """The C side reads as many values as the shapes promise: a shape
    that does not fit raises before any pointer is passed."""
    _, tn = libs
    with pytest.raises(ValueError):
        call(tn)
