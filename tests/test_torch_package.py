"""Package rules of the torch port: no JAX, no import of the JAX package,
CUDA by default with no silent CPU fallback, kernels built from source,
and the public signatures of the JAX package kept."""
import ast
import importlib
import importlib.util
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import critic2_tpu_torch
from critic2_tpu_torch import System, config
from critic2_tpu_torch.analysis.autocp import (Seed, autocp, gen_seeds,
                                               makegraph)
from critic2_tpu_torch.analysis.bader import bader_integrate
from critic2_tpu_torch.analysis.bisect import (basin_integral, bisect_basin,
                                               sphere_integral)
from critic2_tpu_torch.analysis.flux import fluxprint
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.analysis.mesh import becke_mesh
from critic2_tpu_torch.analysis.molcalc import molcalc_nelec
from critic2_tpu_torch.analysis.nci import nciplot
from critic2_tpu_torch.analysis.qtree import qtree_integrate
from critic2_tpu_torch.analysis.yt import yt_integrate
from critic2_tpu_torch.convert import (crystal_from_arrays,
                                       crystal_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.fields.field import Field
from critic2_tpu_torch.fields.wfn import Wavefunction
from critic2_tpu_torch.ops import _ext
from critic2_tpu_torch.ops.ode import trace_paths, trace_paths_screened

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(critic2_tpu_torch.__file__)
FORBIDDEN = {"jax", "jaxlib", "critic2_tpu"}


def _modules():
    """The package's own modules; _build/ holds what a run builds there
    (kernel libraries, at times a whole proof copy of the tree)."""
    for dirpath, dirs, files in os.walk(PKG):
        if "_build" in dirs:
            dirs.remove("_build")
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_import_anywhere():
    mods = list(_modules())
    assert len(mods) >= 80
    assert not [p for p in mods if "_build" in p]
    bad = [(os.path.relpath(p, ROOT), r)
           for p in mods + [os.path.join(ROOT, "chip_smoke.py")]
           for r in _imported_roots(p) if r in FORBIDDEN]
    assert not bad, bad
    # the scan sees real imports
    assert "torch" in set(_imported_roots(os.path.join(PKG, "config.py")))


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys\n"
            "import critic2_tpu_torch\n"
            "import critic2_tpu_torch.analysis.autocp\n"
            "import critic2_tpu_torch.arithmetic\n"
            "import critic2_tpu_torch.analysis.ewald\n"
            "import critic2_tpu_torch.analysis.hirshfeld\n"
            "import critic2_tpu_torch.analysis.rhoplot\n"
            "import critic2_tpu_torch.analysis.stm\n"
            "import critic2_tpu_torch.analysis.struct\n"
            "import critic2_tpu_torch.analysis.xdm\n"
            "import critic2_tpu_torch.ops.brhole\n"
            "import critic2_tpu_torch.ops.mdint\n"
            "import critic2_tpu_torch.ops.xc\n"
            "import critic2_tpu_torch.analysis.bader\n"
            "import critic2_tpu_torch.analysis.bisect\n"
            "import critic2_tpu_torch.analysis.flux\n"
            "import critic2_tpu_torch.analysis.mesh\n"
            "import critic2_tpu_torch.analysis.molcalc\n"
            "import critic2_tpu_torch.analysis.qtree\n"
            "import critic2_tpu_torch.crystal.seed\n"
            "import critic2_tpu_torch.crystal.fragment\n"
            "import critic2_tpu_torch.crystal.library\n"
            "import critic2_tpu_torch.crystal.spgs\n"
            "import critic2_tpu_torch.crystal.sympg\n"
            "import critic2_tpu_torch.crystal.transform\n"
            "import critic2_tpu_torch.crystal.wyckoff\n"
            "import critic2_tpu_torch.fields.elk\n"
            "import critic2_tpu_torch.fields.qe\n"
            "import critic2_tpu_torch.fields.wien\n"
            "import critic2_tpu_torch.fields.pi\n"
            "import critic2_tpu_torch.fields.dftb\n"
            "import critic2_tpu_torch.analysis.deloc\n"
            "import critic2_tpu_torch.io.abinit\n"
            "import critic2_tpu_torch.io.cif\n"
            "import critic2_tpu_torch.io.writers\n"
            "import critic2_tpu_torch.fields.wfn\n"
            "import critic2_tpu_torch.analysis.surface\n"
            "import critic2_tpu_torch.io.graphics\n"
            "import critic2_tpu_torch.ops.fft\n"
            "import critic2_tpu_torch.ops.lebedev\n"
            "import critic2_tpu_torch.ops.ode\n"
            "import critic2_tpu_torch.ops.quadrature\n"
            "import critic2_tpu_torch.ops.rlm\n"
            "import critic2_tpu_torch.ops.trispline\n"
            "import critic2_tpu_torch.analysis.integration\n"
            "import critic2_tpu_torch.analysis.nci\n"
            "import critic2_tpu_torch.analysis.yt\n"
            "import critic2_tpu_torch.convert\n"
            "import critic2_tpu_torch.crystal.symmetry\n"
            "import critic2_tpu_torch.fields.field\n"
            "import critic2_tpu_torch.io.cube\n"
            "import critic2_tpu_torch.ops.eig3\n"
            "import critic2_tpu_torch.ops.interp\n"
            "import critic2_tpu_torch.ops.newton\n"
            "import critic2_tpu_torch.ops.yt_pass\n"
            "import critic2_tpu_torch.parallel.mesh\n"
            "import critic2_tpu_torch.parallel.sharded\n"
            "import critic2_tpu_torch.parallel.grid_ops\n"
            "import critic2_tpu_torch.parallel.yt_sharded\n"
            "import critic2_tpu_torch.utils.chk\n"
            "import critic2_tpu_torch.utils.runlog\n"
            "import critic2_tpu_torch.utils.trace\n"
            "import critic2_tpu_torch.cli\n"
            "import critic2_tpu_torch.native\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',"
            " 'critic2_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _crystal():
    return crystal_from_arrays(np.diag([6.0, 6.0, 6.0]), [[0, 0, 0]], [0],
                               [("Na", 11)])


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        System.from_structure(_crystal())
    with pytest.raises(RuntimeError, match="CUDA"):
        yt_integrate(_crystal(), np.ones((4, 4, 4)))
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_build_directory_is_not_scanned(tmp_path, monkeypatch):
    """A copy of the tree under _build/ (JAX package and all) does not
    count as the port's code."""
    fake = tmp_path / "pkg"
    (fake / "_build" / "proof" / "critic2_tpu").mkdir(parents=True)
    (fake / "_build" / "proof" / "critic2_tpu" / "x.py").write_text(
        "import jax\n")
    (fake / "ok.py").write_text("import torch\n")
    monkeypatch.setattr(sys.modules[__name__], "PKG", str(fake))
    assert [os.path.basename(p) for p in _modules()] == ["ok.py"]


@pytest.mark.parametrize("entry", ["autocp", "nciplot", "grd", "makegraph",
                                   "bader", "bisect", "sphere_integral",
                                   "fluxprint"])
def test_grid_entry_points_raise_without_cuda(monkeypatch, entry):
    """With no device given, the grid main path wants CUDA and says so;
    nothing drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = _crystal()
    grid = np.ones((4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "autocp":
            autocp(System(crystal=c))
        elif entry == "nciplot":
            nciplot(System(crystal=c))
        elif entry == "makegraph":
            makegraph(System(crystal=c), None)
        elif entry == "bader":
            bader_integrate(c, grid)
        elif entry == "bisect":
            bisect_basin(System(crystal=c), [0, 0, 0], np.eye(3))
        elif entry == "sphere_integral":
            sphere_integral(System(crystal=c), [0, 0, 0], 1.0)
        elif entry == "fluxprint":
            fluxprint(System(crystal=c), np.ones((1, 3)))
        else:
            system_from_arrays(**crystal_to_arrays(c), grid=grid).ref.grd(
                np.zeros((1, 3)))


def _grid_system(mode=None):
    s = system_from_arrays(**crystal_to_arrays(_crystal()),
                           grid=np.random.default_rng(0).random((6, 6, 6)),
                           device="cpu")
    if mode:
        s.ref.set_options(interp=mode)
    return s


def _pwc_path():
    """A synthetic pwc file (the writer of tests/test_deloc.py) on a 4^3
    grid of the 6 bohr cell of _crystal()."""
    import tempfile

    from test_deloc import write_pwc

    p = os.path.join(tempfile.mkdtemp(), "x.pwc")
    write_pwc(p, np.eye(3) * 6.0, (2, 1, 1), 2, (4, 4, 4))
    return p


def _fragment_xyz():
    """An xyz file holding the Na atom of _crystal(), at the origin."""
    import tempfile

    p = os.path.join(tempfile.mkdtemp(), "frag.xyz")
    with open(p, "w") as fh:
        fh.write("1\nNa\nNa 0.0 0.0 0.0\n")
    return p


@pytest.mark.parametrize("what, call", [
    (None, lambda: gen_seeds(_molecule().crystal, [Seed(typ="mesh")],
                             device="cpu")),
    (None, lambda: nciplot(_grid_system(), molmotif=True)),
    (None, lambda: _crystal().spg_name()),
    (None, lambda: _crystal().wyckoffs()),
    (None, lambda: autocp(_molecule())),
    (None, lambda: makegraph(_molecule(), autocp(_molecule()))),
    (None,
     lambda: trace_paths(_grid_system().ref.eval_fn(),
                         torch.ones((1, 3), dtype=torch.float64),
                         escape=(np.zeros(3), 1.0))),
    (None,
     lambda: sphere_integral(_grid_system(), [0, 0, 0], 1.0, expr="$1")),
    (None, lambda: basin_integral(_grid_system(), [0, 0, 0], expr="$1",
                                  level=1, nr=4)),
    (None, lambda: intgrid(_grid_system(), discard="$1 < 0")),
    (None,
     lambda: _grid_system().load_field_as("promolecular", shape=(4, 4, 4),
                                          fragment=_fragment_xyz())),
    (None, lambda: Field.from_file(_crystal(), _pwc_path(), device="cpu")),
], ids=["mesh-seed", "molmotif", "spg_name", "wyckoffs", "wfn-autocp",
        "wfn-makegraph", "ode-escape", "sphere_integral-expr",
        "basin_integral-expr", "intgrid-discard", "fragment-file",
        "pwc-grid"])
def test_unported_branches_name_what_they_wait_for(what, call):
    """Branches the port lacks raise NotImplementedError naming the module
    they wait for; a case whose module is now ported (what=None: mesh
    seeds, autocp and makegraph on a wavefunction field, the tracer's
    escape sphere, molmotif, space-group names, Wyckoff letters, a
    fragment given as an xyz file, expr= of the bisection integrals,
    intgrid's discard= and a pwc grid with its Kohn-Sham states) runs
    instead."""
    if what is None:
        call()
        return
    with pytest.raises(NotImplementedError, match=what):
        call()


@pytest.mark.parametrize("mode", ["trispline", "tristar"])
def test_spline_modes_no_longer_raise(mode):
    s = _grid_system(mode)
    x = np.array([[0.3, 1.1, 2.7]])
    y, yp, ypp = s.ref.grid.interp(x / 6.0)
    res = s.ref.grd(x)
    f, gf, h6 = s.ref.eval_fn()(torch.as_tensor(x.T))
    assert torch.equal(res.f, y) and torch.allclose(f, y, rtol=1e-12)
    assert tuple(yp.shape) == (1, 3) and tuple(ypp.shape) == (1, 3, 3)
    assert tuple(gf.shape) == (3, 1) and tuple(h6.shape) == (6, 1)


H2_MOLDEN = """[Molden Format]
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
"""


def _molden_path():
    import tempfile

    p = os.path.join(tempfile.mkdtemp(), "h2.molden")
    with open(p, "w") as fh:
        fh.write(H2_MOLDEN)
    return p


def _molecule(device="cpu"):
    """H2/STO-3G from a molden file: molecular cell, wfn field 1."""
    p = _molden_path()
    s = System.from_structure(p, device=device)
    s.load_field(p)
    return s


@pytest.mark.parametrize("entry", ["from_structure", "field", "qtree",
                                   "becke_mesh", "molcalc_nelec",
                                   "wfn-autocp", "rho_eval",
                                   "trace_paths_screened"])
def test_molecular_entry_points_default_to_cuda(monkeypatch, entry):
    """The slice's entry points resolve their device as cuda when none is
    given, and raise without it; with device="cpu" they run (the system
    is built on the CPU before CUDA is taken away)."""
    mol = _molecule()
    grid = _grid_system()
    w = mol.ref.wfn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "from_structure":
            System.from_structure(_molden_path())
        elif entry == "field":
            Field.from_file(mol.crystal, _molden_path())
        elif entry == "qtree":
            qtree_integrate(System(crystal=grid.crystal, fields=grid.fields,
                                   iref=1))
        elif entry == "becke_mesh":
            becke_mesh(mol.crystal, "small")
        elif entry == "molcalc_nelec":
            molcalc_nelec(System(crystal=mol.crystal, fields=mol.fields,
                                 iref=1))
        elif entry == "wfn-autocp":
            autocp(System(crystal=mol.crystal, fields=mol.fields, iref=1))
        elif entry == "rho_eval":
            w.rho_eval(np.zeros((1, 3)))
        else:
            trace_paths_screened(w, np.zeros((1, 3)))
    assert isinstance(w, Wavefunction) and mol.device.type == "cpu"


@pytest.mark.parametrize("entry", [
    "rhf_energy", "eri_matrix", "overlap_kinetic_nuclear", "rinv_pairs",
    "mep", "uslater", "xhole", "molcalc_hf", "molcalc-expr", "ewald_energy",
    "ewald_potential", "eval_expr", "load_field_expr", "ghost",
    "hirshfeld", "xdm_grid", "xdm_wfn", "stm", "cube", "point", "line",
    "rdf", "compare-rdf"])
def test_expression_slice_entry_points_default_to_cuda(monkeypatch, entry):
    """The expression slice's entry points (ops/mdint, the hole functions,
    molcalc, Ewald, the compiler, ghost fields, Hirshfeld, XDM, STM,
    rhoplot, RDF) resolve their device as cuda when none is given, and
    raise without it. Systems built on the CPU are re-wrapped with no
    device, as the molecular test above does."""
    from critic2_tpu_torch import arithmetic
    from critic2_tpu_torch.analysis import (ewald, hirshfeld, molcalc,
                                            rhoplot, stm, struct, xdm)
    from critic2_tpu_torch.ops import mdint

    mol = _molecule()
    grid = _grid_system()
    w = mol.ref.wfn
    c = grid.crystal

    def sys_(s):
        return System(crystal=s.crystal, fields=dict(s.fields), iref=1)

    calls = {
        "rhf_energy": lambda: mdint.rhf_energy(w),
        "eri_matrix": lambda: mdint.eri_matrix(w),
        "overlap_kinetic_nuclear": lambda: mdint.overlap_kinetic_nuclear(w),
        "rinv_pairs": lambda: mdint.rinv_pairs(w, np.zeros((1, 3))),
        "mep": lambda: w.mep(np.zeros((1, 3))),
        "uslater": lambda: w.uslater(np.zeros((1, 3))),
        "xhole": lambda: w.xhole(np.zeros((1, 3)), np.zeros(3)),
        "molcalc_hf": lambda: molcalc.molcalc_hf(sys_(mol)),
        "molcalc-expr": lambda: molcalc.molcalc_integral(sys_(mol), "$1*2"),
        "ewald_energy": lambda: ewald.ewald_energy(c),
        "ewald_potential": lambda: ewald.ewald_potential(c,
                                                         np.zeros((1, 3))),
        "eval_expr": lambda: arithmetic.eval_expr("$1", sys_(grid),
                                                  np.zeros((1, 3))),
        "load_field_expr": lambda: sys_(grid).load_field_expr(
            "$1", shape=(4, 4, 4)),
        "ghost": lambda: Field.ghost(c, lambda x: x[0]),
        "hirshfeld": lambda: hirshfeld.hirshfeld_charges(sys_(grid)),
        "xdm_grid": lambda: xdm.xdm_grid(sys_(grid)),
        "xdm_wfn": lambda: xdm.xdm_wfn(sys_(mol), lvl="small"),
        "stm": lambda: stm.stm(sys_(grid), npts=(2, 2)),
        "cube": lambda: rhoplot.cube(sys_(grid), n=(2, 2, 2)),
        "point": lambda: rhoplot.point(sys_(grid), [0, 0, 0]),
        "line": lambda: rhoplot.line(sys_(grid), [0, 0, 0], [1, 0, 0],
                                     npts=3),
        "rdf": lambda: struct.rdf(c, rend=4.0, npts=11),
        "compare-rdf": lambda: struct.compare([c, c], method="rdf",
                                              rend=4.0, npts=11),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("entry", [
    "read_pwc", "pwc-field", "deloc_wannier", "WienField", "ElkField",
    "PiField", "DftbField", "load_field_pi"])
def test_formats_slice_entry_points_default_to_cuda(monkeypatch, entry):
    """The field formats' entry points (the pwc reader and deloc, the
    WIEN2k, elk, aiPI and DFTB+ evaluators, LOAD PI) resolve their
    device as cuda when none is given, and raise without it, before they
    read a file."""
    from critic2_tpu_torch.analysis.deloc import deloc_wannier
    from critic2_tpu_torch.fields.dftb import DftbField
    from critic2_tpu_torch.fields.elk import ElkField
    from critic2_tpu_torch.fields.pi import PiField
    from critic2_tpu_torch.fields.qe import read_pwc
    from critic2_tpu_torch.fields.wien import WienField

    c = _crystal()
    pwc = _pwc_path()
    qe, rho = read_pwc(pwc, device="cpu")
    decomp = yt_integrate(c, rho)
    calls = {
        "read_pwc": lambda: read_pwc(pwc),
        "pwc-field": lambda: Field.from_file(c, pwc),
        "deloc_wannier": lambda: deloc_wannier(c, decomp, qe, useu=False),
        "WienField": lambda: WienField.from_files("x.clmsum", "x.struct"),
        "ElkField": lambda: ElkField.from_files("STATE.OUT", "GEOMETRY.OUT"),
        "PiField": lambda: PiField.from_files(c, {}),
        "DftbField": lambda: DftbField.from_files(c, "detailed.xml",
                                                  "eigenvec.bin", "wfc.hsd"),
        "load_field_pi": lambda: System(crystal=c).load_field_pi({}),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


# The one module exempt from "cuda by default": the sequential C++
# reference the card's results are held against runs on the host by
# design, so it takes no device and launches nothing on the card.
HOST_ONLY = {"critic2_tpu_torch.native"}


def test_native_is_the_one_host_only_module(monkeypatch):
    """critic2_tpu_torch.native, the host reference, has no device
    parameter anywhere and answers with CUDA unavailable; it takes
    tensors on any device and returns numpy."""
    from critic2_tpu_torch import native

    assert HOST_ONLY == {native.__name__}
    fns = dict(_public_callables(native))
    assert len(fns) >= 14
    for name, fn in fns.items():
        assert "device" not in inspect.signature(fn).parameters, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tris = native.hull(torch.as_tensor(
        np.random.default_rng(0).normal(size=(12, 3))))
    assert isinstance(tris, np.ndarray) and len(tris) > 0


def test_explicit_cpu_device_and_dtypes():
    s = System.from_structure(_crystal(), device="cpu")
    assert s.device == torch.device("cpu")
    assert s.fields[0].promol.atpos.dtype == config.FDTYPE == torch.float64
    assert config.EDTYPE == torch.float32
    res = yt_integrate(_crystal(), np.random.default_rng(0).random((6, 6, 6)),
                       device="cpu")
    assert res._chiP.device.type == "cpu"
    assert res._chis(adjoint=True) == (None, None)   # plain f64 route


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(RuntimeError, match="nvcc"):
        _ext.nvcc_path()


def test_kernel_library_name_tracks_sources():
    a = _ext._lib_path("yt_pass")
    b = _ext._lib_path("yt_gs_pass")
    assert a != b and a.startswith(_ext.BUILD_DIR)
    assert set(_ext.SOURCES) == {"yt_pass", "yt_gs_pass"}
    for src in _ext.SOURCES.values():
        assert os.path.exists(os.path.join(_ext.CSRC, src))
    assert "-gencode=arch=compute_90a,code=sm_90a" in _ext.NVCC_FLAGS


# Public names of both packages whose parameters still differ, each with
# its reason: (JAX package module, qualified name) -> parameters the port
# adds beyond device and generator.
SIGNATURE_ALLOW = {
    # the JAX package takes its float width from the x64 switch; PyTorch
    # has none, so the caller names the dtype of the wave vectors
    ("critic2_tpu.ops.fft", "gvectors"): {"dtype"},
    # opt-in instrumentation: a dict the port fills with the wall of the
    # traces, the cubature, the boundary and the spheres
    ("critic2_tpu.analysis.qtree", "qtree_integrate"): {"stats"},
    # the same instrumentation: the wall of the basin supports, the
    # Wannier stack, the Sij assembly and Fa
    ("critic2_tpu.analysis.deloc", "deloc_wannier"): {"stats"},
}
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _public_callables(mod):
    """(qualified name, function) of the public functions and methods
    that module `mod` defines itself."""
    for name, obj in vars(mod).items():
        if name.startswith("_") or \
                getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            yield name, obj
        elif inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if isinstance(m, (classmethod, staticmethod)):
                    m = m.__func__
                if not mname.startswith("_") and inspect.isfunction(m):
                    yield f"{name}.{mname}", m


def _module_pairs():
    """(port module, JAX package module) for every port module whose
    counterpart of the same path exists."""
    for path in _modules():
        rel = os.path.relpath(path, PKG)[:-3].replace(os.sep, ".")
        rel = "" if rel == "__init__" else rel.replace(".__init__", "")
        tname = "critic2_tpu_torch" + ("." + rel if rel else "")
        rname = "critic2_tpu" + ("." + rel if rel else "")
        if importlib.util.find_spec(rname) is not None:
            yield tname, rname


def _signature_fault(port_fn, ref_fn, allowed):
    """Why port_fn's parameters do not keep ref_fn's, or None."""
    tp = inspect.signature(port_fn).parameters
    rp = inspect.signature(ref_fn).parameters
    extra = [n for n in tp if n not in rp]
    rpos = [n for n, p in rp.items() if p.kind in POSITIONAL]
    tpos = [n for n, p in tp.items() if p.kind in POSITIONAL]
    if [n for n in tp if n in rp] != list(rp):
        return f"reference parameters {list(rp)} -> {list(tp)}"
    if set(extra) - allowed:
        return f"parameters of the port's own {sorted(set(extra) - allowed)}"
    if tpos[:len(rpos)] != rpos:
        return f"positional parameters {rpos} -> {tpos}"
    return None


def test_public_signatures_keep_the_reference_parameters():
    """Every public function and method defined under the same qualified
    name in both packages takes the JAX package's parameters, by name and
    in order; a parameter it may pass by position sits at the same place
    (so a positional argument never lands on a parameter of the port's
    own). The port adds only device and generator, or what
    SIGNATURE_ALLOW names with its reason."""
    compared, bad = 0, []
    used = set()
    for tname, rname in _module_pairs():
        ref = dict(_public_callables(importlib.import_module(rname)))
        for qual, fn in _public_callables(importlib.import_module(tname)):
            if qual not in ref:
                continue
            compared += 1
            allowed = {"device", "generator"} | SIGNATURE_ALLOW.get(
                (rname, qual), set())
            if (rname, qual) in SIGNATURE_ALLOW:
                used.add((rname, qual))
            fault = _signature_fault(fn, ref[qual], allowed)
            if fault:
                bad.append(f"{rname}.{qual}: {fault}")
    assert not bad, "\n".join(bad)
    assert compared >= 480
    assert used == set(SIGNATURE_ALLOW), "stale SIGNATURE_ALLOW entries"


def test_repl_keeps_every_keyword():
    """The port's REPL answers every keyword of the JAX package's, each
    handler taking (self, args, lines)."""
    import critic2_tpu.cli as jcli
    import critic2_tpu_torch.cli as tcli

    def handlers(cls):
        return {k: v for k, v in vars(cls).items() if k.startswith("cmd_")}

    ref, port = handlers(jcli.Repl), handlers(tcli.Repl)
    assert len(ref) >= 87 and set(port) == set(ref)
    for name, fn in port.items():
        assert list(inspect.signature(fn).parameters) == \
            ["self", "args", "lines"], name


def _ref(crystal, rho, block=None, loop=None):
    pass


def _kept(crystal, rho, block=None, loop=None, *, device=None):
    pass


def _device_third(crystal, rho, device=None, block=None, loop=None):
    pass


def _loop_dropped(crystal, rho, block=None, device=None):
    pass


def _own_option(crystal, rho, block=None, loop=None, fast=False):
    pass


@pytest.mark.parametrize("port_fn, fault", [
    (_kept, None), (_device_third, "positional"),
    (_loop_dropped, "reference parameters"), (_own_option, "own")])
def test_signature_check_sees_each_fault(port_fn, fault):
    """The check catches the faults it guards against: a parameter of the
    port's own where the reference has a positional one, a reference
    parameter gone, an option the reference lacks."""
    got = _signature_fault(port_fn, _ref, {"device", "generator"})
    assert (got is None) if fault is None else (fault in got)
