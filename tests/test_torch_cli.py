"""The port's keyword REPL (critic2_tpu_torch/cli.py) against the JAX
package's: every test of tests/test_cli.py run on the port's Repl on the
CPU, the printed numbers of the same scripts from both REPLs, main(),
checkpoints read across the packages, and the CUDA default."""
import functools
import inspect
import io
import re

import numpy as np
import pytest
import torch

import critic2_tpu.cli as jcli
import critic2_tpu_torch.cli as tcli
import test_cli  # noqa: E402  (the JAX package's CLI tests)
from critic2_tpu.utils import chk as jchk
from critic2_tpu_torch.utils import chk as tchk

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

PORT_REPL = functools.partial(tcli.Repl, device="cpu")

# every test of tests/test_cli.py but test_load_post_options, which reads
# the grid's element count through numpy's `.size` (a method on a tensor)
# and has its counterpart below
JAX_CLI_TESTS = [
    "test_crystal_point_auto", "test_load_as_and_reductions",
    "test_yt_from_cli", "test_unknown_keyword_soft_error",
    "test_variable_assignment", "test_molecule_wfx_molcalc",
    "test_checkpoints_and_scene", "test_load_as_computed_fields",
    "test_settings_newcell_identify", "test_newcell_primitive_roundtrip",
    "test_auto_options", "test_identify_and_nci_fragments_molecule_frame",
    "test_environ_shells", "test_runlog", "test_clearsymm_and_system"]


@pytest.fixture
def poscar(tmp_path):
    p = tmp_path / "POSCAR"
    p.write_text(test_cli.POSCAR)
    return str(p)


@pytest.mark.parametrize("name", JAX_CLI_TESTS)
def test_jax_cli_tests_pass_on_the_port(name, poscar, tmp_path,
                                        monkeypatch):
    """The JAX CLI test, its assertions unchanged, with the port's Repl
    (device="cpu") in place of the JAX package's."""
    monkeypatch.setattr(test_cli, "Repl", PORT_REPL)
    monkeypatch.setattr(jcli, "Repl", PORT_REPL)
    monkeypatch.chdir(tmp_path)
    fn = getattr(test_cli, name)
    have = {"poscar": poscar, "tmp_path": tmp_path,
            "monkeypatch": monkeypatch}
    fn(**{p: have[p] for p in inspect.signature(fn).parameters})


def test_load_post_options_on_the_port():
    """test_cli.py::test_load_post_options with the tensor's numel()."""
    out = io.StringIO()
    r = PORT_REPL(out=out, quiet=True)
    r.run_script("crystal library mgo\n"
                 'load as "$0" 8 8 8 normalize 20.0 typnuc -1\n')
    f = r.sy.field(1)
    assert f.typnuc == -1
    tot = float(f.grid.f.sum()) * r.sy.crystal.volume / f.grid.f.numel()
    assert abs(tot - 20.0) < 1e-9


def _run(repl, script):
    out = io.StringIO()
    r = repl(out=out, quiet=True)
    try:
        r.run_script(script)
    except StopIteration:
        pass
    return out.getvalue(), r


NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
RTOL = 1e-8         # printed numbers: port against JAX
# |grad f| at a converged CP and the split of a degenerate Hessian pair
# are rounding noise at this size (autocp's convergence bar is 1e-10)
ATOL = 1e-10

# the scripts of test_cli.py:40, :54 and :66, and CPREPORT LONG
SCRIPTS = {
    "point-auto": "crystal {p}\npoint 0.25 0.25 0.25\nauto\ncpreport\n",
    "load-as": 'crystal {p}\nload as "$0" 16 16 16 id rho\nsum 1\nmean 1\n',
    "yt": 'crystal {p}\nload as "$0" 20 20 20\nyt\n',
    # the complete cell list of MgO on its promolecular field: a CP on a
    # lattice plane, and every image the symmetry maps onto the plane
    "mgo-cpreport-long": "crystal library mgo\nauto\ncpreport long\n",
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_printed_numbers_match_jax(script, poscar):
    """Both REPLs print the same lines; their numbers agree to 1e-8
    relative (1e-10 absolute). The POINT report's ellipticity (l1/l2 - 1
    of a degenerate pair at (1/4, 1/4, 1/4), on a three-fold axis) is a
    difference of rounding errors and is held only to |e| < 1e-6."""
    text = SCRIPTS[script].format(p=poscar)
    jt, jr = _run(jcli.Repl, text)
    tt, tr = _run(PORT_REPL, text)
    assert jr.nwarns == tr.nwarns == 0
    jl, tl = jt.splitlines(), tt.splitlines()
    assert len(jl) == len(tl) > 2
    for a, b in zip(jl, tl):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        x = np.array([float(v) for v in NUM.findall(a)])
        y = np.array([float(v) for v in NUM.findall(b)])
        if "Ellipticity" in a:
            assert max(abs(x[-1]), abs(y[-1])) < 1e-6
            continue
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL, err_msg=a)


def test_main_cpu_returns_zero(poscar, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "in.cri"
    path.write_text(SCRIPTS["load-as"].format(p=poscar))
    assert tcli.main(["--cpu", str(path)]) == 0
    out = capsys.readouterr().out
    assert "SUM(1) =" in out and "ended (0 warnings)" in out


def test_runlog_line_carries_the_keywords_record(poscar, tmp_path,
                                                monkeypatch):
    """With CRITIC2_RUNLOG set, each keyword runs inside its own
    trace.recording(): the YT keyword's line (YT is the keyword that
    runs intgrid on a grid) carries the totals of the YT path's spans and
    its counters, a keyword that runs no span carries none, and the
    process's default record stays empty."""
    import json

    from critic2_tpu_torch.utils import trace

    trace.reset()
    log = tmp_path / "run.jsonl"
    monkeypatch.setenv("CRITIC2_RUNLOG", str(log))
    _, r = _run(PORT_REPL, f'crystal {poscar}\nload as "$0" 16 16 16\n'
                'yt\n')
    assert r.nwarns == 0
    recs = {x["kw"]: x for x in map(json.loads,
                                    log.read_text().splitlines())}
    assert list(recs) == ["crystal", "load", "yt"]
    yt = recs["yt"]
    assert set(yt["spans"]) == {"intgrid", "yt.neighbours", "yt.flux",
                                "yt.order", "yt.operands", "yt.solve",
                                "yt.readback", "intgrid.rows"}
    n, seconds = yt["spans"]["intgrid"]
    assert n == 1 and 0 < seconds <= yt["wall_s"] + 1e-4
    assert yt["counters"]["yt.solves"] == 1
    assert yt["counters"]["host_syncs"] > 7
    assert recs["crystal"]["spans"] == {}
    assert trace.read() == {"spans": [], "counters": {}, "dropped": 0}


def _cps(cpl):
    return [(cp.typ, cp.name, cp.mult, bool(cp.isnuc), float(cp.f),
             float(cp.gfmod), float(cp.del2f), tuple(np.asarray(cp.x)),
             tuple(np.asarray(cp.eig))) for cp in cpl.cps]


def test_cp_checkpoints_load_in_either_package(poscar, tmp_path):
    """AUTO_CHK files of either package load in the other with the same
    CP list."""
    a, b = tmp_path / "jax.npz", tmp_path / "port.npz"
    _, jr = _run(jcli.Repl, f"crystal {poscar}\nauto\nauto_chk save {a}\n")
    _, tr = _run(PORT_REPL,
                 f"crystal {poscar}\nauto_chk load {a}\nauto_chk save {b}\n")
    assert jr.nwarns == tr.nwarns == 0
    assert len(jr.cpl.cps) > 2
    assert _cps(tr.cpl) == _cps(jr.cpl)
    back = jchk.load_cplist(jr.sy, str(b))
    assert _cps(back) == _cps(jr.cpl)


def test_nci_checkpoints_share_the_jax_format(tmp_path):
    """NCI checkpoints: the port writes the JAX package's npz keys from
    tensor cubes and reads its own files and the JAX package's. (The JAX
    package's load_nci passes NCIResult a `dat=` it does not take, so it
    reads no file; the port's passes the empty scatter as `_dat`.)"""
    from critic2_tpu.analysis.nci import NCIResult as JNCIResult
    from critic2_tpu_torch.analysis.nci import NCIResult

    rng = np.random.default_rng(3)
    cubes = {k: rng.random((3, 4, 5))
             for k in ("crho", "cgrad", "cgrad_raw", "rhoat")}
    p, q = tmp_path / "port.npz", tmp_path / "jax.npz"
    tchk.save_nci(NCIResult(x0=np.zeros(3), xmat=np.eye(3),
                            **{k: torch.as_tensor(v)
                               for k, v in cubes.items()}), str(p))
    jchk.save_nci(JNCIResult(x0=np.zeros(3), xmat=np.eye(3), **cubes),
                  str(q))
    assert sorted(np.load(p).files) == sorted(np.load(q).files)
    for path in (p, q):
        back = tchk.load_nci(str(path))
        assert back.ndat == 0 and back.dat.shape == (0, 2)
        for k, v in cubes.items():
            np.testing.assert_array_equal(getattr(back, k), v)


def test_repl_and_mesh_need_cuda_by_default(monkeypatch):
    from critic2_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.Repl()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-q", "/nonexistent.cri"])
    assert tcli.Repl(device="cpu").device == torch.device("cpu")
