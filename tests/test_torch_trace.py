"""The port's record of spans and counters (critic2_tpu_torch/utils/
trace.py) on the CPU: off by default and free when off, on under
torch.profiler or `recording()`, and the spans and counters of intgrid's
YT path. Pure torch: nothing here compiles JAX."""
import sys
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from critic2_tpu_torch.analysis import yt as tyt
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.convert import crystal_from_arrays, system_from_arrays
from critic2_tpu_torch.utils import trace

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

SHAPE = (16, 16, 16)
# the spans of one intgrid(method="yt") on the plain (CPU) route
YT_SPANS = ["intgrid", "yt.neighbours", "yt.flux", "yt.order",
            "yt.operands", "yt.solve", "yt.readback", "intgrid.rows"]


def _system(shape=SHAPE):
    """Rock salt-like cell, two Gaussians on a grid field."""
    g = np.stack(np.meshgrid(*[np.arange(s) / s for s in shape],
                             indexing="ij"), axis=-1)
    rho = np.zeros(shape)
    for site, amp in (((0.0, 0.0, 0.0), 2.0), ((0.5, 0.5, 0.5), 1.0)):
        d = g - np.asarray(site)
        d -= np.rint(d)
        rho += amp * np.exp(-((8.0 * d) ** 2).sum(-1))
    return system_from_arrays(np.diag([8.0, 8.0, 8.0]),
                              [[0, 0, 0], [0.5, 0.5, 0.5]], [0, 1],
                              [("Na", 11), ("Cl", 17)], grid=rho,
                              device="cpu")


class _NoRecordFunction:
    def __init__(self, *a, **k):
        raise AssertionError("record_function called")


@pytest.fixture
def no_record_function(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _NoRecordFunction)
    monkeypatch.setattr(torch.profiler, "record_function",
                        _NoRecordFunction)


@pytest.fixture
def host_reads(monkeypatch):
    """Counts the reads of the device by the host that the YT path makes,
    found by the functions that make them: .cpu(), int(), float(),
    .item(), torch.equal, torch.nonzero, and torch.as_tensor of host
    data onto a device."""
    n = {"reads": 0}

    def counting(fn, pred=lambda *a, **k: True):
        def wrapped(*a, **k):
            if pred(*a, **k):
                n["reads"] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("cpu", "__int__", "__float__", "item"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(getattr(torch.Tensor, name)))
    for name in ("equal", "nonzero"):
        monkeypatch.setattr(torch, name, counting(getattr(torch, name)))
    monkeypatch.setattr(torch, "as_tensor", counting(
        torch.as_tensor, lambda x, *a, **k: "device" in k
        and not isinstance(x, torch.Tensor)))
    return n


def test_off_records_nothing_and_costs_no_record_function(
        no_record_function):
    trace.reset()
    s = _system()
    res = intgrid(s, method="yt")
    assert res.nattr_raw == 2
    rec = trace.read()
    assert rec == {"spans": [], "counters": {}, "dropped": 0}


def test_off_path_makes_no_sync_and_keeps_nothing(monkeypatch,
                                                  no_record_function):
    """Off, span / count / count_device allocate nothing in the record
    module, keep no reference to the tensor handed over, and read
    nothing from it."""
    trace.reset()
    t = torch.zeros(2, dtype=torch.int64)

    def no_sync(*a, **k):
        raise AssertionError("the off path read a tensor")

    for name in ("cpu", "__int__", "__float__", "item", "tolist", "sum"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    refs = sys.getrefcount(t)
    for _ in range(10):     # warm the interpreter's caches
        with trace.span("x"):
            trace.count("y")
            trace.count_device("z", t, 0)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("x"):
                trace.count("y")
                trace.count_device("z", t, 0)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__
             and d.size_diff > 0]
    assert not grown, grown
    assert sys.getrefcount(t) == refs
    monkeypatch.undo()
    assert trace.read() == {"spans": [], "counters": {}, "dropped": 0}


def test_profiler_window_records_the_yt_spans_under_one_call(
        no_record_function, host_reads):
    s = _system()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        host_reads["reads"] = 0
        res = intgrid(s, method="yt")
        reads = host_reads["reads"]
    rec = trace.read()
    names = [sp[0] for sp in rec["spans"]]
    assert names == YT_SPANS
    root = rec["spans"][0]
    assert root[3] == -1
    assert {sp[4] for sp in rec["spans"]} == {root[4]}
    for name, t0, t1, parent, _ in rec["spans"][1:]:
        assert parent == 0, name
        assert root[1] <= t0 <= t1 <= root[2], name
    assert rec["dropped"] == 0
    # every read of the device the route made is counted, and one solve
    assert rec["counters"] == {"yt.solves": 1, "host_syncs": reads}
    assert reads > 7
    # after the window the record is off again
    n = len(trace.read()["spans"])
    intgrid(s, method="yt")
    assert len(trace.read()["spans"]) == n
    assert res.nattr_raw == 2


def test_recording_nests_its_own_record_and_restores():
    trace.reset()
    with trace.recording() as outer:
        trace.count("a")
        with trace.recording() as inner:
            with trace.span("s"):
                trace.count("a", 2)
        trace.count("a")
    assert outer.read()["counters"] == {"a": 2}
    assert inner.read()["counters"] == {"a": 2}
    assert [sp[0] for sp in inner.read()["spans"]] == ["s"]
    assert outer.read()["spans"] == []
    assert trace.read() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_past_the_cap_are_counted_as_dropped():
    rec = trace.Record(cap=2)
    with trace.recording(rec):
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
        with trace.span("d"):
            pass
    out = rec.read()
    assert [sp[0] for sp in out["spans"]] == ["a", "b"]
    assert [sp[3] for sp in out["spans"]] == [-1, 0]
    assert out["dropped"] == 2


def test_device_counters_are_summed_only_when_read():
    counts = torch.tensor([3, 100], dtype=torch.int64)
    whole = torch.tensor([1, 2], dtype=torch.int64)
    with trace.recording() as rec:
        trace.count_device("barriers", counts, 0)
        trace.count_device("barriers", counts, 0)
        trace.count_device("all", whole)
    assert rec.counters == {}
    counts[0] = 5           # the device writes after the hand-over
    assert rec.read()["counters"] == {"barriers": 10, "all": 3}
    counts[0] = 7           # read once: later writes are not seen
    assert rec.read()["counters"] == {"barriers": 10, "all": 3}
    assert rec.pending == {}


def _zigzag(shape=(10, 6, 32), period=8, amp=2.0):
    """One attractor at the top of a ridge that climbs along axis 2 while
    it zig-zags along axis 0, the sweeps' axis: each turn needs another
    Gauss-Seidel pair, so the optimistic 4 + 4 pairs trip."""
    i, j, k = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    xr = shape[0] / 2 + amp * np.sin(2 * np.pi * k / period)
    rho = np.exp(2.0 * np.cos(2 * np.pi * (i - xr) / shape[0])
                 + np.cos(2 * np.pi * j / shape[1]) + 1.0 * k)
    c = crystal_from_arrays(np.diag([0.4 * s for s in shape]),
                            [[0.5, 0.5, 0.9]], [0], [("C", 6)])
    return c, rho


def test_kernel_route_counts_the_trip_of_the_optimistic_schedule(
        monkeypatch):
    """_solve_sweep's kernel route, run with the plain kernels as in
    tests/test_torch_yt.py::test_kernel_route_matches_jax_xla_sweep, on a
    field that needs more than 4 pairs: one solve, one trip of the first
    4 pairs into the flag-stepped ones, one span, one host sync a flag
    read (the plain kernels' own compares stand for work that the CUDA
    kernels do on the device), and the yt_gs_pass launches of the
    schedule."""
    c, rho = _zigzag()
    rt = tyt.yt_integrate(c, torch.as_tensor(rho))
    assert rt.nattr == 1
    chi, offs = rt._chiP, rt._offs
    chi32 = tyt._shifted(chi, offs, torch.float32)
    chiR = tyt._shifted(chi, offs, torch.float64)
    f3 = torch.as_tensor(np.stack([np.ones(rho.shape), rho]))
    flag_reads = []
    to_int = torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "__int__",
                        lambda t: flag_reads.append(t) or to_int(t))
    sweeps = []
    gs_pass = tyt.yt_gs_pass
    monkeypatch.setattr(tyt, "yt_gs_pass",
                        lambda *a, **kw: sweeps.append(1) or gs_pass(*a, **kw))
    with trace.recording() as rec:
        s = tyt._solve_sweep(chi, chi32, chiR, f3, offs, adjoint=True)
    out = rec.read()
    assert out["counters"] == {"yt.solves": 1, "yt.fallbacks": 1,
                               "host_syncs": len(flag_reads)}
    assert len(flag_reads) > 3
    # the schedule: s1 and e each 4 pairs, then 2 a flag read, from f once
    assert len(sweeps) == 32
    assert [(sp[0], sp[3]) for sp in out["spans"]] == [("yt.solve", -1)]
    ref = tyt._xla_sweep(chi, f3, offs, adjoint=True)
    np.testing.assert_allclose(s.numpy(), ref.numpy(), rtol=1e-10,
                               atol=1e-10 * float(ref.abs().max()))
    # on the two Gaussians 4 + 4 pairs suffice: no trip, a flag read each
    sy = _system()
    rt2 = tyt.yt_integrate(sy.crystal, sy.ref.grid.f)
    chi, offs = rt2._chiP, rt2._offs
    f3 = torch.stack([torch.ones_like(sy.ref.grid.f), sy.ref.grid.f])
    sweeps.clear()
    with trace.recording() as rec:
        tyt._solve_sweep(chi, tyt._shifted(chi, offs, torch.float32),
                         tyt._shifted(chi, offs, torch.float64), f3, offs,
                         adjoint=True)
    assert rec.read()["counters"] == {"yt.solves": 1, "host_syncs": 2}
    assert len(sweeps) == 16


def _optimistic_then_stepped(chi32, chiR, f3, offs, adjoint):
    """The earlier schedule of the kernel route, spelled out: the refined
    solve with 4 + 4 pairs; if either last pair changed anything, the
    refined solve again from f with 4 pairs, then 2 a flag read until a
    pair changes nothing. Returns (s, whether it tripped)."""
    def fixpoint(rhs, stepped):
        s, flag = tyt._gs_pairs(chi32, rhs, rhs, offs, adjoint, npair=4)
        npairs = 4
        while (stepped and int(flag) != 0
               and npairs < sum(rhs.shape[1:]) + 16):
            s, flag = tyt._gs_pairs(chi32, s, rhs, offs, adjoint, npair=2)
            npairs += 2
        return s, flag

    def refined(stepped):
        s1, flag1 = fixpoint(f3.to(torch.float32), stepped)
        s1 = s1.to(f3.dtype)
        r = tyt.yt_pass(chiR, s1, f3, offs=offs, adjoint=adjoint) - s1
        e, flag2 = fixpoint(r.to(torch.float32), stepped)
        return s1 + e.to(f3.dtype), int(flag1) != 0 or int(flag2) != 0

    out, tripped = refined(False)
    return (refined(True)[0] if tripped else out), tripped


@pytest.mark.parametrize("adjoint", [True, False],
                         ids=["adjoint", "forward"])
@pytest.mark.parametrize("field", ["zigzag", "two_gaussians"])
def test_stepped_schedule_is_the_optimistic_one_bit_for_bit(field, adjoint):
    """The f32 fixpoint is unique bit for bit and the stepped schedule's
    first 4 pairs are the optimistic schedule's, so running it from the
    first pair gives the earlier schedule's answer exactly, with or
    without a trip; each trip still counts one yt.fallbacks."""
    if field == "zigzag":
        c, rho = _zigzag()
        rho = torch.as_tensor(rho)
    else:
        sy = _system()
        c, rho = sy.crystal, sy.ref.grid.f
    rt = tyt.yt_integrate(c, rho)
    chi, offs = rt._chiP, rt._offs
    if adjoint:
        chi32 = tyt._shifted(chi, offs, torch.float32)
        chiR = tyt._shifted(chi, offs, torch.float64)
    else:
        chi32, chiR = chi.to(torch.float32), chi
    f3 = torch.stack([torch.ones_like(rho), rho])
    want, tripped = _optimistic_then_stepped(chi32, chiR, f3, offs, adjoint)
    with trace.recording() as rec:
        got = tyt._solve_sweep(chi, chi32, chiR, f3, offs, adjoint=adjoint)
    assert torch.equal(got, want)
    # the zig-zag needs 8 pairs each way, the Gaussians 4
    assert tripped == (field == "zigzag")
    assert rec.read()["counters"].get("yt.fallbacks", 0) == tripped
