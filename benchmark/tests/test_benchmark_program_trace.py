"""The readers of the program's own record (benchmark/lib/program_trace.py
and the six metrics that read it) on synthetic runs and records, on a
traced window of a tiny cell on the CPU, and the files the benchmark had
before they came, byte for byte."""
import hashlib
import json
import os
import time

import pytest

from benchmark.lib import harness, program_trace, trace

METRICS = ("yt_flux_ms", "yt_solve_ms", "yt_fallbacks_per_job",
           "gs_barriers_per_job", "host_syncs_per_job",
           "intgrid_host_idle_ms")

# sha256 (first 16 hex digits) of every file the benchmark had before the
# readers of the program's record came; a change to one of them is a
# benchmark change of its own, which brings this list up to date
BEFORE = {
    "README.md": "a6944cc2812b1215",
    "calibrate.py": "3152267dda9385f1",
    "configs/anthracene-x23.json": "b275b44aabc3b6a8",
    "configs/nacl-b1-256.json": "22881c0a22ec9821",
    "jobs/nci.py": "8d30479f4921e58f",
    "jobs/topology.py": "2c5d226e4d2badff",
    "jobs/yt.py": "f9cb7fa6c66d408b",
    "lib/density.py": "63a0f18a0fdbd74b",
    "lib/harness.py": "5acda76d28f95a0f",
    "lib/program.py": "244a489ff4d5425b",
    "lib/roofline.py": "97bae8944cc645ec",
    "lib/stats.py": "eeaf12f1ab42039b",
    "lib/trace.py": "acecd0fa40912fbe",
    "limits/anthracene-x23.nci.json": "36b4a843a40b655f",
    "limits/anthracene-x23.yt.json": "4be45bd5cc9d3360",
    "limits/nacl-b1-256.topology.json": "5ed15b64b84f60c5",
    "limits/nacl-b1-256.yt.json": "4be45bd5cc9d3360",
    "metrics/device_idle_pct.py": "50993de464fd93ac",
    "metrics/job_p90_s.py": "6cedc768d2ff20ff",
    "metrics/job_s.py": "78df20cee6ea2d1f",
    "metrics/launches_per_job.py": "2ebc78059ddb8e77",
    "metrics/nci_roofline_pct.py": "42e482bdc0ac2b6d",
    "metrics/peak_gib.py": "1c02fe3cf728c564",
    "metrics/setup_s.py": "d08e3b76e2a5e11d",
    "metrics/yt_gs_launches_per_job.py": "07d979889ddb6536",
    "metrics/yt_kernel_roofline_pct.py": "2d0dcfdd94580ff7",
    "reference/nci.py": "f5c765818a6a916b",
    "reference/topology.py": "2d135bd0a5dfd4e4",
    "reference/yt.py": "ad8461baaf463c7a",
    "run.py": "984513d8356cecc3",
    "tests/conftest.py": "c25c084f03130475",
    "tests/test_benchmark_arith.py": "e7bb46bf6dff7745",
    "tests/test_benchmark_card.py": "9892311d1a98042b",
    "tests/test_benchmark_checks.py": "425b9e73837df7af",
    "tests/test_benchmark_contract.py": "de0f08b2dba745c3",
    "tests/test_benchmark_density.py": "f8c8860c2f94289b",
    "tests/test_benchmark_extend.py": "27439f3b38d02dbd",
    "tests/test_benchmark_guard.py": "6d316a66c0bb3bd9",
    "traffic/nci.json": "6b92ff7fb3340817",
    "traffic/topology.json": "7ce4834b464c88ad",
    "traffic/yt-pool4.json": "0f1bb1bfa1099d5f",
    "traffic/yt.json": "dc43dd78e0859be2",
}


def _reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
        "bench_metric_" + name)


MS = 1_000_000      # ns in a ms


def _record(offset_ns=0):
    """Two intgrid calls on the program's clock (ns): each 100 ms long,
    yt.neighbours its first 10 ms, yt.flux 10-30 ms, yt.order 30-31 ms,
    yt.solve 31-90 ms (the second call's with a fallback), intgrid.rows
    95-99 ms."""
    spans, counters = [], {"host_syncs": 17, "yt.solves": 2,
                           "yt.fallbacks": 1,
                           "yt_gs_pass.grid_barriers": 50_000}
    for call, t in ((1, 1000 * MS), (2, 1200 * MS)):
        t += offset_ns
        i = len(spans)
        spans.append(("intgrid", t, t + 100 * MS, -1, call))
        for name, a, b in (("yt.neighbours", 0, 10), ("yt.flux", 10, 30),
                           ("yt.order", 30, 31), ("yt.solve", 31, 90),
                           ("intgrid.rows", 95, 99)):
            spans.append((name, t + a * MS, t + b * MS, i, call))
        if call == 2:
            spans.append(("yt.fallback", t + 50 * MS, t + 90 * MS,
                          len(spans) - 2, call))
    return {"spans": spans, "counters": counters, "dropped": 0}


def _run(njobs=2, analysis_at=(5_000.0, 205_000.0), device=()):
    """A traced run whose `analysis` spans start at `analysis_at` (us on
    the profiler's clock) and last 100 ms, inside jobs 1 ms longer on
    each side."""
    tr = trace.Trace()
    for a in analysis_at:
        tr.spans += [("job", a - 1000.0, a + 101_000.0),
                     ("analysis", a, a + 100_000.0)]
    tr.device = list(device)
    return harness.Run(info={}, setup_s=0.0, walls=[0.1] * njobs,
                       window_s=0.2, njobs=njobs, peak_bytes=0,
                       counters={}, trace=tr)


@pytest.fixture
def synthetic(monkeypatch):
    box = {"rec": _record()}
    monkeypatch.setattr(program_trace, "record", lambda: box["rec"])
    return box


def test_span_and_counter_readers(synthetic):
    run = _run()
    assert _reader("yt_flux_ms").read(run) == pytest.approx(20.0)
    assert _reader("yt_solve_ms").read(run) == pytest.approx(59.0)
    assert _reader("yt_fallbacks_per_job").read(run) == 0.5
    assert _reader("gs_barriers_per_job").read(run) == 25_000
    assert _reader("host_syncs_per_job").read(run) == 8.5
    # a count the record does not hold is zero, not missing
    del synthetic["rec"]["counters"]["yt.fallbacks"]
    assert _reader("yt_fallbacks_per_job").read(run) == 0.0


def test_alignment_by_a_known_offset(synthetic):
    """The program's clock runs 7 s and 123 ns off the profiler's: each
    call lands on its analysis span all the same."""
    synthetic["rec"] = _record(offset_ns=7 * 10 ** 9 + 123)
    calls = program_trace.aligned_calls(_run(), synthetic["rec"])
    assert len(calls) == 2
    for (off, spans), a in zip(calls, (5_000.0, 205_000.0)):
        assert spans[0][0] == "intgrid"
        assert spans[0][1] == pytest.approx(a)
        assert spans[0][2] == pytest.approx(a + 100_000.0)
    # the same offset for both calls: 5 ms less 8 s and 123 ns
    assert calls[0][0] == calls[1][0]
    assert calls[0][0] == pytest.approx(5_000.0 - 8_000_000.123, abs=1e-6)


def test_host_idle_counts_the_gaps_inside_the_host_steps(synthetic):
    """The card idles in three places of each call: 4 ms inside
    yt.neighbours (0-4 ms), 2 ms inside yt.flux (12-14 ms) and 3 ms
    between yt.solve and intgrid.rows (91-94 ms); and 1 ms across the
    start of intgrid.rows (94.5-96 ms half inside). Only the host steps'
    share is read: 4 + 0 + 0 + 1 ms a call."""
    dev = []
    for a in (5_000.0, 205_000.0):
        busy = [(-1000.0, 0.0), (4_000.0, 12_000.0), (14_000.0, 91_000.0),
                (94_000.0, 94_500.0), (96_000.0, 101_000.0)]
        dev += [(a + s, a + e, "k") for s, e in busy]
    run = _run(device=dev)
    assert _reader("intgrid_host_idle_ms").read(run) == pytest.approx(5.0)
    idle = program_trace.idle_by_span(
        run, program_trace.aligned_calls(run, synthetic["rec"]))
    per_call = {k: v / 2 / 1e3 for k, v in idle.items()}
    assert per_call == pytest.approx({"yt.neighbours": 4.0, "yt.flux": 2.0,
                                      "intgrid": 3.5, "intgrid.rows": 1.0,
                                      "yt.order": 0.0, "yt.solve": 0.0,
                                      "yt.fallback": 0.0})


def test_none_where_the_record_is_empty_or_does_not_pair(synthetic):
    run = _run()
    synthetic["rec"] = None
    for name in METRICS:
        assert _reader(name).read(run) is None, name
    # one analysis span more than calls
    synthetic["rec"] = _record()
    run3 = _run(njobs=3, analysis_at=(5_000.0, 205_000.0, 405_000.0))
    assert _reader("intgrid_host_idle_ms").read(run3) is None
    # a dropped span
    synthetic["rec"] = dict(_record(), dropped=1)
    assert _reader("intgrid_host_idle_ms").read(run) is None
    # no trace
    synthetic["rec"] = _record()
    run.trace = None
    assert _reader("intgrid_host_idle_ms").read(run) is None


def test_the_programs_record_reads_none_when_empty():
    from critic2_tpu_torch.utils import trace as ptrace

    ptrace.reset()
    assert program_trace.record() is None
    with ptrace.recording(ptrace.RECORD):
        ptrace.count("host_syncs")
    assert program_trace.record()["counters"] == {"host_syncs": 1}
    ptrace.reset()


def test_traced_tiny_cell_reads_all_six_on_the_cpu(tiny_bench):
    """A traced window of the tiny NaCl twin on the CPU: the program
    records while the profiler does, every new metric is read, and each
    call pairs with its job's analysis span."""
    from critic2_tpu_torch.utils import trace as ptrace

    bd, _ = tiny_bench
    ptrace.reset()
    cell = harness.Cell.load("nacl-b1-256-tiny.yt", bench_dir=bd)
    res = harness.run_cell(cell, 2 ** 40 + 5, 0.3, True, "cpu",
                           time.perf_counter())
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(METRICS) <= set(m)
    assert m["yt_flux_ms"] > 0 and m["yt_solve_ms"] > 0
    assert m["host_syncs_per_job"] > 7
    assert m["yt_fallbacks_per_job"] == 0.0
    assert m["intgrid_host_idle_ms"] > 0
    rec = ptrace.read()
    calls = [sp for sp in rec["spans"] if sp[0] == "intgrid"]
    assert len(calls) == res["attempted"]
    assert rec["counters"]["yt.solves"] == res["attempted"]
    ptrace.reset()
    json.dumps(res, allow_nan=False)


def _digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


def test_every_file_the_benchmark_had_is_unchanged():
    assert len(BEFORE) == 42
    for rel, digest in BEFORE.items():
        assert _digest(os.path.join(harness.BENCH_DIR, rel)) == digest, rel
    for name in METRICS:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                           name + ".py"))
