"""The benchmark's frozen arithmetic and its metric readers, against hand
sums."""
import numpy as np
import pytest

from benchmark.lib import harness, roofline, stats
from benchmark.lib.trace import Trace


def test_job_seconds_is_window_over_jobs():
    assert stats.job_seconds(30.0, 120) == 0.25
    with pytest.raises(ValueError):
        stats.job_seconds(30.0, 0)


@pytest.mark.parametrize("q", [50.0, 90.0, 95.0])
def test_percentile_matches_numpy_linear(q):
    x = np.random.default_rng(3).lognormal(size=137)
    assert stats.percentile(x, q) == pytest.approx(np.percentile(x, q),
                                                   rel=1e-15)


def test_p90_needs_ten_beyond_it():
    assert stats.tail(list(range(99)), 90.0) is None
    assert stats.tail(list(range(100)), 90.0) == pytest.approx(89.1)


def test_interval_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert stats.interval_union(iv) == [(0, 15), (20, 30), (40, 41)]
    assert stats.covered(iv, 0, 50) == 26
    assert stats.covered(iv, 12, 22) == 5
    assert stats.gaps(iv, 0, 50) == [(15, 20), (30, 40), (41, 50)]


def test_yt_launch_bytes_hand_sum():
    N = 256 ** 3
    # K = 6 chi planes, P = 2 integrands read as s and f, written once
    assert roofline.yt_launch_bytes(6, 2, N, 8) == (6 + 2 + 2 + 2) * N * 8
    assert roofline.least_seconds(roofline.yt_launch_bytes(6, 2, N, 4)) \
        == pytest.approx(0.2404e-3, rel=1e-3)


def test_fp64_tensor_peak_and_least_seconds_of_flops():
    # H100 SXM data sheet: 67 TFLOP/s dense FP64 on the Tensor Cores
    assert roofline.H100_FP64_TENSOR_FLOPS_PER_S == 67e12
    assert roofline.least_seconds_flops(67e12) == 1.0
    # a 512 x 512 by 512 x 512 ZGEMM: 8 real flops a complex multiply-add,
    # 8 * 512^3 = 1,073,741,824 flops, 16.0260 us
    assert roofline.least_seconds_flops(8 * 512 ** 3) == pytest.approx(
        16.0260e-6, rel=1e-5)


def test_nci_job_bytes_hand_sum():
    N = 384 * 270 * 504
    assert roofline.nci_job_bytes(N) == 8 * N + 4 * N + 4 * N


def _run(trace, info=None, walls=(1.0,), counters=None):
    return harness.Run(info=info or {}, setup_s=1.0,
                       walls=list(walls), window_s=sum(walls),
                       njobs=len(walls), peak_bytes=2 ** 30,
                       counters=counters or {}, trace=trace)


def _reader(name):
    return harness.load_module(f"{harness.BENCH_DIR}/metrics/{name}.py",
                               "t_" + name)


def test_device_idle_is_one_minus_union_over_window():
    tr = Trace(device=[(0, 400, "k1"), (200, 600, "k2"), (800, 900,
                                                          "Memcpy DtoH")],
               spans=[("job", 0, 1000)])
    assert tr.busy_s() == pytest.approx(700e-6)
    assert _reader("device_idle_pct").read(_run(tr)) == pytest.approx(30.0)


def test_launches_per_job_leaves_copies_out():
    tr = Trace(device=[(0, 1, "a"), (2, 3, "b"), (4, 5, "Memset (Device)"),
                       (6, 7, "c")],
               spans=[("job", 0, 3), ("job", 3, 8)])
    assert _reader("launches_per_job").read(_run(tr)) == 1.5


def test_yt_kernel_roofline_from_names_and_sizes():
    N, K, P = 1000, 6, 2
    f32 = roofline.least_seconds(roofline.yt_launch_bytes(K, P, N, 4))
    f64 = roofline.least_seconds(roofline.yt_launch_bytes(K, P, N, 8))
    tr = Trace(device=[(0, 100, "void yt_gs_kernel<float, 8, 1, true>(x)"),
                       (100, 150, "void yt_pass_kernel<double, 6>(y)"),
                       (150, 400, "elementwise")],
               spans=[("job", 0, 400)])
    got = _reader("yt_kernel_roofline_pct").read(
        _run(tr, info={"N": N, "K": K, "P": P}))
    assert got == pytest.approx(100.0 * (f32 + f64) / 150e-6)
    assert _reader("yt_kernel_roofline_pct").read(
        _run(Trace(device=[(0, 1, "other")], spans=[("job", 0, 1)]),
             info={"N": N, "K": K, "P": P})) is None


def test_nci_roofline_over_job_busy_time():
    """Kernel time only, as a union: the copies to the host are left out."""
    N = 10 ** 6
    tr = Trace(device=[(0, 100, "a"), (50, 150, "b"), (150, 190,
                                                       "Memcpy DtoH"),
                       (300, 350, "c"), (350, 400, "Memset (Device)")],
               spans=[("job", 0, 200), ("job", 200, 400)])
    least = 2 * roofline.least_seconds(16 * N)
    assert _reader("nci_roofline_pct").read(_run(tr, info={"N": N})) \
        == pytest.approx(100.0 * least / 200e-6)


def test_counter_and_host_clock_readers():
    run = _run(None, walls=[0.5] * 100, counters={"yt_gs_pass": 1600})
    assert _reader("job_s").read(run) == 0.5
    assert _reader("job_p90_s").read(run) == 0.5
    assert _reader("yt_gs_launches_per_job").read(run) == 16
    assert _reader("peak_gib").read(run) == 1.0
    assert _reader("setup_s").read(run) == 1.0
    assert _reader("device_idle_pct").read(run) is None
