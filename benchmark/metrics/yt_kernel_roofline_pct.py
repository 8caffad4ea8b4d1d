"""yt_kernel_roofline_pct: the least time of every yt_gs_pass and yt_pass
launch in the traced window, summed, over their device time, summed. A
launch's least time is its least bytes, (K + 3P) N sizeof(dtype), over
the HBM's 3.35 TB/s: both kernels are bound by bytes."""
from benchmark.lib import roofline

KERNELS = ("yt_gs_kernel", "yt_pass_kernel")


def _itemsize(name):
    args = name.split("<", 1)[1] if "<" in name else ""
    if args.startswith("double"):
        return 8
    if args.startswith("float"):
        return 4
    raise ValueError(f"no dtype in the kernel name {name!r}")


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    K, P, N = run.info["K"], run.info["P"], run.info["N"]
    least = busy = 0.0
    for s, e, name in run.trace.kernels():
        if lo <= s <= hi and any(k in name for k in KERNELS):
            least += roofline.least_seconds(
                roofline.yt_launch_bytes(K, P, N, _itemsize(name)))
            busy += (e - s) / 1e6
    return 100.0 * least / busy if busy > 0 else None
