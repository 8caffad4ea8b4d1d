"""bader_walk_roofline_pct: the least time of every bader_walk_kernel
launch in the traced window, summed, over their device time, summed. A
launch's least time is its least bytes over the HBM's 3.35 TB/s: the
density read once and one root (int64) written per point, N (sizeof(dtype)
+ 8) bytes. The walk reads the 27 points around each position it takes,
mostly from the caches; the bound holds whatever implements the walk.
None where the window has no such launch."""
from benchmark.lib import roofline

KERNEL = "bader_walk_kernel"


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
    N = run.info["N"]
    least = busy = 0.0
    for s, e, name in run.trace.kernels():
        if lo <= s <= hi and KERNEL in name:
            least += roofline.least_seconds(N * (_itemsize(name) + 8))
            busy += (e - s) / 1e6
    return 100.0 * least / busy if busy > 0 else None
