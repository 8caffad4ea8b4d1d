"""nci_roofline_pct: the jobs' least time over the time their kernels ran
in the traced window. A job's least bytes: the float64 input grid read
once and its two float32 output grids written once; the least time is
those bytes over the HBM's 3.35 TB/s. The count is of the work, whatever
kernels do it. Copies and memsets are left out of the time: the readback
of the output grids to the host is job_s's and device_idle_pct's to
show, not the sweep's."""
from benchmark.lib import roofline, stats


def read(run):
    if run.trace is None or not run.trace.jobs:
        return None
    kernels = [(s, e) for s, e, _ in run.trace.kernels()]
    busy = sum(stats.covered(kernels, s, e) for s, e in run.trace.jobs) / 1e6
    least = len(run.trace.jobs) * roofline.least_seconds(
        roofline.nci_job_bytes(run.info["N"]))
    return 100.0 * least / busy if busy > 0 else None
