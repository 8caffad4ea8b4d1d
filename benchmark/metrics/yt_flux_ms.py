"""yt_flux_ms: the program's `yt.flux` spans summed over the traced window,
per job: the flux tensors and the attractors, up to their readback to the
host, which drains the card's queue (critic2_tpu_torch/utils/trace.py,
host clock)."""
from benchmark.lib import program_trace


def read(run):
    return program_trace.span_ms_per_job(run, "yt.flux")
