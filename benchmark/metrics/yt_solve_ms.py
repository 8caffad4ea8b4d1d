"""yt_solve_ms: the program's `yt.solve` spans summed over the traced
window, per job: the adjoint solve up to its last flag read, the YT
fallback's flag-stepped loop included (critic2_tpu_torch/utils/trace.py,
host clock)."""
from benchmark.lib import program_trace


def read(run):
    return program_trace.span_ms_per_job(run, "yt.solve")
