"""deloc_support_ms: the program's `deloc.support` spans summed over the
traced window, per job: the basin supports: one forward YT solve a
basin, its weights read back, the shifts to the nearest attractor image
on the host and the groups uploaded (critic2_tpu_torch/utils/trace.py,
host clock). None where the record holds no such span."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or not any(s[0] == "deloc.support" for s in rec["spans"]):
        return None
    return program_trace.span_ms_per_job(run, "deloc.support")
