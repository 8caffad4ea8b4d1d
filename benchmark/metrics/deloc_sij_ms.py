"""deloc_sij_ms: the program's `deloc.sij` spans summed over the traced
window, per job: the basin overlaps: per (attractor, shift) group the
gathered stack's ZGEMM, the screening and the accumulation, up to a sync
(critic2_tpu_torch/utils/trace.py, host clock). None where the record
holds no such span."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or not any(s[0] == "deloc.sij" for s in rec["spans"]):
        return None
    return program_trace.span_ms_per_job(run, "deloc.sij")
