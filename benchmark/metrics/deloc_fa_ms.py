"""deloc_fa_ms: the program's `deloc.fa` spans summed over the traced
window, per job: Fa: per lattice vector the permuted copy of the
overlaps and their traces (critic2_tpu_torch/utils/trace.py, host
clock). None where the record holds no such span."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or not any(s[0] == "deloc.fa" for s in rec["spans"]):
        return None
    return program_trace.span_ms_per_job(run, "deloc.fa")
