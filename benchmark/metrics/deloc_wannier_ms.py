"""deloc_wannier_ms: the program's `deloc.wannier` spans summed over the
traced window, per job: the Wannier stack: per band the U rotation, the
Bloch sums' inverse FFTs and the (nlat, nks) phase matrix times the
Bloch stack, up to a sync (critic2_tpu_torch/utils/trace.py, host
clock). None where the record holds no such span."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or not any(s[0] == "deloc.wannier" for s in rec["spans"]):
        return None
    return program_trace.span_ms_per_job(run, "deloc.wannier")
