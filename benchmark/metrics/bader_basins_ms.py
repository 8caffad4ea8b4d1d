"""bader_basins_ms: the program's `bader.basins` and `bader.sums` spans
summed over the traced window, per job: the attractors by torch.unique
and their readback, then the basin sums by index_add_ and theirs
(critic2_tpu_torch/utils/trace.py, host clock). None where the record
holds neither span."""
from benchmark.lib import program_trace

SPANS = ("bader.basins", "bader.sums")


def read(run):
    rec = program_trace.record()
    if rec is None or not any(s[0] in SPANS for s in rec["spans"]):
        return None
    return sum(program_trace.span_ms_per_job(run, name) for name in SPANS)
