"""bader_walk_ms: the program's `bader.walk` spans summed over the traced
window, per job: the near-grid walks of every grid point, block by
block, with the reads of `done` and the compactions between segments
(critic2_tpu_torch/utils/trace.py, host clock). None where the record
holds no such span."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or not any(s[0] == "bader.walk" for s in rec["spans"]):
        return None
    return program_trace.span_ms_per_job(run, "bader.walk")
