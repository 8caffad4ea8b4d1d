"""bader_segments_per_job: the program's count `bader.segments` over the
traced window, per job: segments of the near-grid walk, each ended by
one read of `done` on the host (critic2_tpu_torch/utils/trace.py). None
where the record holds no such count."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or "bader.segments" not in rec["counters"]:
        return None
    return program_trace.counter_per_job(run, "bader.segments")
