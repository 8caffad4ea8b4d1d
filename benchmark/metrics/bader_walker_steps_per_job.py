"""bader_walker_steps_per_job: the program's count `bader.walker_steps`
over the traced window, per job: the live walkers of each segment of the
near-grid walk times its steps (critic2_tpu_torch/utils/trace.py). None
where the record holds no such count."""
from benchmark.lib import program_trace


def read(run):
    rec = program_trace.record()
    if rec is None or "bader.walker_steps" not in rec["counters"]:
        return None
    return program_trace.counter_per_job(run, "bader.walker_steps")
