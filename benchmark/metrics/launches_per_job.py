"""launches_per_job: kernels the profiler recorded in the traced window
(copies and memsets left out), per job."""


def read(run):
    if run.trace is None or not run.trace.jobs:
        return None
    lo, hi = run.trace.window
    n = sum(1 for s, _, _ in run.trace.kernels() if lo <= s <= hi)
    return n / len(run.trace.jobs)
