"""job_s: time to solution, the whole window over the jobs completed in
it (host clock)."""
from benchmark.lib import stats


def read(run):
    return stats.job_seconds(run.window_s, run.njobs)
