"""job_p90_s: 90th percentile of the jobs' walls (host clock), only where
at least ten jobs lie beyond it."""
from benchmark.lib import stats


def read(run):
    return stats.tail(run.walls, 90.0)
