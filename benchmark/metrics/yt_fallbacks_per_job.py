"""yt_fallbacks_per_job: the program's count of trips of the optimistic
4 + 4 Gauss-Seidel schedule into the flag-stepped loop (`yt.fallbacks`)
over the traced window, per job."""
from benchmark.lib import program_trace


def read(run):
    return program_trace.counter_per_job(run, "yt.fallbacks")
