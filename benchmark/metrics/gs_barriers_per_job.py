"""gs_barriers_per_job: the grid barriers of every yt_gs_pass launch in the
traced window, per job: each launch's device counter, handed to the
program's record (`yt_gs_pass.grid_barriers`) and summed after the
window."""
from benchmark.lib import program_trace


def read(run):
    return program_trace.counter_per_job(run, "yt_gs_pass.grid_barriers")
