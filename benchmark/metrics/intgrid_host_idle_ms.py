"""intgrid_host_idle_ms: device idle inside the program's host-step spans
(`yt.neighbours`, `yt.order`, `intgrid.rows`: the card waits on the host
for the whole span), per job, on the device trace's clock. Each intgrid
call's spans are aligned to the job's `analysis` span
(benchmark/lib/program_trace.py); None where the two do not pair up."""
from benchmark.lib import program_trace


def read(run):
    calls = program_trace.aligned_calls(run, program_trace.record())
    if not calls:
        return None
    steps = [(s, e) for _, spans in calls for name, s, e in spans
             if name in program_trace.HOST_STEPS]
    return program_trace.idle_inside(run, steps) / 1e3 / len(calls)
