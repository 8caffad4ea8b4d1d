"""host_syncs_per_job: the program's count of the places on the YT path
where the host waits for the card (`host_syncs`: reads to the host and
copies from pageable host memory) over the traced window, per job."""
from benchmark.lib import program_trace


def read(run):
    return program_trace.counter_per_job(run, "host_syncs")
