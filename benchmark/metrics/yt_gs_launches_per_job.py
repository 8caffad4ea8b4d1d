"""yt_gs_launches_per_job: the program's own count of yt_gs_pass launches
(critic2_tpu_torch.ops.yt_pass.launches) over the window, per job."""


def read(run):
    n = run.counters.get("yt_gs_pass")
    return None if n is None else n / run.njobs
