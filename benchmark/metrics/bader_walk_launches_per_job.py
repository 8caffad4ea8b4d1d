"""bader_walk_launches_per_job: the program's own count of the walk
kernel's launches (critic2_tpu_torch.ops.bader_walk.launches) over the
window, per job: 1 where every job's walk went through the kernel."""


def read(run):
    n = run.counters.get("bader_walk")
    return None if n is None else n / run.njobs
