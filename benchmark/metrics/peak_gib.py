"""peak_gib: torch.cuda.max_memory_allocated() over the window, reset at
its start."""


def read(run):
    return run.peak_bytes / 2.0 ** 30 if run.peak_bytes else None
