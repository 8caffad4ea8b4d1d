"""setup_s: process start to the first timed job (imports, CUDA context,
kernel libraries, the density pool and its checks, the warm-up job)."""


def read(run):
    return run.setup_s
