"""Run one cell of the benchmark of critic2_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and each number of the output check beside its limit as the last lines
of standard error. Needs a CUDA device; without one it exits with code 1
and prints no result. It also exits with code 1, and no result, if a
forbidden module (jax, jaxlib, flax, critic2_tpu) was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: host work that fans out over threads of a
# shared host's cores reads differently from run to run
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout holds the program and the benchmark; kernels build inside it
sys.path.insert(0, ROOT)


def power_limit_w():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.lib import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded at start: {bad}", file=sys.stderr)
        return 1
    cell = harness.Cell.load(args.workload)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded by the run: {bad}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, **result.pop("device"),
              "power_limit_w": power_limit_w()}
    checks = result.pop("checks")
    line = dict(result, device=device, checks=checks)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
