"""Readings that the limits of a cell's output check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103

In one process on one card: for every seed, the pool of items that a
run of that seed draws (the configuration's data model makes it), one
job of the program on each item and the cell's numbers against the
plain reference (the lower readings); then, for every control seed, the
reference in the precision below the one the configuration states put
in the program's place (the upper readings).
Prints one JSON line per seed and a summary: the largest program reading
and the smallest control reading of each number.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(cell, ctx, pool, run_job):
    """The cell's numbers over the items of a pool, the worst of each."""
    import torch

    worst = {}
    for item in pool:
        out = run_job(ctx, item)
        ans = cell.job.reference(ctx, item, torch.float64)
        for k, v in cell.job.compare(ctx, out, ans).items():
            worst[k] = max(worst.get(k, float("-inf")), float(v))
        del out, ans
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return worst


def calibrate(cell, seeds, control_seeds, device) -> dict:
    """Per seed, the cell's numbers of the program and of the control;
    returns the largest program and the smallest control reading of each."""
    from benchmark.lib import harness

    ctx = harness.Context(cfg=cell.cfg, traffic=cell.traffic, device=device)
    npool = int(cell.traffic["pool"])

    def control(ctx_, item):
        return cell.job.as_output(cell.job.reference(ctx_, item,
                                                     cell.job.CONTROL))

    summary = {"program": {}, "control": {}}
    for side, ss, fn in (("program", seeds, cell.job.run),
                         ("control", control_seeds, control)):
        for seed in ss:
            t0 = time.perf_counter()
            pool = cell.data.make_pool(cell.cfg, seed, npool, device)
            cell.data.check_pool(cell.cfg, pool, seed)
            r = readings(cell, ctx, pool, fn)
            del pool
            print(json.dumps({"side": side, "seed": seed, "numbers": r,
                              "s": time.perf_counter() - t0}), flush=True)
            agg = summary[side]
            for k, v in r.items():
                agg[k] = (max if side == "program" else min)(
                    agg.get(k, v), v)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import harness

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 1
    cell = harness.Cell.load(args.workload)
    ints = lambda text: [int(s) for s in text.split(",") if s]  # noqa: E731
    summary = calibrate(cell, ints(args.seeds), ints(args.control_seeds),
                        torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload,
                      "lower (largest program reading)": summary["program"],
                      "upper (smallest control reading)": summary["control"],
                      "limits": cell.limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
