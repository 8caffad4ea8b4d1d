"""The cells on the card at their own sizes: a short run of each is
correct, and the control in the program's place is not."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.lib import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card_is_correct(card, name):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", "31", "--seconds", "3", "--trace",
                        "0"], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_is_not_correct(card, name):
    cell = harness.Cell.load(name)
    ctx = harness.Context(cfg=cell.cfg, traffic=cell.traffic, device=card)
    item = cell.data.make_pool(cell.cfg, 17, 1, card)[0]
    import torch

    ans = cell.job.reference(ctx, item, torch.float64)
    ctl = cell.job.as_output(cell.job.reference(ctx, item, cell.job.CONTROL))
    nums = cell.job.compare(ctx, ctl, ans)
    assert any(v > cell.limits[k] for k, v in nums.items()), nums
