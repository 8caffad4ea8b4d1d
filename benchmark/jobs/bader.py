"""Job `bader`: Bader basin volumes and charges by critic2's default
near-grid walk (INTEGRALS BADER; Tang, Sanville and Henkelman 2009).

The timed call builds a System from the configuration's structure, loads
the density as a grid field already on the device, runs
intgrid(system, method="bader") with critic2's defaults (the near-grid
method) and takes the table of volumes and charges per attractor to the
host (intgrid does). The check holds the attractors (count and grid
positions) and every basin's volume and charge to the plain reference
(benchmark/reference/bader.py), which walks every grid point again by
the published step rule.

The numbers of the check and the reasons for their limits
(limits/<cell>.json; PERF.md gives the readings they were set from):
- attractors_unmatched: attractor grid points of one side missing on
  the other; exact, 0: the walk decides them, and both sides walk by the
  same rule in float64.
- volume_gap_bohr3: the widest gap of a matched basin's volume. Both
  sides count points and scale by V / N, so it reads rounding only while
  every label agrees; one label that differs moves two basins by one
  point's volume (1.80e-4 bohr^3 on hematite's grid), far above that.
- charge_gap_e: the same for the charges, float64 sums whose order on
  the card is not fixed (1e-13 e and below), against the density's own
  rounding in the float32 control.
- attractor_count_gap: |attractors - atoms| of the program's outputs
  alone; exact, 0: the data model's check holds every density to one
  maximum per atom, so a walk that stops anywhere else reads here even
  where the reference stops there too (a walker caught in a cycle and
  stopped at the cap off any maximum, as one that remembered only its
  previous point did on this grid lattice).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.jobs import yt
from benchmark.jobs.yt import as_output  # noqa: F401
from benchmark.lib import program
from benchmark.reference import bader as ref_bader

# the control: the reference one precision below the float64 of the walk
CONTROL = torch.float32


def run(ctx, rho):
    from critic2_tpu_torch.analysis.integration import intgrid

    s = program.system(ctx, rho)
    with ctx.span("analysis"):
        res = intgrid(s, method="bader")
    with ctx.span("readback"):
        return {"iattr": np.asarray(res.decomp.iattr, dtype=np.int64),
                "attr_map": np.asarray(res.attr_map, dtype=np.int64),
                "volume": np.asarray(res.volumes, dtype=float),
                "charge": np.asarray(res.charges, dtype=float)}


def counters() -> dict:
    """The program's launches of the walk kernel. A program without it
    (no critic2_tpu_torch/ops/bader_walk.py) cannot run this job kind: the
    run stops at set-up with ModuleNotFoundError."""
    from critic2_tpu_torch.ops import bader_walk

    return dict(bader_walk.launches)


def info(ctx) -> dict:
    """Sizes of the walk: N grid points, K neighbours a walker reads."""
    shape = tuple(int(v) for v in ctx.cfg["grid"])
    return {"N": int(np.prod(shape)), "K": len(ref_bader.NEIGHBOURS)}


def reference(ctx, rho, dtype):
    return ref_bader.basins(rho, ctx.cfg["structure"]["lattice_bohr"], dtype)


def compare(ctx, out, ans) -> dict:
    """The YT job's numbers (attractors_unmatched, charge_gap_e,
    volume_gap_bohr3) and attractor_count_gap."""
    nums = yt.compare(ctx, out, ans)
    nums["attractor_count_gap"] = abs(
        len(out["iattr"]) - len(ctx.cfg["structure"]["x_frac"]))
    return nums
