"""Job `topology`: the critical points and the bond and ring paths of a
grid density, the first half of critic2's quick start (AUTO, then the
graph).

The timed call builds a System from the configuration's structure, loads
the density as a grid field already on the device, runs autocp(system)
with its default Wigner-Seitz seeds and makegraph(system, cpl), and takes
the CP list and each path's ends to the host (autocp and makegraph do).
The check holds every CP to the plain reference
(benchmark/reference/topology.py): its gradient there and its distance
from the reference's own CP, its type and multiplicity, the orbits found
on one side only, the Poincare-Hopf sum, and the ends of every bond and
ring path.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import program
from benchmark.reference import topology as ref_top

# the control: the reference's interpolant and search one precision below
# the float64 of autocp's Newton steps
CONTROL = torch.float32


def run(ctx, rho):
    from critic2_tpu_torch.analysis.autocp import autocp, makegraph

    s = program.system(ctx, rho)
    with ctx.span("analysis"):
        cpl = makegraph(s, autocp(s))
    with ctx.span("readback"):
        cps = cpl.cps
        return {"x": np.array([cp.x for cp in cps], dtype=float),
                "typ": np.array([cp.typ for cp in cps], dtype=int),
                "isnuc": np.array([cp.isnuc for cp in cps], dtype=bool),
                "mult": np.array([cp.mult for cp in cps], dtype=int),
                "ipath": np.array([cp.ipath if cp.ipath is not None
                                   else [-1, -1] for cp in cps], dtype=int)}


def info(ctx) -> dict:
    return {"N": int(np.prod([int(v) for v in ctx.cfg["grid"]]))}


def reference(ctx, rho, dtype):
    ans = ref_top.cps(rho, ctx.cfg, dtype)
    ans["interp"] = ref_top.Interpolant(rho, ctx.cfg["structure"][
        "lattice_bohr"], torch.float64)
    return ans


def as_output(ans) -> dict:
    n = len(ans["typ"])
    ipath = np.full((n, 2), -1)
    for k, ends in ans["ends"].items():
        ipath[k] = ends
    return {"x": ans["x"], "typ": ans["typ"], "isnuc": ans["isnuc"],
            "mult": ans["mult"], "ipath": ipath}


def compare(ctx, out, ans) -> dict:
    """cp_grad_max: widest |grad rho| of the reference's interpolant at a
    reported CP off the nuclei (a.u.); cp_position_gap_bohr: widest
    distance of such a CP from the reference's CP of its orbit;
    cp_mismatches: reference orbits without a CP, CPs without an orbit,
    and CPs of another type or multiplicity; cp_count_gap: gap of the
    cell's counts (n, b, r, c) with multiplicities, summed, plus the
    program's Poincare-Hopf sum; path_end_mismatches: bond and ring CPs
    whose two path ends are other orbits than the reference's."""
    orb = ans["orbits"]
    a = np.asarray(ctx.cfg["structure"]["lattice_bohr"], dtype=float)
    off = np.nonzero(~out["isnuc"])[0]
    kof = np.array([orb.find(x) for x in out["x"]], dtype=int)
    nums = {"cp_grad_max": 0.0, "cp_position_gap_bohr": 0.0}
    if len(off):
        _, g, _ = ans["interp"].eval(torch.as_tensor(
            out["x"][off] @ a.T, dtype=torch.float64,
            device=ans["interp"].f.device))
        nums["cp_grad_max"] = float(torch.linalg.norm(g, dim=1).max())
    mism = 0
    for i in off:
        k = kof[i]
        if k < 0 or orb.typ[k] != out["typ"][i] or \
                orb.mult[k] != out["mult"][i]:
            mism += 1
            continue
        nums["cp_position_gap_bohr"] = max(nums["cp_position_gap_bohr"],
                                           orb.gap(out["x"][i], k))
    found = set(kof[kof >= 0].tolist())
    mism += sum(1 for k in range(len(orb.rep))
                if k not in found and not ans["isnuc"][k])
    cnt = lambda typ, mult: np.array([mult[typ == t].sum()  # noqa: E731
                                      for t in (-3, -1, 1, 3)])
    cp_ = cnt(out["typ"], out["mult"])
    cr = cnt(ans["typ"], ans["mult"])
    ph = cp_[0] - cp_[1] + cp_[2] - cp_[3]
    ends = 0
    for i in np.nonzero(np.isin(out["typ"], (-1, 1)) & ~out["isnuc"])[0]:
        mine = tuple(sorted(int(kof[j]) if j >= 0 else -1
                            for j in out["ipath"][i]))
        if kof[i] < 0 or ans["ends"].get(int(kof[i])) != mine or -1 in mine:
            ends += 1
    nums.update(cp_mismatches=mism,
                cp_count_gap=int(np.abs(cp_ - cr).sum() + abs(ph)),
                path_end_mismatches=ends)
    return nums
