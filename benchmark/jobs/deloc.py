"""Job `deloc`: localization and delocalization indices of a solid from
Wannier functions over its YT basins, critic2's `LOAD x.pwc x.chk`,
`INTEGRABLE 1 DELOC WANCUT 4`, `INTEGRALS YT`.

The timed call does what the REPL's INTEGRALS does after those lines, in
the same calls, on a pool item of benchmark/data/bloch_orbitals.py (the
states already on the device): QEData.from_arrays, its density and
attach_wannier (span `states`); a System of the configuration's crystal
with the density as a grid field that carries the states (`system`,
`field`); intgrid(system, method="yt") (`analysis`); deloc_wannier with
the U rotation and WANCUT 4, aggregated onto intgrid's rows (`deloc`);
then the attractors, Fa, LI and populations to the host. The check holds
the attractors (grid positions) and every Fa(a, b, R), LI and population
of matched attractors to the plain reference (benchmark/reference/
deloc.py), which works the density, the basin weights, the Wannier
values, the screening and the translations out again by its own routes.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import deloc as ref_deloc
from benchmark.reference import yt as ref_yt

# the control: the reference one precision below the complex128 of the
# overlaps (complex64, float32)
CONTROL = torch.float32


def _wancut(ctx) -> float:
    return float(ctx.cfg["density"]["wancut"])


def run(ctx, item):
    from critic2_tpu_torch.analysis.deloc import deloc_wannier
    from critic2_tpu_torch.analysis.integration import intgrid
    from critic2_tpu_torch.convert import crystal_from_arrays
    from critic2_tpu_torch.fields.field import Field
    from critic2_tpu_torch.fields.grid3 import Grid3
    from critic2_tpu_torch.fields.qe import QEData
    from critic2_tpu_torch.system import System

    with ctx.span("states"):
        qe = QEData.from_arrays(item["at"], item["nk"], item["n"],
                                item["kpt"], item["wk"], item["ek"],
                                item["occ"], item["ngk"], item["igk_k"],
                                item["nl"], None, item["evc"])
        rho = qe.density()
        qe.attach_wannier([item["u"]], [item["centres_ang"]],
                          [item["spreads_ang2"]], [item["rlatt_ang"]])
    st = ctx.cfg["structure"]
    with ctx.span("system"):
        c = crystal_from_arrays(np.asarray(st["lattice_bohr"]),
                                st["x_frac"], st["species_of"],
                                [(s["name"], s["z"]) for s in st["species"]])
        s = System.from_structure(c, device=ctx.device)
    with ctx.span("field"):
        s.load_field(Field.from_grid(c, Grid3(rho, qe=qe)))
    with ctx.span("analysis"):
        res = intgrid(s, method="yt")
    with ctx.span("deloc"):
        d = deloc_wannier(s.crystal, res.decomp, qe, useu=True,
                          wancut=_wancut(ctx), device=ctx.device)
        agg = d.aggregate(res.attr_map, len(res.rows))
    with ctx.span("readback"):
        return {"iattr": np.asarray(res.decomp.iattr, dtype=np.int64),
                "attr_map": np.asarray(res.attr_map, dtype=np.int64),
                "fa": agg.fa, "li": agg.li(),
                "population": agg.population(),
                "rvec": np.asarray(agg.rvec, dtype=np.int64)}


def counters() -> dict:
    from critic2_tpu_torch.ops import yt_pass

    return dict(yt_pass.launches)


def info(ctx) -> dict:
    """Sizes of the call: N grid points, K flux neighbours, nmo Wannier
    functions (lattice vectors times bands)."""
    shape = tuple(int(v) for v in ctx.cfg["grid"])
    offs, _ = ref_yt.ws_facets(ref_yt.grid_lattice(
        ctx.cfg["structure"]["lattice_bohr"], shape))
    m = ctx.cfg["density"]
    return {"N": int(np.prod(shape)), "K": len(offs),
            "nmo": int(np.prod(m["nk"])) * int(m["bands"])}


def reference(ctx, item, dtype):
    return ref_deloc.deloc(item, ctx.cfg["structure"]["lattice_bohr"],
                           dtype, wancut=_wancut(ctx))


def as_output(ans) -> dict:
    """A reference answer in the shape of the program's outputs (one row
    per attractor): what the control hands to compare()."""
    n = len(ans["iattr"])
    return {"iattr": ans["iattr"], "attr_map": np.arange(n),
            "fa": ans["fa"], "li": ans["li"],
            "population": ans["population"], "rvec": ans["rvec"]}


def compare(ctx, out, ans) -> dict:
    """attractors_unmatched: attractors of one side missing on the other;
    fa_gap: the widest gap of Fa(a, b, R) over the rows whose attractors
    are all matched and every lattice vector R (infinite where a side
    lacks an R); li_gap, population_gap_e: the widest gap of a row's LI
    and population (e), the latter infinite unless every attractor is
    matched."""
    ref_pos = {int(v): i for i, v in enumerate(ans["iattr"])}
    prog = [int(v) for v in out["iattr"]]
    unmatched = len(set(prog) ^ set(ref_pos))
    nrows = out["fa"].shape[1]
    inf = {"attractors_unmatched": unmatched, "fa_gap": np.inf,
           "li_gap": np.inf, "population_gap_e": np.inf}
    # the reference's R axis in the program's order
    rref = {tuple(int(v) for v in r): i for i, r in enumerate(ans["rvec"])}
    rout = [tuple(int(v) for v in r) for r in out["rvec"]]
    if sorted(rout) != sorted(rref) or len(rout) != out["fa"].shape[3]:
        return inf
    perm = np.array([rref[r] for r in rout])
    # rows of the program made of matched attractors; the reference's Fa
    # summed onto them
    members = [[] for _ in range(nrows)]
    whole = np.ones(nrows, dtype=bool)
    for a, row in zip(prog, out["attr_map"]):
        if row < 0:
            continue
        if a in ref_pos:
            members[row].append(ref_pos[a])
        else:
            whole[row] = False
    if not whole.any():
        return inf
    fa_ref = ans["fa"][..., perm]
    ref_rows = np.zeros_like(out["fa"])
    for r in range(nrows):
        for c in range(nrows):
            for i in members[r]:
                for j in members[c]:
                    ref_rows[:, r, c] += fa_ref[:, i, j]
    fspin = 2.0 if out["fa"].shape[0] == 1 else 1.0
    r0 = rout.index((0, 0, 0))
    li_ref = fspin * np.abs(ref_rows[:, :, :, r0]).sum(0).diagonal()
    pop_ref = fspin * np.abs(ref_rows).sum(axis=(0, 3)).sum(axis=1)
    ww = np.ix_(whole, whole)
    return {"attractors_unmatched": unmatched,
            "fa_gap": float(np.abs(out["fa"] - ref_rows)[:, ww[0], ww[1]]
                            .max()),
            "li_gap": float(np.abs(out["li"] - li_ref)[whole].max()),
            "population_gap_e": (float(np.abs(out["population"]
                                              - pop_ref).max())
                                 if unmatched == 0 and whole.all()
                                 else np.inf)}
