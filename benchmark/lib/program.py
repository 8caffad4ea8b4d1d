"""The calls into the program that every job makes: a new System from the
configuration's structure, and the density loaded as a grid field that
is already on the device."""
from __future__ import annotations

import numpy as np


def system(ctx, rho):
    """A System of the configuration's crystal with `rho` as its reference
    field, each step in a span of its own."""
    from critic2_tpu_torch.convert import crystal_from_arrays
    from critic2_tpu_torch.fields.field import Field
    from critic2_tpu_torch.fields.grid3 import Grid3
    from critic2_tpu_torch.system import System

    st = ctx.cfg["structure"]
    with ctx.span("system"):
        c = crystal_from_arrays(np.asarray(st["lattice_bohr"]),
                                st["x_frac"], st["species_of"],
                                [(s["name"], s["z"]) for s in st["species"]])
        s = System.from_structure(c, device=ctx.device)
    with ctx.span("field"):
        s.load_field(Field.from_grid(c, Grid3(rho)))
    return s
