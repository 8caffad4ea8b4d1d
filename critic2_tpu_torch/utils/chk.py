"""Checkpoint files (role of the reference's per-feature binary
checkpoints: AUTO CP lists src/autocp@proc.f90:1054-1113, NCIPLOT
.ncichk src/nci@proc.f90:1027-1059). Stored as npz with a version tag,
with the JAX package's keys, so a file written by either package loads in
the other. Device tensors (the NCI cubes) are copied to the host first.
"""
from __future__ import annotations

import numpy as np

__all__ = ["save_cplist", "load_cplist", "save_nci", "load_nci"]

_VERSION = 1


def _np(a):
    """A tensor (on any device) or array as a host numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def save_cplist(cpl, path: str):
    cps = cpl.cps
    np.savez_compressed(
        path, version=_VERSION,
        x=np.array([_np(cp.x) for cp in cps]),
        typ=np.array([cp.typ for cp in cps]),
        f=np.array([float(cp.f) for cp in cps]),
        gfmod=np.array([float(cp.gfmod) for cp in cps]),
        del2f=np.array([float(cp.del2f) for cp in cps]),
        eig=np.array([_np(cp.eig) for cp in cps]),
        isnuc=np.array([cp.isnuc for cp in cps]),
        mult=np.array([cp.mult for cp in cps]),
        name=np.array([cp.name for cp in cps]))


def load_cplist(system, path: str):
    from ..analysis.autocp import CP, CPList

    d = np.load(path, allow_pickle=False)
    c = system.crystal
    cpl = CPList(crystal=c)
    for i in range(len(d["typ"])):
        x = d["x"][i]
        cpl.cps.append(CP(
            x=x, r=c.x2c(x), typ=int(d["typ"][i]), f=float(d["f"][i]),
            gfmod=float(d["gfmod"][i]), del2f=float(d["del2f"][i]),
            eig=d["eig"][i], isnuc=bool(d["isnuc"][i]),
            mult=int(d["mult"][i]), name=str(d["name"][i])))
    return cpl


def save_nci(res, path: str):
    np.savez_compressed(
        path, version=_VERSION, crho=_np(res.crho), cgrad=_np(res.cgrad),
        cgrad_raw=_np(res.cgrad_raw), x0=_np(res.x0), xmat=_np(res.xmat),
        **({"rhoat": _np(res.rhoat)} if res.rhoat is not None else {}))


def load_nci(path: str):
    """The cubes of a checkpoint as host arrays, with no scatter points."""
    from ..analysis.nci import NCIResult

    d = np.load(path)
    return NCIResult(
        crho=d["crho"], cgrad=d["cgrad"], cgrad_raw=d["cgrad_raw"],
        rhoat=d["rhoat"] if "rhoat" in d else None,
        x0=d["x0"], xmat=d["xmat"],
        dat_sel=np.zeros(0, dtype=bool), _dat=np.zeros((0, 2)))
