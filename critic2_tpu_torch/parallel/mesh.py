"""Device mesh for sharded grid analysis, and the collectives over it.

The reference scales with OpenMP threads over a shared-memory grid
(reference README.md:78-90; no MPI/distributed layer exists, SURVEY.md
S2.4). As in the JAX package, the device layout is a 2-D mesh:

  - axis "space":  the volumetric grid is slab-sharded along its first
    axis; stencils need halo planes of their neighbours' slabs;
  - axis "points": evaluation batches are data-parallel; sums over
    points are reductions.

One Python process drives every shard (single controller, as the JAX
package's shard_map programs do): a shard is a tensor on its mesh
device, and the collectives below are plain functions over the list of
shards of one mesh axis, in shard order. Copies between shards use
`.to(device, non_blocking=True)`: peer copies between cards, nothing at
all when two shards share a device.

`make_mesh(n, device=d)` puts all n shards on the one device d, the
counterpart of the JAX package's virtual host devices: every halo and
transpose still moves, between tensors of one device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["Mesh", "make_mesh", "mesh_shape_for", "halo_pad",
           "all_to_all", "psum", "gather"]


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """Pick a (space, points) factorization of n_devices.

    Favors the space axis (grids are the large object); falls back to
    (n, 1) for primes.
    """
    best = (n_devices, 1)
    for p in range(2, n_devices + 1):
        if n_devices % p:
            continue
        q = n_devices // p
        if p >= q:
            best = (p, q)
            break
    return best


class Mesh:
    """A (space, points) array of torch devices with named axes;
    `shape` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names=("space", "points")):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def space_devices(self) -> list:
        """The device of each space shard (its first points shard)."""
        return list(self.devices[:, 0])


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = ("space", "points"), *,
              device=None) -> Mesh:
    """Mesh of n_devices shards, one per visible CUDA device in order, or
    all on `device` when it is given. Raises without CUDA unless `device`
    names another device."""
    if device is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is None:
            n_devices = len(devs)
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices, have "
                             f"{len(devs)}")
        devs = devs[:n_devices]
    else:
        dev = resolve_device(device)
        n_devices = 1 if n_devices is None else n_devices
        devs = [dev] * n_devices
    space, points = mesh_shape_for(n_devices)
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(space, points), axis_names)


def halo_pad(shards, left: int, right: int, dim: int = 0) -> list:
    """Each shard with `left` planes of its left neighbour and `right` of
    its right neighbour along `dim`, cyclically (the periodic wrap): the
    lax.ppermute halo exchange. Each width must not exceed a shard."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        lo, hi = shards[i - 1], shards[(i + 1) % n]
        parts = [lo.narrow(dim, lo.shape[dim] - left, left)] if left else []
        parts.append(x)
        if right:
            parts.append(hi.narrow(dim, 0, right))
        out.append(torch.cat([p.to(x.device, non_blocking=True)
                              for p in parts], dim))
    return out


def all_to_all(shards, split_dim: int, concat_dim: int) -> list:
    """Tiled all-to-all (lax.all_to_all(..., tiled=True)): every shard is
    cut into len(shards) equal chunks along split_dim, and shard j
    receives chunk j of every shard, concatenated in shard order along
    concat_dim."""
    n = len(shards)
    chunks = [torch.tensor_split(x, n, dim=split_dim) for x in shards]
    return [torch.cat([chunks[i][j].to(shards[j].device, non_blocking=True)
                       for i in range(n)], concat_dim) for j in range(n)]


def psum(parts):
    """Sum of per-shard tensors (lax.psum), on the first shard's device."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device, non_blocking=True)
    return out


def gather(shards, dim: int = 0, device=None):
    """Shards concatenated along `dim` into one tensor on `device` (the
    first shard's by default)."""
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in shards], dim)
