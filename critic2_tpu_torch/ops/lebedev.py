"""Lebedev-Laikov spherical quadrature grids.

Role of the reference tools_math@lebedev (src/tools_math@lebedev.f90,
7281 LoC of LDnnnn tables + gen_oh): quadrature nodes/weights on the
unit sphere, exact for spherical harmonics up to high order. The
(code, A, B, V) parameters per rule are extracted data
(lebedev.json in the JAX package's data directory, read by file path);
this module reimplements the six octahedral-symmetry point generators (gen_oh,
src/tools_math@lebedev.f90) vectorized in numpy.

Weights follow the Lebedev-Laikov convention: sum(w) = 1, so
integral over the sphere = 4 pi sum w_i f(x_i).
"""
from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

from ..param import DATA_DIR

__all__ = ["lebedev", "good_lebedev", "available_rules"]


@lru_cache(maxsize=1)
def _rules():
    with open(os.path.join(DATA_DIR, "lebedev.json")) as fh:
        return {int(k): v for k, v in json.load(fh).items()}


def available_rules():
    return sorted(_rules())


def good_lebedev(npts: int) -> int:
    """Smallest available rule size >= npts (reference good_lebedev)."""
    for n in available_rules():
        if n >= npts:
            return n
    return available_rules()[-1]


def _gen_oh(code: int, a: float, b: float, v: float):
    """Points of one octahedral symmetry class (reference gen_oh)."""
    if code == 1:               # (1, 0, 0): 6 points
        p = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=float)
    elif code == 2:             # (0, a, a), a = 1/sqrt(2): 12
        a = 1.0 / np.sqrt(2.0)
        p = []
        for s1 in (a, -a):
            for s2 in (a, -a):
                p += [[0, s1, s2], [s1, 0, s2], [s1, s2, 0]]
        p = np.asarray(p)
    elif code == 3:             # (a, a, a), a = 1/sqrt(3): 8
        a = 1.0 / np.sqrt(3.0)
        p = np.array([[sx * a, sy * a, sz * a]
                      for sx in (1, -1) for sy in (1, -1)
                      for sz in (1, -1)])
    elif code == 4:             # (a, a, b), b = sqrt(1 - 2a^2): 24
        bb = np.sqrt(1.0 - 2.0 * a * a)
        p = []
        for s1 in (a, -a):
            for s2 in (a, -a):
                for s3 in (bb, -bb):
                    p += [[s1, s2, s3], [s1, s3, s2], [s3, s1, s2]]
        p = np.asarray(p)
    elif code == 5:             # (a, b, 0), b = sqrt(1 - a^2): 24
        bb = np.sqrt(1.0 - a * a)
        p = []
        for s1 in (a, -a):
            for s2 in (bb, -bb):
                p += [[s1, s2, 0], [s2, s1, 0], [s1, 0, s2],
                      [s2, 0, s1], [0, s1, s2], [0, s2, s1]]
        p = np.asarray(p)
    elif code == 6:             # (a, b, c), c = sqrt(1 - a^2 - b^2): 48
        c = np.sqrt(1.0 - a * a - b * b)
        p = []
        for s1 in (a, -a):
            for s2 in (b, -b):
                for s3 in (c, -c):
                    p += [[s1, s2, s3], [s1, s3, s2], [s2, s1, s3],
                          [s2, s3, s1], [s3, s1, s2], [s3, s2, s1]]
        p = np.asarray(p)
    else:
        raise ValueError(f"gen_oh: invalid code {code}")
    return p, np.full(len(p), v)


@lru_cache(maxsize=None)
def lebedev(npts: int):
    """(points (n, 3), weights (n,)) of the n-point Lebedev rule.
    npts must be one of available_rules()."""
    rules = _rules()
    if npts not in rules:
        raise ValueError(f"no {npts}-point Lebedev rule "
                         f"(available: {available_rules()})")
    ps, ws = [], []
    for code, a, b, v in rules[npts]:
        p, w = _gen_oh(code, a, b, v)
        ps.append(p)
        ws.append(w)
    return np.concatenate(ps), np.concatenate(ws)
