"""Real solid harmonics r^l S_lm on batched points.

Role of the reference tools_math genrlm/genylm (src/tools_math.f90:47-50)
as used by the atomic-multipole integration
(src/integration@proc.f90:1102-1178).

Convention: orthonormal real spherical harmonics S_lm (unit sphere
integral = 1) times r^l; component order per l: m = -l..l with sin
components at negative m (the reference's ordering).
"""
from __future__ import annotations

from math import factorial

import numpy as np
import torch

__all__ = ["solid_harmonics", "nlm"]


def nlm(lmax: int) -> int:
    return (lmax + 1) ** 2


def solid_harmonics(xT, lmax: int):
    """r^l S_lm at Cartesian points xT (3, N) tensor -> ((lmax+1)^2, N),
    on the device and in the dtype of xT.

    Associated-Legendre recursion in cos(theta) with r^l folded in to stay
    finite at r = 0; cos/sin(m phi) from Chebyshev-style recursions on the
    Cartesian components (no trig calls).
    """
    x, y, z = xT[0], xT[1], xT[2]
    r2 = x * x + y * y + z * z

    # P~_lm = r^l P_lm(cos theta) / sin^m(theta) * (x,y-recursions carry
    # the sin^m r^m factor): use the standard solid-harmonic recursion on
    # A_lm = r^l P_lm(z/r) sin^-m... Simplest stable scheme: track
    # Q_lm = r^(l-m) P_lm(cos t) (polynomial in z, r2) and the azimuthal
    # factors Cm = Re[(x+iy)^m], Sm = Im[(x+iy)^m].
    Q = {}
    Q[(0, 0)] = torch.ones_like(x)
    for l in range(1, lmax + 1):
        # diagonal: Q_ll = (2l-1) Q_(l-1)(l-1)  [sin^l factor lives in Cm/Sm]
        Q[(l, l)] = (2 * l - 1) * Q[(l - 1, l - 1)]
    for m in range(0, lmax):
        # first off-diagonal
        Q[(m + 1, m)] = (2 * m + 1) * z * Q[(m, m)]
        for l in range(m + 2, lmax + 1):
            # (l-m) P_l^m = (2l-1) x P_(l-1)^m - (l+m-1) P_(l-2)^m,
            # with the r^(l-m) solid factor folded in
            Q[(l, m)] = ((2 * l - 1) * z * Q[(l - 1, m)]
                         - (l + m - 1) * r2 * Q[(l - 2, m)]) / (l - m)

    # azimuthal: Cm = Re[(x+iy)^m], Sm = Im[(x+iy)^m]
    C = [torch.ones_like(x)]
    S = [torch.zeros_like(x)]
    for m in range(1, lmax + 1):
        C.append(x * C[m - 1] - y * S[m - 1])
        S.append(x * S[m - 1] + y * C[m - 1])

    out = []
    for l in range(lmax + 1):
        row = {}
        for m in range(0, l + 1):
            # normalization of real spherical harmonics
            if m == 0:
                norm = float(np.sqrt((2 * l + 1) / (4 * np.pi)))
            else:
                norm = float(np.sqrt((2 * l + 1) / (2 * np.pi)
                                     * float(factorial(l - m))
                                     / float(factorial(l + m))))
            base = Q[(l, m)]
            if m > 0:
                row[-m] = norm * base * S[m]
                row[m] = norm * base * C[m]
            else:
                row[0] = norm * base
        for m in range(-l, l + 1):
            out.append(row[m])
    return torch.stack(out)
