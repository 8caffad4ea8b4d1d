"""FFT-based grid operators (device, torch.fft).

Role of the reference grid3mod FFT machinery (src/grid3mod@proc.f90:
laplacian :1075, gradrho :1164, pot :1245, hxx :1345) built on the cfftnd
mixed-radix FFT (src/cfftnd.f90). Each operator is one forward fftn, a
k-space scaling and one inverse transform per output grid.

Conventions: grids are (n1, n2, n3) tensors over fractional coordinates
(i/n1, j/n2, k/n3); x2c has lattice vectors as columns; G vectors are
built from the standard reciprocal basis (the reference uses the negated
set, which is equivalent for every quadratic form used here, and for
gradrho only |grad rho| is kept).

Precision: the transform runs in the grid's own dtype on every device
(f64 grid -> complex128, f32 grid -> complex64). The full complex fftn
and `.real` are used rather than rfftn, so the Nyquist planes of the odd
operators (i G f_k) are handled exactly as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gvectors", "laplacian", "grad_components", "gradrho", "hxx",
           "pot"]


def _recip_basis(m_x2c) -> np.ndarray:
    """Reciprocal basis b (3,3), columns b_i, with a_i . b_j = 2 pi d_ij."""
    m_x2c = np.asarray(m_x2c, dtype=float)
    vol = abs(np.linalg.det(m_x2c))
    b = np.empty((3, 3))
    b[:, 0] = np.cross(m_x2c[:, 1], m_x2c[:, 2])
    b[:, 1] = np.cross(m_x2c[:, 2], m_x2c[:, 0])
    b[:, 2] = np.cross(m_x2c[:, 0], m_x2c[:, 1])
    return b * (2.0 * np.pi / vol)


def _freqs(shape, dtype, device):
    """The three 1-D integer frequency vectors of the FFT grid, shaped to
    broadcast over (n1, n2, n3)."""
    out = []
    for ax, n in enumerate(shape):
        k = torch.fft.fftfreq(int(n), d=1.0 / int(n), dtype=torch.float64,
                              device=device).to(dtype)
        view = [1, 1, 1]
        view[ax] = int(n)
        out.append(k.reshape(view))
    return out


def _gcomp(ks, b, i):
    """Cartesian component i of G on the grid (broadcast sum of the three
    frequency vectors, in fixed order)."""
    return ks[0] * float(b[i, 0]) + ks[1] * float(b[i, 1]) \
        + ks[2] * float(b[i, 2])


def _g2(ks, b):
    g0, g1, g2 = (_gcomp(ks, b, i) for i in range(3))
    return g0 * g0 + g1 * g1 + g2 * g2


def gvectors(shape, m_x2c, dtype=torch.float64, device="cpu"):
    """Cartesian G vectors on the FFT grid: (n1, n2, n3, 3) on `device`.
    The operators below never materialize this tensor; they form G and
    |G|^2 by broadcasting the 1-D frequency vectors."""
    ks = _freqs(shape, dtype, device)
    b = _recip_basis(m_x2c)
    return torch.stack([_gcomp(ks, b, i) for i in range(3)], dim=-1)


def _setup(f, m_x2c):
    return (torch.fft.fftn(f), _freqs(f.shape, f.dtype, f.device),
            _recip_basis(m_x2c))


def laplacian(f, m_x2c):
    """del^2 f via FFT (reference laplacian, src/grid3mod@proc.f90:1075)."""
    fk, ks, b = _setup(f, m_x2c)
    return torch.fft.ifftn(-_g2(ks, b) * fk).real


def grad_components(f, m_x2c):
    """Cartesian gradient components, (3, n1, n2, n3)."""
    fk, ks, b = _setup(f, m_x2c)
    return torch.stack([torch.fft.ifftn(1j * _gcomp(ks, b, i) * fk).real
                        for i in range(3)])


def gradrho(f, m_x2c):
    """|grad f| grid (reference gradrho, src/grid3mod@proc.f90:1164)."""
    fk, ks, b = _setup(f, m_x2c)
    acc = None
    for i in range(3):
        c = torch.fft.ifftn(1j * _gcomp(ks, b, i) * fk).real
        acc = c * c if acc is None else acc.add_(c * c)
    return torch.sqrt(acc)


def hxx(f, m_x2c, ix: int):
    """Diagonal Cartesian Hessian component d2f/dx_ix^2
    (reference hxx, src/grid3mod@proc.f90:1345)."""
    fk, ks, b = _setup(f, m_x2c)
    gi = _gcomp(ks, b, ix)
    return torch.fft.ifftn(-gi * gi * fk).real


def pot(f, m_x2c, isry: bool = False):
    """Hartree potential of the density f: V(G) = 4 pi rho(G)/G^2, V(0)=0
    (reference pot, src/grid3mod@proc.f90:1245; isry doubles to Rydberg)."""
    fk, ks, b = _setup(f, m_x2c)
    g2 = _g2(ks, b)
    small = g2 < 1e-12
    inv = torch.where(small, torch.zeros_like(g2),
                      4.0 * np.pi / torch.where(small, torch.ones_like(g2),
                                                g2))
    v = torch.fft.ifftn(inv * fk).real
    return 2.0 * v if isry else v
