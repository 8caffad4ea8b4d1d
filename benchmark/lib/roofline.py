"""Peaks of the card and the least bytes of the measured work.

The peaks are the published ones of one NVIDIA H100 SXM (data sheet,
dense rates, 700 W). A roofline share is stated against them, with the
card's power limit beside it.
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12


def yt_launch_bytes(K: int, P: int, N: int, itemsize: int) -> int:
    """Least bytes of one YT relaxation launch (yt_pass or a yt_gs_pass
    sweep) over a stack of P integrands on N points: the K flux planes and
    the P source and P right-hand-side grids read once, the P results
    written once: (K + 3P) N sizeof(dtype). Both kernels are bound by
    these bytes: a launch does 2 K P N flops, under 1 flop a byte."""
    return (K + 3 * P) * N * itemsize


def nci_job_bytes(N: int, in_itemsize: int = 8, out_itemsize: int = 4,
                  nout: int = 2) -> int:
    """Least bytes of one NCI job over an N-point grid: the input grid read
    once and the job's output grids (sign(lambda2) rho and the RDG)
    written once."""
    return N * (in_itemsize + nout * out_itemsize)


def least_seconds(nbytes: float) -> float:
    """The time the card's HBM needs to move nbytes."""
    return nbytes / H100_HBM_BYTES_PER_S
