"""Dtype tiers and device selection for the PyTorch/CUDA port.

PyTorch has no global 64-bit switch, so every tensor the port creates
names its dtype: FDTYPE (f64) is the default for correctness (basin
charges must accumulate in f64 to reach the 1e-6 e parity bar), EDTYPE
(f32) is the opt-in throughput tier (the Gauss-Seidel sweeps of the YT
solve run in it, wrapped in f64 refinement).

Device rule: entry points take ``device=``. With no device they run on
``cuda`` and raise when CUDA is missing; they never drop to the CPU
silently. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

FDTYPE = torch.float64   # accumulation / host-parity tier
EDTYPE = torch.float32   # throughput tier (opt-in)

# cube writers: E22.14 body values (the reference `precisecube` default,
# src/global@proc.f90:90) or the standard 1p,e12.5
PRECISECUBE = True


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else cuda.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "critic2_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev
