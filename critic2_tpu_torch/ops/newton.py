"""Batched damped-free Newton search for critical points (device).

Replacement for the reference's per-seed Newton loop
(src/fieldmod@proc.f90:1832-1868 `newton`): all seeds advance in lockstep
with per-seed convergence/failure masks; the LINPACK dgeco/dgedi 3x3
Hessian solve becomes the closed-form adjugate solve on symmetric
components (ops/eig3.py solve3s).

Layout: batch-last SoA throughout the loop - positions (3, N), gradients
(3, N), Hessians (6, N). The public interface stays (N, 3).

Loop structure: segments of `chunk` masked iterations are enqueued on the
device with no host read inside a segment; the host reads the settled
mask once per segment and, for large batches, packs the lanes that are
still active before the next one.

Semantics mirror the reference exactly: stop when |grad f| < gfnormeps
(success), when |det H| < 1e-30 (singular failure), or after maxit
iterations (failure).
"""
from __future__ import annotations

import torch

from .eig3 import solve3s

__all__ = ["newton_batch"]

COMPACT_MIN = 4096     # batches below this never pack their active lanes


def _newton_segment(eval_fn, xT, conv, failed, gfnormeps, nsteps: int):
    """Advance all active seeds nsteps Newton iterations (masked, all on
    the device), then check the final positions once."""

    def check(xT):
        _, gf, h6 = eval_fn(xT)
        gfmod2 = (gf * gf).sum(0)
        cnow = gfmod2 < gfnormeps * gfnormeps
        nan = ~torch.isfinite(xT).all(0) | ~torch.isfinite(gf).all(0)
        return gf, h6, cnow, nan

    for _ in range(nsteps):
        gf, h6, cnow, nan = check(xT)
        step_num, det = solve3s(h6, gf)
        sing = det.abs() < 1e-30
        conv = conv | cnow
        failed = failed | ((sing | nan) & ~conv)
        active = ~(conv | failed)
        step = step_num / torch.where(sing, torch.ones_like(det), det)[None, :]
        xT = torch.where(active[None, :], xT - step, xT)

    # convergence state of the final positions
    _, _, cfin, _ = check(xT)
    conv = conv | (cfin & ~failed)
    return xT, conv, failed


def _newton_run(eval_fn, xT, gfnormeps, maxit, chunk, compact_min):
    """The segment loop of newton_batch on SoA positions xT (3, N); lanes
    are packed between segments when N >= compact_min. Lanes are
    independent, so the result does not depend on the packing."""
    N = xT.shape[1]
    conv = torch.zeros(N, dtype=torch.bool, device=xT.device)
    failed = torch.zeros(N, dtype=torch.bool, device=xT.device)
    compact = N >= compact_min
    it = 0
    idx = None                      # None = all lanes active, unpacked
    while it < maxit:
        n = min(chunk, maxit - it)
        if idx is not None:
            xs, cs, fs = _newton_segment(eval_fn, xT[:, idx], conv[idx],
                                         failed[idx], gfnormeps, n)
            xT[:, idx] = xs
            conv[idx] = cs
            failed[idx] = fs
        else:
            xT, conv, failed = _newton_segment(eval_fn, xT, conv, failed,
                                               gfnormeps, n)
        it += n
        settled = (conv | failed).cpu()   # the one host read of a segment
        if bool(settled.all()):
            break
        if compact:
            active = torch.nonzero(~settled)[:, 0]
            # pack once the active set is down to half the batch
            if len(active) <= N // 2:
                idx = active.to(xT.device)
    return xT, conv, it


def newton_batch(eval_fn, x0, gfnormeps: float = 1e-12, maxit: int = 200,
                 chunk: int = 10, loop: str | None = None,
                 compact: bool = True):
    """Run Newton iterations from a batch of Cartesian seeds. `loop` is
    accepted and ignored: the port has one loop form.

    eval_fn: SoA evaluator (3, N) -> (f (N,), gf (3, N), h6 (6, N)) on
    the device of x0. x0: (N, 3) Cartesian seeds (tensor).

    compact: between iteration segments, gather the still-active lanes
    and scatter their results back. Lockstep width is the large-batch
    Newton's wall: most seeds converge in a few tens of iterations while
    a handful of oscillating lanes run to maxit, and without compaction
    EVERY lane pays every straggler iteration. Disabled for small batches
    where the extra launches cost more than the width saves.
    Returns (x (N, 3) final positions, conv (N,) success mask, nit).
    """
    xT = x0.T.clone(memory_format=torch.contiguous_format)
    xT, conv, it = _newton_run(
        eval_fn, xT, gfnormeps, maxit, chunk,
        COMPACT_MIN if compact else xT.shape[1] + 1)
    return xT.T, conv, it
