#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of critic2-tpu on one GPU and check it.

    python3 chip_smoke.py            # full run: NaCl analogue at 256^3
    python3 chip_smoke.py --profile  # also: where one intgrid's time goes

Phases (any failure exits non-zero; no phase catches its own failure):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from critic2_tpu_torch/csrc/;
  3. hold each kernel against its plain PyTorch version on the card:
     cubic (K=6) and triclinic (K=14) grid lattices at 48^3, P=2, float32
     and float64, adjoint and forward; then shapes that stress
     yt_gs_pass's tiles: P=1, P=8 forward (as labels calls it), P=12 (more
     integrands than one launch holds, so the wrapper launches chunks), a
     40x50x37 grid whose tiles are ragged on both plane axes, a smooth
     single-maximum density whose in-plane chains cross many tiles, and
     an 8x264x264 grid whose tiles exceed a block's threads.
     yt_pass must match to rtol 1e-6 (f32) / 1e-13 (f64); yt_gs_pass
     sweep pairs are iterated to a zero flag and the fixpoints must be
     bitwise equal and every flag the same;
  4. the slice: promolecular NaCl analogue (a = 10.66 bohr, 4 atoms)
     rasterized on the card, System -> intgrid(method="yt") once warm and
     once timed with the launch counts reset just before; partition of
     unity and agreement with the f64 Jacobi route (_xla_sweep) on the
     same card to 1e-8 e per basin; each kernel against its plain version
     at the shapes the slice gives it (yt_gs_pass bitwise);
  5. per-kernel times at the slice's shape with CUDA events, beside the
     plain versions and the bytes bound; yt_gs_pass's grid barriers per
     sweep beside the earlier global-Jacobi schedule's count (from the
     plain version's in-plane iterations), and the time, grid barriers
     and block 0's local iterations of each of the 16 sweeps of one
     adjoint solve;
then one JSON line of kernel records and, last, the device JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
N_SLICE = 256                  # the yt256 leg of tools/parity_bench.py
N_KERNEL = 48                  # grid of the kernel-against-plain phase
REPLACES = {"yt_pass": "critic2_tpu/ops/yt_pass.py:126",
            "yt_gs_pass": "critic2_tpu/ops/yt_pass.py:292"}
SOURCE = {"yt_pass": "critic2_tpu_torch/csrc/yt_pass.cu",
          "yt_gs_pass": "critic2_tpu_torch/csrc/yt_gs_pass.cu"}


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """Fail the run (a plain raise: it must hold under python -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def density(crystal, shape, rng, noise=1e-3, nsite=2):
    """Gaussians at the crystal's first nsite sites, plus uniform noise
    (plateaus broken) unless noise is 0."""
    import numpy as np

    g = np.stack(np.meshgrid(*[np.arange(n) / n for n in shape],
                             indexing="ij"), -1)
    rho = np.zeros(shape)
    for site, amp in list(zip(crystal.x_frac, (1.0, 0.8)))[:nsite]:
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ crystal.m_x2c.T) ** 2).sum(-1))
    return rho + noise * rng.random(rho.shape)


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def gs_fixpoint(gs, op, f3, offs, adjoint, tag):
    """Gauss-Seidel sweep pairs from f to a pair with both flags 0; returns
    (fixpoint, flags, the first sweep's schedule counters)."""
    from critic2_tpu_torch.ops import yt_pass as ops

    s, flags, first = f3, [], None
    for _ in range(sum(f3.shape[1:]) + 16):
        s, c1 = gs(op, s, f3, offs=offs, adjoint=adjoint, backward=False)
        if first is None:
            first = ops.gs_counts()
        s, c2 = gs(op, s, f3, offs=offs, adjoint=adjoint, backward=True)
        flags.append((int(c1), int(c2)))
        if flags[-1] == (0, 0):
            return s, flags, first
    raise RuntimeError(f"yt_gs_pass {tag}: no fixpoint")


def kernel_phase(dev, n):
    """Phase 3: every kernel against its plain version: n^3, P=2 on both
    lattices, then the shapes that stress yt_gs_pass's tiles."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
    from critic2_tpu_torch.crystal.crystal import Crystal, Species
    from critic2_tpu_torch.ops import yt_pass as ops

    rng = np.random.default_rng(7)
    lattices = {"cubic": ([8.0, 8.0, 8.0], [90, 90, 90]),
                "triclinic": ([8.0, 7.0, 6.5], [75, 80, 70])}
    f32, f64 = torch.float32, torch.float64
    # (lattice, shape, P, dtypes, directions, density noise, sites)
    cases = [(lat, (n,) * 3, 2, (f32, f64), (True, False), 1e-3, 2)
             for lat in lattices]
    cases += [
        # labels' forward solve of a chunk of 8 basins
        ("cubic", (n,) * 3, 8, (f32,), (False,), 1e-3, 2),
        ("triclinic", (n,) * 3, 8, (f64,), (False,), 1e-3, 2),
        # more integrands than one launch holds: chunks of 8 and 4
        ("cubic", (n,) * 3, 12, (f32, f64), (False,), 1e-3, 2),
        # one integrand (volumes alone)
        ("triclinic", (n,) * 3, 1, (f32, f64), (True,), 1e-3, 2),
        # n2, n3 not multiples of the tile (13 x 19 on 50 x 37)
        ("cubic", (40, 50, 37), 2, (f32, f64), (True,), 1e-3, 2),
        # one smooth maximum: in-plane chains cross many tiles
        ("cubic", (n,) * 3, 2, (f32,), (True, False), 0.0, 1),
        # tiles of more points than a block has threads (the general path)
        ("cubic", (8, 264, 264), 2, (f32,), (True,), 1e-3, 2)]
    for lname, shape, P, dtypes, dirs, noise, nsite in cases:
        c = Crystal(m_x2c=m_x2c_from_cellpar(*lattices[lname]),
                    x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.7, 0.6]]),
                    species_of=np.array([0, 0]), species=[Species("C", 6)])
        rho = torch.as_tensor(density(c, shape, rng, noise, nsite),
                              dtype=torch.float64, device=dev)
        offs_np, wts = yt._grid_ws_neighbors(c, rho.shape)
        offs = tuple(tuple(int(v) for v in o) for o in offs_np)
        chi, _ = yt._flux_tensors(rho, wts, offs)
        s_rand = torch.as_tensor(rng.random((P,) + shape), device=dev)
        fs = torch.cat([torch.stack([torch.ones_like(rho), rho]),
                        torch.as_tensor(rng.random((P,) + shape),
                                        device=dev)])[:P]
        for dt in dtypes:
            rtol = 1e-6 if dt == f32 else 1e-13
            for adjoint in dirs:
                op = yt._shifted(chi, offs, dt) if adjoint else chi.to(dt)
                f3 = fs.to(dt)
                s = s_rand.to(dt)
                tag = (f"{lname} {'x'.join(map(str, shape))} K={len(offs)} "
                       f"P={P} {str(dt)[6:]} "
                       f"{'adjoint' if adjoint else 'forward'}"
                       f"{' smooth' if noise == 0 else ''}")
                out_k = ops.yt_pass(op, s, f3, offs=offs, adjoint=adjoint)
                out_p = ops.yt_pass_plain(op, s, f3, offs=offs,
                                          adjoint=adjoint)
                e = rel_err(out_k, out_p)
                check(e <= rtol, f"yt_pass {tag}: rel err {e:.3e} > {rtol}")

                sk, fk, ck = gs_fixpoint(ops.yt_gs_pass, op, f3, offs,
                                         adjoint, tag)
                sp, fp, cp = gs_fixpoint(ops.yt_gs_pass_plain, op, f3, offs,
                                         adjoint, tag)
                check(fk == fp, f"yt_gs_pass {tag}: flags {fk} vs {fp}")
                check(torch.equal(sk, sp), f"yt_gs_pass {tag}: fixpoints "
                      f"differ, rel err {rel_err(sk, sp):.3e}")
                log(f"kernel check {tag}: yt_pass rel err {e:.3e}; "
                    f"yt_gs_pass fixpoint bitwise equal after {len(fk)} "
                    f"pairs, tile {ck['tile'][0]}x{ck['tile'][1]} x "
                    f"{ck['tiles']}, {ck['pc']} integrands a launch, "
                    f"first sweep grid barriers {ck['grid_barriers']} "
                    f"(global-Jacobi schedule {cp['old_grid_barriers']})")
                ty, tz = ck["tile"]
                if shape == (40, 50, 37):
                    check(shape[1] % ty and shape[2] % tz,
                          f"{tag}: tile {ty}x{tz} divides the plane")
                if shape == (8, 264, 264):
                    check(not ck["res"], f"{tag}: tile {ty}x{tz} holds its "
                          "points in registers")
                check((ck["pc"] < P) == (P > ops.GS_MAXP),
                      f"{tag}: {ck['pc']} integrands a launch")
    log(json.dumps({"kernels_checked": ["yt_pass", "yt_gs_pass"]}))


def nacl_crystal():
    import numpy as np

    from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
    from critic2_tpu_torch.crystal.crystal import Crystal, Species

    return Crystal(m_x2c=m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                                    [0.5, 0.5, 0.0], [0.0, 0.0, 0.5]]),
                   species_of=np.array([0, 1, 0, 1]),
                   species=[Species("Na", 11), Species("Cl", 17)])


def slice_phase(dev, n):
    """Phase 4: System -> intgrid(method="yt") on the NaCl analogue."""
    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.analysis.integration import (_rasterize_field,
                                                        intgrid)
    from critic2_tpu_torch.fields.field import Field
    from critic2_tpu_torch.fields.grid3 import Grid3
    from critic2_tpu_torch.ops import yt_pass as ops

    c = nacl_crystal()
    s = System.from_structure(c, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = _rasterize_field(s.fields[0], (n, n, n))
    torch.cuda.synchronize()
    t_raster = time.perf_counter() - t0
    s.load_field(Field.from_grid(c, Grid3(g), name="promolgrid"))
    check(g.shape == (n, n, n) and bool(torch.isfinite(g).all()),
          "rasterized grid: wrong shape or not finite")

    t0 = time.perf_counter()
    intgrid(s, method="yt")
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    r = intgrid(s, method="yt")
    t_timed = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"slice {n}^3: rasterize {t_raster:.3f} s, intgrid warm "
        f"{t_warm:.3f} s, intgrid timed {t_timed:.3f} s, nattr "
        f"{r.nattr_raw}, peak device memory {peak_gib:.2f} GiB, "
        f"launches per intgrid {launches}")
    log(r.table())
    for k in ops.launches:
        check(launches[k] > 0, f"the main path launched no {k} kernel")

    dv = c.volume / n**3
    q = np.array([row.pop for row in r.rows])
    v = np.array([row.volume for row in r.rows])
    names = sorted(row.name for row in r.rows)
    check(np.isfinite(q).all() and np.isfinite(v).all(),
          "charges or volumes not finite")
    check(names == ["Cl", "Cl", "Na", "Na"], f"basin rows {names}")
    punity = abs(q.sum() - float(g.sum()) * dv)
    vunity = abs(v.sum() - c.volume)
    log(f"partition of unity: |sum q - int rho| = {punity:.3e} e, "
        f"|sum V - cell| = {vunity:.3e} bohr^3")
    check(punity <= 1e-8, f"partition of unity {punity:.3e} e")

    # the same charges from the f64 Jacobi route on the same card
    res = r.decomp
    f3 = torch.stack([torch.ones_like(g), g]).reshape((2,) + res.shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sx = yt._xla_sweep(res._chiP, f3, res._offs)
    torch.cuda.synchronize()
    t_xla = time.perf_counter() - t0
    i1, i2, i3 = res._index(res.iattr)
    q_ref = sx[1, i1, i2, i3].cpu().numpy() * dv
    q_raw = res.integrate(g.reshape(-1)) * dv
    dq = float(np.abs(q_raw - q_ref).max())
    log(f"per-basin |q(kernels) - q(f64 Jacobi)| max = {dq:.3e} e "
        f"(f64 Jacobi solve {t_xla:.3f} s)")
    check(dq <= 1e-8, f"charges vs f64 Jacobi {dq:.3e} e")
    return {"system": s, "raster_s": t_raster, "intgrid_warm_s": t_warm,
            "intgrid_s": t_timed, "nattr": r.nattr_raw,
            "punity_e": punity, "dq_vs_f64_jacobi_e": dq,
            "launches": launches, "res": res, "f3": f3, "dv": dv}


def main_shape_phase(sl):
    """Each kernel against its plain version at the slice's shapes, and
    its time there beside the plain version's and the bytes bound."""
    import torch

    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.ops import yt_pass as ops

    res, f3 = sl["res"], sl["f3"]
    offs = res._offs
    chi32, chi64 = res._chis(adjoint=True)
    P = f3.shape[0]
    N = f3[0].numel()
    K = len(offs)
    out = {}

    # yt_pass as the slice calls it: f64 residual, shifted f64 chi
    s1 = f3 * 0.5
    k = ops.yt_pass(chi64, s1, f3, offs=offs)
    p = ops.yt_pass_plain(chi64, s1, f3, offs=offs)
    err = float((k - p).abs().max())
    check(err <= 1e-13 * float(p.abs().max()), f"yt_pass err {err:.3e}")
    ms = {}
    plain = {}
    for dt in (torch.float32, torch.float64):
        op, ss, ff = chi64.to(dt), s1.to(dt), f3.to(dt)
        ms[dt] = cuda_ms(lambda: ops.yt_pass(op, ss, ff, offs=offs), 20)
        plain[dt] = cuda_ms(lambda: ops.yt_pass_plain(op, ss, ff, offs=offs),
                            5)
        log(f"yt_pass {str(dt)[6:]} P={P} K={K} N={N}: kernel "
            f"{ms[dt]:.4f} ms, plain {plain[dt]:.4f} ms, bytes bound "
            f"{(K + 3 * P) * N * dt.itemsize / HBM_BYTES_PER_S * 1e3:.4f} ms")
    out["yt_pass"] = dict(
        max_abs_err=err, ms=ms[torch.float64], plain_ms=plain[torch.float64],
        bound_ms=(K + 3 * P) * N * 8 / HBM_BYTES_PER_S * 1e3)

    # yt_gs_pass as the slice calls it: f32, adjoint, first pair from f
    f32 = f3.to(torch.float32)

    def pair(gs, op, ff, counts=None):
        """One forward + backward pair from ff; flags stay on the device
        (counts, when given, takes each sweep's schedule counters)."""
        a, c1 = gs(op, ff, ff, offs=offs, backward=False)
        if counts is not None:
            counts.append(ops.gs_counts())
        b, c2 = gs(op, a, ff, offs=offs, backward=True)
        if counts is not None:
            counts.append(ops.gs_counts())
        return b, c1, c2

    kc, pc, got = [], [], []
    bk, k1, k2 = pair(ops.yt_gs_pass, chi32, f32, kc)
    plain_gs = cuda_ms(lambda: got.append(
        pair(ops.yt_gs_pass_plain, chi32, f32, pc)), 1, warm=0) / 2
    bp, p1, p2 = got[0]
    flags_k, flags_p = (int(k1), int(k2)), (int(p1), int(p2))
    err = float((bk - bp).abs().max())
    check(flags_k == flags_p, f"flags {flags_k} vs {flags_p}")
    check(torch.equal(bk, bp), f"yt_gs_pass first pair differs: {err:.3e}")
    for j, (ck, cp) in enumerate(zip(kc, pc)):
        log(f"yt_gs_pass first pair, sweep {j + 1}: grid barriers "
            f"{ck['grid_barriers']} (= tile rounds; tile "
            f"{ck['tile'][0]}x{ck['tile'][1]} x {ck['tiles']}), block 0's "
            f"local iterations {ck['local_iters_block0']}; global-Jacobi "
            f"schedule {cp['old_grid_barriers']} (in-plane Jacobi "
            f"iterations {sum(cp['jacobi_iters'])} + "
            f"{len(cp['jacobi_iters'])} planes)")
        check(ck["grid_barriers"] < cp["old_grid_barriers"],
              f"sweep {j + 1}: {ck['grid_barriers']} grid barriers, not "
              f"fewer than {cp['old_grid_barriers']}")
    gms = {}
    for dt, op in ((torch.float32, chi32), (torch.float64, chi64)):
        ff = f3.to(dt)
        gms[dt] = cuda_ms(lambda: pair(ops.yt_gs_pass, op, ff), 3) / 2
        log(f"yt_gs_pass {str(dt)[6:]} P={P} K={K}: first sweep pair from "
            f"f {gms[dt]:.4f} ms per sweep, bytes bound "
            f"{(K + 3 * P) * N * dt.itemsize / HBM_BYTES_PER_S * 1e3:.4f} ms")
    log(f"yt_gs_pass plain float32: {plain_gs:.4f} ms per sweep")

    # the 16 sweeps of one adjoint solve, as _solve_sweep runs them: 4
    # pairs on f, the f64 residual by yt_pass, 4 pairs on the residual
    sweeps = []

    def pairs4(rhs):
        s = rhs
        for j in range(8):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            s, _ = ops.yt_gs_pass(chi32, s, rhs, offs=offs,
                                  backward=j % 2 == 1)
            b.record()
            sweeps.append((a, b, ops.gs_counts()))
        return s

    s1 = pairs4(f32).to(f3.dtype)
    r = ops.yt_pass(chi64, s1, f3, offs=offs) - s1
    solved = s1 + pairs4(r.to(torch.float32)).to(f3.dtype)
    torch.cuda.synchronize()
    check(torch.equal(solved, yt._solve_sweep(res._chiP, chi32, chi64, f3,
                                              offs)),
          "the timed sweeps differ from _solve_sweep")
    sweep_ms = [a.elapsed_time(b) for a, b, _ in sweeps]
    barriers = [c["grid_barriers"] for _, _, c in sweeps]
    local = [c["local_iters_block0"] for _, _, c in sweeps]
    for j, (t_ms, nb, nl) in enumerate(zip(sweep_ms, barriers, local)):
        log(f"adjoint solve sweep {j + 1:2d} "
            f"({'residual' if j >= 8 else 'f'}, "
            f"{'backward' if j % 2 else 'forward'}): {t_ms:.4f} ms, grid "
            f"barriers {nb}, block 0's local iterations {nl}")
    log(f"adjoint solve: 16 sweeps {sum(sweep_ms):.4f} ms")
    out["yt_gs_pass"] = dict(
        max_abs_err=err, ms=gms[torch.float32], plain_ms=plain_gs,
        bound_ms=(K + 3 * P) * N * 4 / HBM_BYTES_PER_S * 1e3,
        extra={"ms_f64": gms[torch.float64],
               "tile": list(kc[0]["tile"]), "tiles": kc[0]["tiles"],
               "grid_barriers_first_pair": [c["grid_barriers"] for c in kc],
               "local_iters_block0_first_pair":
                   [c["local_iters_block0"] for c in kc],
               "old_grid_barriers_first_pair": [c["old_grid_barriers"]
                                                for c in pc],
               "solve_sweep_ms": sweep_ms,
               "solve_grid_barriers": barriers,
               "solve_local_iters_block0": local})

    # open question: f64 Gauss-Seidel directly vs f32 + one refinement
    ref = yt._solve_sweep(res._chiP, chi32, chi64, f3, offs)
    t_ref = cuda_ms(lambda: yt._solve_sweep(res._chiP, chi32, chi64, f3,
                                            offs), 1, warm=0)
    d64 = yt._kernel_sweep(chi64, f3, offs, True)
    t_d64 = cuda_ms(lambda: yt._kernel_sweep(chi64, f3, offs, True), 1,
                    warm=0)
    i1, i2, i3 = res._index(res.iattr)
    dq = float((d64[1, i1, i2, i3] - ref[1, i1, i2, i3]).abs().max()) \
        * sl["dv"]
    log(f"adjoint solve P={P}: f32 GS + f64 refinement {t_ref:.3f} ms, "
        f"f64 GS direct {t_d64:.3f} ms, per-basin charge difference "
        f"{dq:.3e} e")
    return out


def profile_phase(sl):
    """Where the time of one intgrid goes: host-clocked stages, then the
    device time by kernel from torch.profiler and the device idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from critic2_tpu_torch.analysis.integration import intgrid
    from critic2_tpu_torch.analysis.yt import yt_integrate

    s = sl["system"]
    g = s.ref.grid.f
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = yt_integrate(s.crystal, g)
    torch.cuda.synchronize()
    stages["decompose (flux tensors, attractors)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res._chis(adjoint=True)
    torch.cuda.synchronize()
    stages["shifted f32/f64 flux copies"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res.integrate(sl["f3"].reshape(2, -1))
    stages["adjoint solve P=2 (host read included)"] = \
        time.perf_counter() - t0
    for k, v in stages.items():
        log(f"stage {k}: {v * 1e3:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        intgrid(s, method="yt")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel and memcpy records only: an operator's own record repeats
    # the device time of the kernels it launched
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    wall_ms = wall * 1e3
    log(f"profiled intgrid: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.4f}")
    check(busy_ms <= wall_ms, f"device busy {busy_ms:.3f} ms exceeds the "
          f"wall {wall_ms:.3f} ms: device time is counted twice")
    for e in sorted(ev, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        if e.self_device_time_total > 0:
            log(f"  device {e.self_device_time_total / 1e3:10.3f} ms  "
                f"x{e.count:<5d} {e.key[:70]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break one intgrid down by stage and kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from critic2_tpu_torch.ops import _ext

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"card: {card.splitlines()[0]}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _ext.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, out in _ext.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    kernel_phase(dev, N_KERNEL)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    sl = slice_phase(dev, N_SLICE)
    meas = main_shape_phase(sl)
    if args.profile:
        profile_phase(sl)
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name in ("yt_pass", "yt_gs_pass"):
        m = meas[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": sl["launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": None, **m.get("extra", {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
