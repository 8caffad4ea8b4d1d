#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of critic2-tpu on one GPU and check it.

    python3 chip_smoke.py            # full run: NaCl analogue at 256^3
    python3 chip_smoke.py --profile  # also: where the time of one intgrid,
                                     # autocp, nciplot, makegraph and
                                     # Bader intgrid goes

Phases (any failure exits non-zero; no phase catches its own failure):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from critic2_tpu_torch/csrc/;
  3. hold each kernel against its plain PyTorch version on the card:
     cubic (K=6) and triclinic (K=14) grid lattices at 48^3, P=2, float32
     and float64, adjoint and forward; then shapes that stress
     yt_gs_pass's tiles: P=1, P=8 forward (as labels calls it), P=12 (more
     integrands than one launch holds, so the wrapper launches chunks), a
     40x50x37 grid whose tiles are ragged on both plane axes, a smooth
     single-maximum density whose in-plane chains cross many tiles,
     8x264x264 grids (cubic and triclinic) whose tiles hold 2 points a
     thread, and anthracene's grid lattice (K=8) at 8x270x504, whose
     45x23 tiles hold 3 points a thread in float32 and stay in shared
     memory in float64 (P=2, both directions; points a thread, grid
     barriers and block 0's local iterations printed); then, along axis
     1 (float32): the same lattice (planes of 8 x 504), anthracene's grid
     lattice cut to 8 of its 270 b planes at 384x8x504 (the full grid's
     384 x 504 planes: 35x42 tiles, 132 of them, 3 points a thread) and
     a triclinic 50x40x37 grid (13x19 tiles, ragged on both plane axes),
     and last anthracene's
     full 384 x 270 x 504 grid on the benchmark's first density of seed
     1234567891 (benchmark/lib/density.py), swept along axis 0 and along
     axis 1 (the axis yt_integrate picks there): per sweep of the first
     adjoint f32 pair (P = 2) its time, grid barriers, block 0's local
     iterations and tile, the pairs each axis takes to a zero flag, and
     the refined solve of each axis (launches, time, and its values at
     the 48 attractors against the other axis's, 1e-12 relative), and
     along axis 1 the time and grid barriers of each of that solve's
     sweeps, timed one by one, its result bitwise the untimed solve's.
     yt_pass must match bitwise (its relative error printed); yt_gs_pass
     sweep pairs are iterated to a zero flag and the fixpoints must be
     bitwise equal and every flag the same;
  4. the slice: promolecular NaCl analogue (a = 10.66 bohr, 4 atoms)
     rasterized on the card, System -> intgrid(method="yt") once warm and
     once timed with the launch counts reset just before; partition of
     unity and agreement with the f64 Jacobi route (_xla_sweep) on the
     same card to 1e-8 e per basin; each kernel against its plain version
     at the shapes the slice gives it (both bitwise);
  5. per-kernel times at the slice's shape with CUDA events, beside the
     plain versions and the bytes bound; yt_pass also at P = 1 and at
     multipoles' chunk of P = 8, in f64 and f32, each bitwise against its
     plain version and beside one torch.sparse.addmm on the same operator
     in CSR form (its library yardstick); yt_gs_pass's grid barriers per
     sweep beside the earlier global-Jacobi schedule's count (from the
     plain version's in-plane iterations), and the time, grid barriers
     and block 0's local iterations of each of the 16 sweeps of one
     adjoint solve;
  6. the grid main path on the same 256^3 grid field (no CUDA kernel of
     the port lies on it; plain PyTorch ops on the card):
     interpolation - interp_soa against interp_soa_rows at 131,072
     scattered points and against interp_grid_soa on a 63x62x61 output
     grid with a non-zero origin (1e-10 relative, f64), node values
     reproduced exactly, a 4,096-point subsample against the CPU (1e-12),
     evals/s of each route in f32 and f64;
     autocp - the default run (WS seeds, depth 1) and the heavy run
     (depth 2): Poincare-Hopf sum 0, |grad| < 1e-10 at every accepted CP,
     the default run's CP list against the same call on the CPU (counts,
     types, multiplicities, positions within 1e-9 bohr up to a symmetry
     image), walls of the whole call, of Newton and of the host part;
     nciplot - 256^3 in f32 and f64 (f32 within the JAX package's own
     f32 bounds of f64, ndat > 0, finite cubes), and at 255x253x251 in f64
     the fast path against the generic chunked route;
  7. the gradient-path and FFT slice on the same 256^3 field (plain
     PyTorch ops on the card, except multipoles, whose solves go through
     both CUDA kernels; each part runs with the launch counts reset just
     before and read just after):
     multipoles(lmax=2) on the YT result - monopoles equal the charges to
     1e-10 e, 9 integrands a solve go through yt_gs_pass in chunks of
     8 + 1, each solve's launches fit the solver's schedule; then yt_pass
     (f64) and a yt_gs_pass sweep pair (f32) on one attractor's 9
     sign-changing integrands against their plain versions (both
     bitwise), and four of that attractor's multipoles (l = 0, 1, 2)
     against the f64 Jacobi route (1e-8);
     FFT grids - lap, grad, pot, hxx1 against the CPU (1e-10 relative),
     hxx1+hxx2+hxx3 against lap, time per operator;
     trispline / tristar - coefficient build times, 131,072 scattered
     points (value + gradient + Hessian) against the CPU (1e-12), node
     exactness, autocp with its defaults on both spline fields with
     Poincare-Hopf sum 0 and |grad| < 1e-10, the trispline CP list
     against the CPU's;
     intgrid(method="bader"), neargrid and ongrid - partition of unity,
     4 atomic basins, charges within 2 % of YT's, labels equal to the
     CPU's at 64^3, walls and peak device memory;
     bisect_basin (level-1 rays, Na basin) and sphere_integral against
     the CPU; fluxprint from 8 seeds, every path ending on a nucleus;
     makegraph on the tricubic CP list - every bond path ends at two
     nuclei, Na-Cl connected, attempts, the tracer's wall and kernel
     launches per attempt;
  8. qtree (plain PyTorch ops; runs before phase 7's gradient-path parts,
     whose launch counting switches the profiler on): maxl=4,
     sphfactor=0.9 on the same 256^3 field, |sum pops - sum YT| <=
     1e-3 sum YT + 0.3 e, wall split into traces, cubature, boundary and
     sphere integrals; the exact-half two-Gaussian crystal at 48^3, maxl=5,
     max |pop - half| < 2e-5 e; maxl=2 on a 48^3 two-Gaussian field, card
     against CPU (same ntraced, pops to 1e-9 e);
  9. the molecular-wavefunction path on H2/STO-3G (molden text below) and
     its 8x8x6 tile (768 atoms, 2,304 primitives, 384 MOs): NELEC of the
     monomer on the ultra mesh; screened against dense GTO evaluation at
     65,536 points in the cell (rho 1e-12 relative, derivatives 1e-10),
     card against CPU on 4,096 points (1e-12), f32 against f64; NELEC of
     the assembly on the 7.0M-point normal mesh (KNN weights), build and
     sweep timed apart; autocp through the screened Newton (PH 1, 768
     maxima at the nuclei, a bond CP within 0.01 bohr of every molecule's
     midpoint, |grad| < 1e-10) and on a 2x2x2 tile against the CPU
     (1e-9 bohr); makegraph through trace_paths_screened (every
     intramolecular bond path ends at its molecule's nuclei); the
     screened tracer against the dense one on 64 seeds (status, termid,
     end points to 1e-8); last, launches per BS23 attempt of both new
     tracers;
 10. the README quick start at 256^3 (runs after phase 6, before phase 8):
     the NaCl analogue written as a POSCAR with io/writers.write_poscar and
     the slice phase's field as a CHGCAR (grid x volume, '%18.11E', five a
     line, formatted vectorised, about 300 MB, in a temporary directory);
     System.from_structure (the same cell to 1e-10 bohr, the same
     positions, species and species_of in the writer's species order),
     load_field (a contiguous cuda tensor within 1e-10 relative of the
     in-memory field), autocp (counts (4, 12, 10, 2), Poincare-Hopf 0, the
     grid phase's CPs within 1e-8 bohr up to a symmetry image), makegraph
     (every bond path ends at two nuclei), intgrid(method="yt") (yt_pass 1
     and yt_gs_pass 16 launches counted in this call, partition of unity
     1e-8 e, each basin's charge within 1e-8 e of the slice phase's), and
     a bincube round trip of the in-memory field, bitwise; the wall of
     each step beside the card's name and power limit;
 11. the expression slice (runs after phase 9, before phase 7's
     gradient-path parts). Grid leg, on the slice phase's 256^3 field:
     load_field_expr("$1:l") at 256^3 (4,096 nodes against the CPU at the
     card's coordinates, 1e-12 relative); a ghost 2*$1 at 131,072 points
     off the node planes (value 1e-12, autograd gradient against central
     differences within the 5e-6 relative bar); intgrid(method="yt")
     with discard="$1 < 1e-3" and INTEGRABLE "$1" and "gtf(1)" (charges
     within 1e-8 e of the slice phase's, the $1 integrable within 1e-8 e
     of the charge, yt_pass and yt_gs_pass launches counted in the call);
     Hirshfeld (populations sum to the grid integral within 1e-8, Na
     alike and Cl alike within 1e-9); xdm_grid card against CPU at 64^3
     (C6, C8, C10, energy 1e-10 relative) and timed at 256^3; the NaCl
     Madelung constant (1e-8); CUBE of "$1 * 2" at 256^3 written (2x the
     grid at the nodes, 1e-12); STM on a 24x24x20 bohr carbon slab at
     96x96x80 (current image card against CPU, 1e-12); POWDER, RDF (card
     against CPU 1e-12) and COMPARE on NaCl. Wavefunction leg: RHF on H2
     (card against CPU 1e-10 Ha) and on its 2x2x2 tile (1e-9 Ha) and
     4x4x2 tile (192 primitives, npair 18,528: E_total and its parts,
     wall, peak memory); PBE xc and ELF integrals on the ultra monomer
     mesh against the CPU (1e-10 relative; ELF weighted by the density,
     since the bare ELF of the far tail is a ratio of cancelling
     1e-30-scale terms and is only printed); PBE xc on phase 9's 7.0M-point
     assembly mesh through the compiler (dense GTO) against the
     screened evaluator with xc_eval called directly (1e-10); mep,
     uslater and xhole on 4,096 monomer points and mep on the tile
     (card against CPU 1e-10); xdm_wfn on the monomer (1e-10);
 12. the remaining field formats (runs after phase 11, before phase 7's
     gradient-path parts), every input written by this script's own
     writers from a seed. pwc: a 2-atom cubic cell, nk 4x4x4, 72^3,
     nbnd 4, plane waves cut to |G| <= 3 (reciprocal-basis units, so the
     density has about a hundred maxima, printed as nattr) and a
     wannier90 chk with random unitary U per k, centres and spreads;
     intgrid YT, then deloc_wannier with useu and wancut 4 and without
     U (populations sum to 8 e within 1e-6 and equal the YT basin
     populations within 5e-6 e; LI <= N), the yt_pass and yt_gs_pass launches of each call per
     attractor, the walls of the read, the basin supports, the Wannier
     stack, Sij and Fa, and peak memory; CUBE UNK and PSINK written and
     MLWF in memory, card against a CPU twin (1e-12 relative); the
     same at nk 2x2x2 / 32^3, Sij and Fa card against the port on the CPU
     (1e-10). Evaluators at 1,048,576 points, nder=2 (ms per 65,536
     points), card against CPU on 4,096 of them (value 1e-12 relative,
     derivatives 1e-10): the WIEN2k cosine field of tests/test_wien.py
     (rho = 2 + cos(qz) within 1e-8 in the interstitial and 1e-6 in the
     sphere, Field hf[2,2] = -q^2 cos(qz) within 1e-8), a wide WIEN2k
     pair (2 atoms, JRI 781, LM terms to l = 8, 3,000 complex plane
     waves) and an elk pair (lmaxvr 7, nrmt 300, ngvec 3,000), each
     Hessian against central differences of the card's gradient (1e-6
     relative, points off the spheres and radial nodes); aiPI (the ions
     of tests/test_pi.py in the rocksalt primitive cell) with autocp
     card against CPU (Poincare-Hopf 0, the same CP list within 1e-8
     bohr); DFTB+ with the test_dftb.py basis on a 64-atom cell, Gamma
     real and two complex k-points, at 131,072 points (card against CPU
     on 512), gkin and elf of expressions card against CPU (1e-10);
 13. the sharded path and the keyword REPL (runs after phase 12, before
     phase 7's gradient-path parts), on a virtual mesh of 8 shards on the
     card (make_mesh(8, device=...): space 4 x points 2, every halo and
     FFT transpose moved between tensors of the one card). Parallel leg:
     intgrid(method="yt", mesh=) at 256^3 on the slice phase's system
     (both kernels' launches counted in the call, yt_gs_pass at least 2
     per shard per outer iteration; each basin's charge within 1e-8 e of
     the slice phase's, partition of unity 1e-8 e, the same nattr; solver
     stats, wall, peak memory); its labels equal to one device's except
     where two basin weights tie within 1e-12; one f64 sweep pair on the
     first shard's padded slab against the plain version, from f and from
     the solution (bitwise, the solution a fixpoint with flags 0, the halo
     planes unchanged); method="jacobi" against "gs" at 64^3 (1e-10 e,
     yt_pass's launches counted); sharded_eval_fn at 1,048,576 points
     against interp_soa (f 1e-12, gradient 1e-11, Hessian 1e-10, each
     relative to the quantity's largest magnitude; wsum 1e-12);
     ShardedGridOps at 256^3 f64 against ops/fft on the card (1e-10
     relative; lap, grad components, gradrho, hxx1-3, pot, each timed
     beside one device) and nci_grids against the single-device FFT
     Hessian where |lambda_2| > 1e-8; basin_reduce_sharded with the
     sharded YT weights against index_add_ on one device (1e-10). CLI
     leg: a .cri script (CRYSTAL the quick-start POSCAR, LOAD the 256^3
     field as a bincube, AUTO, CPREPORT, YT, INTEGRABLE 1, YT, SUM 1)
     through Repl(device=...) in-process (no warning, AUTO (4, 12, 10, 2),
     charges at the printed precision of the slice phase's, both kernels
     launched by the YT lines) and through `python3 -m
     critic2_tpu_torch.cli` with CRITIC2_RUNLOG set (exit 0, no warning,
     the same numbers, one run-log line with wall_s per keyword);
 14. the sequential C++ reference (runs after phase 13, before phase 7's
     gradient-path parts; critic2_tpu_torch/native.py, built with g++
     from native/critic2_native.cpp beside the CUDA kernels), on the
     card's results of the earlier phases and the same inputs on the
     host: the slice phase's 256^3 charges against native.yt_charges
     (same nattr, basins matched by the native label at each card
     attractor, each within 1e-6 e) and one device's labels (equal
     except where two basin weights tie within 1e-12; no YT solve is
     run again); the grid phase's heavy CP list against
     native.auto_drain from the same 39,312 WS seeds of depth 2 (each
     native CP an image of a card CP of its signature within 1e-6 bohr,
     every card CP reached) and each card CP re-converged by a damped
     host Newton on
     native.tricubic_batch (shift 1e-6 bohr); interp_soa f64 at phase
     6's 131,072 points against native.tricubic_batch (1e-10 of each
     quantity's largest); nciplot f64 at 256^3 against native.nci_sweep
     (the .dat count equal up to the card's points within 1e-12 of a
     cutoff); trace_paths colours of every seed the qtree phase traced
     (47,214) against native.trace_colors (every difference printed; at
     most 0.1 % off a separatrix, where a 1e-8 bohr shift of the seed
     changes the colour on either side; every seed is shifted so, and the
     share of all seeds on a separatrix is printed);
     rho_eval_screened on 16,384 points of the 8x8x6 tile against
     native.wfn_eval_seq (1e-10); autocp on the 4x4x2 tile against
     native.wfn_auto_drain from the same pair seeds (the CPs off the
     nuclei with their signatures, 1e-6 bohr); each leg's card wall
     beside the reference's host wall, the host CPU and its OpenMP
     threads;
 15. the near-grid walk kernel bader_walk at the benchmark's hematite
     cell (runs after phase 5; benchmark/configs/hematite-r3c.json, its
     density of seed HEMATITE_SEED, 162 x 162 x 432, f64):
     intgrid(method="bader") once warm and once with the launch counts
     reset just before, exactly one bader_walk launch and no walker
     stopped at the cap, 30 attractors on the 12 Fe and 18 O, the sums of
     the charges (204 e) and of the volumes (the cell's) to 1e-9
     relative; the kernel's roots bitwise neargrid_walk_plain's on the
     same tensor; the kernel's time (CUDA events) beside the plain walk's
     and the bytes bound N (8 + 8) B at the HBM rate;
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
ANTHRACENE_SEED = 1234567891   # the benchmark density of the axis leg
N_KERNEL = 48                  # grid of the kernel-against-plain phase
# NCI box for fast path against generic route: every axis odd, so no
# output plane but index 0 lies on a node plane of the 256 grid (254 would
# share the plane at 1/2)
NSTEP_ODD = (255, 253, 251)
HEMATITE_SEED = 2500000107     # the benchmark density of the walk leg
REPLACES = {"yt_pass": "critic2_tpu/ops/yt_pass.py:126",
            "yt_gs_pass": "critic2_tpu/ops/yt_pass.py:292",
            # no TPU kernel: the JAX package's batched XLA steps
            "bader_walk": "critic2_tpu/analysis/bader.py::_neargrid_roots"}
SOURCE = {"yt_pass": "critic2_tpu_torch/csrc/yt_pass.cu",
          "yt_gs_pass": "critic2_tpu_torch/csrc/yt_gs_pass.cu",
          "bader_walk": "critic2_tpu_torch/csrc/bader_walk.cu"}


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


def flux_csr(chiP, offs, adjoint=True):
    """The flux operator R of yt_pass's out = f + R s as an (N, N) sparse
    CSR tensor on chiP's device: row x holds the columns x + d_k, wrapped
    periodically, with the values chiP[k, x]; int32 indices, the columns
    sorted within each row. torch.sparse.addmm(f, R, s) on (N, P)
    operands then computes yt_pass's function (in another term order).
    The yardstick of yt_pass's time; the port never calls it."""
    import warnings

    import torch

    from critic2_tpu_torch.ops import yt_pass as ops

    K, n1, n2, n3 = chiP.shape
    N = n1 * n2 * n3
    ax = [torch.arange(n, device=chiP.device) for n in (n1, n2, n3)]
    col = torch.stack([
        (((ax[0] + d[0]) % n1)[:, None, None] * n2
         + ((ax[1] + d[1]) % n2)[None, :, None]) * n3
        + ((ax[2] + d[2]) % n3)[None, None, :]
        for d in ops._disp(offs, adjoint)], -1).reshape(N, K)
    col, perm = col.sort(1)
    val = chiP.reshape(K, N).T.gather(1, perm)
    crow = torch.arange(0, N * K + 1, K, dtype=torch.int32,
                        device=chiP.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(
            crow, col.to(torch.int32).reshape(-1), val.reshape(-1),
            size=(N, N), check_invariants=False)


def gs_fixpoint(gs, op, f3, offs, adjoint, tag, axis=0):
    """Gauss-Seidel sweep pairs along `axis` from f to a pair with both
    flags 0; returns (fixpoint, flags, the first sweep's schedule
    counters)."""
    from critic2_tpu_torch.ops import yt_pass as ops

    s, flags, first = f3, [], None
    for _ in range(sum(f3.shape[1:]) + 16):
        s, c1 = gs(op, s, f3, offs=offs, adjoint=adjoint, backward=False,
                   axis=axis)
        if first is None:
            first = ops.gs_counts()
        s, c2 = gs(op, s, f3, offs=offs, adjoint=adjoint, backward=True,
                   axis=axis)
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
                "triclinic": ([8.0, 7.0, 6.5], [75, 80, 70]),
                # anthracene's cell (X23, P2_1/a) with a cut to 8 of its
                # 384 planes: the grid lattice of its 384 x 270 x 504
                # grid, K = 8, 4 of them in-plane
                "monoclinic": ([15.901 * 8 / 384, 11.320, 20.967],
                               [90, 125.293, 90]),
                # the same grid lattice with b cut to 8 of its 270 planes:
                # along axis 1 the full grid's 384 x 504 planes
                "monoclinic-b": ([15.901, 11.320 * 8 / 270, 20.967],
                                 [90, 125.293, 90])}
    f32, f64 = torch.float32, torch.float64
    # (lattice, shape, P, dtypes, directions, density noise, sites)
    cases = [(lat, (n,) * 3, 2, (f32, f64), (True, False), 1e-3, 2)
             for lat in ("cubic", "triclinic")]
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
        # tiles of 2 points a thread, held in registers, ninp 4 and 6
        ("cubic", (8, 264, 264), 2, (f32,), (True,), 1e-3, 2),
        ("triclinic", (8, 264, 264), 2, (f32,), (True,), 1e-3, 2),
        # anthracene's plane: 45 x 23 tiles, 3 points a thread
        ("monoclinic", (8, 270, 504), 2, (f32, f64), (True, False), 1e-3,
         2)]
    # (lattice, shape, ...) of the cases also swept along axis 1
    # (f32 only: the plain sweep of 270 planes takes seconds;
    # tests/test_torch_yt_gs_card.py holds f64 too)
    cases = [c + (0,) for c in cases] + [
        ("monoclinic", (8, 270, 504), 2, (f32,), (True, False), 1e-3, 2,
         1),
        # the plan of anthracene's solve: 35 x 42 tiles, 3 points a thread
        ("monoclinic-b", (384, 8, 504), 2, (f32,), (True, False), 1e-3, 2,
         1),
        # planes of 50 x 37, as the cubic case's along axis 0
        ("triclinic", (50, 40, 37), 2, (f32,), (True, False), 1e-3, 2, 1)]
    for lname, shape, P, dtypes, dirs, noise, nsite, axis in cases:
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
            for adjoint in dirs:
                op = yt._shifted(chi, offs, dt) if adjoint else chi.to(dt)
                f3 = fs.to(dt)
                s = s_rand.to(dt)
                tag = (f"{lname} {'x'.join(map(str, shape))} K={len(offs)} "
                       f"P={P} {str(dt)[6:]} "
                       f"{'adjoint' if adjoint else 'forward'}"
                       f"{' smooth' if noise == 0 else ''}"
                       f"{' axis 1' if axis else ''}")
                out_k = ops.yt_pass(op, s, f3, offs=offs, adjoint=adjoint)
                out_p = ops.yt_pass_plain(op, s, f3, offs=offs,
                                          adjoint=adjoint)
                e = rel_err(out_k, out_p)
                check(torch.equal(out_k, out_p),
                      f"yt_pass {tag}: differs from its plain version, rel "
                      f"err {e:.3e}")

                sk, fk, ck = gs_fixpoint(ops.yt_gs_pass, op, f3, offs,
                                         adjoint, tag, axis)
                sp, fp, cp = gs_fixpoint(ops.yt_gs_pass_plain, op, f3, offs,
                                         adjoint, tag, axis)
                check(fk == fp, f"yt_gs_pass {tag}: flags {fk} vs {fp}")
                check(torch.equal(sk, sp), f"yt_gs_pass {tag}: fixpoints "
                      f"differ, rel err {rel_err(sk, sp):.3e}")
                log(f"kernel check {tag}: yt_pass bitwise equal (rel err "
                    f"{e:.3e}); "
                    f"yt_gs_pass fixpoint bitwise equal after {len(fk)} "
                    f"pairs, tile {ck['tile'][0]}x{ck['tile'][1]} x "
                    f"{ck['tiles']}, {ck['pc']} integrands a launch, "
                    f"{ck['ppt']} points a thread in registers, "
                    f"first sweep grid barriers {ck['grid_barriers']} "
                    f"(global-Jacobi schedule {cp['old_grid_barriers']}), "
                    f"block 0's local iterations "
                    f"{ck['local_iters_block0']}")
                ty, tz = ck["tile"]
                plane = (shape[0], shape[2]) if axis else shape[1:]
                if plane == (50, 37):
                    check(plane[0] % ty and plane[1] % tz,
                          f"{tag}: tile {ty}x{tz} divides the plane")
                if plane in ((264, 264), (270, 504), (384, 504)):
                    # float64 keeps such tiles in shared memory
                    want = 0 if dt == f64 else 2 if plane[0] == 264 else 3
                    check(ck["res"] == (want > 0) and ck["ppt"] == want,
                          f"{tag}: tile {ty}x{tz}, {ck['ppt']} points a "
                          f"thread in registers, not {want}")
                if plane == (384, 504):
                    check((ty, tz, ck["tiles"]) == (35, 42, 132),
                          f"{tag}: {ck['tiles']} tiles of {ty}x{tz}, not "
                          f"anthracene's 132 of 35x42")
                check((ck["pc"] < P) == (P > ops.GS_MAXP),
                      f"{tag}: {ck['pc']} integrands a launch")
                check(ck["axis"] == axis, f"{tag}: swept along axis "
                      f"{ck['axis']}")
    anthracene_axis_leg(dev)
    log(json.dumps({"kernels_checked": ["yt_pass", "yt_gs_pass"]}))


def anthracene_axis_leg(dev):
    """Phase 3's last leg: yt_gs_pass on anthracene's full grid along axis
    0 and along axis 1, as the adjoint solve of the benchmark's
    anthracene-x23.yt runs it (f32, P = 2, K = 8)."""
    import numpy as np
    import torch

    from benchmark.lib import density
    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.convert import crystal_from_arrays
    from critic2_tpu_torch.ops import yt_pass as ops

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "benchmark", "configs",
                           "anthracene-x23.json")) as fh:
        cfg = json.load(fh)
    st = cfg["structure"]
    rho = density.make_pool(cfg, ANTHRACENE_SEED, 1, dev)[0]
    c = crystal_from_arrays(np.asarray(st["lattice_bohr"]), st["x_frac"],
                            st["species_of"],
                            [(s["name"], s["z"]) for s in st["species"]])
    res = yt.yt_integrate(c, rho)
    offs = res._offs
    axis = yt._sweep_axis(offs)
    check(len(offs) == 8 and axis == 1,
          f"anthracene: K = {len(offs)}, sweep axis {axis}, not 8, 1")
    chi32, chi64 = res._chis(adjoint=True)
    f3 = torch.stack([torch.ones_like(rho), rho])
    f32 = f3.to(torch.float32)
    i1, i2, i3 = res._index(res.iattr)
    tag = f"anthracene {'x'.join(map(str, res.shape))} K=8 P=2"
    out = {}
    for axis in (0, 1):
        rows = []
        s = f32
        for j in range(2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            s, _ = ops.yt_gs_pass(chi32, s, f32, offs=offs,
                                  backward=j == 1, axis=axis)
            b.record()
            b.synchronize()
            ck = ops.gs_counts()
            rows.append(dict(ms=a.elapsed_time(b),
                             grid_barriers=ck["grid_barriers"],
                             local_iters_block0=ck["local_iters_block0"],
                             tile=list(ck["tile"]), tiles=ck["tiles"],
                             ppt=ck["ppt"]))
            log(f"{tag} axis {axis}, first pair sweep {j + 1}: "
                f"{rows[-1]['ms']:.4f} ms, grid barriers "
                f"{ck['grid_barriers']}, block 0's local iterations "
                f"{ck['local_iters_block0']}, tile {ck['tile'][0]}x"
                f"{ck['tile'][1]} x {ck['tiles']}, {ck['ppt']} points a "
                f"thread in registers")
        # pairs from f to a zero flag
        s, npair = f32, 0
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        while True:
            s, flag = yt._gs_pairs(chi32, s, f32, offs, True, 1, axis)
            npair += 1
            if int(flag) == 0:
                break
            check(npair < sum(res.shape), f"{tag} axis {axis}: no fixpoint")
        t1.record()
        t1.synchronize()
        # the refined solve as intgrid runs it
        ops.reset_launches()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        sol = yt._solve_sweep(res._chiP, chi32, chi64, f3, offs, axis=axis)
        at = sol[:, i1, i2, i3]
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        out[axis] = dict(first_pair=rows, pairs_to_zero_flag=npair,
                         pairs_ms=t0.elapsed_time(t1),
                         solve_ms=wall * 1e3,
                         solve_launches=ops.launches["yt_gs_pass"],
                         attractors=at)
        log(f"{tag} axis {axis}: {npair} pairs from f to a zero flag "
            f"({out[axis]['pairs_ms']:.1f} ms); refined solve "
            f"{out[axis]['solve_ms']:.1f} ms, "
            f"{out[axis]['solve_launches']} yt_gs_pass launches")
        if axis == 1:
            out[axis]["stepped_sweeps"] = timed_solve_sweeps(
                res, chi32, chi64, f3, offs, axis, sol, tag)
        del s, sol
    gap = rel_err(out[1].pop("attractors"), out[0].pop("attractors"))
    check(gap < 1e-12, f"{tag}: the two axes' solves differ at the "
          f"attractors, rel err {gap:.3e}")
    check(out[1]["pairs_to_zero_flag"] < out[0]["pairs_to_zero_flag"],
          f"{tag}: axis 1 takes no fewer pairs than axis 0")
    log(json.dumps({"anthracene_axis": {"nattr": res.nattr,
                                        "attractor_rel_gap": gap,
                                        **{f"axis{a}": v
                                           for a, v in out.items()}}}))
    del res, chi32, chi64, f3, f32, rho
    torch.cuda.empty_cache()


def timed_solve_sweeps(res, chi32, chi64, f3, offs, axis, sol, tag):
    """The refined solve of anthracene_axis_leg again, each yt_gs_pass
    sweep between CUDA events and its counters read after it (a sync a
    sweep, so only the sweeps' own times count): the cost of each solve's
    cold first pair against its later sweeps. Returns the sweeps' rows."""
    import torch

    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.ops import yt_pass as ops

    rows = []
    gs_pass = yt.yt_gs_pass

    def timed(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = gs_pass(*a, **kw)
        ev[1].record()
        ev[1].synchronize()
        rows.append(dict(ms=ev[0].elapsed_time(ev[1]),
                         rhs="residual" if ops.launches["yt_pass"] else "f",
                         grid_barriers=ops.gs_counts()["grid_barriers"]))
        return got

    ops.reset_launches()
    yt.yt_gs_pass = timed
    try:
        again = yt._solve_sweep(res._chiP, chi32, chi64, f3, offs, axis=axis)
    finally:
        yt.yt_gs_pass = gs_pass
    check(torch.equal(again, sol), f"{tag}: the timed sweeps' solve differs "
          f"from the untimed one")
    for j, r in enumerate(rows):
        log(f"{tag} axis {axis} solve sweep {j + 1:2d} ({r['rhs']}): "
            f"{r['ms']:.4f} ms, grid barriers {r['grid_barriers']}")
    for rhs in ("f", "residual"):
        ms = [r["ms"] for r in rows if r["rhs"] == rhs]
        log(f"{tag} axis {axis} solve on {rhs}: {len(ms)} sweeps "
            f"{sum(ms):.1f} ms, first pair {ms[0]:.2f} / {ms[1]:.2f} ms, "
            f"the later sweeps {sum(ms[2:]) / max(len(ms) - 2, 1):.2f} ms "
            "on average")
    return rows


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
            "launches": launches, "res": res, "f3": f3, "dv": dv,
            "intres": r, "q_basins": q_raw, "iattr": np.asarray(res.iattr)}


def time_yt_pass(op, offs, R, fp, dt, plain=False):
    """yt_pass on the integrands fp (s = fp / 2) in dtype dt: bitwise
    against its plain version, its time beside the bytes bound and one
    torch.sparse.addmm(f, R, s) on the same operator in CSR form (R from
    flux_csr; operands laid out (N, P) before the timing); with `plain`,
    the plain version's time too. Returns the record."""
    import torch

    from critic2_tpu_torch.ops import yt_pass as ops

    P, N, K = fp.shape[0], fp[0].numel(), len(offs)
    ff, ss = fp.to(dt), (fp * 0.5).to(dt)
    k = ops.yt_pass(op, ss, ff, offs=offs)
    p = ops.yt_pass_plain(op, ss, ff, offs=offs)
    err = rel_err(k, p)
    tag = f"yt_pass {str(dt)[6:]} P={P} K={K} N={N}"
    check(torch.equal(k, p), f"{tag}: differs from its plain version, rel "
          f"err {err:.3e}")
    r = dict(max_abs_err=float((k - p).abs().max()))
    del p
    fN = ff.reshape(P, N).T.contiguous()
    sN = ss.reshape(P, N).T.contiguous()
    r["library_rel_err"] = rel_err(torch.sparse.addmm(fN, R, sN).T,
                                   k.reshape(P, N))
    check(r["library_rel_err"] <= (1e-13 if dt == torch.float64 else 1e-6),
          f"{tag}: torch.sparse.addmm differs, rel err "
          f"{r['library_rel_err']:.3e}")
    del k
    r["ms"] = cuda_ms(lambda: ops.yt_pass(op, ss, ff, offs=offs), 20)
    r["library_ms"] = cuda_ms(lambda: torch.sparse.addmm(fN, R, sN), 20)
    r["bound_ms"] = (K + 3 * P) * N * dt.itemsize / HBM_BYTES_PER_S * 1e3
    if plain:
        r["plain_ms"] = cuda_ms(
            lambda: ops.yt_pass_plain(op, ss, ff, offs=offs), 5)
    log(f"{tag}: bitwise equal to its plain version (rel err {err:.3e}); "
        f"kernel {r['ms']:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f} % of "
        f"the {r['bound_ms']:.4f} ms bytes bound), torch.sparse.addmm "
        f"{r['library_ms']:.4f} ms (rel err {r['library_rel_err']:.3e})"
        + (f", plain {r['plain_ms']:.4f} ms" if plain else ""))
    return r


def main_shape_phase(sl):
    """Each kernel against its plain version at the slice's shapes, and
    its time there beside the plain version's and the bytes bound."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
    from critic2_tpu_torch.crystal.crystal import Crystal, Species
    from critic2_tpu_torch.ops import yt_pass as ops

    res, f3 = sl["res"], sl["f3"]
    offs = res._offs
    chi32, chi64 = res._chis(adjoint=True)
    P = f3.shape[0]
    N = f3[0].numel()
    K = len(offs)
    out = {}

    # yt_pass as the slice calls it (f64 residual, shifted f64 chi), at
    # P = 2, at P = 1 and at multipoles' chunk of P = 8, in f64 and f32;
    # then at K = 14 on a triclinic lattice's flux at the same grid
    stacks = {2: f3, 1: f3[1:], 8: torch.cat([f3 * (1 + q) for q in
                                               range(4)])}
    rec = {}
    for dt in (torch.float64, torch.float32):
        op = chi64.to(dt)
        R = flux_csr(op, offs)
        for P_, fp in stacks.items():
            rec[f"{str(dt)[6:]}_P{P_}"] = time_yt_pass(op, offs, R, fp, dt,
                                                        plain=P_ == 2)
        del R
    c = Crystal(m_x2c=m_x2c_from_cellpar([8.0, 7.0, 6.5], [75, 80, 70]),
                x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.7, 0.6]]),
                species_of=np.array([0, 0]), species=[Species("C", 6)])
    rho = torch.as_tensor(density(c, res.shape, np.random.default_rng(7)),
                          device=f3.device)
    offs14, wts = yt._grid_ws_neighbors(c, rho.shape)
    offs14 = tuple(tuple(int(v) for v in o) for o in offs14)
    chi14, _ = yt._flux_tensors(rho, wts, offs14)
    check(len(offs14) == 14, f"triclinic lattice: K = {len(offs14)}")
    op = yt._shifted(chi14, offs14, torch.float64)
    del chi14
    fp = torch.stack([torch.ones_like(rho), rho])
    rec["float64_P2_K14"] = time_yt_pass(op, offs14, flux_csr(op, offs14),
                                         fp, torch.float64)
    del op, fp, rho
    m2 = rec["float64_P2"]
    out["yt_pass"] = dict(
        max_abs_err=m2["max_abs_err"], ms=m2["ms"],
        plain_ms=m2["plain_ms"], bound_ms=m2["bound_ms"],
        library_ms=m2["library_ms"],
        extra={f"{key}_{name}": r[key] for name, r in rec.items()
               for key in ("ms", "bound_ms", "library_ms")})
    torch.cuda.empty_cache()

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
    # the f64 pair against its plain version, and the plain pair's time
    f64 = f3.to(torch.float64)
    got64 = []
    plain_gs64 = cuda_ms(lambda: got64.append(
        pair(ops.yt_gs_pass_plain, chi64, f64)), 1, warm=0) / 2
    bk64, k164, k264 = pair(ops.yt_gs_pass, chi64, f64)
    bp64, p164, p264 = got64[0]
    check((int(k164), int(k264)) == (int(p164), int(p264))
          and torch.equal(bk64, bp64),
          "yt_gs_pass f64 first pair differs from its plain version")
    log(f"yt_gs_pass plain float64: {plain_gs64:.4f} ms per sweep; the "
        f"kernel's f64 first pair bitwise equal to it")

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
        extra={"ms_f64": gms[torch.float64], "plain_ms_f64": plain_gs64,
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
    d64, _ = yt._f32_fixpoint(chi64, f3, offs, True, 0)
    t_d64 = cuda_ms(lambda: yt._f32_fixpoint(chi64, f3, offs, True, 0), 1,
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

    device_profile(lambda: intgrid(s, method="yt"), "intgrid")


def device_profile(fn, label, cpu=True):
    """Run fn() under torch.profiler: wall, device busy time, device idle
    share and the ten kernels with the most device time. cpu=False leaves
    the host's operator records out: for calls of 10^5 launches and more,
    whose host records take minutes to process."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel and memcpy records only: an operator's own record repeats
    # the device time of the kernels it launched
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    wall_ms = wall * 1e3
    log(f"profiled {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms in {sum(e.count for e in ev)} kernels and "
        f"copies, device idle share {1 - busy_ms / wall_ms:.4f}")
    check(busy_ms <= wall_ms, f"device busy {busy_ms:.3f} ms exceeds the "
          f"wall {wall_ms:.3f} ms: device time is counted twice")
    for e in sorted(ev, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        if e.self_device_time_total > 0:
            log(f"  device {e.self_device_time_total / 1e3:10.3f} ms  "
                f"x{e.count:<5d} {e.key[:70]}")


def wall_s(fn):
    """(result, host-clock seconds) of fn(), the device drained before and
    after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def interp_phase(g):
    """Phase 6a: the three tricubic routes against each other, against
    the CPU, and their rates on the 256^3 grid g (f64, on the card)."""
    import numpy as np
    import torch

    from critic2_tpu_torch.ops import interp

    npts = 131072
    rng = np.random.default_rng(11)
    pts = torch.as_tensor(rng.random((3, npts)), device=g.device)
    soa = interp.interp_soa(g, pts)
    rows = interp.interp_soa_rows(g, pts)
    names = ("value", "gradient", "Hessian")
    for nm, a, b in zip(names, rows, soa):
        e = rel_err(a, b)
        check(e <= 1e-10, f"interp_soa_rows vs interp_soa, {nm}: {e:.3e}")
    log("interp: interp_soa_rows vs interp_soa at 131072 points, rel err "
        + ", ".join(f"{nm} {rel_err(a, b):.3e}"
                    for nm, a, b in zip(names, rows, soa)))
    del rows

    # a regular output grid that shares no node with the input
    nout, origin = (63, 62, 61), (0.0113, 0.0271, 0.0057)
    gy = interp.interp_grid_soa(g, nout, origin=origin)
    ax = [origin[a] + torch.arange(nout[a], device=g.device,
                                   dtype=torch.float64) / nout[a]
          for a in range(3)]
    xg = torch.stack(torch.meshgrid(*ax, indexing="ij")).reshape(3, -1)
    off = xg * g.shape[0]
    check(bool((off - off.round()).abs().min() > 1e-6),
          "an output node sits on an input node")
    sc = interp.interp_soa(g, xg)
    for nm, a, b in zip(names, gy, sc):
        e = rel_err(a.reshape(b.shape), b)
        check(e <= 1e-10, f"interp_grid_soa vs interp_soa, {nm}: {e:.3e}")
    log("interp: interp_grid_soa 63x62x61 vs interp_soa, rel err "
        + ", ".join(f"{nm} {rel_err(a.reshape(b.shape), b):.3e}"
                    for nm, a, b in zip(names, gy, sc)))
    y0 = interp.interp_grid_soa(g, g.shape, nder=0)[0]
    check(torch.equal(y0, g), "interp_grid_soa at nout = grid shape does "
          "not reproduce the node values exactly")
    del y0, gy, sc

    # the card against the CPU on a subsample
    sub = pts[:, :4096]
    cpu = interp.interp_soa(g.cpu(), sub.cpu())
    for nm, a, b in zip(names, interp.interp_soa(g, sub), cpu):
        e = rel_err(a.cpu(), b)
        check(e <= 1e-12, f"interp_soa card vs CPU, {nm}: {e:.3e}")
    log("interp: interp_soa on the card vs device='cpu' at 4096 points: "
        "within 1e-12 relative")

    out = {}
    for dt in (torch.float32, torch.float64):
        gd, tag = g.to(dt), str(dt)[6:]
        for name, fn in (("interp_soa", interp.interp_soa),
                         ("interp_soa_rows", interp.interp_soa_rows)):
            ms = cuda_ms(lambda: fn(gd, pts, nder=2), 5)
            out[f"{name}_{tag}_ms"] = ms
            log(f"interp: {name} {tag}, 131072 points, value + gradient + "
                f"Hessian: {ms:.4f} ms, {npts / ms / 1e3:.3f} M evals/s")
        ms = cuda_ms(lambda: interp.interp_grid_soa(gd, gd.shape, nder=2), 2)
        out[f"interp_grid_soa_{tag}_ms"] = ms
        log(f"interp: interp_grid_soa {tag}, {N_SLICE}^3 whole-grid sweep, "
            f"value + gradient + Hessian: {ms:.4f} ms, "
            f"{g.numel() / ms / 1e3:.3f} M evals/s")
        del gd
    for tag in ("float32", "float64"):
        check(out[f"interp_soa_{tag}_ms"] < out[f"interp_soa_rows_{tag}_ms"],
              f"interp_soa_rows is the faster scattered route in {tag}: "
              "fields/field.py must take it")
    return out


def timed_autocp(s, seeds, **kw):
    """One autocp with the walls of its parts: (CP list, record). The
    seed generator and the Newton search are wrapped for this call; kw
    goes to autocp."""
    import torch

    from critic2_tpu_torch.analysis import autocp as auto

    rec = {"seed_s": 0.0, "newton_s": 0.0, "generated": 0, "seeds": 0,
           "converged": 0, "iterations": []}
    gen, newton = auto.gen_seeds, auto.newton_batch

    def gen_timed(*a, **kw):
        out, dt = wall_s(lambda: gen(*a, **kw))
        rec["seed_s"] += dt
        rec["generated"] += len(out)
        return out

    def newton_timed(fn, x0, **kw):
        (x, conv, nit), dt = wall_s(lambda: newton(fn, x0, **kw))
        rec["newton_s"] += dt
        rec["seeds"] += x0.shape[0]
        rec["converged"] += int(conv.sum())
        rec["iterations"].append(nit)
        return x, conv, nit

    auto.gen_seeds, auto.newton_batch = gen_timed, newton_timed
    try:
        cpl, rec["autocp_s"] = wall_s(lambda: auto.autocp(s, seeds=seeds,
                                                           **kw))
    finally:
        auto.gen_seeds, auto.newton_batch = gen, newton
    rec["host_s"] = rec["autocp_s"] - rec["seed_s"] - rec["newton_s"]
    rec["counts"] = list(cpl.counts())
    return cpl, rec


def check_cplist(s, cpl, tag):
    """Poincare-Hopf sum 0 and |grad| < 1e-10 at every accepted CP,
    evaluated again at the stored positions."""
    import numpy as np

    check(cpl.poincare_hopf() == 0,
          f"autocp {tag}: Poincare-Hopf sum {cpl.poincare_hopf()} "
          f"(counts {cpl.counts()})")
    found = np.array([cp.r for cp in cpl.cps if not cp.isnuc])
    check(len(found) > 0, f"autocp {tag}: no critical point found")
    gmax = float(s.ref.grd(found, nder=1).gfmod.max())
    check(gmax < 1e-10, f"autocp {tag}: |grad| {gmax:.3e} at an accepted CP")
    return gmax


def autocp_phase(s):
    """Phase 6b: AUTO on the grid field, default and heavy seeding."""
    import numpy as np

    from critic2_tpu_torch.analysis.autocp import Seed, autocp
    from critic2_tpu_torch.convert import (cplist_to_arrays,
                                           crystal_to_arrays,
                                           system_from_arrays)

    out = {}
    lists = {}
    for tag, seeds in (("default", None), ("heavy", [Seed("ws", depth=2)])):
        _, first = timed_autocp(s, seeds)       # seed cache cold, first use
        cpl, rec = timed_autocp(s, seeds)
        rec["gfmod_max"] = check_cplist(s, cpl, tag)
        rec["first_call_s"] = first["autocp_s"]
        rec["seed_first_s"] = first["seed_s"]
        out[tag] = rec
        lists[tag] = cpl
        log(f"autocp {tag}: {rec['generated']} seeds generated, "
            f"{rec['seeds']} distinct into Newton, {rec['converged']} "
            f"converged, counts (n, b, r, c) {tuple(rec['counts'])}, "
            f"Poincare-Hopf 0, max |grad| {rec['gfmod_max']:.3e}, Newton "
            f"iterations {rec['iterations']}; wall {rec['autocp_s']:.4f} s "
            f"(first call {rec['first_call_s']:.4f} s, of it seed "
            f"generation {rec['seed_first_s']:.4f} s): Newton "
            f"{rec['newton_s']:.4f} s, seeds (cached) {rec['seed_s']:.4f} s, "
            f"classification + host dedup {rec['host_s']:.4f} s")
    check(out["default"]["seeds"] == 2071
          and out["heavy"]["generated"] == 39312,
          f"seed counts {out['default']['seeds']} distinct (default), "
          f"{out['heavy']['generated']} generated (heavy)")

    # the default run again with every tensor on the CPU
    c = s.crystal
    scpu = system_from_arrays(**crystal_to_arrays(c),
                              grid=s.ref.grid.f.cpu().numpy(), device="cpu")
    t0 = time.perf_counter()
    ref = cplist_to_arrays(autocp(scpu))
    t_cpu = time.perf_counter() - t0
    got = cplist_to_arrays(lists["default"])
    for key in ("typ", "mult", "isnuc"):
        check(np.array_equal(got[key], ref[key]),
              f"autocp card vs CPU: {key} {got[key]} vs {ref[key]}")
    # which image of an orbit stands for it hangs on which seed arrives
    # first: compare each CP with the nearest symmetry image of its twin
    sg = c.spacegroup
    dmax = 0.0
    for xa, xb in zip(got["x"], ref["x"]):
        imgs = (sg.rotations @ xb + sg.translations) % 1.0
        dmax = max(dmax, float(c.distmat(xa, imgs).min()))
    check(dmax <= 1e-9, f"autocp card vs CPU: positions differ by "
          f"{dmax:.3e} bohr")
    log(f"autocp default on the card vs device='cpu' ({t_cpu:.3f} s there): "
        f"same types and multiplicities, {len(got['typ'])} CPs, positions "
        f"within {dmax:.3e} bohr")
    return out, lists


def nci_phase(s):
    """Phase 6c: NCIPLOT on the grid field at 256^3, f32 and f64, and the
    fast path against the generic route on an incommensurate box."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis.nci import nciplot

    n = N_SLICE
    out = {}
    res = {}
    for prec in ("f32", "f64"):
        _, t_first = wall_s(lambda: nciplot(s, nstep=(n, n, n),
                                            precision=prec))
        torch.cuda.reset_peak_memory_stats()
        res[prec], t = wall_s(lambda: nciplot(s, nstep=(n, n, n),
                                              precision=prec))
        r = res[prec]
        ndat = r.ndat
        check(ndat > 0, f"nciplot {prec}: empty .dat selection")
        for name in ("crho", "cgrad", "cgrad_raw"):
            check(bool(torch.isfinite(getattr(r, name)).all()),
                  f"nciplot {prec}: {name} not finite")
        out[prec] = {"wall_s": t, "first_call_s": t_first, "ndat": ndat,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"nciplot {prec} {n}^3: wall {t:.4f} s (first call "
            f"{t_first:.4f} s), ndat {ndat}, peak device memory "
            f"{out[prec]['peak_gib']:.2f} GiB")

    # f32 against f64, the bounds of the JAX package's own f32 test
    r32, r64 = res["f32"], res["f64"]
    dcr = (r32.crho.double() - r64.crho).abs()
    mag = r64.crho.abs()
    flip = dcr > 1.9 * mag - 1e-6
    fl = float(flip.double().mean())
    e_rho = float((dcr[~flip] / (mag[~flip] + 1e-3)).max())
    m = (r32.cgrad < 99.0) & (r64.cgrad < 99.0)
    e_rdg = float(((r32.cgrad.double()[m] - r64.cgrad[m]).abs()
                   / (r64.cgrad[m] + 1e-3)).max())
    log(f"nciplot f32 vs f64: sign flips {fl:.3e} of points, crho rel "
        f"{e_rho:.3e} elsewhere, RDG rel {e_rdg:.3e} under the plot cut-off")
    check(fl < 2e-3, f"nciplot f32: sign flips at {fl:.3e} of points")
    check(e_rho < 1e-4, f"nciplot f32: crho rel {e_rho:.3e}")
    check(e_rdg < 1e-3, f"nciplot f32: RDG rel {e_rdg:.3e}")
    del res, r32, r64, dcr, mag, flip, m

    # fast path against the generic chunked route, f64; usecore with an
    # empty zpsp turns the fast path off and adds no core density
    nstep = NSTEP_ODD
    fast, t_fast = wall_s(lambda: nciplot(s, nstep=nstep, precision="f64"))
    s.ref.usecore = True
    try:
        gen, t_gen = wall_s(lambda: nciplot(s, nstep=nstep, block=1 << 18))
    finally:
        s.ref.usecore = False
    sel = torch.ones(nstep, dtype=torch.bool, device=fast.crho.device)
    sel[0, 0, 0] = False                    # the node on the nucleus
    for name, rtol, atol in (("crho", 1e-9, 1e-10),
                             ("cgrad_raw", 1e-7, 1e-10)):
        a, b = getattr(fast, name)[sel], getattr(gen, name)[sel]
        bad = int(((a - b).abs() > atol + rtol * b.abs()).sum())
        check(bad == 0, f"nciplot fast vs generic: {name} differs at {bad} "
              f"points, max {float((a - b).abs().max()):.3e}")
    log(f"nciplot {'x'.join(map(str, nstep))} f64: fast path {t_fast:.4f} s, generic "
        f"chunked route {t_gen:.4f} s, crho and RDG agree (rtol 1e-9 / "
        "1e-7)")
    out["fast_255_s"], out["generic_255_s"] = t_fast, t_gen
    return out


def grid_phase(sl, profile):
    """Phase 6: the grid main path on the slice phase's 256^3 field."""
    import torch

    from critic2_tpu_torch.analysis.autocp import Seed, autocp
    from critic2_tpu_torch.analysis.nci import nciplot
    from critic2_tpu_torch.ops import yt_pass as ops

    s = sl["system"]
    check(s.ref.type == "grid" and s.ref.grid.n == (N_SLICE,) * 3
          and s.ref.grid.f.is_cuda, "the grid field is not on the card")
    ops.reset_launches()
    out = {"interp": interp_phase(s.ref.grid.f)}
    torch.cuda.empty_cache()
    out["autocp"], lists = autocp_phase(s)
    sl["cpl"], sl["cpl_heavy"] = lists["default"], lists["heavy"]
    out["nci"] = nci_phase(s)
    log(f"grid path: CUDA kernel launches {dict(ops.launches)} (no kernel "
        "of the port lies on this path)")
    if profile:
        a, nc = out["autocp"]["heavy"], out["nci"]["f32"]
        sweep = out["interp"]["interp_grid_soa_float32_ms"]
        log(f"stage autocp heavy: Newton {a['newton_s'] * 1e3:.3f} ms, "
            f"seeds (cached) {a['seed_s'] * 1e3:.3f} ms, classification + "
            f"host dedup {a['host_s'] * 1e3:.3f} ms")
        log(f"stage nciplot f32: whole-grid sweep {sweep:.3f} ms, cast + "
            f"elementwise tail {nc['wall_s'] * 1e3 - sweep:.3f} ms")
        device_profile(lambda: autocp(s, seeds=[Seed("ws", depth=2)]),
                       "autocp heavy")
        n = N_SLICE
        device_profile(lambda: nciplot(s, nstep=(n, n, n)), "nciplot f32")
    log(json.dumps({"grid_path": out}))
    return out


def multipoles_phase(sl):
    """Phase 7a: atomic multipoles on the YT result of the slice phase.
    Each attractor's solve carries (lmax+1)^2 = 9 integrands, so
    yt_gs_pass runs in chunks of 8 + 1; both kernels must be launched.
    Then, outside the counted run: both kernels against their plain
    versions on one attractor's 9 integrands (sign-changing solid
    harmonics times rho) at this shape, that attractor's multipoles
    against the f64 Jacobi route, and the number of sweep pairs each
    integrand needs to settle."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis import yt
    from critic2_tpu_torch.analysis.integration import (
        _multipole_integrands, multipoles)
    from critic2_tpu_torch.ops import yt_pass as ops

    s, r = sl["system"], sl["intres"]
    res = r.decomp
    # the launches of each solve: YTResult.integrate, counted per call
    per_solve = []
    integrate = res.integrate

    def counted(f):
        before = dict(ops.launches)
        q = integrate(f)
        per_solve.append({k: ops.launches[k] - before[k] for k in before})
        return q

    res.integrate = counted
    ops.reset_launches()
    try:
        q, t = wall_s(lambda: multipoles(s, r, lmax=2))
    finally:
        del res.integrate
    launches = dict(ops.launches)
    pc = ops.gs_counts()["pc"]
    nchunk = -(-9 // pc)
    check(q.shape == (len(r.rows), 9) and np.isfinite(q).all(),
          "multipoles: wrong shape or not finite")
    dq = float(np.abs(q[:, 0] * np.sqrt(4 * np.pi) - r.charges).max())
    check(dq <= 1e-10, f"multipoles: monopoles differ from the charges by "
          f"{dq:.3e} e")
    for k, v in launches.items():
        check(v > 0, f"the multipoles path launched no {k} kernel")
    check(pc == ops.GS_MAXP and nchunk == 2, f"multipoles: yt_gs_pass took "
          f"{pc} integrands a launch, not 8 + 1")
    # a sweep is one launch per chunk. A solve is 8 + 4i sweeps on f,
    # one yt_pass residual and 8 + 4j sweeps on it: 4 pairs each, then 2
    # a flag read until a pair changes nothing
    check(len(per_solve) == r.nattr_raw
          and sum(p["yt_gs_pass"] for p in per_solve)
          == launches["yt_gs_pass"], f"multipoles: {len(per_solve)} solves "
          f"for {r.nattr_raw} attractors")
    sweeps = []
    for p in per_solve:
        check(p["yt_gs_pass"] % nchunk == 0, f"multipoles: {p} launches in "
              f"{nchunk} chunks")
        n = p["yt_gs_pass"] // nchunk
        sweeps.append(n)
        check(n >= 16 and n % 4 == 0 and p["yt_pass"] == 1,
              f"multipoles: a solve of {n} sweeps and {p['yt_pass']} "
              "residuals is not 4 + 2i pairs, a residual, 4 + 2j pairs")
    log(f"multipoles lmax=2 on the {N_SLICE}^3 YT result: wall {t:.3f} s, "
        f"{r.nattr_raw} attractors, 9 integrands a solve in chunks of "
        f"{pc} + {9 - pc}, launches {launches}, sweeps of each solve "
        f"{sweeps} x {nchunk} chunks, |monopole/S00 - charge| max "
        f"{dq:.3e} e, largest dipole {float(np.abs(q[:, 1:4]).max()):.3e}, "
        f"largest quadrupole {float(np.abs(q[:, 4:]).max()):.3e}")
    out = {"wall_s": t, "launches": launches, "pc": pc, "dq_e": dq,
           "sweeps_per_solve": sweeps}

    # the kernels against their plain versions on the integrands of the
    # first attractor, as its solve calls them
    a = 0
    row = r.attr_map[a]
    offs = res._offs
    chi32, chi64 = res._chis(adjoint=True)
    f64 = _multipole_integrands(s.crystal, res.shape, r.rho.reshape(-1),
                                r.rows[row].xfrac, 2
                                ).reshape((9,) + res.shape)
    check(bool((f64[1:].amin((1, 2, 3)) < 0).all()
               and (f64[1:].amax((1, 2, 3)) > 0).all()),
          "the l >= 1 integrands do not change sign")
    s1 = f64 * 0.5
    k = ops.yt_pass(chi64, s1, f64, offs=offs)
    (p, ), t_plain = wall_s(lambda: (ops.yt_pass_plain(chi64, s1, f64,
                                                       offs=offs), ))
    e = rel_err(k, p)
    check(torch.equal(k, p), "yt_pass P=9 on the multipole integrands: "
          f"differs from its plain version, rel err {e:.3e}")
    out["yt_pass_p9_ms"] = cuda_ms(
        lambda: ops.yt_pass(chi64, s1, f64, offs=offs), 5)
    log(f"yt_pass float64 P=9 on the multipole integrands: bitwise equal, "
        f"rel err {e:.3e} "
        f"against the plain version ({t_plain * 1e3:.1f} ms there), kernel "
        f"{out['yt_pass_p9_ms']:.4f} ms")
    del s1, k, p
    f32 = f64.to(torch.float32)
    got = {}
    for name, gs in (("kernel", ops.yt_gs_pass),
                     ("plain", ops.yt_gs_pass_plain)):
        def pair():
            x, c1 = gs(chi32, f32, f32, offs=offs, backward=False)
            x, c2 = gs(chi32, x, f32, offs=offs, backward=True)
            return x, (int(c1), int(c2))
        got[name], out[f"gs_pair_p9_{name}_s"] = wall_s(pair)
    check(got["kernel"][1] == got["plain"][1],
          f"yt_gs_pass P=9: flags {got['kernel'][1]} vs {got['plain'][1]}")
    check(torch.equal(got["kernel"][0], got["plain"][0]),
          "yt_gs_pass P=9 first pair on the multipole integrands differs "
          f"from the plain version: {rel_err(*[g[0] for g in got.values()]):.3e}")
    log(f"yt_gs_pass float32 P=9 (chunks of {pc} + {9 - pc}) first pair on "
        f"the multipole integrands: bitwise equal to the plain version, "
        f"flags {got['kernel'][1]}; kernel "
        f"{out['gs_pair_p9_kernel_s'] * 1e3:.1f} ms, plain "
        f"{out['gs_pair_p9_plain_s']:.1f} s the pair")
    del got

    # that attractor's monopole, one dipole and two quadrupoles (S_00,
    # S_1-1, S_20, S_22) against the f64 Jacobi route
    sel = [0, 1, 6, 8]
    sx, t_xla = wall_s(lambda: yt._xla_sweep(res._chiP, f64[sel], offs))
    i1, i2, i3 = res._index(res.iattr[a:a + 1])
    q_ref = sx[:, i1, i2, i3].cpu().numpy()[:, 0] * sl["dv"]
    del sx
    scale = np.maximum(np.abs(q_ref), 1.0)
    dql = float((np.abs(q[row, sel] - q_ref) / scale).max())
    check(dql <= 1e-8, f"multipoles of {r.rows[row].name} vs the f64 Jacobi "
          f"route: {dql:.3e}")
    log(f"multipoles {sel} of {r.rows[row].name} vs the f64 Jacobi route "
        f"({t_xla:.3f} s): max difference {dql:.3e} (relative above 1, "
        "absolute below)")
    out["dq_l_vs_jacobi"] = dql

    # why a solve goes on: sweep pairs until a pair changes no bit (that
    # clean pair counted), each integrand alone: signed, as its absolute
    # value, and the residual its correction solve starts from
    s4, _ = yt._gs_pairs(chi32, f32, f32, offs, True, npair=4)
    s4 = s4.to(f64.dtype)
    r32 = (ops.yt_pass(chi64, s4, f64, offs=offs) - s4).to(torch.float32)
    del s4
    npairs = {"signed": [], "abs": [], "residual": []}
    for j in range(9):
        for tag, ff in (("signed", f32[j:j + 1]),
                        ("abs", f32[j:j + 1].abs()),
                        ("residual", r32[j:j + 1])):
            _, flags, _ = gs_fixpoint(ops.yt_gs_pass, chi32,
                                      ff.contiguous(), offs, True,
                                      f"multipole integrand {j} {tag}")
            npairs[tag].append(len(flags))
    log(f"yt_gs_pass float32 sweep pairs to a clean pair, the 9 integrands "
        f"one at a time: signed {npairs['signed']}, absolute values "
        f"{npairs['abs']}, residuals {npairs['residual']} (a solve goes "
        "on 2 pairs a flag read where one needs more than 4)")
    out["pairs_to_settle"] = npairs
    return out


def fft_phase(s):
    """Phase 7b: the FFT-derived grids of the 256^3 field, card against
    CPU, and the time of each operator."""
    import torch

    from critic2_tpu_torch.ops import fft as fftops

    g = s.ref.grid.f
    m = s.crystal.m_x2c
    gc = g.cpu()
    out = {}
    ops_ = {"lap": lambda f: fftops.laplacian(f, m),
            "grad": lambda f: fftops.gradrho(f, m),
            "pot": lambda f: fftops.pot(f, m),
            "hxx1": lambda f: fftops.hxx(f, m, 0)}
    for kind, fn in ops_.items():
        fid = s.load_field_as(kind, src=s.iref, fid=900)
        got = s.field(fid).grid.f
        check(got.is_cuda and got.dtype == torch.float64
              and got.shape == g.shape, f"load_field_as {kind}: wrong tensor")
        ref, t_cpu = wall_s(lambda: fn(gc))
        e = rel_err(got.cpu(), ref)
        check(e <= 1e-10, f"FFT grid {kind}: card vs CPU {e:.3e}")
        out[kind + "_ms"] = cuda_ms(lambda: fn(g), 3)
        log(f"fft {kind} {N_SLICE}^3 f64: {out[kind + '_ms']:.3f} ms on the "
            f"card ({t_cpu:.3f} s on the CPU), card vs CPU rel {e:.3e}")
        del ref
    s.fields.pop(900)
    lap = fftops.laplacian(g, m)
    tr = fftops.hxx(g, m, 0) + fftops.hxx(g, m, 1) + fftops.hxx(g, m, 2)
    e = rel_err(tr, lap)
    check(e <= 1e-10, f"hxx1 + hxx2 + hxx3 vs lap: {e:.3e}")
    v = fftops.pot(g, m)
    check(abs(float(v.mean())) <= 1e-10 * float(v.abs().max()),
          "pot: V(G=0) is not zero")
    log(f"fft: hxx1 + hxx2 + hxx3 vs lap rel {e:.3e}; pot has zero mean")
    return out


def spline_phase(s, tricubic_ms):
    """Phase 7c: trispline and tristar on the 256^3 field."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis.autocp import autocp
    from critic2_tpu_torch.convert import (cplist_to_arrays,
                                           crystal_to_arrays,
                                           system_from_arrays)
    from critic2_tpu_torch.ops import trispline as tri

    g = s.ref.grid.f
    npts = 131072
    rng = np.random.default_rng(13)
    pts = torch.as_tensor(rng.random((3, npts)), device=g.device)
    idx = torch.as_tensor(rng.integers(0, N_SLICE, (3, 4096)),
                          device=g.device)
    nodes = idx.to(torch.float64) / N_SLICE
    node_vals = g[idx[0], idx[1], idx[2]]
    names = ("value", "gradient", "Hessian")
    out = {}
    torch.cuda.reset_peak_memory_stats()

    coef, out["spline_coeffs_s"] = wall_s(lambda: tri.spline_coeffs(g))
    c2, out["star_c2_s"] = wall_s(lambda: tri.star_c2(g))
    coef_cpu, t_cpu = wall_s(lambda: tri.spline_coeffs(g.cpu()))
    e = rel_err(coef.cpu(), coef_cpu)
    check(e <= 1e-10, f"spline_coeffs card vs CPU: {e:.3e}")
    log(f"trispline: spline_coeffs {out['spline_coeffs_s']:.3f} s "
        f"({coef.numel() * 8 / 2**30:.2f} GiB; {t_cpu:.3f} s on the CPU, "
        f"rel {e:.3e}), star_c2 {out['star_c2_s']:.3f} s "
        f"({c2.numel() * 8 / 2**30:.2f} GiB)")
    c2_cpu = c2.cpu()
    gc = g.cpu()
    evals = {"trispline": (lambda x, nder=2: tri.trispline_soa(coef, x, nder),
                           lambda x: tri.trispline_soa(coef_cpu, x)),
             "tristar": (lambda x, nder=2: tri.trispline_star_soa(g, c2, x,
                                                                  nder),
                         lambda x: tri.trispline_star_soa(gc, c2_cpu, x))}
    for mode, (fn, fn_cpu) in evals.items():
        y0 = fn(nodes, 0)[0]
        e0 = float((y0 - node_vals).abs().max()) / float(node_vals.abs().max())
        check(e0 <= 1e-12, f"{mode}: node values off by {e0:.3e}")
        sub = pts[:, :4096]
        errs = [rel_err(a.cpu(), b) for a, b in zip(fn(sub), fn_cpu(sub.cpu()))]
        for nm, e in zip(names, errs):
            check(e <= 1e-12, f"{mode} card vs CPU, {nm}: {e:.3e}")
        ms = cuda_ms(lambda: fn(pts), 5)
        out[f"{mode}_ms"] = ms
        log(f"{mode}: 131072 points, value + gradient + Hessian: {ms:.4f} ms, "
            f"{npts / ms / 1e3:.3f} M evals/s (tricubic interp_soa f64 "
            f"{tricubic_ms:.4f} ms); nodes exact to {e0:.3e}; card vs CPU at "
            "4096 points rel " + ", ".join(f"{nm} {e:.3e}"
                                          for nm, e in zip(names, errs)))
    del coef, c2, coef_cpu, c2_cpu

    # AUTO with its defaults on both spline fields, and the trispline run
    # against the same call with every tensor on the CPU
    c = s.crystal
    for mode in ("trispline", "tristar"):
        s.ref.set_options(interp=mode)
        # one call each (the coefficient build is inside it): on tristar
        # some lanes run all 200 Newton iterations
        cpl, rec = timed_autocp(s, None)
        rec["gfmod_max"] = check_cplist(s, cpl, mode)
        out[f"autocp_{mode}"] = rec
        log(f"autocp (defaults) on the {mode} field: counts (n, b, r, c) "
            f"{tuple(rec['counts'])}, Poincare-Hopf 0, max |grad| "
            f"{rec['gfmod_max']:.3e}, {rec['converged']} of {rec['seeds']} "
            f"seeds converged, wall {rec['autocp_s']:.4f} s (coefficient "
            f"build included), Newton {rec['newton_s']:.4f} s, iterations "
            f"{rec['iterations']}")
        if mode == "trispline":
            scpu = system_from_arrays(**crystal_to_arrays(c), grid=gc.numpy(),
                                      device="cpu", interp=mode)
            ref, t_cpu = wall_s(lambda: cplist_to_arrays(autocp(scpu)))
            got = cplist_to_arrays(cpl)
            for key in ("typ", "mult", "isnuc"):
                check(np.array_equal(got[key], ref[key]), f"autocp {mode} "
                      f"card vs CPU: {key} {got[key]} vs {ref[key]}")
            sg = c.spacegroup
            dmax = 0.0
            for xa, xb in zip(got["x"], ref["x"]):
                imgs = (sg.rotations @ xb + sg.translations) % 1.0
                dmax = max(dmax, float(c.distmat(xa, imgs).min()))
            check(dmax <= 1e-9, f"autocp {mode} card vs CPU: positions "
                  f"differ by {dmax:.3e} bohr")
            log(f"autocp on the {mode} field, card vs device='cpu' "
                f"({t_cpu:.3f} s there, coefficient build included): same "
                f"types and multiplicities, {len(got['typ'])} CPs, positions "
                f"within {dmax:.3e} bohr")
            del scpu
    s.ref.set_options(interp="tricubic")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory of the spline phase {out['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    return out


def kernels_launched(fn) -> int:
    """Device kernels and copies that fn() launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def counting_attempts():
    """(counter dict, restore()) with ode._attempt wrapped to count BS23
    attempts and lane-attempts until restore() is called."""
    from critic2_tpu_torch.ops import ode

    cnt = {"attempts": 0, "lane_attempts": 0}
    attempt = ode._attempt

    def counted(su, st):
        cnt["attempts"] += 1
        cnt["lane_attempts"] += st[0].shape[1]
        return attempt(su, st)

    ode._attempt = counted

    def restore():
        ode._attempt = attempt

    return cnt, restore


def launches_per_attempt(trace):
    """(kernel launches of one BS23 attempt, launches, attempts):
    trace(mstep) for 16 and for 48 attempts under the profiler, the
    difference over the attempts between (set-up and the final scatter
    cancel)."""
    nk, na = [], []
    cnt, restore = counting_attempts()
    try:
        for mstep in (16, 48):
            cnt["attempts"] = 0
            nk.append(kernels_launched(lambda: trace(mstep)))
            na.append(cnt["attempts"])
    finally:
        restore()
    check(na[0] == 16 and na[1] > 16, f"the profiled traces took {na} "
          "attempts")
    return (nk[1] - nk[0]) / (na[1] - na[0]), nk, na


def graph_phase(s, cpl):
    """Phase 7f: makegraph on the tricubic CP list of the grid phase."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis.autocp import makegraph
    from critic2_tpu_torch.ops import ode

    # the stepper's BS23 attempt and the tracer, wrapped for this call:
    # attempts counted, the tracer's wall summed
    cnt, restore = counting_attempts()
    cnt["trace_s"] = 0.0
    trace = ode.trace_paths

    def trace_timed(*a, **kw):
        out, dt = wall_s(lambda: trace(*a, **kw))
        cnt["trace_s"] += dt
        return out

    ode.trace_paths = trace_timed
    try:
        _, t = wall_s(lambda: makegraph(s, cpl))
    finally:
        ode.trace_paths = trace
        restore()
    made = dict(cnt)                # makegraph's own counts
    bcps = [cp for cp in cpl.cps if cp.typ == -1]
    rcps = [cp for cp in cpl.cps if cp.typ == 1]
    check(len(bcps) > 0, "makegraph: the CP list has no bond point")
    pairs = set()
    for cp in bcps:
        check(cp.ipath is not None and min(cp.ipath) >= 0
              and all(cpl.cps[i].isnuc for i in cp.ipath),
              f"makegraph: bond point {cp.name} has ends {cp.ipath}")
        check(all(np.isfinite(cp.brpathlen)) and min(cp.brpathlen) > 0,
              f"makegraph: bond point {cp.name} path lengths {cp.brpathlen}")
        pairs.add(tuple(sorted(cpl.cps[i].name for i in cp.ipath)))
    check(("Cl", "Na") in pairs, f"makegraph: no Na-Cl bond path in {pairs}")
    nring = sum(min(cp.ipath) >= 0 for cp in rcps)

    # kernel launches of one attempt on the bond paths (no batch this
    # small is packed)
    seeds = torch.as_tensor(
        np.array([cp.r + sg * 1e-2 * cp.brvec for cp in bcps
                  for sg in (1.0, -1.0)]), device=s.ref.device)
    fn = s.ref.eval_fn(nder=2)
    tgt = s.ref._nucleus_images()
    per, nk, na = launches_per_attempt(lambda mstep: trace(
        fn, seeds, iup=1, targets=tgt, rterm=np.full(len(tgt), 0.1),
        mstep=mstep))
    cnt = made
    out = {"wall_s": t, "trace_s": cnt["trace_s"],
           "attempts": cnt["attempts"],
           "lane_attempts": cnt["lane_attempts"], "paths": 2 * (len(bcps)
                                                               + len(rcps)),
           "profiled_attempts": na, "profiled_launches": nk,
           "launches_per_attempt": per,
           "trace_ms_per_attempt": cnt["trace_s"] * 1e3 / cnt["attempts"]}
    log(f"makegraph on the {N_SLICE}^3 tricubic CP list: {len(bcps)} bond and "
        f"{len(rcps)} ring points, {out['paths']} paths, wall {t:.3f} s, of "
        f"it trace_paths {cnt['trace_s']:.3f} s in {cnt['attempts']} BS23 "
        f"attempts (trace_paths wall / attempts "
        f"{out['trace_ms_per_attempt']:.3f} ms, {cnt['lane_attempts']} "
        f"lane-attempts), {out['launches_per_attempt']:.1f} kernel launches "
        f"an attempt ({nk[1]} in {na[1]} attempts less {nk[0]} in {na[0]}); "
        f"every bond path ends at two nuclei, pairs {sorted(pairs)}; {nring} "
        f"of {len(rcps)} ring points reach two cages")
    return out


def bader_phase(s, yt_rows):
    """Phase 7d: intgrid(method="bader"), both assignments, at 256^3, and
    the labels against the CPU's at 64^3."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis.bader import bader_integrate
    from critic2_tpu_torch.analysis.integration import (_rasterize_field,
                                                        intgrid)

    g = s.ref.grid.f
    c = s.crystal
    dv = c.volume / g.numel()
    total = float(g.sum()) * dv
    q_yt = {}
    for row in yt_rows:
        q_yt[row.atom] = row.pop
    out = {}
    for bm in ("neargrid", "ongrid"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r, t = wall_s(lambda: intgrid(s, method="bader", bader_method=bm))
        peak = torch.cuda.max_memory_allocated() / 2**30
        q = np.array([row.pop for row in r.rows])
        names = sorted(row.name for row in r.rows)
        check(names == ["Cl", "Cl", "Na", "Na"] and r.nattr_raw == 4,
              f"bader {bm}: basin rows {names}, {r.nattr_raw} attractors")
        pu = abs(q.sum() - total)
        check(pu <= 1e-8, f"bader {bm}: partition of unity {pu:.3e} e")
        vu = abs(sum(row.volume for row in r.rows) - c.volume)
        dmax = max(abs(row.pop - q_yt[row.atom]) / q_yt[row.atom]
                   for row in r.rows)
        check(dmax < 0.02, f"bader {bm}: charges differ from YT's by "
              f"{dmax:.3e} relative")
        out[bm] = {"wall_s": t, "peak_gib": peak, "punity_e": pu,
                   "dq_vs_yt_rel": dmax}
        log(f"intgrid bader {bm} {N_SLICE}^3: wall {t:.3f} s, peak device "
            f"memory {peak:.2f} GiB, 4 atomic basins, |sum q - int rho| = "
            f"{pu:.3e} e, |sum V - cell| = {vu:.3e} bohr^3, charges within "
            f"{dmax:.3e} relative of YT's")
        log(r.table())
        del r
    g64 = _rasterize_field(s.fields[0], (64, 64, 64))
    for bm in ("neargrid", "ongrid"):
        a = bader_integrate(c, g64, method=bm)
        b = bader_integrate(c, g64.cpu(), method=bm)
        check(a.nattr == b.nattr and np.array_equal(a.iattr, b.iattr)
              and torch.equal(a.labels_d.cpu(), b.labels_d),
              f"bader {bm} at 64^3: the card's labels differ from the CPU's")
    log("bader at 64^3: labels and attractors on the card equal the CPU's, "
        "neargrid and ongrid")
    return out


def bader_walk_phase(dev):
    """Phase 15: the walk kernel on the benchmark's hematite density, in
    intgrid and against its plain version; returns its kernel record."""
    import numpy as np
    import torch

    from benchmark.lib import density as bench_density
    from critic2_tpu_torch.analysis import bader
    from critic2_tpu_torch.analysis.integration import intgrid
    from critic2_tpu_torch.convert import crystal_from_arrays
    from critic2_tpu_torch.fields.field import Field
    from critic2_tpu_torch.fields.grid3 import Grid3
    from critic2_tpu_torch.ops import bader_walk
    from critic2_tpu_torch.system import System
    from critic2_tpu_torch.utils import trace

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmark", "configs",
                           "hematite-r3c.json")) as fh:
        cfg = json.load(fh)
    st = cfg["structure"]
    rho = bench_density.make_pool(cfg, HEMATITE_SEED, 1, dev)[0]
    shape = tuple(rho.shape)
    N = rho.numel()
    c = crystal_from_arrays(np.asarray(st["lattice_bohr"]), st["x_frac"],
                            st["species_of"],
                            [(sp["name"], sp["z"]) for sp in st["species"]])
    s = System.from_structure(c, device=dev)
    s.load_field(Field.from_grid(c, Grid3(rho)))
    intgrid(s, method="bader")                 # warm: the library loads
    bader_walk.launches["bader_walk"] = 0
    with trace.recording() as rec:
        r, t = wall_s(lambda: intgrid(s, method="bader"))
    counters = rec.read()["counters"]
    launches = bader_walk.launches["bader_walk"]
    check(launches == 1, f"bader_walk: {launches} launches in one intgrid")
    check(counters["bader.capped"] == 0,
          f"bader_walk: {counters['bader.capped']} walkers at the cap")
    names = sorted(row.name for row in r.rows)
    check(r.nattr_raw == 30 and names == ["Fe"] * 12 + ["O"] * 18,
          f"hematite: {r.nattr_raw} attractors, rows {names}")
    q = sum(row.pop for row in r.rows)
    v = sum(row.volume for row in r.rows)
    check(abs(q - 204.0) <= 1e-9 * 204.0, f"hematite: sum of charges {q!r}")
    check(abs(v - c.volume) <= 1e-9 * c.volume,
          f"hematite: sum of volumes {v!r}, cell {c.volume!r}")
    log(f"intgrid bader neargrid hematite {shape}: wall {t:.4f} s, 1 "
        f"bader_walk launch, {counters['bader.walker_steps']} walker-steps, "
        f"0 capped, 30 rows (12 Fe, 18 O), sum q = {q:.12f} e, sum V - "
        f"cell = {v - c.volume:.3e} bohr^3")
    del r
    lat2car, offs, dists = bader._lattice_metric(c, shape)
    car2lat = np.linalg.inv(lat2car)
    G = (car2lat @ car2lat.T).tolist()
    invd = 1.0 / dists
    maxiter = 4 * max(shape) + 64
    got = bader._neargrid_roots(c, rho)
    want = []
    plain_ms = cuda_ms(lambda: want.append(bader_walk.neargrid_walk_plain(
        rho, G, offs, invd, maxiter)), 1, warm=0)
    same = torch.equal(got, want[0])
    check(same, "bader_walk: roots differ from neargrid_walk_plain's")
    del got, want
    ms = cuda_ms(lambda: bader_walk.bader_walk(rho, G, invd, maxiter), 5)
    bound_ms = N * (rho.element_size() + 8) / HBM_BYTES_PER_S * 1e3
    log(f"bader_walk f64 N={N}: roots bitwise equal to the plain walk's; "
        f"kernel {ms:.4f} ms ({100 * bound_ms / ms:.2f} % of the "
        f"{bound_ms:.4f} ms bytes bound), plain {plain_ms:.1f} ms")
    return {"name": "bader_walk", "route": "cuda",
            "source": SOURCE["bader_walk"],
            "replaces": REPLACES["bader_walk"], "launches": launches,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "intgrid_s": t, "walker_steps": counters["bader.walker_steps"],
            "shape": list(shape), "dtype": "float64"}


def bisect_flux_phase(s):
    """Phase 7e: IAS bisection of the Na basin, a sphere integral and
    FLUXPRINT, card against CPU."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis.bisect import (basin_rays, bisect_basin,
                                                   sphere_integral)
    from critic2_tpu_torch.analysis.flux import fluxprint
    from critic2_tpu_torch.convert import (crystal_to_arrays,
                                           system_from_arrays)

    c = s.crystal
    scpu = system_from_arrays(**crystal_to_arrays(c),
                              grid=s.ref.grid.f.cpu().numpy(), device="cpu")
    dirs, _ = basin_rays(level=1)
    # one bisection step is a whole trace of every ray: 1e-2 bohr (10
    # steps), not the default 1e-4 (17 steps), keeps the phase short
    tol = 1e-2
    log(f"bisect_basin runs at tol={tol:g} bohr (the default is 1e-4)")
    center = c.x_frac[0]
    r, t = wall_s(lambda: bisect_basin(s, center, dirs, tol=tol))
    r_cpu, t_cpu = wall_s(lambda: bisect_basin(scpu, center, dirs, tol=tol))
    rmax = float(np.linalg.norm(c.ws.vertices, axis=1).max())
    check(np.isfinite(r).all() and (r > 0).all() and (r < rmax).all(),
          f"bisect_basin: radii {r} outside (0, {rmax})")
    dr = float(np.abs(r - r_cpu).max())
    check(dr <= tol, f"bisect_basin card vs CPU: {dr:.3e} bohr")
    log(f"bisect_basin Na, {len(dirs)} rays: wall {t:.3f} s on the card "
        f"({t_cpu:.3f} s on the CPU), radii {r.min():.4f} .. {r.max():.4f} "
        f"bohr below the WS circumradius {rmax:.4f}, card vs CPU "
        f"{dr:.3e} bohr")
    v, t_sph = wall_s(lambda: sphere_integral(s, center, 1.5))
    v_cpu = sphere_integral(scpu, center, 1.5)
    e = abs(v - v_cpu) / abs(v_cpu)
    check(np.isfinite(v) and e <= 1e-10,
          f"sphere_integral card vs CPU: {e:.3e}")
    log(f"sphere_integral r=1.5 bohr around Na: {v:.10f} ({t_sph:.4f} s), "
        f"card vs CPU rel {e:.3e}")

    rng = np.random.default_rng(17)
    seeds = (c.x_cart[rng.integers(0, c.ncel, 8)]
             + rng.normal(0.0, 1.2, (8, 3)))
    scene, t_flux = wall_s(lambda: fluxprint(s, seeds, iup=1, nrec=300))
    nuc = torch.as_tensor(s.ref._nucleus_images())
    for p in scene.pathpts:
        d = float((nuc - torch.as_tensor(p[-1])).norm(dim=1).min())
        check(d < 1e-9, f"fluxprint: a path ends {d:.3e} bohr off a nucleus")
    log(f"fluxprint, 8 seeds uphill: wall {t_flux:.3f} s, "
        f"{sum(len(p) for p in scene.pathpts)} recorded points, every path "
        "ends on a nucleus")
    return {"bisect_s": t, "bisect_cpu_s": t_cpu, "bisect_dr": dr,
            "tol": tol, "sphere_rel": e, "flux_s": t_flux}


def format_e18_11(vals):
    """'%18.11E' of every float64 of vals (|exponent| < 100), vectorised:
    an (N, 18) uint8 array. The 12 significant digits come from the value
    scaled by a power of ten and rounded once, so the last digit may
    differ from printf's exact decimal rounding (a relative error below
    1e-11 either way)."""
    import numpy as np

    v = np.asarray(vals, dtype=np.float64).reshape(-1)
    a = np.abs(v)
    nz = a > 0
    e = np.zeros(v.shape, dtype=np.int64)
    e[nz] = np.floor(np.log10(a[nz])).astype(np.int64)
    for _ in range(2):          # log10 may put the exponent one off
        m = np.rint(a * 10.0 ** (11 - e))
        e += (m >= 1e12).astype(np.int64)
        e -= (nz & (m < 1e11)).astype(np.int64)
    m = np.rint(a * 10.0 ** (11 - e)).astype(np.int64)
    check(int(np.abs(e).max(initial=0)) < 100, "exponent of 3 digits")
    out = np.empty((len(v), 18), dtype=np.uint8)
    out[:, 0] = np.where(v < 0, ord("-"), ord(" "))
    digits = (m[:, None] // 10 ** np.arange(11, -1, -1)) % 10 + ord("0")
    out[:, 1] = digits[:, 0]
    out[:, 2] = ord(".")
    out[:, 3:14] = digits[:, 1:]
    out[:, 14] = ord("E")
    out[:, 15] = np.where(e < 0, ord("-"), ord("+"))
    out[:, 16] = np.abs(e) // 10 + ord("0")
    out[:, 17] = np.abs(e) % 10 + ord("0")
    return out


def chgcar_bytes(poscar_text: str, grid, volume: float) -> bytes:
    """A VASP CHGCAR of grid (n1, n2, n3) on the POSCAR's cell: the POSCAR
    text, a blank line, the dimensions, then grid * volume with the
    first index fastest, five '%18.11E' values a line."""
    import numpy as np

    chars = format_e18_11(np.asarray(grid).reshape(-1, order="F") * volume)
    nfull = len(chars) // 5
    lines = np.empty((nfull, 91), dtype=np.uint8)
    lines[:, :90] = chars[:nfull * 5].reshape(nfull, 90)
    lines[:, 90] = ord("\n")
    tail = chars[nfull * 5:].tobytes()
    return ((poscar_text.rstrip("\n") + "\n\n"
             + " ".join(map(str, np.shape(grid)))
             + "\n").encode() + lines.tobytes()
            + (tail + b"\n" if tail else b""))


def match_cps(crystal, got, ref, tol):
    """Pair each CP of list `got` with one of `ref` of the same type and
    multiplicity at the least distance over the symmetry images; returns
    the largest such distance (bohr). Fails on a CP with no partner."""
    import numpy as np

    sg = crystal.spacegroup
    free = list(range(len(ref["typ"])))
    dmax = 0.0
    for i in range(len(got["typ"])):
        cand = [j for j in free if ref["typ"][j] == got["typ"][i]
                and ref["mult"][j] == got["mult"][i]]
        check(cand, f"CP {i} (type {got['typ'][i]}) has no partner")
        d = [float(crystal.distmat(got["x"][i], (sg.rotations @ ref["x"][j]
                                                 + sg.translations)
                                   % 1.0).min()) for j in cand]
        k = int(np.argmin(d))
        free.remove(cand[k])
        dmax = max(dmax, d[k])
    check(not free, f"{len(free)} CPs of the reference list unmatched")
    check(dmax <= tol, f"CP positions differ by {dmax:.3e} bohr")
    return dmax


def quickstart_phase(sl, card):
    """Phase 10: the README quick start at 256^3 on the card. The POSCAR
    of the NaCl analogue and a CHGCAR of the slice phase's field are
    written, then System.from_structure -> load_field -> autocp ->
    makegraph -> intgrid(method="yt") run on them and are held against
    the in-memory runs of phases 4 and 6; last, a bincube round trip."""
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis.autocp import autocp, makegraph
    from critic2_tpu_torch.analysis.integration import intgrid
    from critic2_tpu_torch.convert import cplist_to_arrays, crystal_to_arrays
    from critic2_tpu_torch.io.writers import write_poscar
    from critic2_tpu_torch.ops import yt_pass as ops

    c0 = nacl_crystal()
    g0 = sl["system"].ref.grid
    n = N_SLICE
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        poscar = os.path.join(tmp, "POSCAR")
        chgcar = os.path.join(tmp, "CHGCAR")

        def write():
            write_poscar(c0, poscar)
            with open(poscar) as fh:
                text = fh.read()
            with open(chgcar, "wb") as fh:
                fh.write(chgcar_bytes(text, g0.f.cpu().numpy(), c0.volume))

        _, walls["write_s"] = wall_s(write)
        size = os.path.getsize(chgcar)
        log(f"quick start: wrote POSCAR and a {n}^3 CHGCAR of {size} bytes "
            f"in {walls['write_s']:.3f} s")

        # 2. the structure: the writer lists the atoms species by species
        s, walls["from_structure_s"] = wall_s(
            lambda: System.from_structure(poscar))
        got, ref = crystal_to_arrays(s.crystal), crystal_to_arrays(c0)
        order = np.argsort(ref["species_of"], kind="stable")
        dcell = float(np.abs(got["m_x2c"] - ref["m_x2c"]).max())
        check(dcell <= 1e-10, f"POSCAR cell differs by {dcell:.3e} bohr")
        check(np.array_equal(got["x_frac"], ref["x_frac"][order]),
              "POSCAR fractional positions differ")
        check(got["species"] == ref["species"] and np.array_equal(
            got["species_of"], ref["species_of"][order]),
            f"POSCAR species {got['species']} {got['species_of']}")
        check(s.device.type == "cuda", f"system on {s.device}")

        # 3. the grid
        fid, walls["load_field_s"] = wall_s(lambda: s.load_field(chgcar))
        f = s.ref.grid.f
        check(fid == 1 and s.iref == 1, f"CHGCAR loaded as field {fid}")
        check(f.is_cuda and f.is_contiguous()
              and tuple(f.shape) == (n,) * 3
              and f.dtype == torch.float64,
              f"CHGCAR grid {tuple(f.shape)} {f.dtype} on {f.device}, "
              f"contiguous {f.is_contiguous()}")
        drel = rel_err(f, g0.f)
        check(drel <= 1e-10, f"CHGCAR grid differs by {drel:.3e} relative")
        log(f"quick start: from_structure {walls['from_structure_s']:.3f} "
            f"s, load_field {walls['load_field_s']:.3f} s; grid "
            f"{tuple(f.shape)} contiguous on {f.device}, max relative "
            f"difference from the in-memory field {drel:.3e}")

        # 4. critical points and bond paths
        cpl, walls["autocp_s"] = wall_s(lambda: autocp(s))
        counts = tuple(cpl.counts())
        check(counts == (4, 12, 10, 2) and cpl.poincare_hopf() == 0,
              f"quick start autocp counts {counts}, Poincare-Hopf "
              f"{cpl.poincare_hopf()}")
        dcp = match_cps(s.crystal, cplist_to_arrays(cpl),
                        cplist_to_arrays(sl["cpl"]), 1e-8)
        _, walls["makegraph_s"] = wall_s(lambda: makegraph(s, cpl))
        bonds = [cp for cp in cpl.cps if cp.typ == -1]
        check(bonds and all(cp.ipath is not None and min(cp.ipath) >= 0
                            and all(cpl.cps[i].isnuc for i in cp.ipath)
                            for cp in bonds),
              "quick start: a bond path does not end at two nuclei")
        log(f"quick start: autocp {walls['autocp_s']:.3f} s, counts "
            f"{counts}, Poincare-Hopf 0, CPs within {dcp:.3e} bohr of the "
            f"grid phase's (up to a symmetry image); makegraph "
            f"{walls['makegraph_s']:.3f} s, {len(bonds)} bond points, every "
            f"bond path ends at two nuclei")

        # 5. integration; the launches counted in this call alone
        ops.reset_launches()
        res, walls["intgrid_s"] = wall_s(lambda: intgrid(s, method="yt"))
        launches = dict(ops.launches)
        check(launches == {"yt_pass": 1, "yt_gs_pass": 16},
              f"quick start intgrid launches {launches}")
        dv = c0.volume / n ** 3
        q = np.array([r.pop for r in res.rows])
        punity = abs(q.sum() - float(f.sum()) * dv)
        check(punity <= 1e-8, f"quick start partition of unity {punity:.3e}")
        q_slice = {r.atom: r.pop for r in sl["intres"].rows}
        check(sorted(r.atom for r in res.rows) == sorted(q_slice) == [0, 1,
                                                                     2, 3],
              "quick start basins differ from the slice phase's")
        dq = max(abs(r.pop - q_slice[int(order[r.atom])]) for r in res.rows)
        check(dq <= 1e-8, f"quick start charges differ by {dq:.3e} e")
        log(f"quick start: intgrid {walls['intgrid_s']:.3f} s, launches "
            f"{launches}, partition of unity {punity:.3e} e, per-basin "
            f"|q - q(slice phase)| max {dq:.3e} e")
        log(res.table())

        # 6. bincube round trip of the in-memory field
        cube = os.path.join(tmp, "rho.bincube")
        _, walls["bincube_write_s"] = wall_s(
            lambda: g0.write_bincube(cube, crystal=s.crystal))
        fb, walls["bincube_read_s"] = wall_s(lambda: s.load_field(cube))
        same = torch.equal(s.fields[fb].grid.f, g0.f)
        check(same and s.fields[fb].grid.f.is_cuda,
              "bincube round trip is not bitwise equal")
        s.unload_field(fb)
        log(f"quick start: bincube of {os.path.getsize(cube)} bytes written "
            f"in {walls['bincube_write_s']:.3f} s, read back in "
            f"{walls['bincube_read_s']:.3f} s, bitwise equal")
    log(f"quick start walls on {card}: " + ", ".join(
        f"{k[:-2]} {v:.3f} s" for k, v in walls.items()))
    out = {"walls_s": walls, "chgcar_bytes": size, "grid_rel_diff": drel,
           "cp_dmax_bohr": dcp, "dq_vs_slice_e": dq, "punity_e": punity,
           "counts": list(counts), "launches": launches}
    log(json.dumps({"quickstart": out}))
    del s, res, cpl, f
    torch.cuda.empty_cache()
    return out


def path_phase(sl, grid_out, profile):
    """Phase 7b-f on the slice phase's system; the launch counts are reset
    before and read after (no kernel of the port lies on these parts)."""
    from critic2_tpu_torch.analysis.autocp import makegraph
    from critic2_tpu_torch.analysis.integration import intgrid
    from critic2_tpu_torch.ops import yt_pass as ops

    s = sl["system"]
    ops.reset_launches()
    out = {"fft": fft_phase(s)}
    out["spline"] = spline_phase(
        s, grid_out["interp"]["interp_soa_float64_ms"])
    out["bader"] = bader_phase(s, sl["intres"].rows)
    out["bisect_flux"] = bisect_flux_phase(s)
    # last: its launch count switches the profiler on, which slows every
    # later launch of the process
    out["makegraph"] = graph_phase(s, sl["cpl"])
    log(f"gradient-path and FFT parts: CUDA kernel launches "
        f"{dict(ops.launches)} (no kernel of the port lies on them)")
    if profile:
        device_profile(lambda: makegraph(s, sl["cpl"]), "makegraph",
                       cpu=False)
        device_profile(lambda: intgrid(s, method="bader"),
                       "intgrid bader neargrid", cpu=False)
    log(json.dumps({"path_slice": out}))
    return out


H2_MOLDEN = """[Molden Format]
[Atoms] AU
H 1 1 0.0 0.0 0.0
H 2 1 0.0 0.0 1.4
[GTO]
1 0
 s 3 1.00
  3.42525091 0.15432897
  0.62391373 0.53532814
  0.16885540 0.44463454

2 0
 s 3 1.00
  3.42525091 0.15432897
  0.62391373 0.53532814
  0.16885540 0.44463454

[MO]
Sym= A1
Ene= -0.578
Spin= Alpha
Occup= 2.0
  1 0.54893404
  2 0.54893404
Sym= A2
Ene= 0.671
Spin= Alpha
Occup= 0.0
  1 1.21146407
  2 -1.21146407
"""
TILE = (8, 8, 6)     # 768 atoms, 2,304 primitives, 384 MOs


def two_gauss_system(dev, n, amp2, alpha2, a=8.0):
    """The two-Gaussian crystal of tests/test_qtree.py: Gaussians at
    (0,0,0) (amplitude 2, exponent 0.8) and (1/2,1/2,1/2), on an n^3
    grid, field 1 of a system on dev."""
    import numpy as np

    from critic2_tpu_torch.convert import system_from_arrays

    ii, jj, kk = np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij")
    xf = np.stack([ii, jj, kk], axis=-1)

    def gauss(center, amp, alpha):
        d = xf - center
        d -= np.round(d)
        return amp * np.exp(-alpha * ((d * a) ** 2).sum(-1))

    g = (gauss(np.zeros(3), 2.0, 0.8) + gauss(np.full(3, 0.5), amp2, alpha2)
         + 1e-3)
    return system_from_arrays(np.diag([a] * 3),
                              [[0, 0, 0], [0.5, 0.5, 0.5]], [0, 1],
                              [("Na", 11), ("Cl", 17)], grid=g, device=dev)


def qtree_phase(sl, dev):
    """Phase 8: qtree (config 5) on the slice's 256^3 field, the exact-half
    case at 48^3 and maxl=2 card against CPU."""
    import numpy as np

    from critic2_tpu_torch.analysis import qtree as qmod
    from critic2_tpu_torch.analysis.qtree import qtree_integrate

    s = sl["system"]
    stats = {}
    cnt, restore = counting_attempts()
    # phase 14 traces every colour seed again: keep them
    tr = sl["qtree_trace"] = {}
    traced = qmod.trace_paths

    def recording(fn, x0, **kw):
        x = x0.cpu().numpy()
        if not tr:
            tr.update(seeds=[x], targets=kw["targets"],
                      tgt_ids=np.tile(np.arange(s.crystal.ncel),
                                      len(kw["targets"]) // s.crystal.ncel),
                      rt=np.asarray(kw["rterm"]), mstep=kw["mstep"])
        else:
            check(np.array_equal(np.asarray(kw["rterm"]), tr["rt"]),
                  "qtree traced with two capture radii")
            tr["seeds"].append(x)
        return traced(fn, x0, **kw)

    qmod.trace_paths = recording
    try:
        r, t = wall_s(lambda: qtree_integrate(
            s, maxl=4, sphfactor=0.9, block=1 << 16, stats=stats))
    finally:
        restore()
        qmod.trace_paths = traced
    tr["seeds"] = np.concatenate(tr["seeds"])
    check(len(tr["seeds"]) == r.ntraced, f"qtree traced "
          f"{len(tr['seeds'])} seeds, ntraced {r.ntraced}")
    q_yt = sum(row.pop for row in sl["intres"].rows)
    dq = abs(float(r.pops.sum()) - q_yt)
    check(np.isfinite(r.pops).all() and (r.pops > 0).all()
          and (r.volumes > 0).all(), f"qtree 256^3: pops {r.pops}")
    check(dq <= 1e-3 * q_yt + 0.3,
          f"qtree 256^3: |sum pops - sum YT| = {dq:.4f} e")
    out = {"wall_s": t, "ntraced": r.ntraced, "nrefined": r.nrefined,
           "nlevels": r.nlevels, **cnt, **stats,
           "pops": r.pops.tolist(), "volumes": r.volumes.tolist(),
           "sum_pops": float(r.pops.sum()), "sum_yt": q_yt, "dq_e": dq}
    log(f"qtree {N_SLICE}^3 maxl=4 sphfactor=0.9: wall {t:.3f} s = traces "
        f"{stats['trace_s']:.3f} + Keast/corner cubature "
        f"{stats['cubature_s']:.3f} + boundary split "
        f"{stats['boundary_s']:.3f} + sphere integrals "
        f"{stats['sphere_s']:.3f} (+ host rest); ntraced {r.ntraced}, "
        f"nrefined {r.nrefined}, {cnt['attempts']} BS23 attempts "
        f"({cnt['lane_attempts']} lane-attempts); sum pops "
        f"{r.pops.sum():.6f} e against sum YT {q_yt:.6f} e (|d| {dq:.3e})")
    log(r.table())

    sh = two_gauss_system(dev, 48, 2.0, 0.8)
    rh, th = wall_s(lambda: qtree_integrate(sh, maxl=5))
    half = rh.pops.sum() / 2
    dh = float(np.abs(rh.pops - half).max())
    check(dh < 2e-5, f"qtree exact half: max |pop - half| = {dh:.3e} e")
    out.update(half_wall_s=th, half_dev_e=dh, half_ntraced=rh.ntraced)
    log(f"qtree exact-half two-Gaussian 48^3 maxl=5: wall {th:.3f} s, "
        f"ntraced {rh.ntraced}, max |pop - half| {dh:.3e} e")

    sc = two_gauss_system(dev, 48, 1.0, 0.6)
    scpu = two_gauss_system("cpu", 48, 1.0, 0.6)
    r2, t2 = wall_s(lambda: qtree_integrate(sc, maxl=2))
    t0 = time.perf_counter()
    r2c = qtree_integrate(scpu, maxl=2)
    t2c = time.perf_counter() - t0
    dp = float(np.abs(r2.pops - r2c.pops).max())
    check(r2.ntraced == r2c.ntraced and r2.nrefined == r2c.nrefined,
          f"qtree maxl=2 card vs CPU: ntraced {r2.ntraced} / {r2c.ntraced}")
    check(dp <= 1e-9, f"qtree maxl=2 card vs CPU: pops {dp:.3e} e")
    out.update(cpu_check_wall_s=t2, cpu_check_cpu_s=t2c, cpu_check_dp=dp)
    log(f"qtree maxl=2 two-Gaussian 48^3, card vs CPU: ntraced "
        f"{r2.ntraced} both, max |d pop| {dp:.3e} e (card {t2:.3f} s, CPU "
        f"{t2c:.3f} s)")
    return out


def wfn_phase(dev):
    """Phase 9: the molecular-wavefunction path on H2/STO-3G and its
    8x8x6 tile."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis.autocp import autocp, makegraph
    from critic2_tpu_torch.analysis.mesh import becke_mesh
    from critic2_tpu_torch.analysis.molcalc import (molcalc_integral,
                                                    molcalc_nelec)
    from critic2_tpu_torch.convert import cplist_to_arrays
    from critic2_tpu_torch.fields.wfn import Wavefunction
    from critic2_tpu_torch.ops.ode import trace_paths, trace_paths_screened

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "h2.molden")
    with open(path, "w") as fh:
        fh.write(H2_MOLDEN)

    # the monomer: NELEC on the ultra mesh (f64 weights)
    s1 = System.from_structure(path, device=dev)
    s1.load_field(path)
    m1, tb1 = wall_s(lambda: becke_mesh(s1.crystal, "ultra", device=dev))
    n1, ts1 = wall_s(lambda: molcalc_integral(s1, "$1", lvl="ultra",
                                              weights_dtype=np.float64))
    check(abs(n1 - 2.0) < 1e-5, f"NELEC H2 ultra {n1}")
    out["monomer"] = {"mesh_points": m1.n, "mesh_build_s": tb1,
                      "sweep_s": ts1, "nelec": n1, "err_e": n1 - 2.0}
    log(f"H2/STO-3G NELEC, ultra mesh ({m1.n} points): {n1:.12f} e, error "
        f"{n1 - 2.0:.3e} e; mesh build {tb1:.3f} s, density sweep + sum "
        f"{ts1:.3f} s")

    # the assembly
    tile = Wavefunction.from_file(path).tile(TILE)
    s = System.from_wavefunction(tile, device=dev)
    w = s.ref.wfn
    nat = len(w.atz)
    ncopy = TILE[0] * TILE[1] * TILE[2]
    check((nat, w.npri, w.nmo) == (2 * ncopy, 6 * ncopy, ncopy)
          and w.npri >= w.SCREEN_NPRI, f"tile {nat}, {w.npri}, {w.nmo}")
    c = s.crystal
    rng = np.random.default_rng(7)
    pts = rng.random((65536, 3)) @ np.asarray(c.m_x2c).T
    xT = torch.as_tensor(pts.T.copy(), dtype=torch.float64, device=dev)
    scr, _ = wall_s(lambda: w.rho_eval_screened(xT, nder=2))
    scr, t_scr = wall_s(lambda: w.rho_eval_screened(xT, nder=2))
    den, _ = wall_s(lambda: w.rho_eval_dense(xT, nder=2))
    den, t_den = wall_s(lambda: w.rho_eval_dense(xT, nder=2))
    e_rho = float((scr[0] - den[0]).abs().max() / den[0].abs().max())
    e_g = float((scr[1] - den[1]).abs().max())
    e_h = float((scr[2] - den[2]).abs().max())
    check(e_rho <= 1e-12 and e_g <= 1e-10 and e_h <= 1e-10,
          f"screened vs dense: rho {e_rho:.3e}, grad {e_g:.3e}, "
          f"hessian {e_h:.3e}")
    f32, t_f32 = wall_s(lambda: w.rho_eval_dense(xT, nder=2,
                                                 dtype=torch.float32))
    f32, t_f32 = wall_s(lambda: w.rho_eval_dense(xT, nder=2,
                                                 dtype=torch.float32))
    e32 = float((f32[0] - den[0]).abs().max() / den[0].abs().max())
    check(all(bool(torch.isfinite(v).all()) for v in f32),
          "f32 dense: not finite")
    cpu = w.rho_eval_soa(xT[:, :4096].cpu(), nder=2)
    e_cpu = max(float((a[..., :4096].cpu() - b).abs().max()
                      / b.abs().max()) for a, b in zip(scr, cpu))
    check(e_cpu <= 1e-12, f"screened card vs CPU: {e_cpu:.3e}")
    out["gto"] = {"points": 65536, "screened_ms": t_scr * 1e3,
                  "dense_ms": t_den * 1e3, "dense_f32_ms": t_f32 * 1e3,
                  "screened_vs_dense": [e_rho, e_g, e_h],
                  "f32_vs_f64_rel": e32, "card_vs_cpu_rel": e_cpu}
    log(f"GTO evaluator, tile {TILE} ({nat} atoms, {w.npri} primitives, "
        f"{w.nmo} MOs), 65,536 points in the cell, nder=2: screened "
        f"{t_scr * 1e3:.3f} ms, dense f64 {t_den * 1e3:.3f} ms, dense f32 "
        f"{t_f32 * 1e3:.3f} ms; screened vs dense rho {e_rho:.3e} (rel), "
        f"grad {e_g:.3e}, hessian {e_h:.3e}; f32 vs f64 rho {e32:.3e} "
        f"(rel); card vs CPU on 4,096 points {e_cpu:.3e} (rel)")

    # NELEC of the assembly: normal mesh, KNN weights (f32, molcalc's
    # default), build and density sweep apart
    m, t_mesh = wall_s(lambda: becke_mesh(c, "normal",
                                          weights_dtype=np.float32,
                                          device=dev))
    nel, t_sweep = wall_s(lambda: molcalc_nelec(s, lvl="normal"))
    check(np.isfinite(nel) and abs(nel - nat) < 1.0, f"NELEC assembly {nel}")
    out["assembly_nelec"] = {"mesh_points": m.n, "mesh_build_s": t_mesh,
                             "sweep_s": t_sweep, "nelec": nel,
                             "err_e": nel - nat}
    log(f"NELEC of the assembly, normal mesh ({m.n} points, KNN f32 "
        f"weights): {nel:.9f} e, error {nel - nat:.3e} e; mesh build "
        f"{t_mesh:.3f} s, density sweep + sum {t_sweep:.3f} s")

    # autocp through the screened Newton
    cpl, t_auto = wall_s(lambda: autocp(s))
    n, b, r, cc = cpl.counts()
    ph = cpl.poincare_hopf()
    arr = cplist_to_arrays(cpl)
    maxima = arr["r"][arr["typ"] == -3]
    d_max = np.linalg.norm(w.atpos[:, None, :] - maxima[None], axis=2)
    mid = 0.5 * (w.atpos[0::2] + w.atpos[1::2])
    bonds = arr["r"][arr["typ"] == -1]
    d_mid = np.linalg.norm(mid[:, None, :] - bonds[None], axis=2).min(1)
    gmax = float(arr["gfmod"][~arr["isnuc"]].max())
    check(ph == 1, f"autocp assembly: Poincare-Hopf {ph}, counts "
          f"{cpl.counts()}")
    check(len(maxima) == nat and d_max.min(1).max() < 0.05,
          f"autocp assembly: {len(maxima)} maxima")
    check(d_mid.max() < 0.01, f"autocp assembly: a molecule's bond CP "
          f"{d_mid.max():.3e} bohr off its midpoint")
    check(gmax < 1e-10, f"autocp assembly: max |grad rho| {gmax:.3e}")
    out["autocp"] = {"wall_s": t_auto, "counts": [n, b, r, cc],
                     "midpoint_dev_max": float(d_mid.max()),
                     "gfmod_max": gmax}
    log(f"autocp on the assembly (screened Newton): {t_auto:.3f} s, counts "
        f"(n, b, r, c) = {cpl.counts()}, PH {ph}, bond CPs within "
        f"{d_mid.max():.3e} bohr of the {ncopy} midpoints, max |grad rho| "
        f"{gmax:.3e}")

    # the screened Newton on a 2x2x2 tile, card against CPU
    small = Wavefunction.from_file(path).tile((2, 2, 2))
    lists = []
    for d in (dev, "cpu"):
        ss = System.from_wavefunction(copy.deepcopy(small), device=d)
        ss.ref.wfn.SCREEN_NPRI = 0
        lists.append(cplist_to_arrays(autocp(ss)))
    check(np.array_equal(lists[0]["typ"], lists[1]["typ"]),
          "screened Newton 2x2x2: card and CPU lists differ")
    dr = float(np.abs(lists[0]["r"] - lists[1]["r"]).max())
    check(dr <= 1e-9, f"screened Newton 2x2x2 card vs CPU {dr:.3e} bohr")
    out["autocp"]["small_card_vs_cpu_bohr"] = dr
    log(f"screened Newton on the 2x2x2 tile: {len(lists[0]['typ'])} CPs, "
        f"card vs CPU {dr:.3e} bohr")

    # makegraph through trace_paths_screened
    cnt, restore = counting_attempts()
    try:
        _, t_graph = wall_s(lambda: makegraph(s, cpl))
    finally:
        restore()
    arr = cplist_to_arrays(cpl)
    bsel = np.nonzero(arr["typ"] == -1)[0]
    intra = 0
    for i in bsel:
        k = int(np.argmin(np.linalg.norm(mid - arr["r"][i], axis=1)))
        if np.linalg.norm(mid[k] - arr["r"][i]) < 0.01:
            intra += 1
            check(sorted(arr["ipath"][i]) == [2 * k, 2 * k + 1],
                  f"makegraph: molecule {k}'s bond path ends at "
                  f"{arr['ipath'][i]}")
    check(intra == ncopy, f"makegraph: {intra} intramolecular bond paths")
    out["makegraph"] = {"wall_s": t_graph, **cnt}
    log(f"makegraph on the assembly (trace_paths_screened): {t_graph:.3f} s, "
        f"{cnt['attempts']} BS23 attempts ({cnt['lane_attempts']} "
        f"lane-attempts); all {ncopy} intramolecular bond paths end at their "
        f"molecule's two nuclei")

    # screened tracer against the dense one on 64 seeds
    iat = rng.integers(0, nat, 64)
    u = rng.normal(size=(64, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    seeds = w.atpos[iat] + 0.5 * u
    kw = dict(iup=1, targets=w.atpos, rterm=np.full(nat, 0.2))
    ts_, t_ts = wall_s(lambda: trace_paths_screened(w, seeds, device=dev,
                                                    **kw))
    td_, t_td = wall_s(lambda: trace_paths(
        w.eval_closure(nder=1),
        torch.as_tensor(seeds, dtype=torch.float64, device=dev), **kw))
    same = (torch.equal(ts_[1], td_[1]) and torch.equal(ts_[2], td_[2]))
    dx = float((ts_[0] - td_[0]).abs().max())
    check(same and dx <= 1e-8, f"trace_paths_screened vs dense: status/"
          f"termid equal {same}, end points {dx:.3e} bohr")
    out["trace"] = {"screened_s": t_ts, "dense_s": t_td, "dx": dx}
    log(f"trace_paths_screened vs trace_paths (dense), 64 seeds: status "
        f"and termid equal, end points {dx:.3e} bohr; {t_ts:.3f} s against "
        f"{t_td:.3f} s")
    out["_seeds"] = seeds
    out["_wfn"] = w
    out["_system"] = s
    out["_monomer"] = s1
    return out


EXPR_TILE = (4, 4, 2)   # 64 atoms, 192 primitives: benzene/6-31G*'s count


def expr_grid_leg(sl, card):
    """Phase 11a: the expression engine and what it feeds on the slice
    phase's 256^3 NaCl analogue, card against the port on the CPU."""
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis import rhoplot, struct
    from critic2_tpu_torch.analysis.ewald import ewald_energy
    from critic2_tpu_torch.analysis.hirshfeld import hirshfeld_charges
    from critic2_tpu_torch.analysis.integration import (_grid_points,
                                                        _rasterize_field,
                                                        intgrid)
    from critic2_tpu_torch.analysis.stm import stm
    from critic2_tpu_torch.analysis.xdm import xdm_grid
    from critic2_tpu_torch.arithmetic import compile_expr
    from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
    from critic2_tpu_torch.crystal.crystal import Crystal, Species
    from critic2_tpu_torch.fields.field import Field
    from critic2_tpu_torch.fields.grid3 import Grid3
    from critic2_tpu_torch.ops import yt_pass as ops

    s = sl["system"]
    c = s.crystal
    dev = s.device
    n = N_SLICE
    shape = (n, n, n)
    g = s.field(1).grid.f
    out, walls = {}, {}

    def cpu_twin(crystal, grid):
        t = System.from_structure(crystal, device="cpu")
        t.load_field(Field.from_grid(crystal, Grid3(grid.cpu())))
        return t

    scpu = cpu_twin(c, g)

    # LOAD AS "$1:l" at 256^3; 4,096 nodes of one loader block against
    # the CPU at the card's own coordinates
    fid, walls["load_field_expr_lap_s"] = wall_s(
        lambda: s.load_field_expr("$1:l", name="lap1", shape=shape))
    blk = min(65536, n ** 3)
    lo = min(100 * 65536, n ** 3 - blk)
    xT = _grid_points(c, shape, lo, lo + blk, torch.float64, dev)[:, ::16]
    ref = compile_expr("$1:l", scpu)(xT.cpu())
    got = s.field(fid).grid.f.reshape(-1)[lo:lo + blk:16].cpu()
    e_lap = rel_err(got, ref)
    check(e_lap <= 1e-12, f"expression grid $1:l card vs CPU {e_lap:.3e}")
    s.unload_field(fid)
    out["expr_grid_card_vs_cpu_rel"] = e_lap

    # a ghost 2*$1: autograd derivatives at 131,072 points off the node
    # planes against central differences of the ghost value
    gid = s.load_field_expr("2*$1", name="ghost2", ghost=True)
    rng = np.random.default_rng(31)
    cell = rng.integers(0, n, (131072, 3))
    pts = ((cell + 0.01 + 0.98 * rng.random((131072, 3))) / n) @ c.m_x2c.T
    ptsT = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    gh = s.field(gid)
    res, walls["ghost_grd_nder2_s"] = wall_s(lambda: gh.grd(ptsT, nder=2))
    res, walls["ghost_grd_nder2_s"] = wall_s(lambda: gh.grd(ptsT, nder=2))
    f1 = s.field(1).grd(ptsT, nder=0).f
    e_val = rel_err(res.f, 2.0 * f1)
    h = 1e-5
    e_fd = 0.0
    for d in range(3):
        dp = torch.zeros(3, dtype=torch.float64, device=dev)
        dp[d] = h
        fd = (gh.grd(ptsT + dp, nder=0).f - gh.grd(ptsT - dp, nder=0).f) \
            / (2 * h)
        e_fd = max(e_fd, float(((res.gf[:, d] - fd).abs()
                                / (1e-10 + 5e-6 * fd.abs())).max()))
    check(e_val <= 1e-12 and e_fd <= 1.0,
          f"ghost 2*$1: value {e_val:.3e}, autograd vs differences "
          f"{e_fd:.3f} of the 5e-6 bar")
    s.unload_field(gid)
    out["ghost"] = {"points": 131072, "value_rel": e_val,
                    "grad_vs_fd_of_bar": e_fd}

    # intgrid with DISCARD and two INTEGRABLE entries, launches counted
    s.integrables[:] = ["$1", ("gtf(1)", "gtf")]
    ops.reset_launches()
    r, walls["intgrid_discard_integrable_s"] = wall_s(
        lambda: intgrid(s, method="yt", discard="$1 < 1e-3"))
    launches = dict(ops.launches)
    s.integrables.clear()
    rows0 = sl["intres"].rows
    check([x.name for x in r.rows] == [x.name for x in rows0],
          "intgrid with INTEGRABLE: other basins")
    dq = max(abs(a.pop - b.pop) for a, b in zip(r.rows, rows0))
    d1 = max(abs(a.extra["$1"] - a.pop) for a in r.rows)
    check(dq <= 1e-8 and d1 <= 1e-8, f"intgrid with INTEGRABLE: charges "
          f"{dq:.3e} e off the slice phase's, $1 integrable {d1:.3e} e")
    for k in ops.launches:
        check(launches[k] > 0, f"intgrid with INTEGRABLE launched no {k}")
    out["intgrid"] = {"dq_vs_slice_e": dq, "integrable_vs_charge_e": d1,
                      "gtf": [a.extra["gtf"] for a in r.rows],
                      "launches": launches}

    # Hirshfeld at 256^3
    hres, walls["hirshfeld_s"] = wall_s(lambda: hirshfeld_charges(s))
    tot = float(g.sum()) * c.volume / g.numel()
    dsum = abs(hres.pops.sum() - tot)
    na, cl = hres.pops[[0, 2]], hres.pops[[1, 3]]
    dna, dcl = abs(na[0] - na[1]) / na[0], abs(cl[0] - cl[1]) / cl[0]
    check(dsum <= 1e-8 and dna <= 1e-9 and dcl <= 1e-9,
          f"Hirshfeld: sum {dsum:.3e} e off the grid integral, Na {dna:.3e}"
          f" Cl {dcl:.3e} apart")
    out["hirshfeld"] = {"pops": hres.pops.tolist(), "sum_err_e": dsum}

    # XDM: card against CPU at 64^3, then the 256^3 run timed
    g64 = _rasterize_field(s.fields[0], (64, 64, 64))
    s64 = System.from_structure(c, device=dev)
    s64.load_field(Field.from_grid(c, Grid3(g64)))
    x_card, walls["xdm_grid_64_s"] = wall_s(lambda: xdm_grid(s64))
    x_cpu = xdm_grid(cpu_twin(c, g64))
    e_x = max(float(np.abs(getattr(x_card, k) - getattr(x_cpu, k)).max()
                    / np.abs(getattr(x_cpu, k)).max())
              for k in ("c6", "c8", "c10"))
    e_x = max(e_x, abs(x_card.energy - x_cpu.energy) / abs(x_cpu.energy))
    check(e_x <= 1e-10, f"xdm_grid 64^3 card vs CPU {e_x:.3e}")
    x256, walls["xdm_grid_256_s"] = wall_s(lambda: xdm_grid(s))
    check(np.isfinite(x256.energy) and x256.energy < 0,
          f"xdm_grid 256^3 energy {x256.energy}")
    out["xdm"] = {"card_vs_cpu_64_rel": e_x, "energy_64": x_card.energy,
                  "energy_256": x256.energy, "c6_256": x256.c6[0].tolist()}

    # Ewald: the NaCl Madelung constant (conventional cell)
    a = 10.66
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    c8 = Crystal(m_x2c=m_x2c_from_cellpar([a] * 3, [90] * 3),
                 x_frac=np.vstack([base, (base + 0.5) % 1]),
                 species_of=np.array([0] * 4 + [1] * 4),
                 species=[Species("Na", 11), Species("Cl", 17)])
    q8 = np.array([1.0] * 4 + [-1.0] * 4)
    e8, walls["ewald_energy_s"] = wall_s(
        lambda: ewald_energy(c8, q8, device=dev))
    mad = -e8 * (a / 2) / 4.0
    check(abs(mad - 1.747564594633) < 1e-8, f"Madelung NaCl {mad}")
    out["madelung_nacl"] = mad

    # CUBE of an expression at 256^3, written
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "twice.cube")
        data, walls["cube_eval_and_write_s"] = wall_s(
            lambda: rhoplot.cube(s, n=shape, what="$1 * 2", file=path))
        size = os.path.getsize(path)
    e_cube = rel_err(data, 2.0 * g)
    check(e_cube <= 1e-12 and size > 23 * n ** 3,
          f"CUBE $1*2 at 256^3: {e_cube:.3e} off 2*grid, {size} bytes")
    out["cube"] = {"vs_grid_rel": e_cube, "bytes": size}

    # STM on the slab of tests/test_flux_stm.py:57-80, 4x4 wider in plane
    xy = np.array([[i / 4 + o, j / 4 + o] for i in range(4)
                   for j in range(4) for o in (0.0, 0.125)])
    slab = Crystal(m_x2c=m_x2c_from_cellpar([24.0, 24.0, 20.0], [90] * 3),
                   x_frac=np.c_[xy, np.full(len(xy), 0.2)],
                   species_of=np.zeros(len(xy), dtype=int),
                   species=[Species("C", 6)])
    ss = System.from_structure(slab, device=dev)
    gs = _rasterize_field(ss.fields[0], (96, 96, 80))
    ss.load_field(Field.from_grid(slab, Grid3(gs)))
    cur, walls["stm_current_96x96_s"] = wall_s(
        lambda: stm(ss, mode="current", level=1e-4, npts=(96, 96)))
    hgt, walls["stm_height_96x96_s"] = wall_s(
        lambda: stm(ss, mode="height", npts=(96, 96)))
    sc = cpu_twin(slab, gs)
    cur_cpu = stm(sc, mode="current", level=1e-4, npts=(96, 96))
    e_stm = float(np.abs(cur.image - cur_cpu.image).max())
    check(e_stm <= 1e-12 and cur.image.min() > 0.2 and
          cur.image.max() <= cur.ztop + 1e-9 and cur.image.std() > 1e-4,
          f"STM current: card vs CPU {e_stm:.3e}, range "
          f"{cur.image.min()}..{cur.image.max()}")
    out["stm"] = {"current_card_vs_cpu": e_stm, "ztop": cur.ztop,
                  "height_mean": float(hgt.image.mean())}

    # POWDER, RDF, COMPARE on NaCl
    pat, walls["powder_s"] = wall_s(lambda: struct.powder(c8))
    rdf_card, walls["rdf_s"] = wall_s(lambda: struct.rdf(c8, device=dev))
    rdf_cpu = struct.rdf(c8, device="cpu")
    e_rdf = float(np.abs(rdf_card.ih - rdf_cpu.ih).max()
                  / np.abs(rdf_cpu.ih).max())
    c8b = Crystal(m_x2c=m_x2c_from_cellpar([a * 1.05] * 3, [90] * 3),
                  x_frac=c8.x_frac, species_of=c8.species_of,
                  species=c8.species)
    dmat, walls["compare_s"] = wall_s(
        lambda: struct.compare([c8, c8, c8b], device=dev))
    ipk = int(np.argmax(pat.peaks_i))
    check(e_rdf <= 1e-12 and dmat[0, 1] < 1e-8 and dmat[0, 2] > 0.01,
          f"RDF card vs CPU {e_rdf:.3e}, COMPARE {dmat.tolist()}")
    out["struct"] = {"strongest_peak_2theta": float(pat.peaks_t[ipk]),
                     "rdf_card_vs_cpu_rel": e_rdf,
                     "compare": dmat.tolist()}
    out["walls_s"] = walls
    out["launches"] = launches
    log(f"expression grid leg ({card}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    log(f"  $1:l grid card vs CPU {e_lap:.3e}; ghost value {e_val:.3e}, "
        f"autograd gradient at {e_fd:.3f} of the 5e-6 difference bar; "
        f"intgrid with DISCARD + 2 INTEGRABLE: charges {dq:.3e} e off the "
        f"slice phase's, $1 integrable {d1:.3e} e off the charge, launches "
        f"{launches}; Hirshfeld pops {np.round(hres.pops, 6).tolist()}; "
        f"XDM 64^3 card vs CPU {e_x:.3e}, E(256^3) {x256.energy:.10e} Ha; "
        f"Madelung {mad:.12f}; CUBE {size} bytes; STM card vs CPU "
        f"{e_stm:.3e}; RDF card vs CPU {e_rdf:.3e}")
    return out


def expr_wfn_leg(wf, card):
    """Phase 11b: integrals, xc and the hole functions on H2/STO-3G, its
    tiles and the assembly mesh of phase 9, card against the CPU."""
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis.mesh import becke_mesh
    from critic2_tpu_torch.analysis.molcalc import molcalc_integral
    from critic2_tpu_torch.analysis.xdm import xdm_wfn
    from critic2_tpu_torch.fields.wfn import Wavefunction
    from critic2_tpu_torch.ops.mdint import rhf_energy
    from critic2_tpu_torch.ops.xc import xc_eval

    out, walls = {}, {}
    s1 = wf.pop("_monomer")
    sa = wf.pop("_system")
    dev = s1.device
    w1 = s1.ref.wfn
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "h2.molden")
    with open(path, "w") as fh:
        fh.write(H2_MOLDEN)
    s1c = System.from_structure(path, device="cpu")
    s1c.load_field(path)

    # RHF: the monomer and a 2x2x2 tile card against CPU, the 4x4x2 tile
    e1, walls["rhf_h2_s"] = wall_s(lambda: rhf_energy(w1, device=dev))
    e1c = rhf_energy(w1, device="cpu")
    d1 = max(abs(e1[k] - e1c[k]) for k in e1)
    check(d1 <= 1e-10, f"rhf H2 card vs CPU {d1:.3e} Ha")
    w8 = Wavefunction.from_file(path).tile((2, 2, 2))
    e8, walls["rhf_tile222_s"] = wall_s(lambda: rhf_energy(w8, device=dev))
    d8 = max(abs(e8[k] - rhf_energy(w8, device="cpu")[k]) for k in e8)
    check(d8 <= 1e-9, f"rhf 2x2x2 tile card vs CPU {d8:.3e} Ha")
    wt = Wavefunction.from_file(path).tile(EXPR_TILE)
    npair = wt.npri * (wt.npri + 1) // 2
    torch.cuda.reset_peak_memory_stats()
    et, walls["rhf_tile442_s"] = wall_s(lambda: rhf_energy(wt, device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(v) for v in et.values()) and
          et["E_total"] < 0 and npair == 18528,
          f"rhf tile {EXPR_TILE}: {et}, npair {npair}")
    out["rhf"] = {"h2": e1, "h2_card_vs_cpu": d1, "tile222_card_vs_cpu": d8,
                  "tile442": et, "tile442_npri": wt.npri,
                  "tile442_npair": npair, "tile442_peak_gib": peak}

    # molcalc expressions on the ultra monomer mesh
    pbe = "xc($1, $1:g, 101) + xc($1, $1:g, 130)"
    mc = {}
    for expr in (pbe, "elf(1)", "elf(1) * $1"):
        v, t = wall_s(lambda: molcalc_integral(
            s1, expr, lvl="ultra", weights_dtype=np.float64))
        vc = molcalc_integral(s1c, expr, lvl="ultra",
                              weights_dtype=np.float64)
        mc[expr] = {"card": v, "cpu": vc, "rel": abs(v - vc) / abs(vc),
                    "wall_s": t}
    # the bare ELF integral sums the mesh's far tail, where ELF is the
    # ratio of two cancelling 1e-30-scale terms: it is reported, and
    # the density-weighted one is held to the bar
    check(mc[pbe]["rel"] <= 1e-10 and mc["elf(1) * $1"]["rel"] <= 1e-10,
          f"molcalc card vs CPU: {mc}")
    out["molcalc_monomer"] = mc

    # one xc expression on the assembly's 7.0M-point mesh of phase 9 (the
    # compiler evaluates the wavefunction densely), held against the same
    # sum from the screened evaluator and xc_eval called directly
    wa = sa.ref.wfn
    ncopy = len(wa.atz) // 2
    ea, walls["molcalc_pbe_assembly_s"] = wall_s(
        lambda: molcalc_integral(sa, pbe, lvl="normal"))

    def screened_sum():
        m = becke_mesh(sa.crystal, "normal", weights_dtype=np.float32,
                       device=dev)
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for lo in range(0, m.n, 1 << 17):
            xT = torch.as_tensor(
                np.ascontiguousarray(m.x[lo:lo + (1 << 17)].T),
                                 dtype=torch.float64, device=dev)
            f, gf, _ = wa.rho_eval_screened(xT, nder=1)
            gm = torch.sqrt((gf * gf).sum(0))
            wl = torch.as_tensor(np.asarray(m.w[lo:lo + xT.shape[1]],
                                            np.float64), device=dev)
            acc += wl @ (xc_eval(101, f, gm) + xc_eval(130, f, gm))
        return float(acc)

    es, walls["pbe_assembly_screened_s"] = wall_s(screened_sum)
    d_route = abs(ea - es) / abs(es)
    per_copy = ea / ncopy / mc[pbe]["card"] - 1.0
    check(np.isfinite(ea) and d_route <= 1e-10,
          f"PBE xc on the assembly {ea}, screened route {es}")
    out["molcalc_assembly"] = {"pbe_xc": ea, "screened_route": es,
                               "routes_rel": d_route,
                               "per_copy_over_monomer_minus_1": per_copy}

    # mep, uslater, xhole on 4,096 monomer points; mep on the 192-primitive
    # tile (its first 256 points against the CPU)
    rng = np.random.default_rng(41)
    pts = w1.atpos.mean(0) + rng.normal(size=(4096, 3))
    ptsT = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    holes = {}
    for name, fn in (("mep", lambda w, p: w.mep(p)),
                     ("uslater", lambda w, p: w.uslater(p)),
                     ("xhole", lambda w, p: w.xhole(p, [0.1, 0.0, 0.6]))):
        v, t = wall_s(lambda: fn(w1, ptsT))
        holes[name] = {"rel": rel_err(v.cpu(), fn(w1, ptsT.cpu())),
                       "wall_s": t}
    ptst = wt.atpos.mean(0) + 4.0 * rng.normal(size=(4096, 3))
    ptstT = torch.as_tensor(ptst, dtype=torch.float64, device=dev)
    vt, t = wall_s(lambda: wt.mep(ptstT))
    holes["mep_tile442"] = {"rel": rel_err(vt[:256].cpu(),
                                           wt.mep(ptstT[:256].cpu())),
                            "wall_s": t}
    check(max(v["rel"] for v in holes.values()) <= 1e-10,
          f"hole functions card vs CPU: {holes}")
    out["holes"] = holes

    # XDM of the monomer on its good mesh, card against CPU
    xw, walls["xdm_wfn_s"] = wall_s(lambda: xdm_wfn(s1))
    xwc = xdm_wfn(s1c)
    e_xw = abs(xw.energy - xwc.energy) / abs(xwc.energy)
    check(xw.energy < 0 and e_xw <= 1e-10,
          f"xdm_wfn card vs CPU {e_xw:.3e}, energy {xw.energy}")
    out["xdm_wfn"] = {"energy": xw.energy, "c6": xw.c6.tolist(),
                      "card_vs_cpu_rel": e_xw}
    out["walls_s"] = walls
    log(f"expression wavefunction leg ({card}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    log(f"  RHF H2 {e1['E_total']:.12f} Ha (card vs CPU {d1:.3e}); tile "
        f"{EXPR_TILE} ({wt.npri} primitives, npair {npair}): E_total "
        f"{et['E_total']:.10f}, E1 {et['E1']:.10f}, E_J {et['E_J']:.10f}, "
        f"E_K {et['E_K']:.10f}, E_nn {et['E_nn']:.10f} Ha, peak "
        f"{peak:.2f} GiB; 2x2x2 card vs CPU {d8:.3e}")
    log(f"  molcalc (ultra monomer): " + "; ".join(
        f"{k}: {v['card']:.12e} (card vs CPU {v['rel']:.3e}, "
        f"{v['wall_s']:.3f} s)" for k, v in mc.items()))
    log(f"  PBE xc on the assembly mesh: {ea:.10f} Ha (dense, through the "
        f"compiler) against {es:.10f} (screened, direct), {d_route:.3e} "
        f"apart; per copy {per_copy:+.3e} off the monomer (the copies' "
        f"tails overlap and xc is not additive); holes: " + "; ".join(
            f"{k} card vs CPU {v['rel']:.3e} ({v['wall_s']:.3f} s)"
            for k, v in holes.items()))
    log(f"  xdm_wfn: E {xw.energy:.10e} Ha, card vs CPU {e_xw:.3e}")
    return out


def expressions_phase(sl, wf, card):
    """Phase 11: the expression slice, both legs."""
    out = {"grid": expr_grid_leg(sl, card), "wfn": expr_wfn_leg(wf, card)}
    out["launches"] = out["grid"]["launches"]
    log(json.dumps({"expressions": out}, default=float))
    return out



# ---------------------------------------------------------------- phase 12
# The field formats: synthetic inputs written by this script's own
# writers (the repository holds no WIEN2k, elk, QE or DFTB+ output).

FMT_NK = (4, 4, 4)             # k-grid of realistic deloc runs
FMT_N = 72                     # their 60-100^3 FFT grids
FMT_NBND = 4
FMT_GMAX = 3                   # plane waves |G| <= 3 (reciprocal basis)
FMT_A = 10.0                   # cubic cell of the pwc leg (bohr)
EVAL_POINTS = 1 << 20          # evaluator points, nder=2
EVAL_CHUNK = 1 << 16           # ms are reported per this many points
EVAL_SUB = 4096                # card-against-CPU subsample
DFTB_POINTS = 1 << 17
DFTB_SUB = 512                 # the CPU's DFTB+ subsample (64 atoms)


def fmt_gvectors(gmax):
    import numpy as np

    r = np.arange(-gmax, gmax + 1)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return g[(g * g).sum(1) <= gmax * gmax]


def random_unitaries(rng, nks, nw):
    import numpy as np

    m = rng.normal(size=(nks, nw, nw)) + 1j * rng.normal(size=(nks, nw, nw))
    return np.linalg.qr(m)[0]


def write_pwc_file(path, at, nk, nbnd, n, rng, gmax):
    """A pw2critic.x pwc file (the record order of read_pwc,
    src/grid3mod@proc.f90:755-840): random orthonormal coefficients on
    the |G| <= gmax plane waves at every k-point of the nk grid, every
    band occupied once (occupation = k weight). Returns the fractional
    k-points."""
    import numpy as np

    from critic2_tpu_torch.fields.qe import FortranFile

    g = fmt_gvectors(gmax)
    ngms = len(g)
    nl = (1 + (g[:, 0] % n[0]) + n[0] * ((g[:, 1] % n[1])
          + n[1] * (g[:, 2] % n[2]))).astype(np.int32)
    nks = int(np.prod(nk))
    kf = np.stack(np.meshgrid(*[np.arange(k) / k for k in nk],
                              indexing="ij"), -1).reshape(-1, 3)
    wk = np.full(nks, 1.0 / nks)
    occ = np.tile(wk[:, None], (1, nbnd))
    evc = np.linalg.qr(rng.normal(size=(nks, ngms, nbnd))
                       + 1j * rng.normal(size=(nks, ngms, nbnd)))[0]
    with FortranFile(path, "wb") as fh:
        fh.write_record(np.int32(1))                     # version
        fh.write_record(np.array([1, 2], np.int32))      # nsp, nat
        fh.write_record(b"He")                           # atm
        fh.write_record(np.array([1, 1], np.int32))      # ityp
        fh.write_record(np.zeros(6))                     # tau
        fh.write_record(np.asarray(at, np.float64).flatten(order="F"))
        fh.write_record(np.array([nks, nbnd, 1, 0], np.int32))
        fh.write_record(np.asarray(nk, np.int32))
        fh.write_record(np.asarray(n, np.int32))
        fh.write_record(np.array([ngms, ngms], np.int32))
        fh.write_record((kf @ np.linalg.inv(at)).reshape(-1))
        fh.write_record(wk)
        fh.write_record(rng.normal(size=(nks, nbnd)).reshape(-1))
        fh.write_record(occ.reshape(-1))
        fh.write_record(np.full(nks, ngms, np.int32))
        fh.write_record(np.tile(np.arange(1, ngms + 1, dtype=np.int32),
                                (nks, 1)).reshape(-1))
        fh.write_record(nl)
        for ik in range(nks):
            for ib in range(nbnd):
                fh.write_record(evc[ik, :, ib].astype(np.complex128))
    return kf


def write_chk_file(path, nbnd, nk, kf, rlatt, u, centers, spreads):
    """A wannier90 .chk as read_wannier_chk walks it (centres Cartesian,
    spreads squared)."""
    import numpy as np

    from critic2_tpu_torch.fields.qe import FortranFile

    nks = len(kf)
    with FortranFile(path, "wb") as fh:
        fh.write_record(b" " * 33)
        fh.write_record(np.int32(nbnd))
        fh.write_record(np.int32(0))                     # excluded bands
        fh.write_record(b"")
        fh.write_record(np.asarray(rlatt, np.float64).flatten(order="F"))
        fh.write_record(2 * np.pi * np.linalg.inv(rlatt).T.flatten(order="F"))
        fh.write_record(np.int32(nks))
        fh.write_record(np.asarray(nk, np.int32))
        fh.write_record(kf.reshape(-1))
        fh.write_record(np.int32(8))                     # nntot
        fh.write_record(np.int32(u.shape[1]))
        fh.write_record(b" " * 20)
        fh.write_record(np.int32(0))                     # not disentangled
        fh.write_record(u.transpose(0, 2, 1).astype(np.complex128)
                        .reshape(-1))
        fh.write_record(np.zeros(2, np.complex128))      # m matrix
        fh.write_record(np.asarray(centers, np.float64).reshape(-1))
        fh.write_record(np.asarray(spreads, np.float64) ** 2)


def pwc_case(tmp, dev, nk, n, seed):
    """Write a pwc + chk pair, load it on `dev` (a 2-atom cubic cell) and
    run intgrid YT; returns the system, the integration result and the
    wall of the load."""
    import numpy as np

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis.integration import intgrid
    from critic2_tpu_torch.convert import crystal_from_arrays

    rng = np.random.default_rng(seed)
    at = np.eye(3) * FMT_A
    tag = "x".join(str(k) for k in nk) + f"-{n}"
    pwc = os.path.join(tmp, f"{tag}.pwc")
    chk = os.path.join(tmp, f"{tag}.chk")
    kf = write_pwc_file(pwc, at, nk, FMT_NBND, (n, n, n), rng, FMT_GMAX)
    frac = rng.uniform(0, 1, (FMT_NBND, 3)) * np.asarray(nk)
    write_chk_file(chk, FMT_NBND, nk, kf, at,
                   random_unitaries(rng, len(kf), FMT_NBND),
                   frac @ at.T, rng.uniform(1.5, 2.5, FMT_NBND))
    c = crystal_from_arrays(at, [[0.0] * 3, [0.5] * 3], [0, 0],
                            [("He", 2)])
    s = System.from_structure(c, device=dev)
    _, load_s = wall_s(lambda: s.load_field(pwc, file2=chk))
    res = intgrid(s, method="yt")
    return s, res, load_s


def deloc_bars(res, pop_yt, tag):
    """The sum rules of a deloc run: all 8 electrons, the YT basin
    populations, LI <= N (wancut drops only overlaps far below the
    bars here)."""
    import numpy as np

    pop = res.population()
    dtot = abs(pop.sum() - 2.0 * FMT_NBND)
    dyt = float(np.abs(pop - pop_yt).max())
    check(dtot <= 1e-6, f"{tag}: populations sum to {pop.sum():.9f} e")
    check(dyt <= 5e-6, f"{tag}: populations {dyt:.3e} e off YT's")
    check(np.all(res.li() <= pop + 1e-12), f"{tag}: LI > N")
    return dtot, dyt


def pwc_leg(dev, card):
    """Phase 12a: pwc -> YT -> deloc at nk 4x4x4 on a 72^3 grid (W is
    256 x 373,248 complex128 = 1.53 GB on the card), the reduced 2x2x2 /
    32^3 leg card against CPU, and the state cubes."""
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System, convert
    from critic2_tpu_torch.analysis.deloc import deloc_wannier
    from critic2_tpu_torch.analysis.rhoplot import cube_states
    from critic2_tpu_torch.fields.field import Field
    from critic2_tpu_torch.fields.grid3 import Grid3
    from critic2_tpu_torch.ops import yt_pass as ops

    out, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        s, ires, walls["read_pwc_s"] = pwc_case(tmp, dev, FMT_NK, FMT_N, 81)
        qe, decomp = s.ref.grid.qe, ires.decomp
        rho = s.ref.grid.f
        nattr = decomp.nattr
        scale = s.crystal.volume / rho.numel()
        pop_yt = decomp.integrate(rho.reshape(-1)) * scale
        log(f"formats: pwc nk {FMT_NK}, {FMT_N}^3, nbnd {FMT_NBND}, "
            f"|G| <= {FMT_GMAX} ({qe.igk_k.shape[1]} plane waves), nattr "
            f"{nattr}, read {walls['read_pwc_s']:.3f} s")
        out["nattr"] = nattr
        runs = (("u_wancut4", True, 4.0), ("nou", False, None))
        for tag, useu, wancut in runs:
            if torch.device(dev).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            stats = {}
            res, wall = wall_s(lambda: deloc_wannier(
                s.crystal, decomp, qe, useu=useu, wancut=wancut, device=dev,
                stats=stats))
            launches = dict(ops.launches)
            rec = {"wall_s": wall, **{f"{k}_s": v for k, v in stats.items()},
                   "launches": launches,
                   "launches_per_attractor": {k: v / nattr for k, v in
                                              launches.items()},
                   "pop_sum": float(res.population().sum()),
                   "pop_vs_yt": float(np.abs(res.population()
                                             - pop_yt).max())}
            if torch.device(dev).type == "cuda":
                rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                check(launches["yt_pass"] >= nattr
                      and launches["yt_gs_pass"] >= 16 * nattr,
                      f"deloc {tag} launches {launches} for {nattr} "
                      "attractors")
            check(np.all(np.isfinite(res.fa)), f"deloc {tag}: Fa not finite")
            rec["dtot"], rec["dyt"] = deloc_bars(res, pop_yt, f"deloc {tag}")
            out[tag] = rec
            log(f"formats: deloc useu={useu} wancut={wancut}: "
                f"{wall:.3f} s (supports {stats['support']:.3f}, Wannier "
                f"stack {stats['wannier']:.3f}, Sij {stats['sij']:.3f}, Fa "
                f"{stats['fa']:.3f}), launches {launches} = "
                f"{rec['launches_per_attractor']} per attractor, sum N "
                f"{rec['pop_sum']:.9f}, |N - N(YT)| max "
                f"{rec['pop_vs_yt']:.3e}, peak "
                f"{rec.get('peak_gib', float('nan')):.2f} GiB on {card}")
        out["launches"] = out["u_wancut4"]["launches"]

        # CUBE UNK/PSINK written, MLWF in memory; card against a CPU twin
        # of the same states (carried across by convert, no FFT redone)
        qc = convert.qedata_from_arrays(**convert.qedata_to_arrays(qe),
                                        device="cpu")
        sc = System.from_structure(s.crystal, device="cpu")
        sc.load_field(Field.from_grid(s.crystal, Grid3(rho.cpu(), qe=qc)))
        errs = {}
        for kind, write in (("unk", True), ("psink", True), ("mlwf", False)):
            root = os.path.join(tmp, "st")
            (a, files), w = wall_s(lambda: cube_states(
                s, kind, 1, ik=2, fileroot=root, write=write))
            b, _ = cube_states(sc, kind, 1, ik=2, write=False)
            errs[kind] = rel_err(a.cpu(), b)
            check(errs[kind] <= 1e-12,
                  f"CUBE {kind}: card and CPU differ by {errs[kind]:.3e}")
            check(len(files) == (2 if write else 0)
                  and all(os.path.getsize(p) > 0 for p in files),
                  f"CUBE {kind} files {files}")
            walls[f"cube_{kind}_s"] = w
        out["cube_rel_err"] = errs
        del a, b, sc, qc, s, ires, decomp, qe, rho
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

        # the reduced leg: Sij and Fa, card against CPU
        sij = {}
        for d in (dev, "cpu"):
            sd, rd, _ = pwc_case(tmp, d, (2, 2, 2), 32, 82)
            sij[str(d)] = deloc_wannier(sd.crystal, rd.decomp, sd.ref.grid.qe,
                                        useu=True, wancut=4.0, device=d)
        a, b = sij[str(dev)], sij["cpu"]
        check(a.nattr == b.nattr and np.array_equal(a.xattr, b.xattr),
              "reduced deloc: attractors differ between card and CPU")
        dS = float(np.abs(a.sij[0] - b.sij[0]).max())
        dF = float(np.abs(a.fa - b.fa).max())
        check(dS <= 1e-10 and dF <= 1e-10,
              f"reduced deloc: Sij {dS:.3e}, Fa {dF:.3e} card against CPU")
        out["reduced"] = {"nattr": a.nattr, "sij_err": dS, "fa_err": dF}
    out["walls_s"] = walls
    log(f"formats: CUBE unk/psink written, mlwf in memory, card = CPU "
        f"within {max(errs.values()):.3e}; reduced 2x2x2/32^3 deloc "
        f"(nattr {a.nattr}) Sij {dS:.3e}, Fa {dF:.3e} card against CPU")
    return out


# -- LAPW writers ---------------------------------------------------------

def wien_struct_text(a, atoms, jri, rnot, rmt):
    """A WIEN2k .struct in the reference's fixed formats: a cubic P cell,
    one inequivalent atom per entry of `atoms` (fractional positions,
    iatnr < 0: no cubic harmonics), the identity as the only operation."""
    lines = ["synthetic field",
             f"{'P':<4s}{'LATTICE,NONEQUIV.ATOMS':<23s}{len(atoms):>3d} NREL",
             "MODE OF CALC=RELA unit=bohr",
             f"{a:10.5f}{a:10.5f}{a:10.5f}{90.0:10.5f}{90.0:10.5f}"
             f"{90.0:10.5f}"]
    for i, p in enumerate(atoms):
        lines.append(f"ATOM{-(i + 1):>4d}: X={p[0]:10.7f} Y={p[1]:10.7f} "
                     f"Z={p[2]:10.7f}")
        lines.append(f"{'MULT=':>15s}{1:>2d}")
        lines.append(f"{'X' + str(i):<10s}{'NPT=':>5s}{jri:>5d}{'R0=':>5s}"
                     f"{rnot:10.8f}{'RMT=':>5s}{rmt:10.5f}{'Z:':>5s}"
                     f"{8.0:5.1f}")
        for j in range(3):
            lines.append(f"{'LOCAL ROT MATRIX:':<20s}" + "".join(
                f"{1.0 if k == j else 0.0:10.8f}" for k in range(3)))
    lines.append(f"{1:>4d}")
    for j in range(3):
        lines.append("".join(f"{1 if k == j else 0:2d}" for k in range(3))
                     + f"{0.0:10.5f}")
    lines.append(f"{1:>8d}")
    return "\n".join(lines) + "\n"


def wien_clmsum_text(tables, waves):
    """A clmsum: per atom a list of ((l1, m), radial values) and the plane
    waves ((k1, k2, k3), re, im), in readslm/readk's fixed formats."""
    import numpy as np

    lines = ["head1", "head2", "head3"]
    for lms in tables:
        lines += ["skip", f"{'NUMBER OF LM':<15s}{len(lms):>3d}", "skip",
                  "skip"]
        for (l1, m), vals in lms:
            lines.append(" " * 15 + f"{l1:3d}" + " " * 5 + f"{m:2d}")
            lines.append("skip")
            txt = np.char.mod("%19.12E", vals)
            for k in range(0, len(vals), 4):
                lines.append("   " + "".join(txt[k:k + 4]))
            lines += ["skip", "skip"]
        lines += ["skip"] * 4
    lines += ["skip", "skip", " " * 13 + f"{len(waves):6d}"]
    for k, re, im in waves:
        lines.append("   " + "".join(f"{v:5d}" for v in k)
                     + f"{re:19.12E}{im:19.12E}")
    return "\n".join(lines) + "\n"


def wien_cosine_files(d):
    """The field of tests/test_wien.py: rho = 2 + cos(q z), a = 8 bohr,
    RMT 2, JRI 401, the exact Rayleigh expansion inside the sphere."""
    import math

    import numpy as np
    from scipy.special import spherical_jn

    a, rmt, jri, rnot = 8.0, 2.0, 401, 1e-4
    q = 2 * math.pi / a
    r = rnot * np.exp(np.arange(jri) * math.log(rmt / rnot) / (jri - 1))
    lms = []
    for l in range(0, 13, 2):
        cl = (-1.0) ** (l // 2) * math.sqrt(4 * math.pi * (2 * l + 1)) \
            * spherical_jn(l, q * r)
        if l == 0:
            cl = (cl + 2.0 * math.sqrt(4 * math.pi)) * math.sqrt(4 * math.pi)
        lms.append(((l, 0), cl * r * r))
    waves = [((0, 0, 0), 2.0, 0.0), ((0, 0, 1), 0.5, 0.0),
             ((0, 0, -1), 0.5, 0.0)]
    st, cl = os.path.join(d, "cos.struct"), os.path.join(d, "cos.clmsum")
    with open(st, "w") as fh:
        fh.write(wien_struct_text(a, [(0.0, 0.0, 0.0)], jri, rnot, rmt))
    with open(cl, "w") as fh:
        fh.write(wien_clmsum_text([lms], waves))
    return cl, st, q, rmt


def smooth_radial(rng, r, scale):
    """A smooth random radial table r^2 sum_p c_p exp(-b_p r)."""
    import numpy as np

    c = rng.normal(size=3) * scale
    b = rng.uniform(0.5, 2.0, 3)
    return r * r * (c[None, :] * np.exp(-b[None, :] * r[:, None])).sum(1)


def wien_wide_files(d, rng):
    """Two inequivalent atoms, JRI 781, LM terms to l = 8 (81 a sphere,
    cosine and sine harmonics), 3,000 plane waves with complex
    coefficients."""
    import math

    import numpy as np

    a, rmt, jri, rnot = 10.0, 2.2, 781, 5e-5
    r = rnot * np.exp(np.arange(jri) * math.log(rmt / rnot) / (jri - 1))
    tables = []
    for _ in range(2):
        lms = [((0, 0), smooth_radial(rng, r, 1.0) + 2.0 * r * r)]
        for l in range(1, 9):
            lms.append(((l, 0), smooth_radial(rng, r, 0.3 / l)))
            for m in range(1, l + 1):
                lms.append(((l, m), smooth_radial(rng, r, 0.3 / l)))
                lms.append(((-l, m), smooth_radial(rng, r, 0.3 / l)))
        tables.append(lms)
    R = np.arange(-10, 11)
    k = np.stack(np.meshgrid(R, R, R, indexing="ij"), -1).reshape(-1, 3)
    k = k[np.argsort((k * k).sum(1), kind="stable")][:3000]
    amp = np.exp(-(k * k).sum(1) / 40.0)
    re = rng.normal(size=len(k)) * amp
    im = rng.normal(size=len(k)) * amp
    re[0], im[0] = 1.0, 0.0
    waves = [(tuple(int(v) for v in kk), x, y) for kk, x, y in zip(k, re, im)]
    st, cl = os.path.join(d, "wide.struct"), os.path.join(d, "wide.clmsum")
    with open(st, "w") as fh:
        fh.write(wien_struct_text(a, [(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)],
                                  jri, rnot, rmt))
    with open(cl, "w") as fh:
        fh.write(wien_clmsum_text(tables, waves))
    return cl, st


def frec(data: bytes) -> bytes:
    import struct as _st

    return _st.pack("<i", len(data)) + data + _st.pack("<i", len(data))


def elk_wide_files(d, rng):
    """GEOMETRY.OUT and STATE.OUT of one species, two atoms in a 10 bohr
    cubic cell: lmaxvr 7, nrmt 300, a 24^3 interstitial grid and ngvec
    3,000."""
    import math

    import numpy as np

    a, rmt, nr, r0, lmax, ngrid = 10.0, 2.2, 300, 5e-5, 7, (24, 24, 24)
    with open(os.path.join(d, "GEOMETRY.OUT"), "w") as fh:
        fh.write("\navec\n" + "".join(
            "  " + "  ".join(f"{a if i == j else 0.0:.10f}" for i in range(3))
            + "\n" for j in range(3))
            + "\natoms\n   1   : nspecies\n'X.in'\n   2   : natoms\n"
            "  0.0 0.0 0.0  0.0 0.0 0.0\n  0.5 0.5 0.5  0.0 0.0 0.0\n")
    r = r0 * np.exp(np.arange(nr) * math.log(rmt / r0) / (nr - 1))
    lmmax = (lmax + 1) ** 2
    rhomt = np.zeros((lmmax, nr, 2))
    for ia in range(2):
        for k in range(lmmax):
            rhomt[k, :, ia] = (smooth_radial(rng, r, 1.0 / (1 + k)) / (r * r)
                               + (2.0 * math.sqrt(4 * math.pi)
                                  if k == 0 else 0.0))
    x = [np.arange(n) / n for n in ngrid]
    X, Y, Z = np.meshgrid(*x, indexing="ij")
    rho_g = 2.0 + 0.3 * np.cos(2 * np.pi * X) * np.sin(4 * np.pi * Y) \
        + 0.2 * np.cos(2 * np.pi * (Y + 2 * Z))

    def ints(*v):
        return frec(np.asarray(v, dtype="<i4").tobytes())

    def flts(v):
        return frec(np.asarray(v, dtype="<f8").tobytes())

    blob = (ints(9, 5, 14) + ints(0) + ints(1) + ints(lmmax) + ints(nr)
            + ints(nr) + ints(2) + ints(nr) + flts(r) + ints(nr) + flts(r)
            + ints(*ngrid) + ints(3000) + ints(0) + ints(1) + ints(0)
            + ints(0) + ints(0) + ints(0)
            + flts(np.concatenate([rhomt.reshape(-1, order="F"),
                                   rho_g.reshape(-1, order="F")])))
    with open(os.path.join(d, "STATE.OUT"), "wb") as fh:
        fh.write(blob)
    return (os.path.join(d, "STATE.OUT"), os.path.join(d, "GEOMETRY.OUT"))


def away_from_spheres(x, pos, P, rmt, nodes, h):
    """Mask of points whose central-difference stencil (step h) stays on
    one side of every sphere and between two radial nodes of the log
    grid (the 4-node radial stencil switches there)."""
    import numpy as np

    ok = np.ones(len(x), bool)
    Pinv = np.linalg.inv(P)
    for p in pos:
        f = (x - p) @ Pinv.T
        dc = (f - np.rint(f)) @ P.T
        r = np.linalg.norm(dc, axis=1)
        ok &= np.abs(r - rmt) > 20 * h
        t = np.log(np.maximum(r, nodes[0]) / nodes[0]) / nodes[1]
        dnode = np.abs(t - np.rint(t)) * r * nodes[1]
        ok &= (r >= rmt) | (dnode > 20 * h)
    return ok


def eval_leg(name, field_dev, field_cpu, x, dev, card, fd=None):
    """nder=2 at every point of x in chunks of EVAL_CHUNK (the ms per
    chunk reported), the card against the CPU on EVAL_SUB points, and,
    with fd = (mask, h), the Hessian against central differences of the
    card's own gradient on the subsample points the mask keeps."""
    import numpy as np
    import torch

    xd = torch.as_tensor(x, dtype=torch.float64, device=dev)
    outs = []
    field_dev.grd(xd[:64], nder=2)                  # warm: first launches

    def run():
        outs.clear()
        for lo in range(0, len(x), EVAL_CHUNK):
            outs.append(field_dev.grd(xd[lo:lo + EVAL_CHUNK], nder=2))

    _, w = wall_s(run)
    f = torch.cat([o[0] for o in outs])
    check(bool(torch.isfinite(f).all()), f"{name}: non-finite values")
    sub = x[:EVAL_SUB]
    a = [torch.cat([o[i] for o in outs], dim=-1)[..., :EVAL_SUB]
         for i in range(3)]
    b = field_cpu.grd(sub, nder=2)
    ev, eg, eh = (rel_err(a[i].cpu(), b[i]) for i in range(3))
    check(ev <= 1e-12 and eg <= 1e-10 and eh <= 1e-10,
          f"{name}: card against CPU value {ev:.3e}, gradient {eg:.3e}, "
          f"Hessian {eh:.3e}")
    rec = {"ms_per_65536": 1e3 * w * EVAL_CHUNK / len(x), "points": len(x),
           "err_value": ev, "err_grad": eg, "err_hess": eh}
    if fd is not None:
        mask, h = fd
        xs = sub[mask]
        H = np.zeros((len(xs), 3, 3))
        for k in range(3):
            e = np.zeros(3)
            e[k] = h
            gp = field_dev.grd(xs + e, nder=1)[1].cpu().numpy()
            gm = field_dev.grd(xs - e, nder=1)[1].cpu().numpy()
            H[:, :, k] = ((gp - gm) / (2 * h)).T
        h6 = a[2][:, mask].cpu().numpy()       # [xx, xy, xz, yy, yz, zz]
        mat = h6[[0, 1, 2, 1, 3, 4, 2, 4, 5]].T.reshape(-1, 3, 3)
        rec["err_fd"] = float(np.abs(mat - H).max() / np.abs(H).max())
        rec["fd_points"] = int(mask.sum())
        check(rec["err_fd"] <= 1e-6, f"{name}: Hessian against central "
              f"differences {rec['err_fd']:.3e} relative")
    log(f"formats: {name} nder=2 {1e3 * w * EVAL_CHUNK / len(x):.3f} ms per "
        f"65,536 points ({len(x)} points, {w:.3f} s) on {card}; card = CPU "
        f"value {ev:.3e}, gradient {eg:.3e}, Hessian {eh:.3e}"
        + (f"; Hessian = central differences {rec['err_fd']:.3e} on "
           f"{rec['fd_points']} points" if fd is not None else ""))
    return rec, a


def lapw_leg(dev, card, npts):
    """Phase 12b: the WIEN2k (cosine field and the wide pair) and elk
    evaluators."""
    import math
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.fields.elk import ElkField
    from critic2_tpu_torch.fields.wien import WienField

    rng = np.random.default_rng(83)
    out = {}
    h = 1e-4
    with tempfile.TemporaryDirectory() as d:
        # the cosine field: exact values, and d2/dz2 at hf[2, 2]
        cl, st, q, rmt = wien_cosine_files(d)
        wd = WienField.from_files(cl, st, device=dev)
        wc = WienField.from_files(cl, st, device="cpu")
        x = rng.uniform(0, 8.0, (npts, 3))
        pos = np.zeros((1, 3))
        mask = away_from_spheres(x[:EVAL_SUB], pos, np.eye(3) * 8.0, rmt,
                                 (1e-4, math.log(rmt / 1e-4) / 400), h)
        out["wien_cosine"], a = eval_leg("WIEN2k cosine", wd, wc, x, dev,
                                         card, (mask, h))
        f = a[0].cpu().numpy()
        r = np.linalg.norm((x[:EVAL_SUB] + 4.0) % 8.0 - 4.0, axis=1)
        exact = 2.0 + np.cos(q * x[:EVAL_SUB, 2])
        inter = r > rmt + 1e-6
        dval = float(np.abs(f - exact)[inter].max())
        dmt = float(np.abs(f - exact)[~inter].max())
        s = System.from_structure(st, device=dev)
        s.load_field(cl)
        hf = s.ref.grd(x[:EVAL_SUB][inter], nder=2).hf.cpu().numpy()
        dzz = float(np.abs(hf[:, 2, 2] + q * q * np.cos(
            q * x[:EVAL_SUB][inter][:, 2])).max())
        check(dval <= 1e-8 and dmt <= 1e-6 and dzz <= 1e-8,
              f"WIEN2k cosine: value {dval:.3e} (interstitial), {dmt:.3e} "
              f"(spheres), d2/dz2 at hf[2,2] {dzz:.3e}")
        out["wien_cosine"].update(exact_inter=dval, exact_mt=dmt,
                                  hzz_exact=dzz)
        log(f"formats: WIEN2k cosine rho = 2 + cos(qz) within {dval:.3e} "
            f"(interstitial) / {dmt:.3e} (spheres); Field hf[2,2] = "
            f"-q^2 cos(qz) within {dzz:.3e}")
        del wd, wc, s

        # the wide pair
        cl, st = wien_wide_files(d, rng)
        wd = WienField.from_files(cl, st, device=dev)
        wc = WienField.from_files(cl, st, device="cpu")
        x = rng.uniform(0, 10.0, (npts, 3))
        pos = np.array([[0.0] * 3, [5.0] * 3])
        mask = away_from_spheres(x[:EVAL_SUB], pos, np.eye(3) * 10.0, 2.2,
                                 (5e-5, math.log(2.2 / 5e-5) / 780), h)
        out["wien_wide"], _ = eval_leg("WIEN2k wide (2 atoms, JRI 781, "
                                       "l <= 8, 3,000 waves)", wd, wc, x,
                                       dev, card, (mask, h))
        del wd, wc

        # elk
        state, geom = elk_wide_files(d, rng)
        ed = ElkField.from_files(state, geom, device=dev)
        ec = ElkField.from_files(state, geom, device="cpu")
        mask = away_from_spheres(x[:EVAL_SUB], pos, np.eye(3) * 10.0, 2.2,
                                 (5e-5, math.log(2.2 / 5e-5) / 299), h)
        out["elk"], _ = eval_leg("elk (lmaxvr 7, nrmt 300, ngvec 3,000)",
                                 ed, ec, x, dev, card, (mask, h))
        del ed, ec
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


ION_HE = """ PI7 STO
 He ground state, 2 STO fit
 HE        2.0
 1
 2
 1 1
 1.45 2.9
 1
 2.0
 -0.918
 0.8 0.3
"""

ION_LI = """ STO
 Li ion
 LI        3.0
 2
 2 1
 1 1 2
 2.7 4.5 0.65
 1 1
 2.0 1.0
 -2.5 -0.2
 0.9 0.2
 1.0
"""


class PiShim:
    """grd of a PiField in the (f, grad (3, N), hess6) form eval_leg
    reads, the Hessian rows [xx, xy, xz, yy, yz, zz]."""

    def __init__(self, pf):
        self.pf = pf

    def grd(self, x, nder=2):
        f, g, h = self.pf.eval(x, nder=nder)
        return f, g.T, h[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T


def pi_leg(dev, card, npts):
    """Phase 12c: the aiPI ions of tests/test_pi.py in the rocksalt
    primitive cell; 1M points, and autocp card against CPU (Poincare-Hopf
    0, the same CP list)."""
    import tempfile

    import numpy as np

    from critic2_tpu_torch import System
    from critic2_tpu_torch.analysis.autocp import autocp
    from critic2_tpu_torch.convert import (cplist_to_arrays,
                                           crystal_from_arrays)
    from critic2_tpu_torch.fields.pi import PiField

    a = 8.0
    m = 0.5 * a * (np.ones((3, 3)) - np.eye(3))
    c = crystal_from_arrays(m, [[0.0] * 3, [0.5] * 3], [0, 1],
                            [("He", 2), ("Li", 3)])
    with tempfile.TemporaryDirectory() as d:
        ions = {}
        for name, text in (("He", ION_HE), ("Li", ION_LI)):
            ions[name] = os.path.join(d, f"{name}.ion")
            with open(ions[name], "w") as fh:
                fh.write(text)
        pd = PiField.from_files(c, ions, device=dev)
        pc = PiField.from_files(c, ions, device="cpu")
        x = np.random.default_rng(84).uniform(0, 1, (npts, 3)) @ m.T
        rec, _ = eval_leg(f"aiPI ({pd.atpos.shape[0]} ion images)",
                          PiShim(pd), PiShim(pc), x, dev, card)
        cps = {}
        for tag, dv in (("card", dev), ("cpu", "cpu")):
            s = System.from_structure(c, device=dv)
            s.load_field_pi(ions)
            cps[tag], rec[f"autocp_{tag}_s"] = wall_s(lambda: autocp(s))
    cpl = cps["card"]
    ph = cpl.poincare_hopf()
    check(ph == 0, f"aiPI autocp Poincare-Hopf {ph}")
    check(tuple(cpl.counts()) == tuple(cps["cpu"].counts()),
          f"aiPI autocp counts {cpl.counts()} against the CPU's "
          f"{cps['cpu'].counts()}")
    dcp = match_cps(c, cplist_to_arrays(cpl), cplist_to_arrays(cps["cpu"]),
                    1e-8)
    rec.update(counts=list(cpl.counts()), ph=ph, cp_dmax_bohr=dcp)
    log(f"formats: aiPI autocp counts {cpl.counts()}, Poincare-Hopf 0, the "
        f"CPU's list within {dcp:.3e} bohr; {rec['autocp_card_s']:.3f} s "
        f"on the card, {rec['autocp_cpu_s']:.3f} s on the CPU")
    return rec


def dftb_files(d, rng, isreal):
    """detailed.xml, eigenvec.bin and wfc.hsd of the test_dftb.py basis
    (H, one s orbital, cutoff 5.5) on a 4x4x4 supercell of its 4 bohr
    cell: 64 atoms, 64 orbitals, 32 states occupied twice; Gamma with
    real eigenvectors, or two k-points with complex ones."""
    import numpy as np

    with open(os.path.join(d, "wfc.hsd"), "w") as fh:
        fh.write("H {\n  AtomicNumber = 1\n  Orbital {\n"
                 "    AngularMomentum = 0\n    Occupation = 1.0\n"
                 "    Cutoff = 5.5\n    Exponents { 0.9 2.1 }\n"
                 "    Coefficients {\n      0.7 0.2\n      0.4 -0.1\n"
                 "    }\n  }\n}\n")
    kpts = ([(0.0, 0.0, 0.0, 1.0)] if isreal
            else [(0.0, 0.0, 0.0, 0.5), (0.5, 0.25, 0.0, 0.5)])
    occ = " ".join(["2.0"] * 32 + ["0.0"] * 32)
    blocks = "\n".join(f" <k{i + 1}>\n  {occ}\n </k{i + 1}>"
                       for i in range(len(kpts)))
    with open(os.path.join(d, "detailed.xml"), "w") as fh:
        fh.write(f"<detailedout>\n <real>{'yes' if isreal else 'no'}</real>\n"
                 f" <nrofkpoints>{len(kpts)}</nrofkpoints>\n"
                 " <nrofspins>1</nrofspins>\n <nrofstates>64</nrofstates>\n"
                 " <nroforbitals>64</nroforbitals>\n <kpointsandweights>\n"
                 + "\n".join("  %.10f %.10f %.10f %.10f" % k for k in kpts)
                 + f"\n </kpointsandweights>\n <occupations>\n{blocks}\n"
                 " </occupations>\n</detailedout>\n")
    recs = [frec(np.int32(1).tobytes())]
    for _ in kpts:
        if isreal:
            v = np.linalg.qr(rng.normal(size=(64, 64)))[0]
            recs += [frec(v[:, j].astype("<f8").tobytes()) for j in range(64)]
        else:
            v = random_unitaries(rng, 1, 64)[0]
            recs += [frec(v[:, j].astype("<c16").tobytes())
                     for j in range(64)]
    with open(os.path.join(d, "eigenvec.bin"), "wb") as fh:
        fh.write(b"".join(recs))
    return [os.path.join(d, f) for f in ("detailed.xml", "eigenvec.bin",
                                         "wfc.hsd")]


def dftb_leg(dev, card, npts):
    """Phase 12d: DFTB+ on a 64-atom cell, Gamma-real and complex-k, at
    131,072 points; gkin and elf of expressions card against CPU."""
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch import System
    from critic2_tpu_torch.convert import crystal_from_arrays

    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) / 4.0
    c = crystal_from_arrays(np.eye(3) * 16.0, g, np.zeros(64, int),
                            [("H", 1)])
    rng = np.random.default_rng(85)
    out = {}
    x = rng.uniform(0, 16.0, (npts, 3))
    sub = x[:DFTB_SUB]
    for kind in ("real", "complex"):
        with tempfile.TemporaryDirectory() as d:
            files = dftb_files(d, rng, kind == "real")
            sd = System.from_structure(c, device=dev)
            sd.load_field(files[0], file2=files[1], file3=files[2])
            sc = System.from_structure(c, device="cpu")
            sc.load_field(files[0], file2=files[1], file3=files[2])
        xd = torch.as_tensor(x, dtype=torch.float64, device=dev)
        sd.ref.dftb.eval(xd[:64], nder=2)           # warm: tables, jvp
        res, w = wall_s(lambda: sd.ref.dftb.eval(xd, nder=2, block=16384))
        check(all(bool(torch.isfinite(t).all()) for t in res),
              f"DFTB+ {kind}: non-finite values")
        ref = sc.ref.dftb.eval(sub, nder=2, block=DFTB_SUB)
        errs = [rel_err(a[:DFTB_SUB].cpu(), b) for a, b in zip(res, ref)]
        check(errs[0] <= 1e-12 and max(errs[1:]) <= 1e-10,
              f"DFTB+ {kind}: card against CPU {errs}")
        ex = {}
        for e in ("gkin(1)", "elf(1)"):
            ex[e] = rel_err(sd.eval_expr(e, sub).cpu(), sc.eval_expr(e, sub))
            check(ex[e] <= 1e-10, f"DFTB+ {kind} {e}: card against CPU "
                  f"{ex[e]:.3e}")
        out[kind] = {"ms_per_65536": 1e3 * w * EVAL_CHUNK / npts,
                     "points": npts, "err_rho": errs[0],
                     "err_derivs": max(errs[1:]), "expr_err": ex}
        log(f"formats: DFTB+ {kind} (64 atoms) nder=2 "
            f"{out[kind]['ms_per_65536']:.3f} ms per 65,536 points "
            f"({npts} points, {w:.3f} s) on {card}; card = CPU rho "
            f"{errs[0]:.3e}, derivatives {max(errs[1:]):.3e} on {DFTB_SUB} "
            f"points; gkin {ex['gkin(1)']:.3e}, elf {ex['elf(1)']:.3e}")
        del sd, sc, res
    return out


def formats_phase(dev, card, npts=EVAL_POINTS, dftb_npts=DFTB_POINTS):
    """Phase 12: the remaining field formats."""
    out = {}
    for name, fn in (("pwc", lambda: pwc_leg(dev, card)),
                     ("lapw", lambda: lapw_leg(dev, card, npts)),
                     ("pi", lambda: pi_leg(dev, card, npts)),
                     ("dftb", lambda: dftb_leg(dev, card, dftb_npts))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name + "_s"] = time.perf_counter() - t0
        log(f"formats: {name} leg {out[name + '_s']:.1f} s")
    out["launches"] = out["pwc"]["launches"]
    log(json.dumps({"formats": out}, default=float))
    return out


# ---------------------------------------------------------------- phase 13
# The sharded path and the keyword REPL: a virtual mesh of 8 shards on the
# card (space 4 x points 2), every halo and transpose moved between tensors
# of one device.
N_MESH = 8
N_JACOBI = 64                  # rasterization of the gs-against-jacobi check
CLI_STEPS = ("crystal", "load", "auto", "cpreport", "yt", "integrable", "yt",
             "sum")


def sharded_yt_leg(sl, mesh):
    """intgrid(mesh=) at 256^3 against the slice phase's single-device
    charges, its labels against one device's, one padded-slab sweep pair
    against the plain version, Jacobi against Gauss-Seidel at 64^3."""
    import numpy as np
    import torch

    from critic2_tpu_torch.analysis.integration import (_rasterize_field,
                                                        intgrid)
    from critic2_tpu_torch.analysis.yt import yt_integrate
    from critic2_tpu_torch.ops import yt_pass as ops
    from critic2_tpu_torch.parallel.mesh import gather, halo_pad
    from critic2_tpu_torch.parallel.yt_sharded import yt_integrate_sharded

    s = sl["system"]
    c = s.crystal
    g = s.ref.grid.f
    n = N_SLICE
    dv = c.volume / n ** 3
    out = {}

    # 1. intgrid(mesh=); the launches counted in this call alone
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    r, out["intgrid_s"] = wall_s(lambda: intgrid(s, method="yt", mesh=mesh))
    launches = dict(ops.launches)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    sh = r.decomp
    sv = sh._solver
    stats = dict(sv.stats)
    nspace = mesh.shape["space"]
    log(f"sharded intgrid {n}^3 on {nspace} slabs of {sv.m} planes (halo "
        f"{sv.H}): {out['intgrid_s']:.3f} s, solver {stats}, launches "
        f"{launches}, peak device memory {out['peak_gib']:.2f} GiB, nattr "
        f"{r.nattr_raw}")
    log(r.table())
    check(launches["yt_gs_pass"] >= 2 * nspace * stats["outer_iters"],
          f"sharded intgrid launched {launches['yt_gs_pass']} yt_gs_pass, "
          f"fewer than 2 per shard per outer iteration")
    check(r.nattr_raw == sl["nattr"], f"sharded nattr {r.nattr_raw}")
    q1 = {row.atom: row.pop for row in sl["intres"].rows}
    check(sorted(row.atom for row in r.rows) == sorted(q1),
          "sharded basins differ from the slice phase's")
    dq = max(abs(row.pop - q1[row.atom]) for row in r.rows)
    q = np.array([row.pop for row in r.rows])
    punity = abs(q.sum() - float(g.sum()) * dv)
    log(f"sharded intgrid: per-basin |q - q(one device)| max {dq:.3e} e, "
        f"partition of unity {punity:.3e} e")
    check(dq <= 1e-8, f"sharded charges differ by {dq:.3e} e")
    check(punity <= 1e-8, f"sharded partition of unity {punity:.3e} e")
    out.update(stats=stats, launches_intgrid=launches, dq_e=dq,
               punity_e=punity)

    # 2. labels against one device's, except at ties of two weights
    one = yt_integrate(c, g)
    t0 = time.perf_counter()
    lab = sh.labels
    out["labels_s"] = time.perf_counter() - t0
    one_lab, t_one = wall_s(lambda: one.labels)
    diff = np.flatnonzero(lab.reshape(-1) != one_lab.reshape(-1))
    # every basin's weight grid (nattr <= 8: one forward solve); where
    # the two largest tie within 1e-12
    w = gather(sh._basin_chunk(0, sh.nattr), dim=1).reshape(sh.nattr, -1)
    top = torch.topk(w, 2, dim=0).values
    tie = ((top[0] - top[1]) <= 1e-12).cpu().numpy()
    del top
    ntie = int(tie[diff].sum())
    # phase 14 holds one device's labels to the sequential sweep's
    check(np.array_equal(np.asarray(one.iattr), sl["iattr"]),
          "one device's attractors differ from the slice phase's")
    sl["yt_host"] = {"labels": one_lab, "iattr": sl["iattr"],
                     "labels_s": t_one, "tie": tie}
    log(f"sharded labels ({out['labels_s']:.3f} s, nboundary "
        f"{sh.nboundary}, one device {one.nboundary}): {len(diff)} points "
        f"differ from one device's, {ntie} of them ties within 1e-12")
    check(ntie == len(diff), f"{len(diff) - ntie} labels differ off a tie")
    out.update(labels_differ=len(diff), nboundary=sh.nboundary)
    del one

    # 3. one padded-slab sweep pair (f64, shard 0) against the plain
    # version: from f, and from the solution (the fixpoint, flags 0)
    H, m = sv.H, sv.m
    f3 = torch.stack([torch.ones_like(g), g])
    op = sv.operand(True)[0]
    fs = sv._slabs(f3)
    sol = sv.solve(f3, adjoint=True)
    for tag, state in (("from f", fs), ("from the solution", sol)):
        sp = halo_pad(state, H, H, dim=1)[0]
        fp = sp.clone()
        fp[:, H:H + m] = fs[0]
        pairs = []
        for gs in (ops.yt_gs_pass, ops.yt_gs_pass_plain):
            def pair():
                a, c1 = gs(op, sp, fp, offs=sv.offs, backward=False)
                b, c2 = gs(op, a, fp, offs=sv.offs, backward=True)
                return b, (int(c1), int(c2))
            pairs.append(wall_s(pair))
        (bk, fk), tk = pairs[0]
        (bp, fpl), tp = pairs[1]
        same = torch.equal(bk, bp) and fk == fpl
        halo = torch.equal(bk[:, :H], sp[:, :H]) and \
            torch.equal(bk[:, H + m:], sp[:, H + m:])
        log(f"padded slab {tuple(sp.shape)} f64 sweep pair {tag}: kernel "
            f"{tk * 1e3:.3f} ms, plain {tp * 1e3:.1f} ms, flags {fk} / "
            f"{fpl}, bitwise equal {same}, halo planes unchanged {halo}")
        check(same, f"padded-slab pair {tag} differs from its plain version")
        check(halo, f"padded-slab pair {tag} changed a halo plane")
        if tag == "from the solution":
            check(fk == (0, 0) and torch.equal(bk, sp),
                  "the sharded solution is not a fixpoint of the kernel")
        out["pair_" + tag.split()[-1] + "_ms"] = [tk * 1e3, tp * 1e3]
    del sol, fs, f3

    # 4. Jacobi against Gauss-Seidel on a 64^3 rasterization; the
    # launches of the Jacobi solve alone
    g64 = _rasterize_field(s.fields[0], (N_JACOBI,) * 3)
    f64 = torch.stack([torch.ones_like(g64), g64]).reshape(2, -1)
    qs = {}
    for method in ("gs", "jacobi"):
        res = yt_integrate_sharded(mesh, c, g64, result=True, method=method)
        ops.reset_launches()
        qs[method], t = wall_s(lambda: res.integrate(f64))
        out[method + "_64"] = {"s": t, "stats": dict(res._solver.stats),
                               "launches": dict(ops.launches)}
        log(f"sharded {method} {N_JACOBI}^3: {t:.3f} s, "
            f"{res._solver.stats}, launches {dict(ops.launches)}")
    dj = float(np.abs(qs["gs"] - qs["jacobi"]).max()) \
        * c.volume / N_JACOBI ** 3
    log(f"sharded {N_JACOBI}^3: |q(jacobi) - q(gs)| max {dj:.3e} e")
    check(dj <= 1e-10, f"jacobi against gs {dj:.3e} e")
    out["dq_jacobi_e"] = dj
    out["launches"] = {k: launches[k] + out["jacobi_64"]["launches"][k]
                       for k in launches}
    for k, v in out["launches"].items():
        check(v > 0, f"the sharded path launched no {k}")
    return out, sh, w


def sharded_eval_leg(s, mesh):
    """sharded_eval_fn at 1,048,576 points against interp_soa."""
    import numpy as np
    import torch

    from critic2_tpu_torch.ops.interp import interp_soa, sym6_to_mat
    from critic2_tpu_torch.parallel.sharded import sharded_eval_fn

    g = s.ref.grid.f
    c = s.crystal
    gen = torch.Generator(device=g.device).manual_seed(13)
    npts = 1 << 20
    xf = torch.rand((npts, 3), generator=gen, dtype=g.dtype, device=g.device)
    m_x2c = torch.as_tensor(c.m_x2c, dtype=g.dtype, device=g.device)
    m_c2x = torch.as_tensor(c.m_c2x, dtype=g.dtype, device=g.device)
    pts = xf @ m_x2c.T
    w = torch.rand(npts, generator=gen, dtype=g.dtype, device=g.device)
    fn = sharded_eval_fn(mesh, tuple(g.shape), c.m_c2x, c.m_x2c, nder=2)
    (fv, gf, hf, wsum), t_sh = wall_s(lambda: fn(g, pts, w))
    (y, yp, ypp), t_one = wall_s(lambda: interp_soa(g, m_c2x @ pts.T))
    gref = yp.T @ m_c2x
    href = torch.einsum("ki,nkl,lj->nij", m_c2x, sym6_to_mat(ypp), m_c2x)
    errs = {k: rel_err(a, b) for k, a, b in (("f", fv, y), ("grad", gf, gref),
                                             ("hess", hf, href))}
    dw = abs(float(wsum) - float((w * y).sum())) / abs(float(wsum))
    log(f"sharded_eval_fn {npts} points: {t_sh:.3f} s (interp_soa on one "
        f"device {t_one:.3f} s); relative to each quantity's largest "
        f"magnitude: f {errs['f']:.3e}, grad {errs['grad']:.3e}, Hessian "
        f"{errs['hess']:.3e}; wsum {dw:.3e}")
    for k, bar in (("f", 1e-12), ("grad", 1e-11), ("hess", 1e-10)):
        check(errs[k] <= bar, f"sharded_eval_fn {k} off by {errs[k]:.3e}")
    check(dw <= 1e-12, f"sharded_eval_fn wsum off by {dw:.3e}")
    return {"s": t_sh, "interp_soa_s": t_one, "rel_err": errs,
            "wsum_rel": dw}


def grid_ops_leg(s, mesh, sh, w):
    """ShardedGridOps at 256^3 f64 against ops/fft on the card, nci_grids
    against the single-device FFT Hessian, basin_reduce_sharded against
    index_add_ on one device with the sharded YT weights w (nattr, N)."""
    import numpy as np
    import torch

    from critic2_tpu_torch.ops import fft as fftops
    from critic2_tpu_torch.ops.eig3 import eigvalsh3s
    from critic2_tpu_torch.parallel.grid_ops import (ShardedGridOps,
                                                     basin_reduce_sharded)
    from critic2_tpu_torch.parallel.mesh import gather

    g = s.ref.grid.f
    m = s.crystal.m_x2c
    sops = ShardedGridOps(mesh, tuple(g.shape), m)
    slabs = sops._slabs(g)
    out = {}
    pairs = {
        "lap": (sops.laplacian, lambda f: fftops.laplacian(f, m)),
        "gradrho": (sops.gradrho, lambda f: fftops.gradrho(f, m)),
        "pot": (sops.pot, lambda f: fftops.pot(f, m)),
    }
    for ix in range(3):
        pairs[f"hxx{ix + 1}"] = (lambda f, ix=ix: sops.hxx(f, ix),
                                 lambda f, ix=ix: fftops.hxx(f, m, ix))
    for name, (sh_fn, one_fn) in pairs.items():
        e = rel_err(gather(sh_fn(slabs)), one_fn(g))
        ms = (cuda_ms(lambda: sh_fn(slabs), 2), cuda_ms(lambda: one_fn(g), 2))
        out[name] = {"rel_err": e, "ms": ms[0], "one_device_ms": ms[1]}
        log(f"sharded {name} {N_SLICE}^3 f64: {ms[0]:.3f} ms (one device "
            f"{ms[1]:.3f} ms), rel {e:.3e}")
        check(e <= 1e-10, f"sharded {name} off by {e:.3e}")
    comps = sops.grad_components(slabs)
    ref = fftops.grad_components(g, m)
    e = max(rel_err(gather(comps[a]), ref[a]) for a in range(3))
    ms = (cuda_ms(lambda: sops.grad_components(slabs), 2),
          cuda_ms(lambda: fftops.grad_components(g, m), 2))
    out["grad_components"] = {"rel_err": e, "ms": ms[0],
                              "one_device_ms": ms[1]}
    log(f"sharded grad_components: {ms[0]:.3f} ms (one device {ms[1]:.3f} "
        f"ms), rel {e:.3e}")
    check(e <= 1e-10, f"sharded grad_components off by {e:.3e}")
    del comps, ref

    # nci_grids against the single-device FFT-Hessian route
    (rho_s, rdg_s, sl2_s), t_nci = wall_s(lambda: sops.nci_grids(slabs))
    rho_s, rdg_s, sl2_s = gather(rho_s), gather(rdg_s), gather(sl2_s)
    gk = fftops.gvectors(g.shape, m, device=g.device)
    fk = torch.fft.fftn(g)
    h6 = torch.stack([torch.fft.ifftn(-gk[..., a] * gk[..., b] * fk).real
                      .reshape(-1) for a, b in ((0, 0), (1, 1), (2, 2),
                                                (0, 1), (0, 2), (1, 2))])
    del gk, fk
    lam2 = eigvalsh3s(h6)[1].reshape(g.shape)
    del h6
    rho = g.abs()
    rdg = fftops.gradrho(g, m) / (2.0 * (3.0 * np.pi ** 2) ** (1 / 3)
                                  * torch.clamp(rho, min=1e-30) ** (4 / 3))
    ok = lam2.abs() > 1e-8
    e_rho = rel_err(rho_s, rho)
    e_rdg = rel_err(rdg_s, rdg)
    e_sl2 = rel_err(sl2_s[ok], (torch.sign(lam2) * rho)[ok])
    log(f"sharded nci_grids {N_SLICE}^3: {t_nci:.3f} s; rho {e_rho:.3e}, "
        f"rdg {e_rdg:.3e}, sign(l2) rho {e_sl2:.3e} relative on the "
        f"{float(ok.double().mean()):.4f} of the points with |l2| > 1e-8")
    check(max(e_rho, e_rdg, e_sl2) <= 1e-10, "sharded nci_grids differ")
    out["nci"] = {"s": t_nci, "rel_err": [e_rho, e_rdg, e_sl2]}
    del rho_s, rdg_s, sl2_s, lam2, rho, rdg

    # basin_reduce_sharded with the YT weights, against index_add_
    wmax, lab = w.max(0)
    isb = wmax < 1.0 - 1e-12
    interior = torch.where(isb, -1, lab)
    bidx = torch.zeros_like(lab)
    nb = int(isb.sum())
    bidx[isb] = torch.arange(nb, device=g.device)
    Wb = w[:, isb]
    del w
    ff = torch.stack([torch.ones_like(g).reshape(-1), g.reshape(-1)])
    q_sh, t_red = wall_s(lambda: basin_reduce_sharded(
        mesh, interior, bidx, Wb, sh.nattr, ff))
    q_one = torch.zeros((2, sh.nattr), dtype=g.dtype, device=g.device)
    q_one.index_add_(1, lab[~isb], ff[:, ~isb])
    q_one = (q_one + ff[:, isb] @ Wb.T).cpu().numpy()
    e = float(np.abs(q_sh - q_one).max() / np.abs(q_one).max())
    dq = float(np.abs(q_sh[1] - sh.integrate(g.reshape(-1))).max()) \
        * s.crystal.volume / g.numel()
    log(f"basin_reduce_sharded: {nb} boundary points, {t_red:.3f} s, "
        f"against index_add_ on one device rel {e:.3e}; its charges "
        f"{dq:.3e} e off the adjoint solve's")
    check(e <= 1e-10, f"basin_reduce_sharded off by {e:.3e}")
    out["basin_reduce"] = {"s": t_red, "nboundary": nb, "rel_err": e,
                           "dq_vs_solve_e": dq}
    return out


def cli_leg(sl, dev):
    """The keyword REPL on the quick-start POSCAR and the slice's field as
    a bincube: in-process on the card, then `python3 -m
    critic2_tpu_torch.cli` with a run log."""
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from critic2_tpu_torch.cli import Repl
    from critic2_tpu_torch.io.writers import write_poscar
    from critic2_tpu_torch.ops import yt_pass as ops

    c0 = nacl_crystal()
    g0 = sl["system"].ref.grid
    q_slice = {r.atom: r.pop for r in sl["intres"].rows}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        poscar = os.path.join(tmp, "POSCAR")
        cube = os.path.join(tmp, "rho.bincube")
        write_poscar(c0, poscar)
        g0.write_bincube(cube, crystal=c0)
        head = f"crystal {poscar}\nload {cube}\nauto\ncpreport\n"
        body = "yt\nintegrable 1\nyt\n"
        tail = "sum 1\n"
        script = os.path.join(tmp, "nacl.cri")
        with open(script, "w") as fh:
            fh.write(head + body + tail)

        def numbers(text):
            """AUTO counts, both YT tables' (atom, pop[, $1]) rows and
            SUM, as printed."""
            auto = re.search(r"\(n=(\d+) b=(\d+) r=(\d+) c=(\d+)\)", text)
            rows = re.findall(r"^\s+\d+\s+(?:Na|Cl)\s+(\d+)\s+(\S+)\s+(\S+)"
                              r"\s+[\d.]+ [\d.]+ [\d.]+(?:\s+(\S+))?$", text,
                              re.M)
            ssum = re.search(r"SUM\(1\) = (\S+)", text)
            return (tuple(int(v) for v in auto.groups()), rows,
                    float(ssum.group(1)))

        # in-process, on the card; the YT lines' launches alone
        buf = io.StringIO()
        repl = Repl(out=buf, device=dev)
        t0 = time.perf_counter()
        repl.run_script(head)
        ops.reset_launches()
        repl.run_script(body)
        launches = dict(ops.launches)
        repl.run_script(tail)
        out["in_process_s"] = time.perf_counter() - t0
        text = buf.getvalue()
        check(repl.nwarns == 0, f"REPL warnings {repl.nwarns}:\n{text}")
        check(repl.sy.device == torch.device(dev), "REPL system device")
        counts, rows, ssum = numbers(text)
        check(counts == (4, 12, 10, 2), f"REPL AUTO counts {counts}")
        check(len(rows) == 8 and all(r[3] for r in rows[4:]),
              f"REPL YT tables: {rows}")
        # the POSCAR lists the atoms species by species
        order = np.argsort(c0.species_of, kind="stable")
        dq = max(abs(float(r[2]) - q_slice[int(order[int(r[0])])])
                 for r in rows)
        d1 = max(abs(float(r[3]) - float(r[2])) for r in rows[4:])
        dsum = abs(ssum - float(g0.f.sum())) / float(g0.f.sum())
        check(dq <= 5.1e-9, f"REPL YT charges {dq:.3e} e off the slice's")
        check(d1 <= 1e-8, f"REPL $1 integrable {d1:.3e} e off the charge")
        check(dsum <= 1e-12, f"REPL SUM {dsum:.3e} off")
        for k in launches:
            check(launches[k] > 0, f"the REPL's YT lines launched no {k}")
        log(f"REPL in-process on {dev}: {out['in_process_s']:.3f} s, "
            f"nwarns 0, AUTO {counts}, YT charges within {dq:.3e} e of the "
            f"slice phase's (printed to 1e-8), $1 within {d1:.3e} e, "
            f"launches of the YT lines {launches}")
        out.update(counts=list(counts), dq_e=dq, launches=launches)

        # as a subprocess, with a run log
        runlog = os.path.join(tmp, "run.jsonl")
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, CRITIC2_RUNLOG=runlog,
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "critic2_tpu_torch.cli",
                            script], cwd=tmp, env=env, capture_output=True,
                           text=True, timeout=600)
        out["subprocess_s"] = time.perf_counter() - t0
        check(p.returncode == 0, f"REPL subprocess exit {p.returncode}: "
              f"{p.stderr[-2000:]}")
        check("ended (0 warnings)" in p.stdout,
              f"REPL subprocess warnings:\n{p.stdout[-2000:]}")
        check(numbers(p.stdout) == (counts, rows, ssum),
              "REPL subprocess printed other numbers")
        with open(runlog) as fh:
            recs = [json.loads(line) for line in fh]
        check([r["kw"] for r in recs] == list(CLI_STEPS)
              and all("wall_s" in r and r["nwarns"] == 0 for r in recs),
              f"run log {recs}")
        log(f"REPL subprocess: {out['subprocess_s']:.3f} s, exit 0, the "
            f"same numbers, run log " + ", ".join(
                f"{r['kw']} {r['wall_s']:.3f} s" for r in recs))
        out["runlog"] = [[r["kw"], r["wall_s"]] for r in recs]
    return out


def parallel_cli_phase(sl, dev, card):
    """Phase 13: the sharded path on a virtual 8-shard mesh of the card,
    and the keyword REPL."""
    import torch

    from critic2_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(N_MESH, device=dev)
    out = {"mesh": dict(mesh.shape)}
    t0 = time.perf_counter()
    out["yt"], sh, w = sharded_yt_leg(sl, mesh)
    out["eval"] = sharded_eval_leg(sl["system"], mesh)
    out["grid_ops"] = grid_ops_leg(sl["system"], mesh, sh, w)
    del sh, w
    torch.cuda.empty_cache()
    out["parallel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"] = cli_leg(sl, dev)
    out["cli_s"] = time.perf_counter() - t0
    log(f"parallel leg {out['parallel_s']:.1f} s, CLI leg "
        f"{out['cli_s']:.1f} s on {card}")
    log(json.dumps({"parallel_cli": out}, default=float))
    return out


# ---------------------------------------------------------------- phase 14
N_GTO = 16384                  # GTO points of the 8x8x6 tile


def host_cpu() -> str:
    """The host CPU's model name (/proc/cpuinfo, else lscpu) and its
    logical CPU count."""
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as fh:
            name = next((ln.split(":", 1)[1].strip() for ln in fh
                         if ln.startswith("model name")), None)
    except OSError:
        pass
    if name is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
            name = next((ln.split(":", 1)[1].strip()
                         for ln in out.splitlines()
                         if ln.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    return (f"{name or platform.machine() + ' (model not reported)'}, "
            f"{os.cpu_count()} logical CPUs")


def native_yt_leg(sl, g, offs, wts):
    """The slice phase's charges and one device's labels against the
    sequential fractional-weight sweep on the same 256^3 field. The
    sweep stays in the main thread: in a worker thread its millions of
    small allocations ran slower on the card's host."""
    import numpy as np

    from critic2_tpu_torch import native

    yh = sl["yt_host"]
    (lab_n, q_n), t = wall_s(lambda: native.yt_charges(g, offs, wts, g))
    q_n = q_n * sl["dv"]
    check(len(q_n) == sl["nattr"], f"native yt nattr {len(q_n)}, card "
          f"{sl['nattr']}")
    # the native basin at each of the card's attractors
    perm = lab_n.reshape(-1)[yh["iattr"]]
    check(sorted(perm.tolist()) == list(range(len(q_n))),
          f"card attractors fall in native basins {perm.tolist()}")
    dq = np.abs(sl["q_basins"] - q_n[perm])
    check(float(dq.max()) <= 1e-6, f"YT charges against the sequential "
          f"sweep: {dq.tolist()} e")
    diff = np.flatnonzero(perm[yh["labels"].reshape(-1)] != lab_n.reshape(-1))
    ntie = int(yh["tie"].reshape(-1)[diff].sum())
    check(ntie == len(diff), f"YT labels: {len(diff) - ntie} points differ "
          f"from the sequential sweep's off a tie")
    log(f"native YT {N_SLICE}^3: nattr {len(q_n)} both, per-basin |q(card) "
        f"- q(sequential)| max {dq.max():.3e} e (bar 1e-6 e), labels differ "
        f"at {len(diff)} points, all ties of two weights within 1e-12; "
        f"card intgrid {sl['intgrid_s']:.3f} s + labels "
        f"{yh['labels_s']:.3f} s, sequential sweep {t:.3f} s")
    return {"card_s": sl["intgrid_s"], "host_s": t, "nattr": len(q_n),
            "dq_max_e": float(dq.max()), "labels_differ": len(diff),
            "ties": ntie}


def native_cp_leg(s, cpl, card_s, g):
    """The grid phase's heavy CP list (WS seeds at depth 2) against the
    sequential AUTO drain from the same seeds, and each CP re-converged
    by a damped host Newton on the native tricubic."""
    import numpy as np

    from critic2_tpu_torch import native
    from critic2_tpu_torch.analysis.autocp import Seed, cell_cp_list, gen_seeds

    c = s.crystal
    m = np.asarray(c.m_x2c)
    xs = np.mod(gen_seeds(c, [Seed(typ="ws", depth=2)], device=s.device),
                1.0)
    ngen = len(xs)
    check(ngen == 39312, f"{ngen} heavy WS seeds generated, not 39,312")
    xs = np.unique(np.round(xs, 10), axis=0)
    (xn, sn), t = wall_s(lambda: native.auto_drain(g, m, xs))
    # the card enters the nuclei at the atoms and drops Newton's maxima
    # within nuceps of them (2 grid steps); the drain keeps those
    nuceps = 2.0 * float(np.max(np.asarray(c.aa) / np.asarray(g.shape)))
    nucl = c.distmat(xn, c.x_frac).min(axis=1) < nuceps
    check(bool((sn[nucl] == -3).all()), "native CPs at the nuclei: "
          f"signatures {sn[nucl].tolist()}")
    xn, sn = xn[~nucl], sn[~nucl]
    # the drain keeps no symmetry: it holds the images its seeds reach.
    # Each must be an image of a card CP of its signature, and every card
    # CP must be reached
    cell = [(i, x) for i, x, _ in cell_cp_list(s, cpl)
            if not cpl.cps[i].isnuc]
    xa = np.array([x for _, x in cell])
    ia = np.array([i for i, _ in cell])
    ta = np.array([cpl.cps[i].typ for i in ia])
    d = np.where(sn[:, None] == ta[None, :], c.distmat(xn, xa), np.inf)
    k = d.argmin(axis=1)
    dn = d[np.arange(len(xn)), k]
    far = np.flatnonzero(~(dn <= 1e-6))
    for i in far:
        log(f"  native CP at {xn[i].tolist()} (signature {sn[i]}): nearest "
            f"card image of its signature {dn[i]:.3e} bohr away")
    check(len(far) == 0, f"{len(far)} native CPs are no image of a card CP")
    hit = np.unique(ia[k])
    noff = sum(not cp.isnuc for cp in cpl.cps)
    check(len(hit) == noff, f"the native drain reaches {len(hit)} of the "
          f"card's {noff} nonequivalent CPs off the nuclei")
    nimg = len(xa)
    dpos = float(dn.max())
    # damped host Newton from each card CP (steps capped at 0.1 bohr)
    x0 = np.array([cp.x for cp in cpl.cps], dtype=float)
    x = x0.copy()
    for _ in range(60):
        _, gr, h6 = native.tricubic_batch(g, x % 1.0)
        H = h6[:, [0, 3, 4, 3, 1, 5, 4, 5, 2]].reshape(-1, 3, 3)
        step = np.linalg.solve(H, gr[:, :, None])[:, :, 0]
        nrm = np.linalg.norm(step @ m.T, axis=1, keepdims=True)
        x = x - np.where(nrm > 0.1, step * (0.1 / np.maximum(nrm, 1e-300)),
                         step)
    dx = x - x0
    dx -= np.round(dx)
    shift = float(np.linalg.norm(dx @ m.T, axis=1).max())
    check(shift <= 1e-6, f"CPs re-converged on the native tricubic move "
          f"{shift:.3e} bohr")
    log(f"native AUTO from the same {ngen} heavy WS seeds ({len(xs)} "
        f"distinct): {len(xn)} CPs off "
        f"the nuclei ({int(nucl.sum())} maxima at them), each an image of "
        f"one of the card's {noff} nonequivalent CPs off the nuclei ({nimg} "
        f"in the cell) of its signature within {dpos:.3e} bohr (bar 1e-6), "
        f"every one reached; host Newton on the native tricubic moves the "
        f"card's {len(cpl.cps)} CPs {shift:.3e} bohr (bar 1e-6); card "
        f"autocp {card_s:.3f} s, sequential drain {t:.3f} s")
    return {"card_s": card_s, "host_s": t, "seeds": ngen,
            "seeds_distinct": len(xs), "ncp_native": len(xn),
            "native_nuclear_maxima": int(nucl.sum()), "ncp_cell": nimg,
            "nonequivalent": noff,
            "dpos_bohr": dpos, "reconverge_bohr": shift}


def native_interp_leg(gd, g):
    """interp_soa in f64 at phase 6's 131,072 points against the native
    tricubic batch."""
    import numpy as np
    import torch

    from critic2_tpu_torch import native
    from critic2_tpu_torch.ops.interp import interp_soa

    pts = np.random.default_rng(11).random((3, 131072))
    pd = torch.as_tensor(pts, device=gd.device)
    card = interp_soa(gd, pd)
    ms = cuda_ms(lambda: interp_soa(gd, pd), 5)
    ref, t = wall_s(lambda: native.tricubic_batch(g, pts.T))
    errs = {}
    for nm, a, b in zip(("value", "gradient", "Hessian"), card, ref):
        errs[nm] = rel_err(a.cpu().reshape(-1), torch.as_tensor(b.T).reshape(-1))
        check(errs[nm] <= 1e-10, f"interp_soa vs native tricubic, {nm}: "
              f"{errs[nm]:.3e}")
    log(f"native tricubic at 131,072 points: value {errs['value']:.3e}, "
        f"gradient {errs['gradient']:.3e}, Hessian {errs['Hessian']:.3e} "
        f"(relative to the largest, bar 1e-10); card {ms:.4f} ms, host "
        f"{t * 1e3:.3f} ms")
    return {"card_s": ms / 1e3, "host_s": t, **errs}


def native_nci_leg(s, g):
    """nciplot in f64 at 256^3 against the native NCI sweep (rhocut 0.2,
    dimcut 2.0)."""
    import numpy as np

    from critic2_tpu_torch import native
    from critic2_tpu_torch.analysis.nci import nciplot

    n = N_SLICE
    r, tc = wall_s(lambda: nciplot(s, nstep=(n, n, n), precision="f64"))
    ndat = r.ndat
    acr = r.crho.abs()
    near = int((((acr - 20.0).abs() <= 20.0 * 1e-12)
                | ((r.cgrad_raw - 2.0).abs() <= 2.0 * 1e-12)).sum())
    del r, acr
    nn, t = wall_s(lambda: native.nci_sweep(g, np.asarray(s.crystal.m_c2x),
                                            0.2, 2.0))
    check(abs(ndat - nn) <= near, f"nciplot f64 selects {ndat} points, the "
          f"native sweep {nn}, {near} points lie within 1e-12 of a cutoff")
    log(f"native NCI sweep {n}^3: {nn} .dat points, card {ndat} (difference "
        f"{ndat - nn}; {near} card points within 1e-12 of a cutoff); card "
        f"nciplot {tc:.3f} s, host sweep {t:.3f} s")
    return {"card_s": tc, "host_s": t, "ndat": ndat, "ndat_native": nn,
            "near_cutoff": near}


def native_path_leg(s, tr, g):
    """trace_paths colours of every seed the qtree phase traced against
    the sequential tracer, the same targets and capture radii; then every
    seed moved 1e-8 bohr along +-x, y and z, on the card and in the
    reference, which marks the seeds on a separatrix."""
    import numpy as np
    import torch

    from critic2_tpu_torch import native
    from critic2_tpu_torch.ops.ode import trace_paths

    seeds, tgt, ids, rt = tr["seeds"], tr["targets"], tr["tgt_ids"], tr["rt"]
    fn = s.ref.eval_fn(nder=1)
    m = np.asarray(s.crystal.m_x2c)

    def card(x):
        """The card's colours by the reference tracer's rule: the
        captured target's id; a gradient-zero end takes the nearest
        target within 0.5 bohr. In blocks of 2^16 lanes, as qtree
        traces."""
        cols = []
        for lo in range(0, len(x), 1 << 16):
            xf, st, ti, _, _ = trace_paths(
                fn, torch.as_tensor(x[lo:lo + (1 << 16)],
                                    dtype=torch.float64, device=s.device),
                iup=1, targets=tgt, rterm=rt, mstep=tr["mstep"])
            st, ti, xf = st.cpu().numpy(), ti.cpu().numpy(), xf.cpu().numpy()
            col = np.where((st == 0) & (ti >= 0), ids[np.clip(ti, 0, None)],
                           -1)
            for i in np.flatnonzero(st == 1):
                d = np.linalg.norm(tgt - xf[i], axis=1)
                if d.min() < 0.5:
                    col[i] = ids[int(d.argmin())]
            cols.append(col)
        return np.concatenate(cols)

    def ref(x):
        return native.trace_colors(g, m, x, tgt, ids, rt,
                                   mstep=tr["mstep"])

    n = len(seeds)
    col, tc = wall_s(lambda: card(seeds))
    (cn, nev), t = wall_s(lambda: ref(seeds))
    bad = np.flatnonzero(col != cn)
    # a seed on a separatrix: moved 1e-8 bohr along an axis, it changes
    # colour on the card or in the reference; there either answer is right
    shift = 1e-8 * np.concatenate([np.eye(3), -np.eye(3)])
    px = (seeds[:, None, :] + shift[None]).reshape(-1, 3)
    pc, tcs = wall_s(lambda: card(px).reshape(n, 6))
    (pn, _), ts = wall_s(lambda: ref(px))
    pn = pn.reshape(n, 6)
    sep_card = (pc != col[:, None]).any(axis=1)
    sep_ref = (pn != cn[:, None]).any(axis=1)
    sep = sep_card | sep_ref
    for i in bad:
        log(f"  path colour differs: seed {seeds[i].tolist()} card {col[i]} "
            f"native {cn[i]}; moved 1e-8 bohr along +-x, y, z: card "
            f"{pc[i].tolist()}, native {pn[i].tolist()}"
            + (" (a separatrix)" if sep[i] else ""))
    ties = int(sep[bad].sum())
    check(len(bad) - ties <= 0.001 * n, f"{len(bad) - ties} of {n} path "
          "colours off a separatrix differ from the sequential tracer's")
    log(f"native path colours, all {n} qtree seeds: {len(bad)} differ "
        f"({100 * len(bad) / n:.3f} %), {ties} of them on a separatrix (bar "
        f"0.1 % off one), {int((cn < 0).sum())} uncoloured; on a separatrix "
        f"{int(sep.sum())} of all {n} seeds ({100 * sep.mean():.3f} %: card "
        f"{int(sep_card.sum())}, reference {int(sep_ref.sum())}); card "
        f"trace_paths {tc:.3f} s, sequential tracer {t:.3f} s ({nev} "
        f"evaluations); the {6 * n} moved seeds card {tcs:.3f} s, "
        f"reference {ts:.3f} s")
    return {"card_s": tc, "host_s": t, "seeds": n, "differ": len(bad),
            "separatrix_of_differing": ties, "separatrix": int(sep.sum()),
            "separatrix_card": int(sep_card.sum()),
            "separatrix_reference": int(sep_ref.sum()), "nevals": nev,
            "moved_card_s": tcs, "moved_host_s": ts}


def native_gto_leg(wf, dev):
    """rho_eval_screened (nder=2) on 16,384 points of the 8x8x6 tile
    against the sequential screened GTO evaluation."""
    import numpy as np
    import torch

    from critic2_tpu_torch import native

    w = wf["_wfn"]
    # the atoms' bounding box and 2 bohr around it
    lo, hi = w.atpos.min(axis=0) - 2.0, w.atpos.max(axis=0) + 2.0
    pts = lo + np.random.default_rng(14).random((N_GTO, 3)) * (hi - lo)
    xT = torch.as_tensor(pts.T.copy(), dtype=torch.float64, device=dev)
    wall_s(lambda: w.rho_eval_screened(xT, nder=2))
    (f, gf, h6), tc = wall_s(lambda: w.rho_eval_screened(xT, nder=2))
    (rho, gr, hs, nvisit), t = wall_s(lambda: native.wfn_eval_seq(w, pts, 2))
    h6n = hs.reshape(-1, 9)[:, [0, 4, 8, 1, 2, 5]]
    errs = {}
    for nm, a, b in (("rho", f, rho), ("gradient", gf.T, gr),
                     ("Hessian", h6.T, h6n)):
        errs[nm] = rel_err(a.cpu(), torch.as_tensor(b))
        check(errs[nm] <= 1e-10, f"screened GTO vs native, {nm}: "
              f"{errs[nm]:.3e}")
    log(f"native GTO evaluation, {N_GTO} points of the {TILE} tile, nder=2: "
        f"rho {errs['rho']:.3e}, gradient {errs['gradient']:.3e}, Hessian "
        f"{errs['Hessian']:.3e} (relative to the largest, bar 1e-10); card "
        f"{tc * 1e3:.3f} ms, sequential {t * 1e3:.3f} ms ({nvisit} primitive "
        f"visits)")
    return {"card_s": tc, "host_s": t, **errs}


def native_mol_cp_leg(dev):
    """autocp on the 4x4x2 H2 tile (dense GTO Newton) against the
    sequential drain from the same pair seeds."""
    import tempfile

    import numpy as np

    from critic2_tpu_torch import System, native
    from critic2_tpu_torch.analysis.autocp import Seed, autocp, gen_seeds
    from critic2_tpu_torch.fields.wfn import Wavefunction

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "h2.molden")
    with open(path, "w") as fh:
        fh.write(H2_MOLDEN)
    w = Wavefunction.from_file(path).tile(EXPR_TILE)
    s = System.from_wavefunction(w, device=dev)
    autocp(s)
    cpl, tc = wall_s(lambda: autocp(s))
    c = s.crystal
    xs = np.mod(gen_seeds(c, [Seed(typ="pair")], device=dev), 1.0)
    b = np.asarray(c.molborder)
    xs = xs[np.all((xs >= b) & (xs <= 1.0 - b), axis=1)]
    xs = np.unique(np.round(xs, 10), axis=0)
    (xn, sn, nev), t = wall_s(lambda: native.wfn_auto_drain(
        s.ref.wfn, c.x2c(xs)))
    # the card's list enters nuclei at the atoms and drops the Newton
    # maxima within nuceps (0.1 bohr) of them; the drain keeps them
    atpos = np.asarray(s.ref.wfn.atpos)
    dn = np.linalg.norm(xn[:, None, :] - atpos[None], axis=2).min(1)
    nucl = dn < 0.1
    check(bool((sn[nucl] == -3).all()), "native maxima near the nuclei: "
          f"signatures {sn[nucl].tolist()}")
    cps = [cp for cp in cpl.cps if not cp.isnuc]
    xa = np.array([cp.r for cp in cps])
    ta = np.array([cp.typ for cp in cps])
    check(len(xa) == int((~nucl).sum()), f"autocp on the {EXPR_TILE} tile: "
          f"{len(xa)} CPs off the nuclei, the native drain {(~nucl).sum()}")
    d = np.linalg.norm(xa[:, None, :] - xn[~nucl][None], axis=2)
    dmax = 0.0
    free = np.ones(d.shape[1], dtype=bool)
    for i in range(len(xa)):
        cand = np.flatnonzero(free & (sn[~nucl] == ta[i]))
        check(len(cand) > 0, f"molecular CP {i} has no native partner")
        k = cand[np.argmin(d[i, cand])]
        free[k] = False
        dmax = max(dmax, float(d[i, k]))
    check(dmax <= 1e-6, f"molecular CPs differ by {dmax:.3e} bohr")
    log(f"native molecular AUTO on the {EXPR_TILE} tile ({w.npri} "
        f"primitives), {len(xs)} pair seeds: {len(xa)} CPs off the nuclei "
        f"with their signatures both, within {dmax:.3e} bohr (bar 1e-6), "
        f"{int(nucl.sum())} native maxima at the nuclei; card autocp "
        f"{tc:.3f} s, sequential drain {t:.3f} s ({nev} evaluations)")
    return {"card_s": tc, "host_s": t, "ncp": len(xa), "dpos_bohr": dmax,
            "native_nuclear_maxima": int(nucl.sum())}


def native_phase(sl, grid_out, wf, dev, card):
    """Phase 14: the card's results against the sequential C++ reference
    (critic2_tpu_torch/native.py) on the same inputs; the YT leg reuses
    the slice and sharded phases' results and solves nothing again."""
    import torch

    from critic2_tpu_torch import native
    from critic2_tpu_torch.analysis.yt import _grid_ws_neighbors

    s = sl["system"]
    gd = s.ref.grid.f
    g = gd.cpu().numpy()
    offs, wts = _grid_ws_neighbors(s.crystal, g.shape)
    out = {"yt": native_yt_leg(sl, g, offs, wts)}
    out["cps"] = native_cp_leg(s, sl["cpl_heavy"],
                               grid_out["autocp"]["heavy"]["autocp_s"], g)
    out["tricubic"] = native_interp_leg(gd, g)
    out["nci"] = native_nci_leg(s, g)
    out["paths"] = native_path_leg(s, sl["qtree_trace"], g)
    del g
    torch.cuda.empty_cache()
    out["gto"] = native_gto_leg(wf, dev)
    out["mol_cps"] = native_mol_cp_leg(dev)
    out["host_cpu"] = host_cpu()
    out["omp_threads"] = native.omp_threads()
    log(f"card {card}; host {out['host_cpu']}, native OpenMP threads "
        f"{out['omp_threads']} (tricubic batch and NCI sweep; the rest one "
        "core)")
    for leg in ("yt", "cps", "tricubic", "nci", "paths", "gto", "mol_cps"):
        log(f"  {leg}: card {out[leg]['card_s']:.4f} s, sequential "
            f"reference {out[leg]['host_s']:.4f} s")
    log(json.dumps({"native": out}, default=float))
    return out


def late_launch_counts(sl, q, wf):
    """Kernel launches of one BS23 attempt on the qtree and wavefunction
    traces; run last, since the profiler slows every later launch."""
    import numpy as np
    import torch

    from critic2_tpu_torch.ops.ode import trace_paths

    s = sl["system"]
    f = s.ref
    seeds = torch.as_tensor(np.asarray(s.crystal.x_cart)[[0, 1]]
                            + np.array([[1.1, 0.3, 0.2], [0.4, 1.2, 0.1]]),
                            dtype=torch.float64, device=f.device)
    # no targets and gradeps 0: no lane stops, every trace runs mstep
    fq = f.eval_fn(nder=1)
    q["launches_per_attempt"] = launches_per_attempt(lambda m: trace_paths(
        fq, seeds, iup=1, gradeps=0.0, mstep=m))[0]
    w = wf.pop("_wfn")
    ws = wf.pop("_seeds")
    shim = w.screened_shim(w.screen_plan(ws[:8], n_chunk=8,
                                         margin=8.0)[2][0], nder=1)
    x8 = torch.as_tensor(ws[:8], dtype=torch.float64, device=f.device)
    wf["trace"]["launches_per_attempt"] = launches_per_attempt(
        lambda m: trace_paths(shim, x8, iup=1, gradeps=0.0, mstep=m))[0]
    log(f"kernel launches a BS23 attempt: qtree traces (tricubic, nder=1) "
        f"{q['launches_per_attempt']:.1f}, screened GTO traces "
        f"{wf['trace']['launches_per_attempt']:.1f}; the qtree run's "
        f"{q['attempts']} attempts make about "
        f"{q['attempts'] * q['launches_per_attempt']:.0f} launches")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break one intgrid, autocp, nciplot, "
                    "makegraph and Bader intgrid down by stage and kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor

    from critic2_tpu_torch import native
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
    # the CUDA kernels (one nvcc each) and the host reference (g++) build
    # side by side; either failing fails the run
    with ThreadPoolExecutor(1) as pool:
        host_ref = pool.submit(native.build)
        _ext.build()
        check(host_ref.result(), "the native reference did not load")
    log(f"build: {time.perf_counter() - t0:.1f} s (native reference "
        f"{os.path.basename(native._lib_path())})")
    for name, out in _ext.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    kernel_phase(dev, N_KERNEL)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    sl = slice_phase(dev, N_SLICE)
    meas = main_shape_phase(sl)
    t0 = time.perf_counter()
    walk = bader_walk_phase(dev)
    torch.cuda.empty_cache()
    log(f"bader walk phase: {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_phase(sl)
    t0 = time.perf_counter()
    mp = multipoles_phase(sl)
    log(f"multipoles phase: {time.perf_counter() - t0:.1f} s")
    # the YT phases' tensors: free them (the rows and charges stay)
    sl.pop("res"), sl.pop("f3")
    sl["intres"].decomp = sl["intres"].rho = None
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grid_out = grid_phase(sl, args.profile)
    log(f"grid path phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qs = quickstart_phase(sl, card.splitlines()[0])
    log(f"quick-start phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q = qtree_phase(sl, dev)
    log(f"qtree phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wf = wfn_phase(dev)
    log(f"wavefunction phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ex = expressions_phase(sl, wf, card.splitlines()[0])
    log(f"expressions phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fm = formats_phase(dev, card.splitlines()[0])
    log(f"formats phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pc = parallel_cli_phase(sl, dev, card.splitlines()[0])
    log(f"parallel and CLI phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native_phase(sl, grid_out, wf, dev, card.splitlines()[0])
    log(f"native reference phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_phase(sl, grid_out, args.profile)
    log(f"gradient-path and FFT phase: {time.perf_counter() - t0:.1f} s")
    late_launch_counts(sl, q, wf)
    log(json.dumps({"qtree": q, "wavefunction": wf}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name in ("yt_pass", "yt_gs_pass"):
        m = meas[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": sl["launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": m.get("library_ms"),
            "launches_multipoles": mp["launches"][name],
            "launches_quickstart": qs["launches"][name],
            "launches_expressions": ex["launches"][name],
            "launches_deloc": fm["launches"][name],
            "launches_sharded": pc["yt"]["launches"][name],
            **m.get("extra", {})})
    kernels.append(walk)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
