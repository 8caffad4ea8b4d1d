// The near-grid Bader walk (Tang, Sanville and Henkelman, J. Phys.:
// Condens. Matter 21, 084204 (2009); critic2 src/bader@proc.f90
// max_neargrid / step_neargrid), one thread per grid point.
//
// Replaces no TPU kernel: the JAX package walks in batched XLA steps
// (critic2_tpu/analysis/bader.py). Added because the batched PyTorch walk
// (ops/bader_walk.py::neargrid_walk_plain) is bound by the host on the
// card: some eighty launches a step and a read of the host every
// WALK_SEGMENT steps, 3.3 s for a hematite job of 11.3 M points.
//
// The arithmetic is the plain version's (_neargrid_step), operation for
// operation: every product, sum and quotient is one _rn intrinsic (and
// the library builds with -fmad=false), in the plain version's order;
// rint rounds half to even, as torch.round; the on-grid step takes the
// first of equal rises, as torch.max; a near-grid step onto a point of
// the walker's last `memory` steps takes the on-grid step, as the plain
// version's guard does; a walker still walking after
// `maxsteps` (the cap rounded up to whole segments) stays where it
// stands. So every root is the plain version's, bit for bit.
//
// Bound on an H100: the gathers. A step reads the 27 points around the
// walker, 33 values for a few dozen flops; neighbouring threads walk
// neighbouring points, so most reads hit L1 and L2. The least traffic is
// the density read once and one root written per point (16 bytes a
// point); the kernel's share of that bound is read from the device trace.
//
// Design: a thread walks its point to the end; a warp runs until its
// longest walk ends. Positions stay in [0, n) on each axis as ints, and
// the points of the walker's last `memory` steps (at most
// BADER_WALK_MEMORY) as int flat indices in registers, newest first: the
// guard against cycles compares the target of a near-grid step with
// them. The steps taken and the walkers capped are summed per warp and
// added to two device counters once per warp.
#include <cuda_runtime.h>
#include <stdint.h>

#define BADER_WALK_THREADS 256
// the most points of its last steps a walker remembers
#define BADER_WALK_MEMORY 8

template <typename T>
struct WalkConsts {
    T G[9];        // direct-coordinate gradient operator, row-major
    T invd[26];    // 1 / |L o_k|, offsets (-1, 0, 1)^3 \ 0, lexicographic
};

__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
    return __fdiv_rn(a, b);
}
__device__ __forceinline__ double round_even(double a) { return rint(a); }
__device__ __forceinline__ float round_even(float a) { return rintf(a); }

// v in [-n, 2n): the point of the periodic grid
__device__ __forceinline__ int wrap(int v, int n) {
    return v < 0 ? v + n : (v >= n ? v - n : v);
}

template <typename T>
__global__ void __launch_bounds__(BADER_WALK_THREADS)
bader_walk_kernel(const T* __restrict__ f, int n1, int n2, int n3,
                  WalkConsts<T> c, int maxsteps, int memory,
                  int64_t* __restrict__ roots,
                  unsigned long long* __restrict__ counts) {
    const int plane = n2 * n3;
    const int64_t N = (int64_t)plane * n1;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    unsigned long long nsteps = 0, ncapped = 0;
    if (i < N) {
        int x = (int)(i / plane);
        const int r = (int)(i - (int64_t)x * plane);
        int y = r / n3;
        int z = r - y * n3;
        // the flat points of the last `memory` steps, newest first (-1:
        // none); at its first step the walker counts as coming from
        // p - (1, 1, 1)
        int seen[BADER_WALK_MEMORY];
        seen[0] = wrap(x - 1, n1) * plane + wrap(y - 1, n2) * n3
                  + wrap(z - 1, n3);
#pragma unroll
        for (int k = 1; k < BADER_WALK_MEMORY; ++k) seen[k] = -1;
        T dr[3] = {T(0), T(0), T(0)};
        bool done = false;
        int s = 0;
        for (; s < maxsteps && !done; ++s) {
            // the 27 points p + (-1, 0, 1)^3, lexicographic
            const int bx[3] = {wrap(x - 1, n1) * plane, x * plane,
                               wrap(x + 1, n1) * plane};
            const int by[3] = {wrap(y - 1, n2) * n3, y * n3,
                               wrap(y + 1, n2) * n3};
            const int bz[3] = {wrap(z - 1, n3), z, wrap(z + 1, n3)};
            T v[27];
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
#pragma unroll
                    for (int e = 0; e < 3; ++e)
                        v[a * 9 + b * 3 + e] = f[bx[a] + by[b] + bz[e]];
            const T f0 = v[13];
            // lattice-coordinate central differences, 0 along an axis
            // where the point is above both neighbours
            const T fp[3] = {v[22], v[16], v[14]};
            const T fm[3] = {v[4], v[10], v[12]};
            T gl[3];
#pragma unroll
            for (int d = 0; d < 3; ++d)
                gl[d] = (fp[d] < f0 && fm[d] < f0)
                            ? T(0) : mul_rn(T(0.5), sub_rn(fp[d], fm[d]));
            T gd[3];
#pragma unroll
            for (int d = 0; d < 3; ++d)
                gd[d] = add_rn(add_rn(mul_rn(gl[0], c.G[3 * d]),
                                      mul_rn(gl[1], c.G[3 * d + 1])),
                               mul_rn(gl[2], c.G[3 * d + 2]));
            const T gmax = fmax(fmax(fabs(gd[0]), fabs(gd[1])),
                                fabs(gd[2]));
            const bool level = gmax < T(1e-30);
            // the on-grid step: the steepest rise, the first of equals
            bool top = true;
            int kbest = 0;
            T best = mul_rn(sub_rn(v[0], f0), c.invd[0]);
#pragma unroll
            for (int k = 0; k < 26; ++k) {
                const T vk = v[k < 13 ? k : k + 1];
                top = top && !(vk > f0);
                const T m = mul_rn(sub_rn(vk, f0), c.invd[k]);
                if (m > best) {
                    best = m;
                    kbest = k;
                }
            }
            if (level && top) {     // a maximum: the walk ends here
                done = true;
                continue;
            }
            const int sk = kbest < 13 ? kbest : kbest + 1;
            const bool rise = best > T(0);
            int step[3] = {rise ? sk / 9 - 1 : 0, rise ? (sk / 3) % 3 - 1 : 0,
                           rise ? sk % 3 - 1 : 0};
            T nd[3] = {T(0), T(0), T(0)};
            if (!level) {
                // the near-grid step: the rounded unit gradient plus the
                // rounded carried correction
                int ns[3];
                T ndr[3];
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    const T g = div_rn(gd[d], gmax);
                    const T rg = round_even(g);
                    const T carry = sub_rn(add_rn(dr[d], g), rg);
                    const T rc = round_even(carry);
                    ns[d] = (int)rg + (int)rc;
                    ndr[d] = sub_rn(carry, rc);
                }
                // a step onto a point of the last `memory` steps takes
                // the on-grid step in its place, dr reset
                const int q = wrap(x + ns[0], n1) * plane
                              + wrap(y + ns[1], n2) * n3 + wrap(z + ns[2], n3);
                bool back = false;
#pragma unroll
                for (int k = 0; k < BADER_WALK_MEMORY; ++k)
                    back = back || (k < memory && seen[k] == q);
                if (!back) {
#pragma unroll
                    for (int d = 0; d < 3; ++d) {
                        step[d] = ns[d];
                        nd[d] = ndr[d];
                    }
                }
            }
            if (step[0] == 0 && step[1] == 0 && step[2] == 0) {
                done = true;
                continue;
            }
#pragma unroll
            for (int k = BADER_WALK_MEMORY - 1; k > 0; --k)
                seen[k] = seen[k - 1];
            seen[0] = x * plane + y * n3 + z;
            x = wrap(x + step[0], n1);
            y = wrap(y + step[1], n2);
            z = wrap(z + step[2], n3);
#pragma unroll
            for (int d = 0; d < 3; ++d) dr[d] = nd[d];
        }
        nsteps = (unsigned long long)s;
        ncapped = done ? 0ull : 1ull;
        roots[i] = (int64_t)x * plane + (int64_t)y * n3 + z;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        nsteps += __shfl_down_sync(0xffffffffu, nsteps, o);
        ncapped += __shfl_down_sync(0xffffffffu, ncapped, o);
    }
    if ((threadIdx.x & 31) == 0 && nsteps) {
        atomicAdd(counts, nsteps);
        if (ncapped) atomicAdd(counts + 1, ncapped);
    }
}

template <typename T>
static int launch(const void* f, int n1, int n2, int n3, const double* G,
                  const double* invd, int maxsteps, int memory, void* roots,
                  void* counts, void* stream) {
    const int64_t N = (int64_t)n1 * n2 * n3;
    // flat indices are ints: the grid holds fewer than 2^31 points
    if (n1 < 2 || n2 < 2 || n3 < 2 || maxsteps < 0 || N > INT32_MAX
        || memory < 1 || memory > BADER_WALK_MEMORY)
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (N + BADER_WALK_THREADS - 1) / BADER_WALK_THREADS;
    WalkConsts<T> c;
    for (int k = 0; k < 9; ++k) c.G[k] = (T)G[k];
    for (int k = 0; k < 26; ++k) c.invd[k] = (T)invd[k];
    bader_walk_kernel<T><<<(unsigned)blocks, BADER_WALK_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const T*)f, n1, n2, n3, c, maxsteps, memory, (int64_t*)roots,
        (unsigned long long*)counts);
    return (int)cudaGetLastError();
}

extern "C" int bader_walk_f32(const void* f, int n1, int n2, int n3,
                              const double* G, const double* invd,
                              int maxsteps, int memory, void* roots,
                              void* counts, void* stream) {
    return launch<float>(f, n1, n2, n3, G, invd, maxsteps, memory, roots,
                         counts, stream);
}

extern "C" int bader_walk_f64(const void* f, int n1, int n2, int n3,
                              const double* G, const double* invd,
                              int maxsteps, int memory, void* roots,
                              void* counts, void* stream) {
    return launch<double>(f, n1, n2, n3, G, invd, maxsteps, memory, roots,
                          counts, stream);
}
