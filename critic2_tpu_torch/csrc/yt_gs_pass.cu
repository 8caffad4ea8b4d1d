// One plane-ordered Gauss-Seidel sweep of s = f + R s along axis 0.
//
// Replaces critic2_tpu/ops/yt_pass.py::yt_gs_pass (the Pallas kernel whose
// pallas_call is at line 292), with the same semantics
// (yt_pass.py:195-269):
//   * planes i = 0 .. n1-1 in order (n1-1 .. 0 when `backward`);
//   * base = f[:, i] + sum over the cross-plane neighbours (those with
//     d0 < 0 first, then d0 > 0, each in k order) of chi[k, i] * nb, where
//     nb is read from `out` when its plane lies on the already-swept side
//     and did not wrap around the periodic boundary, and from the old `s`
//     otherwise;
//   * the in-plane sub-system u = base + sum_{d0 == 0} chi[k, i] * u[+d]
//     is solved by Jacobi iteration between two plane buffers, warm-started
//     from the plane's old value, until no point changes (the in-plane
//     operator is nilpotent, so this ends at a bitwise fixpoint);
//   * the plane is written to `out` and "changed versus the old s" is OR-ed
//     into the int32 flag.
// Built with -fmad=false, so every term is one rounded product and one
// rounded sum, as in the plain PyTorch version.
//
// The TPU ran the planes as a sequential grid with a VMEM carry. On Hopper
// the blocks of a grid run in no order, so this is one persistent
// cooperative kernel: all blocks walk the planes together and meet at a
// grid-wide barrier (cooperative_groups::this_grid().sync()) after each
// in-plane iteration and after each plane. The grid is sized from the
// occupancy calculator times the SM count (a larger grid would deadlock at
// the barrier) and capped at one thread per (p, y, z) of a plane.
//
// Bound on an H100: bytes for the (K + 3P) words per point of one sweep,
// but in practice the barriers: one per in-plane iteration, so the first
// sweep, which walks the longest in-plane chains, is barrier-bound. Plane
// buffers are small (P * n2 * n3 words) and stay in L2; every load of data
// written inside this launch uses ld.global.cg (__ldcg) so no stale L1 line
// is read.
#include <cooperative_groups.h>

#include "yt_common.cuh"

namespace cg = cooperative_groups;

struct GsDisp {
    int ncross;                 // cross-plane neighbours, summation order
    int kc[YT_MAXK];
    int dc[YT_MAXK][3];
    int ninp;                   // in-plane neighbours, summation order
    int ki[YT_MAXK];
    int di[YT_MAXK][2];
};

template <typename T>
__global__ void __launch_bounds__(256)
yt_gs_kernel(const T* __restrict__ chi, const T* __restrict__ s,
             const T* __restrict__ f, T* out, int* flag, T* base, T* buf0,
             T* buf1, int* chg, int P, int n1, int n2, int n3, int backward,
             GsDisp g) {
    cg::grid_group grid = cg::this_grid();
    const int64_t plane = (int64_t)n2 * n3;
    const int64_t N = (int64_t)n1 * plane;
    const int64_t M = (int64_t)P * plane;          // work items per plane
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t nth = (int64_t)gridDim.x * blockDim.x;
    unsigned it = 0;        // in-plane iteration count, same in all threads
    int changed = 0;

    for (int step = 0; step < n1; ++step) {
        const int i = backward ? n1 - 1 - step : step;
        const int64_t ioff = (int64_t)i * plane;

        // 1. base from the cross-plane neighbours
        for (int64_t q = tid; q < M; q += nth) {
            const int64_t p = q / plane;
            const int yz = (int)(q - p * plane);
            const int y = yz / n3;
            const int z = yz - y * n3;
            const int64_t pN = p * N;
            T acc = f[pN + ioff + yz];
            for (int c = 0; c < g.ncross; ++c) {
                const int d0 = g.dc[c][0];
                const int ii = i + d0;
                const bool wrapped = ii < 0 || ii >= n1;
                const bool swept = backward ? d0 > 0 : d0 < 0;
                const int64_t idx = pN + (int64_t)yt_wrap(ii, n1) * plane
                    + (int64_t)yt_wrap(y + g.dc[c][1], n2) * n3
                    + yt_wrap(z + g.dc[c][2], n3);
                const T v = (swept && !wrapped) ? __ldcg(out + idx) : s[idx];
                acc = acc + chi[g.kc[c] * N + ioff + yz] * v;
            }
            if (g.ninp == 0) {
                out[pN + ioff + yz] = acc;
                changed |= acc != s[pN + ioff + yz];
            } else {
                base[q] = acc;
            }
        }

        if (g.ninp > 0) {
            // 2. in-plane Jacobi iterations: cur -> nxt, warm start from
            // the old s plane. chg[] holds three flag slots: slot it % 3 is
            // written in iteration it and read after its barrier; thread 0
            // clears slot (it + 1) % 3, whose last readers all passed the
            // previous barrier.
            const T* cur = s + ioff;
            int64_t curP = N;                      // p-stride of cur
            T* nxt = buf0;
            // the in-plane operator is nilpotent: Jacobi reaches its
            // fixpoint within (plane points + 1) iterations; the cap only
            // guards against a hang, and marks the flag with bit 2
            for (int64_t n = 0;; ++n) {
                const int slot = it % 3;
                if (tid == 0) chg[(it + 1) % 3] = 0;
                int any = 0;
                for (int64_t q = tid; q < M; q += nth) {
                    const int64_t p = q / plane;
                    const int yz = (int)(q - p * plane);
                    const int y = yz / n3;
                    const int z = yz - y * n3;
                    const T* cp = cur + p * curP;
                    T un = __ldcg(base + q);
                    for (int c = 0; c < g.ninp; ++c) {
                        const int64_t nb =
                            (int64_t)yt_wrap(y + g.di[c][0], n2) * n3
                            + yt_wrap(z + g.di[c][1], n3);
                        un = un + chi[g.ki[c] * N + ioff + yz] * __ldcg(cp + nb);
                    }
                    nxt[q] = un;
                    any |= un != __ldcg(cp + yz);
                }
                if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0)
                    atomicOr(chg + slot, 1);
                grid.sync();
                const int more = *(volatile int*)(chg + slot);
                ++it;
                if (!more) break;               // nxt == cur bitwise
                if (n > plane + 1) {
                    if (tid == 0) atomicOr(flag, 2);
                    break;
                }
                cur = nxt;
                curP = plane;
                nxt = (nxt == buf0) ? buf1 : buf0;
            }
            // 3. write the plane (each thread reads back its own points)
            for (int64_t q = tid; q < M; q += nth) {
                const int64_t p = q / plane;
                const int64_t o = p * N + ioff + (q - p * plane);
                const T u = __ldcg(nxt + q);
                out[o] = u;
                changed |= u != s[o];
            }
        }
        grid.sync();            // plane i is visible to the next plane
    }
    if (__any_sync(0xffffffffu, changed) && (threadIdx.x & 31) == 0)
        atomicOr(flag, 1);
}

template <typename T>
static int launch(const void* chi, const void* s, const void* f, void* out,
                  void* flag, void* scratch, void* chg, int P, int n1, int n2,
                  int n3, int backward, int ncross, const int* cross,
                  int ninp, const int* inp, void* stream) {
    GsDisp g;
    if (ncross < 0 || ninp < 0 || ncross + ninp > YT_MAXK)
        return (int)cudaErrorInvalidValue;
    g.ncross = ncross;
    for (int c = 0; c < ncross; ++c) {
        g.kc[c] = cross[4 * c];
        for (int a = 0; a < 3; ++a) g.dc[c][a] = cross[4 * c + 1 + a];
    }
    g.ninp = ninp;
    for (int c = 0; c < ninp; ++c) {
        g.ki[c] = inp[3 * c];
        g.di[c][0] = inp[3 * c + 1];
        g.di[c][1] = inp[3 * c + 2];
    }
    const int64_t M = (int64_t)P * n2 * n3;
    if (M == 0 || n1 == 0) return 0;

    int dev = 0, nsm = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int threads = 256;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, yt_gs_kernel<T>, threads, 0);
    if (e != cudaSuccess) return (int)e;
    int64_t blocks = (int64_t)per_sm * nsm;
    const int64_t need = (M + threads - 1) / threads;
    if (blocks > need) blocks = need;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;

    const T* chi_ = (const T*)chi;
    const T* s_ = (const T*)s;
    const T* f_ = (const T*)f;
    T* out_ = (T*)out;
    int* flag_ = (int*)flag;
    T* base_ = (T*)scratch;
    T* buf0_ = base_ + M;
    T* buf1_ = buf0_ + M;
    int* chg_ = (int*)chg;
    void* args[] = {&chi_, &s_, &f_, &out_, &flag_, &base_, &buf0_, &buf1_,
                    &chg_, &P, &n1, &n2, &n3, &backward, &g};
    e = cudaLaunchCooperativeKernel((const void*)yt_gs_kernel<T>,
                                    dim3((unsigned)blocks), dim3(threads),
                                    args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// cross: ncross x (k, d0, d1, d2); inp: ninp x (k, d1, d2), both in the
// summation order. scratch: 3 * P * n2 * n3 elements of T; chg: 3 int32
// zeros; flag: 1 int32, OR-ed (the caller zeroes it).
extern "C" int yt_gs_pass_f32(const void* chi, const void* s, const void* f,
                              void* out, void* flag, void* scratch, void* chg,
                              int P, int n1, int n2, int n3, int backward,
                              int ncross, const int* cross, int ninp,
                              const int* inp, void* stream) {
    return launch<float>(chi, s, f, out, flag, scratch, chg, P, n1, n2, n3,
                         backward, ncross, cross, ninp, inp, stream);
}

extern "C" int yt_gs_pass_f64(const void* chi, const void* s, const void* f,
                              void* out, void* flag, void* scratch, void* chg,
                              int P, int n1, int n2, int n3, int backward,
                              int ncross, const int* cross, int ninp,
                              const int* inp, void* stream) {
    return launch<double>(chi, s, f, out, flag, scratch, chg, P, n1, n2, n3,
                          backward, ncross, cross, ninp, inp, stream);
}
