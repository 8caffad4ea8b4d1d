// One plane-ordered Gauss-Seidel sweep of s = f + R s along grid axis 0
// or 1.
//
// Replaces critic2_tpu/ops/yt_pass.py::yt_gs_pass (the Pallas kernel whose
// pallas_call is at line 292), with the same semantics
// (yt_pass.py:195-269), which sweeps along axis 0:
//   * planes i = 0 .. n1-1 in order (n1-1 .. 0 when `backward`);
//   * base = f[:, i] + sum over the cross-plane neighbours (those with
//     d0 < 0 first, then d0 > 0, each in k order) of chi[k, i] * nb, where
//     nb is read from the swept planes when its plane lies on the already
//     swept side and did not wrap around the periodic boundary, and from
//     the old `s` otherwise;
//   * the in-plane sub-system u = base + sum_{d0 == 0} chi[k, i] * u[+d]
//     is solved exactly, warm-started from the plane's old value, until no
//     point changes;
//   * the plane is written to `out` and "changed versus the old s" is OR-ed
//     into the int32 flag.
// Built with -fmad=false, so every term is one rounded product and one
// rounded sum, as in the plain PyTorch version.
//
// Along axis 1 the same holds with the grid's axes 0 and 1 exchanged: the
// planes are (n1, n3), d0 is a displacement's axis-1 step and (d1, d2)
// its (axis 0, axis 2) steps. The sweep addresses a plane point (u, v) as
// i * sa + u * su + v in the grid (sa, su: the plane and row strides) and
// as u * nv + v in the plane-sized exchange buffers. The axis is a
// template argument: along axis 0 the two in-plane offsets coincide, the
// tile keeps one table of them, and the instances (yt_gs_kernel) compile
// to a sweep with no axis to choose; along axis 1 (yt_gs_kernel_axis1) a
// third table holds the tile's and its halo's grid offsets. z is the
// contiguous row of a plane either way.
//
// Why any schedule of the in-plane solve gives the same bits: the in-plane
// operator is nilpotent (its dependency graph is a DAG in density-rank
// order). At a stationary state every point holds the one rounded
// expression base + sum chi * u[nb] of values that are themselves final,
// so the fixpoint is unique, and every schedule that stops at bitwise
// stationarity reaches it.
//
// Design for Hopper. The TPU held a whole plane in VMEM and ran the
// in-plane loop there. A 256^2 plane of u, base and the in-plane chi does
// not fit one SM's shared memory, so the plane is cut into tiles, one per
// block, that stay resident for the whole launch:
//   * a persistent cooperative kernel; block b owns the (ty, tz) tile b of
//     the (y, z) plane for all P, for every plane; the wrapper chooses the
//     tile so that the tile count is at most the co-resident block count
//     (checked here with the occupancy calculator);
//   * per plane, the block computes its tile's base from the cross-plane
//     neighbours and loads the in-plane chi and the warm start, with a
//     halo of width h (the largest in-plane |d1|, |d2|) in shared memory;
//     when the tile has at most one point per thread, or up to
//     YT_GS_MAX_PPT in float at P <= 2, each point's chi, base and
//     current value stay in its thread's registers;
//   * rounds of block-Jacobi over the tiles: in a round each block iterates
//     its tile by Jacobi in shared memory, behind __syncthreads_or, until
//     it is bitwise stationary with its halo held fixed or has taken
//     YT_GS_LOCAL_CAP iterations, publishes the tile to a plane-sized
//     exchange buffer and meets the others at ONE grid barrier; the next
//     round reloads the halo from that buffer. The rounds end when every
//     tile is stationary and none changed a point within h of its edge
//     (only those points are ever another tile's halo), which is global
//     stationarity;
//   * the exchange buffers alternate between rounds (round G reads buffer
//     G % 2 and writes buffer (G + 1) % 2), so no block reads a halo that
//     another block is rewriting in the same round; the last round's
//     buffer is also where the next plane reads this plane from, so a
//     plane costs exactly its rounds in grid barriers.
// The earlier schedule of this kernel (global Jacobi, one grid barrier per
// in-plane iteration plus one per plane) paid the longest in-plane chain in
// grid barriers; this one pays it in block-local iterations, and a grid
// barrier per round.
//
// Bound on an H100: bytes for the (K + 3P) words per point of one sweep.
// In practice the block-local iterations of the slowest tile in each round
// (instruction issue and the block barrier) and the grid barriers of the
// rounds. There is no product to tile, so tensor cores do nothing here,
// and the plane set-up is a few per cent of the time, so it is not
// overlapped with asynchronous copies. Every
// load of data written inside this launch (the swept planes, the exchange
// buffers) uses ld.global.cg (__ldcg) so no stale L1 line is read.
//
// Counters (int64, accumulated over launches into `counts`):
//   [0] grid barriers (= tile rounds summed over planes),
//   [1] block 0's local iterations summed over planes.
#include <cooperative_groups.h>

#include <cstdlib>

#include "yt_common.cuh"

namespace cg = cooperative_groups;

#define YT_GS_THREADS 512
// the most local iterations a tile takes in one round: past it, a tile
// re-walks chains whose halo is about to change, and another round is
// cheaper. 12 was the fastest of 4 to 32 and uncapped on the 256^3 NaCl
// analogue (PERF.md).
#define YT_GS_LOCAL_CAP 12
#define YT_GS_EDGE (1 << 30)    // bit of a tile point's offset entry
// the most tile points a thread holds in registers (float, P <= 2): 4 x
// 512 points a tile, 132 tiles, cover a 512^2 plane
#define YT_GS_MAX_PPT 4

struct GsDisp {
    int ncross;                 // cross-plane neighbours, summation order
    int kc[YT_MAXK];
    int dc[YT_MAXK][3];
    int ninp;                   // in-plane neighbours, summation order
    int ki[YT_MAXK];
    int di[YT_MAXK][2];
};

// The sweep. PM: the largest P this instance serves; the P integrands of a
// point live in registers, so one point's neighbour loads serve all of
// them. NI: the number of in-plane neighbours, or YT_MAXK for any count up
// to it; with NI fixed the neighbour loop unrolls and a point's loads issue
// together. PPT: the tile has at most PPT points per thread, whose
// in-plane chi, base and current value (and, at PM = 2, offset) then stay
// in that thread's registers for the whole plane, so a local iteration
// reads only the neighbours from shared memory, and the PPT points' loads
// issue together; PPT = 0 keeps chi and base in shared memory and loops
// over the points. AX: the sweep runs along grid axis 1 (else 0, where sa
// and su are not read).
template <typename T, int PM, int NI, int PPT, bool AX>
__device__ __forceinline__ void yt_gs_sweep(
    const T* __restrict__ chi, const T* __restrict__ s,
    const T* __restrict__ f, T* out, int* flag, T* xb0, T* xb1, int* chg,
    long long* counts, int P, int na, int nu, int nv, int sa, int su,
    int backward, int h, int TY, int TZ, const GsDisp& g) {
    extern __shared__ __align__(16) unsigned char yt_smem[];
    __shared__ int nring;
    constexpr int RP = PPT > 0 ? PPT : 1;   // register slots of a thread
    // the points' lo_s entries in registers too, where the P <= 2 state
    // leaves room (at PM = 8 they would push it out to spills)
    constexpr bool HOLD_LO = PPT > 0 && PM <= 2;

    cg::grid_group grid = cg::this_grid();
    const int A = TY * TZ;                 // tile points
    const int Wz = TZ + 2 * h;             // halo'd row length
    const int W = (TY + 2 * h) * Wz;       // halo'd tile points
    const int AS = PPT ? 0 : A;            // points kept in shared memory
    T* chi_s = (T*)yt_smem;                // ninp x AS
    T* base_s = chi_s + g.ninp * AS;       // P x AS
    T* ua = base_s + P * AS;               // P x W, two Jacobi buffers
    T* ub = ua + P * W;
    int* lo_s = (int*)(ub + P * W);        // A: offset in ua (| EDGE), or -1
    int* yz_s = lo_s + A;                  // A: y * nv + z
    int* gyz_s = yz_s + (AX ? A : 0);      // A: y * su + z (axis 0: yz_s)
    int* rw_s = gyz_s + A;                 // halo ring: offset in ua
    int* ryz_s = rw_s + (W - A);           // halo ring: y * nv + z
    int* rgyz_s = ryz_s + (AX ? W - A : 0);   // halo ring: y * su + z

    // (y, z) below is a plane point (u, v)
    const int gz = (nv + TZ - 1) / TZ;
    const int y0 = (blockIdx.x / gz) * TY;
    const int z0 = (blockIdx.x % gz) * TZ;
    const int ny = min(TY, nu - y0);
    const int nz = min(TZ, nv - z0);
    const int64_t plane = (int64_t)nu * nv;   // an exchange buffer's plane
    const int64_t N = (int64_t)na * plane;
    const int64_t pstride = AX ? (int64_t)sa : plane;   // the grid's
    const int tid = threadIdx.x;
    const int bd = blockDim.x;
    const bool lead = blockIdx.x == 0 && tid == 0;   // counts, flag slots

    // the tile's tables, once per launch
    const int ninp = NI == YT_MAXK ? g.ninp : NI;
    int doff[NI];                          // in-plane neighbour offsets
#pragma unroll
    for (int c = 0; c < NI; ++c)
        doff[c] = c < ninp ? g.di[c][0] * Wz + g.di[c][1] : 0;
    // a thread's tile points are l = tid + j * bd: PPT of them, unrolled
    // (j indexes the registers), or the strided loop over the tile
    int rlo[RP];                           // HOLD_LO: the points' lo_s
    if (tid == 0) nring = 0;
#pragma unroll
    for (int j = 0, l = tid; PPT ? j < PPT : l < A; ++j, l += bd) {
        if constexpr (HOLD_LO) rlo[j] = -1;
        if (l >= A) continue;
        const int ly = l / TZ;
        const int lz = l - ly * TZ;
        const bool in = ly < ny && lz < nz;
        const bool edge = ly < h || ly >= ny - h || lz < h || lz >= nz - h;
        const int lo = in ? ((ly + h) * Wz + lz + h) | (edge ? YT_GS_EDGE : 0)
                          : -1;
        lo_s[l] = lo;
        if constexpr (HOLD_LO) rlo[j] = lo;
        yz_s[l] = (y0 + ly) * nv + z0 + lz;
        if constexpr (AX) gyz_s[l] = (y0 + ly) * su + z0 + lz;
    }
    __syncthreads();
    for (int w = tid; w < W; w += bd) {
        const int ly = w / Wz - h;
        const int lz = w % Wz - h;
        if (ly >= ny + h || lz >= nz + h) continue;
        if (ly >= 0 && ly < ny && lz >= 0 && lz < nz) continue;
        const int j = atomicAdd(&nring, 1);
        const int y = yt_wrap(y0 + ly, nu);
        const int z = yt_wrap(z0 + lz, nv);
        rw_s[j] = w;
        ryz_s[j] = y * nv + z;
        if constexpr (AX) rgyz_s[j] = y * su + z;
    }
    __syncthreads();

    unsigned G = 0;             // rounds so far, the same in every block
    long long nlocal = 0;       // this block's local iterations
    int changed = 0;
    T rch[RP][NI], rbs[RP][PM], rown[RP][PM];    // PPT: the thread's points

    for (int step = 0; step < na; ++step) {
        const int i = backward ? na - 1 - step : step;
        const int iprev = backward ? i + 1 : i - 1;
        const int64_t ioff = (int64_t)i * pstride;
        const T* prev = (G & 1) ? xb1 : xb0;   // plane iprev, if swept
        T* cur = ua;
        T* nxt = ub;

        // 1. the tile's in-plane chi, base and warm start
#pragma unroll
        for (int j = 0, l = tid; PPT ? j < PPT : l < A; ++j, l += bd) {
            const int lo = HOLD_LO ? rlo[j] : l < A ? lo_s[l] : -1;
            if (lo < 0) continue;
            const int o = lo & (YT_GS_EDGE - 1);
            const int yz = yz_s[l];
            const int y = yz / nv;
            const int z = yz - y * nv;
            const int64_t gyz = ioff + (AX ? gyz_s[l] : yz);
#pragma unroll
            for (int c = 0; c < NI; ++c) {
                if (c < ninp) {
                    const T v = chi[g.ki[c] * N + gyz];
                    if constexpr (PPT > 0) rch[j][c] = v;
                    else chi_s[c * A + l] = v;
                }
            }
            T acc[PM];
#pragma unroll
            for (int p = 0; p < PM; ++p)
                if (p < P) acc[p] = f[p * N + gyz];
            for (int c = 0; c < g.ncross; ++c) {
                const int d0 = g.dc[c][0];
                const int ii = i + d0;
                const bool wrapped = ii < 0 || ii >= na;
                const bool swept = backward ? d0 > 0 : d0 < 0;
                const int ny_ = yt_wrap(y + g.dc[c][1], nu);
                const int nz_ = yt_wrap(z + g.dc[c][2], nv);
                const int64_t nyz = (int64_t)ny_ * nv + nz_;
                const int64_t gnyz = AX ? (int64_t)ny_ * su + nz_ : nyz;
                // the swept side: the previous plane from the exchange
                // buffer, older ones from out; else the old s
                const T* src;
                int64_t sp = N;
                if (swept && !wrapped && ii == iprev) {
                    src = prev + nyz;
                    sp = plane;
                } else if (swept && !wrapped) {
                    src = out + (int64_t)ii * pstride + gnyz;
                } else {
                    src = s + (int64_t)yt_wrap(ii, na) * pstride + gnyz;
                }
                const T ch = chi[g.kc[c] * N + gyz];
#pragma unroll
                for (int p = 0; p < PM; ++p)
                    if (p < P) acc[p] = acc[p] + ch * __ldcg(src + p * sp);
            }
#pragma unroll
            for (int p = 0; p < PM; ++p) {
                if (p < P) {
                    const T u = g.ninp ? s[p * N + gyz] : acc[p];
                    cur[p * W + o] = u;
                    if constexpr (PPT > 0) {
                        rbs[j][p] = acc[p];
                        rown[j][p] = u;
                    } else {
                        base_s[p * A + l] = acc[p];
                    }
                }
            }
        }
        __syncthreads();

        // 2. rounds. chg[] holds three flag slots: slot G % 3 is written
        // in round G and read after its barrier; the lead thread clears
        // slot (G + 1) % 3, whose last readers all passed the previous
        // barrier.
        for (int64_t r = 0;; ++r) {
            const int slot = G % 3;
            if (lead) chg[(G + 1) % 3] = 0;
            // the halo: the old s in round 0, else last round's buffer
            const T* hsrc = r == 0 ? s + ioff : ((G & 1) ? xb1 : xb0);
            const int* htab = AX && r == 0 ? rgyz_s : ryz_s;
            const int64_t hp = r == 0 ? N : plane;
            for (int j = tid; j < nring; j += bd) {
                const int w = rw_s[j];
                const T* src = hsrc + htab[j];
#pragma unroll
                for (int p = 0; p < PM; ++p) {
                    if (p < P) {
                        const T v = __ldcg(src + p * hp);
                        ua[p * W + w] = v;
                        ub[p * W + w] = v;
                    }
                }
            }
            __syncthreads();

            // local Jacobi cur -> nxt until the tile is stationary or has
            // taken YT_GS_LOCAL_CAP iterations; eany: a point within h of
            // the tile's edge changed this round, or the tile is not
            // stationary
            int eany = 0;
            if (g.ninp > 0) {
                for (int n = 0;; ++n) {
                    int any = 0;
#pragma unroll
                    for (int j = 0, l = tid; PPT ? j < PPT : l < A;
                         ++j, l += bd) {
                        const int lo = HOLD_LO ? rlo[j] : l < A ? lo_s[l] : -1;
                        if (lo < 0) continue;
                        const int o = lo & (YT_GS_EDGE - 1);
                        T ch[NI], un[PM];
#pragma unroll
                        for (int c = 0; c < NI; ++c)
                            if (c < ninp)
                                ch[c] = PPT ? rch[j][c] : chi_s[c * A + l];
#pragma unroll
                        for (int p = 0; p < PM; ++p)
                            if (p < P)
                                un[p] = PPT ? rbs[j][p] : base_s[p * A + l];
#pragma unroll
                        for (int c = 0; c < NI; ++c) {
                            if (c < ninp) {
                                const T* cp = cur + o + doff[c];
#pragma unroll
                                for (int p = 0; p < PM; ++p)
                                    if (p < P)
                                        un[p] = un[p] + ch[c] * cp[p * W];
                            }
                        }
#pragma unroll
                        for (int p = 0; p < PM; ++p) {
                            if (p < P) {
                                nxt[p * W + o] = un[p];
                                const int d = un[p] != (PPT ? rown[j][p]
                                                            : cur[p * W + o]);
                                if constexpr (PPT > 0) rown[j][p] = un[p];
                                any |= d;
                                eany |= d && (lo & YT_GS_EDGE);
                            }
                        }
                    }
                    ++nlocal;
                    if (!__syncthreads_or(any)) break;   // nxt == cur
                    T* t = cur;
                    cur = nxt;
                    nxt = t;
                    // (a nilpotent tile system is stationary within A + 1
                    // iterations, so A + 2 only stops a hang)
                    if (n + 1 >= min(YT_GS_LOCAL_CAP, A + 2)) {
                        eany = 1;                  // the next round goes on
                        break;
                    }
                }
            }

            // publish the tile to buffer (G + 1) % 2
            T* pub = (G & 1) ? xb0 : xb1;
#pragma unroll
            for (int j = 0, l = tid; PPT ? j < PPT : l < A; ++j, l += bd) {
                const int lo = HOLD_LO ? rlo[j] : l < A ? lo_s[l] : -1;
                if (lo < 0) continue;
                const int o = lo & (YT_GS_EDGE - 1);
#pragma unroll
                for (int p = 0; p < PM; ++p)
                    if (p < P)
                        pub[p * plane + yz_s[l]] =
                            PPT ? rown[j][p] : cur[p * W + o];
            }
            if (__syncthreads_or(eany) && tid == 0) atomicOr(chg + slot, 1);
            grid.sync();
            const int more = *(volatile int*)(chg + slot);
            ++G;
            if (!more) break;
            if (r > plane + 1) {
                if (lead) atomicOr(flag, 2);
                break;
            }
        }

        // 3. write the plane
#pragma unroll
        for (int j = 0, l = tid; PPT ? j < PPT : l < A; ++j, l += bd) {
            const int lo = HOLD_LO ? rlo[j] : l < A ? lo_s[l] : -1;
            if (lo < 0) continue;
            const int o = lo & (YT_GS_EDGE - 1);
            const int64_t yz = ioff + gyz_s[l];
#pragma unroll
            for (int p = 0; p < PM; ++p) {
                if (p < P) {
                    const T u = PPT ? rown[j][p] : cur[p * W + o];
                    out[p * N + yz] = u;
                    changed |= u != s[p * N + yz];
                }
            }
        }
        // the next plane's set-up rewrites only what each thread itself
        // read here, and the halo ring nobody reads here
    }
    if (__any_sync(0xffffffffu, changed) && (tid & 31) == 0)
        atomicOr(flag, 1);
    if (lead) {
        atomicAdd((unsigned long long*)counts, (unsigned long long)G);
        atomicAdd((unsigned long long*)(counts + 1),
                  (unsigned long long)nlocal);
    }
}

// The kernels along axis 0. RES: at most one tile point per thread, held
// in registers (else chi and base in shared memory); the instances with up
// to YT_GS_MAX_PPT points a thread in registers add that count as a fifth
// argument.
template <typename T, int PM, int NI, bool RES>
__global__ void __launch_bounds__(YT_GS_THREADS)
yt_gs_kernel(const T* __restrict__ chi, const T* __restrict__ s,
             const T* __restrict__ f, T* out, int* flag, T* xb0, T* xb1,
             int* chg, long long* counts, int P, int na, int nu, int nv,
             int sa, int su, int backward, int h, int TY, int TZ, GsDisp g) {
    yt_gs_sweep<T, PM, NI, RES ? 1 : 0, false>(chi, s, f, out, flag, xb0,
                                               xb1, chg, counts, P, na, nu,
                                               nv, sa, su, backward, h, TY,
                                               TZ, g);
}

template <typename T, int PM, int NI, bool RES, int PPT>
__global__ void __launch_bounds__(YT_GS_THREADS)
yt_gs_kernel(const T* __restrict__ chi, const T* __restrict__ s,
             const T* __restrict__ f, T* out, int* flag, T* xb0, T* xb1,
             int* chg, long long* counts, int P, int na, int nu, int nv,
             int sa, int su, int backward, int h, int TY, int TZ, GsDisp g) {
    static_assert(RES && PPT > 1 && PPT <= YT_GS_MAX_PPT, "1 < PPT <= max");
    yt_gs_sweep<T, PM, NI, PPT, false>(chi, s, f, out, flag, xb0, xb1, chg,
                                       counts, P, na, nu, nv, sa, su,
                                       backward, h, TY, TZ, g);
}

// The kernels along axis 1, one for each of the above: PPT 0 (shared
// memory), 1, or up to YT_GS_MAX_PPT points a thread in registers.
template <typename T, int PM, int NI, int PPT>
__global__ void __launch_bounds__(YT_GS_THREADS)
yt_gs_kernel_axis1(const T* __restrict__ chi, const T* __restrict__ s,
                   const T* __restrict__ f, T* out, int* flag, T* xb0,
                   T* xb1, int* chg, long long* counts, int P, int na,
                   int nu, int nv, int sa, int su, int backward, int h,
                   int TY, int TZ, GsDisp g) {
    yt_gs_sweep<T, PM, NI, PPT, true>(chi, s, f, out, flag, xb0, xb1, chg,
                                      counts, P, na, nu, nv, sa, su,
                                      backward, h, TY, TZ, g);
}

template <typename T>
using GsKernel = void (*)(const T*, const T*, const T*, T*, int*, T*, T*,
                          int*, long long*, int, int, int, int, int, int,
                          int, int, int, int, GsDisp);

// The instance for ninp in-plane neighbours and ppt register-held points a
// thread (0: the tile in shared memory). A lattice plane's neighbours are
// those of its own 2-D lattice, 4 (cubic, K = 6) or 6 (triclinic, K = 14),
// and these two have register-held instances: one point a thread at both
// widths, up to YT_GS_MAX_PPT in float at the charges' P <= 2 (at P <= 8,
// or in double, the state of more than one point a thread spills out of
// the 128 registers a thread has at 512 threads); any other count, and
// larger tiles, take the general one.
template <typename T, int PM, int NI, int PPT, bool AX>
static GsKernel<T> inst() {
    if constexpr (AX) return yt_gs_kernel_axis1<T, PM, NI, PPT>;
    else if constexpr (PPT > 1) return yt_gs_kernel<T, PM, NI, true, PPT>;
    else return yt_gs_kernel<T, PM, NI, PPT == 1>;
}

template <typename T, int PM, bool AX>
static GsKernel<T> pick(int ninp, int ppt) {
    if (ppt == 1 && ninp == 4) return inst<T, PM, 4, 1, AX>();
    if (ppt == 1 && ninp == 6) return inst<T, PM, 6, 1, AX>();
    if constexpr (PM == 2 && sizeof(T) == 4) {
        if (ppt == 2 && ninp == 4) return inst<T, PM, 4, 2, AX>();
        if (ppt == 3 && ninp == 4) return inst<T, PM, 4, 3, AX>();
        if (ppt == 4 && ninp == 4) return inst<T, PM, 4, 4, AX>();
        if (ppt == 2 && ninp == 6) return inst<T, PM, 6, 2, AX>();
        if (ppt == 3 && ninp == 6) return inst<T, PM, 6, 3, AX>();
        if (ppt == 4 && ninp == 6) return inst<T, PM, 6, 4, AX>();
    }
    if (ppt == 0) return inst<T, PM, YT_MAXK, 0, AX>();
    return nullptr;
}

template <typename T>
static int launch(const void* chi, const void* s, const void* f, void* out,
                  void* flag, void* xbuf, void* chg, void* counts, int P,
                  int n1, int n2, int n3, int axis, int backward, int ncross,
                  const int* cross, int ninp, const int* inp, int h, int TY,
                  int TZ, int ppt, int smem, void* stream) {
    GsDisp g;
    if (ncross < 0 || ninp < 0 || ncross + ninp > YT_MAXK || h < 0
        || TY < 1 || TZ < 1 || (axis != 0 && axis != 1))
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
        if (abs(g.di[c][0]) > h || abs(g.di[c][1]) > h)
            return (int)cudaErrorInvalidValue;   // halo narrower than |d|
    }
    if ((int64_t)P * n2 * n3 == 0 || n1 == 0) return 0;
    // along axis 1 a plane point's grid offset y * n2 * n3 + z is an int
    if (axis && (int64_t)n1 * n2 * n3 >= (int64_t)1 << 31)
        return (int)cudaErrorInvalidValue;
    // the sweep's planes: na of nu x nv points, at strides sa (plane) and
    // su (row) in the grid (not const: the launch takes their addresses);
    // along axis 0 the kernel reads neither
    int na = axis ? n2 : n1;
    int nu = axis ? n1 : n2;
    int nv = n3;
    int sa = axis ? n3 : n2 * n3;
    int su = axis ? n2 * n3 : n3;

    // the wrapper's plan (ops/yt_pass.py::gs_plan) chose the tile, whether
    // its points stay in registers and the shared memory; this only checks
    // the plan against the kernel's layout. T: in-plane chi and base
    // (unless in registers), two Jacobi buffers; int: the tile's tables
    const int64_t W = (int64_t)(TY + 2 * h) * (TZ + 2 * h);
    const int64_t A = (int64_t)TY * TZ;
    if (ppt && (ppt != (A + YT_GS_THREADS - 1) / YT_GS_THREADS
                || ppt > YT_GS_MAX_PPT
                || (ppt > 1 && (P > 2 || sizeof(T) != 4))
                || (ninp != 4 && ninp != 6)))
        return (int)cudaErrorInvalidValue;
    const int64_t AS = ppt ? 0 : A;
    const int64_t need = sizeof(T) * (ninp * AS + P * AS + 2 * P * W)
                         + sizeof(int) * (axis ? 3 : 2) * W;
    if (smem < need) return (int)cudaErrorInvalidValue;
    const int blocks = ((nu + TY - 1) / TY) * ((nv + TZ - 1) / TZ);
    // two register widths keep the build short: the charges' P = 2 and
    // labels' chunks of up to 8; each has its instances for either axis
    GsKernel<T> kernel = P <= 2   ? (axis ? pick<T, 2, true>(ninp, ppt)
                                          : pick<T, 2, false>(ninp, ppt))
                         : P <= 8 ? (axis ? pick<T, 8, true>(ninp, ppt)
                                          : pick<T, 8, false>(ninp, ppt))
                                  : nullptr;
    if (!kernel) return (int)cudaErrorInvalidValue;  // P > 8: chunked above

    int dev = 0, nsm = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
    // above 48 KB only after opting in, and before the occupancy query so
    // that the co-residency bound counts the real shared memory
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, YT_GS_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    // a grid larger than what is co-resident would deadlock at the barrier
    if ((int64_t)per_sm * nsm < blocks)
        return (int)cudaErrorCooperativeLaunchTooLarge;

    const T* chi_ = (const T*)chi;
    const T* s_ = (const T*)s;
    const T* f_ = (const T*)f;
    T* out_ = (T*)out;
    int* flag_ = (int*)flag;
    T* xb0_ = (T*)xbuf;
    T* xb1_ = xb0_ + (int64_t)P * nu * nv;
    int* chg_ = (int*)chg;
    long long* counts_ = (long long*)counts;
    void* args[] = {&chi_, &s_, &f_, &out_, &flag_, &xb0_, &xb1_, &chg_,
                    &counts_, &P, &na, &nu, &nv, &sa, &su, &backward, &h,
                    &TY, &TZ, &g};
    e = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3((unsigned)blocks),
                                    dim3(YT_GS_THREADS), args,
                                    (size_t)smem,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The limits for the wrapper's tile plan: out[0] SMs, out[1] the shared
// memory a block may opt in to, out[2] cooperative launch support, out[3]
// threads per block.
extern "C" int yt_gs_limits(int* out) {
    int dev = 0;
    out[3] = YT_GS_THREADS;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(out + 2, cudaDevAttrCooperativeLaunch,
                                   dev);
    return (int)e;
}

// axis: 0 or 1, the grid axis swept; cross: ncross x (k, d0, d1, d2);
// inp: ninp x (k, d1, d2), both in the summation order and in the sweep's
// axes (d0 across the planes); h >= every in-plane |d1|, |d2|; (TY, TZ)
// the tile of a plane of the sweep; ppt:
// tile points a thread holds in registers, ceil(TY * TZ / threads) (at
// most YT_GS_MAX_PPT, above 1 only in float at P <= 2; ninp 4 or 6), or 0
// for the
// tile's state in shared memory; smem: dynamic shared memory bytes, at
// least the layout's.
// xbuf: 2 * P * (a plane's points) elements of T; chg: 3 int32 zeros;
// flag: 1 int32,
// OR-ed (the caller zeroes it); counts: 2 int64, accumulated; P <= 8.
#define YT_GS_ENTRY(NAME, T)                                                 \
    extern "C" int NAME(const void* chi, const void* s, const void* f,       \
                        void* out, void* flag, void* xbuf, void* chg,        \
                        void* counts, int P, int n1, int n2, int n3,         \
                        int axis, int backward, int ncross,                  \
                        const int* cross, int ninp, const int* inp, int h,   \
                        int TY, int TZ, int ppt, int smem, void* stream) {   \
        return launch<T>(chi, s, f, out, flag, xbuf, chg, counts, P, n1, n2, \
                         n3, axis, backward, ncross, cross, ninp, inp, h,    \
                         TY, TZ, ppt, smem, stream);                         \
    }
YT_GS_ENTRY(yt_gs_pass_f32, float)
YT_GS_ENTRY(yt_gs_pass_f64, double)
