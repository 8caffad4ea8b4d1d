// One Jacobi pass of the Yu-Trinkle flux operator: out = f + R s.
//
// Replaces critic2_tpu/ops/yt_pass.py::yt_pass (the Pallas kernel whose
// pallas_call is at line 126):
//   out[p, x] = f[p, x] + sum_k chi[k, x] * s[p, x + d_k]
// in the term order k = 0 .. K-1 (built with -fmad=false, so each term is
// one rounded product and one rounded sum, as in the plain PyTorch
// version: the result is the plain version's, bit for bit).
//
// Bound on an H100: bytes. Each point does K multiply-adds against
// (K + 3P) words of traffic (chi read once, f and s once per integrand,
// out written once), far under the ~20 flop/byte ridge.
//
// Design. One thread owns a grid point x for all P integrands: it loads
// chi[0..K-1, x] into registers once and then loops over p, so chi is
// read once and not once per integrand (the earlier one-thread-per-(p, x)
// kernel moved (K P + 3P) words, 2.4x the bound at P = 8). A block is a
// tile of YT_PASS_BY rows x YT_PASS_BX columns of one plane i, so the
// point's (i, j, l) come from blockIdx / threadIdx: no division and no
// modulo per point. The displacements arrive reduced to [0, n) on each
// axis, so a neighbour index wraps with one compare and subtract; the K
// neighbour offsets are computed once per point, as 32-bit offsets from
// the point (an integrand holds fewer than 2^31 points), and reused for
// every integrand; only the point's and the integrands' bases are 64-bit.
// The stencil's reuse stays on chip through the caches: a warp reads 32
// consecutive points of a row, the j +- 1 rows lie in the same block, and
// blocks run plane by plane, so the s planes i +- 1 are still in the 50 MB
// L2 when a neighbouring plane reads them. chi and f are read and out is
// written with streaming (evict-first) hints, which leaves L2 to the
// reused s planes.
#include "yt_common.cuh"

#define YT_PASS_BX 32     // columns of a block: one warp along the row
#define YT_PASS_BY 8      // rows of a block

template <typename T, int K>
__global__ void __launch_bounds__(YT_PASS_BX * YT_PASS_BY)
yt_pass_kernel(const T* __restrict__ chi, const T* __restrict__ s,
               const T* __restrict__ f, T* __restrict__ out, int P, int n1,
               int n2, int n3, YtDisp disp) {
    const int l = blockIdx.x * YT_PASS_BX + threadIdx.x;
    const int j = blockIdx.y * YT_PASS_BY + threadIdx.y;
    const int i = blockIdx.z;
    if (l >= n3 || j >= n2) return;
    const int plane = n2 * n3;
    const int64_t N = (int64_t)plane * n1;
    const int r = j * n3 + l;
    const int64_t x = (int64_t)i * plane + r;
    T c[K];
    int dx[K];          // neighbour k's offset from x
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c[k] = __ldcs(chi + k * N + x);
        int ii = i + disp.d[k][0];
        int jj = j + disp.d[k][1];
        int ll = l + disp.d[k][2];
        if (ii >= n1) ii -= n1;
        if (jj >= n2) jj -= n2;
        if (ll >= n3) ll -= n3;
        dx[k] = (ii - i) * plane + (jj * n3 + ll - r);
    }
    for (int p = 0; p < P; ++p) {
        const T* sx = s + p * N + x;
        T acc = __ldcs(f + p * N + x);
#pragma unroll
        for (int k = 0; k < K; ++k) acc = acc + c[k] * sx[dx[k]];
        __stcs(out + p * N + x, acc);
    }
}

// the kernel instance for K terms (1 <= K <= YT_MAXK)
template <typename T, int KMAX = YT_MAXK>
static void launch_k(int K, dim3 grid, dim3 block, cudaStream_t stream,
                     const T* chi, const T* s, const T* f, T* out, int P,
                     int n1, int n2, int n3, const YtDisp& d) {
    if constexpr (KMAX > 0) {
        if (K == KMAX)
            yt_pass_kernel<T, KMAX><<<grid, block, 0, stream>>>(
                chi, s, f, out, P, n1, n2, n3, d);
        else
            launch_k<T, KMAX - 1>(K, grid, block, stream, chi, s, f, out, P,
                                  n1, n2, n3, d);
    }
}

template <typename T>
static int launch(const void* chi, const void* s, const void* f, void* out,
                  int P, int n1, int n2, int n3, int K, const int* disp,
                  void* stream) {
    YtDisp d;
    int err = yt_fill_disp(&d, K, disp);
    if (err) return err;
    if (K < 1 || P < 0 || n1 < 0 || n2 < 0 || n3 < 0)
        return (int)cudaErrorInvalidValue;
    if ((int64_t)P * n1 * n2 * n3 == 0) return 0;
    const unsigned gx = (n3 + YT_PASS_BX - 1) / YT_PASS_BX;
    const unsigned gy = (n2 + YT_PASS_BY - 1) / YT_PASS_BY;
    // grid limits and 32-bit offsets within an integrand
    if (n1 > 65535 || gy > 65535 || (int64_t)n1 * n2 * n3 > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    // each displacement reduced to [0, n): one compare wraps it
    const int n[3] = {n1, n2, n3};
    for (int k = 0; k < K; ++k)
        for (int a = 0; a < 3; ++a)
            d.d[k][a] = ((d.d[k][a] % n[a]) + n[a]) % n[a];
    launch_k<T>(K, dim3(gx, gy, n1), dim3(YT_PASS_BX, YT_PASS_BY),
                (cudaStream_t)stream, (const T*)chi, (const T*)s,
                (const T*)f, (T*)out, P, n1, n2, n3, d);
    return (int)cudaGetLastError();
}

extern "C" int yt_pass_f32(const void* chi, const void* s, const void* f,
                           void* out, int P, int n1, int n2, int n3, int K,
                           const int* disp, void* stream) {
    return launch<float>(chi, s, f, out, P, n1, n2, n3, K, disp, stream);
}

extern "C" int yt_pass_f64(const void* chi, const void* s, const void* f,
                           void* out, int P, int n1, int n2, int n3, int K,
                           const int* disp, void* stream) {
    return launch<double>(chi, s, f, out, P, n1, n2, n3, K, disp, stream);
}
