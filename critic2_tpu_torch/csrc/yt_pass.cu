// One Jacobi pass of the Yu-Trinkle flux operator: out = f + R s.
//
// Replaces critic2_tpu/ops/yt_pass.py::yt_pass (the Pallas kernel whose
// pallas_call is at line 126):
//   out[p, x] = f[p, x] + sum_k chi[k, x] * s[p, x + d_k]
// in the term order k = 0 .. K-1 (built with -fmad=false, so each term is
// one rounded product and one rounded sum, as in the plain PyTorch version).
//
// Bound on an H100: bytes. Each point does K multiply-adds against
// (K + 3P) words of traffic, far under the ~20 flop/byte ridge. Design: one
// thread per (p, x) in a grid-stride loop; consecutive threads take
// consecutive points of the fastest axis, so the chi / f / out streams and
// the shifted s reads are coalesced. The K shifted reads of s hit the same
// few planes, which stay in L1/L2; no shared-memory tiling yet.
#include "yt_common.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
yt_pass_kernel(const T* __restrict__ chi, const T* __restrict__ s,
               const T* __restrict__ f, T* __restrict__ out, int P, int n1,
               int n2, int n3, YtDisp disp) {
    const int64_t plane = (int64_t)n2 * n3;
    const int64_t N = (int64_t)n1 * plane;
    const int64_t total = (int64_t)P * N;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         q < total; q += stride) {
        const int64_t p = q / N;
        const int64_t x = q - p * N;
        const int i = (int)(x / plane);
        const int r = (int)(x - i * plane);
        const int j = r / n3;
        const int l = r - j * n3;
        const T* sp = s + p * N;
        T acc = f[q];
        for (int k = 0; k < disp.k; ++k) {
            const int ii = yt_wrap(i + disp.d[k][0], n1);
            const int jj = yt_wrap(j + disp.d[k][1], n2);
            const int ll = yt_wrap(l + disp.d[k][2], n3);
            acc = acc + chi[k * N + x] * sp[ii * plane + (int64_t)jj * n3 + ll];
        }
        out[q] = acc;
    }
}

template <typename T>
static int launch(const void* chi, const void* s, const void* f, void* out,
                  int P, int n1, int n2, int n3, int K, const int* disp,
                  void* stream) {
    YtDisp d;
    int err = yt_fill_disp(&d, K, disp);
    if (err) return err;
    const int64_t total = (int64_t)P * n1 * n2 * n3;
    if (total == 0) return 0;
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;   // grid-stride beyond this
    yt_pass_kernel<T><<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const T*)chi, (const T*)s, (const T*)f, (T*)out, P, n1, n2, n3, d);
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
