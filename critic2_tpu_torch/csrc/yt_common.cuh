// Shared definitions of the Yu-Trinkle flux-operator kernels.
//
// Layout: chi is (K, n1, n2, n3), s / f / out are (P, n1, n2, n3), all
// C-contiguous. The value point x needs from neighbour k is s[x + d_k]
// with d_k = -o_k (adjoint, chi already shifted) or +o_k (forward),
// wrapped periodically on all three axes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define YT_MAXK 14

__device__ __forceinline__ int yt_wrap(int a, int n) {
    a %= n;
    return a < 0 ? a + n : a;
}

// Build a by-value displacement table from a host array of K (d0, d1, d2).
struct YtDisp {
    int k;
    int d[YT_MAXK][3];
};

static inline int yt_fill_disp(YtDisp* out, int K, const int* disp) {
    if (K < 0 || K > YT_MAXK) return (int)cudaErrorInvalidValue;
    out->k = K;
    for (int k = 0; k < K; ++k)
        for (int a = 0; a < 3; ++a) out->d[k][a] = disp[3 * k + a];
    return 0;
}
