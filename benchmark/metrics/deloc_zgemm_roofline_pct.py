"""deloc_zgemm_roofline_pct: the least time of the complex128 matrix
products of the traced window over the device time of the kernels that
ran them. The least time is the program's count `deloc.zgemm_flops` (8 m
n k real flops a product: the U rotation, the Wannier stack's phase
matrix, the basin overlaps and Fa's traces) over the FP64 Tensor Cores'
67 TFLOP/s; the time is that of every launch in the window whose name
holds one of KERNELS, cuBLAS's complex128 GEMM and GEMV kernels as the
card's profiler names them (H100, CUDA 12.8: sm90_xmma_gemm_cf64cf64_*
for the stack, the overlaps and Fa; gemv2N_kernel<int, int, double2, ...>
for the U rotation). None where the record holds no such count
or the window no such launch."""
from benchmark.lib import program_trace, roofline

KERNELS = ("gemm_cf64cf64", "zgemm", "gemv2N_kernel<int, int, double2",
           "gemv2T_kernel_val<int, int, double2")


def read(run):
    rec = program_trace.record()
    if run.trace is None or rec is None:
        return None
    flops = rec["counters"].get("deloc.zgemm_flops")
    if not flops:
        return None
    lo, hi = run.trace.window
    busy = sum((e - s) / 1e6 for s, e, name in run.trace.kernels()
               if lo <= s <= hi and any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    return 100.0 * roofline.least_seconds_flops(flops) / busy
