"""Device time in float32 matrix-product kernels (cuBLAS and CUTLASS names
of single-precision GEMMs) over device busy time, in %: the adapters'
float32 backward."""
from portbench import readers

FP32_GEMM = r"(?i)(sgemm|gemm.*f32f32_f32f32|gemm.*_f32_f32|gemmk1_kernel<float|gemmSN_.*float|cutlass.*simt_sgemm)"


def read(rec):
    return readers.device_share(rec, FP32_GEMM)
