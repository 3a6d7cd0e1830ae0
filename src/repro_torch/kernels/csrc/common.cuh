// Shared helpers of the port's CUDA kernels (built for sm_90a with nvcc,
// bound to PyTorch through a plain C interface and ctypes).
//
// Element types are passed from Python as an int code (RT_F32, RT_BF16,
// RT_F16); RT_DISPATCH instantiates the templated launcher for each.
// Every C entry point returns cudaGetLastError() after its launch, so a
// refused launch (too many threads, too much shared memory) reaches the
// Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_F32 0
#define RT_BF16 1
#define RT_F16 2

#define RT_DISPATCH(code, T, ...)                 \
  switch (code) {                                 \
    case RT_F32: {                                \
      using T = float;                            \
      __VA_ARGS__;                                \
      break;                                      \
    }                                             \
    case RT_BF16: {                               \
      using T = __nv_bfloat16;                    \
      __VA_ARGS__;                                \
      break;                                      \
    }                                             \
    case RT_F16: {                                \
      using T = __half;                           \
      __VA_ARGS__;                                \
      break;                                      \
    }                                             \
    default:                                      \
      return (int)cudaErrorInvalidValue;          \
  }

// The 16-bit types only (the tensor-core route); float32 is the caller's
// other branch.
#define RT_DISPATCH_16(code, T, ...)              \
  switch (code) {                                 \
    case RT_BF16: {                               \
      using T = __nv_bfloat16;                    \
      __VA_ARGS__;                                \
      break;                                      \
    }                                             \
    case RT_F16: {                                \
      using T = __half;                           \
      __VA_ARGS__;                                \
      break;                                      \
    }                                             \
    default:                                      \
      return (int)cudaErrorInvalidValue;          \
  }

#define RT_NEG_INF (-1e30f)  // the reference's mask value

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// round-to-nearest-even, as torch's .to(dtype)
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// 16-byte vectors: VEC<T> elements per uint4.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  return u;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rt
