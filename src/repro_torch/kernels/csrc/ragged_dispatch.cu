// Sort-based ragged MoE dispatch: gather, grouped expert matmul, combine.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/ragged_dispatch.py, which run in every MoE layer of
// prefill and decode under dispatch="ragged":
//   ragged_gather         xs[i] = x[src[i]] * valid[i]
//   ragged_expert_matmul  row block i: xs_i @ W[be[i]] (+ (xs_i@A[e])@B[e]·scale)
//   ragged_combine        out[t] = sum_j wrank[t,j] * eo[rows[t,j]]
//
// Bound on the H100: bytes, for all three.  The gather and the combine move
// rows and do at most one FMA per element.  The grouped matmul at serving
// batch sizes multiplies a few rows per expert by a whole 2048x1024 expert
// slab: about 2·rows FLOPs per weight byte, far below the ~295 FLOP/byte
// where bf16 tensor cores would become the limit, so it is the expert
// weights' bytes that bound it.
//
// Design (simple and right first):
//  * gather / combine: one block per output row, 16-byte vector loads when
//    the row is 16-byte aligned (scalar otherwise), fp32 accumulation in
//    the combine, no atomics (the combine only gathers).
//  * matmul: one block of 8 warps per (row block, 128-column tile).  The
//    block reads block_expert[i] itself, stages its rows (in chunks of 8)
//    in shared memory as fp32, and each warp walks a strided eighth of K:
//    lane l loads 4 adjacent weights of one W row (a warp reads 256
//    contiguous bytes) and keeps an 8x4 fp32 accumulator.  The 8 partial
//    sums are reduced through shared memory in a fixed order, the optional
//    LoRA bypass (x@A computed once per chunk into shared memory) is added
//    as acc + (xa@B)·scale, and the result is cast once.  No tensor cores:
//    at these row counts the weight bytes, not the FLOPs, bound it.
#include "common.cuh"

namespace {

// ------------------------------------------------------------------ gather
template <typename T, bool VEC>
__global__ void ragged_gather_kernel(const T* __restrict__ x, const int* __restrict__ src,
                                     const int* __restrict__ valid, T* __restrict__ out,
                                     int D) {
  const int i = blockIdx.x;
  const int row = src[i];
  const bool keep = valid[i] != 0;
  if (VEC) {
    const int nv = D / rt::Vec<T>::N;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)i * D);
    for (int c = threadIdx.x; c < nv; c += blockDim.x)
      orow[c] = keep ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  } else {
    const T* xr = x + (size_t)row * D;
    T* orow = out + (size_t)i * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x)
      orow[c] = keep ? xr[c] : rt::from_f<T>(0.f);
  }
}

// ----------------------------------------------------------------- combine
template <typename T, bool VEC>
__global__ void ragged_combine_kernel(const T* __restrict__ eo, const int* __restrict__ rows,
                                      const float* __restrict__ wrank, T* __restrict__ out,
                                      int D, int max_k) {
  const int t = blockIdx.x;
  const int* rt_ = rows + (size_t)t * max_k;
  const float* wt = wrank + (size_t)t * max_k;
  if (VEC) {
    constexpr int V = rt::Vec<T>::N;
    const int nv = D / V;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      float acc[V], val[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int j = 0; j < max_k; ++j) {
        const float w = wt[j];
        const uint4 u = reinterpret_cast<const uint4*>(eo + (size_t)rt_[j] * D)[c];
        rt::unpack<T>(u, val);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += val[e] * w;
      }
      reinterpret_cast<uint4*>(out + (size_t)t * D)[c] = rt::pack<T>(acc);
    }
  } else {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < max_k; ++j) acc += rt::to_f(eo[(size_t)rt_[j] * D + c]) * wt[j];
      out[(size_t)t * D + c] = rt::from_f<T>(acc);
    }
  }
}

// ------------------------------------------------------------------ matmul
constexpr int MM_WARPS = 8;
constexpr int MM_THREADS = 32 * MM_WARPS;
constexpr int MM_COLS = 128;  // 32 lanes x 4 adjacent columns
constexpr int RB = 8;         // rows per chunk held in registers

__host__ __device__ __forceinline__ size_t stage_floats(int K) {
  const size_t rows = (size_t)RB * K, partials = (size_t)MM_WARPS * RB * MM_COLS;
  return rows > partials ? rows : partials;
}

template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* p, int c, int H, float* out) {
  if (VEC) {  // H % 4 == 0 and c % 4 == 0: one 8- or 16-byte load
    if (c < H) {
      if (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + c);
        out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p + c);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = rt::to_f(e[q]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = (c + q < H) ? rt::to_f(p[c + q]) : 0.f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(MM_THREADS)
ragged_matmul_kernel(const T* __restrict__ xs, const int* __restrict__ block_expert,
                     const T* __restrict__ w, const T* __restrict__ a,
                     const T* __restrict__ bm_, T* __restrict__ out, int K, int H,
                     int bm, int r, float scale) {
  extern __shared__ float sm[];
  float* xsm = sm;  // RB x K (staged rows, fp32)
  float* red = sm;  // MM_WARPS x RB x MM_COLS (reuses the staging area)
  float* xa = sm + stage_floats(K);  // RB x r

  const int blk = blockIdx.x;
  const int h0 = blockIdx.y * MM_COLS;
  const int e = block_expert[blk];
  const T* W = w + (size_t)e * K * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = h0 + lane * 4;

  for (int rc = 0; rc < bm; rc += RB) {
    const size_t row0 = (size_t)blk * bm + rc;
    const int nrows = min(RB, bm - rc);
    __syncthreads();
    for (int i = tid; i < RB * K; i += MM_THREADS) {
      const int rr = i / K, kk = i % K;
      xsm[i] = rr < nrows ? rt::to_f(xs[(row0 + rr) * K + kk]) : 0.f;
    }
    __syncthreads();
    if (a != nullptr) {
      const T* A = a + (size_t)e * K * r;
      for (int i = tid; i < RB * r; i += MM_THREADS) {
        const int rr = i / r, j = i % r;
        float s = 0.f;
        for (int kk = 0; kk < K; ++kk) s += xsm[rr * K + kk] * rt::to_f(A[(size_t)kk * r + j]);
        xa[i] = s;
      }
    }

    float acc[RB][4];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[rr][q] = 0.f;
#pragma unroll 4
    for (int kk = warp; kk < K; kk += MM_WARPS) {
      float wv[4];
      load4<T, VEC>(W + (size_t)kk * H, c0, H, wv);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const float xv = xsm[rr * K + kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] = fmaf(xv, wv[q], acc[rr][q]);
      }
    }
    __syncthreads();  // everyone is done reading xsm before red overwrites it
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[((size_t)warp * RB + rr) * MM_COLS + lane * 4 + q] = acc[rr][q];
    __syncthreads();
    const T* B = bm_ == nullptr ? nullptr : bm_ + (size_t)e * r * H;
    for (int i = tid; i < RB * MM_COLS; i += MM_THREADS) {
      const int rr = i / MM_COLS, cc = i % MM_COLS, c = h0 + cc;
      if (rr >= nrows || c >= H) continue;
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < MM_WARPS; ++wp) s += red[((size_t)wp * RB + rr) * MM_COLS + cc];
      if (B != nullptr) {
        float l = 0.f;
        for (int j = 0; j < r; ++j) l += xa[rr * r + j] * rt::to_f(B[(size_t)j * H + c]);
        s = s + l * scale;
      }
      out[(row0 + rr) * H + c] = rt::from_f<T>(s);
    }
  }
}

template <typename T>
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int rt_ragged_gather(const void* x, const int* src, const int* valid,
                                void* out, int dtype, int N, int D,
                                cudaStream_t stream) {
  if (N == 0 || D == 0) return (int)cudaGetLastError();
  RT_DISPATCH(dtype, T, {
    const bool vec = (D % rt::Vec<T>::N) == 0 && aligned16<T>(x) && aligned16<T>(out);
    const int threads = 256;
    if (vec)
      ragged_gather_kernel<T, true><<<N, threads, 0, stream>>>(
          static_cast<const T*>(x), src, valid, static_cast<T*>(out), D);
    else
      ragged_gather_kernel<T, false><<<N, threads, 0, stream>>>(
          static_cast<const T*>(x), src, valid, static_cast<T*>(out), D);
  });
  return (int)cudaGetLastError();
}

extern "C" int rt_ragged_combine(const void* eo, const int* rows, const float* wrank,
                                 void* out, int dtype, int n_tok, int max_k, int D,
                                 cudaStream_t stream) {
  if (n_tok == 0 || D == 0) return (int)cudaGetLastError();
  RT_DISPATCH(dtype, T, {
    const bool vec = (D % rt::Vec<T>::N) == 0 && aligned16<T>(eo) && aligned16<T>(out);
    const int threads = 256;
    if (vec)
      ragged_combine_kernel<T, true><<<n_tok, threads, 0, stream>>>(
          static_cast<const T*>(eo), rows, wrank, static_cast<T*>(out), D, max_k);
    else
      ragged_combine_kernel<T, false><<<n_tok, threads, 0, stream>>>(
          static_cast<const T*>(eo), rows, wrank, static_cast<T*>(out), D, max_k);
  });
  return (int)cudaGetLastError();
}

// a/b may be null (no LoRA bypass); r is then ignored.
extern "C" int rt_ragged_expert_matmul(const void* xs, const int* block_expert,
                                       const void* w, const void* a, const void* b,
                                       void* out, int dtype, int N, int nb, int K,
                                       int H, int r, float scale, cudaStream_t stream) {
  if (nb == 0 || N % nb) return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0) return (int)cudaGetLastError();
  const int bm = N / nb;
  const bool lora = a != nullptr && b != nullptr;
  if (!lora) r = 0;
  const size_t smem = (stage_floats(K) + (size_t)RB * r) * sizeof(float);
  dim3 grid(nb, (H + MM_COLS - 1) / MM_COLS);
  RT_DISPATCH(dtype, T, {
    const bool vec = (H % 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T))) == 0;
    auto kern = vec ? &ragged_matmul_kernel<T, true> : &ragged_matmul_kernel<T, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, MM_THREADS, smem, stream>>>(
        static_cast<const T*>(xs), block_expert, static_cast<const T*>(w),
        lora ? static_cast<const T*>(a) : nullptr, lora ? static_cast<const T*>(b) : nullptr,
        static_cast<T*>(out), K, H, bm, r, scale);
  });
  return (int)cudaGetLastError();
}
