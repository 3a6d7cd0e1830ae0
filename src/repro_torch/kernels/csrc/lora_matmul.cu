// Fused LoRA matmul: y = x·W + (x·A)·B·scale, fp32 accumulation, one cast.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/lora_matmul.py,
// which share one kernel body (_lora_matmul_kernel):
//   lora_matmul          x (M,K), W (K,N), A (K,r), B (r,N) -> (M,N)
//                        the q/k/v/o adapters of layers.lora_dense;
//   lora_matmul_experts  x (E,C,K), W (E,K,N), A (E,K,r), B (E,r,N) -> (E,C,N)
//                        the expert SwiGLU of capacity/dense dispatch, the
//                        training hot spot.
// Both C entry points launch the same kernel: the 2-D one as one "expert",
// the stacked one with the expert on blockIdx.z and per-expert base offsets.
// What the Pallas kernel keeps out of HBM, this keeps too: the running x·A
// is accumulated in the same K loop as x·W from the same staged x tile, and
// the bypass (x·A)·B·scale is added in the epilogue before the single cast,
// so neither x·A nor the bypass ever reaches device memory.  The TPU grid
// carried its accumulators across a sequential K axis; here a block owns an
// output tile and walks K itself.
//
// Bound on the H100 at the training round's shapes: the expert w1/w3 at
// OLMoE FULL (E=64, K=2048, N=1024, r=20) reads W's 268 MB at every tier, so
// it is bound by bytes, 0.121 ms at k=8 (C=328) down to 0.088 ms at k=1
// (C=48); the attention projection (M=2048, K=N=2048, r=20) does 17.5 GFLOP
// over 25 MB, 0.018 ms, bound by operations.
//
// Route by dtype, chosen in the C entry points from the dtype code alone:
//
// * bf16 / fp16 — wg::lora_wgmma_kernel, on the tensor cores through
//   Hopper's warpgroup MMA: the mainloop and epilogue of wgmma_gemm.cuh
//   (shared with the grouped ragged expert matmul), one tile per block.  A
//   block of two warpgroups owns a 128 x 256 output tile at every tier (one
//   warpgroup where that pads M less was 13-18% slower at C = 168 and
//   within 2% at C = 48 on an H100, launch/ab_kernels.py); x·A is the
//   second wgmma, m64n24k16 (r <= 24) or m64n64k16 (r <= 64).  x and W
//   come by the TMA through 3-D maps (E, rows, cols), so a tile past an
//   expert's C rows is zero-filled and not read from the next expert.  The
//   M tile is the fastest grid index, so the blocks that share one
//   (expert, N) slab of W run together and read it from L2.  wgmma rather
//   than mma.sync: it runs asynchronously from shared memory, so the
//   tensor cores keep working while the warps issue the next tile's
//   copies, and it needs no ldmatrix traffic or fragment registers for x
//   and W.
// * float32 — simt::lora_matmul_kernel, on the FMA units: 256 threads per
//   64x128 tile, K in steps of 16 staged as fp32, 8x4 accumulators per
//   thread, x·A from the same staged x tile.  It keeps full fp32 products,
//   which the fp32 checks (1e-4 of the largest output) need and TF32 would
//   not hold.
#include "wgmma_gemm.cuh"

namespace {

struct Batch {  // per-expert element offsets (0 for the 2-D entry point)
  long long x, w, a, b, o;
};

namespace simt {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int XA_PER_THREAD = BM * RT_LORA_MAX_RANK / THREADS;  // 16

template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ bmat,
                   T* __restrict__ out, int M, int N, int K, int r, float scale,
                   Batch st) {
  __shared__ float xs[BM][BK];
  __shared__ __align__(16) float ws[BK][BN];
  __shared__ float as[BK][RT_LORA_MAX_RANK];
  __shared__ float xas[BM][RT_LORA_MAX_RANK];

  const int e = blockIdx.z;
  x += e * st.x;
  w += e * st.w;
  a += e * st.a;
  bmat += e * st.b;
  out += e * st.o;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid & 31;   // 4 columns each
  const int ty = tid >> 5;   // rows ty + 8 i (one warp = one ty)

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  float xa[XA_PER_THREAD];
#pragma unroll
  for (int j = 0; j < XA_PER_THREAD; ++j) xa[j] = 0.f;
  const int n_xa = BM * r;  // running x·A entries of this tile

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage x (BM x BK), W (BK x BN) and A (BK x r) as fp32, edges zeroed
#pragma unroll
    for (int j = 0; j < BM * BK / THREADS; ++j) {
      const int i = tid + j * THREADS, m = i / BK, kk = i % BK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[m][kk] = (gm < M && gk < K) ? rt::to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int i = tid + j * THREADS, kk = i / BN, n = i % BN;
      const int gk = k0 + kk, gn = n0 + n;
      ws[kk][n] = (gk < K && gn < N) ? rt::to_f(w[(size_t)gk * N + gn]) : 0.f;
    }
    for (int i = tid; i < BK * r; i += THREADS) {
      const int kk = i / r, c = i % r, gk = k0 + kk;
      as[kk][c] = gk < K ? rt::to_f(a[(size_t)gk * r + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = xs[ty + 8 * i][kk];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
    // the running x·A from the same staged x tile
#pragma unroll
    for (int j = 0; j < XA_PER_THREAD; ++j) {
      const int i = tid + j * THREADS;
      if (i < n_xa) {
        const int m = i / r, c = i % r;
        float s = xa[j];
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) s = fmaf(xs[m][kk], as[kk][c], s);
        xa[j] = s;
      }
    }
    __syncthreads();
  }

  // epilogue: acc + (x·A)·B[:, tile]·scale, cast once
#pragma unroll
  for (int j = 0; j < XA_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    if (i < n_xa) xas[i / r][i % r] = xa[j];
  }
  __syncthreads();
  const int c0 = n0 + tx * 4;
  float byp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) byp[i][q] = 0.f;
  for (int j = 0; j < r; ++j) {
    float bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bv[q] = (c0 + q < N) ? rt::to_f(bmat[(size_t)j * N + c0 + q]) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xv = xas[ty + 8 * i][j];
#pragma unroll
      for (int q = 0; q < 4; ++q) byp[i][q] = fmaf(xv, bv[q], byp[i][q]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 8 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gn = c0 + q;
      if (gn < N) out[(size_t)gm * N + gn] = rt::from_f<T>(acc[i][q] + byp[i][q] * scale);
    }
  }
}

int launch(const float* x, const float* w, const float* a, const float* b, float* out,
           int E, int M, int N, int K, int r, float scale, Batch st,
           cudaStream_t stream) {
  const long long grid_y = (M + BM - 1) / BM;
  if (grid_y > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((N + BN - 1) / BN, (unsigned)grid_y, E);
  lora_matmul_kernel<float><<<grid, THREADS, 0, stream>>>(x, w, a, b, out, M, N, K, r,
                                                          scale, st);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace wg {

// Two warpgroups per 128 x 256 output tile; x·A as 24 (r <= 24) or 64
// columns.
template <int JTMAX>
using LoraCfg = Cfg<2, 256, JTMAX>;

// One tile per block: the expert on blockIdx.z, 128 rows of its C on
// blockIdx.x (fastest, so the blocks that share one (expert, N) slab of W
// run together and read it from L2), 256 columns on blockIdx.y.
template <typename T, int JTMAX, bool ALIGNED>
__global__ void __launch_bounds__(LoraCfg<JTMAX>::THREADS, 1)
lora_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ a, const T* __restrict__ bmat,
                  T* __restrict__ out, int M, int N, int K, int r, float scale,
                  Batch st, const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw) {
  using C = LoraCfg<JTMAX>;
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  __shared__ __align__(8) unsigned long long full[C::STAGES];  // x/W tile landed
  init_ring<C::STAGES, ALIGNED>(full);
  const int e = blockIdx.z, m0 = blockIdx.x * C::BM;
  const Tile tl{e, e, m0, min(C::BM, M - m0), e * st.x + (long long)m0 * K,
                e * st.o + (long long)m0 * N};
  unsigned it = 0;
  tile_gemm<T, C, ALIGNED>(tl, blockIdx.y * C::BN, ring_base(smem_dyn), full, it, x, w, a,
                           bmat, out, N, K, r, scale, Strides{st.w, st.a, st.b}, &tmx, &tmw);
}

template <typename T, int JTMAX, bool ALIGNED>
int launch_cfg(const T* x, const T* w, const T* a, const T* b, T* out, int E, int M,
               int N, int K, int r, float scale, Batch st, cudaStream_t stream) {
  using C = LoraCfg<JTMAX>;
  auto kernel = lora_wgmma_kernel<T, JTMAX, ALIGNED>;
  CUtensorMap tmx{}, tmw{};  // x (E, M, K) and W (E, K, N), as boxes
  if (ALIGNED && !(tensor_map(&tmx, x, K, M, E, BK, C::BM) &&
                   tensor_map(&tmw, w, N, K, E, 64, BK)))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instantiation (one process, one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, E);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(x, w, a, b, out, M, N, K, r, scale, st,
                                                  tmx, tmw);
  return (int)cudaGetLastError();
}

// JTMAX 3 for r <= 24, else 8; ALIGNED from the row strides and bases
template <typename T>
int launch(const T* x, const T* w, const T* a, const T* b, T* out, int E, int M, int N,
           int K, int r, float scale, Batch st, cudaStream_t stream) {
  const bool wide = r > 24;
  const bool aligned = K % 8 == 0 && N % 8 == 0 && r % 2 == 0 && rt::aligned16(x) &&
                       rt::aligned16(w) && reinterpret_cast<uintptr_t>(a) % 4 == 0;
#define RT_LORA_CFG(JT_, AL_)               \
  if (wide == (JT_ == 8) && aligned == AL_) \
    return launch_cfg<T, JT_, AL_>(x, w, a, b, out, E, M, N, K, r, scale, st, stream);
  RT_LORA_CFG(3, true)
  RT_LORA_CFG(8, true)
  RT_LORA_CFG(3, false)
  RT_LORA_CFG(8, false)
#undef RT_LORA_CFG
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

int launch(const void* x, const void* w, const void* a, const void* b, void* out,
           int dtype, int E, int M, int N, int K, int r, float scale, Batch st,
           cudaStream_t stream) {
  if (r < 1 || r > RT_LORA_MAX_RANK || E < 0 || M < 0 || N < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || M == 0 || N == 0) return (int)cudaGetLastError();
  if (E > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dtype == RT_F32)
    return simt::launch(static_cast<const float*>(x), static_cast<const float*>(w),
                       static_cast<const float*>(a), static_cast<const float*>(b),
                       static_cast<float*>(out), E, M, N, K, r, scale, st, stream);
  RT_DISPATCH_16(dtype, T, {
    return wg::launch<T>(static_cast<const T*>(x), static_cast<const T*>(w),
                         static_cast<const T*>(a), static_cast<const T*>(b),
                         static_cast<T*>(out), E, M, N, K, r, scale, st, stream);
  });
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M,K), w (K,N), a (K,r), b (r,N), out (M,N); all contiguous, one dtype.
extern "C" int rt_lora_matmul(const void* x, const void* w, const void* a, const void* b,
                              void* out, int dtype, int M, int N, int K, int r,
                              float scale, cudaStream_t stream) {
  return launch(x, w, a, b, out, dtype, 1, M, N, K, r, scale, Batch{0, 0, 0, 0, 0},
                stream);
}

// x (E,C,K), w (E,K,N), a (E,K,r), b (E,r,N), out (E,C,N); all contiguous.
extern "C" int rt_lora_matmul_experts(const void* x, const void* w, const void* a,
                                      const void* b, void* out, int dtype, int E, int C,
                                      int N, int K, int r, float scale,
                                      cudaStream_t stream) {
  const Batch st{(long long)C * K, (long long)K * N, (long long)K * r, (long long)r * N,
                 (long long)C * N};
  return launch(x, w, a, b, out, dtype, E, C, N, K, r, scale, st, stream);
}
