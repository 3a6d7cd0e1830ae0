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
// Design:
//  * gather / combine: one block per output row, 16-byte vector loads when
//    the row is 16-byte aligned (scalar otherwise), fp32 accumulation in
//    the combine, no atomics (the combine only gathers).
//  * matmul, bf16 / fp16 — tc::ragged_wgmma_kernel, on the tensor cores
//    with the wgmma + TMA mainloop of wgmma_gemm.cuh (shared with the LoRA
//    expert matmul).  A tile is a run of up to BM/bm consecutive row
//    blocks that share an expert, not one row block: the segments are
//    expert-major and contiguous, and the trailing padding blocks are one
//    more run (of expert E-1), so each live tile reads its expert's W
//    column tile once, and the weight bytes approach the bound (each used
//    expert's slab once per column tile), where one block per 8 rows read
//    it once per 8 rows.  The tile table is computed inside the launch:
//    every block scans block_expert (a max-scan for each run's first block,
//    a sum-scan of tile starts; ~330 ints at the serving shapes) and takes
//    tile blockIdx.y, then blockIdx.y + gridDim.y, ...  The grid is
//    (column tiles, min(nb, ceil(nb·bm/BM) + E)): at most one tile per BM
//    rows plus one per run, and a plan has at most E runs; blocks past the
//    real count exit, and more runs (a block_expert that is not
//    expert-major) are taken in turn, so any block_expert is right.  x
//    comes as a 2-D box that starts at the run's first row: rows of the
//    next run that it brings in are computed and discarded, and the
//    epilogue stores only the run's rows (any other store would race with
//    the block that owns the next run).  The column tile is the fastest
//    grid index: the blocks of one tile share its x rows in L2, and the
//    blocks past the tile count come last.  Two shapes of block, chosen
//    from N and E on the host (no sync): where the average segment is at
//    most 16 rows (decode, short prefills) one warpgroup and 128 columns —
//    64-row tiles pad short runs less, and a narrower column tile puts
//    twice the blocks (two per SM) in flight on a few experts' slabs;
//    otherwise two warpgroups and 256 columns.  With LoRA factors (no
//    serving path passes them) the two-warpgroup block with x·A as a
//    second m64n64k16 wgmma, r <= 64.
//  * matmul, float32 and the other 16-bit cases — simt::ragged_matmul_kernel,
//    on the FMA units: one block of 8 warps per (row block, 128-column
//    tile).  The block reads block_expert[i] itself, stages its rows (in
//    chunks of 8) in shared memory as fp32, and each warp walks a strided
//    eighth of K: lane l loads 4 adjacent weights of one W row (a warp
//    reads 256 contiguous bytes) and keeps an 8x4 fp32 accumulator.  The 8
//    partial sums are reduced through shared memory in a fixed order, the
//    optional LoRA bypass (x@A computed once per chunk into shared memory)
//    is added as acc + (xa@B)·scale, and the result is cast once.  float32
//    keeps full fp32 products, which the fp32 end-to-end checks need; the
//    C entry point sends 16-bit inputs here only where the tensor-core
//    kernel cannot take them: LoRA rank r > 64, a row block bm that does
//    not divide 64, or K = 0.
#include "wgmma_gemm.cuh"

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
namespace simt {

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

}  // namespace simt

namespace tc {

using namespace wg;

// No LoRA: one warpgroup x 128 columns (short segments) or two x 256;
// LoRA: two x 256, x·A as 64 columns (r <= 64).
using Narrow = Cfg<1, 128, 0>;
using Wide = Cfg<2, 256, 0>;
using WideLora = Cfg<2, 256, 8>;
constexpr int NARROW_ROWS_PER_EXPERT = 16;  // N <= 16·E: the narrow block

// Tile `t` of the ragged buffer: the runs of consecutive row blocks that
// share an expert, each cut into tiles of at most TB blocks.  Returns the
// number of tiles and, for t below it, the tile's first block and its
// length in blocks (the same in every thread).  One pass over
// block_expert in chunks of THREADS blocks: a block starts a run where its
// expert differs from the previous block's, the run's first block is a
// max-scan of those starts, a block starts a tile where its distance from
// the run's first block is a multiple of TB, and the tile's index is a
// sum-scan of the tile starts.
template <int THREADS>
__device__ int find_tile(const int* __restrict__ be, int nb, int TB, int t, int& start,
                         int& len) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int part[WARPS];
  __shared__ int s_start, s_rs, s_cnt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_start = -1;
  int carry_rs = 0, carry_cnt = 0;
  for (int c0 = 0; c0 < nb; c0 += THREADS) {
    const int i = c0 + tid;
    const bool in = i < nb;
    const int e = in ? be[i] : 0;
    const bool run_start = in && (i == 0 || be[i - 1] != e);
    int v = run_start ? i : -1;  // max-scan: the first block of i's run
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = max(v, u);
    }
    if (lane == 31) part[warp] = v;
    __syncthreads();
    for (int q = 0; q < warp; ++q) v = max(v, part[q]);
    const int rs = max(v, carry_rs);
    __syncthreads();  // part is reused
    const bool tile_start = in && (i - rs) % TB == 0;
    int n = tile_start ? 1 : 0;  // sum-scan: tile starts up to i
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, n, o);
      if (lane >= o) n += u;
    }
    if (lane == 31) part[warp] = n;
    __syncthreads();
    for (int q = 0; q < warp; ++q) n += part[q];
    if (tile_start && carry_cnt + n - 1 == t) s_start = i;
    if (tid == THREADS - 1) {
      s_rs = rs;
      s_cnt = carry_cnt + n;
    }
    __syncthreads();
    carry_rs = s_rs;
    carry_cnt = s_cnt;
  }
  __syncthreads();
  start = s_start;
  len = 0;
  if (start >= 0) {  // the blocks from start on that share its expert, <= TB
    const int e0 = be[start];
    for (int b0 = 0; b0 < TB; b0 += 32) {
      const int l = b0 + lane, j = start + l;
      const unsigned m = __ballot_sync(0xffffffffu, l < TB && j < nb && be[j] == e0);
      const int lead = m == 0xffffffffu ? 32 : __ffs(~m) - 1;
      len += lead;
      if (lead < 32) break;
    }
  }
  return carry_cnt;
}

template <typename T, class C, bool ALIGNED>
__global__ void __launch_bounds__(C::THREADS, 1)
ragged_wgmma_kernel(const T* __restrict__ xs, const int* __restrict__ be,
                    const T* __restrict__ w, const T* __restrict__ a,
                    const T* __restrict__ bmat, T* __restrict__ out, int nb, int bm, int H,
                    int K, int r, float scale, Strides st,
                    const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw) {
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  __shared__ __align__(8) unsigned long long full[C::STAGES];  // x/W tile landed
  init_ring<C::STAGES, ALIGNED>(full);
  unsigned char* smem = ring_base(smem_dyn);
  const int TB = C::BM / bm;
  unsigned it = 0;
  int start, len;
  const int tiles = find_tile<C::THREADS>(be, nb, TB, blockIdx.y, start, len);
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    if (t != (int)blockIdx.y) find_tile<C::THREADS>(be, nb, TB, t, start, len);
    const int row0 = start * bm;
    const Tile tl{be[start], 0, row0, len * bm, (long long)row0 * K, (long long)row0 * H};
    tile_gemm<T, C, ALIGNED>(tl, blockIdx.x * C::BN, smem, full, it, xs, w, a, bmat, out,
                             H, K, r, scale, st, &tmx, &tmw);
  }
}

template <typename T, class C, bool ALIGNED>
int launch_cfg(const T* xs, const int* be, const T* w, const T* a, const T* b, T* out,
               int N, int nb, int K, int H, int E, int r, float scale,
               cudaStream_t stream) {
  auto kernel = ragged_wgmma_kernel<T, C, ALIGNED>;
  CUtensorMap tmx{}, tmw{};  // xs (1, N, K) and W (E, K, H), as boxes
  if (ALIGNED && !(tensor_map(&tmx, xs, K, N, 1, BK, C::BM) &&
                   tensor_map(&tmw, w, H, K, E, 64, BK)))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instantiation (one process, one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int bm = N / nb, TB = C::BM / bm;
  long long tiles = (nb + TB - 1) / TB + (long long)E;
  if (tiles > nb) tiles = nb;
  if (tiles > 65535) tiles = 65535;  // the blocks then take several tiles each
  dim3 grid((H + C::BN - 1) / C::BN, (unsigned)tiles);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      xs, be, w, a, b, out, nb, bm, H, K, r, scale,
      Strides{(long long)K * H, (long long)K * r, (long long)r * H}, tmx, tmw);
  return (int)cudaGetLastError();
}

// the block shape from N and E; ALIGNED from the row strides and bases
template <typename T>
int launch(const T* xs, const int* be, const T* w, const T* a, const T* b, T* out, int N,
           int nb, int K, int H, int E, int r, float scale, cudaStream_t stream) {
  const bool lora = a != nullptr;
  const bool aligned = K % 8 == 0 && H % 8 == 0 && rt::aligned16(xs) && rt::aligned16(w) &&
                       (!lora || (r % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0));
  const bool narrow = !lora && (long long)N <= (long long)NARROW_ROWS_PER_EXPERT * E;
#define RT_RAGGED_CFG(C_, AL_)                                                          \
  return AL_ ? launch_cfg<T, C_, true>(xs, be, w, a, b, out, N, nb, K, H, E, r, scale, \
                                       stream)                                         \
             : launch_cfg<T, C_, false>(xs, be, w, a, b, out, N, nb, K, H, E, r, scale, \
                                        stream);
  if (lora) RT_RAGGED_CFG(WideLora, aligned)
  if (narrow) RT_RAGGED_CFG(Narrow, aligned)
  RT_RAGGED_CFG(Wide, aligned)
#undef RT_RAGGED_CFG
}

}  // namespace tc

}  // namespace

extern "C" int rt_ragged_gather(const void* x, const int* src, const int* valid,
                                void* out, int dtype, int N, int D,
                                cudaStream_t stream) {
  if (N == 0 || D == 0) return (int)cudaGetLastError();
  RT_DISPATCH(dtype, T, {
    const bool vec = (D % rt::Vec<T>::N) == 0 && rt::aligned16(x) && rt::aligned16(out);
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
    const bool vec = (D % rt::Vec<T>::N) == 0 && rt::aligned16(eo) && rt::aligned16(out);
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

// a/b may be null (no LoRA bypass); r is then ignored.  E, w's expert
// count, comes last, after the stream: an entry point built without it
// ignores a trailing argument, so launch/ab_kernels.py can call either.
// Route: bf16 / fp16 run the tensor-core kernel, except a LoRA rank above
// 64, a row block that does not divide 64 rows, or K = 0, which run the
// FMA kernel as float32 does.
extern "C" int rt_ragged_expert_matmul(const void* xs, const int* block_expert,
                                       const void* w, const void* a, const void* b,
                                       void* out, int dtype, int N, int nb, int K,
                                       int H, int r, float scale, cudaStream_t stream,
                                       int E) {
  if (nb == 0 || N % nb || E < 1) return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0) return (int)cudaGetLastError();
  const int bm = N / nb;
  const bool lora = a != nullptr && b != nullptr;
  if (!lora) r = 0;
  const bool tensor_cores = dtype != RT_F32 && r <= RT_LORA_MAX_RANK && bm <= 64 &&
                            64 % bm == 0 && K > 0;
  if (tensor_cores) {
    RT_DISPATCH_16(dtype, T, {
      return tc::launch<T>(static_cast<const T*>(xs), block_expert, static_cast<const T*>(w),
                           lora ? static_cast<const T*>(a) : nullptr,
                           lora ? static_cast<const T*>(b) : nullptr, static_cast<T*>(out),
                           N, nb, K, H, E, r, scale, stream);
    });
  }
  const size_t smem = (simt::stage_floats(K) + (size_t)simt::RB * r) * sizeof(float);
  dim3 grid(nb, (H + simt::MM_COLS - 1) / simt::MM_COLS);
  RT_DISPATCH(dtype, T, {
    const bool vec = (H % 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T))) == 0;
    auto kern = vec ? &simt::ragged_matmul_kernel<T, true>
                    : &simt::ragged_matmul_kernel<T, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, simt::MM_THREADS, smem, stream>>>(
        static_cast<const T*>(xs), block_expert, static_cast<const T*>(w),
        lora ? static_cast<const T*>(a) : nullptr, lora ? static_cast<const T*>(b) : nullptr,
        static_cast<T*>(out), K, H, bm, r, scale);
  });
  return (int)cudaGetLastError();
}
