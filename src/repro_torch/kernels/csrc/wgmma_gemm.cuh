// The Hopper tensor-core mainloop shared by the LoRA expert matmul
// (lora_matmul.cu) and the grouped ragged expert matmul
// (ragged_dispatch.cu): one output tile of BM = 64·WGS rows x BN columns,
// out[rows] = x[rows]·W[e] (+ (x[rows]·A[e])·B[e]·scale), fp32 accumulation,
// one cast.
//
// A tile is a descriptor (Tile): the expert e whose W, A and B it reads,
// where its x rows start (TMA coordinates and an element offset) and how
// many rows it stores.  The callers differ only in how a block finds its
// tiles: the LoRA kernel from blockIdx (expert on z, 128-row tile on x),
// the ragged kernel from a scan of block_expert (one tile per run of
// blocks that share an expert).
//
// Per warpgroup a 64 x BN fp32 accumulator in registers, fed by
// wgmma.mma_async m64n{BN}k16 with x and W read from shared memory through
// descriptors (x K-major, W MN-major via imm-trans-b, both in the 128-byte
// swizzle).  With LoRA, x·A is a second wgmma per k16 step, m64n{8·JTMAX}k16,
// from the same x descriptor and A's tile zero-padded to 8·JTMAX columns.
// K runs in steps of 64 through a 3-4 stage ring: one thread asks the Tensor
// Memory Accelerator for the x box and BN/64 W boxes of a stage (written in
// the 128-byte swizzle, zero-filled past the tensors' edges, bytes counted
// on the stage's mbarrier), every thread copies A's rows with 4-byte
// cp.async; the loads of tile kt+2 and the wgmma of tile kt-1 run while
// tile kt's wgmma are issued.  The LoRA epilogue keeps (x·A)·B in fp32 FMA
// through shared memory (the ring, reused), then casts acc + bypass·scale
// once; without LoRA the accumulator is cast and stored from registers.
// Rows of x or W that are not 16-byte aligned (K or N not a multiple of 8),
// or odd r, take masked element loads into the same layouts (ALIGNED =
// false); the wgmma math is the same.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "mma.cuh"

#define RT_LORA_MAX_RANK 64

// In each including file's anonymous namespace: every .cu instantiates its
// own kernels.
namespace {
namespace wg {

constexpr int BK = 64;                     // one 128-byte swizzle row of x
constexpr int XAS = RT_LORA_MAX_RANK + 4;  // fp32 x·A row stride (epilogue)
constexpr int SMEM_MAX = 232448;           // a block's shared memory on sm_90

// WGS warpgroups of 64 output rows each, BN columns (a multiple of 64);
// JTMAX 0: no LoRA bypass, else x·A as 8·JTMAX columns.  A ring stage holds
// x (BM x BK, 128-byte rows, 128-byte swizzle), W (BK x BN as BN/64
// 64-column atoms of BK 128-byte rows, 128-byte swizzle) and A (BK x RA,
// RA = 8·JTMAX columns zero past r, as 8x8 core matrices: column block j at
// j·1024 bytes, k group at 128 bytes within it).
template <int WGS_, int BN_, int JTMAX_>
struct Cfg {
  static constexpr int WGS = WGS_, BN = BN_, JTMAX = JTMAX_;
  static constexpr bool LORA = JTMAX > 0;
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int RA = 8 * JTMAX;
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN * 2;
  static constexpr int A_BYTES = JTMAX * (BK / 8) * 128;
  static constexpr int STAGE = (X_BYTES + W_BYTES + A_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGES = 4 * STAGE + 1024 <= SMEM_MAX ? 4 : 3;
  static constexpr size_t EPI =
      LORA ? ((size_t)BM * XAS + (size_t)RT_LORA_MAX_RANK * BN) * sizeof(float) : 0;
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t BYTES = (RING > EPI ? RING : EPI) + 1024;  // + alignment
  static_assert(BN % 64 == 0 && BN <= 256, "BN: 64-column atoms, wgmma N <= 256");
};

struct Tile {
  int e;                  // expert: W's z coordinate, the index of A and B
  int xz, xrow;           // x's TMA coordinates: batch index and first row
  int rows;               // rows of the tile that are stored (<= BM)
  long long xoff, ooff;   // element offsets of the first x row / output row
};

struct Strides {  // per-expert element strides of W, A and B
  long long w, a, b;
};

// byte offset of 16-byte chunk `ch` (0..7) of 128-byte row `row` in a
// 128-byte-swizzled tile (1024-byte aligned): the chunk index XOR row % 8
__device__ __forceinline__ int sw128(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

// The ring, 1024-byte aligned (the swizzle is on absolute address bits).
__device__ __forceinline__ unsigned char* ring_base(unsigned char* smem_dyn) {
  return smem_dyn + ((1024 - (rt::smem_addr(smem_dyn) & 1023)) & 1023);
}

template <int STAGES, bool ALIGNED>
__device__ __forceinline__ void init_ring(unsigned long long* full) {
  if (ALIGNED && threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) rt::mbar_init(&full[s], 1);
    rt::mbar_init_fence();
  }
  __syncthreads();
}

// One output tile: columns [n0, n0 + BN) of out rows [0, tl.rows) from
// x rows tl.xrow.. (all BM of them are computed; rows past tl.rows are
// discarded).  `it` counts the ring's k steps across the block's tiles, so
// each stage's mbarrier parity follows it.  All threads of the block call
// it; it returns with the ring free.
template <typename T, class C, bool ALIGNED>
__device__ __forceinline__ void tile_gemm(
    const Tile& tl, int n0, unsigned char* smem, unsigned long long* full, unsigned& it,
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
    const T* __restrict__ bmat, T* __restrict__ out, int N, int K, int r, float scale,
    Strides st, const CUtensorMap* tmx, const CUtensorMap* tmw) {
  constexpr int BM = C::BM, BN = C::BN, THREADS = C::THREADS, STAGES = C::STAGES,
                RA = C::RA;
  constexpr int WCH = BN / 8;  // 16-byte chunks of a W row
  const unsigned smem_s = rt::smem_addr(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;  // warp = 4·wg + warp in wg
  const int g = lane >> 2, t = lane & 3;
  const int kt_n = (K + BK - 1) / BK;
  const T* xg = x + tl.xoff;
  const T* wgt = w + tl.e * st.w;
  const T* ag = a + tl.e * st.a;
  const T* bg = bmat + tl.e * st.b;
  T* og = out + tl.ooff;

  // x and W of a ring stage: ALIGNED, one thread asks the TMA for the x box
  // (BM rows x 64) and BN/64 W boxes (64 k-rows x 64 columns); otherwise
  // every thread stores masked elements into the same layout
  auto load_xw = [&](int s, int k0) {
    unsigned char* xs = smem + s * C::STAGE;
    unsigned char* ws = xs + C::X_BYTES;
    if (ALIGNED) {
      if (tid == 0) {
        rt::mbar_expect_tx(&full[s], C::X_BYTES + C::W_BYTES);
        rt::tma_load_3d(xs, tmx, &full[s], k0, tl.xrow, tl.xz);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          rt::tma_load_3d(ws + i * (BK * 128), tmw, &full[s], n0 + 64 * i, k0, tl.e);
      }
      return;
    }
    for (int c = tid; c < BM * 8; c += THREADS) {  // x: BM rows x 8 chunks
      const int row = c >> 3, ch = c & 7, gk = k0 + ch * 8;
      const T* src = xg + (long long)row * K + gk;
      T* dst = reinterpret_cast<T*>(xs + sw128(row, ch));
      for (int u = 0; u < 8; ++u)
        dst[u] = row < tl.rows && gk + u < K ? src[u] : rt::from_f<T>(0.f);
    }
    for (int c = tid; c < BK * WCH; c += THREADS) {  // W: chunk cn of row k
      const int k = c / WCH, cn = c % WCH, gk = k0 + k, gn = n0 + cn * 8;
      const T* src = wgt + (long long)gk * N + gn;
      T* dst = reinterpret_cast<T*>(ws + (cn >> 3) * (BK * 128) + sw128(k, cn & 7));
      for (int u = 0; u < 8; ++u)
        dst[u] = gk < K && gn + u < N ? src[u] : rt::from_f<T>(0.f);
    }
  };
  auto load_a = [&](int s, int k0) {
    if constexpr (C::LORA) {
      unsigned char* as = smem + s * C::STAGE + C::X_BYTES + C::W_BYTES;
      // A: BK rows x RA, as column pairs (4 bytes, inside one core-matrix row)
      constexpr int PAIRS = BK * RA / 2;
      static_assert(PAIRS % THREADS == 0, "whole A pairs per thread");
#pragma unroll
      for (int i = 0; i < PAIRS / THREADS; ++i) {
        const int p = tid + i * THREADS;
        const int row = p / (RA / 2), col = (p % (RA / 2)) * 2;
        const bool ok = k0 + row < K && col < r;
        const T* src = ag + (long long)(k0 + row) * r + col;
        T* dst = reinterpret_cast<T*>(as + (col >> 3) * (BK / 8 * 128) + (row >> 3) * 128 +
                                      (row & 7) * 16 + (col & 7) * 2);
        if (ALIGNED) {
          rt::cp_async4(dst, ok ? src : ag, ok);
        } else {
          dst[0] = ok ? src[0] : rt::from_f<T>(0.f);
          dst[1] = ok && col + 1 < r ? src[1] : rt::from_f<T>(0.f);
        }
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float xa[C::LORA ? RA / 2 : 1];
#pragma unroll
  for (int i = 0; i < (C::LORA ? RA / 2 : 1); ++i) xa[i] = 0.f;

  // prologue: k tiles 0 .. STAGES-3 in flight
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < kt_n) {
      load_xw((it + s) % STAGES, s * BK);
      load_a((it + s) % STAGES, s * BK);
    }
    rt::cp_async_commit();
  }

  for (int kt = 0; kt < kt_n; ++kt) {
    const unsigned j = it + kt;        // this k tile's use of the ring
    const int s = j % STAGES;
    rt::cp_async_wait<STAGES - 3>();  // this thread's copies of A
    rt::fence_proxy_async();
    if (ALIGNED) rt::mbar_wait(&full[s], (j / STAGES) & 1);  // x, W
    __syncthreads();  // tile kt is in shared memory; tile kt-2's wgmma are done
    if (kt + STAGES - 2 < kt_n) {
      load_xw((j + STAGES - 2) % STAGES, (kt + STAGES - 2) * BK);
      load_a((j + STAGES - 2) % STAGES, (kt + STAGES - 2) * BK);
    }
    rt::cp_async_commit();

    const unsigned xs_s = smem_s + s * C::STAGE;
    const unsigned ws_s = xs_s + C::X_BYTES;
    // x·W and x·A: per k16 step one m64n{BN}k16 and one m64n{RA}k16 on this
    // warpgroup's 64 rows, from the same x descriptor
    rt::fence_regs(acc);
    if constexpr (C::LORA) rt::fence_regs(xa);
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dx =
          rt::wgmma_desc(xs_s + (warp >> 2) * 64 * 128 + kk * 32, 16, 1024, 1);
      rt::Wgmma<T, BN>::run(acc, dx, rt::wgmma_desc(ws_s + kk * 2048, BK * 128, 1024, 1));
      if constexpr (C::LORA)
        rt::Wgmma<T, RA>::run(
            xa, dx, rt::wgmma_desc(ws_s + C::W_BYTES + kk * 256, 128, BK / 8 * 128, 0));
    }
    rt::wgmma_commit();
    rt::wgmma_wait<1>();
    rt::fence_regs(acc);
    if constexpr (C::LORA) rt::fence_regs(xa);
  }
  rt::wgmma_wait<0>();
  rt::fence_regs(acc);
  if constexpr (C::LORA) rt::fence_regs(xa);
  rt::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the LoRA epilogue reuses it
  it += kt_n;

  const int row = warp * 16 + g;  // this thread's rows: row, row + 8
  [[maybe_unused]] float* xas = reinterpret_cast<float*>(smem);  // LoRA only
  [[maybe_unused]] float* bs = xas + BM * XAS;
  if constexpr (C::LORA) {
    // x·A (fp32) and B[:, n-tile] (fp32) to shared memory
#pragma unroll
    for (int jt = 0; jt < C::JTMAX; ++jt) {
      const int col = jt * 8 + 2 * t;
      xas[row * XAS + col] = xa[4 * jt];
      xas[row * XAS + col + 1] = xa[4 * jt + 1];
      xas[(row + 8) * XAS + col] = xa[4 * jt + 2];
      xas[(row + 8) * XAS + col + 1] = xa[4 * jt + 3];
    }
    for (int i = tid; i < r * BN; i += THREADS) {
      const int jr = i / BN, n = i % BN, gn = n0 + n;
      bs[i] = gn < N ? rt::to_f(bg[(long long)jr * N + gn]) : 0.f;
    }
    __syncthreads();
  }

  // acc (+ (x·A)·B·scale), cast once, 64 columns at a time
  const bool pair_ok = ALIGNED && rt::aligned16(out);  // N % 8 == 0 too
#pragma unroll
  for (int grp = 0; grp < BN / 64; ++grp) {
    float byp[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) byp[jn][q] = 0.f;
    if constexpr (C::LORA) {
      for (int c = 0; c < r; ++c) {
        const float x0 = xas[row * XAS + c], x1 = xas[(row + 8) * XAS + c];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float2 bv =
              *reinterpret_cast<const float2*>(&bs[c * BN + grp * 64 + jn * 8 + 2 * t]);
          byp[jn][0] = fmaf(x0, bv.x, byp[jn][0]);
          byp[jn][1] = fmaf(x0, bv.y, byp[jn][1]);
          byp[jn][2] = fmaf(x1, bv.x, byp[jn][2]);
          byp[jn][3] = fmaf(x1, bv.y, byp[jn][3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = row + 8 * h;
      if (lr >= tl.rows) continue;
      T* orow = og + (long long)lr * N;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int nt = grp * 8 + jn;  // n8 tile of the accumulator
        const int gn = n0 + nt * 8 + 2 * t;
        const float v0 = acc[4 * nt + 2 * h] + byp[jn][2 * h] * scale;
        const float v1 = acc[4 * nt + 2 * h + 1] + byp[jn][2 * h + 1] * scale;
        if (pair_ok && gn + 1 < N) {
          *reinterpret_cast<unsigned*>(orow + gn) = rt::pack2<T>(v0, v1);
        } else {
          if (gn < N) orow[gn] = rt::from_f<T>(v0);
          if (gn + 1 < N) orow[gn + 1] = rt::from_f<T>(v1);
        }
      }
    }
  }
  if constexpr (C::LORA) __syncthreads();  // the epilogue's reads of the ring are done
}

// A 3-D tensor map (dims innermost first, row strides in bytes) with the
// 128-byte swizzle and zero fill out of bounds; false if the driver refuses
template <typename T>
bool tensor_map(CUtensorMap* map, const T* base, unsigned long long d0,
                unsigned long long d1, unsigned long long d2, unsigned box0,
                unsigned box1) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !fn)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * sizeof(T), d0 * d1 * sizeof(T)};
  const cuuint32_t box[3] = {box0, box1, 1}, estr[3] = {1, 1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 2 && std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, dt, 3, const_cast<T*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace
