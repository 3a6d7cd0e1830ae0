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
//   Hopper's warpgroup MMA.  A block of two warpgroups owns a 128 x 256
//   output tile at every tier (one warpgroup where that pads M less was
//   13-18% slower at C = 168 and within 2% at C = 48 on an H100,
//   launch/ab_kernels.py); each warpgroup keeps its 64 x 256 fp32
//   accumulator in registers and issues wgmma.mma_async m64n256k16 with x
//   and W read from shared memory through descriptors (x K-major, W
//   MN-major, both in the 128-byte swizzle the descriptors name).  x·A is
//   a second wgmma per k16 step, m64n24k16 (r <= 24) or m64n64k16
//   (r <= 64), from the same x descriptor and A's tile zero-padded to 24
//   or 64 columns.  K runs in
//   steps of 64 through a 3-4 stage ring: one thread asks the Tensor Memory
//   Accelerator for the x box and four W boxes of a stage (the TMA writes
//   them in the 128-byte swizzle, zero-filled past M, N and K, and counts
//   their bytes on the stage's mbarrier), while every thread copies A's
//   rows (40 bytes at r = 20, not a TMA row) with 4-byte cp.async; the
//   loads of tile kt+2 and the wgmma of tile kt-1 run while tile kt's
//   wgmma are issued.  The epilogue keeps (x·A)·B in fp32 FMA (r/K ~ 1% of
//   the work), as the Pallas kernel keeps x·A in fp32, then casts
//   acc + bypass·scale once.  The M tile is the fastest grid index, so the
//   blocks that share one (expert, N) slab of W run together and read it
//   from L2.  Rows of x or W that are not 16-byte aligned (K or N not a
//   multiple of 8), or odd r, take masked element loads into the same
//   layouts; the wgmma math is the same.  wgmma rather than mma.sync: it
//   runs asynchronously from shared memory, so the tensor cores keep
//   working while the warps issue the next tile's copies, and it needs no
//   ldmatrix traffic or fragment registers for x and W.
// * float32 — simt::lora_matmul_kernel, on the FMA units: 256 threads per
//   64x128 tile, K in steps of 16 staged as fp32, 8x4 accumulators per
//   thread, x·A from the same staged x tile.  It keeps full fp32 products,
//   which the fp32 checks (1e-4 of the largest output) need and TF32 would
//   not hold.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "mma.cuh"

#define RT_LORA_MAX_RANK 64

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

constexpr int BN = 256;
constexpr int BK = 64;                     // one 128-byte swizzle row of x
constexpr int XAS = RT_LORA_MAX_RANK + 4;  // fp32 x·A row stride (epilogue)
constexpr int SMEM_MAX = 232448;           // a block's shared memory on sm_90

constexpr int WGS = 2;  // warpgroups per block

// WGS warpgroups, each owning 64 output rows x BN: BM = 64·WGS.  A ring
// stage holds x (BM x BK, 128-byte rows, 128-byte swizzle), W (BK x BN as
// four 64-column atoms of BK 128-byte rows, 128-byte swizzle) and A (BK x
// RA, RA = 8·JTMAX columns zero past r, as 8x8 core matrices: column block
// j at j·1024 bytes, k group at 128 bytes within it).
template <int JTMAX>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int RA = 8 * JTMAX;
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN * 2;
  static constexpr int A_BYTES = JTMAX * (BK / 8) * 128;
  static constexpr int STAGE = (X_BYTES + W_BYTES + A_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGES = 4 * STAGE + 1024 <= SMEM_MAX ? 4 : 3;
  static constexpr size_t EPI =
      ((size_t)BM * XAS + (size_t)RT_LORA_MAX_RANK * BN) * sizeof(float);
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t BYTES = (RING > EPI ? RING : EPI) + 1024;  // + alignment
};

// byte offset of 16-byte chunk `ch` (0..7) of 128-byte row `row` in a
// 128-byte-swizzled tile (1024-byte aligned): the chunk index XOR row % 8
__device__ __forceinline__ int sw128(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

// ALIGNED: x and W rows start on 16-byte boundaries (the TMA's rows) and
// A's on 4-byte ones (r even, cp.async).  Otherwise masked element loads
// into the same layouts.
template <typename T, int JTMAX, bool ALIGNED>
__global__ void __launch_bounds__(Cfg<JTMAX>::THREADS, 1)
lora_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ a, const T* __restrict__ bmat,
                  T* __restrict__ out, int M, int N, int K, int r, float scale,
                  Batch st, const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw) {
  using C = Cfg<JTMAX>;
  constexpr int BM = C::BM, THREADS = C::THREADS, STAGES = C::STAGES, RA = C::RA;
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // the swizzle is on absolute address bits: align the ring to 1024 bytes
  unsigned char* smem = smem_dyn + ((1024 - (rt::smem_addr(smem_dyn) & 1023)) & 1023);
  const unsigned smem_s = rt::smem_addr(smem);

  const int e = blockIdx.z;
  x += e * st.x;
  w += e * st.w;
  a += e * st.a;
  bmat += e * st.b;
  out += e * st.o;

  const int m0 = blockIdx.x * BM;  // fastest: blocks of one W slab together
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;  // warp = 4·wg + warp in wg
  const int g = lane >> 2, t = lane & 3;
  const int kt_n = (K + BK - 1) / BK;

  __shared__ __align__(8) unsigned long long full[STAGES];  // x/W tile landed
  // x and W of a ring stage: ALIGNED, one thread asks the TMA for the x box
  // (BM rows x 64) and four W boxes (64 k-rows x 64 columns), which it
  // writes in the 128-byte swizzle and zero-fills past M, N and K;
  // otherwise every thread stores masked elements into the same layout
  auto load_xw = [&](int s, int k0) {
    unsigned char* xs = smem + s * C::STAGE;
    unsigned char* ws = xs + C::X_BYTES;
    if (ALIGNED) {
      if (tid == 0) {
        rt::mbar_expect_tx(&full[s], C::X_BYTES + C::W_BYTES);
        rt::tma_load_3d(xs, &tmx, &full[s], k0, m0, e);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          rt::tma_load_3d(ws + i * (BK * 128), &tmw, &full[s], n0 + 64 * i, k0, e);
      }
      return;
    }
    for (int c = tid; c < BM * 8; c += THREADS) {  // x: BM rows x 8 chunks
      const int row = c >> 3, ch = c & 7, gm = m0 + row, gk = k0 + ch * 8;
      const T* src = x + (long long)gm * K + gk;
      T* dst = reinterpret_cast<T*>(xs + sw128(row, ch));
      for (int u = 0; u < 8; ++u)
        dst[u] = gm < M && gk + u < K ? src[u] : rt::from_f<T>(0.f);
    }
    for (int c = tid; c < BK * 32; c += THREADS) {  // W: chunk cn of row k
      const int k = c >> 5, cn = c & 31, gk = k0 + k, gn = n0 + cn * 8;
      const T* src = w + (long long)gk * N + gn;
      T* dst = reinterpret_cast<T*>(ws + (cn >> 3) * (BK * 128) + sw128(k, cn & 7));
      for (int u = 0; u < 8; ++u)
        dst[u] = gk < K && gn + u < N ? src[u] : rt::from_f<T>(0.f);
    }
  };
  auto load_a = [&](int s, int k0) {
    unsigned char* as = smem + s * C::STAGE + C::X_BYTES + C::W_BYTES;
    // A: BK rows x RA, as column pairs (4 bytes, inside one core-matrix row)
    constexpr int PAIRS = BK * RA / 2;
    static_assert(PAIRS % THREADS == 0, "whole A pairs per thread");
#pragma unroll
    for (int it = 0; it < PAIRS / THREADS; ++it) {
      const int p = tid + it * THREADS;
      const int row = p / (RA / 2), col = (p % (RA / 2)) * 2;
      const bool ok = k0 + row < K && col < r;
      const T* src = a + (long long)(k0 + row) * r + col;
      T* dst = reinterpret_cast<T*>(as + (col >> 3) * (BK / 8 * 128) + (row >> 3) * 128 +
                                    (row & 7) * 16 + (col & 7) * 2);
      if (ALIGNED) {
        rt::cp_async4(dst, ok ? src : a, ok);
      } else {
        dst[0] = ok ? src[0] : rt::from_f<T>(0.f);
        dst[1] = ok && col + 1 < r ? src[1] : rt::from_f<T>(0.f);
      }
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float xa[RA / 2];
#pragma unroll
  for (int i = 0; i < RA / 2; ++i) xa[i] = 0.f;

  if (ALIGNED && tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) rt::mbar_init(&full[s], 1);
    rt::mbar_init_fence();
  }
  __syncthreads();

  // prologue: k tiles 0 .. STAGES-3 in flight
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < kt_n) {
      load_xw(s, s * BK);
      load_a(s, s * BK);
    }
    rt::cp_async_commit();
  }

  for (int kt = 0; kt < kt_n; ++kt) {
    rt::cp_async_wait<STAGES - 3>();  // this thread's copies of A
    rt::fence_proxy_async();
    if (ALIGNED) rt::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);  // x, W
    __syncthreads();  // tile kt is in shared memory; tile kt-2's wgmma are done
    if (kt + STAGES - 2 < kt_n) {
      load_xw((kt + STAGES - 2) % STAGES, (kt + STAGES - 2) * BK);
      load_a((kt + STAGES - 2) % STAGES, (kt + STAGES - 2) * BK);
    }
    rt::cp_async_commit();

    const int s = kt % STAGES;
    const unsigned xs_s = smem_s + s * C::STAGE;
    const unsigned ws_s = xs_s + C::X_BYTES;
    // x·W and x·A: per k16 step one m64n256k16 and one m64n(RA)k16 on this
    // warpgroup's 64 rows, from the same x descriptor
    rt::fence_regs(acc);
    rt::fence_regs(xa);
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dx =
          rt::wgmma_desc(xs_s + (warp >> 2) * 64 * 128 + kk * 32, 16, 1024, 1);
      rt::Wgmma<T, BN>::run(acc, dx, rt::wgmma_desc(ws_s + kk * 2048, BK * 128, 1024, 1));
      rt::Wgmma<T, RA>::run(
          xa, dx, rt::wgmma_desc(ws_s + C::W_BYTES + kk * 256, 128, BK / 8 * 128, 0));
    }
    rt::wgmma_commit();
    rt::wgmma_wait<1>();
    rt::fence_regs(acc);
    rt::fence_regs(xa);
  }
  rt::wgmma_wait<0>();
  rt::fence_regs(acc);
  rt::fence_regs(xa);
  rt::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue

  // epilogue: x·A (fp32) and B[:, n-tile] (fp32) to shared memory, then
  // acc + (x·A)·B·scale, cast once, 64 columns at a time
  float* xas = reinterpret_cast<float*>(smem);
  float* bs = xas + BM * XAS;
  const int row = warp * 16 + g;  // this thread's rows: row, row + 8
#pragma unroll
  for (int j = 0; j < JTMAX; ++j) {
    const int col = j * 8 + 2 * t;
    xas[row * XAS + col] = xa[4 * j];
    xas[row * XAS + col + 1] = xa[4 * j + 1];
    xas[(row + 8) * XAS + col] = xa[4 * j + 2];
    xas[(row + 8) * XAS + col + 1] = xa[4 * j + 3];
  }
  for (int i = tid; i < r * BN; i += THREADS) {
    const int j = i / BN, n = i % BN, gn = n0 + n;
    bs[i] = gn < N ? rt::to_f(bmat[(long long)j * N + gn]) : 0.f;
  }
  __syncthreads();

  const bool pair_ok = ALIGNED && rt::aligned16(out);  // N % 8 == 0 too
#pragma unroll
  for (int grp = 0; grp < BN / 64; ++grp) {
    float byp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) byp[j][q] = 0.f;
    for (int c = 0; c < r; ++c) {
      const float x0 = xas[row * XAS + c], x1 = xas[(row + 8) * XAS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&bs[c * BN + grp * 64 + j * 8 + 2 * t]);
        byp[j][0] = fmaf(x0, bv.x, byp[j][0]);
        byp[j][1] = fmaf(x0, bv.y, byp[j][1]);
        byp[j][2] = fmaf(x1, bv.x, byp[j][2]);
        byp[j][3] = fmaf(x1, bv.y, byp[j][3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + row + 8 * h;
      if (gm >= M) continue;
      T* orow = out + (long long)gm * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = grp * 8 + j;  // n8 tile of the accumulator
        const int gn = n0 + nt * 8 + 2 * t;
        const float v0 = acc[4 * nt + 2 * h] + byp[j][2 * h] * scale;
        const float v1 = acc[4 * nt + 2 * h + 1] + byp[j][2 * h + 1] * scale;
        if (pair_ok && gn + 1 < N) {
          *reinterpret_cast<unsigned*>(orow + gn) = rt::pack2<T>(v0, v1);
        } else {
          if (gn < N) orow[gn] = rt::from_f<T>(v0);
          if (gn + 1 < N) orow[gn + 1] = rt::from_f<T>(v1);
        }
      }
    }
  }
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

template <typename T, int JTMAX, bool ALIGNED>
int launch_cfg(const T* x, const T* w, const T* a, const T* b, T* out, int E, int M,
               int N, int K, int r, float scale, Batch st, cudaStream_t stream) {
  using C = Cfg<JTMAX>;
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
  dim3 grid((M + C::BM - 1) / C::BM, (N + BN - 1) / BN, E);
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
