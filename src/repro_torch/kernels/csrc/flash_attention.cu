// Causal / sliding-window GQA flash attention (forward).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel of the prefill (no-cache) branch of every attention
// layer.
//
// Bound on the H100: at prefill lengths of a few hundred tokens the work,
// 4·D FLOPs per (query, key) pair inside the causal band, is small against
// the bytes of q/k/v/o; both bounds are microseconds.  This first kernel is
// bound by its own FMA issue rate (no tensor cores) — a wgmma/TMA version
// is later work.
//
// Design (simple and right first): one block of 256 threads per
// (q-tile of 64 rows, head, batch).  The block loops over 64-key tiles from
// the first tile its causal window can see up to its diagonal, with the
// online softmax in fp32: scores S = Q·K^T into shared memory (4x4 FMA
// micro-tiles per thread), masked to -1e30 where the key is past the query,
// outside the window or past the ragged S edge; per-row max / sum by warp
// shuffles; acc = acc·corr + P·V in registers.  GQA reads kv head
// h / (H/KV) directly.  Output = acc / max(l, 1e-30), cast once.  The
// kernel takes strides for the (batch, head, seq) axes with a contiguous
// head_dim, so the model-layout (B,S,H,D) tensors go in without a copy.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_floats() {
  // Qs, Ks (padded rows), Vs, Ps (padded rows), m, l, corr
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int KVH, int S,
                 float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;
  float* m_s = Ps + BQ * PP;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qp = q0 + r;
    Qs[r * DP + d] = qp < S ? rt::to_f(qb[qp * qs.s + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = RT_NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  for (int kt = k_begin / BK; kt * BK < k_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D, kp = k0 + c;
      const bool in = kp < S;
      Ks[c * DP + d] = in ? rt::to_f(kb[kp * ks.s + d]) : 0.f;
      Vs[c * D + d] = in ? rt::to_f(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        bool valid = kp < S;
        if (causal) {
          valid = valid && kp <= qp;
          if (window > 0) valid = valid && kp > qp - window;
        }
        Ps[r * PP + c] = valid ? s[i][j] * scale : RT_NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float a0 = Ps[r * PP + lane], a1 = Ps[r * PP + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, rt::warp_max(fmaxf(a0, a1)));
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      const float ps = rt::warp_sum(p0 + p1);
      Ps[r * PP + lane] = p0;
      Ps[r * PP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp < S) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        ob[qp * os.s + tx + 16 * j] = rt::from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int KVH, int S, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, H, KVH, S, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 int64 — (batch, head, seq) strides of q, k, v, o in elements;
// head_dim must be contiguous.  Supported head_dim: 32, 64, 128.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int dtype, const long long* strides,
                                  int B, int H, int KVH, int S, int D, float scale,
                                  int causal, int window, cudaStream_t stream) {
  if (KVH < 1 || H % KVH) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  RT_DISPATCH(dtype, T, {
    switch (D) {
      case 32:
        return launch<T, 32>(q, k, v, o, strides, B, H, KVH, S, scale, causal, window, stream);
      case 64:
        return launch<T, 64>(q, k, v, o, strides, B, H, KVH, S, scale, causal, window, stream);
      case 128:
        return launch<T, 128>(q, k, v, o, strides, B, H, KVH, S, scale, causal, window, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}
