// Causal / sliding-window GQA flash attention (forward).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), the prefill (no-cache) branch of every
// attention layer in serving and the forward of every attention layer in
// training.  Same function: q (B,H,S,D), k/v (B,KV,S,D), scale D^-0.5, fp32
// softmax statistics, key kpos visible to query qpos when kpos <= qpos and,
// with window > 0, kpos > qpos - window; masked scores are -1e30.  With
// softcap > 0 the scaled score is capped first, s = softcap·tanh(s / softcap)
// (Gemma 2's attn_logit_softcapping): the reference computes that on its
// blockwise jnp path (models/attention.py flash_attention_jnp), since its
// Pallas kernel has no cap; here both kernels apply it to the score in
// natural units, with tanhf (full precision: tanh.approx.f32 would add ~2^-11
// relative error), before the mask, so the running max is taken over capped
// scores.  The cap is a template flag (CAP): softcap = 0 runs an
// instantiation with no tanhf in it.
//
// Bound on the H100: at the path's shapes (serving B=2 S=256 H=16 D=128;
// training B=16 S=128) the work, 4·D FLOPs per (query, key) pair inside
// the causal band, is ~0.5 µs of tensor-core time against ~2.5 µs of q/k/v/o
// bytes at 3.35 TB/s: bound by bytes, and in practice by latency (a
// 256-token prefill is only 128 blocks of 64 queries).
//
// Route by dtype, chosen in the C entry point from the dtype code alone:
//
// * bf16 / fp16 — tc::flash_mma_kernel, on the tensor cores.  A block of 4
//   warps owns 64 queries of one (batch, head); each warp owns 16 rows.  Q
//   is staged once with cp.async and kept in registers as mma A fragments.
//   Per 64-key tile, S = Q·K^T runs on mma.sync.m16n8k16 (K read with
//   ldmatrix from its row-major [key][d] tile) into fp32 accumulators; the
//   mask, the running max and sum (log2 domain, quad shuffles for the row
//   reductions) and the rescale of O all happen on those fragments in
//   registers.  P is cast to the input type in registers and is the A
//   fragment of O += P·V (V read with ldmatrix.trans) — the one rounding the
//   fp32 plain version does not have.  K/V tiles come through a
//   double-buffered cp.async ring (16-byte copies, zero-filled past S), so
//   the next tile loads while this one multiplies.  O is staged through the
//   warp's own Q rows in shared memory and written in 16-byte rows.  Rows
//   are padded by 16 bytes so no ldmatrix has bank conflicts.  Strides that
//   are not 16-byte multiples take masked element loads into the same
//   layout; the mma math is the same.
// * float32 — simt::flash_fwd_kernel, on the FMA units: one block of 256
//   threads per 64-query tile, 64-key tiles staged as fp32, S by 4x4 FMA
//   micro-tiles into shared memory, per-row max/sum by warp shuffles,
//   acc = acc·corr + P·V in registers.  It keeps full fp32 products, which
//   the fp32 backward checks need.
//
// Both take strides for the (batch, head, seq) axes with a contiguous
// head_dim, so the model-layout (B,S,H,D) tensors go in without a copy; GQA
// reads kv head h / (H/KV); with window > 0 the key tiles before the
// block's window are skipped; any S works (ragged edge masked); head_dim
// 32, 64 or 128.  Output = acc / max(l, 1e-30), cast once.
#include "mma.cuh"

namespace {

struct Strides {
  long long b, h, s;
};

namespace simt {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
constexpr size_t smem_floats() {
  // Qs, Ks (padded rows), Vs, Ps (padded rows), m, l, corr
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int KVH, int S,
                 float scale, int causal, int window, float softcap) {
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
        float sv = s[i][j] * scale;
        if (CAP) sv = softcap * tanhf(sv / softcap);
        Ps[r * PP + c] = valid ? sv : RT_NEG_INF;
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

template <int D, bool CAP>
int launch(const float* q, const float* k, const float* v, float* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int H, int KVH, int S, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<float, D, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(q, k, v, o, qs, ks, vs, os, H, KVH, S, scale, causal,
                                     window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace tc {

constexpr int BQ = 64;   // 4 warps x 16 query rows
constexpr int BKV = 64;  // keys per tile
constexpr int THREADS = 128;

template <int D>
struct Smem {
  static constexpr int DS = D + 8;  // row stride: 16-byte pad
  static constexpr int TILE = BKV * DS;
  static constexpr size_t BYTES = ((size_t)BQ * DS + 4 * (size_t)TILE) * 2;  // Q, 2 K, 2 V
};

template <typename T, int D, bool ALIGNED, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int H, int KVH, int S, float scale, int causal,
                 int window, float softcap) {
  constexpr int DS = Smem<D>::DS;
  constexpr int TILE = Smem<D>::TILE;
  constexpr int KD = D / 16;  // k16 steps of Q·K^T
  constexpr int ND = D / 8;   // n8 tiles of O
  constexpr int NS = BKV / 8; // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * DS;
  T* Vs = Ks + 2 * TILE;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_begin / BKV, kt1 = (k_end + BKV - 1) / BKV;

  auto load_kv = [&](int buf, int k0) {
    rt::load_tile<T, ALIGNED, BKV, D, DS, THREADS>(Ks + buf * TILE, kb + k0 * ks.s,
                                                   ks.s, S - k0, D, tid);
    rt::load_tile<T, ALIGNED, BKV, D, DS, THREADS>(Vs + buf * TILE, vb + k0 * vs.s,
                                                   vs.s, S - k0, D, tid);
  };
  rt::load_tile<T, ALIGNED, BQ, D, DS, THREADS>(Qs, qb + q0 * qs.s, qs.s, S - q0, D, tid);
  load_kv(0, kt0 * BKV);
  rt::cp_async_commit();

  unsigned qf[KD][4];
  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_r[2] = {RT_NEG_INF, RT_NEG_INF}, l_r[2] = {0.f, 0.f};
  const float sl2 = scale * 1.4426950408889634f;  // scores in the log2 domain
  // with the cap: s·scale in natural units, capped, then to the log2 domain
  const float cap_in = CAP ? scale / softcap : 0.f;
  const float cap_l2 = CAP ? softcap * 1.4426950408889634f : 0.f;
  const int qp0 = q0 + warp * 16 + g;               // this thread's rows qp0, qp0 + 8

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_kv(buf ^ 1, (kt + 1) * BKV);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();  // tile kt (and Q) landed
    if (kt == kt0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        rt::ldmatrix_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * DS + kd * 16 +
                                    (lane >> 4) * 8);
    }
    const T* kts = Ks + buf * TILE;
    const T* vts = Vs + buf * TILE;

    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bf[4];
        rt::ldmatrix_x4(bf, kts + (np * 16 + (lane & 7) + (lane >> 4) * 8) * DS +
                                kd * 16 + ((lane >> 3) & 1) * 8);
        rt::Mma<T>::run(sc[2 * np], qf[kd], bf[0], bf[1]);
        rt::Mma<T>::run(sc[2 * np + 1], qf[kd], bf[2], bf[3]);
      }
    }

    // mask, scale, online softmax on the fragments
    const int k0 = kt * BKV;
    float mx[2] = {RT_NEG_INF, RT_NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const int qp = qp0 + 8 * (e >> 1);
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
        const float sv = CAP ? cap_l2 * tanhf(sc[j][e] * cap_in) : sc[j][e] * sl2;
        sc[j][e] = ok ? sv : RT_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_r[hh], mx[hh]);
      corr[hh] = exp2f(m_r[hh] - m_new);
      m_r[hh] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - m_r[e >> 1]);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * corr[hh] + rs[hh];  // per-thread part
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }

    // O += P·V: two S n-tiles are one A fragment of a 16-key step
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const unsigned pa[4] = {rt::pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                              rt::pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                              rt::pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              rt::pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned bf[4];
        rt::ldmatrix_x4_trans(bf, vts + (kk * 16 + (lane & 15)) * DS + dp * 16 +
                                      (lane >> 4) * 8);
        rt::Mma<T>::run(oacc[2 * dp], pa, bf[0], bf[1]);
        rt::Mma<T>::run(oacc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at the next iteration
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / fmaxf(l, 1e-30f);
  }
  // stage O in this warp's own 16 rows of Qs, then write whole rows
  T* Os = Qs + warp * 16 * DS;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<unsigned*>(Os + g * DS + col) =
        rt::pack2<T>(oacc[j][0] * inv[0], oacc[j][1] * inv[0]);
    *reinterpret_cast<unsigned*>(Os + (g + 8) * DS + col) =
        rt::pack2<T>(oacc[j][2] * inv[1], oacc[j][3] * inv[1]);
  }
  __syncwarp();
  T* ob = o + b * os.b + h * os.h;
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int row = c / CH, cc = (c % CH) * 8;
    const int qp = q0 + warp * 16 + row;
    if (qp >= S) continue;
    if (ALIGNED) {
      *reinterpret_cast<uint4*>(ob + qp * os.s + cc) =
          *reinterpret_cast<const uint4*>(Os + row * DS + cc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) ob[qp * os.s + cc + e] = Os[row * DS + cc + e];
    }
  }
}

template <typename T, int D, bool ALIGNED, bool CAP>
int launch_cfg(const T* q, const T* k, const T* v, T* o, Strides qs, Strides ks,
               Strides vs, Strides os, int B, int H, int KVH, int S, float scale,
               int causal, int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_mma_kernel<T, D, ALIGNED, CAP>;
  constexpr size_t smem = Smem<D>::BYTES;
  static bool attr_set = false;  // once per instantiation (one process, one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, qs, ks, vs, os, H, KVH, S, scale,
                                          causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool CAP>
int launch(const T* q, const T* k, const T* v, T* o, Strides qs, Strides ks, Strides vs,
           Strides os, int B, int H, int KVH, int S, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  bool aligned = rt::aligned16(q) && rt::aligned16(k) && rt::aligned16(v) &&
                 rt::aligned16(o);
  const Strides all[4] = {qs, ks, vs, os};
  for (int i = 0; i < 4; ++i)
    aligned = aligned && all[i].b % 8 == 0 && all[i].h % 8 == 0 && all[i].s % 8 == 0;
  if (aligned)
    return launch_cfg<T, D, true, CAP>(q, k, v, o, qs, ks, vs, os, B, H, KVH, S, scale,
                                       causal, window, softcap, stream);
  return launch_cfg<T, D, false, CAP>(q, k, v, o, qs, ks, vs, os, B, H, KVH, S, scale,
                                      causal, window, softcap, stream);
}

}  // namespace tc

template <int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int dtype,
           const Strides* st, int B, int H, int KVH, int S, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  if (dtype == RT_F32)
    return simt::launch<D, CAP>(static_cast<const float*>(q), static_cast<const float*>(k),
                                static_cast<const float*>(v), static_cast<float*>(o),
                                st[0], st[1], st[2], st[3], B, H, KVH, S, scale, causal,
                                window, softcap, stream);
  RT_DISPATCH_16(dtype, T, {
    return tc::launch<T, D, CAP>(static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<T*>(o), st[0],
                                 st[1], st[2], st[3], B, H, KVH, S, scale, causal, window,
                                 softcap, stream);
  });
  return (int)cudaErrorInvalidValue;
}

// the cap, decided once: softcap = 0 runs the kernels without it
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int dtype,
           const Strides* st, int B, int H, int KVH, int S, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  if (softcap > 0.f)
    return launch<D, true>(q, k, v, o, dtype, st, B, H, KVH, S, scale, causal, window,
                           softcap, stream);
  return launch<D, false>(q, k, v, o, dtype, st, B, H, KVH, S, scale, causal, window,
                          softcap, stream);
}

}  // namespace

// strides: 12 int64 — (batch, head, seq) strides of q, k, v, o in elements;
// head_dim must be contiguous.  Supported head_dim: 32, 64, 128.  softcap: 0
// (no cap) or the cap, > 0.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int dtype, const long long* strides,
                                  int B, int H, int KVH, int S, int D, float scale,
                                  int causal, int window, float softcap,
                                  cudaStream_t stream) {
  if (KVH < 1 || H % KVH || !(softcap >= 0.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, dtype, st, B, H, KVH, S, scale, causal, window,
                        softcap, stream);
    case 64:
      return launch<64>(q, k, v, o, dtype, st, B, H, KVH, S, scale, causal, window,
                        softcap, stream);
    case 128:
      return launch<128>(q, k, v, o, dtype, st, B, H, KVH, S, scale, causal, window,
                         softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
