// Fused SMoE router: softmax + iterative top-k + renormalised weights +
// per-expert activation counts.
//
// Replaces: src/repro/kernels/topk_router.py::topk_router (_router_kernel),
// the Pallas TPU kernel behind the static-k router of every MoE layer.
//
// Bound on the H100: bytes.  Per token it reads E logits and writes 2·E
// fp32 values (weights, mask); the k rounds of argmax are a few hundred
// register operations per row, far below the card's compute rate.
//
// Design (deliberately simple): one warp per token row, E <= 32·RT_MAX_PER
// logits held in registers (lane l owns experts l, l+32, ...).  The k
// rounds mirror the reference exactly: argmax over the masked probability
// row with the LOWEST index winning ties (warp shuffle reduction on
// (value desc, index asc)), mask += one-hot, masked *= (1 - one-hot).
// The TPU kernel carried the counts across its sequential grid steps; GPU
// blocks run in no order, so counts go to a zeroed (E,) buffer with
// atomicAdd — sums of 1.0f, exact below 2^24 tokens.
#include "common.cuh"

#include <limits.h>

#define RT_MAX_PER 16  // experts per lane: E <= 512

namespace {

template <typename T>
__global__ void __launch_bounds__(128)
topk_router_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                   float* __restrict__ m_out, float* __restrict__ counts,
                   int n_tok, int E, int k) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_tok) return;
  const T* lr = logits + (size_t)row * E;

  float p[RT_MAX_PER], masked[RT_MAX_PER], msk[RT_MAX_PER];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < RT_MAX_PER; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? rt::to_f(lr[e]) : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
  mx = rt::warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < RT_MAX_PER; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  sum = rt::warp_sum(sum);
#pragma unroll
  for (int j = 0; j < RT_MAX_PER; ++j) {
    p[j] = p[j] / sum;
    masked[j] = p[j];
    msk[j] = 0.f;
  }

  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < RT_MAX_PER; ++j) {  // ascending index: strict > keeps the lowest
      const int e = lane + 32 * j;
      if (e < E && masked[j] > bv) {
        bv = masked[j];
        bi = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < RT_MAX_PER; ++j) {
      if (lane + 32 * j == bi) {
        msk[j] += 1.f;
        masked[j] = masked[j] * 0.f;
      }
    }
  }

  float ws = 0.f;
#pragma unroll
  for (int j = 0; j < RT_MAX_PER; ++j) ws += p[j] * msk[j];
  ws = fmaxf(rt::warp_sum(ws), 1e-9f);
#pragma unroll
  for (int j = 0; j < RT_MAX_PER; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      w_out[(size_t)row * E + e] = p[j] * msk[j] / ws;
      m_out[(size_t)row * E + e] = msk[j];
      if (msk[j] != 0.f) atomicAdd(counts + e, msk[j]);
    }
  }
}

}  // namespace

extern "C" int rt_topk_router(const void* logits, int dtype, float* weights,
                              float* mask, float* counts, int n_tok, int E,
                              int k, cudaStream_t stream) {
  if (E < 1 || E > 32 * RT_MAX_PER || k < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(float) * E, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_tok == 0) return (int)cudaGetLastError();
  const int threads = 128;  // 4 rows per block
  const int blocks = (n_tok * 32 + threads - 1) / threads;
  RT_DISPATCH(dtype, T,
              topk_router_kernel<T><<<blocks, threads, 0, stream>>>(
                  static_cast<const T*>(logits), weights, mask, counts, n_tok, E, k));
  return (int)cudaGetLastError();
}
