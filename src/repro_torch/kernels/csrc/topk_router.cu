// Fused SMoE router: softmax + iterative top-k + renormalised weights +
// per-expert activation counts, in one launch.
//
// Replaces: src/repro/kernels/topk_router.py::topk_router (_router_kernel),
// the Pallas TPU kernel behind every MoE layer's router.  Two C entry
// points share the kernel: rt_topk_router (a static k, the Pallas
// kernel's contract) and rt_adaptive_topk_router (a budget k_tok[t] per
// token, the reference's adaptive_topk_router_ref: the decode step's
// router, which the JAX package runs as plain ops fused by XLA).
//
// Bound on the H100: bytes.  Per token it reads E logits and writes 2·E
// fp32 values (weights, mask); at the serving shapes that is far below a
// launch, so the design removes latency:
//
// * one launch, no memset (see the counts below);
// * one warp per token row; lane l owns the P adjacent experts
//   [l·P, l·P + P), P the smallest of 1, 2, 4, 8, 16 with 32·P >= E (a
//   template: E=64 keeps 2 values per lane), loaded as one vector (bf16 at
//   E=64: 4 bytes a lane) and stored as float2 / float4 where the rows
//   allow (E % P == 0 and aligned pointers), element by element otherwise;
// * a selection round is one __reduce_max_sync over an order-preserving
//   32-bit key of the masked probability and a __ballot_sync of the lanes
//   holding it: lanes own ascending expert ranges, so the holder with no
//   holder below it takes its lowest such slot, the lowest expert index —
//   the reference's tie rule (argmax takes the first maximum).  The round
//   is branch-free (a divergent branch for the winner read slower), and
//   the chosen probabilities are summed as they are chosen, in every lane,
//   so the weights' normaliser needs no warp sum (a row that re-picks an
//   expert, or is NaN, takes the warp sum);
// * the reference's semantics on every row: the chosen expert's masked
//   value is multiplied by 0 (masked *= 1 - onehot), so a NaN stays NaN and
//   is chosen again; NaN keys above every number, as argmax takes NaN for
//   the maximum.  A row with a NaN or an inf logit, or all logits -inf, has
//   an all-NaN softmax and selects expert 0 in every round; the weights'
//   clamp keeps NaN (torch's clamp_min, jnp.maximum), unlike fmaxf.
//   Probabilities that underflow to 0 tie with chosen experts at 0, and
//   the lowest index among them is chosen again, as argmax does;
// * counts: a lane owns the same experts in every row, so it counts them
//   in registers; the block adds its warps' counts through shared memory
//   (one barrier, no atomics).  A grid of one block (every decode step)
//   writes counts itself.  Otherwise every block adds (its count << 32 | 1)
//   for each expert to a 64-bit word of a device-global scratch with one
//   atomic; the block that reads the low half at gridDim - 1 is the last
//   for that expert: it writes counts[e] from the word and zeroes the word
//   for the next call.  The sum and the
//   ticket are one word, so no fence is needed.  Counts are sums of whole
//   numbers, exact in float below 2^24.  The scratch is a __device__ array
//   (one per device context, zero when the module loads), so two router
//   calls must not run at the same time on one device: the port issues
//   every call on one stream.
#include "common.cuh"

namespace {

constexpr int RT_MAX_E = 512;        // 16 experts per lane
constexpr int RT_WARPS = 8;          // token rows per block at a time
constexpr int RT_MAX_BLOCKS = 264;   // 2 per SM of the H100; rows beyond loop
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NAN_KEY = 0xffffffffu;

__device__ unsigned long long g_count_scratch[RT_MAX_E];

template <int BYTES> struct Chunk;
template <> struct Chunk<2> { using type = unsigned short; };
template <> struct Chunk<4> { using type = unsigned int; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// P consecutive elements at p (aligned to min(P·sizeof(T), 16)), as float.
template <typename T, int P>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  constexpr int BYTES = P * (int)sizeof(T);
  constexpr int CB = BYTES < 16 ? BYTES : 16;
  using C = typename Chunk<CB>::type;
  C raw[BYTES / CB];
#pragma unroll
  for (int i = 0; i < BYTES / CB; ++i) raw[i] = reinterpret_cast<const C*>(p)[i];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int j = 0; j < P; ++j) out[j] = rt::to_f(e[j]);
}

// P consecutive floats at p (aligned to min(P, 4)·4 bytes).
template <int P>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (P == 1) {
    p[0] = v[0];
  } else if constexpr (P == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < P; i += 4)
      reinterpret_cast<float4*>(p)[i / 4] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// float -> int with the same order (an involution), for __reduce_max_sync
__device__ __forceinline__ int ordered(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

template <typename T, int P>
__global__ void __launch_bounds__(32 * RT_WARPS)
router_kernel(const T* __restrict__ logits, const int* __restrict__ k_tok,
              float* __restrict__ w_out, float* __restrict__ m_out,
              float* __restrict__ counts, int n_tok, int E, int k, bool vec) {
  __shared__ unsigned part[RT_WARPS][32 * P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e0 = lane * P;
  const unsigned below = (1u << lane) - 1u;
  unsigned cnt[P];
#pragma unroll
  for (int j = 0; j < P; ++j) cnt[j] = 0u;

  for (int row = blockIdx.x * RT_WARPS + warp; row < n_tok;
       row += gridDim.x * RT_WARPS) {
    const int rounds = k_tok ? min(max(k_tok[row], 0), k) : k;
    const T* lr = logits + (size_t)row * E;
    float p[P];
    if (vec && e0 < E) {
      load_row<T, P>(lr + e0, p);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) p[j] = e0 + j < E ? rt::to_f(lr[e0 + j]) : -INFINITY;
    }

    // softmax in fp32: exp(x - max) / sum, as the plain version
    int mk = ordered(__float_as_int(p[0]));
#pragma unroll
    for (int j = 1; j < P; ++j) mk = max(mk, ordered(__float_as_int(p[j])));
    const float mx = __int_as_float(ordered(__reduce_max_sync(FULL, mk)));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      p[j] = e0 + j < E ? expf(p[j] - mx) : 0.f;
      sum += p[j];
    }
    sum = rt::warp_sum(sum);

    // keys of the masked probabilities (>= 0 or NaN): their bits order
    // them; NaN above all; slots past E at 0, never chosen (expert 0
    // precedes them and its key is >= 0)
    unsigned key[P];
    float msk[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      p[j] = p[j] / sum;
      key[j] = e0 + j >= E ? 0u : isnan(p[j]) ? NAN_KEY : __float_as_uint(p[j]);
      msk[j] = 0.f;
    }
    // the chosen probabilities, summed as they are chosen; a round whose
    // best key is 0 (a re-pick) or NaN sends the row to the warp sum
    float ws = 0.f;
    bool by_lanes = false;
    for (int r = 0; r < rounds; ++r) {
      unsigned lk = key[0];
#pragma unroll
      for (int j = 1; j < P; ++j) lk = max(lk, key[j]);
      const unsigned best = __reduce_max_sync(FULL, lk);
      const bool has = lk == best;
      const unsigned holders = __ballot_sync(FULL, has);   // all 32 lanes vote
      const bool win = has && (holders & below) == 0u;
      bool taken = false;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const bool hit = win && !taken && key[j] == best;
        taken = taken || hit;
        msk[j] += hit ? 1.f : 0.f;
        key[j] = hit && key[j] != NAN_KEY ? 0u : key[j];
      }
      by_lanes = by_lanes || best == 0u || best == NAN_KEY;
      ws += __uint_as_float(best);
    }
    if (by_lanes) {
      ws = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) ws += p[j] * msk[j];
      ws = rt::warp_sum(ws);
    }
    ws = ws < 1e-9f ? 1e-9f : ws;     // clamp_min(1e-9), NaN kept
    float w[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      w[j] = p[j] * msk[j] / ws;
      cnt[j] += (unsigned)msk[j];
    }
    float* wr = w_out + (size_t)row * E;
    float* mr = m_out + (size_t)row * E;
    if (vec) {
      if (e0 < E) {
        store_row<P>(wr + e0, w);
        store_row<P>(mr + e0, msk);
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (e0 + j < E) {
          wr[e0 + j] = w[j];
          mr[e0 + j] = msk[j];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < P; ++j) part[warp][e0 + j] = cnt[j];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    unsigned own = 0u;
#pragma unroll
    for (int w = 0; w < RT_WARPS; ++w) own += part[w][e];
    if (gridDim.x == 1) {
      counts[e] = (float)own;
      continue;
    }
    const unsigned long long old =
        atomicAdd(&g_count_scratch[e], ((unsigned long long)own << 32) | 1ull);
    if ((unsigned)(old & 0xffffffffull) == gridDim.x - 1) {
      counts[e] = (float)((old >> 32) + own);
      g_count_scratch[e] = 0ull;
    }
  }
}

template <typename T, int P>
void launch_p(const T* logits, const int* k_tok, float* w, float* m, float* c,
              int n_tok, int E, int k, cudaStream_t stream) {
  constexpr size_t in_align = P * sizeof(T) < 16 ? P * sizeof(T) : 16;
  constexpr size_t out_align = (P < 4 ? P : 4) * sizeof(float);
  const bool vec = E % P == 0 && (uintptr_t)logits % in_align == 0 &&
                   (uintptr_t)w % out_align == 0 && (uintptr_t)m % out_align == 0;
  int blocks = (n_tok + RT_WARPS - 1) / RT_WARPS;
  blocks = blocks < 1 ? 1 : blocks > RT_MAX_BLOCKS ? RT_MAX_BLOCKS : blocks;
  router_kernel<T, P><<<blocks, 32 * RT_WARPS, 0, stream>>>(logits, k_tok, w, m, c,
                                                             n_tok, E, k, vec);
}

template <typename T>
void launch(const void* logits, const int* k_tok, float* w, float* m, float* c,
            int n_tok, int E, int k, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  if (E <= 32) launch_p<T, 1>(x, k_tok, w, m, c, n_tok, E, k, stream);
  else if (E <= 64) launch_p<T, 2>(x, k_tok, w, m, c, n_tok, E, k, stream);
  else if (E <= 128) launch_p<T, 4>(x, k_tok, w, m, c, n_tok, E, k, stream);
  else if (E <= 256) launch_p<T, 8>(x, k_tok, w, m, c, n_tok, E, k, stream);
  else launch_p<T, 16>(x, k_tok, w, m, c, n_tok, E, k, stream);
}

int route(const void* logits, int dtype, const int* k_tok, float* weights,
          float* mask, float* counts, int n_tok, int E, int k, cudaStream_t stream) {
  if (E < 1 || E > RT_MAX_E || k < 0 || n_tok < 0) return (int)cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, launch<T>(logits, k_tok, weights, mask, counts, n_tok, E, k, stream));
  return (int)cudaGetLastError();
}

}  // namespace

// Static k for every token: logits (n_tok, E) -> weights, mask (n_tok, E)
// fp32 and counts (E,) fp32.
extern "C" int rt_topk_router(const void* logits, int dtype, float* weights,
                              float* mask, float* counts, int n_tok, int E,
                              int k, cudaStream_t stream) {
  return route(logits, dtype, nullptr, weights, mask, counts, n_tok, E, k, stream);
}

// Per-token budgets: token t takes min(max(k_tok[t], 0), max_k) rounds
// (budget 0 deselects it), the reference's adaptive_topk_router_ref.
extern "C" int rt_adaptive_topk_router(const void* logits, int dtype, const int* k_tok,
                                       float* weights, float* mask, float* counts,
                                       int n_tok, int E, int max_k, cudaStream_t stream) {
  if (k_tok == nullptr && n_tok > 0) return (int)cudaErrorInvalidValue;
  return route(logits, dtype, k_tok, weights, mask, counts, n_tok, E, max_k, stream);
}
