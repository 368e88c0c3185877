// The adaptive tier's choice: each block's Golomb parameter, picked from a
// ladder of candidates by the exact coded bits of the whole block, in one
// launch a pass.
//
// It replaces no TPU kernel: the JAX package computes this step in plain jnp
// (airs_compression_tpu/ops/adapt.py: select_golomb_zero,
// select_golomb_multi), and its plain PyTorch version,
// ops/adapt.py::select_params_plain, costs one chain of about 30 int64
// elementwise operations over the whole batch a candidate column: about
// 800 launches a pass, which the host issues more slowly than the card runs
// them.  Everything that chain computes is three numbers a block.
//
// Input: residuals (B, N) int32, sign-extended i16, as preprocess_forward
// hands them over; the ladder (L,) int32, ascending in [1, 65535], and its
// L - 1 float32 geometric midpoints float32(sqrt(a b)), rounded on the host
// as the plain version rounds them; for GOLOMB_MULTI the caller's outlier.
// Output: g, outlier and bits (B,) int64: the chosen parameter, its escape
// threshold (ZERO: the optimal zero-escape outlier clamped to the 32-bit
// codeword bound; MULTI: the caller's outlier clamped to it) and the
// block's coded bits under it.
//
// The choice, as the plain version makes it:
// * window mode (w > 0 and 2w + 2 < L): the estimate g* = 0.69 mu, mu the
//   float32 mean of the values the Golomb coder sees (ZERO: the zigzag
//   values m; MULTI: m, or outlier + level where m escapes the caller's
//   outlier), from the exact 64-bit sum rounded once, centres a window of
//   2w + 1 ladder entries around idx = the count of midpoints below g*; the
//   candidates are ladder[0], then ladder[clip(idx - w .. idx + w)];
// * full mode: every ladder entry.
// Ties go to the first candidate in list order, as torch.argmin does.
//
// What bounds it on the H100: neither bytes nor operations at the main
// path's shapes.  It reads 4 bytes a sample once (16 MiB at 512 x 8192,
// 5 us at 3.35 TB/s) and spends a dozen integer operations a sample and
// candidate (6 candidates in window mode).  The design, one CTA of 256
// threads a block:
// 1. Load.  The row is read once, coalesced, zigzagged and staged as u16 in
//    shared memory (rows of up to kStageMax samples, 32 KiB); a longer row
//    is read again from device memory (through L2) in each sweep.  The same
//    sweep sums the estimate's values (window mode).
// 2. Estimate.  The sum is reduced by warp shuffles, then shared memory;
//    one thread rounds mu and g* with IEEE float32 operations (no fast
//    math), and every thread counts its share of the midpoints below g*.
// 3. Cost.  The candidates are costed kChunk at a time, one sweep over the
//    staged samples a chunk (one in window mode at w = 2), each thread
//    keeping a partial per candidate; Golomb's group is a multiply-high
//    divide by the candidate (exact for every u32 dividend, as K1's).  The
//    partials are reduced together, and one thread keeps the first
//    cheapest candidate.
// 4. Choose.  That thread writes g, outlier and bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// candidates costed in one sweep over the samples
constexpr int kChunk = 8;
// the longest row staged in shared memory (u16 samples)
constexpr int kStageMax = 16384;

// One candidate's closed forms (ops/adapt.py: zero_terms,
// _clamped_outlier_multi), with the multiply-high divide by g.
struct Cand {
  uint32_t g, glog2, cutoff, outlier, magic, sh1, sh2;
};

template <bool kMulti>
__device__ Cand cand_terms(uint32_t g, uint32_t caller) {
  Cand c;
  c.g = g;
  c.glog2 = 31u - __clz(g);
  c.cutoff = (2u << c.glog2) - g;
  const uint32_t upper = c.cutoff + (31u - c.glog2) * g;
  if constexpr (kMulti)
    c.outlier = min(caller, upper - 8u);
  else
    c.outlier = min(c.cutoff + 16u * g - 1u, upper);
  const uint32_t ell = g > 1 ? 32u - __clz(g - 1) : 0u;  // ceil(log2(g))
  c.magic = static_cast<uint32_t>(
      (((uint64_t{1} << 32) * ((uint64_t{1} << ell) - g)) / g) + 1);
  c.sh1 = ell < 1 ? ell : 1u;
  c.sh2 = ell > 1 ? ell - 1u : 0u;
  return c;
}

__device__ __forceinline__ uint32_t zigzag(int32_t v) {
  return ((static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 15)) &
         0xFFFFu;
}

// ilog2(d) >> 1 for d >= 4, else 0: the MULTI escape's level.
__device__ __forceinline__ uint32_t level_of(uint32_t d) {
  return d < 4 ? 0u : (31u - __clz(d)) >> 1;
}

// The Golomb code length of v (ops/adapt.py::_lengths).
__device__ __forceinline__ uint32_t golomb_len(uint32_t v, const Cand& c) {
  if (v < c.cutoff) return c.glog2 + 1;
  const uint32_t x = v - c.cutoff;
  const uint32_t t = __umulhi(x, c.magic);
  return c.glog2 + 2 + ((t + ((x - t) >> c.sh1)) >> c.sh2);
}

// The coded bits of mapped value m under candidate c.
template <bool kMulti>
__device__ __forceinline__ uint32_t cost(uint32_t m, const Cand& c) {
  if constexpr (kMulti) {
    if (m < c.outlier) return golomb_len(m, c);
    const uint32_t level = level_of(m - c.outlier);
    return golomb_len(c.outlier + level, c) + 2 * (level + 1);
  } else {
    return m < c.outlier ? golomb_len(m + 1, c) : c.glog2 + 17;
  }
}

// The value the estimate averages for mapped value m.
template <bool kMulti>
__device__ __forceinline__ uint32_t estimate_value(uint32_t m,
                                                   uint32_t caller) {
  if constexpr (kMulti)
    return m < caller ? m : caller + level_of(m - caller);
  else
    return m;
}

// The sum of v over the CTA, in thread 0 (part: kWarps scratch words; the
// caller synchronises before part is written again).
__device__ unsigned long long cta_sum(unsigned long long v,
                                      unsigned long long* part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += part[w];
  return total;
}

template <bool kMulti, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    adapt_select_kernel(const int32_t* __restrict__ res, int n,
                        uint32_t caller, int w,
                        const int32_t* __restrict__ ladder,
                        const float* __restrict__ mids, int len,
                        int64_t* __restrict__ g_out,
                        int64_t* __restrict__ outlier_out,
                        int64_t* __restrict__ bits_out) {
  extern __shared__ uint16_t staged[];
  __shared__ unsigned long long part[kWarps];
  __shared__ unsigned long long red[kWarps][kChunk];
  __shared__ Cand cand[kChunk];
  __shared__ float g_est;
  __shared__ int idx;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int32_t* row = res + static_cast<int64_t>(blockIdx.x) * n;
  const bool stage = n <= kStageMax;

  // 1. load (and the estimate's sum)
  unsigned long long sum = 0;
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t m = zigzag(__ldg(row + i));
    if (stage) staged[i] = static_cast<uint16_t>(m);
    if constexpr (kWindow) sum += estimate_value<kMulti>(m, caller);
  }

  // 2. estimate: idx, the midpoints below g* = 0.69 mu
  int k_count = len;
  if constexpr (kWindow) {
    const unsigned long long total = cta_sum(sum, part);
    if (tid == 0) {
      const float mu = __fdiv_rn(__ull2float_rn(total), __int2float_rn(n));
      g_est = __fmul_rn(0.69f, mu);
    }
    __syncthreads();
    const float est = g_est;
    unsigned long long below = 0;
    for (int j = tid; j < len - 1; j += kThreads) below += mids[j] < est;
    const unsigned long long count = cta_sum(below, part);
    if (tid == 0) idx = static_cast<int>(count);
    k_count = 2 * w + 2;
  }
  __syncthreads();  // the staged row, idx

  // 3. cost, kChunk candidates a sweep; 4. choose
  unsigned long long best = ~0ull;
  int best_k = 0;
  for (int c0 = 0; c0 < k_count; c0 += kChunk) {
    const int kc = min(kChunk, k_count - c0);
    if (tid < kc) {
      const int k = c0 + tid;
      int at = k;
      if constexpr (kWindow)
        at = k == 0 ? 0 : min(max(idx - w + k - 1, 0), len - 1);
      cand[tid] = cand_terms<kMulti>(static_cast<uint32_t>(ladder[at]),
                                     caller);
    }
    __syncthreads();
    Cand cc[kChunk];
    uint32_t acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < kc) cc[k] = cand[k];
      acc[k] = 0;
    }
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t m = stage ? staged[i] : zigzag(__ldg(row + i));
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < kc) acc[k] += cost<kMulti>(m, cc[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k >= kc) break;
      unsigned long long v = acc[k];
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(0xFFFFFFFFu, v, o);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < kc; ++k) {
        unsigned long long total = 0;
        for (int j = 0; j < kWarps; ++j) total += red[j][k];
        if (total < best) {
          best = total;
          best_k = c0 + k;
        }
      }
    }
    __syncthreads();  // cand and red are written again by the next chunk
  }

  if (tid == 0) {
    int at = best_k;
    if constexpr (kWindow)
      at = best_k == 0 ? 0 : min(max(idx - w + best_k - 1, 0), len - 1);
    const Cand c = cand_terms<kMulti>(static_cast<uint32_t>(ladder[at]),
                                      caller);
    g_out[blockIdx.x] = c.g;
    outlier_out[blockIdx.x] = c.outlier;
    bits_out[blockIdx.x] = static_cast<int64_t>(best);
  }
}

template <bool kMulti, bool kWindow>
int launch(const void* res, int b, int n, unsigned caller, int w,
           const void* ladder, const void* mids, int len, void* g,
           void* outlier, void* bits, void* stream) {
  const size_t smem = n <= kStageMax ? sizeof(uint16_t) * n : 0;
  adapt_select_kernel<kMulti, kWindow>
      <<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(res), n, caller, w,
          static_cast<const int32_t*>(ladder),
          static_cast<const float*>(mids), len, static_cast<int64_t*>(g),
          static_cast<int64_t*>(outlier), static_cast<int64_t*>(bits));
  return cudaGetLastError();
}

}  // namespace

// One launch over b blocks of n residuals.  multi: GOLOMB_MULTI with the
// caller's outlier `caller`, else GOLOMB_ZERO; w > 0: window mode of
// half-width w (2w + 2 < len), else the full ladder of len entries.
extern "C" int airs_adapt_select(const void* res, int b, int n, int multi,
                                 unsigned caller, int w, const void* ladder,
                                 const void* mids, int len, void* g,
                                 void* outlier, void* bits, void* stream) {
  if (b < 1 || n < 0 || len < 1 || (w > 0 && 2 * w + 2 >= len))
    return cudaErrorInvalidValue;
  if (multi)
    return w > 0 ? launch<true, true>(res, b, n, caller, w, ladder, mids, len,
                                      g, outlier, bits, stream)
                 : launch<true, false>(res, b, n, caller, w, ladder, mids,
                                       len, g, outlier, bits, stream);
  return w > 0 ? launch<false, true>(res, b, n, caller, w, ladder, mids, len,
                                     g, outlier, bits, stream)
               : launch<false, false>(res, b, n, caller, w, ladder, mids, len,
                                      g, outlier, bits, stream);
}
