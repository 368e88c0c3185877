// K1 and K2: bit pack of a batch of blocks, one CTA per block row.
//
// K1 replaces airs_compression_tpu/ops/pallas_pack.py::_residual_kernel
// (entry pack_residuals_pallas): zigzag + Golomb codewords computed from
// residuals (B, N) int32, sign-extended i16, and packed.  K2 replaces
// ::_codes_kernel (entry pack_codes_tree_pallas): precomputed codes loaded
// from hi/lo/lens rows (B, K) and packed; zero-length codes contribute
// nothing.  The plain PyTorch version of both is
// ops/pack.py::pack_codes_plain.
//
// Output: payload (B, C) u32 words of a left-justified MSB-first bit stream
// per block, zero past the stream's last bit, and bits (B,) int32.  C is
// the capacity for the worst-case code length, computed by the wrapper;
// pieces past C words (from lengths over that maximum) are dropped and bits
// is still the full sum.  Lengths are taken in [0, 64].
//
// What bounds it on the H100: bytes.  K1 reads 4 bytes a residual, K2 8 or
// 12 bytes a code, and each row writes its C words once (at the main path's
// shapes most of them are the zeros past the stream).  Per code the work is
// a few dozen integer operations.  The TPU kernels merged codes pairwise in
// a doubling tree held in VMEM, because Mosaic has no scatter; here one CTA
// owns a row and walks it a tile at a time:
//
// 1. Staging.  Tile t + 1 is copied into shared memory with cp.async while
//    tile t is packed (two buffers): 16-byte copies where the row starts on
//    a 16-byte boundary, 4-byte copies otherwise (odd N), so every warp
//    reads whole lines.  A tile is 256 threads x 8 codes for K1, x 4 for
//    K2 (whose tile stages 8 or 12 bytes a code): the fastest of the
//    geometries `chip_smoke.py --pack-sweep` times.
// 2. Codes.  Thread i takes the tile's codes [kPer i, kPer (i + 1)), read
//    from shared memory as 16-byte words, and keeps them in registers: K1
//    computes each code once, dividing by the launch's Golomb parameter
//    with a multiply-high (exact for every u32 dividend), K2 reads each
//    length once.
// 3. Scan.  A CTA scan of the runs' bit counts, plus the carry of the tiles
//    before, gives each run its first bit.
// 4. Emit.  A thread appends its codes, MSB first, to a 32-bit word with
//    funnel shifts and stores each finished word whose first bit lies in
//    its run with a plain store, into a ring of words in shared memory.
//    Only the word its run starts in can hold an earlier run's bits: that
//    one word gets a single atomicOr after the next barrier.  A run of
//    zero-length codes stores nothing, and no word is zeroed before it is
//    written.
// 5. Copy out.  Between the two barriers of each tile's scan, the words the
//    tiles before have finished go from the ring to the row (coalesced),
//    so the ring holds one tile of 64-bit codes and rows of any width take
//    this path.  At the end the last words follow and the words past the
//    stream's end are zeroed, with 16-byte stores where the row is aligned.
#include "common.cuh"

#include <atomic>
#include <cuda_pipeline_primitives.h>

namespace {

// The tile geometry: threads per CTA and codes per thread (a multiple of
// 4) for K1 and K2.  A build may override it (chip_smoke.py --pack-sweep).
#ifndef AIRS_PACK_THREADS
#define AIRS_PACK_THREADS 256
#endif
#ifndef AIRS_PACK_K1_PER
#define AIRS_PACK_K1_PER 8
#endif
#ifndef AIRS_PACK_K2_PER
#define AIRS_PACK_K2_PER 4
#endif
constexpr int kThreads = AIRS_PACK_THREADS;

struct Code {
  uint32_t hi, lo;
  int len;
};

// x / g for every u32 x, by multiply-high (Granlund and Montgomery, with
// the add-back step): magic and shifts from the host.
struct Golomb {
  uint32_t g, cutoff, outlier, magic;
  int glog2, sh1, sh2;
};

__device__ __forceinline__ uint32_t div_g(uint32_t x, const Golomb& gt) {
  const uint32_t t = __umulhi(x, gt.magic);
  return (t + ((x - t) >> gt.sh1)) >> gt.sh2;
}

__device__ __forceinline__ uint32_t ilog2u(uint32_t x) {
  return x ? 31u - __clz(x) : 0u;
}

// golomb.golomb_codeword: value v < golomb_upper_bound -> (cw, len <= 32),
// without branches.
__device__ __forceinline__ void golomb_codeword(uint32_t v, const Golomb& gt,
                                                uint32_t* cw, int* len) {
  const int len0 = gt.glog2 + 1;
  const bool short_form = v < gt.cutoff;
  const uint32_t vg = short_form ? 0u : v - gt.cutoff;
  const uint32_t group = div_g(vg, gt);
  const uint32_t rem = vg - group * gt.g;
  const uint32_t unary = group >= 32u ? 0xFFFFFFFFu : (1u << group) - 1u;
  *cw = short_form ? v : (unary << (len0 + 1)) + (gt.cutoff << 1) + rem;
  *len = short_form ? len0 : len0 + 1 + static_cast<int>(group);
}

// golomb.encode_codewords for one residual.
template <int kEnc>
__device__ __forceinline__ Code encode(int32_t r, const Golomb& gt) {
  Code c;
  if (kEnc == 0) {  // UNCOMPRESSED: raw 16 bits
    c.hi = 0u;
    c.lo = static_cast<uint32_t>(r) & 0xFFFFu;
    c.len = 16;
    return c;
  }
  const uint32_t m =
      ((static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 15)) &
      0xFFFFu;
  const bool esc = m >= gt.outlier;
  uint32_t cw;
  int len;
  if (kEnc == 1) {  // GOLOMB_ZERO: escape = Golomb(0) + 16 raw bits
    golomb_codeword(esc ? 0u : m + 1u, gt, &cw, &len);
    c.hi = 0u;
    c.lo = esc ? m : cw;
    c.len = esc ? gt.glog2 + 17 : len;
    return c;
  }
  // GOLOMB_MULTI: escape = Golomb(outlier + level) + (level + 1) * 2 raw bits
  const uint32_t diff = esc ? m - gt.outlier : 0u;
  const uint32_t level = diff < 4u ? 0u : ilog2u(diff) >> 1;
  golomb_codeword(esc ? gt.outlier + level : m, gt, &cw, &len);
  const uint32_t raw = (level + 1u) * 2u;
  c.hi = esc ? cw >> (32u - raw) : 0u;
  c.lo = esc ? (cw << raw) | diff : cw;
  c.len = esc ? len + static_cast<int>(raw) : len;
  return c;
}

// Start the copies of count words src[0, count) to dst (shared memory).
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src,
                                            int count, bool vec) {
  int i = threadIdx.x;
  if (vec) {
    for (; 4 * i + 3 < count; i += kThreads)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    i = (count & ~3) + static_cast<int>(threadIdx.x);
  }
  for (; i < count; i += kThreads) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// 16-byte word q of this thread's run in a staged array.
template <int kPer>
__device__ __forceinline__ uint4 run_words(const uint32_t* tile, int q) {
  return reinterpret_cast<const uint4*>(tile)[threadIdx.x * (kPer / 4) + q];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A code source: kPer codes per thread, kWide when codes may pass 32 bits,
// a Tile of staged arrays, stage() to start a tile's copies and get() to
// read this thread's run from a staged tile.

// K1's code source: Golomb codes of a block's residuals.  ZERO and
// UNCOMPRESSED codes are at most 32 bits (ZERO's outlier is clamped to the
// Golomb upper bound); a longer one still takes the two-piece path.
template <int kEnc>
struct ResidualCodes {
  static constexpr int kPer = AIRS_PACK_K1_PER;
  static constexpr int kTile = kThreads * kPer;
  static constexpr bool kWide = kEnc == 2;
  const uint32_t* res;
  Golomb gt;
  struct __align__(16) Tile {
    uint32_t r[kTile];
  };
  __device__ bool aligned(size_t row) const { return aligned16(res + row); }
  __device__ void stage(Tile& t, size_t at, int count, bool vec) const {
    stage_words(t.r, res + at, count, vec);
  }
  // count: codes staged in the tile (those past it are pads)
  __device__ void get(const Tile& t, int count, Code* c) const {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const uint4 v = run_words<kPer>(t.r, q);
      const uint32_t r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[4 * q + j] = encode<kEnc>(static_cast<int32_t>(r[j]), gt);
        if (static_cast<int>(threadIdx.x) * kPer + 4 * q + j >= count)
          c[4 * q + j].len = 0;
      }
    }
  }
};

// K2's code source: codes loaded from hi (absent: all zero), lo and lens.
template <bool kHi>
struct LoadedCodes {
  static constexpr int kPer = AIRS_PACK_K2_PER;
  static constexpr int kTile = kThreads * kPer;
  static constexpr bool kWide = true;
  const uint32_t* hi;
  const uint32_t* lo;
  const uint32_t* lens;
  struct __align__(16) Tile {
    uint32_t lo[kTile], lens[kTile], hi[kHi ? kTile : 4];
  };
  __device__ bool aligned(size_t row) const {
    return aligned16(lo + row) && aligned16(lens + row) &&
           (!kHi || aligned16(hi + row));
  }
  __device__ void stage(Tile& t, size_t at, int count, bool vec) const {
    stage_words(t.lo, lo + at, count, vec);
    stage_words(t.lens, lens + at, count, vec);
    if (kHi) stage_words(t.hi, hi + at, count, vec);
  }
  __device__ void get(const Tile& t, int count, Code* c) const {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const uint4 l = run_words<kPer>(t.lo, q);
      const uint4 n = run_words<kPer>(t.lens, q);
      const uint4 h =
          kHi ? run_words<kPer>(t.hi, q) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t ls[4] = {l.x, l.y, l.z, l.w};
      const uint32_t ns[4] = {n.x, n.y, n.z, n.w};
      const uint32_t hs[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live =
            static_cast<int>(threadIdx.x) * kPer + 4 * q + j < count;
        c[4 * q + j] = Code{hs[j], ls[j], live ? static_cast<int>(ns[j]) : 0};
      }
    }
  }
};

// Words in the ring: one tile of 64-bit codes and the carry word, with
// slack.  The copy-out of the tiles before runs between the scan's
// barriers, so the ring never holds more than one tile's words.
template <class Codes>
__host__ __device__ constexpr int ring_words() {
  return 2 * Codes::kTile + 64;
}

// Append a thread's run of kPer codes at bit pos (>= 0): a plain store into
// the ring for every word whose first bit lies in the run; the word the run
// starts in, if an earlier run began it, is returned in (*share_w,
// *share_v) for one OR after the next barrier.
template <class Codes>
__device__ __forceinline__ void emit_run(const Code* c, int pos, uint32_t* ring,
                                         int* share_w, uint32_t* share_v) {
  constexpr int kRing = ring_words<Codes>();
  const int fill0 = pos & 31;
  int fill = fill0;
  uint32_t cur = 0u;  // the word being filled, zero past fill
  int r = static_cast<int>(static_cast<unsigned>(pos >> 5) % kRing);
  bool first = true;
  auto put = [&]() {
    if (first && fill0) {
      *share_w = pos >> 5;
      *share_v = cur;
    } else {
      ring[r] = cur;
    }
    first = false;
    r = r + 1 == kRing ? 0 : r + 1;
  };
  // the low m bits of v, m in [0, 32]
  auto append = [&](uint32_t v, int m) {
    const uint32_t p = __funnelshift_lc(0u, v, 32 - m);  // left-justified
    cur |= p >> fill;
    const int end = fill + m;
    if (end >= 32) {
      put();
      cur = __funnelshift_lc(0u, p, 32 - fill);  // the bits that did not fit
    }
    fill = end & 31;
  };
#pragma unroll
  for (int j = 0; j < Codes::kPer; ++j) {
    const int len = c[j].len;
    if (Codes::kWide || len > 32) {
      const int hi_bits = max(len - 32, 0);
      append(c[j].hi, hi_bits);
      append(c[j].lo, len - hi_bits);
    } else {
      append(c[j].lo, len);
    }
  }
  if (fill > (first ? fill0 : 0)) put();
}

// Zero out[from, to), 16-byte stores where out is aligned.
__device__ __forceinline__ void zero_words(uint32_t* out, int from, int to) {
  const int t = threadIdx.x;
  int head = to;
  int body = to;
  if (aligned16(out)) {
    head = min(to, (from + 3) & ~3);
    body = max(head, to & ~3);
  }
  for (int i = from + t; i < head; i += kThreads) out[i] = 0u;
  for (int i = head / 4 + t; i < body / 4; i += kThreads)
    reinterpret_cast<uint4*>(out)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = body + t; i < to; i += kThreads) out[i] = 0u;
}

template <class Codes>
constexpr size_t smem_bytes() {
  return 2 * sizeof(typename Codes::Tile) +
         ring_words<Codes>() * sizeof(uint32_t);
}

template <class Codes>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(Codes codes, int n, int c_words, uint32_t* __restrict__ payload,
                int32_t* __restrict__ bits) {
  using Tile = typename Codes::Tile;
  constexpr int kPer = Codes::kPer;
  constexpr int kTile = Codes::kTile;
  constexpr int kRing = ring_words<Codes>();
  static_assert(kPer % 4 == 0, "runs are read as 16-byte words");
  extern __shared__ uint4 smem_vec[];
  Tile* tiles = reinterpret_cast<Tile*>(smem_vec);
  uint32_t* ring = reinterpret_cast<uint32_t*>(tiles + 2);
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * n;
  uint32_t* out = payload + static_cast<size_t>(b) * c_words;
  const bool vec = codes.aligned(row);
  const int n_tiles = (n + kTile - 1) / kTile;

  if (n_tiles) codes.stage(tiles[0], row, min(n, kTile), vec);
  __pipeline_commit();
  int carry = 0;    // bits of the tiles before
  int flushed = 0;  // words copied out
  int share_w = -1;
  uint32_t share_v = 0u;
  // copy the words below `upto` from the ring to the row
  auto copy_out = [&](int upto) {
    for (int w = flushed + t; w < min(upto, c_words); w += kThreads)
      out[w] = ring[static_cast<unsigned>(w) % kRing];
    flushed = upto;
  };
  for (int k = 0; k < n_tiles; ++k) {
    const int start = k * kTile;
    if (k + 1 < n_tiles)
      codes.stage(tiles[(k + 1) & 1], row + start + kTile,
                  min(n - start - kTile, kTile), vec);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // tile k staged; the tile before stored its words
    if (share_w >= 0) atomicOr(&ring[share_w % kRing], share_v);
    share_w = -1;

    Code c[kPer];
    codes.get(tiles[k & 1], n - start, c);
    int run_bits = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      c[j].len = min(max(c[j].len, 0), 64);
      run_bits += c[j].len;
    }
    // between the scan's barriers (after the ORs above, before this
    // tile's stores): copy out the words the tiles before finished
    int tile_bits;
    const int first = block_exclusive_scan<kThreads>(
        run_bits, &tile_bits, [&]() { copy_out(carry >> 5); });
    if (run_bits) emit_run<Codes>(c, carry + first, ring, &share_w, &share_v);
    carry += tile_bits;
  }
  __syncthreads();
  if (share_w >= 0) atomicOr(&ring[share_w % kRing], share_v);
  __syncthreads();
  const int used = (carry >> 5) + ((carry & 31) ? 1 : 0);
  copy_out(used);
  if (used < c_words) zero_words(out, used, c_words);
  if (t == 0) bits[b] = carry;
}

// Launch pack_kernel<Codes> over b blocks.  Its shared memory is fixed, so
// the attribute that allows it is set once per device.
template <class Codes>
int launch_pack(Codes codes, int b, int n, int c_words, void* payload,
                void* bits, void* stream) {
  static std::atomic<uint64_t> ready{0};  // devices with the attribute set
  constexpr size_t smem = smem_bytes<Codes>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(pack_kernel<Codes>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  pack_kernel<Codes><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, n, c_words, static_cast<uint32_t*>(payload),
      static_cast<int32_t*>(bits));
  return cudaGetLastError();
}

Golomb golomb_terms(unsigned g, unsigned outlier) {
  Golomb gt{};
  gt.g = g;
  gt.outlier = outlier;
  if (!g) return gt;  // UNCOMPRESSED
  gt.glog2 = 31 - __builtin_clz(g);
  gt.cutoff = (2u << gt.glog2) - g;
  const int ell = g > 1 ? 32 - __builtin_clz(g - 1) : 0;  // ceil(log2(g))
  gt.magic = static_cast<uint32_t>(
      (((uint64_t{1} << 32) * ((uint64_t{1} << ell) - g)) / g) + 1);
  gt.sh1 = ell < 1 ? ell : 1;
  gt.sh2 = ell > 1 ? ell - 1 : 0;
  return gt;
}

}  // namespace

extern "C" int airs_pack_residuals(const void* res, int b, int n, int c_words,
                                   int enc, unsigned g, unsigned outlier,
                                   void* payload, void* bits, void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(res);
  const Golomb gt = golomb_terms(g, outlier);
  switch (enc) {
    case 0:
      return launch_pack(ResidualCodes<0>{r, gt}, b, n, c_words, payload, bits,
                         stream);
    case 1:
      return launch_pack(ResidualCodes<1>{r, gt}, b, n, c_words, payload, bits,
                         stream);
    case 2:
      return launch_pack(ResidualCodes<2>{r, gt}, b, n, c_words, payload, bits,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int airs_pack_codes(const void* hi, const void* lo,
                               const void* lens, int b, int k, int c_words,
                               void* payload, void* bits, void* stream) {
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* l = static_cast<const uint32_t*>(lo);
  const uint32_t* n = static_cast<const uint32_t*>(lens);
  if (h)
    return launch_pack(LoadedCodes<true>{h, l, n}, b, k, c_words, payload,
                       bits, stream);
  return launch_pack(LoadedCodes<false>{h, l, n}, b, k, c_words, payload, bits,
                     stream);
}
