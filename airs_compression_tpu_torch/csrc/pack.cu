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
//    geometries timed on the H100.
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
//
// Long-row mode (the entries *_at): one long block row, cut into rows of at
// most n codes, is packed by one launch straight into ONE stream, each row
// at its absolute start bit (starts[], from an exclusive scan of the rows'
// code-length sums, the header's bits included).  It replaces the JAX
// long-stream tier's per-row Pallas packs and their doubling-tree and fori
// span merges (airs_compression_tpu/parallel/sp.py:159-203, :318-330).  Its
// launches have few rows (2 to 512 on the long-stream tier's paths), so one
// CTA a row walking its tiles in turn would leave most of the card idle
// behind a chain of tile carries.  Instead (pack_long_kernel):
//
// 1. One thread-block cluster a row, one tile a CTA.  A row of n codes gets
//    a cluster of S CTAs; CTA j takes the row's tiles j, j + S, ..., one a
//    round.  S = min(8, tiles of n), halved while the launch would have
//    more than 512 CTAs: at 8192 codes a row, S = 8 (K2) or 4 (K1) and one
//    round up to 64 or 128 rows, and one CTA a row at 512 rows, which fill
//    the card without clusters.
// 2. Loads.  A tile is staged into shared memory by cp.async, 16-byte
//    copies where the row is aligned (a TMA bulk copy took longer at 512
//    rows); a CTA that takes more than one tile stages the next one while
//    it packs this one, in a second buffer only such launches allocate.
// 3. The tile's start bit.  The CTA scan of the runs' bit counts gives the
//    tile's bits; the CTA sends them into slot j of the round's count array
//    in every CTA of the cluster (distributed shared memory, st.async),
//    each store counted by the receiving CTA's mbarrier of the round's
//    parity.  Once its mbarrier's phase completes, a CTA has every count of
//    the round: the slots before j, plus the row's start bit and the rounds
//    before, give its tile's start bit.  The arrays and mbarriers alternate
//    by round, so a count of round r + 1 cannot land in a phase of round r;
//    a cluster barrier (arrived at when the CTA starts, waited on before
//    its first send) makes sure every CTA runs before counts reach it, and
//    a CTA waits for all its counts before it exits.  A cluster of one CTA
//    sends none.
// 4. Stores.  The tile's runs are emitted into its own zeroed words in
//    shared memory: a plain store of each word that holds one run's bits
//    only, the word a run starts in (where an earlier run began it) and
//    the word it ends in (where a later run goes on in it) ORed at once.
//    The words go to start / 32 + w, and are zeroed again as they go.  The
//    stream is zeroed (or holds header bits) before the launch and tiles
//    run in no order, so a word a tile shares with a neighbour (in its row
//    or the next) -- its first word when its start % 32 != 0, its last
//    when its end is not word-aligned -- is ORed into the stream with
//    atomicOr; every other word holds only the tile's bits and gets a
//    plain store.  Nothing past a row's bits is zeroed.  CTA 0 of the
//    cluster writes the row's bits.
#include "common.cuh"

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>

namespace {

// The tile geometry: threads per CTA; each code source below sets its codes
// per thread (a multiple of 4).
constexpr int kThreads = 256;

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
  static constexpr int kPer = 8;
  static constexpr int kTile = kThreads * kPer;
  static constexpr bool kWide = kEnc == 2;
  // CTAs an SM the long-row kernel is compiled for: any number, since its
  // launches are of at most 512 CTAs or one a row, and fewer registers spill
  static constexpr int kLongBlocks = 1;
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
  static constexpr int kPer = 4;
  static constexpr int kTile = kThreads * kPer;
  static constexpr bool kWide = true;
  static constexpr int kLongBlocks = 8;  // 32 registers, none spilled
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
// *share_v) for one OR after the next barrier.  kLongRow: ring is a zeroed
// buffer that holds word pos / 32 at index pos / 32, and the run ORs the
// word it starts in (if an earlier run began it) and the word it ends in
// (if a later run goes on in it) into it at once.
template <class Codes, bool kLongRow = false>
__device__ __forceinline__ void emit_run(const Code* c, int pos, uint32_t* ring,
                                         int* share_w, uint32_t* share_v) {
  constexpr int kRing = ring_words<Codes>();
  const int fill0 = pos & 31;
  int fill = fill0;
  uint32_t cur = 0u;  // the word being filled, zero past fill
  int r = kLongRow ? pos >> 5
                   : static_cast<int>(static_cast<unsigned>(pos >> 5) % kRing);
  bool first = true;
  auto put = [&]() {
    if (first && fill0) {
      if (kLongRow) {
        atomicOr(&ring[r], cur);
      } else {
        *share_w = pos >> 5;
        *share_v = cur;
      }
    } else {
      ring[r] = cur;
    }
    first = false;
    r = !kLongRow && r + 1 == kRing ? 0 : r + 1;
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
  if (fill > (first ? fill0 : 0)) {
    if (kLongRow)
      atomicOr(&ring[r], cur);
    else
      put();
  }
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

// Row b packs codes [b n, min((b + 1) n, total)) into payload row b of
// c_words words.
template <class Codes>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(Codes codes, int n, int64_t total, int c_words,
                uint32_t* __restrict__ payload, int32_t* __restrict__ bits) {
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
  const int64_t left = total - static_cast<int64_t>(row);
  if (left < n) n = static_cast<int>(left);  // the last row may be short
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

// Allow kernel smem bytes of dynamic shared memory on the current device,
// once per device: ready holds the devices where it is set.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launch pack_kernel<Codes> over b rows.
template <class Codes>
int launch_pack(Codes codes, int b, int n, int64_t total, int c_words,
                void* payload, void* bits, void* stream) {
  static std::atomic<uint64_t> ready{0};
  constexpr size_t smem = smem_bytes<Codes>();
  const cudaError_t err = allow_smem(pack_kernel<Codes>, smem, ready);
  if (err != cudaSuccess) return err;
  pack_kernel<Codes><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, n, total, c_words, static_cast<uint32_t*>(payload),
      static_cast<int32_t*>(bits));
  return cudaGetLastError();
}

// -- long-row mode: one cluster a row, one tile a CTA ------------------------

namespace cg = cooperative_groups;

// CTAs a row at most: the portable cluster size
constexpr int kClusterMax = 8;
// CTAs a launch at most, where rows allow: about four an SM on 132 SMs;
// a launch with more rows fills the card with fewer CTAs a row, which
// have fewer counts to wait for
constexpr int kLongCtas = 512;
// An mbarrier wait that does not end within 2^34 SM cycles traps: a lost
// count fails the launch instead of hanging the card.
constexpr long long kWaitCycles = 1ll << 34;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// until the phase of this parity of the mbarrier has completed (acquiring
// the stores it counted, from any CTA of the cluster)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// Store v into the int at local address `at` of CTA `rank` of the cluster,
// counted (4 bytes) by that CTA's mbarrier at local address `bar`.
__device__ __forceinline__ void send_count(const void* at, const void* bar,
                                           int rank, int v) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra)
               : "r"(smem_addr(at)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];" ::"r"(ra),
      "r"(v), "r"(rb)
      : "memory");
}

template <class Codes>
struct LongSmem {
  int counts[2][kClusterMax];  // [round % 2][rank]: the round's tiles' bits
  uint64_t got[2];  // [round % 2]: mbarriers of the counts' stores
  // the tile's words from its start bit's word on: 64-bit codes and the
  // start's offset in its word, in whole 16-byte words
  alignas(16) uint32_t out[2 * Codes::kTile + 4];
  // the staged tiles, by round parity: the second only where a CTA takes
  // more than one tile
  typename Codes::Tile tiles[2];
};

// the kernel's shared memory with one staged tile, or two
template <class Codes>
constexpr size_t long_smem(bool two) {
  return sizeof(LongSmem<Codes>) - (two ? 0 : sizeof(typename Codes::Tile));
}

// Row blockIdx.x / S (S CTAs a cluster) packs codes [b n, min((b + 1) n,
// total)) at bit starts[b] of the stream payload[0, c_words); a start
// below 0 writes nothing.  bits[b]: the row's bits.
template <class Codes>
__global__ void __launch_bounds__(kThreads, Codes::kLongBlocks)
    pack_long_kernel(Codes codes, int n, int64_t total, int c_words,
                     const int32_t* __restrict__ starts,
                     uint32_t* __restrict__ payload,
                     int32_t* __restrict__ bits) {
  constexpr int kPer = Codes::kPer;
  constexpr int kTile = Codes::kTile;
  extern __shared__ uint4 smem_vec[];
  LongSmem<Codes>& sm = *reinterpret_cast<LongSmem<Codes>*>(smem_vec);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int j = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int b = blockIdx.x / S;
  const size_t row = static_cast<size_t>(b) * n;
  const int64_t left = total - static_cast<int64_t>(row);
  if (left < n) n = static_cast<int>(left);  // the last row may be short
  const int n_tiles = (n + kTile - 1) / kTile;
  const int rounds = (n_tiles + S - 1) / S;
  const int start = starts[b];
  const bool vec = codes.aligned(row);
  auto count_of = [&](int r) {  // codes in round r's tile
    const int tile = r * S + j;
    return tile < n_tiles ? min(kTile, n - tile * kTile) : 0;
  };
  auto stage = [&](int r) {  // round r's tile into buffer r % 2
    const int count = count_of(r);
    if (count)
      codes.stage(sm.tiles[r & 1],
                  row + static_cast<size_t>(r * S + j) * kTile, count, vec);
    __pipeline_commit();
  };

  if (t == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&sm.got[p]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every CTA of the cluster has started: waited on before the first count
  // goes into another CTA's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  stage(0);
  // the tile's words start zeroed (and are zeroed again as they are
  // copied out)
  for (int w = t; w < (2 * kTile + 4) / 4; w += kThreads)
    reinterpret_cast<uint4*>(sm.out)[w] = make_uint4(0u, 0u, 0u, 0u);
  int carry = start;  // the bits of the rounds before, from the row's start
  for (int r = 0; r < rounds; ++r) {
    const int count = count_of(r);
    // the next round's tile loads while this one is packed
    if (r + 1 < rounds)
      stage(r + 1);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // this round's tile is staged, by every thread

    Code c[kPer];
    codes.get(sm.tiles[r & 1], count, c);
    int run_bits = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k].len = min(max(c[k].len, 0), 64);
      run_bits += c[k].len;
    }
    int tile_bits;
    const int first = block_exclusive_scan<kThreads>(run_bits, &tile_bits);

    if (r == 0) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    int pos = carry;  // the tile's start bit
    if (S == 1) {
      carry += tile_bits;
    } else {
      // the tile's bits into slot j of the round's counts in every CTA;
      // this CTA's mbarrier of the round's parity counts the S stores it
      // gets (a phase of that parity every other round)
      uint64_t* got = &sm.got[r & 1];
      if (t == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_addr(got)),
            "r"(4 * S)
            : "memory");
      if (t < S) send_count(&sm.counts[r & 1][j], got, t, tile_bits);
      mbar_wait(got, (r >> 1) & 1);
      // lane i of each warp takes rank i's count: the ranks before j give
      // the tile's start, all of them the round's bits
      const int lane = t & 31;
      const int v = lane < S ? sm.counts[r & 1][lane] : 0;
      pos += __reduce_add_sync(~0u, lane < j ? v : 0);
      carry += __reduce_add_sync(~0u, v);
    }
    if (!tile_bits) continue;  // nothing to store (uniform in the CTA)

    const int s0 = pos & 31;
    const int base = pos >> 5;
    if (run_bits)
      emit_run<Codes, true>(c, s0 + first, sm.out, nullptr, nullptr);
    __syncthreads();
    const int end = s0 + tile_bits;
    const int used = (end + 31) >> 5;
    const int or_last = (end & 31) ? used - 1 : -1;
    const int limit = start < 0 ? 0 : min(used, c_words - base);
    for (int w = t; w < used; w += kThreads) {
      const uint32_t v = sm.out[w];
      sm.out[w] = 0u;
      if (w >= limit) continue;
      if ((w == 0 && s0) || w == or_last)
        atomicOr(payload + base + w, v);
      else
        payload[base + w] = v;
    }
  }
  if (!rounds) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (j == 0 && t == 0) bits[b] = carry - start;
}

// CTAs a row of a long-row launch over `rows` rows of `tiles` tiles each:
// min(8, tiles), halved while rows x S is over kLongCtas (a CTA then takes
// a tile a round, the next one staged meanwhile).
int long_cluster(int rows, int tiles) {
  int S = tiles < 1 ? 1 : tiles < kClusterMax ? tiles : kClusterMax;
  while (S > 1 && int64_t{rows} * S > kLongCtas) S = (S + 1) / 2;
  return S;
}

// Launch pack_long_kernel<Codes> over `rows` rows of n codes, one cluster
// of long_cluster() CTAs a row, with two staged tiles only where a CTA
// takes more than one.
template <class Codes>
int launch_long(Codes codes, int rows, int n, int64_t total, int c_words,
                const void* starts, void* payload, void* bits, void* stream) {
  static std::atomic<uint64_t> ready{0};
  const auto kernel = pack_long_kernel<Codes>;
  cudaError_t err = allow_smem(kernel, long_smem<Codes>(true), ready);
  if (err != cudaSuccess) return err;
  const int tiles = (n + Codes::kTile - 1) / Codes::kTile;
  const int S = long_cluster(rows, tiles);
  const bool two = (tiles + S - 1) / S > 1;
  if (int64_t{rows} * S > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = long_smem<Codes>(two);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, codes, n, total, c_words,
                           static_cast<const int32_t*>(starts),
                           static_cast<uint32_t*>(payload),
                           static_cast<int32_t*>(bits));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch: do not leave it to the next
    return err;
  }
  return cudaGetLastError();
}

// A launch over b rows in batch (kLong false: starts null) or long-row mode.
template <class Codes, bool kLong>
int launch(Codes codes, int b, int n, int64_t total, int c_words,
           const void* starts, void* payload, void* bits, void* stream) {
  if constexpr (kLong)
    return launch_long<Codes>(codes, b, n, total, c_words, starts, payload,
                              bits, stream);
  else
    return launch_pack<Codes>(codes, b, n, total, c_words, payload, bits,
                              stream);
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

// One launch over b rows.  at: null for a batch of b rows of n codes into
// (b, c_words) payload rows; else long-row mode: the rows of codes
// [i n, min((i + 1) n, total)) of one long row, each packed at bit at[i] of
// the one stream payload[0, c_words).
template <bool kLong>
int residuals_entry(const void* res, int b, int n, int64_t total, int c_words,
                    int enc, unsigned g, unsigned outlier, const void* at,
                    void* payload, void* bits, void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(res);
  const Golomb gt = golomb_terms(g, outlier);
  switch (enc) {
    case 0:
      return launch<ResidualCodes<0>, kLong>(
          {r, gt}, b, n, total, c_words, at, payload, bits, stream);
    case 1:
      return launch<ResidualCodes<1>, kLong>(
          {r, gt}, b, n, total, c_words, at, payload, bits, stream);
    case 2:
      return launch<ResidualCodes<2>, kLong>(
          {r, gt}, b, n, total, c_words, at, payload, bits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kLong>
int codes_entry(const void* hi, const void* lo, const void* lens, int b, int k,
                int64_t total, int c_words, const void* at, void* payload,
                void* bits, void* stream) {
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* l = static_cast<const uint32_t*>(lo);
  const uint32_t* n = static_cast<const uint32_t*>(lens);
  if (h)
    return launch<LoadedCodes<true>, kLong>(
        {h, l, n}, b, k, total, c_words, at, payload, bits, stream);
  return launch<LoadedCodes<false>, kLong>(
      {h, l, n}, b, k, total, c_words, at, payload, bits, stream);
}

}  // namespace

extern "C" int airs_pack_residuals(const void* res, int b, int n, int c_words,
                                   int enc, unsigned g, unsigned outlier,
                                   void* payload, void* bits, void* stream) {
  return residuals_entry<false>(res, b, n, int64_t{b} * n, c_words, enc, g,
                                outlier, nullptr, payload, bits, stream);
}

extern "C" int airs_pack_codes(const void* hi, const void* lo,
                               const void* lens, int b, int k, int c_words,
                               void* payload, void* bits, void* stream) {
  return codes_entry<false>(hi, lo, lens, b, k, int64_t{b} * k, c_words,
                            nullptr, payload, bits, stream);
}

// Long-row mode: `total` residuals (codes) in rows of n, row i at bit at[i]
// (int32) of the stream payload (c_words u32 words); bits: each row's bits.
extern "C" int airs_pack_residuals_at(const void* res, int rows, int n,
                                      int total, int c_words, int enc,
                                      unsigned g, unsigned outlier,
                                      const void* at, void* payload,
                                      void* bits, void* stream) {
  return residuals_entry<true>(res, rows, n, total, c_words, enc, g, outlier,
                               at, payload, bits, stream);
}

// CTAs of a long-row launch of K1 (residuals != 0) or K2 over `rows` rows
// of n codes.
extern "C" int airs_pack_long_ctas(int rows, int n, int residuals) {
  const int tile =
      residuals ? ResidualCodes<1>::kTile : LoadedCodes<false>::kTile;
  return rows * long_cluster(rows, (n + tile - 1) / tile);
}

extern "C" int airs_pack_codes_at(const void* hi, const void* lo,
                                  const void* lens, int rows, int k,
                                  int total, int c_words, const void* at,
                                  void* payload, void* bits, void* stream) {
  return codes_entry<true>(hi, lo, lens, rows, k, total, c_words, at, payload,
                           bits, stream);
}
