// K3: Golomb decode of N codes per block, one CTA of 256 threads per block.
//
// Replaces airs_compression_tpu/ops/pallas_decode.py::_make_kernel (entry
// decode_blocks_pallas, dispatched from ops/decode.py:206-212); the plain
// PyTorch version is ops/decode.py::decode_codes_plain.
//
// Input: frames (B, W) u32 big-endian word values, decoding starts at bit
// hdr_bits; per-block Golomb parameter g and outlier (B,).  Output: mapped
// values (B, N) u32 and end bit positions (B,) int32, with 1 << 29 added
// where one of the N codes was malformed (as ops/decode.py::_decode_one).
// Reads past a row give zeros.
//
// What bounds it on the H100: not bytes (a few MB in and out) but the
// bit-serial chain: each code's position depends on every earlier code's
// length.  A block is therefore decoded by speculation and
// self-synchronisation, the usual way to decode prefix codes in parallel:
//
// 1. The CTA stages its row in shared memory (16-byte loads where the row
//    is aligned) and finds the row's last nonzero word; past it every
//    window is zero.  Rows wider than the shared memory a CTA may hold are
//    read from device memory through the same cursor.
// 2. Speculate: the bits [hdr_bits, end) up to that word are cut into at
//    most 256 segments of at least 64 bits.  Thread t decodes from the
//    start of its segment as if a code began there, and records its exit
//    (the first code start at or past its segment's end) and the number of
//    codes that start inside it.  Thread 0's start is the true one.
// 3. Synchronise: each thread whose entry (the exit of the thread before
//    it) differs from the entry it decoded from decodes its segment again,
//    until no entry changes.  After round k segments 0..k are exact, so the
//    rounds are bounded by the segment count; Golomb codes resynchronise
//    within a few codewords, so real data needs one.  A walk stops as soon
//    as it reaches a code start of its segment's speculative walk (kept as
//    a bitmap of the segment's first 64 bits): from there on it is that
//    walk, whose exit and count are known.
// 4. Place and write: a CTA scan of the counts gives each code its index;
//    each thread decodes its segment once more from its exact entry and
//    writes the codes below N into a (B, N)-row staged in shared memory,
//    which the CTA then stores coalesced.  If the chain passes the last
//    nonzero word before the N-th code, every remaining window is zero, so
//    the remaining codes are one value each and the end position is closed
//    form.  Codes past the N-th never reach the values, `bad` or the end.
//
// The TPU kernel fed 1024 lanes from a pyramid of aligned slabs because the
// TPU has no per-lane gather; here each thread keeps three words of the row
// in registers and loads the next word when its cursor crosses a word.
//
// Window mode (entry airs_decode_windows, decode_windows_kernel): the rows
// are not stored.  Row b is the window of w_count words of ONE word stream
// that starts at bit starts[b]: window word i is stream words start / 32 + i
// and + i + 1 funnel-shifted by start % 32, the next word read as zero for
// the last window word and every word past the stream's end read as zero.
// This is the sidecar decode of one long block (parallel/sp.py), and it
// replaces the JAX tier's window build and scan decode
// (airs_compression_tpu/parallel/sp.py:486-519, a row gather and a 7-level
// barrel shift, then ops/pallas_decode.py:137).  A window holds the next
// chunk's bits past its own end, as the JAX windows do; the caller's check
// of the end positions rejects a sidecar that lies.
//
// It is issue-bound, not byte-bound: phase G of chip_smoke.py moves about
// 20 MB, yet every code costs a chain of some 50 dependent instructions.
// Decoded as the batch kernel decodes a row (one CTA of 256 threads), a
// window of ~5,500 bits leaves most threads idle, decodes every code about
// twice (speculate, then write) and advances a register cursor by a loop.
// So the window kernel (decode_windows_kernel) is built around instructions
// a code:
//
// 1. One warp a window, eight windows a CTA.  The window's bits are cut
//    into at most 32 segments of at least 64 bits, one a lane; rounds are
//    synchronised by warp shuffles of the exits and the codes placed by a
//    warp scan of the counts, with no CTA barrier past the staging.  A
//    launch of few windows (under 16 an SM, as 2^20 samples at chunks of
//    1024 or 2^22 at 4096) leaves the card with too few warps to hide each
//    code's latency, so where a window has the bits, it gets 2 or 4 warps
//    (64 or 128 segments), which exchange exits and counts through shared
//    memory under a named barrier of their own (bar.red.or for the rounds).
// 2. Staging once.  The CTA's windows usually lie in one span of the stream
//    (consecutive chunks); the span is copied once into shared memory by
//    16-byte cp.async from the aligned word below its first word, and each
//    window reads its words there at its own offset: no funnel shift at
//    staging, no word loaded twice from device memory.  A window works in
//    bits of the stream from its base word (its start bit is hdr_bits +
//    start % 32); words at or past its limit min(w_count, stream words -
//    base) read as zero.  A cursor loads the three words under each code
//    (WordCursor): no register window advanced by a loop.  A CTA whose
//    windows do not fit one span (starts out of order, far apart, below 0
//    or past the end; windows wider than shared memory) reads device memory
//    through the same cursor.
// 3. Each code decoded once.  A thread's speculative walk keeps its codes'
//    values (16 bits) and lengths (8 bits) in shared memory, up to `room`
//    codes sized by the window's codes a segment; a code that is malformed
//    ends the kept run.  A segment whose exact entry is its own start
//    writes its kept values as they are; one whose synchronise walk joined
//    its speculative walk at code k writes the codes of that walk, decoded
//    again, then its kept values from k on.  Codes past the room, or past a
//    walk that never joined, are decoded again: an exact path.  Where g is
//    a power of two (every remainder short), the decode drops the long form.
// 4. Write.  Values go to the window's (1, N) row staged as 16 bits in
//    shared memory, then out as 16-byte stores; a thread that wrote a value
//    over 16 bits (a malformed code) writes its codes again straight to
//    device memory after the copy.  Rows too long for shared memory are
//    written straight to device memory.
#include "common.cuh"

#include <cuda_pipeline_primitives.h>
#include <limits.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // segments per block row
constexpr int kMinSegmentBits = 64;
constexpr int kPoisonBits = 1 << 29;
constexpr int kWinWarps = 8;  // windows a CTA in window mode, one warp each

struct Terms {
  uint32_t g, cutoff, outlier;
  int glog2;
};

struct Code {
  uint32_t mapped;
  int consumed;
  bool bad;
};

// The 64-bit window at a code's first bit, as two words.
struct Window {
  uint32_t hi, lo;
};

// count bits of the window from MSB-relative start (start < 64, count <=
// 32); bits past the window read as zeros
__device__ __forceinline__ uint32_t take(Window w, int start, int count) {
  const uint32_t top =
      start < 32 ? __funnelshift_l(w.lo, w.hi, start) : w.lo << (start - 32);
  return count ? top >> (32 - count) : 0u;
}

// ops/decode.py::_decode_one for the window at a code's first bit.  kPow2:
// g is a power of two (or 0), so no remainder takes the long form.
template <int kEnc, bool kPow2 = false>
__device__ __forceinline__ Code decode_code(Window w, const Terms& tm) {
  Code c;
  if (kEnc == 0) {  // UNCOMPRESSED: raw 16-bit residual
    c.mapped = w.hi >> 16;
    c.consumed = 16;
    c.bad = false;
    return c;
  }
  const int q = __clz(~w.hi);  // unary quotient: leading ones (<= 32)
  const uint32_t r0 = take(w, q + 1, tm.glog2);
  const int long_form = !kPow2 && r0 >= tm.cutoff ? 1 : 0;
  const uint32_t extra = take(w, q + 1 + tm.glog2, long_form);
  const uint32_t rem = long_form ? ((r0 << 1) | extra) - tm.cutoff : r0;
  const uint32_t v = static_cast<uint32_t>(q) * tm.g + rem;
  int consumed = q + 1 + tm.glog2 + long_form;
  c.bad = consumed > 32;  // Golomb part over the 32-bit codeword cap
  if (kEnc == 1) {  // GOLOMB_ZERO: 0 escapes to 16 raw bits
    const bool esc = v == 0u;
    c.mapped = esc ? take(w, consumed, 16) : v - 1u;
    consumed += esc ? 16 : 0;
  } else {  // GOLOMB_MULTI: v >= outlier escapes to (level+1)*2 raw bits
    const bool esc = v >= tm.outlier;
    // u32 arithmetic, as the plain version's mask
    const uint32_t nbits = esc ? (v - tm.outlier + 1u) * 2u : 0u;
    c.bad |= nbits > 32u;
    const int taken = static_cast<int>(min(nbits, 32u));
    c.mapped = esc ? tm.outlier + take(w, consumed, taken) : v;
    consumed += taken;
  }
  c.bad |= c.mapped > 0xFFFFu;  // zigzag of an i16 is < 2^16
  c.consumed = consumed;
  return c;
}

// Words of a staged span (shared memory) or of the stream (device memory).
struct SharedWords {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator()(int i) const { return p[i]; }
};
struct GlobalWords {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return __ldg(p + i);
  }
};

// A register window over a row (p: shared or device memory); words at or
// past `limit` read as zeros.
struct Cursor {
  const uint32_t* p;
  int limit;
  int base;
  uint32_t w0, w1, w2;

  __device__ __forceinline__ uint32_t load(int i) const {
    return i < limit ? p[i] : 0u;
  }
  __device__ __forceinline__ void seek(int pos) {
    base = pos >> 5;
    w0 = load(base);
    w1 = load(base + 1);
    w2 = load(base + 2);
  }
  // the window at pos; pos never moves back between seeks
  __device__ __forceinline__ Window window(int pos) {
    const int wi = pos >> 5;
    while (base < wi) {
      w0 = w1;
      w1 = w2;
      w2 = load(base + 3);
      ++base;
    }
    const int r = pos & 31;
    return Window{__funnelshift_l(w1, w0, r), __funnelshift_l(w2, w1, r)};
  }
};

// The window kernel's cursor: the three words under a code's first bit
// loaded at each code (from shared memory, where the span is staged), with
// no registers carried between codes and no loop to advance them; words
// at or past `limit` read as zeros.
template <class S>
struct WordCursor {
  S src;
  int limit;

  __device__ __forceinline__ void seek(int) const {}
  __device__ __forceinline__ Window window(int pos) const {
    const int i = pos >> 5;
    const int r = pos & 31;
    const uint32_t a = i < limit ? src(i) : 0u;
    const uint32_t b = i + 1 < limit ? src(i + 1) : 0u;
    const uint32_t c = i + 2 < limit ? src(i + 2) : 0u;
    return Window{__funnelshift_l(b, a, r), __funnelshift_l(c, b, r)};
  }
};

// A segment's speculative walk: its exit, its code count, and which of the
// segment's first 64 bits start one of its codes.
struct Spec {
  uint64_t starts;
  int exit, count;
};

struct NoKeep {
  __device__ void operator()(int, const Code&) const {}
};

// Decode from the segment's first bit while the code start is before
// seg_end; keep(i, code) sees the walk's i-th code.
template <int kEnc, bool kPow2 = false, class Cur, class Keep = NoKeep>
__device__ __forceinline__ Spec speculate(Cur& cur, int seg_start,
                                          int seg_end, const Terms& tm,
                                          Keep keep = {}) {
  Spec s{0ull, seg_start, 0};
  cur.seek(seg_start);
  for (; s.exit < seg_end && s.exit - seg_start < 64; ++s.count) {
    s.starts |= 1ull << (s.exit - seg_start);
    const Code c = decode_code<kEnc, kPow2>(cur.window(s.exit), tm);
    keep(s.count, c);
    s.exit += c.consumed;
  }
  for (; s.exit < seg_end; ++s.count) {
    const Code c = decode_code<kEnc, kPow2>(cur.window(s.exit), tm);
    keep(s.count, c);
    s.exit += c.consumed;
  }
  return s;
}

struct NoJoin {
  __device__ void operator()(int, int, int) const {}
};

// Decode from entry pos (at or past seg_start) while the code start is
// before seg_end: the exit (first code start at or past seg_end) and the
// code count.  A chain that reaches a code start of the speculative walk
// follows that walk from there on, so the walk stops at the first one;
// join(c, k, pos) then sees the codes it decoded (c), the index of the
// speculative walk's code it joined (k) and that code's start.
template <int kEnc, bool kPow2 = false, class Cur, class Join = NoJoin>
__device__ __forceinline__ void walk(Cur& cur, int pos, int seg_start,
                                     int seg_end, const Spec& spec,
                                     const Terms& tm, int* seg_exit,
                                     int* count, Join join = {}) {
  cur.seek(pos);
  int c = 0;
  for (; pos < seg_end && pos - seg_start < 64; ++c) {
    const int off = pos - seg_start;
    if ((spec.starts >> off) & 1ull) {
      const int k = __popcll(spec.starts & ((1ull << off) - 1));
      *seg_exit = spec.exit;
      *count = c + spec.count - k;
      join(c, k, pos);
      return;
    }
    pos += decode_code<kEnc, kPow2>(cur.window(pos), tm).consumed;
  }
  for (; pos < seg_end; ++c)
    pos += decode_code<kEnc, kPow2>(cur.window(pos), tm).consumed;
  *seg_exit = pos;
  *count = c;
}

template <int kEnc>
__global__ void __launch_bounds__(kThreads)
    decode_blocks_kernel(const uint32_t* __restrict__ words, int w_count,
                         int n, int hdr_bits, const uint32_t* __restrict__ g_arr,
                         const uint32_t* __restrict__ o_arr, int stage_words,
                         int stage_out, uint32_t* __restrict__ vals,
                         int32_t* __restrict__ end_pos) {
  extern __shared__ uint4 smem_vec[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_vec);
  __shared__ int exits[kThreads];
  __shared__ int last_nonzero;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const uint32_t* row = words + static_cast<size_t>(b) * w_count;
  uint32_t* out_row = vals + static_cast<size_t>(b) * n;
  uint32_t* out = stage_out ? smem + (stage_words ? w_count : 0) : out_row;

  // 1. stage the row, find its last nonzero word
  if (t == 0) last_nonzero = -1;
  int last = -1;
  const bool vec = (w_count & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  const int v_count = vec ? w_count >> 2 : 0;
  for (int i = t; i < v_count; i += kThreads) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row) + i);
    if (stage_words) smem_vec[i] = w;
    if (w.x | w.y | w.z | w.w)
      last = 4 * i + (w.w ? 3 : w.z ? 2 : w.y ? 1 : 0);
  }
  for (int i = 4 * v_count + t; i < w_count; i += kThreads) {
    const uint32_t w = __ldg(row + i);
    if (stage_words) smem[i] = w;
    if (w) last = i;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    last = max(last, __shfl_xor_sync(0xFFFFFFFFu, last, o));
  __syncthreads();  // last_nonzero initialised
  if ((t & 31) == 0 && last >= 0) atomicMax(&last_nonzero, last);
  __syncthreads();  // staged row and last_nonzero complete

  const uint32_t g = g_arr[b];
  Terms tm;
  tm.g = g;
  tm.glog2 = g ? 31 - __clz(g) : 0;
  tm.cutoff = (2u << tm.glog2) - g;
  tm.outlier = o_arr[b];
  const int w_eff = last_nonzero + 1;
  Cursor cur;
  cur.p = stage_words ? smem : row;  // the staged row in shared memory
  cur.limit = w_eff;

  // 2. speculate
  const int end_bits = max(hdr_bits, 32 * w_eff);
  const int bits = end_bits - hdr_bits;
  int seg = max(kMinSegmentBits, (bits + kThreads - 1) / kThreads);
  seg = (seg + 31) & ~31;
  const int n_seg = (bits + seg - 1) / seg;
  const bool active = t < n_seg;
  const int seg_start = hdr_bits + t * seg;
  const int seg_end = min(seg_start + seg, end_bits);
  Spec spec{0ull, seg_start, 0};
  if (active) spec = speculate<kEnc>(cur, seg_start, seg_end, tm);
  int entry = seg_start, seg_exit = spec.exit, count = spec.count;
  exits[t] = seg_exit;
  __syncthreads();

  // 3. synchronise
  for (;;) {
    const int e = t ? exits[t - 1] : hdr_bits;
    __syncthreads();  // every entry read before any exit changes
    const bool redo = active && e != entry;
    if (redo) {
      entry = e;
      walk<kEnc>(cur, entry, seg_start, seg_end, spec, tm, &seg_exit,
                 &count);
      exits[t] = seg_exit;
    }
    if (!__syncthreads_or(redo)) break;
  }

  // 4. place and write the codes below n
  int total;
  const int first = block_exclusive_scan<kThreads>(active ? count : 0, &total);
  const int tail_from = n_seg ? exits[n_seg - 1] : hdr_bits;
  bool bad = false;
  int end = -1;  // set by the one thread that knows the end position
  if (active && first < n) {
    const int stop = min(count, n - first);
    int pos = entry;
    cur.seek(pos);
    for (int j = 0; j < stop; ++j) {
      const Code c = decode_code<kEnc>(cur.window(pos), tm);
      out[first + j] = c.mapped;
      bad |= c.bad;
      pos += c.consumed;
    }
    if (first + stop == n) end = pos;  // this thread decoded code n - 1
  }
  if (total < n) {  // the chain left the row's nonzero words: zero windows
    const Code z = decode_code<kEnc>(Window{0u, 0u}, tm);
    for (int i = total + t; i < n; i += kThreads) out[i] = z.mapped;
    if (t == 0) {
      bad |= z.bad;
      end = tail_from + (n - total) * z.consumed;
    }
  }
  if (t == 0 && n == 0) end = hdr_bits;
  const bool any_bad = __syncthreads_or(bad);  // also orders the staged row
  if (end >= 0) end_pos[b] = end + (any_bad ? kPoisonBits : 0);
  if (stage_out)
    for (int i = t; i < n; i += kThreads) out_row[i] = out[i];
}

template <int kEnc>
int launch(const void* words, int b, int w_count, int n, int hdr_bits,
           const void* g, const void* outlier, void* vals, void* end_pos,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, decode_blocks_kernel<kEnc>);
  if (err != cudaSuccess) return err;
  // the row first (it is read on every step), then the output row
  const size_t avail = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  const size_t row_bytes = static_cast<size_t>(w_count) * sizeof(uint32_t);
  const size_t out_bytes = static_cast<size_t>(n) * sizeof(uint32_t);
  const int stage_words = row_bytes <= avail;
  const size_t left = avail - (stage_words ? row_bytes : 0);
  const int stage_out = out_bytes <= left;
  const size_t smem =
      (stage_words ? row_bytes : 0) + (stage_out ? out_bytes : 0);
  err = cudaFuncSetAttribute(decode_blocks_kernel<kEnc>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_blocks_kernel<kEnc><<<b, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(words), w_count, n, hdr_bits,
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(outlier),
      stage_words, stage_out, static_cast<uint32_t*>(vals),
      static_cast<int32_t*>(end_pos));
  return cudaGetLastError();
}

int dispatch(const void* words, int b, int w_count, int n, int hdr_bits,
             int enc, const void* g, const void* outlier, void* vals,
             void* end_pos, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (enc) {
    case 0:
      return launch<0>(words, b, w_count, n, hdr_bits, g, outlier, vals,
                       end_pos, s);
    case 1:
      return launch<1>(words, b, w_count, n, hdr_bits, g, outlier, vals,
                       end_pos, s);
    case 2:
      return launch<2>(words, b, w_count, n, hdr_bits, g, outlier, vals,
                       end_pos, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Window mode: kK warps a window (see the top of the file).

// The kK warps of one window: a named barrier of their own (id 1 + the
// window's slot in the CTA), and an OR over their threads.
template <int kK>
struct WindowGroup {
  int id;

  __device__ __forceinline__ void sync() const {
    if constexpr (kK == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(32 * kK) : "memory");
  }
  __device__ __forceinline__ bool any(bool p) const {
    if constexpr (kK == 1) {
      return __any_sync(0xFFFFFFFFu, p);
    } else {
      int r;
      asm volatile(
          "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
          " bar.red.or.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}"
          : "=r"(r)
          : "r"(static_cast<int>(p)), "r"(id), "n"(32 * kK)
          : "memory");
      return r != 0;
    }
  }
};

// Exchanged between the warps of a window (slot: the CTA's warp): the
// last lane's exit each round (two buffers, by round parity), each warp's
// code count, and the exit of the window's last segment.
struct WindowShared {
  int exits[2][kWinWarps];
  int counts[kWinWarps];
  int tail[kWinWarps];
};

// One window, decoded by the kK calling warps (sub: this warp's index
// among them, t = 32 sub + lane its segment).  `words` reads the stream
// from the window's base word; words at or past `lim` are zero; decoding
// starts at bit hdr_q = hdr_bits + start % 32 of those words.  kept / lens:
// the window's room of kept codes (room a segment, segment-minor); out16:
// its staged (1, n) row of 16-bit values, or null to write straight to
// out_row.
template <int kEnc, bool kPow2, int kK, class S>
__device__ __forceinline__ void decode_window(
    S words, int lim, int r, int n, int hdr_bits, const Terms& tm, int room,
    uint16_t* __restrict__ kept, uint8_t* __restrict__ lens,
    uint16_t* __restrict__ out16, uint32_t* __restrict__ out_row, bool vec,
    int32_t* __restrict__ end_out, WindowShared& xs) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int kSegs = 32 * kK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp % kK;
  const int t = 32 * sub + lane;
  const WindowGroup<kK> group{1 + warp / kK};

  // the last nonzero word (each warp finds it): past it every window is 0
  int last = -1;
  for (int k0 = (lim - 1) & ~31; k0 >= 0; k0 -= 32) {
    const int k = k0 + lane;
    const unsigned m = __ballot_sync(kAll, k < lim && words(k) != 0u);
    if (m) {
      last = k0 + 31 - __clz(m);
      break;
    }
  }
  WordCursor<S> cur;
  cur.src = words;
  cur.limit = last + 1;

  // speculate: segments of at least 64 bits, one a thread, each keeping
  // the values and lengths of its first codes
  const int hdr_q = hdr_bits + r;
  const int end_bits = max(hdr_q, 32 * (last + 1));
  const int bits = end_bits - hdr_q;
  const int seg = max(kMinSegmentBits, (bits + kSegs - 1) / kSegs);
  const int n_seg = (bits + seg - 1) / seg;
  const bool active = t < n_seg;
  const int seg_start = hdr_q + t * seg;
  const int seg_end = min(seg_start + seg, end_bits);
  uint16_t* kv = kept + t;
  uint8_t* kl = lens + t;
  int kept_n = 0;  // the walk's codes 0 .. kept_n - 1 are kept
  Spec spec{0ull, seg_start, 0};
  if (active)
    spec = speculate<kEnc, kPow2>(cur, seg_start, seg_end, tm,
                                  [&](int i, const Code& c) {
                                    if (i == kept_n && i < room && !c.bad) {
                                      kv[kSegs * i] =
                                          static_cast<uint16_t>(c.mapped);
                                      kl[kSegs * i] =
                                          static_cast<uint8_t>(c.consumed);
                                      ++kept_n;
                                    }
                                  });

  // synchronise: entries from the segment before (by shuffle, and through
  // shared memory across warps), until none changes; a segment's codes
  // are then `fresh` codes decoded from its entry followed by its
  // speculative walk's codes from code k0 (at bit p0)
  int entry = seg_start, seg_exit = spec.exit, count = spec.count;
  int fresh = 0, k0 = 0, p0 = seg_start;
  for (int pass = 0;; ++pass) {
    int e = __shfl_up_sync(kAll, seg_exit, 1);
    if constexpr (kK > 1) {
      if (lane == 31) xs.exits[pass & 1][warp] = seg_exit;
      group.sync();
      if (lane == 0 && sub) e = xs.exits[pass & 1][warp - 1];
    }
    if (t == 0) e = hdr_q;
    const bool redo = active && e != entry;
    if (redo) {
      entry = e;
      fresh = -1;
      walk<kEnc, kPow2>(cur, entry, seg_start, seg_end, spec, tm, &seg_exit,
                        &count, [&](int c, int k, int pos) {
                          fresh = c;
                          k0 = k;
                          p0 = pos;
                        });
      if (fresh < 0) fresh = count;  // never joined: every code is fresh
    }
    if (!group.any(redo)) break;
  }

  // place: a scan of the counts, by warp, then across the warps
  const int mine = active ? count : 0;
  int first = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, first, o);
    if (lane >= o) first += y;
  }
  int total = __shfl_sync(kAll, first, 31);
  first -= mine;
  int tail_from = hdr_q;  // where segment n_seg - 1 exits
  if constexpr (kK == 1) {
    if (n_seg) tail_from = __shfl_sync(kAll, seg_exit, n_seg - 1);
  } else {
    if (lane == 31) xs.counts[warp] = total;
    if (t == n_seg - 1) xs.tail[warp - sub] = seg_exit;
    group.sync();
    total = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = xs.counts[warp - sub + k];
      if (k < sub) first += c;
      total += c;
    }
    if (n_seg) tail_from = xs.tail[warp - sub];
  }

  // write the codes below n
  bool bad = false, big = false;
  int end = -1;  // set by the one thread that knows the end position
  auto write = [&](auto store) {
    if (!active || first >= n) return;
    const int stop = min(count, n - first);
    int pos = entry, j = 0;
    const int decoded = min(fresh, stop);
    for (; j < decoded; ++j) {
      const Code c = decode_code<kEnc, kPow2>(cur.window(pos), tm);
      store(first + j, c.mapped);
      bad |= c.bad;
      pos += c.consumed;
    }
    if (j < stop) {
      // the kept values from code k0 on: copies with no chain between
      // them; their lengths are summed only where a position is needed
      const int m = min(stop - j, max(0, kept_n - k0));
      const uint16_t* kvk = kv + kSegs * k0;
#pragma unroll 4
      for (int u = 0; u < m; ++u) store(first + j + u, kvk[kSegs * u]);
      j += m;
      if (j < stop || first + stop == n) {
        pos = p0;
        const uint8_t* klk = kl + kSegs * k0;
#pragma unroll 4
        for (int u = 0; u < m; ++u) pos += klk[kSegs * u];
      }
      for (; j < stop; ++j) {  // past the room: decoded again
        const Code c = decode_code<kEnc, kPow2>(cur.window(pos), tm);
        store(first + j, c.mapped);
        bad |= c.bad;
        pos += c.consumed;
      }
    }
    if (first + stop == n) end = pos;
  };
  auto direct = [&](int i, uint32_t v) { out_row[i] = v; };
  auto staged = [&](int i, uint32_t v) {
    out16[i] = static_cast<uint16_t>(v);
    big |= v > 0xFFFFu;
  };
  if (out16)
    write(staged);
  else
    write(direct);
  if (total < n) {
    // the chain left the window's nonzero words: zero windows, whose value
    // is 0 for every encoder (so never over 16 bits)
    const Code z = decode_code<kEnc>(Window{0u, 0u}, tm);
    for (int i = total + t; i < n; i += kSegs) {
      if (out16)
        out16[i] = static_cast<uint16_t>(z.mapped);
      else
        out_row[i] = z.mapped;
    }
    if (t == 0) {
      bad |= z.bad;
      end = tail_from + (n - total) * z.consumed;
    }
  }
  if (t == 0 && n == 0) end = hdr_q;
  const bool any_bad = group.any(bad);
  if (end >= 0) *end_out = end - r + (any_bad ? kPoisonBits : 0);
  if (!out16) return;

  // copy the staged row out; threads that staged a value over 16 bits then
  // write their codes again, whole
  group.sync();  // the staged row complete
  if (vec) {
    for (int i = 4 * t; i < n; i += 4 * kSegs) {
      const uint2 h = *reinterpret_cast<const uint2*>(out16 + i);
      *reinterpret_cast<uint4*>(out_row + i) =
          make_uint4(h.x & 0xFFFFu, h.x >> 16, h.y & 0xFFFFu, h.y >> 16);
    }
  } else {
    for (int i = t; i < n; i += kSegs) out_row[i] = out16[i];
  }
  if (group.any(big)) {
    group.sync();  // after the copy
    if (big) write(direct);
  }
}

// Window b = blockIdx.x * (kWinWarps / kK) + warp / kK.  span_room: words
// of the span staging (0: none); room: kept codes a segment; stage_out:
// the rows are staged (n_pad 16-bit values a window).
template <int kEnc, int kK>
__global__ void __launch_bounds__(kWinWarps * 32)
    decode_windows_kernel(const uint32_t* __restrict__ words,
                          int stream_words, const int32_t* __restrict__ starts,
                          int b_count, int w_count, int n, int hdr_bits,
                          const uint32_t* __restrict__ g_arr,
                          const uint32_t* __restrict__ o_arr, int span_room,
                          int room, int stage_out, int n_pad,
                          uint32_t* __restrict__ vals,
                          int32_t* __restrict__ end_pos) {
  constexpr int kWin = kWinWarps / kK;  // windows a CTA
  extern __shared__ uint4 smem_vec[];
  uint32_t* span = reinterpret_cast<uint32_t*>(smem_vec);
  uint16_t* kept = reinterpret_cast<uint16_t*>(span + span_room);
  uint16_t* outs = kept + kWinWarps * 32 * room;
  uint8_t* lens =
      reinterpret_cast<uint8_t*>(outs + (stage_out ? kWin * n_pad : 0));
  __shared__ int span_lo[kWin], span_hi[kWin];
  __shared__ WindowShared xs;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = warp / kK;
  const int b = blockIdx.x * kWin + w;

  // the window: its base word, bit offset and words in the stream
  int base = 0, r = 0, lim = 0;
  uint32_t g = 0, outlier = 0;
  if (b < b_count) {
    g = g_arr[b];
    outlier = o_arr[b];
    const int start = starts[b];
    if (start >= 0) {  // a start below 0 reads zeros
      base = start >> 5;
      r = start & 31;
      lim = max(0, min(w_count, stream_words - base));
    }
  }

  // stage the CTA's span [lo, hi) of the stream once, if it fits
  bool in_span = false;
  int lo_al = 0;
  if (span_room) {
    if (lane == 0 && warp % kK == 0) {
      span_lo[w] = lim ? base : INT_MAX;
      span_hi[w] = lim ? base + lim : 0;
    }
    __syncthreads();
    int lo = INT_MAX, hi = 0;
#pragma unroll
    for (int v = 0; v < kWin; ++v) {
      lo = min(lo, span_lo[v]);
      hi = max(hi, span_hi[v]);
    }
    const bool vec = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
    lo_al = vec ? lo & ~3 : lo;
    if (hi > 0 && hi - lo_al <= span_room) {
      in_span = true;
      for (int c = lo_al + 4 * static_cast<int>(threadIdx.x); c < hi;
           c += 4 * kWinWarps * 32) {
        if (vec && c + 4 <= stream_words) {
          __pipeline_memcpy_async(span + (c - lo_al), words + c, 16);
        } else {
          for (int e = c; e < min(c + 4, hi); ++e)
            __pipeline_memcpy_async(span + (e - lo_al), words + e, 4);
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();
  }
  if (b >= b_count) return;

  Terms tm;
  tm.g = g;
  tm.glog2 = g ? 31 - __clz(g) : 0;
  tm.cutoff = (2u << tm.glog2) - g;
  tm.outlier = outlier;
  uint16_t* kept_w = kept + w * 32 * kK * room;
  uint8_t* lens_w = lens + w * 32 * kK * room;
  uint16_t* out16 = stage_out ? outs + w * n_pad : nullptr;
  uint32_t* out_row = vals + static_cast<size_t>(b) * n;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  // g a power of two (the usual parameters): no long-form remainders; the
  // rare windows read from device memory take the general decode only
  const bool pow2 = kEnc != 0 && (g & (g - 1)) == 0;
  if (in_span && pow2)
    decode_window<kEnc, kEnc != 0, kK>(
        SharedWords{span + (base - lo_al)}, lim, r, n, hdr_bits, tm, room,
        kept_w, lens_w, out16, out_row, vec, end_pos + b, xs);
  else if (in_span)
    decode_window<kEnc, false, kK>(
        SharedWords{span + (base - lo_al)}, lim, r, n, hdr_bits, tm, room,
        kept_w, lens_w, out16, out_row, vec, end_pos + b, xs);
  else
    decode_window<kEnc, false, kK>(GlobalWords{words + base}, lim, r, n,
                                   hdr_bits, tm, room, kept_w, lens_w, out16,
                                   out_row, vec, end_pos + b, xs);
}

// A window launch: warps a window (kK, 2 or 4 where the launch has too few
// windows to give each SM 32 warps and the windows have the bits for more
// than 32 segments), and its shared memory: the span, the kept codes (3
// bytes a code), the staged rows; whatever does not fit is left out, the
// span first.
struct WindowSmem {
  int warps, span_room, room, stage_out, n_pad;
  size_t bytes;
};

WindowSmem window_smem(int b, int sms, int w_count, int n, int hdr_bits,
                       size_t avail) {
  WindowSmem m;
  const int64_t bits = std::max<int64_t>(0, 32 * int64_t{w_count} - hdr_bits);
  m.warps = 1;
  while (m.warps < 4 && int64_t{b} * m.warps * 2 <= int64_t{sms} * 32 &&
         int64_t{32} * m.warps * kMinSegmentBits < bits)
    m.warps *= 2;
  const int windows = kWinWarps / m.warps;  // a CTA
  // codes a segment: the window's codes over its segments (the window's
  // bits over 64, at most 32 a warp), a quarter more for the spread
  const int64_t segs = std::max<int64_t>(
      1, std::min<int64_t>(32 * m.warps, bits / kMinSegmentBits));
  const int64_t per_seg = (n + segs - 1) / segs;
  int64_t room = per_seg + per_seg / 4 + 4;
  m.n_pad = (n + 7) & ~7;
  int64_t span = ((int64_t{windows} * w_count + 8 + 3) & ~int64_t{3}) * 4;
  int64_t out = int64_t{windows} * m.n_pad * 2;
  const int64_t per_code = kWinWarps * 32 * 3;
  const int64_t cap = static_cast<int64_t>(avail);
  if (span + out + per_code * room > cap) span = 0;
  if (out + per_code * room > cap) out = 0;
  room = std::min(room, (cap - span - out) / per_code);
  m.span_room = static_cast<int>(span / 4);
  m.room = static_cast<int>(room);
  m.stage_out = out ? 1 : 0;
  m.bytes = static_cast<size_t>(span + out + per_code * room);
  return m;
}

// The plan of a window launch of b windows on the current device.
int window_plan(int b, int w_count, int n, int hdr_bits, WindowSmem* m) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the most static shared memory of the instances (kK = 1: 8 windows)
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, decode_windows_kernel<1, 1>);
  if (err != cudaSuccess) return err;
  *m = window_smem(b, sms, w_count, n, hdr_bits,
                   static_cast<size_t>(optin) - attr.sharedSizeBytes);
  return cudaSuccess;
}

template <int kEnc, int kK>
int launch_windows(const WindowSmem& m, const void* words, int stream_words,
                   const void* starts, int b, int w_count, int n, int hdr_bits,
                   const void* g, const void* outlier, void* vals,
                   void* end_pos, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_windows_kernel<kEnc, kK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(m.bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(decode_windows_kernel<kEnc, kK>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int kWin = kWinWarps / kK;
  decode_windows_kernel<kEnc, kK>
      <<<(b + kWin - 1) / kWin, kWinWarps * 32, m.bytes, stream>>>(
          static_cast<const uint32_t*>(words), stream_words,
          static_cast<const int32_t*>(starts), b, w_count, n, hdr_bits,
          static_cast<const uint32_t*>(g),
          static_cast<const uint32_t*>(outlier), m.span_room, m.room,
          m.stage_out, m.n_pad, static_cast<uint32_t*>(vals),
          static_cast<int32_t*>(end_pos));
  return cudaGetLastError();
}

template <int kEnc>
int launch_windows(const void* words, int stream_words, const void* starts,
                   int b, int w_count, int n, int hdr_bits, const void* g,
                   const void* outlier, void* vals, void* end_pos,
                   cudaStream_t stream) {
  WindowSmem m;
  const int err = window_plan(b, w_count, n, hdr_bits, &m);
  if (err != cudaSuccess) return err;
  switch (m.warps) {
    case 1:
      return launch_windows<kEnc, 1>(m, words, stream_words, starts, b,
                                     w_count, n, hdr_bits, g, outlier, vals,
                                     end_pos, stream);
    case 2:
      return launch_windows<kEnc, 2>(m, words, stream_words, starts, b,
                                     w_count, n, hdr_bits, g, outlier, vals,
                                     end_pos, stream);
    default:
      return launch_windows<kEnc, 4>(m, words, stream_words, starts, b,
                                     w_count, n, hdr_bits, g, outlier, vals,
                                     end_pos, stream);
  }
}

int dispatch_windows(const void* words, int stream_words, const void* starts,
                     int b, int w_count, int n, int hdr_bits, int enc,
                     const void* g, const void* outlier, void* vals,
                     void* end_pos, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (enc) {
    case 0:
      return launch_windows<0>(words, stream_words, starts, b, w_count, n,
                               hdr_bits, g, outlier, vals, end_pos, s);
    case 1:
      return launch_windows<1>(words, stream_words, starts, b, w_count, n,
                               hdr_bits, g, outlier, vals, end_pos, s);
    case 2:
      return launch_windows<2>(words, stream_words, starts, b, w_count, n,
                               hdr_bits, g, outlier, vals, end_pos, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int airs_decode_blocks(const void* words, int b, int w_count, int n,
                                  int hdr_bits, int enc, const void* g,
                                  const void* outlier, void* vals,
                                  void* end_pos, void* stream) {
  return dispatch(words, b, w_count, n, hdr_bits, enc, g, outlier, vals,
                  end_pos, stream);
}

// Window mode: row i is the w_count-word window at bit starts[i] (int32) of
// the stream words[0, stream_words).
extern "C" int airs_decode_windows(const void* words, int stream_words,
                                   const void* starts, int b, int w_count,
                                   int n, int hdr_bits, int enc, const void* g,
                                   const void* outlier, void* vals,
                                   void* end_pos, void* stream) {
  return dispatch_windows(words, stream_words, starts, b, w_count, n,
                          hdr_bits, enc, g, outlier, vals, end_pos, stream);
}
