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
// Window mode (entry airs_decode_windows): the rows are not stored.  Row b
// is the window of w_count words of ONE word stream that starts at bit
// starts[b]: window word i is stream words start / 32 + i and + i + 1
// funnel-shifted by start % 32, the next word read as zero for the last
// window word and every word past the stream's end read as zero.  This is
// the sidecar decode of one long block (parallel/sp.py), the counterpart of
// airs_compression_tpu/parallel/sp.py:486-519, which built the window
// matrix by a row gather and a 7-level barrel shift before the TPU kernel;
// here each CTA builds its window while it stages it (step 1), and the rest
// of the kernel is unchanged.  A window holds the next chunk's bits past
// its own end, as the JAX windows do; the caller's check of the end
// positions rejects a sidecar that lies.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // segments per block row
constexpr int kMinSegmentBits = 64;
constexpr int kPoisonBits = 1 << 29;

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

// ops/decode.py::_decode_one for the window at a code's first bit.
template <int kEnc>
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
  const int long_form = r0 >= tm.cutoff ? 1 : 0;
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

// A row's words: p[i] (shared or device memory), or in window mode (kAt)
// the window word i of a stream whose words from p on number `avail`, for
// a window of `width` words shifted left by r bits (a staged window: p in
// shared memory, avail = width, r = 0).
template <bool kAt>
struct Src {
  const uint32_t* p;
  int avail, width, r;

  __device__ __forceinline__ uint32_t operator()(int i) const {
    if constexpr (kAt) {
      const uint32_t a = i < avail ? p[i] : 0u;
      const uint32_t c = i + 1 < width && i + 1 < avail ? p[i + 1] : 0u;
      return __funnelshift_l(c, a, r);  // (a << r) | (c >> (32 - r))
    } else {
      return p[i];
    }
  }
};

// A register window over a row; words at or past `limit` read as zeros.
template <bool kAt>
struct Cursor {
  Src<kAt> src;
  int limit;
  int base;
  uint32_t w0, w1, w2;

  __device__ __forceinline__ uint32_t load(int i) const {
    return i < limit ? src(i) : 0u;
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

// A segment's speculative walk: its exit, its code count, and which of the
// segment's first 64 bits start one of its codes.
struct Spec {
  uint64_t starts;
  int exit, count;
};

// Decode from the segment's first bit while the code start is before
// seg_end.
template <int kEnc, class Cur>
__device__ __forceinline__ Spec speculate(Cur& cur, int seg_start,
                                          int seg_end, const Terms& tm) {
  Spec s{0ull, seg_start, 0};
  cur.seek(seg_start);
  for (; s.exit < seg_end && s.exit - seg_start < 64; ++s.count) {
    s.starts |= 1ull << (s.exit - seg_start);
    s.exit += decode_code<kEnc>(cur.window(s.exit), tm).consumed;
  }
  for (; s.exit < seg_end; ++s.count)
    s.exit += decode_code<kEnc>(cur.window(s.exit), tm).consumed;
  return s;
}

// Decode from entry pos (at or past seg_start) while the code start is
// before seg_end: the exit (first code start at or past seg_end) and the
// code count.  A chain that reaches a code start of the speculative walk
// follows that walk from there on, so the walk stops at the first one.
template <int kEnc, class Cur>
__device__ __forceinline__ void walk(Cur& cur, int pos, int seg_start,
                                     int seg_end, const Spec& spec,
                                     const Terms& tm, int* seg_exit,
                                     int* count) {
  cur.seek(pos);
  int c = 0;
  for (; pos < seg_end && pos - seg_start < 64; ++c) {
    const int off = pos - seg_start;
    if ((spec.starts >> off) & 1ull) {
      *seg_exit = spec.exit;
      *count = c + spec.count - __popcll(spec.starts & ((1ull << off) - 1));
      return;
    }
    pos += decode_code<kEnc>(cur.window(pos), tm).consumed;
  }
  for (; pos < seg_end; ++c)
    pos += decode_code<kEnc>(cur.window(pos), tm).consumed;
  *seg_exit = pos;
  *count = c;
}

// kAt: window mode (starts, stream_words; see the top of the file).
template <int kEnc, bool kAt>
__global__ void __launch_bounds__(kThreads)
    decode_blocks_kernel(const uint32_t* __restrict__ words, int w_count,
                         int n, int hdr_bits, const uint32_t* __restrict__ g_arr,
                         const uint32_t* __restrict__ o_arr, int stage_words,
                         int stage_out, uint32_t* __restrict__ vals,
                         int32_t* __restrict__ end_pos,
                         int32_t* __restrict__ rounds_out,
                         const int32_t* __restrict__ starts,
                         int stream_words) {
  extern __shared__ uint4 smem_vec[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_vec);
  __shared__ int exits[kThreads];
  __shared__ int last_nonzero;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  Src<kAt> row;
  row.width = w_count;
  if constexpr (kAt) {  // the window at starts[b]; a start below 0 reads 0s
    const int start = starts[b];
    const int base = start >= 0 ? start >> 5 : 0;
    row.p = words + base;
    row.avail = start >= 0 ? stream_words - base : 0;
    row.r = start & 31;
  } else {
    row.p = words + static_cast<size_t>(b) * w_count;
    row.avail = w_count;
    row.r = 0;
  }
  uint32_t* out_row = vals + static_cast<size_t>(b) * n;
  uint32_t* out = stage_out ? smem + (stage_words ? w_count : 0) : out_row;

  // 1. stage the row, find its last nonzero word
  if (t == 0) last_nonzero = -1;
  int last = -1;
  const bool vec = !kAt && (w_count & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  const int v_count = vec ? w_count >> 2 : 0;
  for (int i = t; i < v_count; i += kThreads) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row.p) + i);
    if (stage_words) smem_vec[i] = w;
    if (w.x | w.y | w.z | w.w)
      last = 4 * i + (w.w ? 3 : w.z ? 2 : w.y ? 1 : 0);
  }
  for (int i = 4 * v_count + t; i < w_count; i += kThreads) {
    const uint32_t w = kAt ? row(i) : __ldg(row.p + i);
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
  Cursor<kAt> cur;
  cur.src = row;
  if (stage_words) {  // the staged row (or window) in shared memory
    cur.src.p = smem;
    cur.src.avail = w_count;
    cur.src.r = 0;
  }
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
  int rounds = 0;
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
    ++rounds;
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
  if (rounds_out && t == 0) rounds_out[b] = rounds;
  if (stage_out)
    for (int i = t; i < n; i += kThreads) out_row[i] = out[i];
}

template <int kEnc, bool kAt>
int launch(const void* words, int b, int w_count, int n, int hdr_bits,
           const void* g, const void* outlier, void* vals, void* end_pos,
           void* rounds, const void* starts, int stream_words,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, decode_blocks_kernel<kEnc, kAt>);
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
  err = cudaFuncSetAttribute(decode_blocks_kernel<kEnc, kAt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_blocks_kernel<kEnc, kAt><<<b, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(words), w_count, n, hdr_bits,
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(outlier),
      stage_words, stage_out, static_cast<uint32_t*>(vals),
      static_cast<int32_t*>(end_pos), static_cast<int32_t*>(rounds),
      static_cast<const int32_t*>(starts), stream_words);
  return cudaGetLastError();
}

template <bool kAt>
int dispatch(const void* words, int b, int w_count, int n, int hdr_bits,
             int enc, const void* g, const void* outlier, void* vals,
             void* end_pos, void* rounds, const void* starts,
             int stream_words, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (enc) {
    case 0:
      return launch<0, kAt>(words, b, w_count, n, hdr_bits, g, outlier, vals,
                            end_pos, rounds, starts, stream_words, s);
    case 1:
      return launch<1, kAt>(words, b, w_count, n, hdr_bits, g, outlier, vals,
                            end_pos, rounds, starts, stream_words, s);
    case 2:
      return launch<2, kAt>(words, b, w_count, n, hdr_bits, g, outlier, vals,
                            end_pos, rounds, starts, stream_words, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// rounds: null, or (B,) int32 that receives each block's synchronise rounds
// (passes in which some segment was decoded again).
extern "C" int airs_decode_blocks(const void* words, int b, int w_count, int n,
                                  int hdr_bits, int enc, const void* g,
                                  const void* outlier, void* vals,
                                  void* end_pos, void* rounds, void* stream) {
  return dispatch<false>(words, b, w_count, n, hdr_bits, enc, g, outlier, vals,
                         end_pos, rounds, nullptr, 0, stream);
}

// Window mode: row i is the w_count-word window at bit starts[i] (int32) of
// the stream words[0, stream_words).
extern "C" int airs_decode_windows(const void* words, int stream_words,
                                   const void* starts, int b, int w_count,
                                   int n, int hdr_bits, int enc, const void* g,
                                   const void* outlier, void* vals,
                                   void* end_pos, void* rounds, void* stream) {
  return dispatch<true>(words, b, w_count, n, hdr_bits, enc, g, outlier, vals,
                        end_pos, rounds, starts, stream_words, stream);
}
