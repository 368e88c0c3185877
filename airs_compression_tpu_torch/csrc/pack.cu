// K1 and K2: bit pack of a batch of blocks, one CTA per block.
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
// per block, and bits (B,) int32.  C is the capacity for the worst-case
// code length, computed by the wrapper.
//
// What bounds it on the H100: bytes.  Each block reads its inputs once
// (K2 reads the lengths twice, the second time from L1/L2) and writes its
// C payload words once; per code the work is a few dozen integer
// operations.  The TPU kernels merged codes pairwise in a doubling tree
// held in VMEM, with a column-major layout and a barrel shifter, because
// Mosaic has no scatter.  Here one CTA owns one block: each thread takes a
// contiguous run of codes, a CTA-wide exclusive scan of the runs' bit
// counts gives every code its bit offset, and each code is OR'd into the
// <= 3 words it touches with shared-memory atomics (codes occupy disjoint
// bits, so the order of the ORs does not matter).  The payload is built in
// shared memory and written to device memory once, coalesced.  Where the
// worst-case payload does not fit in the shared memory a block may hold
// (N above about 38K codes of 48 bits), the same ORs go straight to the
// block's row in device memory, zeroed first by the CTA.  The two kernels
// are one template over where the codes come from.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Code {
  uint32_t hi, lo;
  int len;
};

__device__ __forceinline__ uint32_t ilog2u(uint32_t x) {
  return x ? 31u - __clz(x) : 0u;
}

// golomb.golomb_codeword: value v < golomb_upper_bound -> (cw, len <= 32).
__device__ __forceinline__ void golomb_codeword(uint32_t v, uint32_t g,
                                                uint32_t glog2, uint32_t* cw,
                                                int* len) {
  const uint32_t cutoff = (2u << glog2) - g;
  const int len0 = static_cast<int>(glog2) + 1;
  if (v < cutoff) {
    *cw = v;
    *len = len0;
    return;
  }
  const uint32_t vg = v - cutoff;
  const uint32_t group = vg / g;
  const uint32_t rem = vg - group * g;
  const uint32_t unary = group >= 32u ? 0xFFFFFFFFu : (1u << group) - 1u;
  *cw = (unary << (len0 + 1)) + (cutoff << 1) + rem;
  *len = len0 + 1 + static_cast<int>(group);
}

// golomb.encode_codewords for one residual.
__device__ __forceinline__ Code encode(int32_t r, int enc, uint32_t g,
                                       uint32_t glog2, uint32_t outlier) {
  Code c;
  if (enc == 0) {  // UNCOMPRESSED: raw 16 bits
    c.hi = 0u;
    c.lo = static_cast<uint32_t>(r) & 0xFFFFu;
    c.len = 16;
    return c;
  }
  const uint32_t m =
      ((static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 15)) &
      0xFFFFu;
  const bool esc = m >= outlier;
  uint32_t cw;
  int len;
  if (enc == 1) {  // GOLOMB_ZERO: escape = Golomb(0) + 16 raw bits
    golomb_codeword(esc ? 0u : m + 1u, g, glog2, &cw, &len);
    c.hi = 0u;
    c.lo = esc ? m : cw;
    c.len = esc ? static_cast<int>(glog2) + 17 : len;
    return c;
  }
  // GOLOMB_MULTI: escape = Golomb(outlier + level) + (level + 1) * 2 raw bits
  const uint32_t diff = esc ? m - outlier : 0u;
  const uint32_t level = diff < 4u ? 0u : ilog2u(diff) >> 1;
  golomb_codeword(esc ? outlier + level : m, g, glog2, &cw, &len);
  const uint32_t raw = (level + 1u) * 2u;
  c.hi = esc ? cw >> (32u - raw) : 0u;
  c.lo = esc ? (cw << raw) | diff : cw;
  c.len = esc ? len + static_cast<int>(raw) : len;
  return c;
}

// OR a code of len in [0, 64] bits into the stream at bit offset pos;
// pieces past the C-word payload (lengths over the caller's maximum) are
// dropped.
__device__ __forceinline__ void or_code(uint32_t* buf, int c_words, int pos,
                                        Code c) {
  // code << 64 would be undefined; pos < 0 only from negative lengths
  if (c.len <= 0 || pos < 0) return;
  const uint64_t code = (static_cast<uint64_t>(c.hi) << 32) | c.lo;
  const uint64_t lj = code << (64 - c.len);  // left-justified in 64 bits
  const int w = pos >> 5;
  const int s = pos & 31;
  const uint32_t p0 = static_cast<uint32_t>(lj >> (32 + s));
  const uint32_t p1 = static_cast<uint32_t>(lj >> s);
  const uint32_t p2 = s ? static_cast<uint32_t>(lj << (32 - s)) : 0u;
  if (p0 && w < c_words) atomicOr(buf + w, p0);
  if (p1 && w + 1 < c_words) atomicOr(buf + w + 1, p1);
  if (p2 && w + 2 < c_words) atomicOr(buf + w + 2, p2);
}

// K1's code source: Golomb codes of one block's residuals.
struct ResidualCodes {
  const int32_t* res;
  int enc;
  uint32_t g, glog2, outlier;
  __device__ Code operator()(size_t i) const {
    return encode(res[i], enc, g, glog2, outlier);
  }
  __device__ int len(size_t i) const { return (*this)(i).len; }
};

// K2's code source: codes loaded from hi (null: all zero), lo and lens.
struct LoadedCodes {
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* lens;
  __device__ Code operator()(size_t i) const {
    Code c;
    c.hi = hi ? hi[i] : 0u;
    c.lo = lo[i];
    c.len = lens[i];
    return c;
  }
  __device__ int len(size_t i) const { return lens[i]; }
};

template <class Codes>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(Codes codes, int n, int c_words, int use_smem,
                uint32_t* __restrict__ payload, int32_t* __restrict__ bits) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * n;
  uint32_t* out = payload + static_cast<size_t>(b) * c_words;
  uint32_t* buf = use_smem ? smem : out;
  for (int i = threadIdx.x; i < c_words; i += kThreads) buf[i] = 0u;

  const int per = (n + kThreads - 1) / kThreads;
  const int begin = min(n, static_cast<int>(threadIdx.x) * per);
  const int end = min(n, begin + per);
  int run_bits = 0;
  for (int i = begin; i < end; ++i) run_bits += codes.len(row + i);

  int total;
  // the scan's barriers also order the zeroing above before the ORs below
  int pos = block_exclusive_scan<kThreads>(run_bits, &total);
  for (int i = begin; i < end; ++i) {
    const Code c = codes(row + i);
    or_code(buf, c_words, pos, c);
    pos += c.len;
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < c_words; i += kThreads) out[i] = smem[i];
  }
  if (threadIdx.x == 0) bits[b] = total;
}

// Launch pack_kernel<Codes> over b blocks with the payload in shared memory
// where it fits.
template <class Codes>
int launch_pack(Codes codes, int b, int n, int c_words, void* payload,
                void* bits, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(c_words) * sizeof(uint32_t);
  // leave room for the scan's static shared memory
  const int use_smem = smem + 256 <= static_cast<size_t>(smem_optin);
  if (use_smem) {
    err = cudaFuncSetAttribute(pack_kernel<Codes>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pack_kernel<Codes><<<b, kThreads, use_smem ? smem : 0,
                       static_cast<cudaStream_t>(stream)>>>(
      codes, n, c_words, use_smem, static_cast<uint32_t*>(payload),
      static_cast<int32_t*>(bits));
  return cudaGetLastError();
}

}  // namespace

extern "C" int airs_pack_residuals(const void* res, int b, int n, int c_words,
                                   int enc, unsigned g, unsigned outlier,
                                   void* payload, void* bits, void* stream) {
  const ResidualCodes codes{static_cast<const int32_t*>(res), enc, g,
                            g ? 31u - static_cast<unsigned>(__builtin_clz(g))
                              : 0u,
                            outlier};
  return launch_pack(codes, b, n, c_words, payload, bits, stream);
}

extern "C" int airs_pack_codes(const void* hi, const void* lo,
                               const void* lens, int b, int k, int c_words,
                               void* payload, void* bits, void* stream) {
  const LoadedCodes codes{static_cast<const uint32_t*>(hi),
                          static_cast<const uint32_t*>(lo),
                          static_cast<const int32_t*>(lens)};
  return launch_pack(codes, b, k, c_words, payload, bits, stream);
}
