// K4: XXH32 of each block's samples as big-endian u16 bytes, one warp per
// block.
//
// Replaces airs_compression_tpu/ops/xxh32_device.py::_xxh_kernel (entry
// xxh32_blocks_pallas, reached through checksum_blocks_device); the plain
// PyTorch version is ops/xxh32_device.py::xxh32_blocks.
//
// Input: samples (B, N) int32 (low 16 bits hashed, two BE bytes each).
// Output: (B,) u32 digests, seed 419764627, any N >= 1.
//
// What bounds it on the H100: the chain, then bytes.  XXH32's round
// acc = rotl13(acc + w * P2) * P1 is not associative, so a block has four
// independent chains (one per accumulator lane) of N / 8 rounds each and
// nothing finer.  One warp hashes one block, so B = 512 gives 512 warps on
// the 132 SMs.  The warp streams its row in 4 KB chunks, 16 bytes per
// thread per load (coalesced); every thread turns its samples into lane
// words and stores them to shared memory, and four threads run the four
// lanes' rounds on the chunk (reading 16 words ahead, so no load sits on
// the round chain) while the next chunk's loads are already in flight in
// the warp's registers.  The lanes combine by warp shuffles, and one
// thread runs the tail (4-byte words, then the odd last sample's two bytes)
// and the finalize.  The TPU kernel relaid the stripes into (8, 128) lane
// tiles and carried the accumulators in VMEM scratch across grid steps;
// here they stay in registers.
#include "common.cuh"

namespace {

constexpr int kWarps = 2;  // blocks per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 8;                  // 16-byte loads per thread per chunk
constexpr int kChunk = 32 * 4 * kLoads;    // samples per warp chunk (4 KB)
constexpr int kChunkStripes = kChunk / 8;  // 16-byte stripes per chunk
constexpr int kAhead = 16;                 // lane words read before their rounds
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// BE bytes of one sample, in the order XXH32 reads them little-endian
__device__ __forceinline__ uint32_t bswap16(int32_t s) {
  const uint32_t u = static_cast<uint32_t>(s) & 0xFFFFu;
  return ((u & 0xFFu) << 8) | (u >> 8);
}

__device__ __forceinline__ uint32_t lane_word(int32_t a, int32_t b) {
  return bswap16(a) | (bswap16(b) << 16);
}

__device__ __forceinline__ uint32_t xxh_round(uint32_t acc, uint32_t w) {
  return rotl(acc + w * kP2, 13) * kP1;
}

// The thread's samples of chunk c, 4 per load (samples past `body` read as
// zeros); load k of every thread covers 512 contiguous bytes.
__device__ __forceinline__ void load_chunk(const int32_t* row, int c, int body,
                                           bool vec, int lane,
                                           int4 (&r)[kLoads]) {
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = c * kChunk + (k * 32 + lane) * 4;
    if (vec && i + 4 <= body) {
      r[k] = __ldg(reinterpret_cast<const int4*>(row + i));
    } else {
      r[k].x = i < body ? __ldg(row + i) : 0;
      r[k].y = i + 1 < body ? __ldg(row + i + 1) : 0;
      r[k].z = i + 2 < body ? __ldg(row + i + 2) : 0;
      r[k].w = i + 3 < body ? __ldg(row + i + 3) : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    xxh32_blocks_kernel(const int32_t* __restrict__ x, int b_count, int n,
                        uint32_t seed, uint32_t* __restrict__ out) {
  // one chunk's lane words per warp: stripe s, lane l at [4 * s + l]
  __shared__ uint2 chunk_words[kWarps][kChunk / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= b_count) return;  // whole warps only: no CTA barrier below
  const int32_t* row = x + static_cast<size_t>(b) * n;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(chunk_words[warp]);
  const int n_stripes = n / 8;  // 16 bytes = 8 samples
  const int body = 8 * n_stripes;
  const int n_chunks = (body + kChunk - 1) / kChunk;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // lane l < 4 carries accumulator l
  uint32_t acc = lane == 0   ? seed + kP1 + kP2
                 : lane == 1 ? seed + kP2
                 : lane == 2 ? seed
                             : seed - kP1;
  int4 r[kLoads];
  if (n_chunks) load_chunk(row, 0, body, vec, lane, r);
  for (int c = 0; c < n_chunks; ++c) {
    // every thread turns its samples into lane words (BE bytes, LE words)
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      chunk_words[warp][k * 32 + lane] = make_uint2(
          lane_word(r[k].x, r[k].y), lane_word(r[k].z, r[k].w));
    __syncwarp();
    if (c + 1 < n_chunks) load_chunk(row, c + 1, body, vec, lane, r);
    if (lane < 4) {
      const int stripes = min(kChunkStripes, n_stripes - c * kChunkStripes);
      const uint32_t* p = words + lane;
      int s = 0;
      for (; s + kAhead <= stripes; s += kAhead) {
        uint32_t w[kAhead];  // loads issued together, off the round chain
#pragma unroll
        for (int j = 0; j < kAhead; ++j) w[j] = p[4 * (s + j)];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) acc = xxh_round(acc, w[j]);
      }
      for (; s < stripes; ++s) acc = xxh_round(acc, p[4 * s]);
    }
    __syncwarp();  // the chunk is consumed before the next one lands
  }

  // h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18) in lane 0
  uint32_t part = rotl(acc, lane == 0 ? 1 : lane == 1 ? 7 : lane == 2 ? 12 : 18);
  part += __shfl_down_sync(0xFFFFFFFFu, part, 2);
  part += __shfl_down_sync(0xFFFFFFFFu, part, 1);
  if (lane) return;
  uint32_t h = n_stripes ? part : seed + kP5;
  h += 2u * static_cast<uint32_t>(n);
  int i = body;
  for (; i + 2 <= n; i += 2)
    h = rotl(h + lane_word(row[i], row[i + 1]) * kP3, 17) * kP4;
  if (i < n) {  // odd last sample: two single BE bytes
    const uint32_t s = static_cast<uint32_t>(row[i]) & 0xFFFFu;
    h = rotl(h + (s >> 8) * kP5, 11) * kP1;
    h = rotl(h + (s & 0xFFu) * kP5, 11) * kP1;
  }
  h = (h ^ (h >> 15)) * kP2;
  h = (h ^ (h >> 13)) * kP3;
  out[b] = h ^ (h >> 16);
}

}  // namespace

extern "C" int airs_xxh32_blocks(const void* x, int b, int n, unsigned seed,
                                 void* out, void* stream) {
  const int grid = (b + kWarps - 1) / kWarps;
  xxh32_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), b, n, seed, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}
