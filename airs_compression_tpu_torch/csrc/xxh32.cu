// K4: XXH32 of each block's samples as big-endian u16 bytes.
//
// Replaces airs_compression_tpu/ops/xxh32_device.py::_xxh_kernel (entry
// xxh32_blocks_pallas, reached through checksum_blocks_device); the plain
// PyTorch version is ops/xxh32_device.py::xxh32_blocks (and
// ::xxh32_lanes_plain for the streaming mode).
//
// Input: samples (B, N) int32 (low 16 bits hashed, two BE bytes each).
// Output: (B,) u32 digests, seed 419764627, any N >= 1.  Streaming mode
// (entry airs_xxh32_lanes) hashes a piece of a stream: each row's four lane
// accumulators come in from lanes[4 b + l] and go back there, the row holds
// whole 16-byte stripes only (N a multiple of 8), and the tail and the
// finalize are left to the host state (utils/xxh32.py XXH32State).
//
// What bounds it on the H100: the latency of one chain, not bytes.  XXH32's
// round acc = rotl13(acc + w P2) P1 is not associative, so a row is four
// independent lane chains of N / 8 dependent rounds each and nothing finer:
// a row takes (cycles a round) x N / 8 whatever the card's width.  The TPU
// kernel relaid the stripes into (8, 128) lane tiles and carried the
// accumulators in VMEM scratch across grid steps; here they stay in
// registers, and the design attacks the two costs a round can carry.
//
// 1. The round itself, in every mode: carried in u-form.  With
//    u = acc + t and t = w P2, the round is u' = rotl13(u) P1 + t', one
//    SHF.L.W and one IMAD on the dependent path (t' is computed off it,
//    with the byte swap, before the chain sees it), where acc-form takes
//    three (IMAD, SHF.L.W, IMAD).  Lanes enter and leave in acc-form: the
//    entry u_0 = acc + t_0 is the first round, taken from
//    u_-1 = rotr13(acc P1^-1) (P1 is odd, so rotl13(u_-1) P1 = acc), and
//    the exit is acc = rotl13(u) P1; a row of 0 stripes leaves acc as it
//    was.  The bytes are XXH32's exactly.
// 2. The loads, in the long path: a chain warp fed by a producer warp.
//    The chain waits only on shared memory; nothing else runs in its
//    instruction stream.
//
// Batch path (B above the SM count, or N under kLongMin = 8192 samples;
// B = 512 x N = 8192 on the main path): one warp per block, two
// blocks a CTA, so B = 512 gives 512 warps on the 132 SMs.  The warp
// streams its row in 4 KB chunks, 16 bytes per thread per load
// (coalesced); every thread turns its samples into t words and stores them
// to shared memory, and four threads run the four lanes' rounds on the
// chunk (reading 16 words ahead) while the next chunk's loads are already
// in flight.  The lanes combine by warp shuffles, and one thread runs the
// tail (4-byte words, then the odd last sample's two bytes) and the
// finalize.
//
// Long path (B at most the SM count and N at least kLongMin samples: one
// long stream is one row, parallel/sp.py): one CTA of two warps per
// row, 82 KB of dynamic shared memory.
//   * Warp 1, the producer.  One thread streams the row's body (its whole
//     stripes) into a ring of 3 raw stages of 4096 int32 samples with
//     cp.async.bulk (1-D TMA), each completing on its mbarrier.  A row that
//     does not start on a 16-byte boundary is fetched as the aligned
//     16-byte chunks that hold it (every stage's range rounded out), and
//     the warp reads from the offset.  The warp turns each stage into t
//     words, __byte_perm byte swap then x P2, into a ring of 4 stages of
//     512 stripes (8 KB) laid out [group of 4 stripes][lane][4], so that
//     chain thread l reads its next 4 t words with one 16-byte LDS and the
//     four threads read 64 contiguous bytes.  Stage s is guarded by a full
//     mbarrier (32 producer arrivals) and an empty one (4 chain arrivals).
//   * Warp 0, the chain.  Threads 0-3 wait on a stage's full barrier once
//     per 512 rounds, run its rounds with their LDS.128 issued 8 groups
//     (32 rounds) ahead -- the last groups of a stage prefetch the next
//     stage's first ones -- and release it through the empty barrier.  The
//     warp issues no device load and no conversion.
//   * Then both warps meet at one CTA barrier; thread 32 stores the lanes
//     (streaming mode) or combines them, hashes the tail from device
//     memory and finalizes, as the batch path does.
// A wait that does not end within 2^34 SM cycles traps: a lost arrival is
// a launch failure, not a hung card.
#include "common.cuh"

namespace {

constexpr int kLongMin = 8192;  // samples a row from which B <= SMs go long

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP1Inv = 244002641u;  // P1 kP1Inv = 1 mod 2^32
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// u-form round: rotl13(u) P1 + t, one SHF.L.W and one IMAD
__device__ __forceinline__ uint32_t uround(uint32_t u, uint32_t t) {
  uint32_t v;
  asm("{\n\t.reg .b32 r;\n\t"
      "shf.l.wrap.b32 r, %1, %1, 13;\n\t"
      "mad.lo.u32 %0, r, %2, %3;\n\t}"
      : "=r"(v)
      : "r"(u), "r"(kP1), "r"(t));
  return v;
}

// acc-form lane -> the u before its first round, and back
__device__ __forceinline__ uint32_t u_entry(uint32_t acc) {
  const uint32_t v = acc * kP1Inv;
  return __funnelshift_r(v, v, 13);
}

__device__ __forceinline__ uint32_t u_exit(uint32_t u) {
  return rotl(u, 13) * kP1;
}

__device__ __forceinline__ uint32_t seed_lane(uint32_t seed, int l) {
  return l == 0 ? seed + kP1 + kP2 : l == 1 ? seed + kP2 : l == 2 ? seed
                                                                  : seed - kP1;
}

// t word of one stripe lane: the BE bytes of samples a, b read as an LE
// word, x P2
__device__ __forceinline__ uint32_t t_word(int32_t a, int32_t b) {
  return __byte_perm(static_cast<uint32_t>(a), static_cast<uint32_t>(b),
                     0x4501) * kP2;
}

// XXH32 from the combined lanes h (or seed + P5 below one stripe) on: the
// length, the tail after the body's whole stripes, the avalanche
__device__ uint32_t digest(uint32_t h, const int32_t* row, int body, int n) {
  h += 2u * static_cast<uint32_t>(n);
  int i = body;
  for (; i + 2 <= n; i += 2)
    h = rotl(h + __byte_perm(row[i], row[i + 1], 0x4501) * kP3, 17) * kP4;
  if (i < n) {  // odd last sample: two single BE bytes
    const uint32_t s = static_cast<uint32_t>(row[i]) & 0xFFFFu;
    h = rotl(h + (s >> 8) * kP5, 11) * kP1;
    h = rotl(h + (s & 0xFFu) * kP5, 11) * kP1;
  }
  h = (h ^ (h >> 15)) * kP2;
  h = (h ^ (h >> 13)) * kP3;
  return h ^ (h >> 16);
}

// ---- batch path -----------------------------------------------------------

constexpr int kWarps = 2;  // blocks per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 8;                  // 16-byte loads per thread per chunk
constexpr int kChunk = 32 * 4 * kLoads;    // samples per warp chunk (4 KB)
constexpr int kChunkStripes = kChunk / 8;  // 16-byte stripes per chunk
constexpr int kAhead = 16;                 // t words read before their rounds

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

// lanes: null, or (B, 4) accumulators in and out (streaming mode; out
// unused, N a multiple of 8).
__global__ void __launch_bounds__(kThreads)
    xxh32_blocks_kernel(const int32_t* __restrict__ x, int b_count, int n,
                        uint32_t seed, uint32_t* __restrict__ out,
                        uint32_t* __restrict__ lanes) {
  // one chunk's t words per warp: stripe s, lane l at [4 * s + l]
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

  // lane l < 4 carries accumulator l, in u-form between entry and exit
  uint32_t u = 0;
  if (lane < 4)
    u = u_entry(lanes ? lanes[4 * b + lane] : seed_lane(seed, lane));
  int4 r[kLoads];
  if (n_chunks) load_chunk(row, 0, body, vec, lane, r);
  for (int c = 0; c < n_chunks; ++c) {
    // every thread turns its samples into t words
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      chunk_words[warp][k * 32 + lane] =
          make_uint2(t_word(r[k].x, r[k].y), t_word(r[k].z, r[k].w));
    __syncwarp();
    if (c + 1 < n_chunks) load_chunk(row, c + 1, body, vec, lane, r);
    if (lane < 4) {
      const int stripes = min(kChunkStripes, n_stripes - c * kChunkStripes);
      const uint32_t* p = words + lane;
      int s = 0;
      for (; s + kAhead <= stripes; s += kAhead) {
        uint32_t t[kAhead];  // loads issued together, off the round chain
#pragma unroll
        for (int j = 0; j < kAhead; ++j) t[j] = p[4 * (s + j)];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) u = uround(u, t[j]);
      }
      for (; s < stripes; ++s) u = uround(u, p[4 * s]);
    }
    __syncwarp();  // the chunk is consumed before the next one lands
  }

  const uint32_t acc = u_exit(u);
  if (lanes) {
    if (lane < 4) lanes[4 * b + lane] = acc;
    return;
  }
  // h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18) in lane 0
  uint32_t part = rotl(acc, lane == 0 ? 1 : lane == 1 ? 7 : lane == 2 ? 12 : 18);
  part += __shfl_down_sync(0xFFFFFFFFu, part, 2);
  part += __shfl_down_sync(0xFFFFFFFFu, part, 1);
  if (lane) return;
  out[b] = digest(n_stripes ? part : seed + kP5, row, body, n);
}

// ---- long path ------------------------------------------------------------

constexpr int kStageStripes = 512;                // stripes a t stage
constexpr int kStageSamples = 8 * kStageStripes;  // 4096
constexpr int kGroups = kStageStripes / 4;        // LDS.128 a lane a stage
constexpr int kStages = 4;                        // t ring
constexpr int kRawStages = 3;                     // raw ring
constexpr int kRawSamples = kStageSamples + 4;    // room to round out
constexpr int kGroupsAhead = 8;                   // chain prefetch distance
constexpr long long kWaitCycles = 1ll << 34;

struct LongSmem {
  uint4 t[kStages][kGroups][4];  // [stage][group][lane]: stripes 4g..4g+3
  alignas(16) int32_t raw[kRawStages][kRawSamples];
  uint64_t t_full[kStages];
  uint64_t t_empty[kStages];
  uint64_t raw_full[kRawStages];
  uint32_t acc[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done;
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (bar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(a, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// TMA of stage k of the row's body into raw slot k % kRawStages; the
// aligned 16-byte chunks holding it, so the stage starts at sample
// (address % 16) / 4 of the slot.
__device__ __forceinline__ void fetch(LongSmem& sm, const int32_t* row,
                                      int body, int k) {
  const int start = k * kStageSamples;
  const int samples = min(kStageSamples, body - start);
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + start);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uint32_t bytes =
      static_cast<uint32_t>(((a + 4u * samples + 15) & ~uintptr_t{15}) - lo);
  const int r = k % kRawStages;
  const uint32_t bar = smem_addr(&sm.raw_full[r]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(sm.raw[r])),
      "l"(lo), "r"(bytes), "r"(bar)
      : "memory");
}

// warp 1: raw stages in by TMA, t stages out
__device__ void produce(LongSmem& sm, const int32_t* row, int body,
                        int lane) {
  const int n_stages = (body + kStageSamples - 1) / kStageSamples;
  if (lane == 0)
    for (int k = 0; k < min(kRawStages, n_stages); ++k) fetch(sm, row, body, k);
  for (int k = 0; k < n_stages; ++k) {
    const int r = k % kRawStages;
    const int slot = k % kStages;
    bar_wait(&sm.raw_full[r], (k / kRawStages) & 1);
    if (k >= kStages) bar_wait(&sm.t_empty[slot], ((k / kStages) & 1) ^ 1);
    const int start = k * kStageSamples;
    const int pairs = min(kStageSamples, body - start) / 2;
    const int32_t* raw =
        sm.raw[r] + ((reinterpret_cast<uintptr_t>(row + start) & 15) >> 2);
    uint32_t* t = reinterpret_cast<uint32_t*>(sm.t[slot]);
    // pair p = stripe p / 4, lane p % 4; a warp's stores hit 32 banks
#pragma unroll 4
    for (int p = lane; p < pairs; p += 32) {
      const int s = p >> 2;
      t[16 * (s >> 2) + 4 * (p & 3) + (s & 3)] =
          t_word(raw[2 * p], raw[2 * p + 1]);
    }
    bar_arrive(&sm.t_full[slot]);
    __syncwarp();  // every lane is done with raw slot r
    if (lane == 0 && k + kRawStages < n_stages) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fetch(sm, row, body, k + kRawStages);
    }
  }
}

__device__ __forceinline__ uint32_t rounds4(uint32_t u, uint4 c) {
  u = uround(u, c.x);
  u = uround(u, c.y);
  u = uround(u, c.z);
  return uround(u, c.w);
}

// warp 0, thread `lane` < 4: the lane's rounds over every stage
__device__ uint32_t chain(LongSmem& sm, int n_stripes, int lane, uint32_t u) {
  const int n_stages = (n_stripes + kStageStripes - 1) / kStageStripes;
  if (!n_stages) return u;
  uint4 q[kGroupsAhead];
  bar_wait(&sm.t_full[0], 0);
#pragma unroll
  for (int j = 0; j < kGroupsAhead; ++j) q[j] = sm.t[0][j][lane];
  for (int k = 0; k < n_stages; ++k) {
    const int slot = k % kStages;
    const int stripes = min(kStageStripes, n_stripes - k * kStageStripes);
    if (stripes == kStageStripes) {
      const uint4* p = &sm.t[slot][kGroupsAhead][lane];
#pragma unroll 1
      for (int g = 0; g < kGroups - kGroupsAhead; g += kGroupsAhead) {
#pragma unroll
        for (int j = 0; j < kGroupsAhead; ++j) {
          const uint4 c = q[j];
          q[j] = p[4 * (g + j)];
          u = rounds4(u, c);
        }
      }
      if (k + 1 < n_stages) {  // the last groups prefetch the next stage
        const int next = (k + 1) % kStages;
        bar_wait(&sm.t_full[next], ((k + 1) / kStages) & 1);
#pragma unroll
        for (int j = 0; j < kGroupsAhead; ++j) {
          const uint4 c = q[j];
          q[j] = sm.t[next][j][lane];
          u = rounds4(u, c);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kGroupsAhead; ++j) u = rounds4(u, q[j]);
      }
    } else {  // the last stage, partly filled
      const uint32_t* w = reinterpret_cast<const uint32_t*>(sm.t[slot]);
#pragma unroll 8
      for (int s = 0; s < stripes; ++s)
        u = uround(u, w[16 * (s >> 2) + 4 * lane + (s & 3)]);
    }
    bar_arrive(&sm.t_empty[slot]);
  }
  return u;
}

// One CTA of two warps per row (lanes: as xxh32_blocks_kernel).
__global__ void __launch_bounds__(64)
    xxh32_long_kernel(const int32_t* __restrict__ x, int n, uint32_t seed,
                      uint32_t* __restrict__ out,
                      uint32_t* __restrict__ lanes) {
  extern __shared__ __align__(128) unsigned char smem[];
  LongSmem& sm = *reinterpret_cast<LongSmem*>(smem);
  const int b = blockIdx.x;
  const int32_t* row = x + static_cast<size_t>(b) * n;
  const int n_stripes = n / 8;
  const int body = 8 * n_stripes;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 32) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.t_full[s], 32);
      bar_init(&sm.t_empty[s], 4);
    }
    for (int r = 0; r < kRawStages; ++r) bar_init(&sm.raw_full[r], 1);
    for (int l = 0; l < 4; ++l)
      sm.acc[l] = lanes ? lanes[4 * b + l] : seed_lane(seed, l);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    sm.acc[lane] = u_exit(chain(sm, n_stripes, lane, u_entry(sm.acc[lane])));
  } else if (threadIdx.x >= 32) {
    produce(sm, row, body, lane);
  }
  __syncthreads();
  if (threadIdx.x != 32) return;
  if (lanes) {
    for (int l = 0; l < 4; ++l) lanes[4 * b + l] = sm.acc[l];
    return;
  }
  const uint32_t h = rotl(sm.acc[0], 1) + rotl(sm.acc[1], 7) +
                     rotl(sm.acc[2], 12) + rotl(sm.acc[3], 18);
  out[b] = digest(n_stripes ? h : seed + kP5, row, body, n);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool long_rows(int b, int n) {
  return n >= kLongMin && b <= sm_count();
}

int launch(const void* x, int b, int n, unsigned seed, void* out, void* lanes,
           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  auto* l = static_cast<uint32_t*>(lanes);
  if (long_rows(b, n)) {
    const int err = cudaFuncSetAttribute(
        xxh32_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sizeof(LongSmem));
    if (err) return err;
    xxh32_long_kernel<<<b, 64, sizeof(LongSmem), s>>>(xs, n, seed, o, l);
  } else {
    xxh32_blocks_kernel<<<(b + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        xs, b, n, seed, o, l);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int airs_xxh32_blocks(const void* x, int b, int n, unsigned seed,
                                 void* out, void* stream) {
  return launch(x, b, n, seed, out, nullptr, stream);
}

// Streaming mode: (b, 4) lane accumulators updated in place by the whole
// stripes of each row of n samples (n a multiple of 8).
extern "C" int airs_xxh32_lanes(const void* x, int b, int n, void* lanes,
                                void* stream) {
  if (n % 8) return cudaErrorInvalidValue;
  return launch(x, b, n, 0u, nullptr, lanes, stream);
}

// 1 where b rows of n samples take the long path, 0 for the batch path
// (on the current device); launches nothing.
extern "C" int airs_xxh32_long_rows(int b, int n) { return long_rows(b, n); }
