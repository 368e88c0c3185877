// A latency probe of kernel K4's round chain; not a kernel of the codec.
// chip_smoke.py times it beside K4 on one long row (csrc/xxh32.cu), so that
// K4's chain bound is a measured time, not an assumed latency.
//
// One warp with four active lanes, as K4 runs one row: each lane runs
// `rounds` dependent XXH32 rounds acc = rotl13(acc + w * P2) * P1.
//   mode 0: the chain alone in acc-form, written as the three instructions
//           the round compiles to (IMAD, SHF.L.W, IMAD) on a lane word held
//           in a register: its time is that chain's latency and nothing
//           else;
//   mode 1: K4's batch round loop in acc-form, without its loads from
//           device memory: lane words read from one 4 KB chunk in shared
//           memory 16 rounds ahead, the whole warp meeting at a __syncwarp
//           per chunk;
//   mode 2: the chain alone in u-form, as K4 now runs it: u = acc + w P2
//           carried, u' = rotl13(u) P1 + t with t = w P2 in a register, two
//           dependent instructions (SHF.L.W, IMAD); it starts from
//           u = rotr13(acc P1^-1), as K4 does, and writes u, not acc.
// Writes each lane's accumulator (so no round is dead code) and, from lane
// 0, the SM cycles the rounds took (clock64).
#include "common.cuh"

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP1Inv = 244002641u;  // P1 kP1Inv = 1 mod 2^32
constexpr uint32_t kP2 = 2246822519u;
constexpr int kAhead = 16;          // as csrc/xxh32.cu
constexpr int kChunkStripes = 512;  // as csrc/xxh32.cu: 4 KB of samples

__device__ __forceinline__ uint32_t xxh_round(uint32_t acc, uint32_t w) {
  return ((acc + w * kP2) << 13 | (acc + w * kP2) >> 19) * kP1;
}

__global__ void __launch_bounds__(32)
    xxh32_chain_kernel(int rounds, int mode, uint32_t* __restrict__ out,
                       long long* __restrict__ cycles) {
  __shared__ uint32_t words[4 * kChunkStripes];
  const int lane = threadIdx.x;
  for (int i = lane; i < 4 * kChunkStripes; i += 32)
    words[i] = 0x9E3779B1u * static_cast<uint32_t>(i + 1);
  __syncwarp();
  uint32_t acc = 0x165667B1u + static_cast<uint32_t>(lane);
  const long long t0 = clock64();
  if (mode == 0) {
    if (lane < 4) {
      const uint32_t w = words[lane];
#pragma unroll 16
      for (int s = 0; s < rounds; ++s)
        asm volatile(
            "mad.lo.u32 %0, %1, %2, %0;\n\t"
            "shf.l.wrap.b32 %0, %0, %0, 13;\n\t"
            "mul.lo.u32 %0, %0, %3;"
            : "+r"(acc)
            : "r"(w), "r"(kP2), "r"(kP1));
    }
  } else if (mode == 2) {
    if (lane < 4) {
      const uint32_t t = words[lane] * kP2;
      const uint32_t v = acc * kP1Inv;
      uint32_t u = __funnelshift_r(v, v, 13);
#pragma unroll 16
      for (int s = 0; s < rounds; ++s)
        asm volatile(
            "{\n\t.reg .b32 r;\n\t"
            "shf.l.wrap.b32 r, %0, %0, 13;\n\t"
            "mad.lo.u32 %0, r, %2, %1;\n\t}"
            : "+r"(u)
            : "r"(t), "r"(kP1));
      acc = u;
    }
  } else {
    const uint32_t* p = words + lane;
    for (int done = 0; done < rounds; done += kChunkStripes) {
      if (lane < 4) {
        const int stripes = min(kChunkStripes, rounds - done);
        int s = 0;
        for (; s + kAhead <= stripes; s += kAhead) {
          uint32_t w[kAhead];
#pragma unroll
          for (int j = 0; j < kAhead; ++j) w[j] = p[4 * (s + j)];
#pragma unroll
          for (int j = 0; j < kAhead; ++j) acc = xxh_round(acc, w[j]);
        }
        for (; s < stripes; ++s) acc = xxh_round(acc, p[4 * s]);
      }
      __syncwarp();
    }
  }
  const long long t1 = clock64();
  if (lane < 4) out[lane] = acc;
  if (lane == 0) *cycles = t1 - t0;
}

}  // namespace

// out: 4 u32 accumulators; cycles: one int64.
extern "C" int airs_xxh32_chain(int rounds, int mode, void* out, void* cycles,
                                void* stream) {
  if (rounds < 0 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  xxh32_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, mode, static_cast<uint32_t*>(out),
      static_cast<long long*>(cycles));
  return cudaGetLastError();
}
