// Batched whole-chunk SHA-256 (K2) for Hopper, sm_90a.
//
// Replaces pbs_plus_tpu/ops/sha256.py::_sha256_scan_impl (with
// _compress_unrolled / _compress_rolled), which XLA lowers on the TPU: the
// SHA-256 of N chunks given as (start, length) slices of one device stream
// buffer.  The kernel applies the 0x80 byte, the zero fill and the 64-bit
// big-endian bit length itself and writes uint32[N, 8] big-endian words.
// Offsets and lengths are int64.
//
// What bounds it on the H100: the instruction rate of one warp.  The blocks of a
// chunk depend on each other, so no kernel finishes before the longest
// chunk (16 MiB = 262,145 blocks at the default max chunk size) has run its
// 64 rounds per block on one lane, and that lane's warp is alone on its
// sub-partition.  A warp's integer instruction occupies the sub-partition's
// 16 INT32 lanes for 2 cycles however many lanes are active.  The first
// version ran the message schedule, the K add and the byte handling on
// that warp too: ~22.8 instructions and ~46 cycles a round.  A round needs
// at least 10 shift and logic instructions (INT32 pipe only) and 4 adds;
// its chain is 3 dependent instructions (SHF, LOP3, IADD3).  Measured
// (PERF.md): one warp alone runs about one instruction per 2 cycles
// whatever the pipe, so this design's ~17 instructions take ~29.5 cycles.
//
// Design: warp-specialised producer/consumer, one block per 32 chunks.
// - The consumer warp (warp 0) runs only the compression: lane = chunk.
//   Each round takes one word KW[i] = K[i] + W[i] from shared memory (one
//   16-byte load per 4 rounds), and folds h + KW and d + h + KW off the
//   chain, so e' = (d+h+KW) + S1(e) + ch(e,f,g) is one 3-input add after
//   S1 and ch; the other adds go to the FMA pipe as IMAD.
// - PRODUCERS producer warps (warps 1..) do everything else for the same
//   32 chunks, producer p taking blocks t = p mod PRODUCERS: load 64 bytes
//   (aligned 4-byte words, realigned with funnel shifts and byte-swapped),
//   build the one or two padding blocks, expand W[16..63], add K, and write
//   the 64 words into slot t mod DEPTH of a ring in shared memory.  The
//   consumer never sees a tail.  They run on other sub-partitions
//   (warp id mod 4), so the schedule no longer takes the rounds'
//   dispatch slots.
// - Hand-off through named barriers, one FULL and one EMPTY per slot.
// The wrapper sorts chunks longest first, so the warp of the longest chunk
// starts first and a warp's lanes have similar block counts; it restores
// input order on output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr int LANES = 32;                    // chunks per block
constexpr int PRODUCERS = 2;
constexpr int DEPTH = 4;                     // ring slots, 8 KiB each
constexpr int THREADS = LANES * (1 + PRODUCERS);
static_assert(DEPTH % PRODUCERS == 0, "a slot is always filled by one producer");
static_assert(1 + 2 * DEPTH <= 16, "named barriers 1..2*DEPTH");

// ring[slot][g][lane] holds KW[4g .. 4g+3] of that lane's chunk block
struct Ring {
  uint4 kw[DEPTH][16][LANES];
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// FULL(s) and EMPTY(s): one producer warp and the consumer warp, 64 threads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * LANES) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * LANES) : "memory");
}
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + DEPTH + s; }

// The aligned 4-byte words that hold the 64 data bytes at p (any
// alignment): 16 when p is aligned, else 17; only words holding at least
// one of those bytes are read.
__device__ __forceinline__ void fetch_block(const uint8_t* p, uint32_t raw[17]) {
  const uint32_t* a = (const uint32_t*)(p - ((uintptr_t)p & 3));
#pragma unroll
  for (int k = 0; k < 16; ++k) raw[k] = __ldg(a + k);
  raw[16] = ((uintptr_t)p & 3) ? __ldg(a + 16) : 0u;
}

// Message block t of a chunk of length L at p, as 16 big-endian words.
// Full data blocks use the words prefetched into raw; the one or two last
// blocks hold the tail bytes, 0x80, zeros and the bit length.
__device__ __forceinline__ void block_words(const uint8_t* p, int64_t L,
                                            int64_t t, const uint32_t raw[17],
                                            uint32_t w[16]) {
  if (t < (L >> 6)) {
    const unsigned shift = 8 * (unsigned)((uintptr_t)(p + 64 * t) & 3);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      w[k] = bswap(__funnelshift_r(raw[k], raw[k + 1], shift));
    return;
  }
  const int r = (int)(L - 64 * t);           // data bytes in this block, <64
  const uint8_t* q = p + 64 * t;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 4 * k + m;
      const uint32_t byte = j < r ? q[j] : (j == r ? 0x80u : 0u);
      word |= byte << (24 - 8 * m);
    }
    w[k] = word;
  }
  if (t == (L + 8) / 64) {                   // the last block
    const uint64_t bits = (uint64_t)L << 3;
    w[14] = (uint32_t)(bits >> 32);
    w[15] = (uint32_t)bits;
  }
}

__device__ __forceinline__ void producer(Ring& ring, const uint8_t* p,
                                         int64_t L, int64_t nb, int64_t T,
                                         int pw, int lane) {
  uint32_t raw[17];
  const int64_t nfull = L >> 6;
  if (pw < nfull) fetch_block(p + 64 * pw, raw);
  for (int64_t t = pw; t < T; t += PRODUCERS) {
    const int s = (int)(t % DEPTH);
    if (t >= DEPTH) bar_sync(empty_bar(s));
    if (t < nb) {
      uint32_t w[16];
      block_words(p, L, t, raw, w);
      if (t + PRODUCERS < nfull) fetch_block(p + 64 * (t + PRODUCERS), raw);
      uint4* dst = &ring.kw[s][0][lane];
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        uint32_t kw[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = 4 * g + m;
          if (i >= 16) {
            const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            w[i & 15] += s0 + w[(i - 7) & 15] + s1;
          }
          kw[m] = w[i & 15] + K[i];
        }
        dst[g * LANES] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
      }
    }
    bar_arrive(full_bar(s));
  }
}

// One round.  h + KW and d + h + KW do not depend on this round's e, so
// they run off the chain, and e' = (d+h+KW) + S1 + ch is one IADD3 after
// S1 and ch.  The other adds are madd(x, y) = x * one + y, where `one` is a
// kernel argument equal to 1: the compiler cannot fold the product, so they
// run as IMAD on the FMA pipe, not the INT32 pipe of the shifts and
// logic ops.  The new e goes to d and the new a to h; the caller rotates
// the register names.
#define madd(x, y) ((x) * one + (y))
#define SHA_ROUND(a, b, c, d, e, f, g, h, kw)                            \
  do {                                                                   \
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);          \
    const uint32_t ch = g ^ (e & (f ^ g));                               \
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);          \
    const uint32_t maj = (a & b) | (c & (a | b));                        \
    const uint32_t hk = madd(h, (kw));                                   \
    const uint32_t dhk = madd(d, hk);                                    \
    d = dhk + S1 + ch;                                                   \
    h = madd(madd(S1, madd(ch, hk)), madd(S0, maj));                     \
  } while (0)

__device__ __forceinline__ void consumer(Ring& ring, uint32_t st[8],
                                         int64_t nb, int64_t T, int lane,
                                         uint32_t one) {
  for (int64_t t = 0; t < T; ++t) {
    const int s = (int)(t % DEPTH);
    bar_sync(full_bar(s));
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
    const uint4* src = &ring.kw[s][0][lane];
#pragma unroll
    for (int q = 0; q < 16; q += 2) {
      const uint4 x = src[q * LANES], y = src[(q + 1) * LANES];
      SHA_ROUND(a, b, c, d, e, f, g, h, x.x);
      SHA_ROUND(h, a, b, c, d, e, f, g, x.y);
      SHA_ROUND(g, h, a, b, c, d, e, f, x.z);
      SHA_ROUND(f, g, h, a, b, c, d, e, x.w);
      SHA_ROUND(e, f, g, h, a, b, c, d, y.x);
      SHA_ROUND(d, e, f, g, h, a, b, c, y.y);
      SHA_ROUND(c, d, e, f, g, h, a, b, y.z);
      SHA_ROUND(b, c, d, e, f, g, h, a, y.w);
    }
    if (t + DEPTH < T) bar_arrive(empty_bar(s));
    if (t < nb) {
      st[0] += a; st[1] += b; st[2] += c; st[3] += d;
      st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
  }
}

// Chunk i of the sorted order: starts/lens sorted by length, longest
// first; out[i] is its digest.  Lanes past n hash nothing.
__global__ void __launch_bounds__(THREADS)
sha256_kernel(const uint8_t* __restrict__ stream,
              const int64_t* __restrict__ starts,
              const int64_t* __restrict__ lens, int64_t n,
              uint32_t* __restrict__ out, uint32_t one) {
  __shared__ Ring ring;
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int64_t first = (int64_t)blockIdx.x * LANES;
  const int64_t i = first + lane;
  const int64_t L = i < n ? lens[i] : 0;
  const int64_t nb = i < n ? (L + 8) / 64 + 1 : 0;
  const int64_t T = (lens[first] + 8) / 64 + 1;   // lane 0 is the longest
  if (warp > 0) {
    producer(ring, stream + (i < n ? starts[i] : 0), L, nb, T, warp - 1, lane);
    return;
  }
  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  consumer(ring, st, nb, T, lane, one);
  if (i < n) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[i * 8 + k] = st[k];
  }
}

}  // namespace

// stream uint8[*]; starts/lens int64[n], sorted by length, longest first;
// out uint32[n, 8] in that order; device pointers.  The caller checks that
// every slice lies inside the stream.
extern "C" int sha256_chunks_launch(int device, const void* stream,
                                    const void* starts, const void* lens,
                                    int64_t n, void* out, void* cuda_stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + LANES - 1) / LANES);
  sha256_kernel<<<blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)stream, (const int64_t*)starts, (const int64_t*)lens, n,
      (uint32_t*)out, 1u);
  return (int)cudaGetLastError();
}

extern "C" const char* sha256_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
