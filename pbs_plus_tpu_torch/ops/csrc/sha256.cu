// Batched whole-chunk SHA-256 (K2) for Hopper, sm_90a.
//
// Replaces pbs_plus_tpu/ops/sha256.py::_sha256_scan_impl (with
// _compress_unrolled / _compress_rolled), which XLA lowers on the TPU: the
// SHA-256 of N chunks given as (start, length) slices of one device stream
// buffer.  The kernel applies the 0x80 byte, the zero fill and the 64-bit
// big-endian bit length itself and writes uint32[N, 8] big-endian words.
// Offsets and lengths are int64.
//
// What bounds it on the H100: operations, and above all the serial chain of
// one chunk.  A 64-byte block costs about 2,300 integer operations, so the
// whole input is bound by the card's int32 rate rather than by its bytes;
// but the blocks of one chunk depend on each other, so no kernel can finish
// before the longest chunk's chain of blocks (16 MiB = 262,144 blocks at the
// default max chunk size) has run on one thread.  Measured: ~2,950 cycles
// per block on that chain, ~46 per round (PERF.md).
//
// Design: one thread per chunk, 32 threads (one warp) per block.  Full data
// blocks are read as 4-byte aligned words one block ahead of the
// compression that uses them, so memory latency overlaps the rounds, then
// realigned with funnel shifts (chunk starts are arbitrary) and
// byte-swapped; the one or two padded tail blocks are assembled byte by
// byte.  The schedule is a 16-word ring and the 64 rounds are unrolled.
// Giving each of a step's ~500 chunks a warp of its own, spread over all
// SMs, was measured no faster: the time is the rounds' dependency chain,
// not issue slots or scattered loads.  Splitting a chunk across threads is
// not possible for SHA-256, so a faster design has to overlap steps or hash
// more chunks at once.

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

constexpr int THREADS = 32;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + K[i] + wi;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The aligned 4-byte words that hold the 64 data bytes at p (any alignment):
// 16 when p is aligned, else 17.  Only words holding at least one of those
// bytes are read.  Issued a block ahead of use, so the loads are in flight
// while the previous block compresses.
__device__ __forceinline__ void fetch_block(const uint8_t* p, uint32_t raw[17]) {
  const uint32_t* a = (const uint32_t*)(p - ((uintptr_t)p & 3));
#pragma unroll
  for (int k = 0; k < 16; ++k) raw[k] = __ldg(a + k);
  raw[16] = ((uintptr_t)p & 3) ? __ldg(a + 16) : 0u;
}

// The fetched words realigned to p and byte-swapped: 16 big-endian words.
__device__ __forceinline__ void block_words(const uint8_t* p,
                                            const uint32_t raw[17],
                                            uint32_t w[16]) {
  const unsigned shift = 8 * (unsigned)((uintptr_t)p & 3);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    w[k] = bswap(__funnelshift_r(raw[k], raw[k + 1], shift));
}

__global__ void __launch_bounds__(THREADS)
sha256_kernel(const uint8_t* __restrict__ stream,
              const int64_t* __restrict__ starts,
              const int64_t* __restrict__ lens, int64_t n,
              uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint8_t* p = stream + starts[i];
  const int64_t L = lens[i];
  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint32_t w[16], raw[17];
  const int64_t nfull = L >> 6;
  if (nfull > 0) fetch_block(p, raw);
  for (int64_t t = 0; t < nfull; ++t) {
    block_words(p + 64 * t, raw, w);
    if (t + 1 < nfull) fetch_block(p + 64 * (t + 1), raw);
    compress(st, w);
  }
  // tail: r data bytes, 0x80, zeros, then the bit length in the last 8
  // bytes of the last block; one block if r + 9 <= 64, else two
  const int r = (int)(L - 64 * nfull);
  const uint8_t* q = p + 64 * nfull;
  const int tail_blocks = r + 9 <= 64 ? 1 : 2;
  const uint64_t bits = (uint64_t)L << 3;
  for (int tb = 0; tb < tail_blocks; ++tb) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = 64 * tb + 4 * k + m;
        const uint32_t byte = j < r ? q[j] : (j == r ? 0x80u : 0u);
        word |= byte << (24 - 8 * m);
      }
      w[k] = word;
    }
    if (tb == tail_blocks - 1) {
      w[14] = (uint32_t)(bits >> 32);
      w[15] = (uint32_t)bits;
    }
    compress(st, w);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[i * 8 + k] = st[k];
}

}  // namespace

// stream uint8[*], starts/lens int64[n], out uint32[n, 8]; device pointers.
// The caller checks that every slice lies inside the stream.
extern "C" int sha256_chunks_launch(int device, const void* stream,
                                    const void* starts, const void* lens,
                                    int64_t n, void* out, void* cuda_stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  sha256_kernel<<<blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)stream, (const int64_t*)starts, (const int64_t*)lens, n,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* sha256_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
