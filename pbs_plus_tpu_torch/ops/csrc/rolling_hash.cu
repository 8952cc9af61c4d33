// Buzhash candidate mask (K1) for Hopper, sm_90a.
//
// Replaces the Pallas kernel of pbs_plus_tpu/ops/pallas_rolling_hash.py
// (_candidate_mask_tiles -> _kernel_factory(...).kernel) and the jnp
// candidate_mask of pbs_plus_tpu/ops/rolling_hash.py: for every byte i of a
// row,
//     h(i) = XOR_{k<64} rotl32(T[b[i-k]], k mod 32),  hit = (h & mask) == magic,
// where b[i-k] for i-k < 0 comes from the row's optional 63-byte history, and
// without a history the positions i < 63 are not candidates.  T is the
// 256-entry buzhash_table (chunker/spec.py), bit-identical to the TPU's
// nibble form.
//
// What bounds it on the H100: bytes.  Each input byte is read once and one
// mask byte is written per input byte, 2 bytes per position at 3.35 TB/s;
// the rolling recurrence below costs about 8 integer operations per
// position, which the card's int32 rate clears in less time.
//
// Design: one block covers SPAN positions of one row.  It stages those bytes
// plus the 63 bytes before them (from the row, or from the history at the
// row's start) and the 1 KiB table in shared memory.  Each thread owns PER
// consecutive positions: it computes the first by the closed form (64
// lookups) and rolls the rest with
//     h(i+1) = T[b[i+1]] ^ rotl1(h(i) ^ rotl31(T[b[i-63]])),
// two lookups each.  PER is odd so that the 32 threads of a warp, reading
// bytes PER apart, hit different shared-memory banks.  Hits are gathered in
// shared memory and written out with coalesced stores.  The TPU's 16320-byte
// tiles, 128-lane alignment and doubling passes are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 64;
constexpr int HALO = WINDOW - 1;
constexpr int THREADS = 256;
constexpr int PER = 33;
constexpr int SPAN = THREADS * PER;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__global__ void __launch_bounds__(THREADS)
candidate_mask_kernel(const uint8_t* __restrict__ data,
                      const uint8_t* __restrict__ hist,
                      const uint32_t* __restrict__ table,
                      uint8_t* __restrict__ out, int64_t S,
                      uint32_t mask, uint32_t magic) {
  __shared__ uint32_t T[256];
  __shared__ uint8_t buf[HALO + SPAN];
  __shared__ uint8_t hit[SPAN];
  const int64_t row = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * SPAN;
  const uint8_t* src = data + row * S;
  for (int i = threadIdx.x; i < 256; i += THREADS) T[i] = table[i];
  for (int i = threadIdx.x; i < HALO + SPAN; i += THREADS) {
    const int64_t p = s0 - HALO + i;
    uint8_t b = 0;
    if (p >= 0) {
      if (p < S) b = src[p];
    } else if (hist != nullptr) {
      b = hist[row * HALO + (HALO + p)];
    }
    buf[i] = b;
  }
  __syncthreads();

  const int n_here = (int)min((int64_t)SPAN, S - s0);
  const int first = threadIdx.x * PER;
  if (first < n_here) {
    const int last = min(first + PER, n_here);
    const int q0 = first + HALO;
    uint32_t h = 0;
#pragma unroll
    for (int k = 0; k < WINDOW; ++k) h ^= rotl(T[buf[q0 - k]], k & 31);
    for (int j = first; j < last; ++j) {
      if (j > first) {
        const int q = j + HALO;
        h = T[buf[q]] ^ rotl(h ^ rotl(T[buf[q - WINDOW]], 31), 1);
      }
      const bool valid = hist != nullptr || s0 + j >= HALO;
      hit[j] = valid && ((h & mask) == magic);
    }
  }
  __syncthreads();
  uint8_t* dst = out + row * S + s0;
  for (int i = threadIdx.x; i < n_here; i += THREADS) dst[i] = hit[i];
}

}  // namespace

// data uint8[B, S], hist uint8[B, 63] or null, table uint32[256],
// out uint8[B, S] (0/1).  All device pointers, rows contiguous.
extern "C" int rolling_hash_candidate_mask(int device, const void* data,
                                           const void* hist, const void* table,
                                           void* out, int64_t B, int64_t S,
                                           uint32_t mask, uint32_t magic,
                                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || S == 0) return 0;
  const dim3 grid((unsigned)((S + SPAN - 1) / SPAN), (unsigned)B);
  candidate_mask_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)hist, (const uint32_t*)table,
      (uint8_t*)out, S, mask, magic);
  return (int)cudaGetLastError();
}

extern "C" const char* rolling_hash_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
