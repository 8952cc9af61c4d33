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
// mask byte is written per input byte, 2 bytes per position at 3.35 TB/s.
// The recurrence below costs about 6 integer instructions per position on
// the INT32 pipe, close behind.
//
// Design: a block walks SPANS consecutive spans of SPAN positions of one
// row (the partition is rolling_hash.py::span_partition), two spans in
// flight: while span k is hashed, span k+1 arrives in the other buffer by
// 16-byte cp.async copies, and its 63-byte halo is the tail of span k,
// already in shared memory.  Each of the 256 threads owns PER = 132
// consecutive positions: it computes the position before them by the
// closed form (64 lookups, under 0.5 a position) and rolls the rest with
//     h(i+1) = T[b[i+1]] ^ T[b[i-63]] ^ rotl1(h(i)),
// two lookups each (rotl by 64 is the identity).  Bytes are read from
// shared memory as 32-bit words and split with __byte_perm; PER / 4 = 33
// words is odd, so a warp's word reads fall on 32 distinct banks.  The
// table is replicated 32 times, bank-interleaved (T[v * 32 + lane]), so
// every lookup of a warp is one wavefront.  The mask is written as zeros
// by coalesced 16-byte stores before a span is hashed, and the rare hits
// (one in 2^22 positions at the default 4 MiB average) as single bytes
// after the barrier that orders them behind the zeros.  Rows whose base
// or length is not 16-byte aligned stage and store byte by byte instead.
// The TPU's 16320-byte tiles, 128-lane alignment and doubling passes are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 64;
constexpr int HALO = WINDOW - 1;
constexpr int THREADS = 256;
constexpr int PER = 132;                     // positions per thread
constexpr int SPAN = THREADS * PER;          // positions per span
constexpr int PAD = 64;                      // halo room before a span
constexpr int BUF_BYTES = PAD + SPAN;
constexpr int TABLE_WORDS = 256 * 32;
constexpr int SMEM_BYTES = 4 * TABLE_WORDS + 2 * BUF_BYTES;
static_assert(PER % 4 == 0 && (PER / 4) % 2 == 1, "odd words per thread");
static_assert(SPAN % 16 == 0 && BUF_BYTES % 16 == 0, "16-byte copies");

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int m) {
  return __byte_perm(w, 0, 0x4440 | m);
}

// Entry v of the lane's table replica: tl is the lane's shared-memory
// address in row 0, rows are 128 bytes apart.  One IMAD for the address.
__device__ __forceinline__ uint32_t look(uint32_t tl, uint32_t v) {
  uint32_t r;
  asm("ld.shared.u32 %0, [%1];" : "=r"(r) : "r"(tl + v * 128u));
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(gmem)
               : "memory");
}

// Stage span k's bytes (local positions 0..n-1) into buf[PAD..]: 16-byte
// async copies when aligned, else synchronous byte loads.
template <bool kAligned>
__device__ __forceinline__ void stage(uint8_t* buf, const uint8_t* src,
                                      int n) {
  if (kAligned) {
    for (int c = threadIdx.x; c < n / 16; c += THREADS)
      cp_async16(buf + PAD + 16 * c, src + 16 * c);
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) buf[PAD + i] = src[i];
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(THREADS, 2)
candidate_mask_kernel(const uint8_t* __restrict__ data,
                      const uint8_t* __restrict__ hist,
                      const uint32_t* __restrict__ table,
                      uint8_t* __restrict__ out, int64_t S, int64_t spans,
                      uint32_t mask, uint32_t magic) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* T = (uint32_t*)smem;
  uint8_t* bufs = smem + 4 * TABLE_WORDS;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t row = blockIdx.y;
  const int64_t n_spans = (S + SPAN - 1) / SPAN;
  const int64_t k0 = (int64_t)blockIdx.x * spans;
  const int64_t k1 = min(k0 + spans, n_spans);
  const uint8_t* src = data + row * S;
  uint8_t* dst = out + row * S;

  for (int i = tid; i < TABLE_WORDS; i += THREADS) T[i] = table[i >> 5];
  if (tid < HALO) {                          // the halo of the first span
    const int64_t p = k0 * SPAN - HALO + tid;
    uint8_t b = 0;
    if (p >= 0) b = src[p];
    else if (hist != nullptr) b = hist[row * HALO + HALO + p];
    bufs[PAD - HALO + tid] = b;
  }
  stage<kAligned>(bufs, src + k0 * SPAN, (int)min((int64_t)SPAN, S - k0 * SPAN));

  const uint32_t tl = (uint32_t)__cvta_generic_to_shared(T + lane);
  for (int64_t k = k0; k < k1; ++k) {
    const int cur = (int)((k - k0) & 1);
    uint8_t* buf = bufs + cur * BUF_BYTES;
    uint8_t* nxt = bufs + (cur ^ 1) * BUF_BYTES;
    const int64_t s0 = k * SPAN;
    const int n_here = (int)min((int64_t)SPAN, S - s0);
    if (k + 1 < k1)
      stage<kAligned>(nxt, src + s0 + SPAN,
                      (int)min((int64_t)SPAN, S - s0 - SPAN));
    if (kAligned) {
      if (k + 1 < k1) asm volatile("cp.async.wait_group 1;" ::: "memory");
      else asm volatile("cp.async.wait_group 0;" ::: "memory");
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int c = tid; c < n_here / 16; c += THREADS)
        *(uint4*)(dst + s0 + 16 * c) = zero;
    } else {
      for (int i = tid; i < n_here; i += THREADS) dst[s0 + i] = 0;
    }
    __syncthreads();                         // span k staged, zeros ordered
    if (k + 1 < k1 && tid < HALO)
      nxt[PAD - HALO + tid] = buf[PAD + SPAN - HALO + tid];

    const int p0 = tid * PER;
    if (p0 < n_here) {
      const uint32_t* W = (const uint32_t*)buf + p0 / 4;
      // h(p0 - 1) by the closed form over bytes p0-64 .. p0-1 (words 0..15;
      // byte p0-64 sits in the pad and cancels when position p0 rolls)
      uint32_t h = 0;
#pragma unroll
      for (int wd = 0; wd < 16; ++wd) {
        const uint32_t w = W[wd];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = 63 - (4 * wd + m);   // distance back from p0 - 1
          h ^= rotl(look(tl, byte_of(w, m)), k & 31);
        }
      }
      const int valid_from = (hist == nullptr && s0 == 0) ? HALO : 0;
#pragma unroll 3
      for (int q = 0; q < PER / 4; ++q) {
        const uint32_t wn = W[16 + q], wo = W[q];
        uint32_t x[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          h = look(tl, byte_of(wn, m)) ^ look(tl, byte_of(wo, m)) ^ rotl(h, 1);
          x[m] = (h & mask) ^ magic;
        }
        if (__builtin_expect((x[0] == 0) | (x[1] == 0) | (x[2] == 0) |
                             (x[3] == 0), 0)) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int pos = p0 + 4 * q + m;
            if (x[m] == 0 && pos < n_here && pos >= valid_from)
              dst[s0 + pos] = 1;
          }
        }
      }
    }
    __syncthreads();                         // buf free for span k + 2
  }
}

}  // namespace

// data uint8[B, S], hist uint8[B, 63] or null, table uint32[256],
// out uint8[B, S] (0/1).  All device pointers, rows contiguous.  The grid
// is grid_x blocks of `spans` spans of `span` positions along each row and
// one row per grid row (rolling_hash.py::span_partition); `span` must be
// this kernel's SPAN.
extern "C" int rolling_hash_candidate_mask(int device, const void* data,
                                           const void* hist, const void* table,
                                           void* out, int64_t B, int64_t S,
                                           int64_t span, int64_t spans,
                                           int64_t grid_x, uint32_t mask,
                                           uint32_t magic, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || S == 0) return 0;
  if (span != SPAN || spans < 1 || grid_x < 1 || B > 65535 ||
      (grid_x - 1) * spans * SPAN >= S)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (((uintptr_t)data | (uintptr_t)out | (uintptr_t)S) & 15) == 0;
  const dim3 grid((unsigned)grid_x, (unsigned)B);
  if (aligned) {
    e = cudaFuncSetAttribute(candidate_mask_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    candidate_mask_kernel<true><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const uint8_t*)hist, (const uint32_t*)table,
        (uint8_t*)out, S, spans, mask, magic);
  } else {
    e = cudaFuncSetAttribute(candidate_mask_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    candidate_mask_kernel<false><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const uint8_t*)hist, (const uint32_t*)table,
        (uint8_t*)out, S, spans, mask, magic);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rolling_hash_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
