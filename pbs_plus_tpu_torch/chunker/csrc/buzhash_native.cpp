// Native CPU buzhash CDC scan — the fast single-core reference chunker.
//
// The port's own copy of the JAX package's native/buzhash_native.cpp, its
// code byte for byte, kept inside pbs_plus_tpu_torch/ so the agent bundle
// (which packs only this package) carries it.  chunker/native.py builds it
// with g++ at first use into build/torch_native/.  Host code: it is not a
// device kernel.
//
// Implements pbs_plus_tpu_torch/chunker/spec.py: 32-bit buzhash over a sliding
// 64-byte window of the raw stream (no reset at cut points).  With W=64 and
// 32-bit rotations, rotl(x, 64 mod 32) == x, so the rolling recurrence is
//     h = rotl1(h) ^ T[b[i-64]] ^ T[b[i]]
// Candidate at i iff (h & mask) == magic.  Cut selection (min/max greedy)
// stays in Python (shared spec.select_cuts) so all backends share it.
//
// Reference role: the external Go buzhash library used at
// internal/pxarmount/commit_orchestrate.go:144 — this is the CPU-baseline
// equivalent.

// The hash at position i depends ONLY on bytes [i-63, i] (64-byte window,
// position-local recurrence), so the scan parallelizes exactly: segment
// workers seed from the 63 bytes preceding their segment and produce
// bit-identical candidates to a sequential scan — the same halo
// discipline as the segment-parallel chunker (parallel/sp_chunker.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

static inline uint32_t rotl1(uint32_t x) { return (x << 1) | (x >> 31); }

extern "C" {

// Scan `data[0..n)` for candidate end offsets.  `prefix` holds up to 63
// bytes of preceding stream context; `global_offset` is the stream offset
// of data[0].  Writes absolute end offsets; returns count written (stops
// at out_cap — caller sizes generously and retries on overflow).
int64_t pbs_buzhash_candidates(
    const uint8_t* data, int64_t n,
    const uint8_t* prefix, int64_t prefix_len,
    const uint32_t* table, uint32_t mask, uint32_t magic,
    int64_t global_offset,
    int64_t* out_ends, int64_t out_cap) {
  const int64_t W = 64;
  if (prefix_len > W - 1) {
    prefix += prefix_len - (W - 1);
    prefix_len = W - 1;
  }
  // Assemble the warm-up window: last <=63 context bytes + data.
  // Positions are valid once 64 bytes of stream history exist.
  uint8_t win[64];  // ring of the last 64 bytes
  int64_t count = 0;
  uint32_t h = 0;
  int64_t hist = global_offset;  // bytes of stream before data[0]
  if (hist < prefix_len) {
    // more context than stream history: keep the LAST hist bytes (the ones
    // immediately preceding data[0]) — matches the numpy backend
    prefix += prefix_len - hist;
    prefix_len = hist;
  }
  // While the window is not yet full (first 64 rolls) nothing leaves it,
  // so the T[out] term must be suppressed — a zero-initialized ring would
  // otherwise inject T[0] terms that never cancel.
  std::memset(win, 0, sizeof win);
  int64_t rolled = 0;  // total bytes rolled through (context + data)
  for (int64_t j = 0; j < prefix_len; ++j) {
    uint8_t in = prefix[j];
    uint32_t out_term = rolled >= W ? table[win[rolled & 63]] : 0u;
    h = rotl1(h) ^ out_term ^ table[in];
    win[rolled & 63] = in;
    ++rolled;
  }
  for (int64_t i = 0; i < n; ++i) {
    uint8_t in = data[i];
    uint32_t out_term = rolled >= W ? table[win[rolled & 63]] : 0u;
    h = rotl1(h) ^ out_term ^ table[in];
    win[rolled & 63] = in;
    ++rolled;
    // full-window validity: needs 64 bytes of real stream history ending
    // at this position, and all of them rolled through this scan.
    if (global_offset + i >= W - 1 && rolled >= W && (h & mask) == magic) {
      if (count >= out_cap) return -1;
      out_ends[count++] = global_offset + i + 1;
    }
  }
  return count;
}

// Multi-threaded scan: bit-identical to the sequential scan (the hash is
// position-local), segments seeded with the 63 bytes preceding them.
// `threads <= 0` → hardware concurrency.  Returns total candidates or -1
// if any worker overflowed its share of `out_ends` (caller retries with a
// bigger buffer, as with the single-threaded entry).
int64_t pbs_buzhash_candidates_mt(
    const uint8_t* data, int64_t n,
    const uint8_t* prefix, int64_t prefix_len,
    const uint32_t* table, uint32_t mask, uint32_t magic,
    int64_t global_offset,
    int64_t* out_ends, int64_t out_cap,
    int threads) {
  const int64_t W = 64;
  const int64_t MIN_SEG = 1 << 20;
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = hc ? static_cast<int>(hc) : 1;
  }
  int64_t max_t = n / MIN_SEG;
  if (max_t < static_cast<int64_t>(threads)) threads = static_cast<int>(max_t);
  if (threads <= 1) {
    return pbs_buzhash_candidates(data, n, prefix, prefix_len, table, mask,
                                  magic, global_offset, out_ends, out_cap);
  }
  const int64_t seg = n / threads;
  const int64_t cap_each = out_cap / threads;
  if (cap_each <= 0) return -1;
  std::vector<std::vector<int64_t>> outs(threads);
  std::vector<int64_t> counts(threads, 0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    const int64_t a = t * seg;
    const int64_t b = (t == threads - 1) ? n : a + seg;
    outs[t].resize(cap_each);
    pool.emplace_back([&, t, a, b]() {
      const uint8_t* seg_prefix;
      int64_t seg_prefix_len;
      if (a == 0) {
        seg_prefix = prefix;
        seg_prefix_len = prefix_len;
      } else {
        // halo: the 63 bytes of stream immediately before data[a]
        seg_prefix_len = a < (W - 1) ? a : (W - 1);
        seg_prefix = data + a - seg_prefix_len;
        // (if a < 63 the caller prefix would also matter, but MIN_SEG
        // guarantees a >= 1 MiB for every non-first segment)
      }
      counts[t] = pbs_buzhash_candidates(
          data + a, b - a, seg_prefix, seg_prefix_len, table, mask, magic,
          global_offset + a, outs[t].data(), cap_each);
    });
  }
  for (auto& th : pool) th.join();
  int64_t total = 0;
  for (int t = 0; t < threads; ++t) {
    if (counts[t] < 0) return -1;
    total += counts[t];
  }
  if (total > out_cap) return -1;
  int64_t pos = 0;
  for (int t = 0; t < threads; ++t) {
    std::memcpy(out_ends + pos, outs[t].data(),
                counts[t] * sizeof(int64_t));
    pos += counts[t];
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Vectorized (SIMD-style) scan: the shift/rotate/XOR doubling formulation
// from pbs_plus_tpu/ops/rolling_hash.py ported to CPU vectors:
//
//     H_1(i)    = T[b[i]]
//     H_{2m}(i) = H_m(i) ^ rotl_{m mod 32}(H_m(i-m))
//
// The classic rolling recurrence above is a 3-instruction dependency chain
// per byte — no ILP, no SIMD.  The doubling form has NO serial dependency:
// every position's window hash falls out of log2(W)=6 data-parallel passes
// over an L1-resident block (the vectorized-CDC reformulation of
// arXiv:2508.05797 / arXiv:2505.21194).  The AVX-512 path does the table
// lookup as the same nibble decomposition the TPU kernel uses
// (T[x] = A[x>>4] ^ B[x&15], chunker/spec.py): two 16-entry vpermd
// permutes replace the 256-entry gather — the CPU-register analog of the
// device kernel's 32 unrolled selects — and vprold does each rotate in one
// instruction.  The generic path is plain C the compiler auto-vectorizes.
// Bit parity with pbs_buzhash_candidates is enforced by
// tests/test_vector_chunker.py and in-run by bench.py.

namespace {

const int64_t VEC_BLK = 4096;   // block (+63 halo) keeps both u32 ping-pong
                                // buffers L1-resident

// Derive the A/B nibble subtables from the materialized 256-entry table
// (any consistent gauge works: A[i] ^= c, B[j] ^= c cancels).  Returns
// false when the table is not nibble-decomposable — only then the AVX-512
// gather is skipped; spec tables always decompose by construction.
bool derive_subtables(const uint32_t* table, uint32_t* a16, uint32_t* b16) {
  for (int j = 0; j < 16; ++j) b16[j] = table[j];
  for (int i = 0; i < 16; ++i) a16[i] = table[i << 4] ^ table[0];
  for (int x = 0; x < 256; ++x)
    if ((a16[x >> 4] ^ b16[x & 15]) != table[x]) return false;
  return true;
}

// scalar closed form h(j) = XOR_{k=0}^{63} rotl(T[in[j-k]], k mod 32) for
// the <16-position ragged tail of the final block (needs j >= 63).
inline uint32_t closed_form_hash(const uint8_t* in, int64_t j,
                                 const uint32_t* table) {
  uint32_t h = 0;
  for (int k = 0; k < 64; ++k) {
    uint32_t t = table[in[j - k]];
    const int r = k & 31;
    h ^= r ? ((t << r) | (t >> (32 - r))) : t;
  }
  return h;
}

#if defined(__AVX512F__)

// Fully register-fused pipeline: all six doubling levels chained through
// valignd lane shifts, so intermediate hash levels never touch memory —
// per 16 bytes: one 16-byte load, two vpermd subtable lookups, five
// vprold rotates, and a vpcmpeqd candidate mask.  History registers carry
// each level's previous vector across steps; zero-seeded history corrupts
// at most the first 1+2+4+8+16+32 = 63 positions of a block, which the
// >= 64-position validity floor masks by construction.
struct FusedState {
  __m512i t_p, h2_p, h4_p, h8_p, h16_p, h32_p1, h32_p2;
  void reset() {
    t_p = h2_p = h4_p = h8_p = h16_p = h32_p1 = h32_p2 =
        _mm512_setzero_si512();
  }
};

struct FusedConsts {
  __m512i va, vb, v15, vm, vg;
};

static inline __mmask16 fused_step(const uint8_t* in, int64_t j,
                                   FusedState& st, const FusedConsts& c) {
  __m128i bytes = _mm_loadu_si128((const __m128i*)(in + j));
  __m512i w = _mm512_cvtepu8_epi32(bytes);
  __m512i t = _mm512_xor_si512(
      _mm512_permutexvar_epi32(_mm512_srli_epi32(w, 4), c.va),
      _mm512_permutexvar_epi32(_mm512_and_si512(w, c.v15), c.vb));
  __m512i h2 = _mm512_xor_si512(
      t, _mm512_rol_epi32(_mm512_alignr_epi32(t, st.t_p, 15), 1));
  __m512i h4 = _mm512_xor_si512(
      h2, _mm512_rol_epi32(_mm512_alignr_epi32(h2, st.h2_p, 14), 2));
  __m512i h8 = _mm512_xor_si512(
      h4, _mm512_rol_epi32(_mm512_alignr_epi32(h4, st.h4_p, 12), 4));
  __m512i h16 = _mm512_xor_si512(
      h8, _mm512_rol_epi32(_mm512_alignr_epi32(h8, st.h8_p, 8), 8));
  __m512i h32 = _mm512_xor_si512(h16, _mm512_rol_epi32(st.h16_p, 16));
  __m512i h64 = _mm512_xor_si512(h32, st.h32_p2);
  st.t_p = t; st.h2_p = h2; st.h4_p = h4; st.h8_p = h8; st.h16_p = h16;
  st.h32_p2 = st.h32_p1; st.h32_p1 = h32;
  return _mm512_cmpeq_epi32_mask(_mm512_and_si512(h64, c.vm), c.vg);
}

// one block [s, e) through the fused pipeline with direct emission —
// handles the irregular cases (stream head, validity floor, ragged tail).
int64_t fused_block(const uint8_t* in, int64_t len, int64_t first_j,
                    const uint32_t* table, uint32_t mask, uint32_t magic,
                    int64_t abs0, const FusedConsts& c,
                    int64_t* out, int64_t cap, int64_t count) {
  FusedState st;
  st.reset();
  const int64_t len16 = len & ~(int64_t)15;
  for (int64_t j = 0; j < len16; j += 16) {
    __mmask16 k = fused_step(in, j, st, c);
    if (j + 15 < first_j) continue;
    if (j < first_j) k &= (__mmask16)(0xFFFFu << (first_j - j));
    while (k) {
      const int bit = __builtin_ctz((unsigned)k);
      k = (__mmask16)(k & (k - 1));
      if (count >= cap) return -1;
      out[count++] = abs0 + j + bit;
    }
  }
  // ragged tail (final block only): scalar closed form
  for (int64_t j = first_j > len16 ? first_j : len16; j < len; ++j)
    if ((closed_form_hash(in, j, table) & mask) == magic) {
      if (count >= cap) return -1;
      out[count++] = abs0 + j;
    }
  return count;
}

int64_t scan_avx_fused(const uint8_t* data, int64_t n,
                       const uint8_t* prefix, int64_t prefix_len,
                       const uint32_t* table,
                       const uint32_t* a16, const uint32_t* b16,
                       uint32_t mask, uint32_t magic, int64_t global_offset,
                       int64_t iv, int64_t* out, int64_t cap) {
  FusedConsts c;
  c.va = _mm512_loadu_si512((const void*)a16);
  c.vb = _mm512_loadu_si512((const void*)b16);
  c.v15 = _mm512_set1_epi32(15);
  c.vm = _mm512_set1_epi32((int)mask);
  c.vg = _mm512_set1_epi32((int)magic);
  uint8_t head[VEC_BLK + 64];
  int64_t count = 0;
  int64_t s = 0;
  // stream head: zero-pad + clamped prefix so the halo is exactly 64
  // bytes (keeps the block length a multiple of 16); pad bytes only
  // reach windows below the validity floor.  Also used when iv pushes
  // the validity floor into the first block (tiny global_offset).
  {
    const int64_t e = VEC_BLK < n ? VEC_BLK : n;
    std::memset(head, 0, (size_t)(64 - prefix_len));
    if (prefix_len)
      std::memcpy(head + 64 - prefix_len, prefix, (size_t)prefix_len);
    std::memcpy(head + 64, data, (size_t)e);
    int64_t first_j = 64 + iv;
    if (first_j < 64 + e) {
      count = fused_block(head, 64 + e, first_j, table, mask, magic,
                          global_offset - 64 + 1, c, out, cap, count);
      if (count < 0) return -1;
    }
    s = e;
  }
  // steady state: two independent segments interleaved per iteration —
  // the six-level fuse is a ~25-cycle dependency chain per step, and two
  // chains overlap where one would stall.  Candidate masks are buffered
  // per segment (they are ~1-per-avg_size sparse) and decoded in segment
  // order afterwards, so emission stays sorted.
  const int64_t STEPS = (64 + VEC_BLK) / 16;
  uint16_t mk_a[STEPS], mk_b[STEPS];
  while (n - s >= 2 * VEC_BLK) {
    const uint8_t* in_a = data + s - 64;
    const uint8_t* in_b = data + s + VEC_BLK - 64;
    FusedState sa, sb;
    sa.reset();
    sb.reset();
    for (int64_t it = 0; it < STEPS; ++it) {
      mk_a[it] = (uint16_t)fused_step(in_a, it * 16, sa, c);
      mk_b[it] = (uint16_t)fused_step(in_b, it * 16, sb, c);
    }
    // decode in order; iterations 0..3 are the halo (j < 64), invalid
    for (int seg = 0; seg < 2; ++seg) {
      const uint16_t* mk = seg ? mk_b : mk_a;
      const int64_t abs0 =
          global_offset + (s + seg * VEC_BLK) - 64 + 1;
      for (int64_t it = 4; it < STEPS; ++it) {
        unsigned k = mk[it];
        while (k) {
          const int bit = __builtin_ctz(k);
          k &= k - 1;
          if (count >= cap) return -1;
          out[count++] = abs0 + it * 16 + bit;
        }
      }
    }
    s += 2 * VEC_BLK;
  }
  // remaining single blocks (including the ragged final one)
  for (; s < n; s += VEC_BLK) {
    const int64_t e = s + VEC_BLK < n ? s + VEC_BLK : n;
    count = fused_block(data + s - 64, 64 + (e - s), 64, table, mask,
                        magic, global_offset + s - 64 + 1, c,
                        out, cap, count);
    if (count < 0) return -1;
  }
  return count;
}

#endif  // __AVX512F__

// generic block pipeline: gather + 6 doubling passes + stripe-accumulated
// candidate check, all in shapes gcc/clang auto-vectorize.
int64_t vec_block_generic(const uint8_t* in, int64_t len, int64_t first_j,
                          const uint32_t* table, uint32_t mask,
                          uint32_t magic, int64_t abs0,
                          uint32_t* ha, uint32_t* hb,
                          int64_t* out, int64_t cap, int64_t count) {
  for (int64_t i = 0; i < len; ++i) ha[i] = table[in[i]];
  const uint32_t* a = ha;
  uint32_t* b = hb;
  for (int m = 1; m < 64; m <<= 1) {
    const int r = m & 31;
    for (int64_t i = 0; i < m && i < len; ++i) b[i] = a[i];
    if (r) {
      for (int64_t i = m; i < len; ++i)
        b[i] = a[i] ^ ((a[i - m] << r) | (a[i - m] >> (32 - r)));
    } else {
      for (int64_t i = m; i < len; ++i) b[i] = a[i] ^ a[i - m];
    }
    const uint32_t* t = a;
    a = b;
    b = const_cast<uint32_t*>(t);
  }
  for (int64_t j = first_j; j < len; j += 64) {
    int64_t hi = j + 64 < len ? j + 64 : len;
    uint32_t acc = 0;
    for (int64_t k = j; k < hi; ++k) acc |= ((a[k] & mask) == magic);
    if (acc) {
      for (int64_t k = j; k < hi; ++k)
        if ((a[k] & mask) == magic) {
          if (count >= cap) return -1;
          out[count++] = abs0 + k;
        }
    }
  }
  return count;
}

}  // namespace

extern "C" {

// 2 = AVX-512 (vpermd nibble lookup + vprold passes), 1 = generic
// auto-vectorized blocks.  Compile-time: the library is built on the host
// that runs it (chunker/native.py builds on demand with -march=native).
int pbs_buzhash_vec_impl(void) {
#if defined(__AVX512F__)
  return 2;
#else
  return 1;
#endif
}

// Vectorized scan, bit-identical to pbs_buzhash_candidates (same prefix
// clamping, validity, and output contract; -1 on out_ends overflow).
int64_t pbs_buzhash_candidates_vec(
    const uint8_t* data, int64_t n,
    const uint8_t* prefix, int64_t prefix_len,
    const uint32_t* table, uint32_t mask, uint32_t magic,
    int64_t global_offset,
    int64_t* out_ends, int64_t out_cap) {
  const int64_t W = 64;
  if (prefix_len > W - 1) {
    prefix += prefix_len - (W - 1);
    prefix_len = W - 1;
  }
  if (global_offset < prefix_len) {
    prefix += prefix_len - global_offset;
    prefix_len = global_offset;
  }
  if (n <= 0) return 0;
  uint32_t a16[16], b16[16];
  const bool nib = derive_subtables(table, a16, b16);
  (void)nib;  // consumed by the AVX-512 gather only
  // first data index whose 64-byte window is fully inside real stream
  // history (prefix side AND stream side — the numpy backend's validity)
  int64_t iv = W - 1 - prefix_len;
  if (W - 1 - global_offset > iv) iv = W - 1 - global_offset;
  if (iv < 0) iv = 0;
#if defined(__AVX512F__)
  if (nib)
    return scan_avx_fused(data, n, prefix, prefix_len, table, a16, b16,
                          mask, magic, global_offset, iv,
                          out_ends, out_cap);
#endif
  int64_t count = 0;
  alignas(64) uint32_t ha[VEC_BLK + 64 + 16];
  alignas(64) uint32_t hb[VEC_BLK + 64 + 16];
  uint8_t head[VEC_BLK + 64];
  for (int64_t s = 0; s < n; s += VEC_BLK) {
    const int64_t e = s + VEC_BLK < n ? s + VEC_BLK : n;
    const uint8_t* in;
    int64_t halo;
    if (s >= W - 1) {
      halo = W - 1;             // context comes straight from data
      in = data + s - halo;
    } else {
      // first block (VEC_BLK > W ⇒ only s == 0): splice the clamped
      // prefix context ahead of the block body
      halo = prefix_len;
      if (halo) std::memcpy(head, prefix, (size_t)halo);
      std::memcpy(head + halo, data, (size_t)e);
      in = head;
    }
    const int64_t len = halo + (e - s);
    int64_t first_j = halo + (iv - s);
    if (first_j < W - 1) first_j = W - 1;
    if (first_j >= len) continue;
    // candidate end offset for local position j is abs0 + j
    const int64_t abs0 = global_offset + s - halo + 1;
    count = vec_block_generic(in, len, first_j, table, mask, magic, abs0,
                              ha, hb, out_ends, out_cap, count);
    if (count < 0) return -1;
  }
  return count;
}

}  // extern "C"
