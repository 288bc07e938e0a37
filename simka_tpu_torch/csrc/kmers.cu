// Canonical k-mer extraction of one ingest batch (Hopper, sm_90a).
//
// Replaces simka_tpu/core/pipeline.py::_extract_windows_program (one
// fused XLA program a batch: simka_tpu/ops/kmers.py::extract_packed,
// extract_canonical_kmers and _multi, kmer_shannon_index_words, the
// mix_hash repartition histogram) and, in the port, the torch ops of
// ops/kmers.py that ran it: unpack_codes, canonical_kmers (one [B, W]
// int64 tensor a shift), kmer_shannon_index_words, uint32_words +
// mix_hash_words + bincount. For window e = b * Wk + p of a [B, L]
// batch (Wk = L - k + 1), in one pass:
//
//   words[w][e] = word w (most significant first) of the canonical
//                 k-mer: 31-base (62-bit) int64 words, the lexicographic
//                 min of the forward k-mer and its reverse complement
//                 (complement = code ^ comp_xor: 3 for simka's A/C/G/T
//                 codes, 2 for gatb-core's A/C/T/G), ties to forward;
//   keep[e]     = every base valid and, with a threshold, the Shannon
//                 index of the canonical k-mer >= the threshold;
//   counts[0..15] += kept windows a bucket of mix_hash over the
//                 reference's big-endian uint32 words (uint32_words:
//                 one extra leading word when 2k is a multiple of 32
//                 and k > 31), with the histogram on;
//   counts[16]  = kept windows.
//
// An invalid base reads as code 3, as the plain version's `codes & 3`
// of its 255, so the words are the plain version's bit for bit on every
// window, kept or not. The Shannon index is summed left to right in
// f32, terms[c0] + terms[c1] + terms[c2] + terms[c3] over the host-made
// table (ops/kmers.py::shannon_terms), then fabsf: adds only, so no
// contraction to FMA can change it, and the build has no fast-math.
//
// Its bound: device-memory bandwidth. A window reads a quarter
// byte of codes and an eighth of validity and writes 8 B a word and
// 1 B of mask: at phase 7's batch (2^17 reads x 104 slots, k = 21,
// 11,010,048 windows) 5.1 MB in and 99.1 MB out, 0.031 ms at 3.35
// TB/s. This form takes 0.73 ms there on an H100 (chip_smoke.py phase
// 15b): its instructions hold it, about 2k base reads a window (shared
// by L1) and a few integer instructions a base.
//
// This first form is a thread a window with no carry between windows:
// a per-window Horner over the window's bases, read from the packed
// bytes through L1 (neighbouring windows share every byte), once in
// forward order and once in reverse for the complement. A base never
// straddles two 62-bit words, so each word is its own Horner over its
// own offsets. The word count is a template parameter, so the words of
// both strands stay in registers. Grid-stride; the histogram and the
// kept total gather in shared memory a block and go out with one
// integer atomic a bucket: exact, the same on every run.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs and the stream; the entry point returns
// the first cudaError_t of its memset and launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kWordBases = 31;
constexpr int kMaxK = 127;
constexpr int kBuckets = 16;

struct Batch {
  const uint8_t* packed;     // [B, L/4] 2-bit codes, or null
  const uint8_t* validbits;  // [B, L/8] validity bits (with packed)
  const uint8_t* codes;      // [B, L] codes, 255 invalid (without packed)
  int64_t L;
};

// base `pos` of row `row`: its code, 3 where invalid (and `bad` set)
template <bool kPacked>
__device__ __forceinline__ uint32_t base_at(const Batch& in, int64_t row,
                                            int64_t pos, bool& bad) {
  if (kPacked) {
    const uint32_t byte = __ldg(in.packed + row * (in.L >> 2) + (pos >> 2));
    const uint32_t vbit =
        (__ldg(in.validbits + row * (in.L >> 3) + (pos >> 3)) >> (pos & 7)) &
        1u;
    if (!vbit) {
      bad = true;
      return 3u;
    }
    return (byte >> (2 * (pos & 3))) & 3u;
  }
  const uint32_t c = __ldg(in.codes + row * in.L + pos);
  if (c >= 4u) bad = true;
  return c & 3u;
}

__device__ __forceinline__ uint32_t mix_hash(uint32_t hi, uint32_t lo) {
  uint32_t h = (hi ^ 0x9E3779B9u) * 0x85EBCA6Bu;
  h ^= h >> 13;
  h = (h ^ lo) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// the reference's uint32 words of the k-mer `o` (port words, most
// significant first), folded through mix_hash most significant first
template <int NW>
__device__ __forceinline__ uint32_t repartition_hash(const uint64_t (&o)[NW],
                                                     int n32) {
  // uint32 words from the bottom: bits [32 i, 32 i + 32) of the value
  constexpr int kMax32 = (2 * kWordBases * NW + 31) / 32 + 1;
  uint32_t u[kMax32];
#pragma unroll
  for (int i = 0; i < kMax32; ++i) {
    const int j = (32 * i) / (2 * kWordBases);  // port word from the bottom
    const int ob = (32 * i) % (2 * kWordBases);
    uint64_t v = 0;
    if (j < NW) v = o[NW - 1 - j] >> ob;
    if (j + 1 < NW) v |= o[NW - 2 - j] << (2 * kWordBases - ob);
    u[i] = (uint32_t)v;
  }
  uint32_t h = 0;
#pragma unroll
  for (int i = kMax32 - 1; i >= 0; --i) {
    if (i == n32 - 1) h = u[i];
    else if (i < n32 - 1) h = mix_hash(h, u[i]);
  }
  return h;
}

template <int NW, bool kPacked>
__global__ void __launch_bounds__(kThreads)
extract_kmers(Batch in, int64_t E, int64_t Wk, int k, uint32_t comp_xor,
              int use_thr, float thr, const float* __restrict__ terms,
              int with_hist, int n32, uint64_t* __restrict__ words,
              uint8_t* __restrict__ keep,
              unsigned long long* __restrict__ counts) {
  __shared__ float s_terms[kMaxK + 1];
  __shared__ unsigned long long s_hist[kBuckets];
  __shared__ unsigned long long s_kept[kThreads / 32];
  if (use_thr)
    for (int i = threadIdx.x; i <= k; i += kThreads) s_terms[i] = terms[i];
  if (threadIdx.x < kBuckets) s_hist[threadIdx.x] = 0;
  __syncthreads();

  const int top = k - kWordBases * (NW - 1);  // bases of the top word
  unsigned long long kept = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < E;
       e += stride) {
    const int64_t row = e / Wk;
    const int64_t p = e - row * Wk;
    bool bad = false;
    uint32_t fcnt = 0;  // forward base counts, 8 bits a code (k <= 127)
    uint64_t f[NW], r[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      // word w spans window offsets [lo, hi), most significant first
      const int hi = top + kWordBases * w;
      const int lo = w == 0 ? 0 : hi - kWordBases;
      uint64_t v = 0;
      for (int i = lo; i < hi; ++i) {
        const uint32_t c = base_at<kPacked>(in, row, p + i, bad);
        v = (v << 2) | c;
        fcnt += 1u << (8 * c);
      }
      f[w] = v;
    }
    // the reverse complement reads comp(base[k - 1 - j]) at offset j
    bool unused = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int hi = top + kWordBases * w;
      const int lo = w == 0 ? 0 : hi - kWordBases;
      uint64_t v = 0;
      for (int j = lo; j < hi; ++j)
        v = (v << 2) |
            (base_at<kPacked>(in, row, p + k - 1 - j, unused) ^ comp_xor);
      r[w] = v;
    }
    // lexicographic min, ties to forward
    bool take_fwd = true, decided = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (!decided && f[w] != r[w]) {
        take_fwd = f[w] < r[w];
        decided = true;
      }
    }
    uint64_t o[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      o[w] = take_fwd ? f[w] : r[w];
      words[(int64_t)w * E + e] = o[w];
    }
    bool ok = !bad;
    if (use_thr) {
      // the canonical k-mer's base counts: the complement strand holds
      // code c as many times as the forward one holds c ^ comp_xor
      const uint32_t x = take_fwd ? 0u : comp_xor;
      float s = s_terms[(fcnt >> (8 * (0u ^ x))) & 0xffu];
      s = s + s_terms[(fcnt >> (8 * (1u ^ x))) & 0xffu];
      s = s + s_terms[(fcnt >> (8 * (2u ^ x))) & 0xffu];
      s = s + s_terms[(fcnt >> (8 * (3u ^ x))) & 0xffu];
      ok = ok && fabsf(s) >= thr;
    }
    keep[e] = ok ? 1 : 0;
    if (ok) {
      ++kept;
      if (with_hist)
        atomicAdd(&s_hist[repartition_hash<NW>(o, n32) & (kBuckets - 1)],
                  1ULL);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, o);
  if (threadIdx.x % 32 == 0) s_kept[threadIdx.x / 32] = kept;
  __syncthreads();
  if (threadIdx.x < kBuckets && s_hist[threadIdx.x])
    atomicAdd(&counts[threadIdx.x], s_hist[threadIdx.x]);
  if (threadIdx.x == 0) {
    unsigned long long b = 0;
    for (int j = 0; j < kThreads / 32; ++j) b += s_kept[j];
    if (b) atomicAdd(&counts[kBuckets], b);
  }
}

template <int NW>
cudaError_t launch(bool packed, const Batch& in, int64_t E, int64_t Wk,
                   int k, int comp_xor, int use_thr, float thr,
                   const float* terms, int with_hist, int n32,
                   uint64_t* words, uint8_t* keep, unsigned long long* counts,
                   cudaStream_t stream) {
  int64_t blocks = (E + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (packed)
    extract_kmers<NW, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, E, Wk, k, (uint32_t)comp_xor, use_thr, thr, terms, with_hist,
        n32, words, keep, counts);
  else
    extract_kmers<NW, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, E, Wk, k, (uint32_t)comp_xor, use_thr, thr, terms, with_hist,
        n32, words, keep, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// packed [B, L/4] + validbits [B, L/8] (L a multiple of 8), or codes
// [B, L] uint8 (packed null); 1 <= k <= min(127, L); comp_xor 3 or 2;
// use_thr: keep only Shannon index >= thr, terms the [k + 1] f32 table
// (may be null without use_thr); with_hist: the repartition histogram;
// n32: the reference's uint32 words of a k-mer. words: [n_words(k), E]
// int64 (E = B * (L - k + 1)); keep: [E] bool; counts: uint64 [17],
// zeroed here, ends holding the 16 buckets (zero without with_hist) and
// the kept total. Returns a cudaError_t code (0 on success).
int simka_extract_kmers(const uint8_t* packed, const uint8_t* validbits,
                        const uint8_t* codes, int64_t B, int64_t L, int k,
                        int comp_xor, int use_thr, float thr,
                        const float* terms, int with_hist, int n32,
                        uint64_t* words, uint8_t* keep, uint64_t* counts,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxK || L < k || B < 0 || (packed && L % 8 != 0) ||
      (use_thr && !terms))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (kBuckets + 1) * sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t Wk = L - k + 1;
  const int64_t E = B * Wk;
  if (E == 0) return (int)cudaSuccess;
  const Batch in{packed, validbits, codes, L};
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const bool pk = packed != nullptr;
  switch ((k + kWordBases - 1) / kWordBases) {
    case 1:
      return (int)launch<1>(pk, in, E, Wk, k, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    case 2:
      return (int)launch<2>(pk, in, E, Wk, k, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    case 3:
      return (int)launch<3>(pk, in, E, Wk, k, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    case 4:
      return (int)launch<4>(pk, in, E, Wk, k, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    default:
      return (int)launch<5>(pk, in, E, Wk, k, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
  }
}

}  // extern "C"
