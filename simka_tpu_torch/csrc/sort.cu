// The join's sort of packed (k-mer, sample) keys: a keys-only LSD radix
// sort over the key's used bits, with the key built in its first pass
// (Hopper, sm_90a).
//
// Replaces the sort of the reference's join, XLA's lax.sort of the packed
// keys in simka_tpu/ops/countjoin.py::_rows_from_instances, which the
// port ran as torch.sort((word << sbits) | sid).values in
// ops/countjoin.py::solid_rows. On CUDA torch.sort sorts (key, int64
// index) pairs over all 64 bits with cub's onesweep: 8 passes of 32 B a
// key, an arange of indices built and its sorted copy thrown away, and
// the key, its shift and its widened sample id built by three elementwise
// kernels first. At the benchmark's 484 M keys that is ~124 GB a sort
// (65 ms on an H100, the key's build included) and, with cub's alternate
// buffers, 27 GiB live.
//
// The key (word << sbits) | sid uses bits = kmer_bits + sbits bits (45 at
// k = 21, N = 5), every key is below 2^bits, and equal keys are equal
// rows, so neither an index nor the top bits need sorting. The design:
//
//   RadixSortHistogram  one read of words and sample ids (12 B a key with
//                       an int32 id): each key formed in registers, and its
//                       digit of every pass counted in shared memory. It
//                       also zeroes the passes' status words.
//   RadixSortScan       one CTA: each pass's digit offsets from those
//                       counts.
//   RadixSortOnesweep   one launch a digit (and portion, below): as few
//                       digits of at most 8 bits as cover [0, bits)
//                       (ops/sort.py::radix_passes; 6 at 45 bits). A CTA
//                       claims a tile of kTile keys from an atomic ticket,
//                       so every tile it waits on is held by a running
//                       CTA. Warp w loads its 32 x kItems keys warp-striped
//                       (each load one coalesced 256-B row of the warp; the
//                       first pass loads the int64 words and the sample ids
//                       and forms the key); counts them by digit in shared
//                       memory and publishes the tile's count of each digit
//                       at once; then puts each key in its slot in a copy
//                       of the tile in digit order in shared memory (its
//                       peers in the warp's step from one shared word a
//                       digit that the step's lanes OR their bits into,
//                       the warp's next slot of the digit in shared memory:
//                       a stable order with no ballots); thread d then
//                       looks back over the earlier tiles' status words
//                       for digit d's exclusive prefix (decoupled
//                       look-back, kLook words in flight) and the tile's
//                       keys go out from shared memory in runs of
//                       consecutive addresses, one per digit present. The
//                       later passes run a persistent grid, each CTA
//                       taking tickets until none is left; the first pass,
//                       whose loads hold 1.5x the registers, one tile a
//                       CTA (a persistent loop there took 7.4 ms at 484 M
//                       keys, against 4.0).
//
// Keys only: two key buffers ping-pong (pass 0 writes keys0 from the words
// and sample ids; the sorted keys end in keys[(passes - 1) % 2]), and the
// only scratch is a 32-bit status word a tile and digit and the small
// histograms. A status word holds an epoch bit (the pass's parity), a
// flag (the tile's count published, or its inclusive prefix) and a
// 29-bit count: every pass rewrites every word, so a word of the last
// pass is told apart by its epoch and the words are zeroed once a sort.
// Prefixes are counted inside portions of at most 2^29 - 1 keys, one
// launch a portion (as cub does; more than one only past 536 M keys): a
// portion's rows of digit d start at its base, the scan's offset for the
// first portion, and for the next one the base plus the portion's count,
// which the portion's last tile writes from its inclusive prefix.
//
// What bounds it: device-memory bandwidth. The yardstick's bound is a
// sort of 8-byte keys, 16 B a key; this design moves 12 B a key in the
// histogram, 12 in and 8 out in the first pass, 16 in each later pass and
// 1 KB of status words a tile (45 bits: 112 B a key, 54 GB and 16.2 ms at
// 3.35 TB/s for 484 M keys). Measured there (NVIDIA H100 80GB HBM3, 700
// W): the histogram near a device copy's rate, a later pass at ~78% of
// it; a tile's time goes to its loads, its slots, its look-back and its
// stores in about equal parts (PERF.md section 6). Stability across
// passes needs each tile's keys ranked in index order, which is why the
// loads are 8-byte warp rows, not 16-byte vectors that would hand a lane
// two neighbouring keys.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the two key buffers, the status words, the small
// scratch and the stream; the entry point returns the first cudaError_t
// of its memset, queries and launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps; thread d takes digit d's bin
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kMaxPasses = 8;  // 63 bits / 8
// keys a thread: 6144-key tiles, two CTAs an SM in 128 registers (16 and
// 20 keys, three CTAs an SM, measured slower, and 16 keys' status words
// pass 1% of the sort's memory)
constexpr int kItems = 24;
constexpr int kTile = kThreads * kItems;
constexpr int kWarpKeys = 32 * kItems;
constexpr int kHistUnroll = 4;  // keys a thread has in flight (histogram)
constexpr int kLook = 8;  // status words a look-back has in flight

// status word: epoch bit, flags, count
constexpr uint32_t kEpoch = 1u << 31;
constexpr uint32_t kFlagP = 1u << 30;  // inclusive prefix published
constexpr uint32_t kFlagA = 1u << 29;  // tile count published
constexpr uint32_t kCountMask = kFlagA - 1;
constexpr int64_t kPortionTiles = (int64_t)kCountMask / kTile;

static_assert(kThreads == kBins, "one digit a thread");

struct Plan {
  int n;
  int shift[kMaxPasses];
  int width[kMaxPasses];
};

// The flag and the count share a word, so it needs no ordering against
// any other access: relaxed stores and loads at gpu scope.
__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// key i: (word << sbits) | sid, the sample id an int or a long long
template <typename S>
__device__ __forceinline__ uint64_t packed_key(const long long* words,
                                               const S* sid, int sbits,
                                               int64_t i) {
  return ((uint64_t)__ldg(words + i) << sbits) | (uint64_t)__ldg(sid + i);
}

__device__ __forceinline__ uint32_t digit(uint64_t key, int shift,
                                          uint32_t mask) {
  return (uint32_t)(key >> shift) & mask;
}

// hist[p][d]: the keys whose pass-p digit is d. Each CTA counts a strided
// share of the keys in shared memory and adds it once. The whole grid
// zeroes the status words first.
template <typename S>
__global__ void __launch_bounds__(kThreads)
RadixSortHistogram(const long long* __restrict__ words,
                   const S* __restrict__ sid, int sbits, int64_t E,
                   const __grid_constant__ Plan plan,
                   unsigned long long* __restrict__ hist,
                   uint4* __restrict__ status, int64_t n_status4) {
  __shared__ uint32_t s_hist[kMaxPasses][kBins];
  for (int j = threadIdx.x; j < kMaxPasses * kBins; j += kThreads)
    (&s_hist[0][0])[j] = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       j < n_status4; j += stride)
    status[j] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads * kHistUnroll +
                    threadIdx.x;
       i0 < E; i0 += stride * kHistUnroll) {
    uint64_t k[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      k[u] = i < E ? packed_key(words, sid, sbits, i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (i0 + u * kThreads >= E) break;
      for (int p = 0; p < plan.n; ++p)
        atomicAdd(&s_hist[p][digit(k[u], plan.shift[p],
                                   (1u << plan.width[p]) - 1)],
                  1u);
    }
  }
  __syncthreads();
  for (int p = 0; p < plan.n; ++p) {
    const uint32_t c = s_hist[p][threadIdx.x];
    if (c) atomicAdd(&hist[p * kBins + threadIdx.x], (unsigned long long)c);
  }
}

// One CTA, thread d: base[p][d] = the keys whose pass-p digit is below d
// (the first portion's bases; base[p] is [portions][kBins]).
__global__ void __launch_bounds__(kBins)
RadixSortScan(const unsigned long long* __restrict__ hist, int n_passes,
              int64_t n_portions, unsigned long long* __restrict__ base) {
  __shared__ unsigned long long s_warp[kBins / 32];
  const int d = threadIdx.x, lane = d % 32, warp = d / 32;
  for (int p = 0; p < n_passes; ++p) {
    const unsigned long long count = hist[p * kBins + d];
    unsigned long long x = count;  // inclusive scan over the digits
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    unsigned long long excl = x - count;
    for (int w = 0; w < warp; ++w) excl += s_warp[w];
    base[p * n_portions * kBins + d] = excl;
    __syncthreads();  // s_warp is rewritten by the next pass
  }
}

// Thread d: the keys of digit d in the portion's tiles before `tile`
// (decoupled look-back over their status words, kLook in flight at a
// time, back to the nearest inclusive prefix).
__device__ __forceinline__ int64_t look_back(const uint32_t* status,
                                             int64_t tile, int64_t tile_first,
                                             int d, uint32_t epoch) {
  int64_t prefix = 0;
  for (int64_t t = tile - 1;;) {
    uint32_t v[kLook];
#pragma unroll
    for (int j = 0; j < kLook; ++j)
      v[j] = t - j >= tile_first ? ld_relaxed(status + (t - j) * kBins + d)
                                 : epoch | kFlagP;
    int used = 0;  // the ready words before the first that is not
#pragma unroll
    for (int j = 0; j < kLook; ++j) {
      if ((v[j] & kEpoch) != epoch || !(v[j] & (kFlagA | kFlagP))) break;
      prefix += v[j] & kCountMask;
      ++used;
      if (v[j] & kFlagP) return prefix;
    }
    t -= used;
  }
}

// One digit pass over the portion's n_tiles tiles tile_first + a ticket
// from `ticket`: keys from `src`, or, in the first pass (S, the sample
// id's type, not void), formed from `words` and `sid`; out to `dst`.
// `base`: the portion's [kBins] bases; `base_next`: the next portion's,
// written by the last tile, or null; `epoch`: kEpoch or 0, the pass's
// parity.
template <typename S>
__global__ void __launch_bounds__(kThreads, 2)
RadixSortOnesweep(const unsigned long long* __restrict__ src,
                  const long long* __restrict__ words,
                  const S* __restrict__ sid, int sbits,
                  unsigned long long* __restrict__ dst, int64_t E, int shift,
                  int width, uint32_t epoch, uint32_t* __restrict__ status,
                  int64_t tile_first,
                  const unsigned long long* __restrict__ base,
                  unsigned long long* __restrict__ base_next,
                  unsigned int* __restrict__ ticket, unsigned n_tiles) {
  extern __shared__ unsigned long long s_keys[];  // [kTile], digit order
  // each warp's count of each digit, then its next slot in s_keys
  __shared__ uint32_t s_count[kWarps][kBins];
  // each warp's peers of each digit, ORed in by a step's lanes; steps
  // alternate between the two sets, and the last of a digit's peers
  // clears its word, so every word is 0 between the steps that use it
  __shared__ uint32_t s_match[2][kWarps][kBins];
  __shared__ long long s_off[kBins];  // a digit's output row minus its slot
  __shared__ uint32_t s_wsum[kWarps];
  __shared__ unsigned int s_ticket;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = threadIdx.x;
  const uint32_t mask = (1u << width) - 1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_match[0][w][d] = s_match[1][w][d] = 0;
  for (;;) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_count[w][d] = 0;
    if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned tk = s_ticket;
    if (tk >= n_tiles) break;
    const bool first = tk == 0;  // the portion's first tile
    const bool last = tk == n_tiles - 1;
    const int64_t tile = tile_first + tk;
    const int64_t tile0 = tile * kTile;
    const int64_t w0 = tile0 + (int64_t)kWarpKeys * warp + lane;

    uint64_t key[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t row = w0 + 32 * i;
      if constexpr (std::is_void_v<S>)
        key[i] = row < E ? __ldg(src + row) : 0;
      else
        key[i] = row < E ? packed_key(words, sid, sbits, row) : 0;
    }

    // the tile's count of each digit, a warp's at a time, published at
    // once
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (w0 + 32 * i < E)
        atomicAdd(&s_count[warp][digit(key[i], shift, mask)], 1u);
    __syncthreads();
    uint32_t count = 0;  // digit d: each warp's exclusive offset, the count
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = s_count[w][d];
      s_count[w][d] = count;
      count += c;
    }
    uint32_t* own = status + tile * kBins + d;
    st_relaxed(own, epoch | (first ? kFlagP : kFlagA) | count);
    uint32_t x = count;  // inclusive scan over the digits
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_wsum[warp] = x;
    __syncthreads();
    uint32_t excl = x - count;  // digit d's first slot in s_keys
    for (int w = 0; w < warp; ++w) excl += s_wsum[w];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_count[w][d] += excl;
    __syncthreads();

    // each key to its slot in digit order: the warp's next slot of its
    // digit plus its peers before it in the step (stable: index order)
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool valid = w0 + 32 * i < E;
      const uint32_t dg = digit(key[i], shift, mask);
      uint32_t* m = &s_match[i % 2][warp][dg];
      if (valid) atomicOr(m, 1u << lane);
      __syncwarp();
      const unsigned peers = valid ? *m : 0u;
      const uint32_t slot =
          valid ? s_count[warp][dg] + __popc(peers & below) : 0;
      __syncwarp();
      if (valid && peers >> lane == 1u) {  // the last of its peers
        s_count[warp][dg] = slot + 1;
        *m = 0;
      }
      if (valid) s_keys[slot] = key[i];
    }

    // digit d's keys in the portion's earlier tiles, looked back for last:
    // by now most of those tiles have published their prefixes
    const int64_t prefix =
        first ? 0 : look_back(status, tile, tile_first, d, epoch);
    if (!first) st_relaxed(own, epoch | kFlagP | (uint32_t)(prefix + count));
    s_off[d] = (long long)base[d] + prefix - (long long)excl;
    if (last && base_next) base_next[d] = base[d] + prefix + count;
    __syncthreads();

    // out in runs: slot j's key goes to row s_off[its digit] + j
    const int64_t left = E - tile0;
    const int n = left < kTile ? (int)left : kTile;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + threadIdx.x;
      if (j < n) {
        const unsigned long long k = s_keys[j];
        dst[s_off[digit(k, shift, mask)] + j] = k;
      }
    }
    if constexpr (!std::is_void_v<S>) break;  // the first pass: one tile
  }
}

// The launches of one sort, the sample ids of type S.
template <typename S>
int sort_passes(const long long* words, const S* sid, int sbits, int64_t E,
                const Plan& plan, int64_t tiles, int64_t portions,
                unsigned long long* k0, unsigned long long* k1,
                uint32_t* status, unsigned long long* hist,
                unsigned long long* base, unsigned int* tickets,
                cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(RadixSortOnesweep<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTile * 8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(RadixSortOnesweep<void>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTile * 8);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, RadixSortOnesweep<void>, kThreads, kTile * 8);
  if (err != cudaSuccess) return (int)err;
  // the later passes' persistent grid
  const int64_t ctas = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t want = E / ((int64_t)kThreads * kHistUnroll) + 1;
  const int64_t hgrid = want < 4 * sms ? want : 4 * sms;
  RadixSortHistogram<<<(unsigned)hgrid, kThreads, 0, stream>>>(
      words, sid, sbits, E, plan, hist, reinterpret_cast<uint4*>(status),
      tiles * kBins / 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  RadixSortScan<<<1, kBins, 0, stream>>>(hist, plan.n, portions, base);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int p = 0; p < plan.n; ++p) {
    const uint32_t epoch = p % 2 == 0 ? kEpoch : 0u;
    unsigned long long* dst = p % 2 == 0 ? k0 : k1;
    const unsigned long long* src = p % 2 == 0 ? k1 : k0;
    for (int64_t q = 0; q < portions; ++q) {
      const int64_t t0 = q * kPortionTiles;
      const int64_t n = tiles - t0 < kPortionTiles ? tiles - t0 : kPortionTiles;
      unsigned long long* b = base + (p * portions + q) * kBins;
      unsigned long long* next = q + 1 < portions ? b + kBins : nullptr;
      unsigned int* ticket = tickets + p * portions + q;
      if (p == 0)
        RadixSortOnesweep<S><<<(unsigned)n, kThreads, kTile * 8, stream>>>(
            nullptr, words, sid, sbits, dst, E, plan.shift[p], plan.width[p],
            epoch, status, t0, b, next, ticket, (unsigned)n);
      else
        RadixSortOnesweep<void>
            <<<(unsigned)(ctas < n ? ctas : n), kThreads, kTile * 8,
               stream>>>(src, nullptr, nullptr, sbits, dst, E, plan.shift[p],
                         plan.width[p], epoch, status, t0, b, next, ticket,
                         (unsigned)n);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// keys a tile; the status words are one uint32 a tile and digit
int64_t simka_sort_tile_keys() { return kTile; }

// tiles a portion (prefixes are counted in 29 bits inside a portion)
int64_t simka_sort_portion_tiles() { return kPortionTiles; }

// words: [E] int64 and sid: [E] int32 or int64 (sid_size 4 or 8), with
// 0 <= word < 2^(bits - sbits) and 0 <= sid < 2^sbits, so that every key
// (word << sbits) | sid lies below 2^bits; shifts, widths: the n_passes
// (1..8) digits, least significant first, each 1..8 bits, together
// [0, bits); keys0, keys1: [E] uint64, the sorted keys end in
// keys[(n_passes - 1) % 2]; status: uint32 [ceil(E / kTile) * 256], any
// contents; small: uint64 [n_passes * (portions + 2) * 256], portions =
// ceil(tiles / portion tiles), zeroed here. E >= 1. Launches the
// histogram, the scan, and n_passes x portions digit passes. Returns a
// cudaError_t code (0 on success).
int simka_radix_sort(const long long* words, const void* sid, int sid_size,
                     int sbits, int64_t E, int n_passes, const int* shifts,
                     const int* widths, uint64_t* keys0, uint64_t* keys1,
                     uint32_t* status, uint64_t* small, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (E < 1 || (sid_size != 4 && sid_size != 8) || sbits < 0 || sbits > 63 ||
      n_passes < 1 || n_passes > kMaxPasses)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n = n_passes;
  int covered = 0;
  for (int p = 0; p < kMaxPasses; ++p) {
    plan.shift[p] = p < n_passes ? shifts[p] : 0;
    plan.width[p] = p < n_passes ? widths[p] : 1;
    if (p < n_passes && (plan.width[p] < 1 || plan.width[p] > kDigitBits ||
                         plan.shift[p] != covered))
      return (int)cudaErrorInvalidValue;
    if (p < n_passes) covered += plan.width[p];
  }
  if (covered > 63) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (E + kTile - 1) / kTile;
  const int64_t portions = (tiles + kPortionTiles - 1) / kPortionTiles;
  // small: hist [n_passes][kBins], base [n_passes][portions][kBins], a
  // ticket a pass and portion
  auto* hist = reinterpret_cast<unsigned long long*>(small);
  auto* base = hist + n_passes * kBins;
  auto* tickets =
      reinterpret_cast<unsigned int*>(base + n_passes * portions * kBins);
  const cudaError_t err = cudaMemsetAsync(
      small, 0, (size_t)n_passes * (portions + 2) * kBins * 8, stream);
  if (err != cudaSuccess) return (int)err;
  auto* k0 = reinterpret_cast<unsigned long long*>(keys0);
  auto* k1 = reinterpret_cast<unsigned long long*>(keys1);
  return sid_size == 8
             ? sort_passes(words, static_cast<const long long*>(sid), sbits,
                           E, plan, tiles, portions, k0, k1, status, hist,
                           base, tickets, stream)
             : sort_passes(words, static_cast<const int*>(sid), sbits, E,
                           plan, tiles, portions, k0, k1, status, hist, base,
                           tickets, stream);
}

}  // extern "C"
