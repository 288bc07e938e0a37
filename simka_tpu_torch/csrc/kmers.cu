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
// Its bound: device-memory bandwidth. A window reads a quarter byte of
// codes and an eighth of validity and writes 8 B a word and 1 B of
// mask: at phase 7's batch (2^17 reads x 104 slots, k = 21, 11,010,048
// windows) 5.1 MB in and 99.1 MB out, 0.031 ms at 3.35 TB/s. This form
// takes 0.075 ms there on the device (0.082 ms at k = 63, 1.38x the
// bytes in half the windows: its work a window, not its bytes, holds
// it; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6).
//
// This form does O(words) work a window:
//   - The batch is one flat stream of B * L bases (row-major rows are
//     contiguous). A CTA of a persistent grid takes tiles of kTileBases
//     bases: the windows that start in the tile, a contiguous range of
//     e, and their bases, the tile plus a halo of k - 1. It stages the
//     tile's 2-bit stream and validity bits in shared memory, 64 bases a
//     thread with 16-byte loads (the packed entry point), or 64 codes
//     packed into the same two streams as they are staged (the codes
//     entry point). An invalid base gets code 3 there: the packed bytes
//     OR its validity bits spread to 2-bit groups. The next tile's loads
//     are issued into registers before the current tile's windows are
//     computed (register double buffering).
//   - Thread t takes windows t, t + 256, ... of the tile (consecutive
//     threads, consecutive windows: coalesced stores), walking (offset in
//     the read, offset in the tile's stream) by a step computed once on
//     the host: no division a window.
//   - The stream is little-endian 2-bit, so the 2n bits at a span's
//     offset are its n bases read backwards: the reverse complement word
//     is that value XOR the replicated complement. The tile is staged a
//     second time with its 2-bit groups reversed (__brev and a swap
//     within each pair, once a staged word), where the bits at the
//     mirrored offset are the span's bases forwards: the forward word.
//     Each 31-base word is so two extractions (three 32-bit shared loads
//     and two funnel shifts each) at their own offsets; validity is k
//     bits of the validity stream, all set; the Shannon counts are
//     popcounts of the per-code match masks.
//   - A thread counts its kept windows in a register and each kept
//     window's bucket in its own column of a shared [16][256] table
//     (bucket-major, so every lane adds in its own bank: no conflict and
//     no atomic); at the end a warp sum a bucket and one integer atomic
//     a bucket a CTA, and one a warp for the kept total: exact, the
//     same on every run. No warp collective in the window loop. Thread
//     0 works out the next tile's geometry while the current tile's
//     windows run, by steps the host computes: no division a tile.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs and the stream; the entry point returns
// the first cudaError_t of its memset, its queries and its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordBases = 31;
constexpr int kMaxK = 127;
constexpr int kBuckets = 16;
constexpr int kVecBases = 64;      // bases a thread stages
constexpr int kTileBases = 4096;   // window starts a tile
// staged vectors a tile: the tile and its k - 1 halo bases
constexpr int kMaxVecs = (kTileBases + kMaxK - 1 + kVecBases - 1) / kVecBases;
static_assert(kMaxVecs <= kThreads, "a thread stages one vector");
constexpr unsigned kFull = 0xffffffffu;

struct Batch {
  const uint8_t* packed;     // [B, L/4] 2-bit codes, or null
  const uint8_t* validbits;  // [B, L/8] validity bits (with packed)
  const uint8_t* codes;      // [B, L] codes, >= 4 invalid (without packed)
  int aligned;               // the stream pointers allow vector loads
};

struct Geometry {
  int64_t N;       // bases of the flat stream, B * L
  int64_t L, Wk;   // row length, windows a row
  int64_t E;       // windows, B * Wk
  int64_t tiles;   // ceil(N / kTileBases)
  int k;
  int step_rows;   // kThreads / Wk: rows a window step passes
  int step_rem;    // kThreads % Wk
  // a tile's start (kTileBases on) and a CTA's next tile's (the grid's
  // kTileBases on), as rows and a remainder of bases: no division in
  // the kernel
  int64_t tile_rows, tile_rem, grid_rows, grid_rem;
};

// one thread's staged vector, as loaded (combined when stored)
template <bool kPacked>
struct Raw;
template <>
struct Raw<true> {
  uint4 pk;  // 64 bases, 2 bits each
  uint2 vb;  // their 64 validity bits
};
template <>
struct Raw<false> {
  uint4 c[4];  // 64 codes
};

// vector v (bases [64 v, 64 v + 64)) of the stream; past N zero bits
// (packed) or code 255 (codes): invalid, and read by no window
__device__ __forceinline__ void load_raw(const Batch& in, int64_t v,
                                         int64_t N, Raw<true>& r) {
  if (in.aligned && (v + 1) * kVecBases <= N) {
    r.pk = __ldg(reinterpret_cast<const uint4*>(in.packed) + v);
    r.vb = __ldg(reinterpret_cast<const uint2*>(in.validbits) + v);
    return;
  }
  uint32_t p[4] = {0, 0, 0, 0}, q[2] = {0, 0};
  for (int j = 0; j < 16; ++j) {
    const int64_t byte = 16 * v + j;  // bases 4 byte .. 4 byte + 3
    if (4 * byte < N) p[j / 4] |= (uint32_t)__ldg(in.packed + byte)
                                  << (8 * (j % 4));
  }
  for (int j = 0; j < 8; ++j) {
    const int64_t byte = 8 * v + j;
    if (8 * byte < N) q[j / 4] |= (uint32_t)__ldg(in.validbits + byte)
                                  << (8 * (j % 4));
  }
  r.pk = make_uint4(p[0], p[1], p[2], p[3]);
  r.vb = make_uint2(q[0], q[1]);
}

__device__ __forceinline__ void load_raw(const Batch& in, int64_t v,
                                         int64_t N, Raw<false>& r) {
  if (in.aligned && (v + 1) * kVecBases <= N) {
    const uint4* src = reinterpret_cast<const uint4*>(in.codes) + 4 * v;
#pragma unroll
    for (int j = 0; j < 4; ++j) r.c[j] = __ldg(src + j);
    return;
  }
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = 0xffffffffu;
  for (int j = 0; j < kVecBases; ++j) {
    const int64_t pos = kVecBases * v + j;
    if (pos < N)
      w[j / 4] = (w[j / 4] & ~(0xffu << (8 * (j % 4)))) |
                 ((uint32_t)__ldg(in.codes + pos) << (8 * (j % 4)));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r.c[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
}

// 16 bits -> 32: bit i to bit 2i
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// four codes (a byte each) -> their 2-bit codes (c & 3, 8 bits) and
// validity (c < 4, 4 bits)
__device__ __forceinline__ void pack4(uint32_t x, uint32_t& code8,
                                      uint32_t& valid4) {
  uint32_t c = x & 0x03030303u;
  c = (c | (c >> 6)) & 0x000f000fu;
  code8 = (c | (c >> 12)) & 0xffu;
  // bit 6 of a byte of t + 0x3f set iff that byte of x is >= 4
  const uint32_t high = (((x >> 2) & 0x3f3f3f3fu) + 0x3f3f3f3fu) & 0x40404040u;
  uint32_t v = (~high >> 6) & 0x01010101u;
  v = (v | (v >> 7)) & 0x00030003u;
  valid4 = (v | (v >> 14)) & 0xfu;
}

// the 16 2-bit groups of x in reverse order
__device__ __forceinline__ uint32_t reverse_groups(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// A tile's staged streams in shared memory, 32-bit words (+ 2 words of
// padding: a funnel's top words):
//   pk: the 2-bit stream, tile base i at bits 2i, 2i + 1;
//   rv: the same stream reversed, base i at group kMaxVecs * 64 - 1 - i,
//       so that the bits at a span's offset there are its bases in
//       forward (most significant first) order;
//   vb: the validity bits, base i at bit i.
struct Staged {
  uint32_t pk[4 * kMaxVecs + 2];
  uint32_t rv[4 * kMaxVecs + 2];
  uint32_t vb[2 * kMaxVecs + 2];
};

// vector j's 64 bases into the staged streams
__device__ __forceinline__ void put_staged(const uint32_t (&p)[4],
                                           const uint32_t (&v)[2], int j,
                                           Staged& st) {
  const int jr = kMaxVecs - 1 - j;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    st.pk[4 * j + q] = p[q];
    st.rv[4 * jr + 3 - q] = reverse_groups(p[q]);
  }
  st.vb[2 * j] = v[0];
  st.vb[2 * j + 1] = v[1];
}

// the packed route: an invalid base's two bits ORed to code 3
__device__ __forceinline__ void store_staged(const Raw<true>& r, int j,
                                             Staged& st) {
  uint32_t p[4] = {r.pk.x, r.pk.y, r.pk.z, r.pk.w};
  const uint32_t v[2] = {r.vb.x, r.vb.y};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    p[q] |= 3u * spread16(~(v[q / 2] >> (16 * (q % 2))) & 0xffffu);
  put_staged(p, v, j, st);
}

// the codes route: code c & 3, valid where c < 4
__device__ __forceinline__ void store_staged(const Raw<false>& r, int j,
                                             Staged& st) {
  uint32_t p[4] = {0, 0, 0, 0}, v[2] = {0, 0};
#pragma unroll
  for (int u = 0; u < 16; ++u) {  // codes 4u .. 4u + 3
    const uint4& c = r.c[u / 4];
    const uint32_t x = u % 4 == 0 ? c.x : u % 4 == 1 ? c.y : u % 4 == 2 ? c.z
                                                                        : c.w;
    uint32_t code8, valid4;
    pack4(x, code8, valid4);
    p[u / 4] |= code8 << (8 * (u % 4));
    v[u / 8] |= valid4 << (4 * (u % 8));
  }
  put_staged(p, v, j, st);
}

// 64 bits of a staged stream from bit `bit`: two funnel shifts
__device__ __forceinline__ uint64_t bits64(const uint32_t* s, int bit) {
  const int w = bit >> 5, sh = bit & 31;
  const uint32_t a = s[w], b = s[w + 1], c = s[w + 2];
  return (uint64_t)__funnelshift_r(a, b, sh) |
         ((uint64_t)__funnelshift_r(b, c, sh) << 32);
}

__device__ __forceinline__ uint64_t low_mask(int nbits) {  // nbits <= 64
  return nbits >= 64 ? ~0ull : (1ull << nbits) - 1;
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

// a base of the stream as (row, offset in the row)
struct Pos {
  int64_t row, off;
  __device__ __forceinline__ void advance(int64_t rows, int64_t rem,
                                          int64_t L) {
    row += rows;
    off += rem;
    if (off >= L) {
      off -= L;
      ++row;
    }
  }
};

// a tile's windows [e_lo, e_lo + n); the first one's offset in its row
// (p0) and its base in the tile (b0)
struct TileInfo {
  int64_t e_lo;
  int n, p0, b0;
};

// the tile starting at base s0 = `at`
__device__ __forceinline__ TileInfo tile_info(const Geometry& g, int64_t s0,
                                              Pos at) {
  auto before = [&](const Pos& q) {  // windows that start before q
    return q.row * g.Wk + (q.off < g.Wk ? q.off : g.Wk);
  };
  TileInfo ti;
  ti.e_lo = before(at);
  Pos end = at;
  end.advance(g.tile_rows, g.tile_rem, g.L);
  ti.n = (int)((s0 + kTileBases < g.N ? before(end) : g.E) - ti.e_lo);
  ti.p0 = at.off < g.Wk ? (int)at.off : 0;
  ti.b0 = at.off < g.Wk ? 0 : (int)(g.L - at.off);
  return ti;
}

template <int NW, bool kPacked>
__global__ void __launch_bounds__(kThreads)
extract_kmers(Batch in, Geometry g, uint32_t comp_xor, int use_thr, float thr,
              const float* __restrict__ terms, int with_hist, int n32,
              uint64_t* __restrict__ words, uint8_t* __restrict__ keep,
              unsigned long long* __restrict__ counts) {
  __shared__ Staged st;
  __shared__ float s_terms[kMaxK + 1];
  // kept windows a bucket, a column a thread (bucket-major: each lane
  // adds in its own bank)
  __shared__ uint32_t s_cnt[kBuckets][kThreads];
  __shared__ TileInfo s_tile[2];  // this tile's and the next one's
  const int t = threadIdx.x, lane = t % 32;
  const int k = g.k;
  if (use_thr)
    for (int i = t; i <= k; i += kThreads) s_terms[i] = terms[i];
  if (with_hist)
    for (int b = 0; b < kBuckets; ++b) s_cnt[b][t] = 0;

  const int top = k - kWordBases * (NW - 1);  // bases of the top word
  const uint64_t comp = 0x5555555555555555ull * comp_xor;
  const int wrap = k - 1;  // stream bases skipped from a row to the next
  constexpr int kRv = 64 * kMaxVecs;  // bases of the reversed stream
  uint32_t kept = 0;

  auto vecs_of = [&](int64_t tile) -> int {
    const int64_t s0 = tile * kTileBases;
    int64_t n = g.N - s0;
    if (n > kTileBases + k - 1) n = kTileBases + k - 1;
    return (int)((n + kVecBases - 1) / kVecBases);
  };

  Raw<kPacked> raw;
  int64_t tile = blockIdx.x;
  Pos at;  // thread 0: the start of this CTA's next tile to describe
  if (tile < g.tiles) {
    if (t < vecs_of(tile))
      load_raw(in, tile * (kTileBases / kVecBases) + t, g.N, raw);
    if (t == 0) {
      at.row = tile * kTileBases / g.L;  // one division a CTA
      at.off = tile * kTileBases - at.row * g.L;
      s_tile[0] = tile_info(g, tile * kTileBases, at);
    }
  }
  for (int buf = 0; tile < g.tiles; tile += gridDim.x, buf ^= 1) {
    __syncthreads();  // the last tile's windows are read
    if (t < vecs_of(tile)) store_staged(raw, t, st);
    __syncthreads();
    const int64_t next = tile + gridDim.x;
    if (next < g.tiles) {
      if (t < vecs_of(next))
        load_raw(in, next * (kTileBases / kVecBases) + t, g.N, raw);
      // the next tile's geometry, while this one's windows run
      if (t == 0) {
        at.advance(g.grid_rows, g.grid_rem, g.L);
        s_tile[buf ^ 1] = tile_info(g, next * kTileBases, at);
      }
    }

    const int64_t e_lo = s_tile[buf].e_lo;
    const int n_tile = s_tile[buf].n, p0 = s_tile[buf].p0;
    const int b0 = s_tile[buf].b0;
    // this thread's first window, t windows on
    const int rows = (p0 + t) / (int)g.Wk;
    int p = p0 + t - rows * (int)g.Wk;
    int base = b0 + t + rows * wrap;
#pragma unroll 2
    for (int j = t; j < n_tile; j += kThreads) {
      uint64_t f[NW], r[NW];
      uint32_t n1 = 0, n2 = 0, n3 = 0;  // bases of code 1, 2, 3
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        // word w spans window offsets [lo, hi), most significant first;
        // the reverse complement's word w reads offsets [k - hi, k - lo)
        const int hi = top + kWordBases * w;
        const int lo = w == 0 ? 0 : hi - kWordBases;
        const uint64_t m = low_mask(2 * (hi - lo));
        f[w] = bits64(st.rv, 2 * (kRv - base - hi)) & m;
        r[w] = (bits64(st.pk, 2 * (base + k - hi)) ^ comp) & m;
        if (use_thr) {
          const uint64_t a = f[w] & 0x5555555555555555ull;
          const uint64_t b = (f[w] >> 1) & 0x5555555555555555ull;
          n1 += __popcll(a & ~b);
          n2 += __popcll(b & ~a);
          n3 += __popcll(a & b);
        }
      }
      bool ok = true;
      for (int c = 0; c < k; c += 64) {
        const uint64_t m = low_mask(k - c);
        ok = ok && (bits64(st.vb, base + c) & m) == m;
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
      for (int w = 0; w < NW; ++w) o[w] = take_fwd ? f[w] : r[w];
      if (use_thr) {
        // the canonical k-mer's base counts: the complement strand holds
        // code c as many times as the forward one holds c ^ comp_xor
        const uint32_t x = take_fwd ? 0u : comp_xor;
        const uint32_t n0 = (uint32_t)k - n1 - n2 - n3;
        auto cnt = [&](uint32_t c) {
          return c == 0 ? n0 : c == 1 ? n1 : c == 2 ? n2 : n3;
        };
        float s = s_terms[cnt(0u ^ x)];
        s = s + s_terms[cnt(1u ^ x)];
        s = s + s_terms[cnt(2u ^ x)];
        s = s + s_terms[cnt(3u ^ x)];
        ok = ok && fabsf(s) >= thr;
      }
      const int64_t e = e_lo + j;
#pragma unroll
      for (int w = 0; w < NW; ++w) words[(int64_t)w * g.E + e] = o[w];
      keep[e] = ok ? 1 : 0;
      kept += ok;
      if (with_hist && ok)
        ++s_cnt[repartition_hash<NW>(o, NW == 1 ? 2 : n32) &
                (kBuckets - 1)][t];
      // kThreads windows on: step_rows rows and step_rem windows
      p += g.step_rem;
      base += kThreads + g.step_rows * wrap;
      if (p >= g.Wk) {
        p -= (int)g.Wk;
        base += wrap;
      }
    }
  }
  // the CTA's totals: warp w sums buckets w and w + 8 over the threads;
  // the kept total by a warp sum, one atomic a warp
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_down_sync(kFull, kept, o);
  if (lane == 0 && kept) atomicAdd(&counts[kBuckets], kept);
  if (!with_hist) return;
  __syncthreads();
  for (int b = t / 32; b < kBuckets; b += kThreads / 32) {
    unsigned long long n = 0;
    for (int i = lane; i < kThreads; i += 32) n += s_cnt[b][i];
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(kFull, n, o);
    if (lane == 0 && n) atomicAdd(&counts[b], n);
  }
}

template <int NW, bool kPacked>
cudaError_t launch(const Batch& in, const Geometry& g, int comp_xor,
                   int use_thr, float thr, const float* terms, int with_hist,
                   int n32, uint64_t* words, uint8_t* keep,
                   unsigned long long* counts, cudaStream_t stream) {
  auto kernel = extract_kmers<NW, kPacked>;
  // the persistent grid, one full wave: asked once a device
  static int grid_dev = -1, grid_size = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != grid_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    grid_dev = dev;
    grid_size = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t blocks = grid_size < g.tiles ? grid_size : g.tiles;
  Geometry gg = g;
  gg.grid_rows = blocks * kTileBases / g.L;
  gg.grid_rem = blocks * kTileBases % g.L;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, gg, (uint32_t)comp_xor, use_thr, thr, terms, with_hist, n32, words,
      keep, counts);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch(bool packed, const Batch& in, const Geometry& g,
                   int comp_xor, int use_thr, float thr, const float* terms,
                   int with_hist, int n32, uint64_t* words, uint8_t* keep,
                   unsigned long long* counts, cudaStream_t stream) {
  return packed ? launch<NW, true>(in, g, comp_xor, use_thr, thr, terms,
                                   with_hist, n32, words, keep, counts, stream)
                : launch<NW, false>(in, g, comp_xor, use_thr, thr, terms,
                                    with_hist, n32, words, keep, counts,
                                    stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  Geometry g;
  g.N = B * L;
  g.L = L;
  g.Wk = L - k + 1;
  g.E = B * g.Wk;
  g.tiles = (g.N + kTileBases - 1) / kTileBases;
  g.k = k;
  g.step_rows = (int)(kThreads / g.Wk);
  g.step_rem = (int)(kThreads % g.Wk);
  g.tile_rows = kTileBases / L;
  g.tile_rem = kTileBases % L;
  if (g.E == 0) return (int)cudaSuccess;
  const bool pk = packed != nullptr;
  const Batch in{packed, validbits, codes,
                 pk ? aligned(packed, 16) && aligned(validbits, 8)
                    : aligned(codes, 16)};
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  switch ((k + kWordBases - 1) / kWordBases) {
    case 1:
      return (int)launch<1>(pk, in, g, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    case 2:
      return (int)launch<2>(pk, in, g, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    case 3:
      return (int)launch<3>(pk, in, g, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    case 4:
      return (int)launch<4>(pk, in, g, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
    default:
      return (int)launch<5>(pk, in, g, comp_xor, use_thr, thr, terms,
                            with_hist, n32, words, keep, c, stream);
  }
}

}  // extern "C"
