// Pair sums of the exact join (Hopper, sm_90a): every co-present pair of
// one k-mer's solid rows, added into the [N * N] pair channels, and
// Whittaker's all-rows sums of every row, in one pass over the rows.
//
// Replaces the XLA programs simka_tpu/ops/countjoin.py::_pair_accumulate
// (:1112, its per-shift fori_loop :1304) with _pairbin_pass (:1357) and
// _whittaker_all_banks (:238; none of them Pallas), and on the card the
// port's own torch loops (ops/countjoin.py::_pair_sums_plain: for each
// offset d < d_max a compare of the row stream with itself shifted and
// one index_add_ a channel; ::_whittaker_all: [rows, 8] blocks of torch
// ops). The reference prunes singleton rows first (its Prejoin,
// countjoin.py:574); here a singleton costs its row's all-rows terms and
// no pair work, so nothing is pruned.
//
// Input: the solid rows in (k-mer, sample) order -- sid and count, int64
// -- cut into segments of one k-mer (starts, lengths: int64); K, the
// per-bank solid totals as f64. For every pair of rows i < j of one
// segment (a = sid[i] < b = sid[j], ca, cb their counts) the channels
// are, as the plain version computes them:
//   0 ab += ca      1 ba += cb      2 distinct += 1    3 bray += min
//   4 hellinger += floor(sqrt(double(ca cb)))          5 chord += ca cb
//   6 whittaker += |int32 wrap of (xY mod 2^32 - yX mod 2^32)|,
//     xY = ca Kb, yX = cb Ka in f64           7 s12 += |w32(xY)| + |w32(yX)|
//   8-12 the five fixed-point limbs of the Kullback-Leibler term
//     (ca / max(Ka, 1)) log(2 xY / (xY + yX)) + (cb / max(Kb, 1))
//     log(2 yX / (xY + yX)) (ops/countjoin.py::_kl_limbs).
// And for every row (a, c) and every bank j, whittaker_all[a N + j] +=
// |w32(c K_j)| (ordered: all of a's rows, singletons too). Outputs are
// the callers' flat [N * N] int64 channels at a N + b (a KL limb:
// element 5 (a N + b) + l of the [N * N, 5] limbs); the kernel adds into
// them, so shards, ranges and ranks fold as before. Every channel is an
// integer sum: the result does not depend on the order of the adds, and
// is the same run to run. The f64 steps use the _rn intrinsics, which
// the compiler never contracts into an FMA, so each rounds as torch's
// separate ops do; log is libdevice's, as torch.log's is on the card:
// kernel and plain version agree bit for bit. w32(p), the int32 wrap of
// an integer-valued double, is read exactly from its int64 conversion
// below 2^63 and from fmod past it; where c K_j < 2^53 (the count at most
// (2^53 - 1) / max K) the product is exact and w32 is the 32-bit integer
// product of the low words.
//
// What bounds it. The rows are read once (16 B a row and a segment; G
// times from L2 with G sample groups, below); the work is the pairs,
// sum L (L - 1) / 2 over the segments, and the all-rows terms: since
// |w32(c K_j)| depends on (c, j) alone, the function needs N of them for
// each distinct (sample, count) of the rows, each added times its rows
// (this kernel computes one a row and bank). Its floor: the bytes at
// N = 8 (0.54 ms for phase 7's 77 M rows); at N = 100 the integer
// instructions a pair and channel (0.58 ms default, 1.89 ms every
// channel) and, with every channel, the f64 terms, ~30 operations a
// pair with two divisions and two logs, at 64 f64 lanes an SM: 2.29 ms
// (chip_smoke.py's pair_sums_bound). What bounds it now is its walk:
// with every add into a register sink it keeps 88% of its time (an
// instrumented build at N = 100, PERF.md section 6), against the
// earlier design's 39-49% (one 64-bit shared atomic a pair and
// channel: 2.1% / 1.7% of its bound without the all-rows terms).
//
// Design: one writer per bin.
//   - Rows through shared memory. A CTA takes the segments whose first
//     row lies in its equal share of the rows (a binary search of the
//     starts), in chunks of whole segments of at most kChunk rows: each
//     thread loads its rows and segment heads of the next chunk into
//     registers while the CTA works on the current one, then stores them
//     (sid as int32, count, the KL quotient c / max(K_sid, 1) once a row)
//     between two barriers. A bulk copy (cp.async.bulk) was the other
//     way: it cannot convert a row on its way in, and a chunk starts at
//     any row, so it needs a peeled head and tail; the register stage
//     costs eight loads and six to eight stores a thread a chunk.
//   - Ownership. The CTA's partials hold, for its sample group [a0, a1)
//     (below), every channel's bins (a, b), b > a, and the all-rows row
//     A[a][.], in int64. A team of team_warps warps shares one copy;
//     warp w of a team owns the samples [warp_bound[w], warp_bound[w+1])
//     (cut at equal bytes, so the small a, with more partners b > a,
//     get narrower ranges), and every warp of a team walks every segment
//     of the team's. Teams (copies of the partials, 16 / team_warps)
//     walk disjoint segments; at small N each warp is a team of its own
//     (a private copy a warp). So a bin has one writer warp, and the
//     per-pair add is a plain shared load, add and store.
//   - The walk. A warp takes its team's segments 32 at a time: a lane a
//     segment finds the rows [p0, p1) of the warp's samples (two binary
//     searches of the sorted sids, skipped when the segment's first and
//     last sid say all or none). The rows' all-rows terms go a row at a
//     time, lanes over the banks (a lane's entries are its own). A warp
//     scan numbers the block's pairs (i, j), p0 <= i < p1, i < j < L,
//     in one flat order (segments in turn, row-major within one), and a
//     batch of 32 takes the flat pairs base + lane: a lane finds its
//     segment from the starts inside the batch (one __reduce_or_sync of
//     a bit a start) and the segments before it (a ballot), then its
//     row by a short loop. So every lane has a pair however few a
//     segment holds for the warp (~2 at N = 8, ~19 at N = 100 with the
//     default channels), and with the complex channels every lane
//     computes f64 terms. Pairs of one segment are distinct bins, but
//     two segments may share one: the lanes of one bin
//     (__match_any_sync) add in turns, one __syncwarp apart. The earlier
//     design (a warp a segment, lanes over its pairs, one 64-bit shared
//     atomic a pair and channel) spent 61.5% / 51.3% of its time on
//     those atomics (an instrumented build at N = 100, PERF.md
//     section 6).
//     The flush sums the copies and adds each nonzero bin into the
//     outputs with one global atomic: the only atomics of the form.
//   - Sample groups. When one copy of every channel's bins does not fit
//     a CTA, the samples are cut into the fewest groups [a0, a1) of
//     equal bytes that do (the grid's fastest index, so the G CTAs of
//     one row share run together and read its rows from L2): still one
//     launch. Shared memory a CTA on an H100 (227 KB opt-in):
//     N = 8, default: 16 private copies of 896 B, 39,008 B in all; every
//     channel and whittaker_all: 16 x 3,424 B, 87,648 B. N = 100,
//     default: one copy of 158,400 B, 184,176 B; every channel and
//     whittaker_all (594,800 B of partials): four groups, <= 155,520 B,
//     189,488 B. Each with the row stage, K and the headers (24,672 to
//     33,968 B). One CTA an SM at both N (the 512 threads' registers).
//     (ops/countjoin.py::pair_plan chooses the teams and groups.)
//   - Global form, past PAIR_MAX_GROUPS groups (every channel from
//     N = 160, the default ones from N = 315 on an H100) or segments
//     longer than kChunk: every pair's adds and every all-rows term go
//     straight into the outputs with 64-bit global atomics, in one
//     launch (the earlier design's form; correct, not fast).
// No tensor cores: a pair's terms are a min, an isqrt, an f64 wrap and
// logs, and the all-rows terms an int32 wrap of products -- none is a
// matrix product of the operands, so wgmma has nothing to multiply. (A
// dense int8 product for the product-shaped channels, distinct, ab, ba
// and chord, would cost N x N x k-mers; it is not done.)
// Two's-complement wrap makes the unsigned atomics add signed values
// (the KL limbs of a negative term) exactly.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs and the stream; the entry point returns
// the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 13;  // 0-7 as above, 8-12 the KL limbs
constexpr int kWall = kChannels;  // outs[13]: whittaker_all
constexpr int kOuts = kChannels + 1;
constexpr int kKlFirst = 8;
constexpr int kKlLimbs = 5;
constexpr int kChunk = 1024;  // rows (and segments) a chunk at most
constexpr int kPerThread = kChunk / kThreads;
constexpr int kMaxGroups = 8;
constexpr double kLimbScale = 268435456.0;  // 2^28, ops/countjoin.py
constexpr double kTwo32 = 4294967296.0;
constexpr double kTwo63 = 9223372036854775808.0;
constexpr unsigned long long kExactMax = (1ULL << 53) - 1;
// rows a CTA at least: small joins take few CTAs (each zeroes and
// flushes its partials)
constexpr long long kRowsPerCta = 4096;
// shared memory the kernel declares statically, kept out of the budget
constexpr int kStaticSmem = 128;

struct Plan {
  // channel c's output (a KL limb's first element), outs[13]
  // whittaker_all; null when off
  unsigned long long* out[kOuts];
  // channel c's slot among the partials, -1 when off
  int slot[kChannels];
  int n_slots;
  int wall;  // whittaker_all on
  int kl;    // the KL limbs on
  int n_groups;
  int team_warps;
  int bound[kMaxGroups + 1];                 // the groups' samples
  int warp_bound[kMaxGroups][kWarps + 1];    // a team's warps' samples
};

// The channel sets of the shared form, one kernel each: the default
// four, with the simple two, with the complex seven (whittaker, s12
// and the KL limbs), or both; a channel's slot among the partials
template <bool kSimple, bool kComplex>
struct ChannelSet {
  static constexpr int n = 4 + (kSimple ? 2 : 0) + (kComplex ? 7 : 0);
  __host__ __device__ static constexpr int slot(int c) {
    return c < 4 ? c
           : c < 6 ? (kSimple ? c : -1)
                   : (kComplex ? c - (kSimple ? 0 : 2) : -1);
  }
};

// torch.remainder(x, 2^32) on f64: fmod, then the sign fix (exact)
__device__ __forceinline__ double mod32(double x) {
  double m = fmod(x, kTwo32);
  if (m != 0.0 && m < 0.0) m = __dadd_rn(m, kTwo32);
  return m;
}

// the low 32 bits of an integer-valued double (its value mod 2^32)
__device__ __forceinline__ unsigned low32(double p) {
  if (fabs(p) < kTwo63) return (unsigned)(unsigned long long)__double2ll_rz(p);
  return (unsigned)(unsigned long long)mod32(p);
}

// |int32 reinterpretation| as int64 (ops/countjoin.py::_abs_wrap32)
__device__ __forceinline__ long long abs32(unsigned u) {
  const long long s = (int)u;
  return s < 0 ? -s : s;
}

// the KL quotient of a row, c / max(K_a, 1)
__device__ __forceinline__ double kl_quotient(long long c, double Ka) {
  return __ddiv_rn((double)c, Ka < 1.0 ? 1.0 : Ka);
}

// the five limbs of ops/countjoin.py::_kl_limbs(x), in v[8..12]
__device__ __forceinline__ void kl_limbs(double x, long long (&v)[kChannels]) {
  const double sgn = x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
  double r = fabs(x);
  double q = floor(r);
  r = __dsub_rn(r, q);
  v[kKlFirst] = (long long)__dmul_rn(q, sgn);
#pragma unroll
  for (int l = 1; l < kKlLimbs; ++l) {
    r = __dmul_rn(r, kLimbScale);
    q = floor(r);
    r = __dsub_rn(r, q);
    v[kKlFirst + l] = (long long)__dmul_rn(q, sgn);
  }
}

// one pair's channel values (those not asked for stay 0); qa, qb the
// rows' KL quotients
__device__ __forceinline__ void pair_terms(long long ca, long long cb,
                                           double Ka, double Kb, double qa,
                                           double qb, bool simple, bool wh,
                                           bool kl,
                                           long long (&v)[kChannels]) {
#pragma unroll
  for (int c = 0; c < kChannels; ++c) v[c] = 0;
  v[0] = ca;
  v[1] = cb;
  v[2] = 1;
  v[3] = ca < cb ? ca : cb;
  if (simple) {
    const long long prod = ca * cb;
    v[4] = (long long)floor(sqrt((double)prod));
    v[5] = prod;
  }
  if (wh || kl) {
    const double xY = __dmul_rn((double)ca, Kb), yX = __dmul_rn((double)cb, Ka);
    if (wh) {
      // SimkaAlgorithm.hpp:481: the difference of the two rounded
      // products wrapped to int32
      const unsigned lx = low32(xY), ly = low32(yX);
      v[6] = abs32(lx - ly);
      v[7] = abs32(lx) + abs32(ly);
    }
    if (kl) {
      // SimkaAlgorithm.hpp:437-446
      const double den = __dadd_rn(xY, yX);
      const double d1 = __dmul_rn(qa, log(__ddiv_rn(__dmul_rn(2.0, xY), den)));
      const double d2 = __dmul_rn(qb, log(__ddiv_rn(__dmul_rn(2.0, yX), den)));
      kl_limbs(__dadd_rn(d1, d2), v);
    }
  }
}

// a (2N - a - 1) / 2: the reference's tri_idx (countjoin.py:1379) of
// (a, a + 1), the first of a's bins in the upper triangle
__device__ __forceinline__ int tri0(int a, int n) {
  return a * (2 * n - a - 1) / 2;
}

// first segment whose first row is >= row
__device__ long long first_segment_at(const long long* __restrict__ starts,
                                      long long n_segs, long long row) {
  long long lo = 0, hi = n_segs;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (starts[mid] < row) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the largest count whose products with every K_j are exact in f64
__device__ unsigned long long exact_count_limit(const double* sK, int n) {
  __shared__ double wmax[kWarps];
  double m = 0.0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmax(m, sK[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmax(m, wmax[w]);
  if (m < 1.0) return ~0ULL;  // every K_j 0: every product is 0
  if (m > (double)kExactMax) return 0;
  return kExactMax / (unsigned long long)m;
}

// The shared-memory layout: K (f64) and its low words, the row stage,
// the chunk's segments, then the partials.
struct Layout {
  double* K;
  unsigned* K_lo;
  int* sid;
  long long* cnt;
  double* q;
  unsigned* seg;  // offset | length << 16
  int4* hdr;      // a warp's 32 segment headers
  unsigned long long* part;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline size_t fixed_bytes(long long n, bool kl) {
  return align16(8 * n) + align16(4 * n) + 4 * kChunk + 8 * kChunk +
         (kl ? 8 * kChunk : 0) + 4 * kChunk + 16 * 32 * kWarps;
}

__device__ inline Layout layout(unsigned char* base, int n, bool kl) {
  Layout L;
  size_t at = 0;
  L.K = reinterpret_cast<double*>(base + at);
  at += align16(8 * (size_t)n);
  L.K_lo = reinterpret_cast<unsigned*>(base + at);
  at += align16(4 * (size_t)n);
  L.cnt = reinterpret_cast<long long*>(base + at);
  at += 8 * kChunk;
  L.q = reinterpret_cast<double*>(base + at);
  at += kl ? 8 * kChunk : 0;
  L.sid = reinterpret_cast<int*>(base + at);
  at += 4 * kChunk;
  L.seg = reinterpret_cast<unsigned*>(base + at);
  at += 4 * kChunk;
  L.hdr = reinterpret_cast<int4*>(base + at);
  at += 16 * 32 * kWarps;
  L.part = reinterpret_cast<unsigned long long*>(base + at);
  return L;
}

// the partials of one copy in group [a0, a1): the slots' bins, then
// whittaker_all's rows
__host__ __device__ inline long long copy_words(int a0, int a1, int n,
                                                int n_slots, bool wall) {
  const long long bins = (long long)a1 * (2 * n - a1 - 1) / 2 -
                         (long long)a0 * (2 * n - a0 - 1) / 2;
  return n_slots * bins + (wall ? (long long)(a1 - a0) * n : 0);
}

// rows of sid[0, L) below a (sorted, distinct)
__device__ __forceinline__ int rows_below(const int* sid, int L, int a) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sid[mid] < a) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A segment header of the pair walk: x = offset | length << 16 in the
// chunk, y = p0 | p1 << 16 the rows of the warp's samples, z the warp's
// pairs in the block's earlier segments.

template <bool kSimple, bool kComplex>
__global__ void __launch_bounds__(kThreads, 1)
pair_owner_kernel(const long long* __restrict__ sid,
                  const long long* __restrict__ count,
                  const long long* __restrict__ starts,
                  const long long* __restrict__ seg_len, long long n_rows,
                  long long n_segs, const double* __restrict__ K, int N,
                  Plan p) {
  using Set = ChannelSet<kSimple, kComplex>;
  constexpr bool kl = kComplex;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool wall = p.wall != 0;
  const Layout S = layout(smem, N, kl);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.n_groups, g = blockIdx.x % G;
  const long long share = blockIdx.x / G, n_shares = gridDim.x / G;
  const int a0 = p.bound[g], a1 = p.bound[g + 1];
  const int Wt = p.team_warps, R = kWarps / Wt;
  const int team = warp / Wt, wt = warp % Wt;
  const int A_lo = p.warp_bound[g][wt], A_hi = p.warp_bound[g][wt + 1];
  const int nb = tri0(a1, N) - tri0(a0, N), base0 = tri0(a0, N);
  const long long stride = copy_words(a0, a1, N, Set::n, wall);
  unsigned long long* const part = S.part + team * stride;
  unsigned long long* const wpart = part + (long long)Set::n * nb;
  int4* const hdr = S.hdr + warp * 32;

  for (long long i = tid; i < R * stride; i += kThreads) S.part[i] = 0;
  for (int j = tid; j < N; j += kThreads) {
    const double k = K[j];
    S.K[j] = k;
    S.K_lo[j] = k < (double)kExactMax ? (unsigned)(unsigned long long)k : 0u;
  }
  __syncthreads();
  const unsigned long long climit = exact_count_limit(S.K, N);

  // this CTA's share of the rows: whole segments
  const long long s_begin = first_segment_at(starts, n_segs,
                                             n_rows * share / n_shares);
  const long long s_end = first_segment_at(starts, n_segs,
                                           n_rows * (share + 1) / n_shares);
  const long long r_end = s_end < n_segs ? starts[s_end] : n_rows;
  long long s_c = s_begin, r_c = s_begin < n_segs ? starts[s_begin] : n_rows;

  // the next chunk, in registers
  long long rs[kPerThread], rc[kPerThread], ss[kPerThread], sl[kPerThread];
  auto load = [&](long long s0, long long r0) {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long r = r0 + tid + u * kThreads;
      const long long s = s0 + tid + u * kThreads;
      rs[u] = r < r_end ? sid[r] : -1;
      rc[u] = r < r_end ? count[r] : 0;
      ss[u] = s < s_end ? starts[s] : -1;
      sl[u] = s < s_end ? seg_len[s] : 0;
    }
  };
  if (s_c < s_end) load(s_c, r_c);

  while (s_c < s_end) {
    __syncthreads();  // the last chunk's work is done
    int complete = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int k = tid + u * kThreads;
      const long long a = rs[u];
      S.sid[k] = (int)a;
      S.cnt[k] = rc[u];
      if (kl) S.q[k] = a >= 0 ? kl_quotient(rc[u], S.K[a]) : 0.0;
      const long long off = ss[u] - r_c;
      const bool whole = ss[u] >= 0 && off + sl[u] <= kChunk;
      S.seg[k] = whole ? (unsigned)off | (unsigned)sl[u] << 16 : 0u;
      complete += whole;
    }
    const int n_seg = __syncthreads_count(complete);
    if (n_seg == 0) break;  // a segment longer than a chunk: not planned
    const unsigned last = S.seg[n_seg - 1];
    const long long r_next = r_c + (last & 0xffff) + (last >> 16);
    const long long s_next = s_c + n_seg;
    if (s_next < s_end) load(s_next, r_next);

    // the team's segments team, team + R, ..., 32 at a time
    const int n_team = n_seg > team ? (n_seg - team + R - 1) / R : 0;
    for (int t0 = 0; t0 < n_team; t0 += 32) {
      // headers, a lane a segment: the rows of the warp's samples
      int off = 0, L = 0, p0 = 0, p1 = 0;
      if (t0 + lane < n_team) {
        const unsigned pk = S.seg[team + R * (t0 + lane)];
        off = pk & 0xffff;
        L = pk >> 16;
        const int first = S.sid[off], lastsid = S.sid[off + L - 1];
        if (lastsid >= A_lo && first < A_hi) {
          p0 = first >= A_lo ? 0 : rows_below(S.sid + off, L, A_lo);
          p1 = lastsid < A_hi ? L : rows_below(S.sid + off, L, A_hi);
        }
      }
      const int m = p1 - p0;
      const int P = m * (L - 1) - m * (p0 + p1 - 1) / 2;

      if (wall) {
        // every row of the warp's samples against every bank: rows in
        // turn, lanes over the banks (a lane's banks are its own, so
        // no two lanes add into one entry)
        unsigned todo = __ballot_sync(0xffffffffu, m > 0);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int r0 = __shfl_sync(0xffffffffu, off + p0, src);
          const int r1 = __shfl_sync(0xffffffffu, off + p1, src);
          for (int r = r0; r < r1; ++r) {
            const long long c = S.cnt[r];
            unsigned long long* const row = wpart + (S.sid[r] - a0) * N;
            if ((unsigned long long)c <= climit) {
              const unsigned c_lo = (unsigned)c;
              for (int j = lane; j < N; j += 32)
                row[j] += (unsigned long long)abs32(c_lo * S.K_lo[j]);
            } else {
              for (int j = lane; j < N; j += 32)
                row[j] += (unsigned long long)abs32(
                    low32(__dmul_rn((double)c, S.K[j])));
            }
          }
        }
      }

      // the pairs (i, j), p0 <= i < p1, i < j < L, of the block's
      // segments in one flat order (segments in turn, row-major within
      // one): lanes take the flat pairs q, q + 32, ..., so every lane
      // has a pair however few a segment holds for this warp. Pairs of
      // one segment are distinct bins, but two segments may share one:
      // the lanes of one bin add in turns
      int P_inc = P;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, P_inc, o);
        if (lane >= o) P_inc += x;
      }
      const int P_all = __shfl_sync(0xffffffffu, P_inc, 31);
      const int pre = P_inc - P;
      // the segments with pairs, compacted in order into the headers
      const unsigned busy = __ballot_sync(0xffffffffu, P > 0);
      if (P > 0)
        hdr[__popc(busy & ((1u << lane) - 1))] =
            make_int4((int)((unsigned)off | (unsigned)L << 16),
                      (int)((unsigned)p0 | (unsigned)p1 << 16), pre, 0);
      __syncwarp();
      for (int base = 0; base < P_all; base += 32) {
        // flat pair q = base + lane lies in the last segment with pairs
        // that starts at or before it: those before the batch, and the
        // starts inside it (a bit a start, gathered by one reduce)
        const int q = base + lane;
        const unsigned starts = __reduce_or_sync(
            0xffffffffu, P > 0 && pre >= base && pre < base + 32
                             ? 1u << (pre - base) : 0u);
        const int before = __popc(
            __ballot_sync(0xffffffffu, P > 0 && pre < base));
        const bool valid = q < P_all;
        long long v[kChannels];
        int bin = 0;
        if (valid) {
          const int4 h =
              hdr[before + __popc(starts & (2u << lane) - 1) - 1];
          const int s_off = h.x & 0xffff, s_L = h.x >> 16;
          int r = q - h.z, i = h.y & 0xffff;
          while (r >= s_L - 1 - i) {
            r -= s_L - 1 - i;
            ++i;
          }
          const int ri = s_off + i, rj = s_off + i + 1 + r;
          const int a = S.sid[ri], b = S.sid[rj];
          pair_terms(S.cnt[ri], S.cnt[rj], kComplex ? S.K[a] : 0.0,
                     kComplex ? S.K[b] : 0.0, kl ? S.q[ri] : 0.0,
                     kl ? S.q[rj] : 0.0, kSimple, kComplex, kComplex, v);
          bin = tri0(a, N) - base0 + (b - a - 1);
        }
        // lanes holding one bin add in turns: a lane's turn is its rank
        // among them (pairs of one segment are distinct bins, so only
        // pairs of different segments share one)
        const unsigned peers = __match_any_sync(0xffffffffu,
                                                valid ? bin : -1 - lane);
        const unsigned turn = __popc(peers & ((1u << lane) - 1));
        const unsigned turns = __reduce_max_sync(0xffffffffu, turn);
        for (unsigned t = 0; t <= turns; ++t) {
          if (valid && turn == t) {
#pragma unroll
            for (int c = 0; c < kChannels; ++c)
              if (Set::slot(c) >= 0)
                part[Set::slot(c) * nb + bin] += (unsigned long long)v[c];
          }
          __syncwarp();
        }
      }
      __syncwarp();  // the headers are rewritten for the next block
    }
    s_c = s_next;
    r_c = r_next;
  }

  // the flush: the copies summed, each nonzero bin added once
  __syncthreads();
  const int n_own = a1 - a0;
  for (int e = tid; e < n_own * N; e += kThreads) {
    const int a = a0 + e / N, b = e - (e / N) * N;
    const long long at = (long long)a * N + b;
    if (wall) {
      unsigned long long x = 0;
      for (int t = 0; t < R; ++t)
        x += S.part[t * stride + (long long)Set::n * nb + e];
      if (x) atomicAdd(p.out[kWall] + at, x);
    }
    if (b <= a) continue;
    const int bin = tri0(a, N) - base0 + (b - a - 1);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      if (Set::slot(c) < 0) continue;
      unsigned long long x = 0;
      for (int t = 0; t < R; ++t)
        x += S.part[t * stride + Set::slot(c) * nb + bin];
      if (x) atomicAdd(p.out[c] + at * (c >= kKlFirst ? kKlLimbs : 1), x);
    }
  }
}

// The global form: every pair's adds and every all-rows term straight
// into the outputs with 64-bit global atomics.
__global__ void __launch_bounds__(kThreads)
pair_global_kernel(const long long* __restrict__ sid,
                   const long long* __restrict__ count,
                   const long long* __restrict__ starts,
                   const long long* __restrict__ seg_len, long long n_rows,
                   long long n_segs, const double* __restrict__ K,
                   long long n_banks, Plan p) {
  __shared__ long long seg_end, row_begin, row_end;
  __shared__ unsigned long long next_seg;
  const bool simple = p.slot[4] >= 0 || p.slot[5] >= 0;
  const bool wh = p.slot[6] >= 0 || p.slot[7] >= 0;
  const bool kl = p.kl != 0;
  if (threadIdx.x == 0) {
    const long long r0 = n_rows * blockIdx.x / gridDim.x;
    const long long r1 = n_rows * (blockIdx.x + 1) / gridDim.x;
    const long long s0 = first_segment_at(starts, n_segs, r0);
    next_seg = (unsigned long long)s0;
    seg_end = first_segment_at(starts, n_segs, r1);
    row_begin = s0 < n_segs ? starts[s0] : n_rows;
    row_end = seg_end < n_segs ? starts[seg_end] : n_rows;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long s_end = seg_end;
  if (p.wall) {
    // every row of the share against every bank
    const long long r0 = row_begin, terms = (row_end - r0) * n_banks;
    for (long long t = threadIdx.x; t < terms; t += blockDim.x) {
      const long long r = r0 + t / n_banks, j = t - (t / n_banks) * n_banks;
      const double Kj = K[j];
      const long long x = abs32(low32(__dmul_rn((double)count[r], Kj)));
      if (x) atomicAdd(p.out[kWall] + sid[r] * n_banks + j,
                       (unsigned long long)x);
    }
  }
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(&next_seg, 32ULL);
    const long long s0 = (long long)__shfl_sync(0xffffffffu, base, 0);
    if (s0 >= s_end) break;
    const long long s = s0 + lane;
    long long len = 0, first = 0;
    if (s < s_end) {
      len = seg_len[s];
      if (len >= 2) first = starts[s];
    }
    unsigned todo = __ballot_sync(0xffffffffu, len >= 2);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int L = (int)__shfl_sync(0xffffffffu, len, src);
      const long long at = __shfl_sync(0xffffffffu, first, src);
      const long long pairs = (long long)L * (L - 1) / 2;
      // pair q = (d - 1) L + i is rows (i, i + d mod L); q steps by 32
      const int step = 32 / L, rem = 32 % L;
      int i = lane % L, d = 1 + lane / L;
      for (long long q = lane; q < pairs; q += 32) {
        int j = i + d;
        if (j >= L) j -= L;
        const long long lo = at + (i < j ? i : j), hi = at + (i < j ? j : i);
        const long long a = sid[lo], b = sid[hi];
        const long long ca = count[lo], cb = count[hi];
        const double Ka = (wh || kl) ? K[a] : 0.0, Kb = (wh || kl) ? K[b] : 0.0;
        long long v[kChannels];
        pair_terms(ca, cb, Ka, Kb, kl ? kl_quotient(ca, Ka) : 0.0,
                   kl ? kl_quotient(cb, Kb) : 0.0, simple, wh, kl, v);
        const long long bin = a * n_banks + b;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          if (p.slot[c] < 0) continue;
          atomicAdd(p.out[c] + bin * (c >= kKlFirst ? kKlLimbs : 1),
                    (unsigned long long)v[c]);
        }
        i += rem;
        d += step;
        if (i >= L) {
          i -= L;
          d += 1;
        }
      }
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return (int)err;
}

// the shared form with channel set (kSimple, kComplex), when the
// caller's slots are that set's
template <bool kSimple, bool kComplex>
int launch_owner(const long long* s, const long long* c, const long long* st,
                 const long long* ln, long long n_rows, long long n_segs,
                 const double* K, long long n_banks, const Plan& p,
                 const int* slots, size_t smem, int sms, long long grid,
                 cudaStream_t stream) {
  using Set = ChannelSet<kSimple, kComplex>;
  for (int ch = 0; ch < kChannels; ++ch)
    if (slots[ch] != Set::slot(ch)) return (int)cudaErrorInvalidValue;
  auto kernel = pair_owner_kernel<kSimple, kComplex>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long shares = (long long)sms * per_sm / p.n_groups;
  if (shares > grid) shares = grid;
  if (shares < 1) shares = 1;
  kernel<<<(unsigned)(shares * p.n_groups), kThreads, smem, stream>>>(
      s, c, st, ln, n_rows, n_segs, K, (int)n_banks, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {


// The bytes of partials one CTA of the shared form may hold at N =
// n_banks on the current device (with the KL limbs on: kl != 0): 0 when
// the row stage and K alone fill its shared memory (the global form
// then), -1 when the device cannot be read.
int64_t simka_pair_sums_budget(int64_t n_banks, int kl) {
  int optin = 0;
  if (optin_smem(&optin) != 0) return -1;
  const int64_t left =
      (int64_t)optin - kStaticSmem - (int64_t)fixed_bytes(n_banks, kl != 0);
  return left > 0 ? left : 0;
}

// sid, count: [n_rows] int64 solid rows in (k-mer, sample) order; starts,
// seg_len: [n_segs] int64 segments (starts ascending, from 0, each at
// most kChunk rows in the shared form); K: [n_banks] f64. outs: 14
// device pointers (null where off): channels 0-7 [n_banks^2] int64, 8-12
// the KL limbs' first elements of the [n_banks^2, 5] int64 limbs, 13
// whittaker_all [n_banks^2] int64. slots: 13 ints, each channel's slot
// in the partials (consecutive from 0), -1 when off. shared: 1 for the
// shared form, planned by n_groups sample groups (bounds: n_groups + 1
// samples from 0 to n_banks) and teams of team_warps warps (warp_bounds:
// n_groups x (team_warps + 1) samples, group g's from bounds[g] to
// bounds[g + 1]); 0 for the global form (the plan is not read). Returns
// a cudaError_t code (0 on success).
int simka_pair_sums(const int64_t* sid, const int64_t* count,
                    const int64_t* starts, const int64_t* seg_len,
                    int64_t n_rows, int64_t n_segs, const double* K,
                    int64_t n_banks, void* const* outs, const int* slots,
                    int shared, int n_groups, int team_warps,
                    const int* bounds, const int* warp_bounds,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows < 1 || n_segs < 1 || n_banks < 1)
    return (int)cudaErrorInvalidValue;
  Plan p = {};
  p.n_slots = 0;
  for (int c = 0; c < kOuts; ++c)
    p.out[c] = static_cast<unsigned long long*>(outs[c]);
  for (int c = 0; c < kChannels; ++c) {
    p.slot[c] = slots[c];
    if (slots[c] >= kChannels || (slots[c] >= 0 && outs[c] == nullptr))
      return (int)cudaErrorInvalidValue;
    if (slots[c] >= 0) p.n_slots = p.n_slots > slots[c] + 1 ? p.n_slots : slots[c] + 1;
  }
  p.wall = outs[kWall] != nullptr;
  p.kl = 0;
  for (int l = 0; l < kKlLimbs; ++l) p.kl |= slots[kKlFirst + l] >= 0;
  if (p.n_slots == 0 && !p.wall) return (int)cudaErrorInvalidValue;
  const long long* s = reinterpret_cast<const long long*>(sid);
  const long long* c = reinterpret_cast<const long long*>(count);
  const long long* st = reinterpret_cast<const long long*>(starts);
  const long long* ln = reinterpret_cast<const long long*>(seg_len);
  int sms = 0, err = sm_count(&sms);
  if (err) return err;
  long long grid = (n_rows + kRowsPerCta - 1) / kRowsPerCta;

  if (!shared) {
    int per_sm = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pair_global_kernel, kThreads, 0);
    if (err) return err;
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
    if (grid < 1) grid = 1;
    pair_global_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
        s, c, st, ln, n_rows, n_segs, K, n_banks, p);
    return (int)cudaGetLastError();
  }

  // the shared form's plan
  if (n_banks > 0x7fff || n_groups < 1 || n_groups > kMaxGroups ||
      team_warps < 1 || team_warps > kWarps || kWarps % team_warps)
    return (int)cudaErrorInvalidValue;
  p.n_groups = n_groups;
  p.team_warps = team_warps;
  long long words = 0;
  for (int g = 0; g <= n_groups; ++g) {
    p.bound[g] = bounds[g];
    if ((g == 0 && bounds[0] != 0) || (g == n_groups && bounds[g] != n_banks) ||
        (g > 0 && bounds[g] <= bounds[g - 1]))
      return (int)cudaErrorInvalidValue;
  }
  for (int g = 0; g < n_groups; ++g) {
    const int* wb = warp_bounds + g * (team_warps + 1);
    for (int w = 0; w <= team_warps; ++w) {
      p.warp_bound[g][w] = wb[w];
      if ((w == 0 && wb[0] != bounds[g]) ||
          (w == team_warps && wb[w] != bounds[g + 1]) ||
          (w > 0 && wb[w] < wb[w - 1]))
        return (int)cudaErrorInvalidValue;
    }
    const long long cw = copy_words(bounds[g], bounds[g + 1], (int)n_banks,
                                    p.n_slots, p.wall);
    words = words > cw ? words : cw;
  }
  int optin = 0;
  if ((err = optin_smem(&optin))) return err;
  const size_t smem = fixed_bytes(n_banks, p.kl) +
                      (size_t)(kWarps / team_warps) * (size_t)words * 8;
  if (smem + kStaticSmem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const bool simple = slots[4] >= 0, complex_ = slots[6] >= 0;
  if (simple && complex_)
    return launch_owner<true, true>(s, c, st, ln, n_rows, n_segs, K,
                                    n_banks, p, slots, smem, sms, grid,
                                    stream);
  if (simple)
    return launch_owner<true, false>(s, c, st, ln, n_rows, n_segs, K,
                                     n_banks, p, slots, smem, sms, grid,
                                     stream);
  if (complex_)
    return launch_owner<false, true>(s, c, st, ln, n_rows, n_segs, K,
                                     n_banks, p, slots, smem, sms, grid,
                                     stream);
  return launch_owner<false, false>(s, c, st, ln, n_rows, n_segs, K, n_banks,
                                    p, slots, smem, sms, grid, stream);
}

}  // extern "C"
