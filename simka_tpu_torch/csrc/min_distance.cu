// SimkaMin's sketch-pair tallies (Hopper, sm_90a): a merge path across
// CTAs.
//
// Replaces the XLA program simka_tpu/minhash/device_distance.py::
// _pair_kernel with _bitonic_merge (:31-166; not Pallas). The reference
// walk (SimkaMinDistance.hpp:215-258) merges two ascending hash lists
// and stops after min(lA, lB) union elements or when a list runs out.
// Per pair the kernel stores four int64 tallies: processed (distinct),
// shared_distinct, nb_kmers (the counts of processed elements of both
// lists) and shared_kmers (min(cA, cB) over processed shared elements).
// The caller turns them into Jaccard and Bray-Curtis once, so the kernel
// and its plain torch version (minhash/device_distance.py::
// pair_tallies_plain) agree bit for bit by construction. Integers only:
// the output is deterministic.
//
// The inclusion rule. Let t = min(A[lA - 1], B[lB - 1]) (unsigned) and
// L = min(lA, lB). A union element x is processed exactly when
//     x <= t  and  rank(x) <= L,
// rank(x) its 1-based rank in the union. Ranks rise with value, so
// rank(x) <= rank(t) iff x <= t, and `processed` = min(L, rank(t)) is
// just the count of included distinct elements: no tally waits for a
// global count.
//
// The merged order. Merge A[0, na) and B[0, nb) (na = #A<=t, nb =
// #B<=t), A first on a tie. A sketch's hashes are distinct, so a shared
// value takes two adjacent merged positions, its A copy then its B copy
// (a "dup"). With Dincl(m) the dups at merged positions <= m, the
// element at position m has rank(m) = m + 1 - Dincl(m) (a dup the rank
// of its A copy). rank(m) >= (m + 1) / 2, so nothing at m >= 2L is
// included: the walk covers positions [0, M), M = min(na + nb, 2L).
// A position is included iff rank(m) <= L; a shared value is counted
// once, at its dup, which reads its A copy's count (its cA, cB min).
//
// Design: the merged order of every pair is cut into segments of kSeg =
// 4,096 positions, one segment a CTA task.
//   1. pair_setup (a warp a pair): t, na and nb (a 32-way search of the
//      list that does not end at t), M; zeroes the pair's tallies.
//   2. pair_partition (a thread a segment boundary): the merge-path
//      split, the number of A elements among the first d = k kSeg
//      positions, by a diagonal binary search (~21 steps at s =
//      1,000,000; ~12 when a window around its expected place, from the
//      lists' densities, brackets it); zeroes the segment's status word.
//   3. min_pair_tallies: a persistent grid (the SMs x the CTAs resident
//      on each) takes tickets in segment-major order (ticket = k P + p:
//      segment k of every pair before segment k + 1 of any). A
//      segment's predecessors in its pair are then P tickets back, long
//      done when P fills the card, and the concurrent segments of many
//      pairs read the same region of each sample, from L2. A segment
//      stages A[i0 - 1, i1) (a one-element halo: the B copy that opens
//      a segment, when it equals the last A element of the segment
//      before, is a dup) and B[j0, j1), hashes and counts, with 16-byte
//      cp.async copies whose shared addresses share the global ones'
//      residue mod 16. Each of 256 threads merges 16 positions of its
//      own from a diagonal search in shared memory, the current element
//      of each side in registers, no branch a step; it counts its dups
//      and the tallies as if every position were included.
//   4. The segment's exclusive dup count D (its rank offset) comes by a
//      decoupled look-back over its pair's segments, the pattern of
//      csrc/compact.cu: a 64-bit status word a segment, flag in the top
//      two bits (A: its dup count; P: the inclusive count; PAST: the
//      segment and every later one include nothing). A segment whose
//      positions all have m + 1 <= L ("lower") needs no prefix: it
//      publishes P when its predecessor's P is already there, else A.
//      Past L a segment is included wholly (d1 - D - dups <= L), not at
//      all (d0 - D > L) or in part (one segment a pair: a second walk
//      with each position's rank).
//   5. Past-skip: a segment past L first looks back without waiting;
//      when its predecessors resolve, it publishes PAST without loading
//      its spans if d0 - D > L (or a predecessor is PAST). Otherwise it
//      loads, publishes A, waits for its prefix, then publishes P or
//      PAST. (Plain look-back, every segment loading, took 1.6x as long
//      at N=100 x s=1,000,000 and 1.2x at 28 pairs; pair-major tickets
//      3.8x and 2.5x: NVIDIA H100 80GB HBM3, 700 W.)
//   6. Tallies: 64-bit atomics of each segment's block sums into the
//      zeroed [P, 4] output: integer sums, deterministic.
// No host sync: the grid needs only the wrapper's bound K on segments a
// pair (from the lengths); segments at d0 >= M exit at once.
//
// What bounds it. A pair's walk needs the union elements of rank <=
// processed: processed + shared_distinct members, 12 B each (hash and
// count). Each sample's longest needed prefix over its pairs, read
// once from device memory, is 0.66 GB at N=100 x s=1,000,000 (4,950
// pairs): 0.20 ms at 3.35 TB/s. The merge's integer work, a 64-bit
// compare and a 64-bit add a member (4 32-bit instructions), is 5.4 G
// members there: 1.29 ms at 16.75 T a second, the bound. This kernel
// took 24.77 ms there (5.2%) and 0.26 ms at 28 pairs of 1,000,000 (7.6%
// of 0.020 ms; NVIDIA H100 80GB HBM3, 700 W). It stages each pair's
// members through L2 anew (65 GB at N=100: 5.5 ms at the 11.7 TB/s
// L2 read rate one torch.sum reached on that card); segment-major
// tickets let the ~500 concurrent segments of N=100's pairs read the
// same few MB of the 100 samples from L2. Where the time goes inside a
// segment (staging, the merge in shared memory, the look-back) is not
// measured.
//
// History: the simple form this replaces (one CTA a pair, two passes
// over chunks of 1,024 staged in shared memory, A read twice) took
// 147.55 ms at N=100 x 1,000,000 and 10.15 ms at `min pipeline`'s 28
// pairs of 1,000,000 (NVIDIA H100 80GB HBM3, 700 W). A design before
// it, every search in device memory, took 682.6 and 75.0 ms there (same
// card).
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the scratch, the output and the stream; the entry
// point returns the first cudaError_t of its three launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;               // merged positions a thread
constexpr int kSeg = kThreads * kPer;  // merged positions a segment
constexpr int kMinBlocks = 4;          // CTAs an SM (shared memory)
// shared slots: the A span with its halo, the B span, and the shifts
// that give each span its global address's residue mod 16
constexpr int kHashSlots = kSeg + 4;
constexpr int kCountSlots = kSeg + 8;
constexpr int kInfo = 6;  // per pair: offA, offB, L, M, na, nb

constexpr uint64_t kFlagA = 1ull << 62;     // segment dup count
constexpr uint64_t kFlagP = 2ull << 62;     // inclusive dup count
constexpr uint64_t kFlagPast = 3ull << 62;  // nothing from here on
constexpr uint64_t kFlagMask = 3ull << 62;
constexpr uint64_t kValMask = kFlagA - 1;

enum : int { kPending = 0, kResolved = 1, kPast = 2 };
constexpr int kMaxSpins = 1 << 26;  // polls of one status word, ~tens of s

template <class T>
__device__ __forceinline__ T mn(T a, T b) {
  return a < b ? a : b;
}

template <class T>
__device__ __forceinline__ T mx(T a, T b) {
  return a < b ? b : a;
}

// The status word carries flag and count together: relaxed stores and
// loads at gpu scope (as csrc/compact.cu).
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"((uint64_t)__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

// Stage n elements of T (8 or 4 bytes) from src to dst, dst and src
// equal mod 16: the body by 16-byte cp.async, the elements before the
// first 16-byte boundary and after the last by plain copies.
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int mis = (int)(((uintptr_t)src & 15) / sizeof(T));
  const int head = mn(mis == 0 ? 0 : kVec - mis, n);
  const int body = (n - head) / kVec;
  const int tail = n - head - body * kVec;
  for (int e = threadIdx.x; e < body; e += kThreads)
    cp_async16(dst + head + e * kVec, src + head + e * kVec);
  const int t = (int)threadIdx.x;
  if (t < head) dst[t] = src[t];
  if (t >= 32 && t - 32 < tail) {
    const int e = n - tail + (t - 32);
    dst[e] = src[e];
  }
}

// First index in [lo, hi) where the monotone predicate (true, then
// false) is false, hi if none: a 32-way search by the calling warp.
template <class Pred>
__device__ __forceinline__ int64_t warp_search(int64_t lo, int64_t hi,
                                               Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + lane * step;
    const unsigned m = __ballot_sync(0xffffffffu, i < hi && pred(i));
    const int c = __popc(m);  // the true lanes are a prefix
    if (c == 0) return lo;
    const int64_t base = lo;
    lo = base + (int64_t)(c - 1) * step + 1;
    hi = mn(hi, base + (int64_t)c * step);
  }
  const int64_t i = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, i < hi && pred(i)));
}

// The merge-path split: A elements among the first d merged positions
// of A[0, na) and B[0, nb), A first on a tie, by binary search. It starts
// from the window of +-kSplitWindow around d na / (na + nb) when the
// window brackets the split (two probes): uniform hashes put it within
// ~sqrt(d) / 2 of there.
constexpr int64_t kSplitWindow = 1024;

__device__ __forceinline__ int64_t diag_split(const uint64_t* A, int64_t na,
                                              const uint64_t* B, int64_t nb,
                                              int64_t d) {
  // A[i] is among the first d positions (true, then false as i grows)
  const auto first = [&](int64_t i) { return A[i] <= B[d - 1 - i]; };
  int64_t lo = mx<int64_t>(0, d - nb), hi = mn(d, na);
  const int64_t guess = mn(
      mx((int64_t)((double)d * (double)na / (double)(na + nb)), lo), hi);
  const int64_t wl = mx(lo, guess - kSplitWindow);
  const int64_t wh = mn(hi, guess + kSplitWindow);
  if ((wl == lo || first(wl - 1)) && (wh == hi || !first(wh))) {
    lo = wl;
    hi = wh;
  }
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (first(mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// 1. per pair (a warp): offsets, L, M, na, nb; the tallies zeroed.
__global__ void pair_setup(const uint64_t* __restrict__ h1,
                           const int64_t* __restrict__ off1,
                           const int64_t* __restrict__ len1,
                           const uint64_t* __restrict__ h2,
                           const int64_t* __restrict__ off2,
                           const int64_t* __restrict__ len2,
                           const int32_t* __restrict__ ii,
                           const int32_t* __restrict__ jj, int64_t P,
                           int64_t* __restrict__ info,
                           unsigned long long* __restrict__ counter,
                           int64_t* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g == 0) *counter = 0;
  const int64_t p = g >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const int64_t i = ii[p], j = jj[p];
  const int64_t la = len1[i], lb = len2[j], oa = off1[i], ob = off2[j];
  const int64_t L = mn(la, lb);
  int64_t na = 0, nb = 0;
  if (L > 0) {
    const uint64_t* A = h1 + oa;
    const uint64_t* B = h2 + ob;
    const uint64_t a_last = A[la - 1], b_last = B[lb - 1];
    const uint64_t t = mn(a_last, b_last);
    const auto in_a = [&](int64_t x) { return A[x] <= t; };
    const auto in_b = [&](int64_t x) { return B[x] <= t; };
    na = a_last <= t ? la : warp_search(0, la, in_a);
    nb = b_last <= t ? lb : warp_search(0, lb, in_b);
  }
  if (lane == 0) {
    int64_t* f = info + kInfo * p;
    f[0] = oa;
    f[1] = ob;
    f[2] = L;
    f[3] = mn(na + nb, 2 * L);
    f[4] = na;
    f[5] = nb;
  }
  if (lane < 4) out[4 * p + lane] = 0;
}

// 2. per segment boundary k in [0, K] of pair p (thread k + (K + 1) p):
// split[k P + p] = the merge-path split at min(k kSeg, M); the status
// words of segments k < K zeroed.
__global__ void pair_partition(const uint64_t* __restrict__ h1,
                               const uint64_t* __restrict__ h2, int64_t P,
                               int64_t K, const int64_t* __restrict__ info,
                               int64_t* __restrict__ split,
                               uint64_t* __restrict__ status) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= P * (K + 1)) return;
  const int64_t p = g / (K + 1), k = g - p * (K + 1);
  const int64_t* f = info + kInfo * p;
  const int64_t M = f[3];
  const int64_t d = mn<int64_t>(k * kSeg, M);
  split[k * P + p] =
      d == 0 ? 0 : diag_split(h1 + f[0], f[4], h2 + f[1], f[5], d);
  if (k < K) status[k * P + p] = 0;
}

struct Task {
  int64_t t;  // ticket; >= P K when the tickets are spent
  int64_t p, k, offA, offB, L, M, i0, i1;
};

struct Smem {
  uint64_t h[kHashSlots];  // hashes: [sa] halo, A span, then B span
  uint32_t c[kCountSlots];  // their counts, the same layout
  Task task;
  int64_t prefix;           // the segment's exclusive dup count
  int state;                // the look-back's outcome
  int warp_tot[kWarps];
  unsigned long long red[4][kWarps];
};

// The look-back of segment k over its pair's segments k - 1, k - 2, ...
// (status words `stride` apart from `st`), by one warp: kResolved with
// the exclusive dup count in D, kPast, or (only when !block, a
// predecessor not yet published) kPending.
__device__ int look_back(const uint64_t* st, int64_t k, int64_t stride,
                         bool block, int64_t& D) {
  const int lane = threadIdx.x & 31;
  D = 0;
  for (int64_t end = k;; end -= 32) {
    const int64_t kk = end - 32 + lane;
    uint64_t v = kFlagP;  // before segment 0: an inclusive count of 0
    if (kk >= 0) {
      v = ld_relaxed(st + kk * stride);
      // every predecessor publishes without waiting on a later ticket;
      // one that never does is a fault: trap rather than hang
      for (int spin = 0; block && (v & kFlagMask) == 0; ++spin) {
        if (spin == kMaxSpins) __trap();
        v = ld_relaxed(st + kk * stride);
      }
    }
    const uint64_t f = v & kFlagMask;
    if (__any_sync(0xffffffffu, f == kFlagPast)) return kPast;
    const unsigned pm = __ballot_sync(0xffffffffu, f == kFlagP);
    const int hi = pm ? 31 - __clz((int)pm) : -1;  // nearest P
    const unsigned above = hi >= 31 ? 0u : ~0u << (hi + 1);
    if (__ballot_sync(0xffffffffu, f == 0) & above) return kPending;
    int64_t c = lane >= hi ? (int64_t)(v & kValMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    D += c;
    if (pm) return kResolved;
  }
}

// One thread's merge of positions [q0, q0 + n) of the staged spans
// A[0, nA) (A[-1] the halo when `halo`) and B[0, nB), counts cA, cB:
// f(position, count, dup, count of the A element before) for each; a
// dup is a B element equal to the A element before it. The current
// element of each side and the last A element stay in registers, so a
// step loads one hash and one count from shared memory, without a
// branch (a divergent branch would run both sides' loads a step).
template <class F>
__device__ __forceinline__ void walk(const uint64_t* sA, const uint32_t* cA,
                                     int nA, const uint64_t* sB,
                                     const uint32_t* cB, int nB, bool halo,
                                     int q0, int n, F&& f) {
  if (n <= 0) return;
  int lo = mx(0, q0 - nB), hi = mn(q0, nA);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sA[mid] <= sB[q0 - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ia = lo, jb = q0 - lo;
  // a read one past a span stays inside the staged buffer, and its value
  // is never used: no step branches on which side it takes
  uint64_t a = sA[ia], b = sB[jb];
  const bool has_prev0 = ia > 0 || halo;
  bool has_prev = has_prev0;
  uint64_t a_prev = has_prev0 ? sA[ia - 1] : 0;
  uint32_t c_prev = has_prev0 ? cA[ia - 1] : 0;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    if (s >= n) break;
    const bool ta = jb >= nB || (ia < nA && a <= b);
    const uint32_t c = *(ta ? cA + ia : cB + jb);
    f(s, c, !ta && has_prev && a_prev == b, c_prev);
    a_prev = ta ? a : a_prev;
    c_prev = ta ? c : c_prev;
    has_prev = has_prev || ta;
    ia += ta ? 1 : 0;
    jb += ta ? 0 : 1;
    const uint64_t v = *(ta ? sA + ia : sB + jb);
    a = ta ? v : a;
    b = ta ? b : v;
  }
}

struct Tally {
  unsigned long long processed = 0, shared = 0, kmers = 0, shared_kmers = 0;
};

__device__ __forceinline__ void block_sum(Smem& s, Tally& t) {
  unsigned long long v[4] = {t.processed, t.shared, t.kmers, t.shared_kmers};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[r] += __shfl_down_sync(0xffffffffu, v[r], o);
    if ((threadIdx.x & 31) == 0) s.red[r][threadIdx.x >> 5] = v[r];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      unsigned long long a = 0;
      for (int w = 0; w < kWarps; ++w) a += s.red[r][w];
      v[r] = a;
    }
    t = {v[0], v[1], v[2], v[3]};
  }
}

// 3. the segments; status[k P + p] of segment k of pair p.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    min_pair_tallies(const uint64_t* __restrict__ h1,
                     const uint32_t* __restrict__ c1,
                     const uint64_t* __restrict__ h2,
                     const uint32_t* __restrict__ c2, int64_t P, int64_t K,
                     const int64_t* __restrict__ info,
                     const int64_t* __restrict__ split,
                     uint64_t* __restrict__ status,
                     unsigned long long* __restrict__ counter,
                     unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tickets = P * K;
  unsigned long long next = 0;  // thread 0: the next ticket, in flight
  if (tid == 0) next = atomicAdd(counter, 1ull);
  while (true) {
    if (tid == 0) {
      Task& g = s.task;
      g.t = (int64_t)next;
      if (g.t < tickets) {
        next = atomicAdd(counter, 1ull);
        g.k = g.t / P;
        g.p = g.t - g.k * P;
        const int64_t* f = info + kInfo * g.p;
        g.offA = f[0];
        g.offB = f[1];
        g.L = f[2];
        g.M = f[3];
        g.i0 = split[g.k * P + g.p];
        g.i1 = split[(g.k + 1) * P + g.p];
      }
    }
    __syncthreads();
    const Task g = s.task;
    if (g.t >= tickets) break;
    const int64_t d0 = g.k * kSeg;
    if (d0 >= g.M) {
      __syncthreads();  // every thread has read s.task
      continue;
    }
    const int64_t d1 = mn<int64_t>(d0 + kSeg, g.M);
    const bool lower = d1 <= g.L;
    uint64_t* st = status + g.k * P + g.p;
    const uint64_t* st0 = status + g.p;  // segment 0 of the pair

    // past L: look back without waiting (past-skip)
    int state = kPending;
    int64_t D = 0;
    if (!lower) {
      if (warp == 0) {
        int64_t d;
        const int r = look_back(st0, g.k, P, false, d);
        if (lane == 0) {
          s.state = r;
          s.prefix = d;
        }
      }
      __syncthreads();
      state = s.state;
      D = s.prefix;
      if (state == kPast || (state == kResolved && d0 - D > g.L)) {
        if (tid == 0) st_relaxed(st, kFlagPast);
        __syncthreads();  // s.task, s.state read
        continue;
      }
    }

    // stage A[i0 - halo, i1) and B[j0, j1), each at its residue mod 16
    const int halo = g.i0 > 0 ? 1 : 0;
    const int nA = (int)(g.i1 - g.i0), n = (int)(d1 - d0), nB = n - nA;
    const int64_t j0 = d0 - g.i0;
    const uint64_t* gA = h1 + g.offA + g.i0 - halo;
    const uint64_t* gB = h2 + g.offB + j0;
    const uint32_t* gcA = c1 + g.offA + g.i0 - halo;
    const uint32_t* gcB = c2 + g.offB + j0;
    const int ha = (int)(((uintptr_t)gA >> 3) & 1);
    int hb = ha + halo + nA;
    hb += (int)((((uintptr_t)gB >> 3) - hb) & 1);
    const int ca = (int)(((uintptr_t)gcA >> 2) & 3);
    int cb = ca + halo + nA;
    cb += (int)((((uintptr_t)gcB >> 2) - cb) & 3);
    stage(s.h + ha, gA, halo + nA);
    stage(s.h + hb, gB, nB);
    stage(s.c + ca, gcA, halo + nA);
    stage(s.c + cb, gcB, nB);
    cp_async_wait_all();
    __syncthreads();
    const uint64_t* sA = s.h + ha + halo;
    const uint64_t* sB = s.h + hb;
    const uint32_t* sCA = s.c + ca + halo;
    const uint32_t* sCB = s.c + cb;

    // pass 1: this thread's dups and its tallies with every position
    // included
    const int q0 = tid * kPer;
    const int cnt = mx(0, mn(kPer, n - q0));
    int dups = 0;
    Tally all;
    walk(sA, sCA, nA, sB, sCB, nB, halo != 0, q0, cnt,
         [&](int, uint32_t c, bool dup, uint32_t c_prev) {
           all.kmers += c;
           if (dup) {
             dups += 1;
             all.shared += 1;
             all.shared_kmers += mn(c_prev, c);
           } else {
             all.processed += 1;
           }
         });
    // block scan of the dups: this thread's exclusive count, the total
    int incl = dups;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s.warp_tot[warp] = incl;
    __syncthreads();
    int before = 0, agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s.warp_tot[w] : 0;
      agg += s.warp_tot[w];
    }
    const int excl = before + incl - dups;

    // the prefix, and what this segment includes
    if (lower) {
      if (tid == 0) {
        uint64_t v = 0;
        if (g.k > 0) v = ld_relaxed(st - P);
        if (g.k == 0 || (v & kFlagMask) == kFlagP)
          st_relaxed(st, kFlagP | ((v & kValMask) + (uint64_t)agg));
        else
          st_relaxed(st, kFlagA | (uint64_t)agg);
      }
    } else {
      if (state != kResolved) {
        if (tid == 0) st_relaxed(st, kFlagA | (uint64_t)agg);
        if (warp == 0) {
          int64_t d;
          const int r = look_back(st0, g.k, P, true, d);
          if (lane == 0) {
            s.state = r;
            s.prefix = d;
          }
        }
        __syncthreads();
        state = s.state;
        D = s.prefix;
      }
      const bool past = state == kPast || d0 - D > g.L;
      if (tid == 0)
        st_relaxed(st, past ? kFlagPast : kFlagP | (uint64_t)(D + agg));
      if (past) {
        all = Tally();
      } else if (d1 - (D + agg) > g.L) {
        // the cut-off is inside: pass 2 with each position's rank
        Tally part;
        int64_t dseen = D + excl;
        const int64_t m0 = d0 + q0;
        walk(sA, sCA, nA, sB, sCB, nB, halo != 0, q0, cnt,
             [&](int q, uint32_t c, bool dup, uint32_t c_prev) {
               dseen += dup ? 1 : 0;
               if (m0 + q + 1 - dseen > g.L) return;
               part.kmers += c;
               if (dup) {
                 part.shared += 1;
                 part.shared_kmers += mn(c_prev, c);
               } else {
                 part.processed += 1;
               }
             });
        all = part;
      }
    }
    block_sum(s, all);  // ends with a barrier: s.task and the spans read
    if (tid == 0) {
      unsigned long long* o = out + 4 * g.p;
      if (all.processed) atomicAdd(o, all.processed);
      if (all.shared) atomicAdd(o + 1, all.shared);
      if (all.kmers) atomicAdd(o + 2, all.kmers);
      if (all.shared_kmers) atomicAdd(o + 3, all.shared_kmers);
    }
  }
}

}  // namespace

extern "C" {

// merged positions a segment: the wrapper bounds the segments a pair
// by ceil(min(lA + lB, 2 min(lA, lB)) / this)
int simka_min_pair_segment() { return kSeg; }

// int64 words of scratch for P pairs of at most K segments:
// [0, 2) the ticket counter; [2, 2 + 6 P) the pairs' info; then the
// splits [(K + 1) P]; then the status words [K P].
int64_t simka_min_pair_scratch_words(int64_t P, int64_t K) {
  return 2 + kInfo * P + (K + 1) * P + K * P;
}

// h1/h2: the two sides' hash streams (uint64 bits); c1/c2: their counts
// (uint32 bits); off1/len1, off2/len2: [n1], [n2] int64 rows of each
// sample in its stream; ii/jj: [P] int32 sample indices of each pair;
// K: segments a pair at most (>= 1); scratch: simka_min_pair_scratch_words(P, K) int64;
// out: [P, 4] int64 (processed, shared_distinct, nb_kmers,
// shared_kmers). Returns a cudaError_t code (0 on success).
int simka_min_pair_tallies(const uint64_t* h1, const uint32_t* c1,
                           const int64_t* off1, const int64_t* len1,
                           const uint64_t* h2, const uint32_t* c2,
                           const int64_t* off2, const int64_t* len2,
                           const int32_t* ii, const int32_t* jj, int64_t P,
                           int64_t K, int64_t* scratch,
                           int64_t* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (P < 1 || K < 1) return (int)cudaErrorInvalidValue;
  unsigned long long* counter =
      reinterpret_cast<unsigned long long*>(scratch);
  int64_t* info = scratch + 2;
  int64_t* split = info + kInfo * P;
  uint64_t* status = reinterpret_cast<uint64_t*>(split + (K + 1) * P);

  const int64_t setup_blocks = (P * 32 + kThreads - 1) / kThreads;
  pair_setup<<<(unsigned)setup_blocks, kThreads, 0, stream>>>(
      h1, off1, len1, h2, off2, len2, ii, jj, P, info, counter, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t part_blocks = (P * (K + 1) + kThreads - 1) / kThreads;
  pair_partition<<<(unsigned)part_blocks, kThreads, 0, stream>>>(
      h1, h2, P, K, info, split, status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the persistent grid: the SMs x the CTAs resident on each (computed
  // once a device)
  static int grid_dev = -1, grid_size = 0;
  const int smem = (int)sizeof(Smem);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != grid_dev) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(min_pair_tallies,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, min_pair_tallies, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    grid_dev = dev;
    grid_size = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tickets = P * K;
  const int64_t grid = tickets < grid_size ? tickets : grid_size;
  min_pair_tallies<<<(unsigned)grid, kThreads, smem, stream>>>(
      h1, c1, h2, c2, P, K, info, split, status, counter,
      reinterpret_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
