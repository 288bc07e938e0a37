// MurmurHash3 of canonical k-mer words with SimkaMin's keep test
// (Hopper, sm_90a).
//
// Replaces simka_tpu/minhash/device.py:50-88 (murmur3_u64_device and
// hash_kmer_words, an XLA program, not Pallas: XLA lowers its uint64
// multiplies to uint32 pairs on the TPU) and the keep test of
// hash_packed_sid_batch (device.py:572). Per window i:
//
//   h[i]    = h1 of MurmurHash3_x64_128 over the 8 little-endian bytes
//             of words[i] with the seed (Appleby's public-domain
//             algorithm for an 8-byte key: the k1 tail mix and the
//             finalisation), or all ones where valid[i] is false;
//   keep[i] = valid[i] && h[i] <= thresh, unsigned;
//   counts  = {number of valid windows, number of kept windows}.
//
// The port's int64 word of a k <= 31 k-mer is the reference's
// (hi << 32) | lo (device.py:86), so the hashes are the reference's bit
// for bit. uint64_t does the six 64 x 64 -> 64 wrapping multiplies in
// registers; the plain torch version (minhash/device.py) needs 16-bit
// limbs for them, about 250 elementwise launches.
//
// What bounds it: device-memory bandwidth. A window reads 8 + 1 bytes
// and writes 8 + 1: 18 B, so 2^24 windows move 302 MB, 0.090 ms at
// 3.35 TB/s. Its arithmetic is about 66 32-bit integer instructions a
// window (a 64-bit multiply is about 4, a 64-bit shift, xor or add 2):
// 1.1 G instructions at 2^24, 0.066 ms at 16.7 T a second (64 integer
// lanes an SM x 132 SMs x 1.98 GHz, a quarter of the 67 TFLOP/s float32
// rate, which counts 128 lanes and an FMA as two operations). So bytes
// bind, with the arithmetic close behind; one pass with every load and
// store coalesced is the design.
//
// Grid-stride over pairs of windows: a thread loads two words as one
// 16-byte vector and their two validity bytes as one 2-byte load, and
// stores the same way, so a warp moves 512 contiguous bytes of words a
// step. An odd tail, or a misaligned pointer, takes the scalar loop.
// The counts: each thread tallies its windows, a block reduces, and one
// thread a block adds the block's two sums with integer atomics:
// exact, and the same on every run.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs and the stream; the entry point returns
// the first cudaError_t of its memset and launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // 2^21 windows a grid step

constexpr uint64_t kC1 = 0x87c37b91114253d5ULL;
constexpr uint64_t kC2 = 0x4cf5ad432745937fULL;
constexpr uint64_t kF1 = 0xff51afd7ed558ccdULL;
constexpr uint64_t kF2 = 0xc4ceb9fe1a85ec53ULL;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= kF1;
  h ^= h >> 33;
  h *= kF2;
  h ^= h >> 33;
  return h;
}

// h1 of MurmurHash3_x64_128 over one 8-byte key (SimkaMinCount.hpp:248)
__device__ __forceinline__ uint64_t murmur_h1(uint64_t v, uint64_t seed) {
  uint64_t k1 = v * kC1;
  k1 = rotl64(k1, 31);
  k1 *= kC2;
  uint64_t h1 = seed ^ k1 ^ 8;  // the key's length, 8
  uint64_t h2 = seed ^ 8;
  h1 += h2;
  h2 += h1;
  return fmix64(h1) + fmix64(h2);
}

struct Window {
  uint64_t h;
  uint8_t keep;
};

__device__ __forceinline__ Window one(uint64_t w, uint8_t valid,
                                      uint64_t seed, uint64_t thresh,
                                      unsigned long long& nv,
                                      unsigned long long& nk) {
  Window out;
  out.h = valid ? murmur_h1(w, seed) : ~0ULL;
  out.keep = (valid && out.h <= thresh) ? 1 : 0;
  nv += valid ? 1 : 0;
  nk += out.keep;
  return out;
}

__global__ void __launch_bounds__(kThreads)
murmur_kmers(const uint64_t* __restrict__ words,
             const uint8_t* __restrict__ valid, int64_t E, uint64_t seed,
             uint64_t thresh, uint64_t* __restrict__ out,
             uint8_t* __restrict__ keep,
             unsigned long long* __restrict__ counts, int vec) {
  unsigned long long nv = 0, nk = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t t0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t pairs = vec ? E / 2 : 0;
  for (int64_t p = t0; p < pairs; p += stride) {
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(words)[p];
    const uint16_t v = reinterpret_cast<const uint16_t*>(valid)[p];
    const Window a = one(w.x, (uint8_t)(v & 0xff), seed, thresh, nv, nk);
    const Window b = one(w.y, (uint8_t)(v >> 8), seed, thresh, nv, nk);
    reinterpret_cast<ulonglong2*>(out)[p] = make_ulonglong2(a.h, b.h);
    reinterpret_cast<uint16_t*>(keep)[p] =
        (uint16_t)(a.keep | ((uint16_t)b.keep << 8));
  }
  for (int64_t i = 2 * pairs + t0; i < E; i += stride) {
    const Window a = one(words[i], valid[i], seed, thresh, nv, nk);
    out[i] = a.h;
    keep[i] = a.keep;
  }
  // block reduce: warp shuffles, then one partial a warp in shared memory
  for (int o = 16; o > 0; o >>= 1) {
    nv += __shfl_down_sync(0xffffffffu, nv, o);
    nk += __shfl_down_sync(0xffffffffu, nk, o);
  }
  __shared__ unsigned long long s_nv[kThreads / 32], s_nk[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_nv[warp] = nv;
    s_nk[warp] = nk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long bv = 0, bk = 0;
    for (int j = 0; j < kThreads / 32; ++j) {
      bv += s_nv[j];
      bk += s_nk[j];
    }
    if (bv) atomicAdd(&counts[0], bv);
    if (bk) atomicAdd(&counts[1], bk);
  }
}

}  // namespace

extern "C" {

// words: [E] uint64 (int64 bits); valid: [E] bool (one byte, 0 or 1);
// thresh: the keep bound as uint64 bits; out: [E] uint64; keep: [E]
// bool; counts: uint64 [2], zeroed here, ends holding (valid windows,
// kept windows). Returns a cudaError_t code (0 on success).
int simka_murmur_kmers(const uint64_t* words, const uint8_t* valid,
                       int64_t E, uint64_t seed, uint64_t thresh,
                       uint64_t* out, uint8_t* keep, uint64_t* counts,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (E < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, 2 * sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((uintptr_t)words % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)valid % 2 == 0 && (uintptr_t)keep % 2 == 0)
                      ? 1
                      : 0;
  const int64_t units = vec ? (E + 1) / 2 : E;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  murmur_kmers<<<(unsigned)blocks, kThreads, 0, stream>>>(
      words, valid, E, seed, thresh, out, keep,
      reinterpret_cast<unsigned long long*>(counts), vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
