// Hopper counterparts of the TPU capability probes (sm_90a).
//
// The JAX package probed what Mosaic (the TPU kernel compiler) accepts
// with small Pallas kernels under scripts/profiling/:
//   test_pallas_basic.py   f1..f6  elementwise bodies and HBM<->VMEM DMAs
//                                  at static, dynamic and unaligned offsets
//   test_mosaic_reshape.py k1..k7  reshapes, one-hots, a bf16 one-hot
//                                  product, concat + slice
//   test_mosaic_features.py ka..ke a bf16 x^T x, per-lane shifts, sublane
//                                  slices, a product under a device-side
//                                  predicate, a max-reduce predicate
//   test_dma_align.py      run     the f6 copy at offsets {0, 128, 131, 777}
// Each entry point below computes what one or more of those kernels
// compute, at their shapes, with the Hopper feature that answers the
// same question:
//   - simka_probe_dma: the DMAs become 1-D bulk copies (cp.async.bulk,
//     the TMA's non-tensor form) global -> shared with an mbarrier and
//     shared -> global with a bulk group. A bulk copy needs 16-byte
//     aligned global and shared addresses and a size that is a multiple
//     of 16 bytes, so an int32 span at an arbitrary element offset is
//     split: the elements before the first 16-byte boundary and after
//     the last one go by plain loads and stores ("peeled"), the aligned
//     body by one bulk copy. The split is reported per copy in `info`.
//   - simka_probe_gram_bf16: the bf16 dot_generals contracting dim 0
//     (k6, ka, kd) become a tensor-core product split over the rows:
//     each CTA bulk-copies a 64-row chunk into shared memory, converts
//     it to bf16 there and runs ldmatrix.trans + mma.sync m16n8k16
//     (bf16 x bf16 -> f32) for its [128, 128] partial; a second kernel
//     sums the partials in a fixed order. kd's lax.cond becomes a
//     device-side flag read by the kernels (no host sync), written by
//     simka_probe_max_positive: a grid-wide reduce in one launch, the
//     last CTA combining (a one-CTA reduce of kd's 1 MB took 42.6 us on
//     an H100 against torch.amax's 5.9 us).
//   - simka_probe_map: the elementwise bodies, one template kernel over
//     (element type, op), the op chosen on the host at the launch.
//   - simka_probe_onehot_f32: k3's and k5's one-hot rows, a warp a row
//     in 16-byte stores.
// What bounds them: the launch. At these sizes (<= 1 MB, one or two
// launches each) the least time the card could take for the work is
// 0.002-0.3 us (the product's 1 MB of x over 3.35 TB/s is 0.33 us, its
// 67 MFLOP over 989 TFLOP/s bf16 0.07 us; a DMA window's 8 KB 0.0024
// us), under the card's shortest kernel: a one-element fill_ takes
// 0.99 us on the device (an H100 80GB HBM3 at 700 W; chip_smoke.py's
// phase 4, PERF.md section 6). No design removes that floor; what
// a design can remove is the time a kernel spends past it. The DMA
// kernel cuts its serial chain (the barrier set up during the offset's
// read, loads issued as soon as the source is known, one shared buffer
// where the residues agree, and a wait on the bulk store's
// shared-memory reads only, not on its global writes); what stays past
// the floor is its two bulk copies' round trips and, where it has one,
// the offset's read. The elementwise kernel moves 16 bytes a thread
// with 32-bit indices on a grid sized to the work, with no per-element
// switch. They are capability and correctness probes, timed for the
// record.
//
// Plain C interface for ctypes; nothing here allocates or
// synchronises. Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The card's SM count, for grids of at most one wave.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// ---- the elementwise probes: one template kernel over (type, op) ----
//
// out[i] = op(x[i], i) over n < 2^31 elements, 32-bit indices. Each
// thread moves 4 elements by one 16-byte load and one 16-byte store
// (float4 / int4) from the first 16-byte boundary of x; the up to 3
// elements before it and the up to 3 after the last whole vector go by
// scalar loads and stores. x and out share their address mod 16 (the
// wrapper allocates out so), so one boundary serves both. The grid
// covers the vectors once, up to one wave. The op is a template
// argument, chosen on the host at the launch (simka_probe_map's codes).

enum : int {
  kScaleF32 = 0,  // x * mul (f32)                    f1, k2
  kMul = 1,       // x * arg                          f2
  kAdd = 2,       // x + arg                          k1, k4 (arg = 1)
  kRollAdd1 = 3,  // x[(i + arg) % n] + 1             k7 (concat + slice [5:])
  kRollSum = 4,   // x[(i + arg) % n] + x[i]          kc (w[3:] + w[:n])
  kLaneByte = 5,  // (x >> (i % arg % 4 * 8)) & 255   kb, arg = lanes
  kSelect = 6,    // *flag ? x : 2 x                  ke
};

constexpr int kMapThreads = 256;

struct I32Op {
  using T = int32_t;
  using V = int4;
  static constexpr bool kFlag = false;
};

struct ScaleF32 {
  using T = float;
  using V = float4;
  static constexpr bool kFlag = false;
  float mul;
  __device__ T operator()(T v, uint32_t, const T*) const { return v * mul; }
};

struct MulI32 : I32Op {
  int32_t arg;
  __device__ T operator()(T v, uint32_t, const T*) const {
    return wrap_mul(v, arg);
  }
};

struct AddI32 : I32Op {
  int32_t arg;
  __device__ T operator()(T v, uint32_t, const T*) const {
    return wrap_add(v, arg);
  }
};

// the rolled operand x[(i + shift) % n] is not 16-byte aligned: a
// scalar load (0 <= shift <= n < 2^31, so i + shift fits 32 bits)
struct RollAdd1 : I32Op {
  uint32_t shift, n;
  __device__ T operator()(T, uint32_t i, const T* x) const {
    uint32_t j = i + shift;
    if (j >= n) j -= n;
    return wrap_add(x[j], 1);
  }
};

struct RollSum : I32Op {
  uint32_t shift, n;
  __device__ T operator()(T v, uint32_t i, const T* x) const {
    uint32_t j = i + shift;
    if (j >= n) j -= n;
    return wrap_add(x[j], v);
  }
};

struct LaneByte : I32Op {
  uint32_t lanes;
  __device__ T operator()(T v, uint32_t i, const T*) const {
    return (v >> (i % lanes % 4 * 8)) & 255;
  }
};

struct Select : I32Op {
  static constexpr bool kFlag = true;
  const int32_t* flag;
  bool take;  // *flag != 0, read once a CTA
  __device__ T operator()(T v, uint32_t, const T*) const {
    return take ? v : wrap_mul(v, 2);
  }
};

template <class Op>
__global__ void __launch_bounds__(kMapThreads)
    probe_map(const typename Op::T* __restrict__ x,
              typename Op::T* __restrict__ out, uint32_t n, uint32_t head,
              Op op) {
  using V = typename Op::V;
  if constexpr (Op::kFlag) {
    __shared__ int32_t taken;
    if (threadIdx.x == 0) taken = *op.flag;
    __syncthreads();
    op.take = taken != 0;
  }
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t nv = (n - head) / 4;
  const V* xv = reinterpret_cast<const V*>(x + head);
  V* ov = reinterpret_cast<V*>(out + head);
  for (uint32_t q = g; q < nv; q += gridDim.x * blockDim.x) {
    const V v = xv[q];
    const uint32_t i = head + 4 * q;
    ov[q] = V{op(v.x, i, x), op(v.y, i + 1, x), op(v.z, i + 2, x),
              op(v.w, i + 3, x)};
  }
  // the scalar head [0, head) and tail [head + 4 nv, n)
  if (g < n - 4 * nv) {
    const uint32_t i = g < head ? g : g + 4 * nv;
    out[i] = op(x[i], i, x);
  }
}

template <class Op>
int launch_map(const void* x, void* out, uint32_t n, Op op, void* stream) {
  using T = typename Op::T;
  // elements before x's first 16-byte boundary (x is 4-byte aligned)
  uint32_t head = (uint32_t)((16 - ((uintptr_t)x & 15)) & 15) / 4;
  if (head > n) head = n;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // one thread a vector (a thread for the scalar ends when there is no
  // vector), up to one wave of 2048 / kMapThreads CTAs an SM
  const int64_t work = (n - head) / 4 > 0 ? (n - head) / 4 : n;
  int64_t blocks = (work + kMapThreads - 1) / kMapThreads;
  const int64_t wave = (int64_t)sms * (2048 / kMapThreads);
  if (blocks > wave) blocks = wave;
  probe_map<Op><<<(unsigned)blocks, kMapThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, head, op);
  return (int)cudaGetLastError();
}

// out[r, c] = (x[r] >= 0 && x[r] == c) ? 1 : 0 over [rows, cols]: k3
// (x == iota) and k5 (the same under the x >= 0 mask, which c >= 0
// already implies). What bounds it is its stores (1 MB at k3's and k5's
// [2048, 128], 0.31 us at 3.35 TB/s), under the launch floor. A warp a
// row: lane 0 loads the row's value once and __shfl_sync shares it, and
// each lane writes the float4 of its four columns with one 16-byte
// store, so a warp writes a 128-column row (512 bytes) in one coalesced
// pass (wider rows in more passes). The float4s are zeros, stored while
// the value's load is in flight; the lane that stored the float4 of
// column x[r] then stores its 1 (one thread, so program order puts the
// 1 after the zero). A first form that waited for the value before its
// stores took 1.43 us a launch on an H100, 0.31 us over a 1 MB
// zero_()'s 1.12 us (PERF.md, section 6). cols is a multiple of 4 and out
// 16-byte aligned (the host entry checks both); indices are 32-bit,
// and the grid covers the rows up to one wave.
constexpr int kOnehotThreads = 256;

__global__ void probe_onehot_f32(const int32_t* __restrict__ x,
                                 float4* __restrict__ out, uint32_t rows,
                                 uint32_t cols4) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t warps = gridDim.x * (blockDim.x >> 5);
  // r is the same in every lane of a warp: the loop and the shuffle are
  // warp-uniform
  for (uint32_t r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       r < rows; r += warps) {
    int32_t v = 0;
    if (lane == 0) v = __ldg(x + r);
    float4* row = out + r * cols4;
    for (uint32_t q = lane; q < cols4; q += 32)
      row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    v = __shfl_sync(0xffffffffu, v, 0);
    // column v's float4 is q = v / 4, stored by lane q % 32
    if (v >= 0 && (uint32_t)v < 4 * cols4 && (uint32_t)v / 4 % 32 == lane)
      reinterpret_cast<float*>(row)[v] = 1.f;
  }
}

// *flag = max(float(x)) > 0 (ke's and kd's predicate): that is, some
// element > 0, since float(v) > 0 iff v > 0 for an int32 v. NaN inputs
// are not expected (a NaN compares false, as fmaxf would drop it).
// A grid-wide reduce in one launch, no host sync: enough CTAs to cover
// the card, each reducing a slice with 16-byte loads (__syncthreads_or);
// the last CTA to take a ticket writes the flag. The combine state is
// the caller's zeroed scratch (a ticket counter and an accumulator), not
// a device global, so launches on any streams never share it; the last
// CTA zeroes it again, so a caller may reuse it for a later launch.
constexpr int kPredThreads = 256;

template <class T, class V>
__device__ __forceinline__ bool any_positive(const void* x, int64_t n) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = ((uintptr_t)x & 15) == 0 ? n / 4 : 0;
  const V* v = static_cast<const V*>(x);
  const T* e = static_cast<const T*>(x);
  bool any = false;
  for (int64_t i = g; i < n4; i += stride) {
    const V q = __ldg(v + i);
    any |= (q.x > 0) | (q.y > 0) | (q.z > 0) | (q.w > 0);
  }
  for (int64_t i = 4 * n4 + g; i < n; i += stride) any |= e[i] > 0;
  return any;
}

__global__ void __launch_bounds__(kPredThreads)
    probe_max_positive(int is_i32, const void* __restrict__ x, int64_t n,
                       int32_t* __restrict__ flag,
                       unsigned int* __restrict__ scratch) {
  const bool any = __syncthreads_or(
      is_i32 ? any_positive<int32_t, int4>(x, n)
             : any_positive<float, float4>(x, n));
  if (threadIdx.x == 0) {
    unsigned int* ticket = scratch;
    unsigned int* acc = scratch + 1;
    if (any) atomicOr(acc, 1u);
    __threadfence();
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      __threadfence();
      *flag = atomicExch(acc, 0u) != 0 ? 1 : 0;
      atomicExch(ticket, 0u);
    }
  }
}

// ---- tensor cores: out = A^T A, A [rows, 128] in bf16 ----
//
// The contraction over rows is split across CTAs: CTA c takes rows
// [64 c, 64 c + 64) of x, brings them into shared memory with one 1-D
// bulk copy (cp.async.bulk + mbarrier), converts them there to bf16
// once (mode 0: f32 x rounded to nearest even, ka and kd; mode 1: the
// one-hot A[r][c] = (x[r] == c % mod) of an int32 x [rows], k6), and
// computes its whole [128, 128] f32 partial on the tensor cores: eight
// warps, each a 64 x 32 block, with ldmatrix.trans fragments (the
// chunk is stored [row][col], and both operands of the dim-0
// contraction are its transpose in mma's terms) into mma.sync
// m16n8k16. A second kernel sums the partials in chunk order, so runs
// are bit-identical and integer inputs stay exact. A flag (nullable)
// at 0 makes the first kernel return before any load and the second
// write zeros (kd's lax.cond false branch).

constexpr int kGramCols = 128;
constexpr int kGramChunk = 64;                // rows of x per CTA
constexpr int kGramThreads = 256;             // 8 warps: 2 (m) x 4 (n)
constexpr int kGramStride = kGramCols + 8;    // bf16 row stride: 272 B puts
                                              // ldmatrix's 8 rows in
                                              // distinct banks
constexpr int kGramXBytes = kGramChunk * kGramCols * 4;
constexpr int kGramSmem =
    kGramXBytes + kGramChunk * kGramStride * 2;  // 50,176 B

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

__global__ void __launch_bounds__(kGramThreads)
    probe_gram_partial(int mode, const void* __restrict__ x,
                       float* __restrict__ part, int mod,
                       const int32_t* __restrict__ flag) {
  extern __shared__ __align__(16) unsigned char gram_smem[];
  __shared__ __align__(8) uint64_t bar;
  if (flag != nullptr && *flag == 0) return;
  float* xs = reinterpret_cast<float*>(gram_smem);
  __nv_bfloat16* as =
      reinterpret_cast<__nv_bfloat16*>(gram_smem + kGramXBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t chunk = blockIdx.x;
  const uint32_t bytes =
      mode == 0 ? (uint32_t)kGramXBytes : (uint32_t)(kGramChunk * 4);
  const char* src = static_cast<const char*>(x) + chunk * bytes;
  const uint32_t bar_a = (uint32_t)__cvta_generic_to_shared(&bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_a),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(
            (uint32_t)__cvta_generic_to_shared(xs)),
        "l"((uint64_t)src), "r"(bytes), "r"(bar_a)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_a), "r"(0u)
        : "memory");
  }
  // the chunk in bf16, rows padded to kGramStride
  if (mode == 0) {
    for (int i = tid; i < kGramChunk * kGramCols / 4; i += kGramThreads) {
      const float4 v = reinterpret_cast<const float4*>(xs)[i];
      const int r = i / (kGramCols / 4), c = i % (kGramCols / 4) * 4;
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(as + r * kGramStride + c);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    const int32_t* xi = reinterpret_cast<const int32_t*>(xs);
    for (int i = tid; i < kGramChunk * kGramCols; i += kGramThreads) {
      const int r = i / kGramCols, c = i % kGramCols;
      as[r * kGramStride + c] =
          __float2bfloat16(xi[r] == c % mod ? 1.f : 0.f);
    }
  }
  __syncthreads();

  // warp block: out rows [m_base, m_base + 64), cols [n_base, +32)
  const int m_base = (warp >> 2) * 64, n_base = (warp & 3) * 32;
  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, t = lane & 3;
  float acc[4][4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kGramChunk; k0 += 16) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)  // a0..a3: (m 0-7|8-15) x (k 0-7|8-15)
      ldmatrix_x4_trans(a[mt], as + (k0 + r8 + (q >> 1) * 8) * kGramStride +
                                   m_base + mt * 16 + (q & 1) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np)  // b0, b1 of n-tile 2 np, then 2 np + 1
      ldmatrix_x4_trans(b[np], as + (k0 + r8 + (q & 1) * 8) * kGramStride +
                                   n_base + np * 16 + (q >> 1) * 8);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t b0 = b[nt >> 1][(nt & 1) * 2];
        const uint32_t b1 = b[nt >> 1][(nt & 1) * 2 + 1];
        float* d = acc[mt][nt];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
              "r"(b0), "r"(b1));
      }
  }
  // D fragment: rows g / g + 8, columns 2t, 2t + 1
  float* o = part + chunk * kGramCols * kGramCols;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m_base + mt * 16 + g, n = n_base + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(o + m * kGramCols + n) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + (m + 8) * kGramCols + n) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// out[i] = sum of part[c][i] over chunks c in order (0 when *flag == 0)
__global__ void probe_gram_reduce(const float* __restrict__ part, int chunks,
                                  float* __restrict__ out, int n,
                                  const int32_t* __restrict__ flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  if (flag == nullptr || *flag != 0)
    for (int c = 0; c < chunks; ++c) s += part[(int64_t)c * n + i];
  out[i] = s;
}

// ---- bulk copies (TMA, 1-D) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// [head, body, tail] elements of an int32 span of len elements at
// address addr: head up to the first 16-byte boundary, body a multiple
// of 16 bytes, tail the rest.
struct Split {
  int64_t mis;  // elements past the 16-byte boundary below addr
  int64_t head, body, tail;
};

__device__ __forceinline__ Split split16(const void* addr, int64_t len) {
  Split s;
  s.mis = (int64_t)(((uintptr_t)addr >> 2) & 3);
  s.head = s.mis == 0 ? 0 : 4 - s.mis;
  if (s.head > len) s.head = len;
  s.body = (len - s.head) / 4 * 4;
  s.tail = len - s.head - s.body;
  return s;
}

// One CTA: out[dst, dst + len) = x[src, src + len) + 1 via shared
// memory, src = off * off_scale + src_add and dst = off * off_scale +
// dst_add, with off = *off_ptr read on the device (0 without one): f3
// (static span), f4 (row tile 0:8 -> 8:16), f5 (dynamic row tile), f6
// and test_dma_align.py (dynamic, unaligned). A shared buffer starts at
// the same residue mod 16 as its global span, so the aligned bodies line
// up. kSame (the load's and the store's residues equal: f3, f4, f5):
// one buffer, the +1 done in place. Otherwise (f6, dma_align: the store
// lies 37 elements on) a load buffer and a store buffer, the +1 on the
// way from one to the other. The chain is cut to what depends: the
// barrier is set up while the offset's read is in flight, the bulk load
// and the peeled loads (+1 straight into the store buffer) go out as
// soon as src is known, and the CTA waits on its bulk store only until
// shared memory has been read (the kernel's end orders the writes).
// info[0..2]: load head/bulk/tail elements; info[3..5]: the store's;
// info[6]: 1 when the span was out of bounds (nothing copied).
template <bool kSame>
__global__ void __launch_bounds__(1024)
    probe_dma_add1(const int32_t* __restrict__ x, int64_t x_len,
                   int32_t* __restrict__ out, int64_t out_len,
                   const int32_t* __restrict__ off_ptr, int64_t off_scale,
                   int64_t src_add, int64_t dst_add, int len,
                   int32_t* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int last = blockDim.x - 1 - tid;  // peeled work goes to the last
                                          // threads, thread 0 to the bulk
  const uint32_t bar_a = smem_u32(&bar);
  const int64_t off = off_ptr ? (int64_t)off_ptr[0] : 0;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int64_t src = off * off_scale + src_add;
  const int64_t dst = off * off_scale + dst_add;
  if (src < 0 || dst < 0 || src + len > x_len || dst + len > out_len) {
    if (tid == 0) info[6] = 1;
    return;
  }
  const Split ld = split16(x + src, len);
  const Split st = split16(out + dst, len);
  int32_t* in_s = reinterpret_cast<int32_t*>(smem_raw) + ld.mis;
  int32_t* out_s =
      kSame ? in_s
            : reinterpret_cast<int32_t*>(smem_raw) + (len + 7) / 4 * 4 + st.mis;
  if (tid == 0) {
    if (ld.body > 0) {
      const uint32_t bytes = (uint32_t)(ld.body * 4);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar_a),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(in_s + ld.head)),
          "l"((uint64_t)(x + src + ld.head)), "r"(bytes), "r"(bar_a)
          : "memory");
    }
    info[0] = (int32_t)ld.head;
    info[1] = (int32_t)ld.body;
    info[2] = (int32_t)ld.tail;
    info[3] = (int32_t)st.head;
    info[4] = (int32_t)st.body;
    info[5] = (int32_t)st.tail;
    info[6] = 0;
  }
  if (last < ld.head + ld.tail) {
    const int e = last < ld.head ? last : (int)ld.body + last;
    out_s[e] = wrap_add(x[src + e], 1);
  }
  __syncthreads();  // the barrier's init, seen by every thread that waits
  if (ld.body > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar_a), "r"(0u)
          : "memory");
    }
    // the loaded body, 16 bytes a thread, + 1 into the store buffer
    const int4* in4 = reinterpret_cast<const int4*>(in_s + ld.head);
    for (int q = tid; q < ld.body / 4; q += blockDim.x) {
      const int4 v = in4[q];
      const int4 r = {wrap_add(v.x, 1), wrap_add(v.y, 1), wrap_add(v.z, 1),
                      wrap_add(v.w, 1)};
      if (kSame) {
        reinterpret_cast<int4*>(out_s + ld.head)[q] = r;
      } else {
        int32_t* o = out_s + ld.head + 4 * q;
        o[0] = r.x;
        o[1] = r.y;
        o[2] = r.z;
        o[3] = r.w;
      }
    }
  }
  // generic-proxy writes to shared memory, visible to the bulk store
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0 && st.body > 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            (uint64_t)(out + dst + st.head)),
        "r"(smem_u32(out_s + st.head)), "r"((uint32_t)(st.body * 4))
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // shared memory must outlive the copy's reads only
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (last < st.head + st.tail) {
    const int e = last < st.head ? last : (int)st.body + last;
    out[dst + e] = out_s[e];
  }
}

}  // namespace

extern "C" {

// out[i] = op(x[i]) over n int32 or f32 elements (the enum above); arg
// for the int32 ops, mul for kScaleF32, flag for kSelect. x and out must
// share their address mod 16.
int simka_probe_map(int op, const void* x, void* out, int64_t n, int32_t arg,
                    float mul, const int32_t* flag, void* stream) {
  if (n < 1 || n >= (int64_t(1) << 31) || ((uintptr_t)x & 3) ||
      (((uintptr_t)x ^ (uintptr_t)out) & 15) ||
      (op == kSelect && flag == nullptr) || (op == kLaneByte && arg < 1) ||
      ((op == kRollAdd1 || op == kRollSum) && (arg < 0 || arg > n)))
    return (int)cudaErrorInvalidValue;
  const uint32_t m = (uint32_t)n;
  switch (op) {
    case kScaleF32: return launch_map(x, out, m, ScaleF32{mul}, stream);
    case kMul: return launch_map(x, out, m, MulI32{{}, arg}, stream);
    case kAdd: return launch_map(x, out, m, AddI32{{}, arg}, stream);
    case kRollAdd1:
      return launch_map(x, out, m, RollAdd1{{}, (uint32_t)arg, m}, stream);
    case kRollSum:
      return launch_map(x, out, m, RollSum{{}, (uint32_t)arg, m}, stream);
    case kLaneByte:
      return launch_map(x, out, m, LaneByte{{}, (uint32_t)arg}, stream);
    case kSelect: return launch_map(x, out, m, Select{{}, flag, false}, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// rows >= 1, cols a positive multiple of 4, rows x cols < 2^31; out
// 16-byte aligned.
int simka_probe_onehot_f32(const int32_t* x, float* out, int64_t rows,
                           int cols, void* stream) {
  if (rows < 1 || cols < 4 || cols % 4 ||
      rows * cols >= (int64_t(1) << 31) || ((uintptr_t)x & 3) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // a warp a row, up to one wave of 2048 / kOnehotThreads CTAs an SM
  constexpr int kWarps = kOnehotThreads / 32;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  const int64_t wave = (int64_t)sms * (2048 / kOnehotThreads);
  if (blocks > wave) blocks = wave;
  probe_onehot_f32<<<(unsigned)blocks, kOnehotThreads, 0,
                     (cudaStream_t)stream>>>(
      x, reinterpret_cast<float4*>(out), (uint32_t)rows,
      (uint32_t)(cols / 4));
  return (int)cudaGetLastError();
}

// scratch: two zeroed uint32 words (left zeroed again).
int simka_probe_max_positive(int is_i32, const void* x, int64_t n,
                             int32_t* flag, unsigned int* scratch,
                             void* stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // a 16-byte load a thread, up to two CTAs an SM
  int64_t blocks = (n / 4 + kPredThreads - 1) / kPredThreads;
  if (blocks > 2 * (int64_t)sms) blocks = 2 * (int64_t)sms;
  if (blocks < 1) blocks = 1;
  probe_max_positive<<<(unsigned)blocks, kPredThreads, 0,
                       (cudaStream_t)stream>>>(is_i32, x, n, flag, scratch);
  return (int)cudaGetLastError();
}

// out [128, 128] f32 = A^T A over rows (a multiple of 64); part: f32
// scratch [rows / 64, 128, 128]; x 16-byte aligned.
int simka_probe_gram_bf16(int mode, const void* x, float* out, int64_t rows,
                          int cols, int mod, const int32_t* flag, float* part,
                          void* stream) {
  if ((mode != 0 && mode != 1) || rows < kGramChunk || rows % kGramChunk ||
      cols != kGramCols || (mode == 1 && mod < 1) || ((uintptr_t)x & 15))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_gram_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGramSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int chunks = (int)(rows / kGramChunk);
  probe_gram_partial<<<chunks, kGramThreads, kGramSmem,
                       (cudaStream_t)stream>>>(mode, x, part, mod, flag);
  const int n = kGramCols * kGramCols;
  probe_gram_reduce<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(part, chunks, out, n, flag);
  return (int)cudaGetLastError();
}

// len <= 4096; shared memory: one buffer of len + 4 int32 (rounded to
// 16 bytes), two when the load's and the store's residues differ; one
// thread per 4 elements (a whole number of warps).
int simka_probe_dma(const int32_t* x, int64_t x_len, int32_t* out,
                    int64_t out_len, const int32_t* off, int64_t off_scale,
                    int64_t src_add, int64_t dst_add, int64_t len,
                    int32_t* info, void* stream) {
  if (len < 1 || len > 4096) return (int)cudaErrorInvalidValue;
  // x + src and out + dst differ by the same number of elements mod 4
  // for every off, so the host knows whether the residues are equal
  const bool same = ((((uintptr_t)x >> 2) - ((uintptr_t)out >> 2) +
                      (uint64_t)src_add - (uint64_t)dst_add) & 3) == 0;
  const size_t buf = (size_t)((len + 7) / 4 * 4) * sizeof(int32_t);
  const int threads = (int)((len + 127) / 128 * 32);
  if (same)
    probe_dma_add1<true><<<1, threads, buf, (cudaStream_t)stream>>>(
        x, x_len, out, out_len, off, off_scale, src_add, dst_add, (int)len,
        info);
  else
    probe_dma_add1<false><<<1, threads, 2 * buf, (cudaStream_t)stream>>>(
        x, x_len, out, out_len, off, off_scale, src_add, dst_add, (int)len,
        info);
  return (int)cudaGetLastError();
}

}  // extern "C"
