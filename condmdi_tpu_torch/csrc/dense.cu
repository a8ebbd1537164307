// Float32 dense layer for Hopper (sm_90a):  y[M, N] = x[M, K] . W[N, K]^T + b[N]
// in float32, on the TF32 tensor cores, three products per operand pair.
//
// Replaces no TPU kernel. The JAX package leaves MDM's Dense projections to XLA
// (condmdi_tpu/models/mdm.py `QDense`, precision "float"), and so did the port
// (`F.linear`), where cuBLAS runs float32 GEMMs on the CUDA cores with TF32 off:
// 43 TFLOP/s at the evaluation shape (M = 64 x 197 rows, K and N 512 to 1536),
// ~64% of the card's 67 TFLOP/s outside the tensor cores. This kernel takes
// that path to the tensor cores without giving up float32: each operand is
// split into two TF32 values, hi = rna_tf32(v) and lo = rna_tf32(v - hi), which
// together carry v to ~2^-22 of |v|, and the product is
//     x.W^T ~ x_lo.W_hi^T + x_hi.W_lo^T + x_hi.W_hi^T
// (the lo.lo term, ~2^-22 of |x||W|, is dropped): float32's error, at a third
// of the TF32 rate (495 / 3 = 165 TFLOP/s of the layer's own operations).
//
// What bounds it on an H100: operations. At the evaluation shape the four
// projections are 4.2e11 FLOP a forward against ~100 MB of operands and
// results, 2.6 ms at 165 TFLOP/s against 0.03 ms at 3.35 TB/s.
//
// The design:
//   * W is split once per parameter (ops/dense.py `SplitDenseWeight`, its
//     plain version `split_weight`) into hi and lo planes [2, N, K] float32:
//     K-major, the only layout TF32 wgmma reads, and torch's [out, in]. x is
//     read as it lies, float32, and split in registers: no pass through
//     device memory.
//   * Persistent and warp-specialised: one CTA an SM walks the 128-row x BN
//     output tiles (BN 128, or 64 where the 128-wide tiles are fewer than the
//     SMs; ops/dense.py `tile_n`). One thread of a producer warpgroup keeps a
//     ring of stages in flight by TMA: x's 128 x 32 box and W's two BN x 32
//     boxes, each row of 128 bytes under the 128-byte swizzle; rows and
//     columns past M, N and K arrive as zeros, so the ragged tile needs no
//     masking until the store. The producer gives up registers (setmaxnreg)
//     to the consumers: at 288 threads with no such handover ptxas ran out of
//     registers and serialised the wgmmas, a third slower.
//   * Two consumer warpgroups, 64 rows each, share the stage's W. Each thread
//     reads its m64nNk8 A fragment of x from shared memory (conflict-free under
//     the swizzle), splits it with cvt.rna.tf32.f32 and issues three wgmma a
//     k8 step with A from registers and W's planes by descriptor; a stage's
//     twelve go out in two commit groups.
//   * The tensor cores truncate each sum into an accumulator. A stage's
//     wgmmas sum into a partial that the stage's first wgmma overwrites, the
//     small terms first, and the partial is added to the float32 sum in
//     registers, rounding to nearest (`consume` says why). The sum starts at
//     the bias, so the epilogue holds no register for it; it writes y with
//     8-byte stores, masked at M and N, while the producer fills the next
//     tile's stages. (Staging y in shared memory for TMA stores cost registers
//     that the accumulators need, and was slower.)

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is taken at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 128;            // rows of x a tile: two consumer warpgroups of 64
constexpr int kChunk = 32;          // columns of depth a stage: one 128-byte swizzle row
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block on sm_90

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 128 ? 4 : 6;
  static constexpr int kXBytes = kBM * kChunk * 4;  // 16 KB
  static constexpr int kWBytes = BN * kChunk * 4;   // one plane: 16 or 8 KB
  static constexpr int kStageBytes = kXBytes + 2 * kWBytes;
  // the stages from a 1024-byte aligned base (the swizzle's period), then the barriers
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kSmem <= kMaxSmem, "a block's shared memory");
  static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0, "1024-byte aligned planes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` of copies which will complete on the barrier
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase with this parity is complete. A wait that never
// ends is a fault of the protocol: trap, so that the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins > (1u << 24)) __trap();
  } while (!done);
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major operand stored as rows of 128 bytes under the 128-byte
// swizzle, the layout a TMA box of 32 float32 columns lands in: 8-row groups
// 1024 bytes apart; a k8 step moves the start 32 bytes along the row.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

#define CONDMDI_D8(d, o)                                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64 x N] (+)= a[64 x 8] . b[8 x N] in TF32 (scale_d 0 overwrites d): a in registers (this thread's
// m64nNk8 fragment: rows g and g + 8 of its warp's 16, columns t and t + 4, with
// g = lane / 4 and t = lane % 4), b K-major in shared memory by descriptor.
template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : CONDMDI_D8(d, 0), CONDMDI_D8(d, 8), CONDMDI_D8(d, 16), CONDMDI_D8(d, 24)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : CONDMDI_D8(d, 0), CONDMDI_D8(d, 8), CONDMDI_D8(d, 16), CONDMDI_D8(d, 24),
          CONDMDI_D8(d, 32), CONDMDI_D8(d, 40), CONDMDI_D8(d, 48), CONDMDI_D8(d, 56)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
  }
};
#undef CONDMDI_D8

// This thread's A fragment of k8 step `ks` of a stage (rows g and g + 8 of its
// warp's 16, columns 8 ks + t and 8 ks + 4 + t), read from x's swizzled box and
// split into TF32 hi and lo. `row` is the byte offset of row g in the box; row
// g + 8 lies 1024 bytes on, under the same swizzle (g = row mod 8). The two
// columns are in 16-byte pieces 2 ks and 2 ks + 1 of the row.
__device__ __forceinline__ void load_split(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t row,
                                           int ks, int g, int t) {
  const uint32_t c0 = row + ((((2 * ks) ^ g) << 4) | (t << 2));
  const uint32_t c1 = row + ((((2 * ks + 1) ^ g) << 4) | (t << 2));
  float v[4];
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v[0]) : "r"(c0) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v[1]) : "r"(c0 + 1024) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v[2]) : "r"(c1) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v[3]) : "r"(c1 + 1024) : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// The small terms of k8 step `ks`, x_lo.W_hi and x_hi.W_lo, into `part` (the
// first overwrites it where `first`); and the large one, x_hi.W_hi.
template <int BN>
__device__ __forceinline__ void small_terms(float (&part)[BN / 2], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], uint32_t w_hi,
                                            uint32_t w_lo, bool first) {
  Wgmma<BN>::run(part, lo[0], lo[1], lo[2], lo[3], wgmma_desc(w_hi), first ? 0 : 1);
  Wgmma<BN>::run(part, hi[0], hi[1], hi[2], hi[3], wgmma_desc(w_lo), 1);
}
template <int BN>
__device__ __forceinline__ void large_term(float (&part)[BN / 2], const uint32_t (&hi)[4],
                                           uint32_t w_hi) {
  Wgmma<BN>::run(part, hi[0], hi[1], hi[2], hi[3], wgmma_desc(w_hi), 1);
}

// One stage's wgmmas into `part`, in two commit groups: the small terms of k8
// steps 0 and 1; then those of steps 2 and 3 and the four large terms. The
// second group's fragments are read and split while the first group runs.
template <int BN>
__device__ __forceinline__ void stage_products(float (&part)[BN / 2], uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4], uint32_t st,
                                               uint32_t row_off, int g, int t) {
  using C = Cfg<BN>;
  const uint32_t w_hi = st + C::kXBytes, w_lo = w_hi + C::kWBytes;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) load_split(hi[ks], lo[ks], st + row_off, ks, g, t);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    small_terms<BN>(part, hi[ks], lo[ks], w_hi + 32 * ks, w_lo + 32 * ks, ks == 0);
  wgmma_commit();
#pragma unroll
  for (int ks = 2; ks < 4; ++ks) load_split(hi[ks], lo[ks], st + row_off, ks, g, t);
  wgmma_fence();
#pragma unroll
  for (int ks = 2; ks < 4; ++ks)
    small_terms<BN>(part, hi[ks], lo[ks], w_hi + 32 * ks, w_lo + 32 * ks, false);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) large_term<BN>(part, hi[ks], w_hi + 32 * ks);
  wgmma_commit();
}

// What a consumer warpgroup computes: its 64 rows of each of the block's tiles.
// `bars`: the ring's full barriers, then its empty ones; `row_off`: the byte
// offset of this thread's row g in a stage's x box.
//
// The tensor cores truncate each sum into an accumulator, towards zero. Over
// all of K in one accumulator that is a bias of about K/16 ulps (PERF.md
// section 6: -1.1e-6 of |y| at K = 512, -2.1e-6 at 1024, and 1000 sampler steps
// carried it into a drift of up to 1.5e-4 rel rms). So the wgmmas sum into
// `part` over one stage (32 columns of depth) only, and `part` is then added to
// `acc` in float32 with round-to-nearest; and within a stage the eight small
// terms go first, while `part` is still ~2^-11 of its end, so that only the
// four large terms' sums truncate at its full size. That leaves -8.7e-8 of |y|
// and a rel rms error of 1.5e-7 (cuBLAS's float32: 4.1e-7), for ~10% of the
// kernel's time.
template <int BN>
__device__ __forceinline__ void consume(uint32_t base, uint32_t bars, uint32_t row_off,
                                        const float* __restrict__ bias, float* __restrict__ y,
                                        int m, int n, int n_tiles, int tiles, int chunks) {
  using C = Cfg<BN>;
  const int wt = threadIdx.x % 128, warp = wt / 32, g = (wt % 32) >> 2, t = wt & 3;
  int s = 0;
  uint32_t phase = 0;
  uint32_t hi[4][4], lo[4][4];  // a fragment set for each k8 step of a stage
  float acc[BN / 2], part[BN / 2];
  auto take = [&]() {  // the next stage, once full; returns its address
    mbarrier_wait(bars + 8 * s, phase);
    return base + s * C::kStageBytes;
  };
  auto hand_back = [&]() {  // the stage taken last is free again; on to the next
    if (wt == 0) mbarrier_arrive(bars + 8 * (C::kStages + s));
    if (++s == C::kStages) {
      s = 0;
      phase ^= 1u;
    }
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {  // the sum starts at the bias
      const int col = n0 + 8 * j + 2 * t;
      const bool in = bias != nullptr && col < n;  // n is a multiple of 16: pairs never straddle it
      acc[4 * j] = acc[4 * j + 2] = in ? __ldg(bias + col) : 0.f;
      acc[4 * j + 1] = acc[4 * j + 3] = in ? __ldg(bias + col + 1) : 0.f;
    }
    for (int c = 0; c < chunks; ++c) {
      stage_products<BN>(part, hi, lo, take(), row_off, g, t);
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      hand_back();
    }

    const int r0 = m0 + (threadIdx.x / 128) * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < n) {
        if (r0 < m)
          *reinterpret_cast<float2*>(y + (long long)r0 * n + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < m)
          *reinterpret_cast<float2*>(y + (long long)(r0 + 8) * n + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    dense_tf32x3_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                        float* __restrict__ y, int m, int n, int k) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kStages * C::kStageBytes;  // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::kStages + s); };
  auto stage_x = [&](int s) { return base + s * C::kStageBytes; };

  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int chunks = (k + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbarrier_init(full(s), 1);
      mbarrier_init(empty(s), 2);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup; one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
        for (int c = 0; c < chunks; ++c) {
          mbarrier_wait(empty(s), phase ^ 1u);
          mbarrier_arrive_expect_tx(full(s), C::kStageBytes);
          const uint32_t st = stage_x(s);
          tma_load_2d(st, &x_map, full(s), c * kChunk, m0);
          tma_load_3d(st + C::kXBytes, &w_map, full(s), c * kChunk, n0, 0);
          tma_load_3d(st + C::kXBytes + C::kWBytes, &w_map, full(s), c * kChunk, n0, 1);
          if (++s == C::kStages) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const uint32_t row_off = (uint32_t)(threadIdx.x / 128 * 64 + (threadIdx.x % 128) / 32 * 16 +
                                      (threadIdx.x % 32) / 4) * 128u;
  consume<BN>(base, bars, row_off, bias, y, m, n, n_tiles, tiles, chunks);
}

// libcuda's tensor-map encoder, taken through the runtime so that nothing
// links against libcuda itself.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major float32 array [planes, rows, cols] (planes 1 for x, 2 for W's hi
// and lo) cut in boxes of 32 columns x box_rows rows of one plane, landing as
// rows of 128 bytes under the 128-byte swizzle; what lies outside arrives as zeros.
bool encode_map(CUtensorMap* map, const void* p, int planes, int rows, int cols, int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes == 1 ? 2 : 3, const_cast<void*>(p),
                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per device and tile width: the kernel may use a block's whole shared
// memory. Gives the current device's number of SMs.
constexpr int kMaxDevices = 64;
template <int BN>
cudaError_t prepare_device(int* sm_count) {
  static std::atomic<int> sms[kMaxDevices];  // 0 until the device is prepared
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int count = sms[device].load(std::memory_order_acquire);
  if (count == 0) {
    e = cudaFuncSetAttribute(dense_tf32x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<BN>::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    sms[device].store(count, std::memory_order_release);
  }
  *sm_count = count;
  return cudaSuccess;
}

template <int BN>
int launch(const void* x, const void* w, const float* bias, float* y, int m, int k, int n,
           cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = prepare_device<BN>(&sms);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap x_map, w_map;
  if (!encode_map(&x_map, x, 1, m, k, kBM) || !encode_map(&w_map, w, 2, n, k, BN))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  dense_tf32x3_kernel<BN><<<grid, kThreads, Cfg<BN>::kSmem, stream>>>(x_map, w_map, bias, y, m, n,
                                                                     k);
  return (int)cudaGetLastError();
}

}  // namespace

// y[M, N] = x[M, K] . W^T + bias, float32. x: contiguous rows, 16-byte aligned;
// w: W's hi and lo TF32 planes [2, N, K] (ops/dense.py `split_weight`); bias:
// [N] or null; y: [M, N] contiguous. K and N multiples of 16 (ops/dense.py
// `dense_route`); tile_n 128 or 64 (`tile_n`). Launches on `stream` of the
// current device; returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int condmdi_dense_forward(const void* x, const void* w, const void* bias, void* y,
                                     int m, int k, int n, int tile_n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 || n % 16 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  if (tile_n == 128) return launch<128>(x, w, b, out, m, k, n, s);
  if (tile_n == 64) return launch<64>(x, w, b, out, m, k, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
