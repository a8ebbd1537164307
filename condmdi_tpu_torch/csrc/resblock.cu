// Fused resblock half for Hopper (sm_90a):
//   Conv1d(k=5, SAME, +bias) -> GroupNorm(n_groups, eps, affine)
//   -> optional AdaGN h*(1+scale[b])+shift[b] -> Mish -> optional +res
//
// Replaces the Pallas TPU kernel condmdi_tpu/ops/resblock.py `_kernel`
// (launched by `_fused_conv_gn_mish`). The TPU tiling (VMEM budget, bt % 8,
// 128-lane cout tiles, pltpu.roll taps, one-hot segment matmuls) is not
// carried over.
//
// What bounds it on an H100: per launch 2*B*T*Cin*Cout*5 FLOPs against about
// 2*(B*T*Cin + 5*Cin*Cout + B*T*Cout (+res)) bytes in bf16. At B=8, T=200,
// 1024->1024 that is 16.8 GFLOP for ~17 MB, so the tensor cores set the
// bound (~17 us at 989 TFLOP/s); at T=25 it is 2.1 GFLOP for 10.5 MB of
// weights, so memory sets it (~3 us at 3.35 TB/s). What the kernel meets
// first at B=8 is neither: every batch item's CTAs stream the same weights
// out of L2, 100 to 200 MB per launch, at the 3.5 to 4.6 TB/s that the
// CTAs together draw from L2.
//
// bfloat16 (the served type) -- `resblock_bf16_kernel`:
//   * The weight arrives packed once per parameter (ops/resblock.py
//     `pack_conv_weight`): [Cin_pad/32, 5, Cout_pad/8, 4, 8, 8]. Its innermost
//     8 output channels x 8 input channels (128 contiguous bytes) are one core
//     matrix of wgmma's shared-memory operand, so a stage's weights are copied
//     in linear 16-byte pieces, five contiguous runs per CTA, and land in the
//     layout the tensor cores read. x rows are 16-byte aligned (the caller
//     pads Cin to a multiple of 8; the packed weight is zero there).
//   * One thread-block cluster owns one (batch item, group), so GroupNorm
//     never needs a second pass: 128 rows x 128 channels per CTA and clusters
//     along T where T > 64 (T=200: 2 CTAs), 64 rows x 64 channels and clusters
//     along the group's channels where T <= 64 (2 CTAs). B=8 gives 64 to 128
//     CTAs; rows past T are zero in the tile and computed like any other.
//   * Each CTA streams Cin in 32-channel stages (the x rows with their 2+2
//     row halo, and the stage's weights for all 5 taps) through a ring of 4
//     or 6 shared-memory buffers filled by 16-byte cp.async, two or four
//     stages in flight while the tensor cores work on the two before them;
//     rows outside [0, T) and channels past the row are zero-filled by the
//     copy itself (src-size 0), which is the SAME padding. One __syncthreads
//     per stage, no scalar load, no division in the loop. Each weight byte
//     enters a CTA once: all of the CTA's rows sit in one tile.
//   * The conv is 5 row-shifted GEMMs on one x tile, on wgmma (m64nNk16, bf16
//     in, f32 accumulate) with both operands read from shared memory by
//     descriptor, without swizzle. The x tile is stored per block of 8 input
//     channels with its rows 16 bytes apart, so any 8 consecutive rows are a
//     core matrix and tap t is the same tile 16 t bytes further on: no copy
//     per tap, no fragment in registers. A stage's 10 wgmmas are left in
//     flight while the threads start the copies two stages ahead. The
//     pre-norm tile never leaves the accumulator registers.
//   * GroupNorm statistics span the cluster: every CTA reduces its part in
//     f32 in a fixed order, the parts are exchanged through distributed
//     shared memory (map_shared_rank + cluster.sync) and summed in rank
//     order by every CTA alike: the mean first, then the centred sum of
//     squares. The per-channel vectors and the residual are fetched ahead of
//     the statistics; the epilogue runs on the registers, with Mish on the
//     fast exponential, and writes the output once.
//
// float32 (the sampling CLIs and evaluation run the UNet in float32, as the JAX
// CLIs do) -- `f32::resblock_f32_kernel`, the same structure on hi and lo bf16
// planes: the tensor cores take no float32 operand short of TF32 (10 mantissa
// bits), so x = x_hi + x_lo and w = w_hi + w_lo (each part bf16) and the conv
// is x_hi.w_hi + x_hi.w_lo + x_lo.w_hi, accumulated in f32: about 16 mantissa
// bits.
//   * The weight is split once per parameter (ops/resblock.py
//     `split_conv_weight`, cached by the module like the bf16 packing): hi and
//     lo planes, each in the core-matrix layout above with 16-channel chunks.
//   * x rows reach shared memory as they are, f32, through the cp.async ring
//     (16-channel stages, three in the ring); the threads split each stage into
//     hi and lo planes in the bf16 kernel's x-tile layout (taps are row offsets
//     of one descriptor) while the tensor cores work on the stage before, and a
//     second barrier makes the planes visible to wgmma. 15 wgmmas a stage.
//   * Tiles of 64 rows x 64 channels up to T=256, two CTAs an SM, so that a
//     group of 128 channels is a cluster of up to 4 x 2 CTAs and the sampling
//     CLI's UNet-XL at B=4 gives 64 to 256 CTAs; 128 x 128 beyond (one CTA an
//     SM), up to 8 CTAs along T: T <= 1024 for any group, as in bfloat16.
//   * The pre-norm values never leave the accumulators. Where groups are
//     narrower than the tile (the gate UNet's 16 and 32 channels) one CTA
//     holds several whole groups, each with its own statistics: column sums
//     per warp, then per group, then over the cluster's ranks through
//     distributed shared memory, in a fixed order; the mean first, then the
//     centred sum of squares. Mish is the exact one.
//   * What bounds it (resblock_probe.py): the three products are three times
//     the bf16 kernel's, and each m64n32k16 reads 3 KB of operands from shared
//     memory for 32k MACs, about half the tensor cores' rate; the cp.async
//     stream of a stage (20 KB of weights, 4 KB of x) adds to that more than it
//     overlaps, and at T=224 the CTAs draw about 5.5 TB/s from L2 (every weight
//     byte read by each row tile of each batch item). Deeper rings, three
//     accumulator sets, 64 x 32 tiles, a split of Cin over a cluster and
//     128 x 64 tiles were each tried and were no faster (PERF.md section 6).
//
// The split route, for every half the clusters cannot hold: a group wider than
// 128 channels (the UNet at --latent_dim 1024 has groups of 256), or a (batch
// item, group) of more than 8 tiles (T > 1024, reached with --unet_pad_to).
// `make_plan` picks the route; ops/resblock.py `resblock_plan` mirrors it.
//   * The conv kernel of either type, instantiated with SPLIT, on the same
//     tiles and grid with no cluster. Its epilogue adds the bias, writes the
//     pre-norm tile in f32 to a scratch [B, T, Cout] that the wrapper
//     allocates, and each of its groups' moments over the tile (the count, the
//     tile's mean, the sum of squares about that mean, reduced in a fixed order
//     as the cluster route reduces them) to [B, groups, tiles, 3].
//   * `resblock_norm_kernel`, launched as its programmatic dependent, one CTA a
//     (row block, 256-channel chunk of a group, batch item): it merges the
//     group's tile moments with Chan's formula in a fixed order, then applies
//     GroupNorm's affine, AdaGN, Mish and the residual to the scratch and writes
//     the output once. Two launches on the same inputs give the same bits.
//   * Beyond the conv's own traffic it moves the scratch: one f32 write and one
//     read of the output's size (at the latent-1024 UNet's widest half, B=4,
//     T=224, 2,048 channels: 7.3 MB each way, ~4.4 us at 3.35 TB/s, beside a
//     conv of 37.6 GFLOP).
// Timings of both are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Probe builds only. resblock_probe.py compiles copies of this file with
// -DCONDMDI_PROBE_OFF=<mask of ProbeOff>, which switches parts of the float32
// kernel or of the split route off (the results are then wrong; the times tell
// what each part costs). The package's build does not define it, and every line that names it
// folds away.
#ifndef CONDMDI_PROBE_OFF
#define CONDMDI_PROBE_OFF 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;    // 8 warps: two warpgroups in the bf16 kernel
constexpr int kTaps = 5;         // conv width of every resblock half (SAME padding 2)
constexpr int kHalo = kTaps / 2;
constexpr int kMaxGroup = 128;   // widest group: one cluster holds one (batch item, group)
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr int kMaxSmem = 232448; // dynamic + static shared memory of one block on sm_90

enum ProbeOff {
  kOffMma = 1, kOffCopies = 2, kOffSplit = 4, kOffWeights = 8,
  kOffSmallTerms = 16,  // x_hi.w_hi alone: one product a tap instead of three
  kOffNorm = 32,        // the split route without its normalisation kernel
  kOffScratch = 64,     // the split route's conv kernel writes no pre-norm values
};
__host__ __device__ constexpr bool probe_off(int part) { return (CONDMDI_PROBE_OFF & part) != 0; }

__device__ __forceinline__ float mish(float h) {
  const float sp = fmaxf(h, 0.f) + log1pf(expf(-fabsf(h)));  // softplus, no overflow
  return h * tanhf(sp);
}

// The same function as tanh(softplus(h)) = t / (t + 2), t = e^h (e^h + 2), on the
// fast exponential and division: a few ulps of f32, far below a bf16 ulp. Past
// h = 20 the ratio is 1 in f32, and e^h underflows to the right limit 0.
__device__ __forceinline__ float mish_fast(float h) {
  const float n = __expf(fminf(h, 20.f));
  const float t = n * (n + 2.f);
  return h * __fdividef(t, t + 2.f);
}

// ------------------------------------------------------------------------- //
// bfloat16: packed weights, cp.async ring, wgmma from shared memory, cluster GroupNorm
// ------------------------------------------------------------------------- //

constexpr int kBK = 32;           // input channels per stage = the packed weight's chunk
constexpr int kWRowBytes = kBK * 2;  // one output channel of one tap of one chunk: 64 B

// BM x BN outputs per CTA, two warpgroups of 64 rows x kWGN columns each
template <int BM, int BN, int STAGES>
struct Cfg {
  static_assert(BM == 64 || BM == 128, "one or two 64-row warpgroup tiles");
  static constexpr int kWGM = BM / 64;          // warpgroups along rows
  static constexpr int kWGN = BN / (2 / kWGM);  // columns per warpgroup
  static constexpr int kXRows = BM + kTaps - 1;
  // The x tile holds, for each block of 8 input channels, all rows 16 B apart:
  // any 8 consecutive rows are one 128-byte core matrix, whatever row they
  // start at, which is what lets a tap read the same tile `tap` rows down.
  // The rows of one channel block are padded to 2 (mod 8) rows, so that the
  // four pieces of one row land in different banks.
  static constexpr int kXPlaneRows = (kXRows + 5) / 8 * 8 + 2;
  static constexpr int kXPlaneBytes = kXPlaneRows * 16;
  static constexpr int kXBytes = (kBK / 8) * kXPlaneBytes;
  static constexpr int kWTapBytes = BN * kWRowBytes;
  static constexpr int kStageBytes = kXBytes + kTaps * kWTapBytes;
  static constexpr int kSmem = STAGES * kStageBytes;
  static constexpr int kNT = kWGN / 8;          // n8 column tiles per thread
  static constexpr int kWPieces = BN * 4 / kThreads;  // 16-byte pieces per thread per tap
  static_assert((BN * 4) % kThreads == 0, "one tap's weight pieces divide evenly");
  static_assert(kXBytes % 16 == 0 && kStageBytes % 16 == 0, "tiles stay 16-byte aligned");
  static_assert(STAGES >= 3 && kSmem + 4096 <= kMaxSmem, "the ring and the static part fit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; all zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// writes made to shared memory by ordinary copies become visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major operand without swizzle: 8 x 8
// core matrices of 128 contiguous bytes (8 rows of 16 B); `lbo` bytes
// between the two core matrices of one k16 step, `sbo` bytes between
// core matrices of neighbouring 8-row blocks.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  // d[64 x 32] += a[64 x 16] . b[16 x 32], both operands in shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a_desc, uint64_t b_desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a_desc), "l"(b_desc), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  // d[64 x 128] += a[64 x 16] . b[16 x 128], both operands in shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a_desc, uint64_t b_desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a_desc), "l"(b_desc), "r"(1));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over every thread of every CTA of the cluster, the same value in
// every thread, summed in a fixed order (lanes, warps, then cluster ranks).
// `part` is this CTA's slot, read by the other CTAs through distributed
// shared memory; a later call must use another slot.
__device__ float cluster_sum(float v, float* warp_part, float* part, cg::cluster_group& cluster) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_part[i];
    *part = s;
  }
  cluster.sync();
  float total = 0.f;
  const unsigned n = cluster.num_blocks();
  for (unsigned r = 0; r < n; ++r) total += *cluster.map_shared_rank(part, r);
  return total;
}

// Sum of v over every thread of the CTA, the same value in every thread, summed
// in a fixed order (lanes, then warps). `warp_part` must not be read by a later
// call before a barrier: give each call its own.
__device__ __forceinline__ float block_sum(float v, float* warp_part) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_part[i];
  return total;
}

// The split route's partial moments of one (batch item, group, tile): the count,
// the mean and the centred sum of squares about that mean, at slot `i`.
__device__ __forceinline__ void store_moments(float* part, size_t i, float n, float mean,
                                              float m2) {
  part[3 * i] = n;
  part[3 * i + 1] = mean;
  part[3 * i + 2] = m2;
}

// Two neighbouring pre-norm values to the scratch: one 8-byte store where the
// pair is aligned, else one or two 4-byte ones.
__device__ __forceinline__ void store_pair(float* dst, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    dst[0] = a;
    if (second) dst[1] = b;
  }
}

template <int BM, int BN, int STAGES, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
resblock_bf16_kernel(const bf16* __restrict__ x,      // [B, T, x_pitch], x_pitch % 8 == 0
                     const bf16* __restrict__ wp,     // packed, see pack_conv_weight
                     const bf16* __restrict__ bias,   // [Cout]
                     const bf16* __restrict__ gamma,  // [Cout]
                     const bf16* __restrict__ beta,   // [Cout]
                     const bf16* __restrict__ scale,  // [B, Cout] rows ss_stride apart, or null
                     const bf16* __restrict__ shift,
                     long long ss_stride,
                     const bf16* __restrict__ res,    // [B, T, Cout] or null
                     bf16* __restrict__ out,          // [B, T, Cout]
                     float* __restrict__ pre,         // split route: [B, T, Cout] pre-norm
                     float* __restrict__ part,        // split route: [B, groups, tiles, 3]
                     int t_len, int x_pitch, int n_chunks, int cout, int group, int cn_tiles,
                     float eps) {
  using C = Cfg<BM, BN, STAGES>;
  constexpr int kNT = C::kNT, kSteps = 2 * kTaps;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_warp[kThreads / 32];
  __shared__ float s_part[2];
  __shared__ float s_par[5][BN];  // bias, gamma, beta, 1 + scale, shift of this CTA's channels

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans the grid's x dimension
  const int ct = rank / cn_tiles, cn = rank - ct * cn_tiles;
  const int m0 = ct * BM;                 // first output row of this CTA
  const int nc0 = cn * BN;                // first channel of this CTA within the group
  const int n_first = blockIdx.y * group + nc0;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;               // warpgroup
  const int wg_m = C::kWGM == 2 ? wg : 0, wg_n = C::kWGM == 2 ? 0 : wg;
  const int gq = lane >> 2, cq = lane & 3;  // accumulator fragment row / column pair
  const bf16* xb = x + (size_t)b * t_len * x_pitch;
  const int cout8 = (cout + 7) >> 3;      // 8-channel blocks of the packed weight
  const uint32_t smem_base = smem_u32(smem_raw);

  // This thread's 16-byte pieces of one tap's weight tile, the same in every
  // stage. Piece q of the tile lies at byte 16 q in shared memory and holds
  // channel (q/32)*8 + q%8, input channels 8*((q/8)%4) .. +7: core matrices of
  // 8 channels x 8 input channels, the layout of the packed weight itself.
  int w_src[C::kWPieces];
  bool w_ok[C::kWPieces];
#pragma unroll
  for (int i = 0; i < C::kWPieces; ++i) {
    const int q = tid + i * kThreads;
    const int n = n_first + (q >> 5) * 8 + (q & 7), kb = (q >> 3) & 3;
    w_ok[i] = n < cout8 * 8;
    w_src[i] = (((n >> 3) * 4 + kb) * 8 + (n & 7)) * 8;  // in elements
  }

  auto load_stage = [&](int stage, int chunk) {
    const uint32_t sx = smem_base + stage * C::kStageBytes;
    const uint32_t sw = sx + C::kXBytes;
    const int c0 = chunk * kBK;
    // x rows t = m0 - halo + r; rows outside [0, T) are the SAME padding
    for (int idx = tid; idx < C::kXRows * 4; idx += kThreads) {
      const int r = idx >> 2, p = idx & 3;
      const int t = m0 - kHalo + r, ch = c0 + p * 8;
      const bool ok = t >= 0 && t < t_len && ch < x_pitch;
      const bf16* src = ok ? xb + (size_t)t * x_pitch + ch : xb;
      cp_async16(sx + p * C::kXPlaneBytes + r * 16, src, ok);
    }
    // this chunk's weights, tap by tap; channels past Cout are zero
    const bf16* wc = wp + (size_t)chunk * kTaps * cout8 * (8 * kBK);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
      for (int i = 0; i < C::kWPieces; ++i)
        cp_async16(sw + tap * C::kWTapBytes + (tid + i * kThreads) * 16,
                   w_ok[i] ? wc + (size_t)tap * cout8 * (8 * kBK) + w_src[i] : wp, w_ok[i]);
  };

  // the per-channel vectors of the epilogue, fetched while the main loop runs
  // (its barriers make them visible); channels past the group read as zero
  for (int i = tid; i < 5 * BN; i += kThreads) {
    const int which = i / BN, col = i % BN;
    const bf16* src = which == 0 ? bias : which == 1 ? gamma : which == 2 ? beta
                      : which == 3 ? scale : shift;
    float v = 0.f;
    if (src != nullptr && nc0 + col < group)
      v = __bfloat162float(src[(which >= 3 ? b * ss_stride : 0) + blockIdx.y * group + nc0 + col]);
    s_par[which][col] = which == 3 ? 1.f + v : v;
  }

  float acc[kNT * 4];  // n8 tile j of this warp's 16 rows: acc[4j .. 4j+3]
#pragma unroll
  for (int i = 0; i < kNT * 4; ++i) acc[i] = 0.f;

  // Both operands are read from shared memory by descriptor. A: this
  // warpgroup's 64 rows of the x tile, `tap` rows down (output row r reads
  // x-tile row r + tap). B: this warpgroup's columns of the tap's weights.
  const uint32_t a_off = wg_m * 64 * 16;
  const uint32_t b_off = C::kXBytes + wg_n * (C::kWGN / 8) * 512;

  // One chunk: its 10 (tap, 16-channel half) steps as one group of wgmmas,
  // left in flight while the threads go on to the next chunk's copies.
  auto compute = [&](int c) {
    const uint32_t st = smem_base + (c % STAGES) * C::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      Wgmma<C::kWGN>::ss(
          acc,
          wgmma_desc(st + a_off + (s & 1) * 2 * C::kXPlaneBytes + (s >> 1) * 16,
                     C::kXPlaneBytes, 128),
          wgmma_desc(st + b_off + (s >> 1) * C::kWTapBytes + (s & 1) * 256, 128, 512));
    wgmma_commit();
  };
  // Ring protocol, per chunk c: this thread's wgmmas up to chunk c-2 are
  // done and its copies of chunk c have landed; after the barrier that holds
  // for every thread, so chunk c is readable and the buffer of chunk c-2 is
  // free for chunk c + STAGES - 2.
  auto advance = [&](int c) {
    wgmma_wait<1>();
    cp_async_wait<STAGES - 3>();
    fence_async_proxy();
    __syncthreads();
    if (c + STAGES - 2 < n_chunks) load_stage((c + STAGES - 2) % STAGES, c + STAGES - 2);
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < n_chunks) load_stage(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    advance(c);
    compute(c);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int row_base = m0 + wg_m * 64 + (warp & 3) * 16 + gq;
  const int lcol_base = wg_n * C::kWGN + 2 * cq;  // within this CTA's BN columns
  const int col_base = nc0 + lcol_base;           // within the group
  const int c_group0 = blockIdx.y * group;
  const bool pairs = ((cout | group) & 1) == 0;   // channel pairs are 4-byte aligned
  const bool row_ok[2] = {row_base < t_len, row_base + 8 < t_len};

  if constexpr (SPLIT) {
    // The split route's first kernel: this tile's moments and its pre-norm values;
    // `resblock_norm_kernel` (launched as this grid's dependent) does the rest.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    __shared__ float s_sum[2][kThreads / 32];
    float s = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[nt * 4 + i] += s_par[0][lcol_base + nt * 8 + (i & 1)];
        const bool ok = row_ok[i >> 1] && col_base + nt * 8 + (i & 1) < group;
        s += ok ? acc[nt * 4 + i] : 0.f;
      }
    const float n = (float)min(BM, t_len - m0) * (float)min(BN, group - nc0);
    const float mean = block_sum(s, s_sum[0]) / n;
    float q = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = row_ok[i >> 1] && col_base + nt * 8 + (i & 1) < group;
        const float d = acc[nt * 4 + i] - mean;
        q += ok ? d * d : 0.f;
      }
    q = block_sum(q, s_sum[1]);
    if (tid == 0)
      store_moments(part, ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + rank, n, mean, q);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = col_base + nt * 8;
        if (!row_ok[half] || col >= group) continue;
        const size_t o = ((size_t)b * t_len + row_base + half * 8) * cout + c_group0 + col;
        if (!probe_off(kOffScratch))
          store_pair(pre + o, acc[nt * 4 + 2 * half], acc[nt * 4 + 2 * half + 1],
                     pairs && col + 1 < group, col + 1 < group);
      }
    return;
  }

  // the residual, fetched before the statistics so that its latency hides behind them
  float rv[kNT * 4];
#pragma unroll
  for (int i = 0; i < kNT * 4; ++i) rv[i] = 0.f;
  if (res != nullptr) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = col_base + nt * 8;
        const size_t o = ((size_t)b * t_len + row_base + half * 8) * cout + c_group0 + col;
        if (row_ok[half] && pairs && col + 1 < group) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + o);
          rv[nt * 4 + 2 * half] = __low2float(r2);
          rv[nt * 4 + 2 * half + 1] = __high2float(r2);
        } else if (row_ok[half]) {
          if (col < group) rv[nt * 4 + 2 * half] = __bfloat162float(res[o]);
          if (col + 1 < group) rv[nt * 4 + 2 * half + 1] = __bfloat162float(res[o + 1]);
        }
      }
  }

  // + conv bias; this thread's part of the sum over valid (row < T, channel < group)
  float s = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nt * 4 + i] += s_par[0][lcol_base + nt * 8 + (i & 1)];
      const bool ok = row_ok[i >> 1] && col_base + nt * 8 + (i & 1) < group;
      s += ok ? acc[nt * 4 + i] : 0.f;
    }
  const float count = (float)t_len * (float)group;
  const float mean = cluster_sum(s, s_warp, &s_part[0], cluster) / count;
  float q = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = row_ok[i >> 1] && col_base + nt * 8 + (i & 1) < group;
      const float d = acc[nt * 4 + i] - mean;
      q += ok ? d * d : 0.f;
    }
  const float rstd = rsqrtf(cluster_sum(q, s_warp, &s_part[1], cluster) / count + eps);

  // epilogue: affine, AdaGN (1 + scale is 1 and shift 0 without it), Mish,
  // residual; each output written once
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int lcol = lcol_base + nt * 8, col = col_base + nt * 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!row_ok[half] || col >= group) continue;
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        h[e] = (acc[nt * 4 + 2 * half + e] - mean) * rstd * s_par[1][lcol + e] + s_par[2][lcol + e];
        h[e] = h[e] * s_par[3][lcol + e] + s_par[4][lcol + e];
        h[e] = mish_fast(h[e]) + rv[nt * 4 + 2 * half + e];
      }
      const size_t o = ((size_t)b * t_len + row_base + half * 8) * cout + c_group0 + col;
      if (pairs && col + 1 < group) {
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(h[0], h[1]);
      } else {
        out[o] = __float2bfloat16_rn(h[0]);
        if (col + 1 < group) out[o + 1] = __float2bfloat16_rn(h[1]);
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its partial sums
}

// The conv kernel's launch. The cluster route: one cluster a (batch item, group),
// the whole half in this one kernel. The split route (SPLIT): the same grid with
// no cluster, writing the pre-norm values and the moments to `pre` and `part`;
// scale, shift and res are then null (the normalisation kernel applies them).
template <int BM, int BN, int STAGES, bool SPLIT>
int launch_bf16(const void* x, const void* wp, const void* bias, const void* gamma,
                const void* beta, const void* scale, const void* shift, long long ss_stride,
                const void* res, void* out, float* pre, float* part, int batch, int t_len,
                int x_pitch, int cin_pad, int cout, int n_groups, float eps,
                cudaStream_t stream) {
  using C = Cfg<BM, BN, STAGES>;
  auto kernel = resblock_bf16_kernel<BM, BN, STAGES, SPLIT>;
  static cudaError_t attr_err =  // once per instantiation
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int group = cout / n_groups;
  const int ct_tiles = (t_len + BM - 1) / BM, cn_tiles = (group + BN - 1) / BN;
  const int tiles = ct_tiles * cn_tiles;
  if (!SPLIT && (tiles > kMaxCluster || group > kMaxGroup)) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, n_groups, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT ? 0 : 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), ss_stride, static_cast<const bf16*>(res),
      static_cast<bf16*>(out), pre, part, t_len, x_pitch, cin_pad / kBK, cout, group,
      cn_tiles, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------- //
// float32: hi+lo bf16 planes, the split weight, wgmma, cluster GroupNorm
// ------------------------------------------------------------------------- //

namespace f32 {

constexpr int kBK = 16;  // input channels per stage = the split weight's chunk

// BM x BN outputs per CTA, two warpgroups of 64 rows x kWGN columns each, as in
// the bf16 kernel. A stage holds the x rows as copied (f32), their hi and lo
// bf16 planes in the layout wgmma reads, and the hi and lo weights of 5 taps.
template <int BM, int BN, int STAGES>
struct Cfg {
  static_assert(BM == 64 || BM == 128, "one or two 64-row warpgroup tiles");
  static constexpr int kWGM = BM / 64;
  static constexpr int kWGN = BN / (2 / kWGM);
  static constexpr int kXRows = BM + kTaps - 1;
  static constexpr int kXPlaneRows = (kXRows + 5) / 8 * 8 + 2;  // as the bf16 kernel's
  static constexpr int kXPlaneBytes = kXPlaneRows * 16;
  static constexpr int kXBytes = (kBK / 8) * kXPlaneBytes;      // hi, or lo
  static constexpr int kRawBytes = kXRows * kBK * 4;            // the f32 rows, 64 B each
  static constexpr int kWTapBytes = BN * kBK * 2;               // one tap of hi, or of lo
  static constexpr int kWBytes = kTaps * kWTapBytes;
  static constexpr int kStageBytes = 2 * kXBytes + kRawBytes + 2 * kWBytes;
  static constexpr int kSmem = STAGES * kStageBytes;
  static constexpr int kNT = kWGN / 8;
  static constexpr int kWTapPieces = BN * kBK / 8;              // 16-byte pieces of one tap
  static constexpr int kWPieces = 2 * kTaps * kWTapPieces / kThreads;  // a thread's, a stage
  static constexpr int kRowWarps = BM / 16;                     // warps along the rows
  static_assert((2 * kTaps * kWTapPieces) % kThreads == 0, "the weight pieces divide evenly");
  static_assert((kWTapPieces & (kWTapPieces - 1)) == 0, "a power of two");
  static_assert(kStageBytes % 16 == 0 && kRawBytes % 16 == 0 && kXBytes % 16 == 0,
                "tiles stay 16-byte aligned");
  static_assert(STAGES >= 3 && kSmem + 12288 <= kMaxSmem, "the ring and the static part fit");
};

// eight floats as their bf16 hi and lo parts, 16 bytes each
__device__ __forceinline__ void split8(const float4 a, const float4 b, uint4& hi, uint4& lo) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    h[i] = *reinterpret_cast<const uint32_t*>(&p);
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(v[2 * i] - __low2float(p), v[2 * i + 1] - __high2float(p));
    l[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// One (batch item, channel tile, row tile). The channel tile is BN channels of
// one group (a cluster spans the group's tiles and T) or, where groups are
// narrower, `gpc` whole groups, each with its own statistics.
template <int BM, int BN, int STAGES, bool SPLIT>
__global__ void __launch_bounds__(kThreads, Cfg<BM, BN, STAGES>::kSmem <= 100000 ? 2 : 1)
resblock_f32_kernel(const float* __restrict__ x,      // [B, T, x_pitch], x_pitch % 4 == 0
                    const bf16* __restrict__ wp,      // [2][Cin_pad/16, 5, Cout_pad/8, 2, 8, 8]
                    const float* __restrict__ bias,   // [Cout]
                    const float* __restrict__ gamma,  // [Cout]
                    const float* __restrict__ beta,   // [Cout]
                    const float* __restrict__ scale,  // [B, Cout] rows ss_stride apart, or null
                    const float* __restrict__ shift,
                    long long ss_stride,
                    const float* __restrict__ res,    // [B, T, Cout] or null
                    float* __restrict__ out,          // [B, T, Cout]
                    float* __restrict__ pre,          // split route: [B, T, Cout] pre-norm
                    float* __restrict__ part,         // split route: [B, groups, tiles, 3]
                    int t_len, int x_pitch, int n_chunks, int cout, int n_groups, int group,
                    int gpc, int cn_tiles, float eps) {
  using C = Cfg<BM, BN, STAGES>;
  constexpr int kNT = C::kNT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_par[5][BN];  // bias, gamma, beta, 1 + scale, shift of this CTA's channels
  __shared__ int s_lg[BN];        // each column's group within the CTA, -1 past its channels
  __shared__ float s_col[C::kRowWarps][BN];  // column sums of each warp's 16 rows
  __shared__ float s_part[2][BN];  // this CTA's sum per local group: mean, then squares
  __shared__ float s_stat[2][BN];  // per local group: mean, 1/std

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans the grid's x dimension
  const int ct = rank / cn_tiles, cn = rank - ct * cn_tiles;
  const int m0 = ct * BM;
  const int g0 = blockIdx.y * gpc;                 // first group of this CTA
  const int n_first = g0 * group + cn * BN;        // first channel of this CTA
  const int local_groups = gpc < n_groups - g0 ? gpc : n_groups - g0;
  // channels of this CTA: part of one group, or `local_groups` whole ones
  const int span = cn_tiles > 1 ? min(BN, group - cn * BN) : local_groups * group;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int wg_m = C::kWGM == 2 ? wg : 0, wg_n = C::kWGM == 2 ? 0 : wg;
  const int gq = lane >> 2, cq = lane & 3;
  const float* xb = x + (size_t)b * t_len * x_pitch;
  const int cout8 = (cout + 7) >> 3;
  const int w_plane = n_chunks * kTaps * cout8 * 8 * kBK;  // elements of one plane (< 2^30)
  const uint32_t smem_base = smem_u32(smem_raw);

  // This thread's 16-byte pieces of a stage's weights: piece q of (plane, tap)
  // at byte 16 q of that tap's tile holds channel n_first + (q/16)*8 + q%8 and
  // input channels 8*((q/8)%2) .. +7, the core-matrix layout of the weight.
  uint32_t w_dst[C::kWPieces];
  int w_src[C::kWPieces];  // in elements from the chunk's start in the hi plane
  bool w_ok[C::kWPieces];
#pragma unroll
  for (int i = 0; i < C::kWPieces; ++i) {
    const int q = tid + i * kThreads;
    const int pt = q / C::kWTapPieces, r = q % C::kWTapPieces;  // (plane, tap), piece
    const int plane = pt / kTaps, tap = pt - plane * kTaps;
    const int n = n_first + (r >> 4) * 8 + (r & 7), kb = (r >> 3) & 1;
    w_ok[i] = n < cout8 * 8;
    w_src[i] = plane * w_plane + tap * cout8 * 8 * kBK + (((n >> 3) * 2 + kb) * 8 + (n & 7)) * 8;
    w_dst[i] = 2 * C::kXBytes + C::kRawBytes + plane * C::kWBytes + tap * C::kWTapBytes + r * 16;
  }

  auto load_stage = [&](int stage, int chunk) {
    const uint32_t st = smem_base + stage * C::kStageBytes;
    const int c0 = chunk * kBK;
    // x rows t = m0 - halo + r as they are (f32); rows outside [0, T) are the
    // SAME padding, channels past the row zero
    for (int idx = tid; idx < (probe_off(kOffCopies) ? 0 : C::kXRows * (kBK / 4));
         idx += kThreads) {
      const int r = idx / (kBK / 4), p = idx % (kBK / 4);
      const int t = m0 - kHalo + r, ch = c0 + p * 4;
      const bool ok = t >= 0 && t < t_len && ch < x_pitch;
      const float* src = ok ? xb + (size_t)t * x_pitch + ch : xb;
      cp_async16(st + 2 * C::kXBytes + r * (kBK * 4) + p * 16, src, ok);
    }
    const bf16* wc = wp + (size_t)chunk * kTaps * cout8 * 8 * kBK;
#pragma unroll
    for (int i = 0; i < C::kWPieces; ++i)
      if (!probe_off(kOffCopies | kOffWeights))
        cp_async16(st + w_dst[i], w_ok[i] ? wc + w_src[i] : wp, w_ok[i]);
  };
  // the f32 rows of a stage as hi and lo planes: per block of 8 input channels,
  // rows 16 B apart, as the bf16 kernel's x tile
  auto split_stage = [&](int stage) {
    unsigned char* st = smem_raw + stage * C::kStageBytes;
    for (int idx = tid; idx < (probe_off(kOffSplit) ? 0 : C::kXRows * (kBK / 8));
         idx += kThreads) {
      const int r = idx / (kBK / 8), p = idx % (kBK / 8);
      const float4* src = reinterpret_cast<const float4*>(st + 2 * C::kXBytes + r * (kBK * 4) + p * 32);
      uint4 hi, lo;
      split8(src[0], src[1], hi, lo);
      *reinterpret_cast<uint4*>(st + p * C::kXPlaneBytes + r * 16) = hi;
      *reinterpret_cast<uint4*>(st + C::kXBytes + p * C::kXPlaneBytes + r * 16) = lo;
    }
  };

  // the per-channel vectors of the epilogue and each column's local group,
  // fetched while the main loop runs (its barriers make them visible)
  for (int i = tid; i < 6 * BN; i += kThreads) {
    const int which = i / BN, col = i % BN;
    const bool ok = col < span;
    if (which == 5) {
      s_lg[col] = !ok ? -1 : cn_tiles > 1 ? 0 : col / group;
      continue;
    }
    const float* src = which == 0 ? bias : which == 1 ? gamma : which == 2 ? beta
                       : which == 3 ? scale : shift;
    float v = 0.f;
    if (src != nullptr && ok) v = src[(which >= 3 ? b * ss_stride : 0) + n_first + col];
    s_par[which][col] = which == 3 ? 1.f + v : v;
  }

  float acc[kNT * 4];
#pragma unroll
  for (int i = 0; i < kNT * 4; ++i) acc[i] = 0.f;

  const uint32_t a_off = wg_m * 64 * 16;
  const uint32_t b_off = 2 * C::kXBytes + C::kRawBytes + wg_n * (C::kWGN / 8) * 256;

  // One stage: per tap, x_hi.w_hi + x_hi.w_lo + x_lo.w_hi, as one group of 15
  // wgmmas left in flight while the threads go on to the next stage.
  auto compute = [&](int c) {
    const uint32_t st = smem_base + (c % STAGES) * C::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const uint64_t a_hi = wgmma_desc(st + a_off + tap * 16, C::kXPlaneBytes, 128);
      const uint64_t a_lo = wgmma_desc(st + C::kXBytes + a_off + tap * 16, C::kXPlaneBytes, 128);
      const uint64_t b_hi = wgmma_desc(st + b_off + tap * C::kWTapBytes, 128, 256);
      const uint64_t b_lo = wgmma_desc(st + b_off + C::kWBytes + tap * C::kWTapBytes, 128, 256);
      if (probe_off(kOffMma)) continue;
      Wgmma<C::kWGN>::ss(acc, a_hi, b_hi);
      if (probe_off(kOffSmallTerms)) continue;
      Wgmma<C::kWGN>::ss(acc, a_hi, b_lo);
      Wgmma<C::kWGN>::ss(acc, a_lo, b_hi);
    }
    wgmma_commit();
  };
  // Ring protocol, per stage c: this thread's wgmmas up to stage c-2 are done
  // and its copies of stage c have landed; after the barrier that holds for
  // every thread, so the buffer of stage c-2 takes stage c + STAGES - 2 and
  // stage c's rows are split into their planes; after a second barrier the
  // planes are readable.
  auto advance = [&](int c) {
    wgmma_wait<1>();
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (c + STAGES - 2 < n_chunks) load_stage((c + STAGES - 2) % STAGES, c + STAGES - 2);
    cp_async_commit();
    split_stage(c % STAGES);
    fence_async_proxy();
    __syncthreads();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < n_chunks) load_stage(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    advance(c);
    compute(c);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int row_warp = wg_m * 4 + (warp & 3);
  const int row_base = m0 + row_warp * 16 + gq;
  const int lcol_base = wg_n * C::kWGN + 2 * cq;  // within this CTA's BN columns
  const bool pairs = ((cout | (gpc * group)) & 1) == 0;  // channel pairs 8-byte aligned
  const bool row_ok[2] = {row_base < t_len, row_base + 8 < t_len};

  // the residual, fetched before the statistics so that its latency hides behind them
  float rv[kNT * 4];
#pragma unroll
  for (int i = 0; i < kNT * 4; ++i) rv[i] = 0.f;
  if (res != nullptr) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lcol = lcol_base + nt * 8;
        const size_t o = ((size_t)b * t_len + row_base + half * 8) * cout + n_first + lcol;
        if (!row_ok[half]) continue;
        if (pairs && lcol + 1 < span) {
          const float2 r2 = *reinterpret_cast<const float2*>(res + o);
          rv[nt * 4 + 2 * half] = r2.x;
          rv[nt * 4 + 2 * half + 1] = r2.y;
        } else {
          if (lcol < span) rv[nt * 4 + 2 * half] = res[o];
          if (lcol + 1 < span) rv[nt * 4 + 2 * half + 1] = res[o + 1];
        }
      }
  }

  // + conv bias; rows past T do not count
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt * 4 + i] += s_par[0][lcol_base + nt * 8 + (i & 1)];

  // Per local group, the sum over the cluster of f(v) over valid entries, in a
  // fixed order: rows of a warp (shuffles), warps along rows, the group's
  // columns (one warp a group), then cluster ranks. `slot` is 0 or 1.
  const int n_local = cn_tiles > 1 ? 1 : local_groups;
  const int width = cn_tiles > 1 ? span : group;  // this CTA's columns of one local group
  auto group_sums = [&](int slot, auto f) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lcol = lcol_base + nt * 8 + e;
        const int lg = s_lg[lcol];
        float v = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if (row_ok[half] && lg >= 0) v += f(acc[nt * 4 + 2 * half + e], lg);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) s_col[row_warp][lcol] = v;
      }
    __syncthreads();
    for (int g = warp; g < n_local; g += kThreads / 32) {
      float v = 0.f;
      for (int c = lane; c < width; c += 32)
#pragma unroll
        for (int r = 0; r < C::kRowWarps; ++r) v += s_col[r][g * width + c];
      v = warp_sum(v);
      if (lane == 0) s_part[slot][g] = v;
    }
    if constexpr (SPLIT) {  // this CTA's sums alone
      __syncthreads();
      for (int g = tid; g < n_local; g += kThreads) s_stat[slot][g] = s_part[slot][g];
    } else {
      cluster.sync();
      const unsigned n = cluster.num_blocks();
      for (int g = tid; g < n_local; g += kThreads) {
        float total = 0.f;
        for (unsigned r = 0; r < n; ++r)
          total += cluster.map_shared_rank(&s_part[slot][0], r)[g];
        s_stat[slot][g] = total;
      }
    }
    __syncthreads();
  };
  if constexpr (SPLIT) {
    // The split route's first kernel: each local group's moments over this tile and
    // the pre-norm values; `resblock_norm_kernel` (this grid's dependent) does the rest.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const float n = (float)min(BM, t_len - m0) * (float)width;
    group_sums(0, [](float v, int) { return v; });
    for (int g = tid; g < n_local; g += kThreads) s_stat[0][g] /= n;
    __syncthreads();
    group_sums(1, [&](float v, int lg) {
      const float d = v - s_stat[0][lg];
      return d * d;
    });
    for (int g = tid; g < n_local; g += kThreads)
      store_moments(part, ((size_t)b * n_groups + g0 + g) * gridDim.x + rank, n, s_stat[0][g],
                    s_stat[1][g]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lcol = lcol_base + nt * 8;
        if (!row_ok[half] || lcol >= span) continue;
        const size_t o = ((size_t)b * t_len + row_base + half * 8) * cout + n_first + lcol;
        if (!probe_off(kOffScratch))
          store_pair(pre + o, acc[nt * 4 + 2 * half], acc[nt * 4 + 2 * half + 1],
                     pairs && lcol + 1 < span, lcol + 1 < span);
      }
    return;
  }
  const float count = (float)t_len * (float)group;
  group_sums(0, [](float v, int) { return v; });
  for (int g = tid; g < n_local; g += kThreads) s_stat[0][g] /= count;
  __syncthreads();
  group_sums(1, [&](float v, int lg) {
    const float d = v - s_stat[0][lg];
    return d * d;
  });
  for (int g = tid; g < n_local; g += kThreads) s_stat[1][g] = rsqrtf(s_stat[1][g] / count + eps);
  __syncthreads();

  // epilogue: affine, AdaGN (1 + scale is 1 and shift 0 without it), Mish,
  // residual; each output written once
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int lcol = lcol_base + nt * 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!row_ok[half] || lcol >= span) continue;
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lg = s_lg[lcol + e] < 0 ? 0 : s_lg[lcol + e];
        h[e] = (acc[nt * 4 + 2 * half + e] - s_stat[0][lg]) * s_stat[1][lg] * s_par[1][lcol + e] +
               s_par[2][lcol + e];
        h[e] = h[e] * s_par[3][lcol + e] + s_par[4][lcol + e];
        h[e] = mish(h[e]) + rv[nt * 4 + 2 * half + e];
      }
      const size_t o = ((size_t)b * t_len + row_base + half * 8) * cout + n_first + lcol;
      if (pairs && lcol + 1 < span) {
        *reinterpret_cast<float2*>(out + o) = make_float2(h[0], h[1]);
      } else {
        out[o] = h[0];
        if (lcol + 1 < span) out[o + 1] = h[1];
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its partial sums
}

// (rows, channels) of one CTA at length T: 64 x 64 up to T=256, where a
// cluster of up to 4 x 2 CTAs holds a group of 128 (two CTAs an SM); 128 x 128
// beyond, up to 8 CTAs along T (T <= 1024). Mirrored by ops/resblock.py
// `f32_tiles`.
__host__ __device__ constexpr int tile_rows(int t_len) { return t_len <= 256 ? 64 : 128; }

template <int BM, int BN, int STAGES, bool SPLIT>
int launch(const void* x, const void* wp, const void* bias, const void* gamma, const void* beta,
           const void* scale, const void* shift, long long ss_stride, const void* res, void* out,
           float* pre, float* part, int batch, int t_len, int x_pitch, int cin_pad, int cout,
           int n_groups, float eps, cudaStream_t stream) {
  using C = Cfg<BM, BN, STAGES>;
  auto kernel = resblock_f32_kernel<BM, BN, STAGES, SPLIT>;
  static cudaError_t attr_err =  // once per instantiation
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int group = cout / n_groups;
  const int gpc = group >= BN ? 1 : BN / group;
  const int cn_tiles = group > BN ? (group + BN - 1) / BN : 1;
  const int ct_tiles = (t_len + BM - 1) / BM;
  const int tiles = ct_tiles * cn_tiles;
  if (!SPLIT && (tiles > kMaxCluster || group > kMaxGroup)) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, (n_groups + gpc - 1) / gpc, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT ? 0 : 1;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, f(x), static_cast<const bf16*>(wp), f(bias), f(gamma), f(beta), f(scale),
      f(shift), ss_stride, f(res), static_cast<float*>(out), pre, part, t_len, x_pitch,
      cin_pad / kBK, cout, n_groups, group, gpc, cn_tiles, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------------------------- //
// The split route: the conv kernels above without a cluster, then one pass that
// merges each group's moments and normalises
// ------------------------------------------------------------------------- //

constexpr int kNormCols = 256;    // channels of one group per CTA of the normalisation
constexpr int kNormElems = 4096;  // values per CTA of the normalisation, about

// (count, mean, centred sum of squares) of some of a group's values
struct Moments {
  float n, mean, m2;
};

// Chan's pairwise merge: the mean first, then the sum of squares. An empty side
// gives the other back as it is.
__device__ __forceinline__ Moments merge(const Moments a, const Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// One (row block, channel chunk of one group, batch item): the group's tile
// moments merged in a fixed order (lane l takes tiles l, l + 32, ... in turn,
// then the lanes pairwise down to lane 0), then GroupNorm's affine, AdaGN, Mish
// (the exact one in float32, the fast one in bfloat16, as the cluster routes)
// and the residual on the pre-norm values; each output written once, in x's type.
// Launched as the conv kernel's programmatic dependent: everything before
// griddepcontrol.wait overlaps the conv kernel's tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock_norm_kernel(const float* __restrict__ pre,   // [B, T, Cout]
                     const float* __restrict__ part,  // [B, groups, tiles, 3]
                     const T* __restrict__ gamma, const T* __restrict__ beta,
                     const T* __restrict__ scale, const T* __restrict__ shift,
                     long long ss_stride, const T* __restrict__ res, T* __restrict__ out,
                     int t_len, int cout, int n_groups, int group, int tiles, int norm_rows,
                     float eps) {
  __shared__ float s_par[4][kNormCols];  // gamma, beta, 1 + scale, shift of the chunk
  __shared__ float s_stat[2];            // mean, 1/std
  const int chunks = (group + kNormCols - 1) / kNormCols;
  const int g = blockIdx.y / chunks, chunk = blockIdx.y - g * chunks;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int c0 = g * group + chunk * kNormCols;  // the chunk's first channel
  const int ncols = min(kNormCols, group - chunk * kNormCols);
  const int r0 = blockIdx.x * norm_rows, nrows = min(norm_rows, t_len - r0);

  for (int c = tid; c < ncols; c += kThreads) {  // inputs the conv kernel does not write
    s_par[0][c] = to_float(gamma[c0 + c]);
    s_par[1][c] = to_float(beta[c0 + c]);
    s_par[2][c] = 1.f + (scale != nullptr ? to_float(scale[b * ss_stride + c0 + c]) : 0.f);
    s_par[3][c] = shift != nullptr ? to_float(shift[b * ss_stride + c0 + c]) : 0.f;
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the conv kernel's writes are visible
  if (tid < 32) {
    const float* p = part + ((size_t)b * n_groups + g) * tiles * 3;
    Moments m = {0.f, 0.f, 0.f};
    for (int i = tid; i < tiles; i += 32) m = merge(m, {p[3 * i], p[3 * i + 1], p[3 * i + 2]});
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Moments other = {__shfl_down_sync(0xffffffffu, m.n, o),
                             __shfl_down_sync(0xffffffffu, m.mean, o),
                             __shfl_down_sync(0xffffffffu, m.m2, o)};
      m = merge(m, other);
    }
    if (tid == 0) {
      s_stat[0] = m.mean;
      s_stat[1] = rsqrtf(m.m2 / m.n + eps);
    }
  }
  __syncthreads();
  const float mean = s_stat[0], rstd = s_stat[1];
  for (int i = tid; i < nrows * ncols; i += kThreads) {
    const int r = i / ncols, c = i - r * ncols;
    const size_t o = ((size_t)b * t_len + r0 + r) * cout + c0 + c;
    float h = (pre[o] - mean) * rstd * s_par[0][c] + s_par[1][c];
    h = h * s_par[2][c] + s_par[3][c];
    if constexpr (sizeof(T) == 4) {
      h = mish(h);
    } else {
      h = mish_fast(h);
    }
    store(out + o, h + (res != nullptr ? to_float(res[o]) : 0.f));
  }
}

// How one half is computed: the route, the conv kernel's tiles and grid, and the
// split route's normalisation grid and scratch. Mirrored by ops/resblock.py
// `resblock_plan`.
struct Plan {
  int split;               // 0: the cluster route, 1: the split route
  int bm, bn, stages;      // the conv kernel's tile and ring
  int tiles, grid_y, gpc;  // its grid (tiles, grid_y, B); groups a CTA holds
  int cluster;             // CTAs of one cluster: `tiles`, or 1 on the split route
  int norm_rows, norm_x, norm_y;  // the normalisation's rows a CTA and grid (x, y, B)
  long long scratch;       // floats of scratch: the pre-norm values, then the moments
};

Plan make_plan(int batch, int t_len, int cout, int n_groups, int dtype) {
  Plan p = {};
  const int group = cout / n_groups;
  if (dtype == 0) {
    p.bm = p.bn = f32::tile_rows(t_len);
    p.stages = 3;
    p.gpc = group >= p.bn ? 1 : p.bn / group;
  } else {
    p.bm = p.bn = t_len <= 64 ? 64 : 128;
    p.stages = t_len <= 64 ? 6 : 4;
    p.gpc = 1;
  }
  const int cn_tiles = dtype == 0 && group <= p.bn ? 1 : (group + p.bn - 1) / p.bn;
  p.tiles = (t_len + p.bm - 1) / p.bm * cn_tiles;
  p.grid_y = (n_groups + p.gpc - 1) / p.gpc;
  p.split = group > kMaxGroup || p.tiles > kMaxCluster;
  p.cluster = p.split ? 1 : p.tiles;
  if (p.split) {
    p.norm_rows = kNormElems / (group < kNormCols ? group : kNormCols);
    p.norm_x = (t_len + p.norm_rows - 1) / p.norm_rows;
    p.norm_y = n_groups * ((group + kNormCols - 1) / kNormCols);
    p.scratch = (long long)batch * t_len * cout + 3LL * batch * n_groups * p.tiles;
  }
  return p;
}

template <typename T>
int launch_norm(const Plan& p, const float* pre, const float* part, const void* gamma,
                const void* beta, const void* scale, const void* shift, long long ss_stride,
                const void* res, void* out, int batch, int t_len, int cout, int n_groups,
                float eps, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.norm_x, p.norm_y, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, resblock_norm_kernel<T>, pre, part, c(gamma), c(beta), c(scale), c(shift), ss_stride,
      c(res), static_cast<T*>(out), t_len, cout, n_groups, cout / n_groups, p.tiles, p.norm_rows,
      eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of one half (see `Plan`) as 12 numbers: split, bm, bn, stages, tiles,
// grid_y, gpc, cluster, norm_rows, norm_x, norm_y, scratch floats. Returns 0, or
// cudaErrorInvalidValue for a shape no route takes.
extern "C" int condmdi_resblock_plan(int batch, int t_len, int cout, int n_groups, int dtype,
                                     long long* out) {
  if (batch <= 0 || t_len <= 0 || n_groups <= 0 || cout % n_groups != 0 || cout <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(batch, t_len, cout, n_groups, dtype);
  const long long v[12] = {p.split, p.bm, p.bn, p.stages, p.tiles, p.grid_y, p.gpc, p.cluster,
                           p.norm_rows, p.norm_x, p.norm_y, p.scratch};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// x: [B, T, x_pitch] contiguous, channels [cin, x_pitch) ignored. dtype 0 =
// float32: w is the split weight of ops/resblock.py `split_conv_weight`, its hi
// and lo bf16 planes each packed as `pack_conv_weight` packs with chunks of 16
// ([2][cin/16, 5, Cout/8, 2, 8, 8]; cin the padded width, a multiple of 16),
// and x_pitch % 4 == 0. dtype 1 = bfloat16: w is the packed
// [cin/32, 5, Cout/8, 4, 8, 8] of `pack_conv_weight` (chunk of 32 input
// channels, tap, block of 8 output channels, block of 8 input channels, output
// channel, input channel; cin the padded width, a multiple of 32) and
// x_pitch % 8 == 0. `scratch` holds the plan's `scratch` floats where the plan is
// the split route (and may be null on the cluster route). Returns the launch's
// error code, 0 on success.
extern "C" int condmdi_resblock_forward(const void* x, const void* w, const void* bias,
                                        const void* gamma, const void* beta, const void* scale,
                                        const void* shift, long long ss_stride, const void* res,
                                        void* out, int batch, int t_len, int x_pitch, int cin,
                                        int cout, int k, int n_groups, float eps, int dtype,
                                        void* stream, void* scratch) {
  if (batch <= 0 || batch > 65535 || t_len <= 0 || cin <= 0 || x_pitch <= 0 || n_groups <= 0 ||
      n_groups > 65535 || cout % n_groups != 0 || k != kTaps ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(batch, t_len, cout, n_groups, dtype);
  if (p.split && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* pre = p.split ? static_cast<float*>(scratch) : nullptr;
  float* part = p.split ? pre + (size_t)batch * t_len * cout : nullptr;
  if (dtype == 0) {
    if (cin % f32::kBK != 0 || x_pitch % 4 != 0 || x_pitch > cin ||
        (long long)cin * kTaps * ((cout + 7) / 8 * 8) >= (1LL << 30))
      return (int)cudaErrorInvalidValue;
    if (p.split) {
#define CONDMDI_F32(BM, BN, STAGES)                                                            \
  f32::launch<BM, BN, STAGES, true>(x, w, bias, gamma, beta, nullptr, nullptr, 0, nullptr,     \
                                    nullptr, pre, part, batch, t_len, x_pitch, cin, cout,      \
                                    n_groups, eps, s)
      const int err = p.bm == 64 ? CONDMDI_F32(64, 64, 3) : CONDMDI_F32(128, 128, 3);
#undef CONDMDI_F32
      if (err != 0 || probe_off(kOffNorm)) return err;
      return launch_norm<float>(p, pre, part, gamma, beta, scale, shift, ss_stride, res, out,
                                batch, t_len, cout, n_groups, eps, s);
    }
#define CONDMDI_F32(BM, BN, STAGES)                                                            \
  f32::launch<BM, BN, STAGES, false>(x, w, bias, gamma, beta, scale, shift, ss_stride, res,    \
                                     out, nullptr, nullptr, batch, t_len, x_pitch, cin, cout,  \
                                     n_groups, eps, s)
    if (p.bm == 64) return CONDMDI_F32(64, 64, 3);
    return CONDMDI_F32(128, 128, 3);
#undef CONDMDI_F32
  }
  if (dtype != 1 || cin % kBK != 0 || x_pitch % 8 != 0 || x_pitch > cin)
    return (int)cudaErrorInvalidValue;
  if (p.split) {
#define CONDMDI_BF16(BM, BN, STAGES)                                                          \
  launch_bf16<BM, BN, STAGES, true>(x, w, bias, gamma, beta, nullptr, nullptr, 0, nullptr,    \
                                    nullptr, pre, part, batch, t_len, x_pitch, cin, cout,     \
                                    n_groups, eps, s)
    const int err = p.bm == 64 ? CONDMDI_BF16(64, 64, 6) : CONDMDI_BF16(128, 128, 4);
#undef CONDMDI_BF16
    if (err != 0 || probe_off(kOffNorm)) return err;
    return launch_norm<bf16>(p, pre, part, gamma, beta, scale, shift, ss_stride, res, out, batch,
                             t_len, cout, n_groups, eps, s);
  }
#define CONDMDI_BF16(BM, BN, STAGES)                                                          \
  launch_bf16<BM, BN, STAGES, false>(x, w, bias, gamma, beta, scale, shift, ss_stride, res,   \
                                     out, nullptr, nullptr, batch, t_len, x_pitch, cin, cout, \
                                     n_groups, eps, s)
  if (p.bm == 64) return CONDMDI_BF16(64, 64, 6);
  return CONDMDI_BF16(128, 128, 4);
#undef CONDMDI_BF16
}

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
