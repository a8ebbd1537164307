// Int8 conv1d / matmul for Hopper (sm_90a), activations quantized on the way in:
//   out[b, t, n] = float(sum_{j, c} q(x[b, t*stride - pad + j, c]) * wq[n, c, j])
//                  * (a_scale * w_scale[n]) + bias[n]            (per-tensor a_scale)
//                  * w_scale[n] + bias[n]                        (per-channel a_scale,
//                                                                 folded into wq)
//   q(v) = clamp(rint(v / a_scale), -127, 127), zero outside [0, T)
//
// Replaces condmdi_tpu/ops/quant.py `int8_conv1d` (and `quant_conv1d_from_f32`,
// `int8_matmul`), which the JAX package left to XLA: an activation quantize
// pass, `lax.conv_general_dilated` / `dot_general` with int32 accumulation,
// and a dequant epilogue. PyTorch has no CUDA int8 conv1d, so this file does
// all of it; the matmul is its k=1, stride-1 case over the rows of x. One C
// call launches two kernels on the caller's stream.
//
// What bounds it on an H100: 2*B*T'*Cin*Cout*k operations against
// B*T*Cin*(2 or 4) + Cout*Cin*k + B*T'*Cout*(2 or 4) bytes. At the UNet-XL
// shapes at B=8 (T' = 200..25, Cin 526..2048, Cout 1024, k 5) that is
// 2-17 G int8 operations for 6-20 MB: 1-9 us of tensor-core time at
// 1,979 TOP/s, and at T' = 25 the weights' 5-10 MB set the bound (2-3 us at
// 3.35 TB/s). What stands between a launch and that bound is how often the
// weights cross from L2 to the SMs, how many SMs have work, and whether the
// tensor cores are fed: the design below is about those three.
//
//   1. `quantize_kernel`: x (bfloat16 or float32, any row pitch) to int8 codes
//      in a scratch buffer the caller allocates, [B, Tp, Cin_pad]: each item
//      gets `pad` zero rows before and after its T rows (Tp = T + 2*pad, made
//      even for stride 2), and channels Cin..Cin_pad (a multiple of 128) are
//      zero. Each value is converted to float, divided by the activation
//      scale (__fdiv_rn: a true division, as XLA's), rounded half to even
//      (__float2int_rn, as jnp.round) and clamped to +-127, once. (Quantizing
//      inside the conv, once per output-channel tile, was bound by those
//      divisions: 4.9 ms for the 41 convs of a UNet-XL forward at B=8 on an
//      NVIDIA H100 80GB HBM3 at 700 W.)
//   2. `conv_kernel`: the conv as one GEMM over the batch. With the halo in
//      the codes, output row t of item b reads code rows t + j for tap j
//      (stride 1), or, with the codes viewed as row pairs [B*Tp/2, 2*Cin_pad],
//      pair t + j/2 at column half j%2 (stride 2). So output rows of all batch
//      items are one M dimension, R = b*Tp/stride + t, and tap j of a 128-row
//      M tile is a plain 2-D box of the codes, j/stride rows further down and
//      (j%stride)*Cin_pad columns further right. A tile may span batch items;
//      the few rows that land on halo rows are computed and not stored. So a
//      CTA reads its weights once per 128 rows of the whole batch, where a
//      CTA per batch item and 64 rows read them 2-4 times as often.
//      A CTA is 3 warpgroups: one thread of the first keeps TMA loads in
//      flight into a ring of 6 stages (mbarriers: full on the copies' bytes,
//      empty on the 8 consuming warps); each stage is one (tap, 128-channel
//      chunk) of the K dimension: the 128 x 128-byte code box and the 128
//      output channels x 128 bytes of the packed weight
//      (ops/quant.py `pack_int8_weight`: [Cout, k*Cin_pad], K index
//      j*Cin_pad + c), both under the 128-byte swizzle. The other two
//      warpgroups own 64 rows each and run wgmma.mma_async m64n128k32 s8.s8 ->
//      s32 on them, both operands K-major from shared memory (8-bit wgmma takes
//      no transposed operand), one step's product in flight while the next
//      one's data is awaited.
//      Where the tiles are fewer than half the SMs (T' <= 100 and the 1x1
//      convs at B=8), the K steps of a tile are split over the CTAs of one
//      cluster, up to sm_count/tiles and at most 8 of them: about one wave
//      (half a wave for clusters of 4 or more, which a card's unevenly sized
//      groups of SMs cannot always place at once: 128 CTAs in clusters of 4
//      or 8 took up to twice as long as 96 in clusters of 3).
//      Int32 partial sums are exact, so any split and any order of reduction
//      give the same sums: each part leaves its sums in its own shared memory,
//      and after a cluster barrier part r adds up its share of the tile's rows
//      from all parts through distributed shared memory and stores them. No
//      global workspace, no atomics, no memset, no host sync, no allocation:
//      the launch can be captured in a CUDA graph.
//      The conv is launched as a programmatic dependent of the quantize pass:
//      its CTAs start, set up their barriers and load the first stages'
//      weights while the pass runs, and wait for it (griddepcontrol.wait)
//      only before they copy codes.
//      The sums are exact in int32 (|sum| <= 127^2*k*Cin < 2^31), so the
//      accumulators equal the plain version's. Epilogue: acc * (a_scale *
//      w_scale[n]) + bias[n] in float32 with __fmul_rn / __fadd_rn (no FMA
//      contraction, the scale product first, as XLA computes it), the cast to
//      x's dtype, stores masked on T' and Cout (263 at the final conv). Where
//      Cout rows are whole 16-byte pieces the tile is staged in shared memory
//      and stored 16 bytes a thread: scattered 4-byte stores cost MDM's
//      evaluation-batch QDense 62 of its 145 us on the same card
//      (int8_probe.py).
// The dynamic per-tensor amax is taken by the caller (one torch.amax over the
// whole tensor, as XLA did) and arrives, like a static scale, as a pointer to a
// float on the device. The tensor maps depend on the tensors' addresses and
// are encoded in the C entry on every call. Timings in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is taken at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Probe builds only. int8_probe.py compiles copies of this file with
// -DCONDMDI_PROBE_OFF=<mask of ProbeOff>, which switches parts of the conv off
// (the results are then wrong; the times tell what each part costs). The
// package's build does not define it, and every line that names it folds away.
#ifndef CONDMDI_PROBE_OFF
#define CONDMDI_PROBE_OFF 0
#endif

namespace {

enum ProbeOff {
  kOffMma = 1,       // no wgmma
  kOffStores = 2,    // no output stores
  kOffSplit = 4,     // split parts store their partial sums as if they were whole
  kOffCopies = 8,    // no TMA copies: the barriers complete on arrivals alone
  kOffQuantize = 16  // no quantize pass
};
__host__ __device__ constexpr bool probe_off(int part) { return (CONDMDI_PROBE_OFF & part) != 0; }

constexpr int kBM = 128;             // output rows per CTA (two warpgroups of 64)
constexpr int kBN = 128;             // output channels per CTA
constexpr int kBK = 128;             // input channels per K step: one 128-byte swizzled row
constexpr int kStages = 6;           // ring depth
constexpr int kConsumers = 2;        // warpgroups that run wgmma
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileBytes = kBM * kBK;        // one operand's box, 16 KB (kBN == kBM)
constexpr int kStageBytes = 2 * kTileBytes;  // codes and weights
// after the ring: the full and empty barriers, and the tile's 128 output
// channels' dequant scales and biases
constexpr int kBarrierBytes = 2 * kStages * 8;
constexpr int kEpilogueBytes = 2 * kBN * 4;
constexpr int kSmemBytes = kStages * kStageBytes + kBarrierBytes + kEpilogueBytes + 1024;  // + alignment slack
constexpr int kAcc = kBN / 2;        // int32 accumulators a consumer thread holds
constexpr int kQThreads = 256;       // quantize kernel: 8 channels a thread
constexpr int kMaxSplit = 8;         // parts of a split tile: the CTAs of one (portable) cluster
constexpr int kPartPitch = kBN + 4;  // int32 a row of a part's sums in shared memory

static_assert(kBM == kBN, "the code box and the weight box share a size");
static_assert(kBM * kPartPitch * 4 <= kStages * kStageBytes, "a part's sums fit the ring");
static_assert(kSmemBytes <= 232448, "a block's shared memory on sm_90");

// ------------------------------------------------------------------------- //
// the plan of a launch: tiles and the split of the K steps
// ------------------------------------------------------------------------- //
struct Plan {
  int t_pad;          // code rows per batch item, halo included
  int rows_per_item;  // output rows per batch item in M: t_pad / stride
  long long m_total;  // batch * rows_per_item
  int m_tiles, n_tiles, chunks, steps, split;
};

// The same function as ops/quant.py `int8_plan` (a card test holds them together).
Plan make_plan(int batch, int t_len, int cin_pad, int cout, int k, int stride, int pad,
               int sm_count) {
  Plan p;
  p.t_pad = (t_len + 2 * pad + stride - 1) / stride * stride;
  p.rows_per_item = p.t_pad / stride;
  p.m_total = (long long)batch * p.rows_per_item;
  p.m_tiles = (int)((p.m_total + kBM - 1) / kBM);
  p.n_tiles = (cout + kBN - 1) / kBN;
  p.chunks = cin_pad / kBK;
  p.steps = k * p.chunks;
  const long long tiles = (long long)p.m_tiles * p.n_tiles;
  p.split = 1;
  if (2 * tiles <= sm_count) {
    const int fill = (int)(sm_count / tiles);
    p.split = fill < p.steps ? fill : p.steps;
    p.split = p.split < kMaxSplit ? p.split : kMaxSplit;
    // clusters of 4 or more cannot always fill the card in one wave (its SMs come
    // in groups of uneven size, and a cluster lives in one): at most half of it
    while (p.split >= 4 && 2 * p.split * tiles > sm_count) --p.split;
  }
  return p;
}

struct Params {
  const float* a_scale;  // [1] or [Cin]
  int a_per_channel;
  const float* w_scale;  // [Cout]
  const float* bias;     // [Cout] or null
  void* out;             // [B, T_out, Cout]
  int cin_pad, cout, stride, t_out, rows_per_item, chunks, steps, split, n_tiles, m_total;
  int vector_stores;     // Cout * sizeof(T) is a multiple of 16: rows stored in 16-byte pieces
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t quantize(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  q = max(-127, min(127, q));
  return static_cast<uint32_t>(q) & 0xffu;
}

// 8 values of x (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// x [B, T, cin] at row pitch `row_stride` -> codes [B, t_pad, cin_pad]: `pad` zero
// rows before each item's T rows and the rest of t_pad after; 8 channels a
// thread, read 16 or 32 bytes at a time where x's rows are 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* x, long long batch_stride, long long row_stride, int t_len, int pad,
                int t_pad, int cin, int cin_pad, const float* a_scale, int per_channel,
                int aligned, int8_t* codes, int n8) {
  // the conv, launched behind this pass as its programmatic dependent, may start
  // its prologue and its weight copies now; it waits for the codes themselves
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int item = blockIdx.x * kQThreads + threadIdx.x;  // the C entry keeps n8 < 2^31
  if (item >= n8) return;
  const int groups = cin_pad / 8;
  const int row = item / groups;
  const int c = (item - row * groups) * 8;
  const int b = row / t_pad;
  const int t = row - b * t_pad - pad;
  uint32_t word[2] = {0, 0};
  if (t >= 0 && t < t_len && c < cin) {
    const T* src = x + (long long)b * batch_stride + (long long)t * row_stride + c;
    float v[8];
    if (aligned && c + 8 <= cin) {
      load8(src, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c + e < cin ? to_f32(src[e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (c + e < cin) {
        const float s = per_channel ? a_scale[c + e] : a_scale[0];
        word[e / 4] |= quantize(v[e], s) << (8 * (e % 4));
      }
    }
  }
  *reinterpret_cast<uint2*>(codes + (long long)row * cin_pad + c) = make_uint2(word[0], word[1]);
}

// ------------------------------------------------------------------------- //
// barriers, TMA and wgmma
// ------------------------------------------------------------------------- //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` of copies which will complete on the barrier
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase with this parity is complete. A wait that
// never ends is a fault of the protocol: trap, so that the launch fails
// instead of hanging the card.
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
// one TMA copy of a box of a 2-D int8 view (columns; rows) into shared memory,
// completing on the barrier; rows and columns past the view arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
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

// Shared-memory descriptor of a K-major operand stored as rows of 128 bytes
// under the 128-byte swizzle, the layout a TMA box with that swizzle lands in:
// 8-row groups 1,024 bytes apart; a step of 32 bytes along K moves the start
// address inside the row.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define CONDMDI_R8(d, o)                                                                     \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]), "+r"(d[o + 5]), \
      "+r"(d[o + 6]), "+r"(d[o + 7])

// d[64 x 128] += a[64 x 32] . b[32 x 128]^T, s8 x s8 -> s32, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc], uint64_t a_desc, uint64_t b_desc) {
  constexpr int kAccumulate = 1;  // scale-d: add to d
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : CONDMDI_R8(d, 0), CONDMDI_R8(d, 8), CONDMDI_R8(d, 16), CONDMDI_R8(d, 24),
        CONDMDI_R8(d, 32), CONDMDI_R8(d, 40), CONDMDI_R8(d, 48), CONDMDI_R8(d, 56)
      : "l"(a_desc), "l"(b_desc), "r"(kAccumulate));
}
#undef CONDMDI_R8

__device__ __forceinline__ void consumer_barrier() {  // the two consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool both, bool paired) {
  if (both && paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool both, bool paired) {
  if (both && paired) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (both) p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void cluster_sync() {  // every thread of every CTA of the cluster
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory location in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ int4 ld_cluster_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Output row r of the batch-folded M: where it lies in out, or null for a row
// past the batch or on the halo (computed, not stored).
template <typename T>
__device__ __forceinline__ T* out_row(const Params& p, int r) {
  const int b = r / p.rows_per_item, t = r - b * p.rows_per_item;
  if (r >= p.m_total || t >= p.t_out) return nullptr;
  return static_cast<T*>(p.out) + ((long long)b * p.t_out + t) * p.cout;
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias, bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

// The epilogue of a whole tile, by the consumer warpgroups: thread (warp, lane)
// of warpgroup cw holds rows 64 cw + 16 warp + lane/4 (+8) and columns
// 8 j + 2 (lane % 4) (+1) of n8 tile j.
template <typename T>
__device__ __forceinline__ void store_tile(const int (&acc)[kAcc], const Params& p,
                                           unsigned char* ring, const float* col_scale,
                                           const float* col_bias, int m0, int n0, int cw) {
  const int tid = threadIdx.x % 128, warp = tid >> 5, lane = tid & 31;
  const bool has_bias = p.bias != nullptr;
  if (p.vector_stores) {
    // the tile goes through shared memory (the ring, which both warpgroups are
    // done with), so that the stores move whole 16-byte pieces of output rows
    constexpr int kPitch = kBN * (int)sizeof(T) + 16;  // a staged row, padded against bank conflicts
    constexpr int kPieces = kBN * (int)sizeof(T) / 16;  // 16-byte pieces a row
    consumer_barrier();
    unsigned char* staged = ring + cw * 64 * kPitch;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + (lane >> 2) + 8 * h;
        store2(reinterpret_cast<T*>(staged + row * kPitch) + col,
               dequant(acc[4 * j + 2 * h], col_scale[col], col_bias[col], has_bias),
               dequant(acc[4 * j + 2 * h + 1], col_scale[col + 1], col_bias[col + 1], has_bias),
               true, true);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // this warpgroup's rows
    for (int i = tid; i < 64 * kPieces; i += 128) {
      const int row = i / kPieces, piece = i % kPieces;
      const int n = n0 + piece * (16 / (int)sizeof(T));
      T* dst = out_row<T>(p, m0 + cw * 64 + row);
      if (dst != nullptr && n < p.cout && !probe_off(kOffStores))
        *reinterpret_cast<uint4*>(dst + n) =
            *reinterpret_cast<const uint4*>(staged + row * kPitch + piece * 16);
    }
    return;
  }
  const bool paired = (p.cout & 1) == 0;  // two columns a store keep their alignment
  T* rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rows[h] = out_row<T>(p, m0 + cw * 64 + warp * 16 + (lane >> 2) + 8 * h);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3), n = n0 + col;
    if (n >= p.cout) continue;
    const bool both = n + 1 < p.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] == nullptr || probe_off(kOffStores)) continue;
      store2(rows[h] + n, dequant(acc[4 * j + 2 * h], col_scale[col], col_bias[col], has_bias),
             dequant(acc[4 * j + 2 * h + 1], col_scale[col + 1], col_bias[col + 1], has_bias),
             both, paired);
    }
  }
}

// Split-K, by every thread of part `rank` of a tile: rows rank*rows_each.. of the
// tile, summed over the parts' shared memory (row-major int32 at `ring` in each
// CTA of the cluster), dequantized and stored, four columns a thread at a time.
template <typename T>
__device__ __forceinline__ void reduce_parts(const Params& p, uint32_t ring, const float* col_scale,
                                             const float* col_bias, int m0, int n0, int rank) {
  const bool has_bias = p.bias != nullptr;
  const int rows_each = (kBM + p.split - 1) / p.split;
  const int r_begin = rank * rows_each;
  const int rows = (kBM - r_begin < rows_each ? kBM - r_begin : rows_each);
  uint32_t remote[kMaxSplit];
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q) remote[q] = q < p.split ? cluster_map(ring, q) : 0;
  for (int i = threadIdx.x; i < rows * (kBN / 4); i += kThreads) {
    const int row = r_begin + i / (kBN / 4), col = 4 * (i % (kBN / 4)), n = n0 + col;
    T* dst = out_row<T>(p, m0 + row);
    if (dst == nullptr || n >= p.cout) continue;
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < p.split) {
        const int4 v = ld_cluster_v4(remote[q] + (row * kPartPitch + col) * 4);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
    }
    const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = dequant(s4[e], col_scale[col + e], col_bias[col + e], has_bias);
    if (probe_off(kOffStores)) continue;
    if ((p.cout & 3) == 0) {  // four columns keep their alignment
      store2(dst + n, v[0], v[1], true, true);
      store2(dst + n + 2, v[2], v[3], true, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; e += 2) if (n + e < p.cout) store2(dst + n + e, v[e], v[e + 1], n + e + 1 < p.cout, false);
    }
  }
}

// ------------------------------------------------------------------------- //
// the conv
// ------------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv_kernel(const __grid_constant__ CUtensorMap codes_map, const __grid_constant__ CUtensorMap w_map,
            const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1,024 bytes
  const uint32_t full = base + kStages * kStageBytes;  // full[s] = full + 8 s
  const uint32_t empty = full + kStages * 8;           // empty[s] = empty + 8 s
  float* col_scale = reinterpret_cast<float*>(smem_raw + (empty + kStages * 8 - raw));  // [kBN]
  float* col_bias = col_scale + kBN;                         // [kBN]

  const int n_tile = blockIdx.x, m_tile = blockIdx.y, part = blockIdx.z;
  const int n0 = n_tile * kBN, m0 = m_tile * kBM;
  const int s_begin = (int)((long long)part * p.steps / p.split);
  const int n_steps = (int)((long long)(part + 1) * p.steps / p.split) - s_begin;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&codes_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w_map))
                 : "memory");
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(full + 8 * s, 1);
      mbarrier_init(empty + 8 * s, 4 * kConsumers);  // lane 0 of each consuming warp
    }
    fence_barrier_init();
  }
  if (threadIdx.x < kBN) {
    // the dequant factor and bias of each output channel, into shared memory
    // before the products, so that the epilogue's stores wait on no global load
    const int n = n0 + threadIdx.x;
    const bool in = n < p.cout;
    const float w_scale = in ? p.w_scale[n] : 0.f;
    col_scale[threadIdx.x] = p.a_per_channel ? w_scale : __fmul_rn(p.a_scale[0], w_scale);
    col_bias[threadIdx.x] = in && p.bias != nullptr ? p.bias[n] : 0.f;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      // step i: tap j, channels c.. c+127; its codes box lies j/stride rows down
      // and (j%stride)*Cin_pad columns right of the tile's own rows
      auto load_codes = [&](int i) {
        const int s = s_begin + i, j = s / p.chunks, c = (s - j * p.chunks) * kBK;
        tma_load_2d(base + (i % kStages) * kStageBytes, &codes_map, full + 8 * (i % kStages),
                    (j % p.stride) * p.cin_pad + c, m0 + j / p.stride);
      };
      auto load_weights = [&](int i) {
        const int s = s_begin + i, j = s / p.chunks, c = (s - j * p.chunks) * kBK;
        tma_load_2d(base + (i % kStages) * kStageBytes + kTileBytes, &w_map,
                    full + 8 * (i % kStages), j * p.cin_pad + c, n0);
      };
      // the first stages' weights do not depend on the quantize pass: they are
      // on their way before this grid waits for it
      const int first = n_steps < kStages ? n_steps : kStages;
      for (int i = 0; i < first; ++i) {
        if (probe_off(kOffCopies)) {
          mbarrier_arrive(full + 8 * i);
          continue;
        }
        mbarrier_arrive_expect_tx(full + 8 * i, kStageBytes);
        load_weights(i);
      }
      asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the codes are written
      for (int i = 0; i < n_steps; ++i) {
        if (i >= first) {
          const int stage = i % kStages;
          mbarrier_wait(empty + 8 * stage, ((i / kStages) & 1) ^ 1);
          if (probe_off(kOffCopies)) {
            mbarrier_arrive(full + 8 * stage);
            continue;
          }
          mbarrier_arrive_expect_tx(full + 8 * stage, kStageBytes);
          load_weights(i);
        }
        if (!probe_off(kOffCopies)) load_codes(i);
      }
    }
  } else {
    // the consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % kStages;
      mbarrier_wait(full + 8 * stage, (i / kStages) & 1);
      const uint32_t a = base + stage * kStageBytes + cw * 64 * kBK;
      const uint32_t b = base + stage * kStageBytes + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        if (!probe_off(kOffMma)) wgmma_s8(acc, wgmma_desc(a + 32 * kk), wgmma_desc(b + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: its stage is free
      if (i > 0 && lane == 0) mbarrier_arrive(empty + 8 * ((i - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(acc[i])::"memory");

    if (p.split == 1 || probe_off(kOffSplit)) {
      store_tile<T>(acc, p, smem_raw + (base - raw), col_scale, col_bias, m0, n0, cw);
      return;
    }
    // exact split-K: this part's int32 sums into its own shared memory (the ring,
    // which both warpgroups are done with), row-major
    consumer_barrier();
    int* parts = reinterpret_cast<int*>(smem_raw + (base - raw));
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = cw * 64 + warp * 16 + (lane >> 2) + 8 * h, col = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<int2*>(parts + row * kPartPitch + col) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  if (p.split > 1 && !probe_off(kOffSplit)) {
    // the parts of a tile are the CTAs of one cluster: once every part's sums are
    // in place, part r adds up rows r*rows_each.. of all of them through
    // distributed shared memory and stores them; no part leaves while another
    // may still read its shared memory
    cluster_sync();
    uint32_t rank;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    reduce_parts<T>(p, base, col_scale, col_bias, m0, n0, (int)rank);
    cluster_sync();
  }
}

// libcuda's tensor-map encoder, taken through the runtime so that nothing
// links against libcuda itself.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// an int8 matrix [rows, cols] with rows row_bytes apart, cut in 128 x 128 boxes
// that land under the 128-byte swizzle; what lies past it arrives as zeros
bool encode_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                long long row_bytes) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Once per device: both instantiations may use the ring's shared memory. Gives
// the current device's number of SMs.
constexpr int kMaxDevices = 64;
cudaError_t prepare_device(int* sm_count) {
  static std::atomic<int> sms[kMaxDevices];  // 0 until the device is prepared
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = sms[device].load(std::memory_order_acquire);
  if (n == 0) {
    e = cudaFuncSetAttribute(conv_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(conv_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    sms[device].store(n, std::memory_order_release);
  }
  *sm_count = n;
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const T* x, long long batch_stride, long long row_stride, const float* a_scale,
                int a_per_channel, const int8_t* w_packed, const float* w_scale,
                const float* bias, int8_t* codes, void* out, int batch, int t_len, int cin, int cin_pad, int cout, int k, int stride, int pad,
                int t_out, cudaStream_t s) {
  int sm_count = 0;
  cudaError_t err = prepare_device(&sm_count);
  if (err != cudaSuccess) return err;
  const Plan plan = make_plan(batch, t_len, cin_pad, cout, k, stride, pad, sm_count);
  if (plan.m_tiles > 65535 || plan.m_total >= (1LL << 31) - kBM) return cudaErrorInvalidValue;

  const int n8 = batch * plan.t_pad * (cin_pad / 8);  // < 2^31, checked by the C entry
  const unsigned blocks = (unsigned)((n8 + kQThreads - 1) / kQThreads);
  const int aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (batch_stride * (long long)sizeof(T)) % 16 == 0 &&
                       (row_stride * (long long)sizeof(T)) % 16 == 0);
  if (!probe_off(kOffQuantize)) {
    quantize_kernel<T><<<blocks, kQThreads, 0, s>>>(x, batch_stride, row_stride, t_len, pad,
                                                     plan.t_pad, cin, cin_pad, a_scale,
                                                     a_per_channel, aligned, codes, n8);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  CUtensorMap codes_map, w_map;
  if (!encode_map(&codes_map, codes, plan.m_total, (long long)stride * cin_pad,
                  (long long)stride * cin_pad) ||
      !encode_map(&w_map, w_packed, cout, (long long)k * cin_pad, (long long)k * cin_pad))
    return cudaErrorInvalidValue;
  Params p;
  p.a_scale = a_scale;
  p.a_per_channel = a_per_channel;
  p.w_scale = w_scale;
  p.bias = bias;
  p.out = out;
  p.cin_pad = cin_pad;
  p.cout = cout;
  p.stride = stride;
  p.t_out = t_out;
  p.rows_per_item = plan.rows_per_item;
  p.chunks = plan.chunks;
  p.steps = plan.steps;
  p.split = plan.split;
  p.n_tiles = plan.n_tiles;
  p.m_total = (int)plan.m_total;
  p.vector_stores = (cout * (int)sizeof(T)) % 16 == 0;
  // a programmatic dependent of the quantize pass: its CTAs start while the pass
  // runs and wait for the codes before they copy them (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.n_tiles, plan.m_tiles, plan.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;  // the parts of a split tile
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = plan.split;
  cfg.attrs = attr;
  cfg.numAttrs = plan.split > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, conv_kernel<T>, codes_map, w_map, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The conv's tiles and split at a shape on a card with sm_count SMs:
// out = {t_pad, m_tiles, n_tiles, split, steps}. Returns 0, or an error code.
extern "C" int condmdi_int8_conv1d_plan(int batch, int t_len, int cin_pad, int cout, int k,
                                        int stride, int pad, int sm_count, int* out) {
  if (batch <= 0 || t_len <= 0 || cin_pad <= 0 || cin_pad % kBK != 0 || cout <= 0 || k <= 0 ||
      (stride != 1 && stride != 2) || pad < 0 || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(batch, t_len, cin_pad, cout, k, stride, pad, sm_count);
  out[0] = p.t_pad;
  out[1] = p.m_tiles;
  out[2] = p.n_tiles;
  out[3] = p.split;
  out[4] = p.steps;
  return 0;
}

extern "C" int condmdi_int8_conv1d(const void* x, int dtype, long long x_batch_stride,
                                   long long x_row_stride, const void* a_scale, int a_per_channel,
                                   const void* w_packed, const void* w_scale, const void* bias,
                                   void* codes, void* out, int batch, int t_len,
                                   int cin, int cin_pad, int cout, int k, int stride, int pad,
                                   int t_out, void* stream) {
  if (batch <= 0 || t_len <= 0 || cin <= 0 || cin_pad < cin || cin_pad % kBK != 0 || cout <= 0 ||
      (k != 1 && k != 3 && k != 5) || (stride != 1 && stride != 2) || pad < 0 || pad >= k ||
      t_out <= 0 || t_out != (t_len + 2 * pad - k) / stride + 1 ||
      (long long)batch * (t_len + 2 * pad + 1) * cin_pad / 8 >= 0x7fffffffLL - kQThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* as = static_cast<const float*>(a_scale);
  const int8_t* wp = static_cast<const int8_t*>(w_packed);
  const float* wsc = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  int8_t* c = static_cast<int8_t*>(codes);
  if (dtype == 0)
    return (int)run(static_cast<const float*>(x), x_batch_stride, x_row_stride, as,
                    a_per_channel, wp, wsc, b, c, out, batch, t_len, cin, cin_pad,
                    cout, k, stride, pad, t_out, s);
  if (dtype == 1)
    return (int)run(static_cast<const __nv_bfloat16*>(x), x_batch_stride, x_row_stride, as,
                    a_per_channel, wp, wsc, b, c, out, batch, t_len, cin, cin_pad,
                    cout, k, stride, pad, t_out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
