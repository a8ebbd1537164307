// Fused multi-head self-attention for Hopper (sm_90a):
//   out[b, t, h*hd:(h+1)*hd] = softmax(q_h[t] . k_h^T / sqrt(hd), keys < T) . v_h
// for every batch item b, head h and query row t < T.
//
// Replaces the Pallas TPU kernel condmdi_tpu/ops/attention.py:34 `_attn_kernel`
// (launched by `_pallas_self_attention`). The TPU layout (q/k/v transposed to
// [B, H, Tp, hdp] and padded to 128 x 128 tiles, one (batch, head) block in
// VMEM) is not carried over: both kernels here read the heads straight out of
// the [B, T, D] column blocks of the fused QKV projection, with a row stride.
//
// What bounds it on an H100: bytes. At the served MDM shape (B=8 rows under
// CFG, T=197, D=512, H=4, hd=128) q, k, v and out in bf16 are 6.46 MB, 1.93 us
// at 3.35 TB/s, against 4*B*H*T^2*hd = 0.64 GFLOP, 0.64 us at 989 TFLOP/s.
//
// Two hand-written kernels, and which shape takes which: `route_of` below, a
// function of the shape and the type alone, exported as
// `condmdi_attention_route`. The caller names the route it expects
// (ops/attention.py `attention_route`, the same function in Python, so that it
// can be asked where there is no card), and the entry point refuses any other:
//
//   route 1, "wgmma" -- `resident::attention_resident_kernel`: bfloat16 with a
//     head width of 32, 64 or 128 whose K and V fit one block's shared memory,
//     4*hd*16*ceil(T/16) + 256 <= 231,424 bytes: T <= 448 at hd=128, 896 at
//     hd=64, 1792 at hd=32. This is what the models serve (T <= 225).
//   route 2, "wgmma_f32" -- `resident::attention_resident_kernel<HD, true>`
//     behind `resident::split_qkv_kernel`: float32 at a head width of 32, 64
//     or 128 whose hi and lo planes of K and V fit one block,
//     8*hd*16*ceil(T/16) + 256 <= 231,424 bytes: T <= 224 at hd=128, 448 at
//     hd=64, 896 at hd=32. This is what the MDM CLIs run (f32, T = 197).
//   route 0, "mma_sync" -- `tiled::attention_tiled_kernel`: every other head
//     width (multiples of 8 up to 128) and longer T, in either type. It walks
//     K and V in 64-key tiles, so any T works.
//
// route 1, the design. A CTA is one warpgroup (128 threads). A work item is one
// 64-row query tile of one head of one batch item; a CTA takes a contiguous
// range of items (one item each while two CTAs an SM hold them all: the
// served batch).
//   * All of a head's K and V are resident in shared memory. One thread asks
//     the TMA for them up front, a box of min(hd, 64) columns x 64 rows at a
//     time, one mbarrier per 64-key tile in the order of use: the first tile's
//     products start while the later tiles are on their way, and no computing
//     thread starts a copy. Rows T..16*ceil(T/16) arrive as zeros from the
//     hardware, inside the batch item.
//   * A box lands as rows of 128 bytes (64 at hd=32) under the swizzle of that
//     width, which wgmma reads by descriptor with no transpose in software: K
//     as the K-major operand of S = Q.K^T, V as the MN-major operand of
//     O += P.V through the transpose bit. The tensor maps depend on the
//     tensors' addresses, so the C entry encodes them on every call.
//   * Q never enters shared memory and neither does the output: the four lanes
//     of a quad read (write) 64 contiguous bytes of a row, 16 each, and a 4x4
//     transpose by shuffles turns them into (out of) the m16n8k16 fragment
//     layout that wgmma shares. P stays in registers too: the S accumulators
//     of two 8-key tiles are the A fragment of one k16 step of P.V.
//   * Both products are wgmma (m64n64k16 for S, m64n{hd}k16 for O), bf16 in,
//     f32 accumulate. Key tile j's scores are started together with tile j-1's
//     P.V, so the tensor cores work on P.V through tile j's softmax; the first
//     and the last tile are peeled, because the assembler serialises the
//     products unless the loop's structure is fixed.
//   * The online softmax runs in the log2 domain in f32, keys >= T masked to
//     -inf after the product. A row's reference maximum moves only when a tile
//     exceeds it by 2^8 (any reference gives the same quotient), so most tiles
//     skip rescaling O. Normalisation once at the end, rows >= T not written.
//   * With K and V at 107 KB for T=197, hd=128, two CTAs share an SM. Within a
//     CTA's range most items find their head's K and V in place; where the
//     head changes, each key tile's place is handed over as the last item's
//     P.V frees it: the next head's copy of that tile goes out at once.
//
// route 2, the same kernel for float32. The tensor cores take no float32
// operand short of TF32 (10 mantissa bits), so each value is split once into
// hi = bf16(x) and lo = bf16(x - hi), and each product is three bf16 products,
// hi.hi + hi.lo + lo.hi, accumulated in f32 in that order: about 16 mantissa
// bits, the precision of route 0.
//   * The split happens once per call, in `split_qkv_kernel`: q, k and v are
//     read once and written as bf16 planes [q, k, v][hi, lo][B][T][D]. The
//     attention kernel is launched as its programmatic dependent: it sets up
//     its barriers while the pass runs and waits for it (griddepcontrol.wait)
//     before its first copy. In the planes, lo is the batch item B further on,
//     so one tensor map of 2B items serves hi and lo of K (and of V).
//   * K and V stay resident as in route 1, hi and lo side by side: 4 planes,
//     213 KB at T=197, hd=128, so one CTA an SM there (two at hd <= 64).
//   * Q's hi and lo fragments and P's stay in registers; the online softmax,
//     the masking and the hand-over between heads are route 1's. The output
//     is float32.
//
// route 0 is the first version of this kernel, unchanged: one CTA per (tile of
// 64 query rows, head, batch item), four warps of 16 query rows each, K
// row-major and V transposed into shared memory tile by tile with plain
// 16-byte loads staged through registers, mma.sync m16n8k16, the same online
// softmax. float32 inputs go through the tensor cores as a hi+lo bf16 split
// (hi*hi + hi*lo + lo*hi for both products), which keeps about 16 mantissa
// bits. hd may be any multiple of 8 up to 128 (columns up to the next multiple
// of 16 are zero in shared memory). Timings of both routes, and what was tried
// and dropped on the way, are in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is taken at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// Probe builds only. attention_probe.py compiles copies of this file with
// -DCONDMDI_PROBE_OFF=<mask of ProbeOff>, which switches parts of the resident
// kernel off (the results are then wrong; the times tell what each part
// costs), or with -DCONDMDI_PROBE_STAMPS, which records clock64() at a CTA's
// milestones, 32 slots a CTA. The package's build defines neither, and every
// line that names them folds away.
#ifndef CONDMDI_PROBE_OFF
#define CONDMDI_PROBE_OFF 0
#endif
#ifdef CONDMDI_PROBE_STAMPS
__device__ unsigned long long* g_probe_stamps = nullptr;
#define CONDMDI_STAMP(slot)                                                   \
  do {                                                                        \
    if (g_probe_stamps != nullptr && threadIdx.x == 0)                        \
      g_probe_stamps[(size_t)blockIdx.x * 32 + (slot)] = clock64();           \
  } while (0)
#else
#define CONDMDI_STAMP(slot) \
  do {                      \
    (void)(slot);           \
  } while (0)
#endif

namespace {

enum ProbeOff {
  kOffScores = 1, kOffPv = 2, kOffSoftmax = 4, kOffStores = 8, kOffQ = 16,
  kOffSlack = 32,      // a row's reference maximum moves on every tile
  kOffSecondCta = 64,  // one CTA an SM
  kOffF32Route = 128,  // float32 takes route 0, the first design, at every shape
  kOffPdl = 256,       // route 2's kernel launched in stream order, not as the pass's dependent
};
__host__ __device__ constexpr bool probe_off(int part) { return (CONDMDI_PROBE_OFF & part) != 0; }

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHd = 128;       // widest head either kernel takes
constexpr int kMaxSmem = 232448;  // dynamic + static shared memory of one block on sm_90

// two floats as one bf16x2 register, `lo` in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------------- //
// route 1: bfloat16, K and V of one head resident in shared memory, wgmma
// ------------------------------------------------------------------------- //

namespace resident {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // one warpgroup: 4 warps x 16 query rows
constexpr int kBlockM = 64;     // query rows per tile
constexpr int kBlockN = 64;     // keys per tile
constexpr int kSmemBudget = kMaxSmem - 1024;  // what ops/attention.py routes by
constexpr int kMaxTiles = 32;   // key tiles of the longest sequence the budget holds (hd=32)
constexpr int kBarrierBytes = kMaxTiles * 8;
constexpr float kMaxSlack = probe_off(kOffSlack) ? 0.f : 8.f;  // log2 of how far P may outgrow 1 before a row's reference moves
// S = Q.K^T always reads 64 rows of a K tile; where the last tile is shorter it
// reads on into V, and V must reach that far
constexpr int kOverread = (kBlockN - 16) * 128;

// K and V of one head: rows of hd bf16, padded to a multiple of 16 rows, in
// `planes` planes each (1, or hi and lo for float32); then the barriers
__host__ __device__ constexpr int padded_rows(int t_len) { return (t_len + 15) & ~15; }
__host__ __device__ constexpr long long smem_bytes(int t_len, int hd, int planes = 1) {
  const long long one = 2LL * hd * padded_rows(t_len);  // one plane of K, or of V
  const long long after_k = planes * one;               // what follows K's last plane: V
  return 2 * planes * one + (after_k < kOverread ? kOverread - after_k : 0) + kBarrierBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
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
    if (!done && ++spins > (1u << 22)) __trap();
  } while (!done);
}
// One TMA copy of a box of the 3-D view (columns; rows; batch items) into shared
// memory, completing on the barrier; rows >= T arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int batch_item) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(batch_item)
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
// the barriers' initialisation becomes visible to the copies that complete on them
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// keeps the compiler from moving uses of an accumulator across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of an operand stored as rows of ROW_BYTES (128 or 64)
// under the swizzle of that width, the layout a TMA box with the same swizzle
// lands in. `sbo`: bytes between groups of 8 rows. `lbo`: for the MN-major
// operand, bytes between two ROW_BYTES-wide column groups; unused (16) for the
// K-major one, whose depth steps move the start address inside the row.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "128-byte or 64-byte swizzle");
  constexpr uint64_t kLayout = ROW_BYTES == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define CONDMDI_D8(d, o)                                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64 x N] (+)= a[64 x 16] . b[16 x N]: a in registers (this thread's m16n8k16
// A fragment of its warp's 16 rows), b in shared memory by descriptor, K-major
// (TNSP 0) or MN-major (TNSP 1). scale_d 0 overwrites d.
template <int N, int TNSP>
struct WgmmaRS;
template <int TNSP>
struct WgmmaRS<32, TNSP> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b_desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : CONDMDI_D8(d, 0), CONDMDI_D8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d), "n"(TNSP));
  }
};
template <int TNSP>
struct WgmmaRS<64, TNSP> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b_desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : CONDMDI_D8(d, 0), CONDMDI_D8(d, 8), CONDMDI_D8(d, 16), CONDMDI_D8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d), "n"(TNSP));
  }
};
template <int TNSP>
struct WgmmaRS<128, TNSP> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b_desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : CONDMDI_D8(d, 0), CONDMDI_D8(d, 8), CONDMDI_D8(d, 16), CONDMDI_D8(d, 24),
          CONDMDI_D8(d, 32), CONDMDI_D8(d, 40), CONDMDI_D8(d, 48), CONDMDI_D8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d), "n"(TNSP));
  }
};
#undef CONDMDI_D8

// A 4 x 4 transpose of words across the four lanes of a quad (cq is the lane's
// index in it): in, w[d] is the word meant for lane d; out, w[s] is the word
// that lane s meant for this lane. It turns 16 contiguous bytes a lane into the
// 4-byte column pairs of the mma fragments, and back.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int cq) {
  const bool hi = (cq & 2) != 0, lo = (cq & 1) != 0;
  uint32_t a = hi ? w[0] : w[2], b = hi ? w[1] : w[3];
  a = __shfl_xor_sync(0xffffffffu, a, 2);
  b = __shfl_xor_sync(0xffffffffu, b, 2);
  w[0] = hi ? a : w[0];
  w[1] = hi ? b : w[1];
  w[2] = hi ? w[2] : a;
  w[3] = hi ? w[3] : b;
  a = lo ? w[0] : w[1];
  b = lo ? w[2] : w[3];
  a = __shfl_xor_sync(0xffffffffu, a, 1);
  b = __shfl_xor_sync(0xffffffffu, b, 1);
  w[0] = lo ? a : w[0];
  w[2] = lo ? b : w[2];
  w[1] = lo ? w[1] : a;
  w[3] = lo ? w[3] : b;
}

// Query rows row0 and row0 + 8 of one head, as the four lanes of a quad read
// them: 64 contiguous bytes of a row at a time, 16 a lane. Rows >= T read as
// zero. Only starts the loads.
template <int HD>
__device__ __forceinline__ void load_q_rows(uint4 (&raw)[2][HD / 32],
                                            const bf16* __restrict__ q_head, long long stride_t,
                                            int row0, int t_len, int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const uint4* p = reinterpret_cast<const uint4*>(q_head + (long long)row * stride_t) + cq;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)  // 32 columns are 4 lanes x 16 bytes; read once: streaming
      raw[r][i] = row < (probe_off(kOffQ) ? 0 : t_len)
                      ? __ldcs(p + 4 * i)
                      : make_uint4(probe_off(kOffQ) ? 1u : 0u, 0u, 0u, 0u);
  }
}

// The rows that `load_q_rows` fetched as this thread's A fragments of all
// HD/16 depth steps: lane cq holds columns 2cq, 2cq+1 of every block of 8.
template <int HD>
__device__ __forceinline__ void q_fragments(uint32_t (&qf)[HD / 16][4],
                                            const uint4 (&raw)[2][HD / 32], int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      uint32_t w[4] = {raw[r][i].x, raw[r][i].y, raw[r][i].z, raw[r][i].w};
      quad_transpose(w, cq);
#pragma unroll
      for (int d = 0; d < 4; ++d)  // block 4i+d: the low or high half of depth step (4i+d)/2
        qf[(4 * i + d) / 2][((4 * i + d) & 1) * 2 + r] = w[d];
    }
}

// float32 -> its bf16 hi and lo parts: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split4(float4 x, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x.x, x.y), h1 = __floats2bfloat162_rn(x.z, x.w);
  hi = make_uint2(*reinterpret_cast<const uint32_t*>(&h0), *reinterpret_cast<const uint32_t*>(&h1));
  lo = make_uint2(pack_bf16(x.x - __low2float(h0), x.y - __high2float(h0)),
                  pack_bf16(x.z - __low2float(h1), x.w - __high2float(h1)));
}

// route 2's split pass: q, k, v [B, T, cols] (rows stride_t apart, 16-byte
// aligned) -> planes [3 (q, k, v)][2 (hi, lo)][B][T][cols] bf16, four values a
// thread. The attention kernel behind it is its programmatic dependent.
constexpr int kSplitThreads = 256;
__global__ void __launch_bounds__(kSplitThreads)
split_qkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, long long stride_b, long long stride_t, int batch,
                 int t_len, int cols, bf16* __restrict__ planes, int n4) {
  // the attention kernel may set up its barriers now; it waits for the planes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int i = blockIdx.x * kSplitThreads + threadIdx.x;  // the C entry keeps n4 < 2^31
  if (i >= n4) return;
  const int c4 = cols / 4;
  const int row = i / c4, c = (i - row * c4) * 4;  // row = (which * B + b) * T + t
  const int item = row / t_len, t = row - item * t_len;
  const int which = item / batch, b = item - which * batch;
  const float* src = (which == 0 ? q : which == 1 ? k : v) + (long long)b * stride_b +
                     (long long)t * stride_t + c;
  uint2 hi, lo;
  split4(__ldcs(reinterpret_cast<const float4*>(src)), hi, lo);
  const long long plane = (long long)batch * t_len * cols;
  const long long at = ((long long)which * 2 * batch + b) * t_len * cols + (long long)t * cols + c;
  *reinterpret_cast<uint2*>(planes + at) = hi;
  *reinterpret_cast<uint2*>(planes + at + plane) = lo;
}

// SPLIT (route 2): q, K and V are hi and lo bf16 planes, lo `lo_batch` batch
// items after hi; each product is three; the output is float32.
template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kThreads, SPLIT ? 1 : 2)
attention_resident_kernel(const bf16* __restrict__ q,  // [B, T, *], rows stride_t apart, head h at h*HD
                          void* __restrict__ out_raw,  // [B, T, H*HD] contiguous, bf16 (float32 if SPLIT)
                          // k and v as 3-D views (H*HD columns; T rows; B) in boxes of
                          // min(HD, 64) columns x 64 rows, and x the last key tile's rows
                          const __grid_constant__ CUtensorMap k_full,
                          const __grid_constant__ CUtensorMap k_last,
                          const __grid_constant__ CUtensorMap v_full,
                          const __grid_constant__ CUtensorMap v_last,
                          long long stride_b, long long stride_t,
                          int t_len, int heads, int items_per_cta, int ctas_with_one_more,
                          float scale_log2, int lo_batch) {
  constexpr int kNK = HD / 16;                 // depth steps of Q.K^T
  constexpr int kCols = HD < 64 ? HD : 64;     // columns of one box: one swizzled row
  constexpr int kRowBytes = kCols * 2;
  constexpr int kGroups = HD / kCols;          // column groups of a key tile
  constexpr int kTileBytes = kBlockN * HD * 2; // one full key tile of K, or of V
  constexpr int kPlanes = SPLIT ? 2 : 1;       // hi (and lo) of K, and of V
  extern __shared__ __align__(1024) unsigned char smem_resident[];
  CONDMDI_STAMP(0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;  // fragment row / column pair
  const int n_tiles = (t_len + kBlockN - 1) / kBlockN;  // key tiles = query tiles
  // A work item is one query tile of one head of one batch item, numbered with
  // the query tiles of a head together. This CTA takes a contiguous range, so
  // most of its items find their head's K and V in place.
  const int item0 = blockIdx.x * items_per_cta + min((int)blockIdx.x, ctas_with_one_more);
  const int item1 = item0 + items_per_cta + ((int)blockIdx.x < ctas_with_one_more ? 1 : 0);
  const int last_rows = padded_rows(t_len) - (n_tiles - 1) * kBlockN;  // 16, 32, 48 or 64
  const uint32_t s_k = smem_u32(smem_resident);
  const uint32_t plane = 2 * HD * padded_rows(t_len);  // bytes of one plane of K, or of V
  const uint32_t s_v = s_k + kPlanes * plane;
  // one barrier per key tile, behind K, V and what S may read past them
  const uint32_t bars = s_k + (uint32_t)smem_bytes(t_len, HD, kPlanes) - kBarrierBytes;
  if ((s_k & 1023) != 0) __trap();  // the swizzle is a function of the address

  // All of K and V by TMA, one barrier per key tile, in the order of use. Tile
  // j lands as [column group][row][kCols columns] under the swizzle, full tiles
  // kTileBytes apart; the last tile has `last_rows` rows. Tile 0 goes first,
  // then the loads of Q, straight to registers, then the other tiles. A lo
  // plane lies `plane` bytes after its hi plane.
  auto copy_tiles = [&](int j0, int j1, int h, int b) {
    for (int j = j0; j < j1; ++j) {
      const bool last = j == n_tiles - 1;
      const int rows = last ? last_rows : kBlockN;
      const uint32_t bar = bars + 8 * j;
      mbarrier_arrive_expect_tx(bar, kPlanes * 2 * rows * HD * 2);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          tma_load_3d(s_k + p * plane + j * kTileBytes + g * rows * kRowBytes,
                      last ? &k_last : &k_full, bar, h * HD + g * kCols, j * kBlockN,
                      b + p * lo_batch);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          tma_load_3d(s_v + p * plane + j * kTileBytes + g * rows * kRowBytes,
                      last ? &v_last : &v_full, bar, h * HD + g * kCols, j * kBlockN,
                      b + p * lo_batch);
    }
  };
  // the batch item, head and query tile of the item in hand, and of the one after it
  int b = item0 / (n_tiles * heads);
  int h = item0 / n_tiles - b * heads;
  int qt = item0 - (b * heads + h) * n_tiles;
  int next_b, next_h, next_qt;
  uint4 q_rows[kPlanes][2][HD / 32];  // an item's Q rows on their way (hi, and lo if SPLIT)
  auto fetch_q = [&](int b, int h, int qt) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      load_q_rows<HD>(q_rows[p], q + (long long)(b + p * lo_batch) * stride_b + (long long)h * HD,
                      stride_t, qt * kBlockM + warp * 16 + gq, t_len, cq);
  };
  if (tid == 0) {
    for (int j = 0; j < n_tiles; ++j) mbarrier_init(bars + 8 * j, 1);
    fence_barrier_init();
  }
  // route 2: the planes are written by the split pass this grid depends on
  if constexpr (SPLIT) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0) {
    CONDMDI_STAMP(1);
    copy_tiles(0, 1, h, b);
  }
  fetch_q(b, h, qt);
  if (tid == 0) copy_tiles(1, n_tiles, h, b);
  __syncthreads();  // the barriers exist before anyone waits on them
  CONDMDI_STAMP(2);

  uint32_t qf[kPlanes][kNK][4];  // Q of one query tile as the A fragments of Q.K^T (hi, lo)
  float o[HD / 2];  // n8 tile t of this warp's 16 rows: o[4t .. 4t+3]
  float s[32];      // scores of one key tile: s[4t + 2r + e] is row gq + 8r, key 8t + 2cq + e
  uint32_t pa[kPlanes][kBlockN / 16][4];  // P of one key tile as the A fragments of P.V (hi, lo)
  // rows gq and gq + 8: running max of the raw scores, this thread's part of the row sum
  float row_max[2], row_sum[2], corr[2];
  const float max_slack = kMaxSlack / scale_log2;  // in units of the raw scores
  bool new_head = true;  // this item waits for K and V; the head's later items find them in place
  uint32_t parity = 0;   // of the barriers' phase that belongs to this head

  // S = Q . K^T of key tile j: 64 rows x 64 keys, left in flight. Past the
  // last tile's rows the product reads whatever follows in shared memory;
  // those keys are masked before use.
  auto start_scores = [&](int j) {
    const uint32_t group = (j == n_tiles - 1 ? last_rows : kBlockN) * kRowBytes;
    const uint32_t k_tile = s_k + j * kTileBytes;
    if (new_head) mbarrier_wait(bars + 8 * j, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk)
      if (!probe_off(kOffScores) || t_len < 0) {
        const uint32_t at = k_tile + (16 * kk / kCols) * group + (16 * kk % kCols) * 2;
        const uint64_t k_hi = wgmma_desc<kRowBytes>(at, 16, 8 * kRowBytes);
        WgmmaRS<64, 0>::run(s, qf[0][kk], k_hi, kk > 0);
        if constexpr (SPLIT) {  // + q_hi . k_lo + q_lo . k_hi
          WgmmaRS<64, 0>::run(s, qf[0][kk], wgmma_desc<kRowBytes>(at + plane, 16, 8 * kRowBytes),
                              1);
          WgmmaRS<64, 0>::run(s, qf[kPlanes - 1][kk], k_hi, 1);
        }
      }
    wgmma_commit();
  };
  // O += P . V of key tile j, left in flight; the last tile holds no rows past
  // the zero-filled ones
  auto start_pv = [&](int j, int rows) {
    const uint32_t v_tile = s_v + j * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      if (kk * 16 < rows && (!probe_off(kOffPv) || t_len < 0)) {
        const uint32_t at = v_tile + kk * 16 * kRowBytes;
        const uint64_t v_hi = wgmma_desc<kRowBytes>(at, rows * kRowBytes, 8 * kRowBytes);
        WgmmaRS<HD, 1>::run(o, pa[0][kk], v_hi, 1);
        if constexpr (SPLIT) {  // + p_hi . v_lo + p_lo . v_hi
          WgmmaRS<HD, 1>::run(
              o, pa[0][kk], wgmma_desc<kRowBytes>(at + plane, rows * kRowBytes, 8 * kRowBytes), 1);
          WgmmaRS<HD, 1>::run(o, pa[kPlanes - 1][kk], v_hi, 1);
        }
      }
    wgmma_commit();
  };
  // The online softmax of key tile j on the finished scores: s becomes P
  // (unnormalised). A row's reference maximum moves only when the tile's own
  // maximum exceeds it by more than kMaxSlack (then P would outgrow 2^kMaxSlack),
  // and then for the whole warp: returns whether it did, with corr the factor
  // that the earlier tiles' O takes. Any reference gives the same quotient.
  auto softmax = [&](int j) -> bool {
    const int n0 = j * kBlockN;
    if (n0 + kBlockN > t_len) {  // the ragged last tile: keys >= T
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = n0 + (i >> 2) * 8 + 2 * cq + (i & 1);
        s[i] = col < t_len ? s[i] : -INFINITY;
      }
    }
    float tile_max[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        m[t] = fmaxf(fmaxf(s[4 * t + 2 * r], s[4 * t + 2 * r + 1]),
                     fmaxf(s[4 * t + 16 + 2 * r], s[4 * t + 16 + 2 * r + 1]));
      tile_max[r] = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
      // the four threads of a quad hold one row; key n0 < T keeps the max finite
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    }
    // always on the first tile, where the reference is -inf
    const bool moved = __any_sync(0xffffffffu, tile_max[0] > row_max[0] + max_slack ||
                                                   tile_max[1] > row_max[1] + max_slack);
    if (moved) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float new_max = fmaxf(row_max[r], tile_max[r]);
        corr[r] = fast_exp2((row_max[r] - new_max) * scale_log2);  // 0 on the first tile
        row_max[r] = new_max;
        row_sum[r] *= corr[r];
      }
    }
    const float max_scaled[2] = {row_max[0] * scale_log2, row_max[1] * scale_log2};
#pragma unroll
    for (int i = 0; i < 32; ++i)  // masked keys give 0
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -max_scaled[(i >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        part[t] = (s[4 * t + 2 * r] + s[4 * t + 2 * r + 1]) +
                  (s[4 * t + 16 + 2 * r] + s[4 * t + 16 + 2 * r + 1]);
      row_sum[r] += (part[0] + part[1]) + (part[2] + part[3]);
    }
    return moved;
  };
  // the S accumulators of key tiles 2kk, 2kk+1 are the A fragment of step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      if constexpr (SPLIT) {  // hi = bf16(p), lo = bf16(p - hi)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float a = s[8 * kk + 2 * w], b = s[8 * kk + 2 * w + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
          pa[0][kk][w] = *reinterpret_cast<const uint32_t*>(&hi);
          pa[kPlanes - 1][kk][w] = pack_bf16(a - __low2float(hi), b - __high2float(hi));
        }
      } else {
        pa[0][kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[0][kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[0][kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[0][kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }
  };

  for (int item = item0; item < item1; ++item) {
    next_qt = qt + 1 < n_tiles ? qt + 1 : 0;
    next_h = next_qt > 0 ? h : h + 1 < heads ? h + 1 : 0;
    next_b = next_qt > 0 || next_h > 0 ? b : b + 1;
    // Where the next item belongs to another head, a key tile is free once
    // its P.V is done, for every warp: the next head's copy of that tile
    // goes out at once, so its K and V arrive while this item still computes.
    const bool hand_over = item + 1 < item1 && next_qt == 0;
    auto copy_next_heads = [&](int j) {
      __syncthreads();
      if (tid == 0) copy_tiles(j, j + 1, next_h, next_b);
    };
    const int stamp = 3 * (item - item0 < 8 ? item - item0 : 8);  // slots 3..26: the first 8 items
    CONDMDI_STAMP(3 + stamp);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) q_fragments<HD>(qf[p], q_rows[p], cq);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    row_max[0] = row_max[1] = -INFINITY;
    row_sum[0] = row_sum[1] = 0.f;

    // Key tile j's scores and key tile j-1's P.V are started together: the
    // tensor cores work on P.V through tile j's softmax.
    start_scores(0);
    if (new_head) CONDMDI_STAMP(4 + stamp);  // tile 0 of a new head in place
    wgmma_wait<0>();
    fence_regs(s);
    if (!probe_off(kOffSoftmax)) softmax(0);
    pack_p();
    for (int j = 1; j < n_tiles; ++j) {
      start_scores(j);
      start_pv(j - 1, kBlockN);
      wgmma_wait<1>();  // the scores are done, P.V may still run
      fence_regs(s);
      const bool moved = probe_off(kOffSoftmax) ? false : softmax(j);
      wgmma_wait<0>();  // P.V is done: O may be rescaled, P overwritten
      fence_regs(o);
      if (hand_over) copy_next_heads(j - 1);
      if (moved) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      pack_p();
    }
    // the next item's Q rows are fetched behind the last P.V and the stores
    start_pv(n_tiles - 1, last_rows);
    if (item + 1 < item1) fetch_q(next_b, next_h, next_qt);
    wgmma_wait<0>();
    fence_regs(o);
    if (hand_over) copy_next_heads(n_tiles - 1);
    new_head = hand_over;
    parity ^= hand_over ? 1u : 0u;
    CONDMDI_STAMP(5 + stamp);  // the item is computed

    // normalise and write rows < T
    const int row_base = qt * kBlockM + warp * 16 + gq;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      inv[r] = 1.f / row_sum[r];
    }
    const int d_model = heads * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_base + 8 * half;
      const long long at = ((long long)b * t_len + row) * d_model + h * HD;
      if constexpr (SPLIT) {  // float32: each thread's column pair of every 8-column block
        float2* dst = reinterpret_cast<float2*>(static_cast<float*>(out_raw) + at) + cq;
        if (row < t_len) {
#pragma unroll
          for (int t = 0; t < HD / 8; ++t)
            dst[4 * t] = make_float2(o[4 * t + 2 * half] * inv[half],
                                     o[4 * t + 2 * half + 1] * inv[half]);
        }
      } else {
        uint4* dst = reinterpret_cast<uint4*>(static_cast<bf16*>(out_raw) + at) + cq;
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) {  // 4 blocks of 8 columns: 16 contiguous bytes a lane
          uint32_t w[4];
#pragma unroll
          for (int d = 0; d < 4; ++d)
            w[d] = pack_bf16(o[4 * (4 * i + d) + 2 * half] * inv[half],
                             o[4 * (4 * i + d) + 2 * half + 1] * inv[half]);
          quad_transpose(w, cq);
          if (row < (probe_off(kOffStores) ? 0 : t_len))
            dst[4 * i] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    b = next_b;
    h = next_h;
    qt = next_qt;
  }
  CONDMDI_STAMP(30);
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

// x [B, T, cols] (rows stride_t elements apart, 16-byte aligned) as a 3-D bf16
// tensor (cols; T; B), cut in boxes of (box_cols; box_rows; 1) that land in
// shared memory as rows of box_cols bf16 under the swizzle of that width (128
// or 64 bytes), which is how wgmma reads them. About 3 us of host time a map.
bool encode_map(CUtensorMap* map, const void* x, int batch, int t_len, int cols,
                long long stride_b, long long stride_t, int box_rows, int box_cols) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  if (batch == 1) stride_b = (long long)t_len * stride_t;  // unused, but must be a valid stride
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)stride_t * 2, (cuuint64_t)stride_b * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per device and instantiation: the kernel may use a block's whole shared
// memory, and the SM keeps all of its memory as shared memory, so that two CTAs
// fit where their sizes allow. Gives the current device's number of SMs.
constexpr int kMaxDevices = 64;
constexpr int kCtasPerSm = probe_off(kOffSecondCta) ? 1 : 2;  // what shared memory allows as served
constexpr int kSmemPerSm = 233472;  // an SM's shared memory, 1 KB of it reserved per CTA
template <int HD, bool SPLIT>
cudaError_t prepare_device(int* sm_count) {
  static std::atomic<int> sms[kMaxDevices];  // 0 until the device is prepared
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = sms[device].load(std::memory_order_acquire);
  if (n == 0) {
    auto kernel = attention_resident_kernel<HD, SPLIT>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    sms[device].store(n, std::memory_order_release);
  }
  *sm_count = n;
  return cudaSuccess;
}

// The four maps of K and V (full and last key tiles) over k and v viewed as
// (cols; T; batch) with these strides.
template <int HD>
bool encode_kv_maps(CUtensorMap (&maps)[4], const void* k, const void* v, int batch, int t_len,
                    int cols, long long stride_b, long long stride_t) {
  const int n_tiles = (t_len + kBlockM - 1) / kBlockM;
  const int last_rows = padded_rows(t_len) - (n_tiles - 1) * kBlockN;
  constexpr int kCols = HD < 64 ? HD : 64;
  CUtensorMap &k_full = maps[0], &k_last = maps[1], &v_full = maps[2], &v_last = maps[3];
  if (!encode_map(&k_last, k, batch, t_len, cols, stride_b, stride_t, last_rows, kCols) ||
      !encode_map(&v_last, v, batch, t_len, cols, stride_b, stride_t, last_rows, kCols))
    return false;
  if (n_tiles > 1 && last_rows != kBlockN) {
    if (!encode_map(&k_full, k, batch, t_len, cols, stride_b, stride_t, kBlockN, kCols) ||
        !encode_map(&v_full, v, batch, t_len, cols, stride_b, stride_t, kBlockN, kCols))
      return false;
  } else {  // the same boxes, or never used by the kernel
    k_full = k_last;
    v_full = v_last;
  }
  return true;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
           int heads, long long stride_b, long long stride_t, cudaStream_t stream) {
  int sm_count = 0;
  const cudaError_t ready = prepare_device<HD, false>(&sm_count);
  if (ready != cudaSuccess) return (int)ready;
  const int n_tiles = (t_len + kBlockM - 1) / kBlockM;
  CUtensorMap maps[4];
  if (!encode_kv_maps<HD>(maps, k, v, batch, t_len, heads * HD, stride_b, stride_t))
    return (int)cudaErrorInvalidValue;
  // one CTA a query tile while the card holds them all at once, else kCtasPerSm
  // CTAs an SM with a contiguous range of query tiles each
  const long long items = (long long)batch * heads * n_tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int max_ctas = kCtasPerSm * sm_count;
  const int grid = (int)(items < max_ctas ? items : max_ctas);
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  attention_resident_kernel<HD, false><<<grid, kThreads, (size_t)smem_bytes(t_len, HD), stream>>>(
      static_cast<const bf16*>(q), out, maps[0], maps[1], maps[2], maps[3], stride_b, stride_t,
      t_len, heads, (int)(items / grid), (int)(items % grid), scale_log2, 0);
  return (int)cudaGetLastError();
}

// route 2: the split pass into `planes` ([3][2][B][T][H*HD] bf16, the caller's
// scratch), then the kernel on the planes as the pass's programmatic dependent.
template <int HD>
int launch_split(const void* q, const void* k, const void* v, void* out, void* planes,
                 int batch, int t_len, int heads, long long stride_b, long long stride_t,
                 cudaStream_t stream) {
  int sm_count = 0;
  const cudaError_t ready = prepare_device<HD, true>(&sm_count);
  if (ready != cudaSuccess) return (int)ready;
  const int cols = heads * HD;
  const long long plane = (long long)batch * t_len * cols;  // elements of one [B][T][cols] plane
  const long long n4 = 3 * plane / 4;
  const int n_tiles = (t_len + kBlockM - 1) / kBlockM;
  const long long items = (long long)batch * heads * n_tiles;
  if (n4 > 0x7fffffffLL || items > 0x7fffffffLL || 2LL * batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bf16* p = static_cast<bf16*>(planes);
  // K's hi plane, and its lo plane `batch` items further: one map of 2B items; so for V
  CUtensorMap maps[4];
  if (!encode_kv_maps<HD>(maps, p + 2 * plane, p + 4 * plane, 2 * batch, t_len, cols,
                          (long long)t_len * cols, cols))
    return (int)cudaErrorInvalidValue;
  split_qkv_kernel<<<(unsigned)((n4 + kSplitThreads - 1) / kSplitThreads), kSplitThreads, 0,
                     stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), stride_b, stride_t, batch, t_len,
                               cols, p, (int)n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long smem = smem_bytes(t_len, HD, 2);
  int per_sm = (int)(kSmemPerSm / (smem + 1024));
  per_sm = per_sm < 1 ? 1 : per_sm > 2 ? 2 : per_sm;
  const int max_ctas = per_sm * sm_count;
  const int grid = (int)(items < max_ctas ? items : max_ctas);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = probe_off(kOffPdl) ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, attention_resident_kernel<HD, true>, static_cast<const bf16*>(p),
                           out, maps[0], maps[1], maps[2], maps[3], (long long)t_len * cols,
                           (long long)cols, t_len, heads, (int)(items / grid),
                           (int)(items % grid), kLog2e / sqrtf((float)HD), batch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace resident

// ------------------------------------------------------------------------- //
// route 0: float32 and whatever route 1 does not hold; key tiles, mma.sync
// ------------------------------------------------------------------------- //

namespace tiled {
constexpr int kThreads = 128;           // 4 warps x 16 query rows
constexpr int kBlockM = 64;             // query rows per CTA
constexpr int kBlockN = 64;             // keys per tile
constexpr int kPitch = kMaxHd + 8;      // Q/K row pitch (bf16): conflict-free fragment loads
constexpr int kVtPitch = kBlockN + 8;   // V^T row pitch (bf16)
constexpr int kQPlane = kBlockM * kPitch;
constexpr int kKPlane = kBlockN * kPitch;
constexpr int kVPlane = kMaxHd * kVtPitch;

template <typename T>
struct Split;
template <>
struct Split<__nv_bfloat16> {
  static constexpr int k = 1;  // bf16 planes per value
};
template <>
struct Split<float> {
  static constexpr int k = 2;  // hi + lo
};

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)Split<T>::k * (kQPlane + kKPlane + kVPlane) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16_residual(float v) {
  return v - __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(pair);
    v[2 * i + 1] = __high2float(pair);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store_f(float* d, float v) { *d = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* d, float v) { *d = __float2bfloat16_rn(v); }

// rows [row0, row0 + 64) x columns [0, hd16) of one head into row-major
// bf16 planes (hi, then lo for float32); rows >= T and columns >= hd are 0
template <typename T>
__device__ void load_rows(const T* __restrict__ base, long long stride_t, int row0, int t_len,
                          int hd, int hd16, __nv_bfloat16* dst, int plane) {
  const int chunks = hd16 / 8;
  for (int idx = threadIdx.x; idx < kBlockM * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    float v[8];
    if (row0 + r < t_len && c < hd) {
      load8(base + (long long)(row0 + r) * stride_t + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    uint4 hi;
    hi.x = pack_bf16(v[0], v[1]);
    hi.y = pack_bf16(v[2], v[3]);
    hi.z = pack_bf16(v[4], v[5]);
    hi.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst + r * kPitch + c) = hi;
    if (Split<T>::k == 2) {
      uint4 lo;
      lo.x = pack_bf16(bf16_residual(v[0]), bf16_residual(v[1]));
      lo.y = pack_bf16(bf16_residual(v[2]), bf16_residual(v[3]));
      lo.z = pack_bf16(bf16_residual(v[4]), bf16_residual(v[5]));
      lo.w = pack_bf16(bf16_residual(v[6]), bf16_residual(v[7]));
      *reinterpret_cast<uint4*>(dst + plane + r * kPitch + c) = lo;
    }
  }
}

// V rows [row0, row0 + 64) of one head, transposed: dst[d * kVtPitch + key]
template <typename T>
__device__ void load_cols(const T* __restrict__ base, long long stride_t, int row0, int t_len,
                          int hd, __nv_bfloat16* dst, int plane) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < kBlockN * chunks; idx += kThreads) {
    const int r = idx % kBlockN, c = (idx / kBlockN) * 8;  // neighbouring threads, neighbouring keys
    float v[8];
    if (row0 + r < t_len) {
      load8(base + (long long)(row0 + r) * stride_t + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[i]);
      dst[(c + i) * kVtPitch + r] = hi;
      if (Split<T>::k == 2)
        dst[plane + (c + i) * kVtPitch + r] = __float2bfloat16_rn(v[i] - __bfloat162float(hi));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_tiled_kernel(const T* __restrict__ q,   // [B, T, *] rows stride_t apart, head h at column h*hd
                 const T* __restrict__ k,
                 const T* __restrict__ v,
                 T* __restrict__ out,       // [B, T, H*hd] contiguous
                 long long stride_b, long long stride_t,
                 int t_len, int heads, int hd, float scale_log2) {
  constexpr int kSplit = Split<T>::k;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + kSplit * kQPlane;
  __nv_bfloat16* s_vt = s_k + kSplit * kKPlane;

  const int m0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment row / column pair
  const long long head = (long long)b * stride_b + (long long)h * hd;
  const int hd16 = (hd + 15) & ~15;
  const int n_k16 = hd16 / 16;  // 16-deep steps of Q.K^T
  const int n_d8 = hd / 8;      // 8-wide column tiles of O

  load_rows(q + head, stride_t, m0, t_len, hd, hd16, s_q, kQPlane);
  __syncthreads();
  uint32_t qf[kSplit][kMaxHd / 16][4];
#pragma unroll
  for (int s = 0; s < kSplit; ++s)
#pragma unroll
    for (int kk = 0; kk < kMaxHd / 16; ++kk)
      if (kk < n_k16) {
        const __nv_bfloat16* p = s_q + s * kQPlane + (warp * 16 + gq) * kPitch + kk * 16 + 2 * cq;
        qf[s][kk][0] = ld32(p);
        qf[s][kk][1] = ld32(p + 8 * kPitch);
        qf[s][kk][2] = ld32(p + 8);
        qf[s][kk][3] = ld32(p + 8 * kPitch + 8);
      }

  float o[kMaxHd / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxHd / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  // this thread's rows gq and gq + 8: running max (log2 domain) and its part of the row sum
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < t_len; n0 += kBlockN) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_rows(k + head, stride_t, n0, t_len, hd, hd16, s_k, kKPlane);
    load_cols(v + head, stride_t, n0, t_len, hd, s_vt, kVPlane);
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxHd / 16; ++kk) {
      if (kk >= n_k16) continue;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        uint32_t b0[kSplit], b1[kSplit];
#pragma unroll
        for (int sp = 0; sp < kSplit; ++sp) {
          const __nv_bfloat16* p = s_k + sp * kKPlane + (nt * 8 + gq) * kPitch + kk * 16 + 2 * cq;
          b0[sp] = ld32(p);
          b1[sp] = ld32(p + 8);
        }
        mma_bf16(s[nt], qf[0][kk], b0[0], b1[0]);
        if (kSplit == 2) {
          mma_bf16(s[nt], qf[0][kk], b0[kSplit - 1], b1[kSplit - 1]);
          mma_bf16(s[nt], qf[kSplit - 1][kk], b0[0], b1[0]);
        }
      }
    }

    // scale into the log2 domain, mask keys >= T, online softmax
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * cq + (i & 1);
        s[nt][i] = col < t_len ? s[nt][i] * scale_log2 : -INFINITY;
        tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[nt][i]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a quad hold one row; key n0 < T keeps the max finite
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float new_max = fmaxf(row_max[r], tile_max[r]);
      corr[r] = exp2f(row_max[r] - new_max);  // 0 on the first tile
      row_max[r] = new_max;
      row_sum[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - row_max[i >> 1]);  // masked keys give 0
        row_sum[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int dt = 0; dt < kMaxHd / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P . V: the S accumulators of key tiles 2kk, 2kk+1 are the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[kSplit][4];
      pa[0][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[0][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[0][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[0][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      if (kSplit == 2) {
        pa[kSplit - 1][0] = pack_bf16(bf16_residual(s[2 * kk][0]), bf16_residual(s[2 * kk][1]));
        pa[kSplit - 1][1] = pack_bf16(bf16_residual(s[2 * kk][2]), bf16_residual(s[2 * kk][3]));
        pa[kSplit - 1][2] =
            pack_bf16(bf16_residual(s[2 * kk + 1][0]), bf16_residual(s[2 * kk + 1][1]));
        pa[kSplit - 1][3] =
            pack_bf16(bf16_residual(s[2 * kk + 1][2]), bf16_residual(s[2 * kk + 1][3]));
      }
#pragma unroll
      for (int dt = 0; dt < kMaxHd / 8; ++dt) {
        if (dt >= n_d8) continue;
        uint32_t b0[kSplit], b1[kSplit];
#pragma unroll
        for (int sp = 0; sp < kSplit; ++sp) {
          const __nv_bfloat16* p = s_vt + sp * kVPlane + (dt * 8 + gq) * kVtPitch + kk * 16 + 2 * cq;
          b0[sp] = ld32(p);
          b1[sp] = ld32(p + 8);
        }
        mma_bf16(o[dt], pa[0], b0[0], b1[0]);
        if (kSplit == 2) {
          mma_bf16(o[dt], pa[0], b0[kSplit - 1], b1[kSplit - 1]);
          mma_bf16(o[dt], pa[kSplit - 1], b0[0], b1[0]);
        }
      }
    }
  }

  // normalise and write rows < T
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    inv[r] = 1.f / row_sum[r];
  }
  const int d_model = heads * hd;
#pragma unroll
  for (int dt = 0; dt < kMaxHd / 8; ++dt) {
    if (dt >= n_d8) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp * 16 + gq + 8 * half;
      if (row < t_len) {
        T* dst = out + ((long long)b * t_len + row) * d_model + h * hd + dt * 8 + 2 * cq;
        store_f(dst, o[dt][2 * half] * inv[half]);
        store_f(dst + 1, o[dt][2 * half + 1] * inv[half]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
           int heads, int hd, long long stride_b, long long stride_t, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBlockM - 1) / kBlockM, heads, batch);
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  attention_tiled_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), stride_b, stride_t, t_len, heads, hd, scale_log2);
  return (int)cudaGetLastError();
}
}  // namespace tiled

// Which kernel a self-attention of T rows and this head width and type takes:
// 1, the resident wgmma kernel (bfloat16); 2, the same kernel on hi and lo
// planes (float32); or 0, the tiled mma.sync one. The one place in this file
// that decides it, from the shape and the type alone.
int route_of(int t_len, int head_dim, int dtype) {
  const int planes = dtype == 0 ? 2 : 1;
  const bool resident_fits =
      (head_dim == 32 || head_dim == 64 || head_dim == 128) &&
      resident::smem_bytes(t_len, head_dim, planes) <= resident::kSmemBudget &&
      (t_len + resident::kBlockN - 1) / resident::kBlockN <= resident::kMaxTiles;
  if (!resident_fits || (dtype == 0 && probe_off(kOffF32Route))) return 0;
  return dtype == 1 ? 1 : 2;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; see `route_of`.
extern "C" int condmdi_attention_route(int t_len, int head_dim, int dtype) {
  return route_of(t_len, head_dim, dtype);
}

// q, k, v: [B, T, H*hd] views sharing (stride_b, stride_t) in elements, unit
// column stride, 16-byte aligned rows; out: [B, T, H*hd] contiguous.
// dtype 0 = float32, 1 = bfloat16. `route` is the kernel the caller expects, as
// `condmdi_attention_route` names it. `scratch`: route 2's hi and lo planes,
// 3 * 2 * B * T * H*hd bf16 (16-byte aligned), null for the other routes.
// Launches on the current device. Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or a type that the kernels do not take and
// for a route that is not this shape's.
extern "C" int condmdi_attention_forward(const void* q, const void* k, const void* v, void* out,
                                         int batch, int t_len, int heads, int head_dim,
                                         long long stride_b, long long stride_t, int dtype,
                                         int route, void* stream, void* scratch) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim <= 0 || head_dim > kMaxHd ||
      head_dim % 8 != 0 || (dtype != 0 && dtype != 1) || route != route_of(t_len, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
#define CONDMDI_RESIDENT(HD) \
  resident::launch<HD>(q, k, v, out, batch, t_len, heads, stride_b, stride_t, s)
    if (head_dim == 128) return CONDMDI_RESIDENT(128);
    if (head_dim == 64) return CONDMDI_RESIDENT(64);
    return CONDMDI_RESIDENT(32);
#undef CONDMDI_RESIDENT
  }
  if (route == 2) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
#define CONDMDI_SPLIT(HD) \
  resident::launch_split<HD>(q, k, v, out, scratch, batch, t_len, heads, stride_b, stride_t, s)
    if (head_dim == 128) return CONDMDI_SPLIT(128);
    if (head_dim == 64) return CONDMDI_SPLIT(64);
    return CONDMDI_SPLIT(32);
#undef CONDMDI_SPLIT
  }
  if (batch > 65535 || heads > 65535)  // the tiled kernel's grid puts them in y and z
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return tiled::launch<float>(q, k, v, out, batch, t_len, heads, head_dim, stride_b, stride_t,
                                s);
  return tiled::launch<__nv_bfloat16>(q, k, v, out, batch, t_len, heads, head_dim, stride_b,
                                      stride_t, s);
}

#ifdef CONDMDI_PROBE_STAMPS
// where the next launches record their stamps (device memory, 32 slots a CTA), or null
extern "C" int condmdi_probe_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_probe_stamps, &p, sizeof(p));
}
#endif

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
