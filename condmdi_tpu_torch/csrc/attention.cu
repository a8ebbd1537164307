// Fused multi-head self-attention for Hopper (sm_90a):
//   out[b, t, h*hd:(h+1)*hd] = softmax(q_h[t] . k_h^T / sqrt(hd), keys < T) . v_h
// for every batch item b, head h and query row t < T.
//
// Replaces the Pallas TPU kernel condmdi_tpu/ops/attention.py:34 `_attn_kernel`
// (launched by `_pallas_self_attention`). The TPU layout (q/k/v transposed to
// [B, H, Tp, hdp] and padded to 128 x 128 tiles, one (batch, head) block in
// VMEM) is not carried over: the kernels here read the heads out of the
// [B, T, D] column blocks of the fused QKV projection, with a row stride, or
// (route 0, where TMA cannot address them as they lie) out of a packed copy.
//
// What bounds it on an H100: bytes. At the served MDM shape (B=8 rows under
// CFG, T=197, D=512, H=4, hd=128) q, k, v and out in bf16 are 6.46 MB, 1.93 us
// at 3.35 TB/s, against 4*B*H*T^2*hd = 0.64 GFLOP, 0.64 us at 989 TFLOP/s.
//
// Three routes, and which shape takes which: `route_of` below, a function of
// the shape and the type alone, exported as `condmdi_attention_route`. The
// caller names the route it expects (ops/attention.py `attention_route`, the
// same function in Python, so that it can be asked where there is no card),
// and the entry point refuses any other:
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
//   route 0, "stream" -- `stream::attention_stream_kernel`, behind
//     `stream::pack_heads_kernel` where it needs one: every other shape, in
//     either type: any head width from 1 up, any T, any B and H, q/k/v at any
//     row stride and alignment. K and V stream through a ring of TMA stages,
//     so no length is too long, and a head wider than the registers hold is
//     cut into column blocks.
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
// bits, as route 0 keeps for float32 too.
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
// route 0, the design. The shapes it takes have no common layout. Where TMA
// can address the heads as they lie (hd 16, 32 or a multiple of 64 -- up to
// 512 in float32 --, 16-byte aligned rows) the kernel reads q, k, v in place;
// elsewhere a pack pass (one launch for q, k and v) first writes head-major
// bf16 planes [B*H][t16][hd16], zero past T and past hd, hi and lo for float32.
// Everything else is route 1's building blocks, arranged to stream:
//   * A CTA is one or two consumer warpgroups, each with its own 64-row query
//     tile, and a producer warpgroup behind them. Two consumers share the K
//     and V copies (128 rows) where T holds two tiles, shared memory both Q
//     tiles, the registers both O blocks and the items still fill half the
//     SMs. Work items (batch x head x tile pair x column block) are numbered
//     in one linear index and walked by persistent CTAs, so no grid dimension
//     limits B or H.
//   * One producer thread keeps TMA copies in flight through a ring of up to
//     12 stages with full and empty mbarriers. A stage holds one chunk: 64
//     rows of 16, 32 or 64 columns (a box under the 32-, 64- or 128-byte
//     swizzle), hi and lo side by side for float32. Float32 read in place lands
//     as it lies, and the producer's other three warps split it into hi and lo
//     in shared memory, under the same swizzle, before the consumers may take
//     it. Q is loaded once an item where it fits beside the ring; else each S
//     stage carries Q's chunk with K's (packed planes only).
//   * S = Q.K^T by wgmma m64n64k16 from shared memory, one depth chunk a
//     stage; O += P.V by wgmma m64n{16,32,64}k16 with P in registers and V as
//     the MN-major operand through the transpose bit, one column chunk of the
//     block a stage into its own accumulators. Where a head is one column
//     block, key tile j's scores are issued as one group with tile j-1's P.V
//     and tile j's softmax runs while that P.V does (route 1's order, first
//     and last tiles peeled, every wait on a fixed number of groups: ptxas
//     serialises the products otherwise).
//   * The online softmax is route 1's. Keys >= T arrive as zeros and are
//     masked to -inf after the product; rows >= T are never stored.
//   * O's columns are cut into blocks of at most 256 (128 for float32, whose
//     P takes twice the registers), each its own work item that recomputes S,
//     one score chunk at a time.
// What bounds it: bytes at the shapes on a path (hd 16 at T = 61: 0.6 us;
// hd 128 at T <= 512 and B <= 8: 2-5 us), operations past B*T of about 1e5
// in bf16. Timings are in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is taken at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// Probe builds only. attention_probe.py compiles copies of this file with
// -DCONDMDI_PROBE_OFF=<mask of ProbeOff>, which switches parts of the resident
// and streaming kernels off (the results are then wrong; the times tell what each part
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
  kOffF32Route = 128,  // float32 takes route 0, the streaming kernel, at every shape
  kOffPdl = 256,       // route 2's kernel launched in stream order, not as the pass's dependent
};
__host__ __device__ constexpr bool probe_off(int part) { return (CONDMDI_PROBE_OFF & part) != 0; }

constexpr float kLog2e = 1.4426950408889634f;
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

// Shared-memory descriptor of an operand stored as rows of ROW_BYTES (128, 64
// or 32) under the swizzle of that width, the layout a TMA box with the same
// swizzle lands in. `sbo`: bytes between groups of 8 rows. `lbo`: for the MN-major
// operand, bytes between two ROW_BYTES-wide column groups; unused (16) for the
// K-major one, whose depth steps move the start address inside the row.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64 || ROW_BYTES == 32, "a swizzle's width");
  constexpr uint64_t kLayout = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
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
struct WgmmaRS<16, TNSP> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b_desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
        "}\n"
        : CONDMDI_D8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d), "n"(TNSP));
  }
};
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
// shared memory as rows of box_cols bf16 under the swizzle of that width (128,
// 64 or 32 bytes), which is how wgmma reads them; what lies outside the tensor
// arrives as zeros. About 3 us of host time a map.
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
                box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B,
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
// route 0, "stream": every shape that routes 1 and 2 do not take; K and V
// stream through a ring of TMA stages
// ------------------------------------------------------------------------- //

namespace stream {

using resident::bf16;
using resident::fast_exp2;
using resident::fence_barrier_init;
using resident::fence_regs;
using resident::mbarrier_arrive_expect_tx;
using resident::mbarrier_init;
using resident::mbarrier_wait;
using resident::smem_u32;
using resident::split4;
using resident::tma_load_3d;
using resident::wgmma_commit;
using resident::wgmma_desc;
using resident::wgmma_fence;
using resident::wgmma_wait;
using resident::WgmmaRS;

constexpr int kRows = 64;              // query rows of a consumer's tile; keys of a key tile
constexpr int kMaxConsumers = 2;       // warpgroups, each with its own 64-row query tile
// A producer warpgroup behind the consumers: its first thread issues every copy;
// where float32 q, k, v are read in place, its other three warps split each
// landed tile into hi and lo (the converters)
constexpr int kProducerThreads = 128;
constexpr int kConverters = kProducerThreads - 32;
// Registers are handed out by warpgroups: with two consumers the producer is a
// third, and ptxas caps a thread at 168 registers, which 3 or 4 column chunks
// of O (96 or 128 floats) overflow; there one consumer, up to 255.
__host__ __device__ constexpr int max_consumers(int no) { return no >= 3 ? 1 : kMaxConsumers; }
__host__ __device__ constexpr int max_threads(int no) {
  return 128 * max_consumers(no) + kProducerThreads;
}
constexpr int kMaxStages = 12;
constexpr int kBarrierBytes = 1024;    // the barriers, ahead of the 1024-aligned stages
constexpr int kSmemBudget = kMaxSmem - 1024;
constexpr int kPackThreads = 256;

// One plain arrival (no bytes announced): a stage with nothing to copy.
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// d[64 x 64] (+)= a[64 x 16] . b[16 x 64], both from shared memory by
// descriptor, both K-major. scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                           int scale_d) {
#define CONDMDI_D8(o)                                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CONDMDI_D8(0), CONDMDI_D8(8), CONDMDI_D8(16), CONDMDI_D8(24)
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
#undef CONDMDI_D8
}

// What a launch needs beside the three tensor maps. A work item is one
// (batch item, head) pair, one pair of 64-row query tiles (one tile where a
// CTA has one consumer) and one block of output columns, numbered in one
// linear index with the column block fastest, then the tile pair.
struct Args {
  void* out;             // [B, T, H*hd] contiguous, bf16 (float32 if SPLIT)
  long long items;       // B*H * pairs * ncb
  int t_len, heads, hd, hd16;
  int n_qtiles, n_ktiles, pairs, ncb, ncs;
  int nq;                // consumer warpgroups (1 or 2)
  int q_resident;        // Q loaded once an item; else each S stage carries Q's chunk too
  int stages, chunk_bytes, stage_bytes;
  int heads_per_item;    // H where the maps address the [B, T, D] views, 1 on the packed planes
  int lo_items;          // where a lo plane lies after its hi plane in the maps' items
  int packed;            // launched behind the pack pass, as its programmatic dependent
  int convert;           // float32 tiles land as they lie and are split in shared memory
  float scale_log2;
};

// The layout of one launch, from the shape and the type alone. A chunk is 64
// rows of CW columns, one TMA box under the swizzle of its row width (32, 64
// or 128 bytes); a head's depth is ncs chunks, its output columns ncb blocks
// of NO chunks.
struct Plan {
  int cw, no, ncb, ncs, planes, nq, q_resident, stages, chunk_bytes, stage_bytes, q_bytes, smem;
  bool overlap;  // one column block: a tile's score chunks and P.V chunks are held together
};

bool make_plan(int t_len, int hd, bool split, int most_consumers, Plan* p) {
  const int hd16 = (hd + 15) & ~15;
  p->cw = hd16 <= 16 ? 16 : hd16 <= 32 ? 32 : 64;
  const int chunks = (hd16 + p->cw - 1) / p->cw;
  const int max_no = p->cw < 64 ? 1 : split ? 2 : 4;  // O in registers: at most 256 (128) columns
  p->ncb = (chunks + max_no - 1) / max_no;
  p->no = (chunks + p->ncb - 1) / p->ncb;
  p->ncs = chunks;
  p->overlap = p->ncb == 1;  // then ncs == no
  p->planes = split ? 2 : 1;
  p->chunk_bytes = kRows * 2 * p->cw;
  const int n_qtiles = (t_len + kRows - 1) / kRows;
  // Q resident before Q streamed; two consumers before one
  for (int resident = 1; resident >= 0; --resident) {
    const int most = most_consumers < max_consumers(p->no) ? most_consumers : max_consumers(p->no);
    for (int nq = n_qtiles > 1 ? most : 1; nq >= 1; --nq) {
      const int q_bytes = resident ? nq * p->ncs * p->planes * p->chunk_bytes : 0;
      const int stage = p->planes * p->chunk_bytes * (resident ? 1 : 1 + nq);
      int stages = (kSmemBudget - kBarrierBytes - q_bytes) / stage;
      stages = stages > kMaxStages ? kMaxStages : stages;
      // the consumer holds a tile's score chunks (all of them where they overlap
      // P.V, else one) and the previous tile's V chunks; one stage more to prefetch
      if (stages >= (p->overlap ? p->ncs : 1) + p->no + 1) {
        p->nq = nq;
        p->q_resident = resident;
        p->stages = stages;
        p->stage_bytes = stage;
        p->q_bytes = q_bytes;
        p->smem = kBarrierBytes + stages * stage + q_bytes;
        return true;
      }
    }
  }
  return false;  // never: one consumer with Q streamed needs 6 stages of 32 KB at most
}

// q, k, v [B, T, *] (rows stride_t apart, head h at column h*hd, any alignment)
// -> planes [3 (q, k, v)][P][B*H][t16][hd16] bf16, zero past T and past hd;
// P = 2 for float32 (hi = bf16(x), lo = bf16(x - hi)), 1 for bfloat16. Eight
// columns a thread, one of q, k, v a grid row (blockIdx.y), so that a
// thread's place is decoded in 32 bits; 16-byte loads where `vec` says the
// rows allow them. The attention kernel behind it is its programmatic
// dependent. ops/attention.py `pack_heads` is its plain version.
template <typename T>
__global__ void __launch_bounds__(kPackThreads)
pack_heads_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  long long stride_b, long long stride_t, int t_len, int heads, int hd, int t16,
                  int hd16, int bh_count, bf16* __restrict__ planes, int groups, int vec) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int kPlanes = sizeof(T) == 4 ? 2 : 1;
  const int g = blockIdx.x * kPackThreads + threadIdx.x;  // < groups < 2^31 (the C entry)
  if (g >= groups) return;
  const int which = blockIdx.y;
  const int c8s = hd16 >> 3, per_head = t16 * c8s;
  const int bh = g / per_head, within = g - bh * per_head;
  const int row = within / c8s, c0 = (within - row * c8s) * 8;
  const int b = bh / heads, h = bh - b * heads;
  const T* src = (which == 0 ? q : which == 1 ? k : v) + b * stride_b + row * stride_t +
                 (long long)h * hd + c0;
  float x[8];
  if (vec && row < t_len && c0 < hd) {  // hd % 8 == 0: the 8 columns lie inside the head
    if constexpr (sizeof(T) == 4) {
      const float4 lo4 = __ldcs(reinterpret_cast<const float4*>(src));
      const float4 hi4 = __ldcs(reinterpret_cast<const float4*>(src) + 1);
      x[0] = lo4.x, x[1] = lo4.y, x[2] = lo4.z, x[3] = lo4.w;
      x[4] = hi4.x, x[5] = hi4.y, x[6] = hi4.z, x[7] = hi4.w;
    } else {
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        x[2 * i] = __low2float(pair);
        x[2 * i + 1] = __high2float(pair);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (row < t_len && c0 + e < hd) {
        if constexpr (sizeof(T) == 4)
          x[e] = __ldcs(reinterpret_cast<const float*>(src) + e);
        else
          x[e] = __bfloat162float(src[e]);
      } else {
        x[e] = 0.f;
      }
    }
  }
  const long long plane = (long long)groups * 8;  // elements of one [B*H][t16][hd16] plane
  bf16* dst = planes + which * kPlanes * plane + (long long)g * 8;
  uint2 hi0, lo0, hi1, lo1;
  split4(make_float4(x[0], x[1], x[2], x[3]), hi0, lo0);
  split4(make_float4(x[4], x[5], x[6], x[7]), hi1, lo1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi0.x, hi0.y, hi1.x, hi1.y);
  if constexpr (kPlanes == 2)
    *reinterpret_cast<uint4*>(dst + plane) = make_uint4(lo0.x, lo0.y, lo1.x, lo1.y);
}

// The streaming kernel. CTA: `nq` consumer warpgroups (threads 0 .. 128nq-1),
// each with its own 64-row query tile, then the producer warpgroup, whose
// first thread issues every copy and whose other three warps, the converters,
// split float32 read in place. Shared memory: the barriers, then a ring of
// `stages` stages, then the consumers' Q tiles where Q is resident.
//   * The producer walks the CTA's items in the consumers' order: each item's
//     Q tiles (where resident), then for j = 0 .. n the ncs depth chunks of key
//     tile j's 64 keys of K (with Q's chunk of each consumer where Q is not
//     resident) and the block's NO column chunks of tile j-1's V. A stage is
//     filled once the consumers have freed it (empty barrier, one arrival per
//     consumer) and announced complete by the TMA (full barrier) or, for
//     float32 in place, by the converters after its tile landed (landed).
//   * A consumer computes S = Q.K^T over the depth, wgmma m64n64k16 with both
//     operands from shared memory (K-major); the online softmax in the log2
//     domain (route 1's: keys >= T masked to -inf, the row's reference maximum
//     moved only by 2^8 steps); P stays in registers as the A operand of
//     O += P.V, wgmma m64n{CW}k16 with V MN-major through the transpose bit,
//     one column chunk a stage into its own accumulators. All stages of a
//     group are waited for before its first product.
//   * OVERLAP (one column block, ncs == NO): key tile j's NO score chunks are
//     one group, issued with tile j-1's P.V, and tile j's softmax runs while
//     the tensor cores work on that P.V (route 1's order, the first and last
//     tiles peeled). Otherwise the scores come one chunk a group, each stage
//     freed once the next chunk's products are issued, then the P.V.
//   * SPLIT (float32): q, k and v come as hi and lo planes, each product is
//     three bf16 products (hi.hi, hi.lo, lo.hi), as in route 2.
//   * A V chunk past the head's columns (the last column block of a wide head)
//     is not copied; the products on it fill accumulators that are never
//     stored. Rows >= T and columns >= hd are never stored.
template <int CW, int NO, bool SPLIT, bool OVERLAP>
__global__ void __launch_bounds__(max_threads(NO), 1)
attention_stream_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, const Args a) {
  constexpr int kRowBytes = 2 * CW;
  constexpr int kSteps = CW / 16;  // depth steps of one chunk
  constexpr int kN = NO * CW;      // output columns of one block
  constexpr int kPlanes = SPLIT ? 2 : 1;
  extern __shared__ __align__(1024) unsigned char smem_stream[];
  const int tid = threadIdx.x;
  const uint32_t base = smem_u32(smem_stream);
  if ((base & 1023) != 0) __trap();  // the swizzle is a function of the address
  const uint32_t full = base, empty = base + 8 * kMaxStages, landed = base + 16 * kMaxStages;
  const uint32_t q_full = base + 24 * kMaxStages, q_empty = q_full + 8 * kMaxConsumers;
  const uint32_t q_landed = q_empty + 8 * kMaxConsumers;
  const uint32_t ring = base + kBarrierBytes;
  const uint32_t q_region = ring + a.stages * a.stage_bytes;
  const uint32_t chunk = a.chunk_bytes;
  const int consumer_threads = 128 * a.nq;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbarrier_init(full + 8 * s, 1);
      mbarrier_init(empty + 8 * s, a.nq);
      mbarrier_init(landed + 8 * s, 1);
    }
    for (int w = 0; w < kMaxConsumers; ++w) {
      mbarrier_init(q_full + 8 * w, 1);
      mbarrier_init(q_empty + 8 * w, 1);
      mbarrier_init(q_landed + 8 * w, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them
  CONDMDI_STAMP(0);
  // behind the pack pass: its planes are complete from here on
  if (a.packed) asm volatile("griddepcontrol.wait;\n" ::: "memory");

  int idx = 0;           // the ring's stage in hand
  uint32_t phase = 0;    // of the stage's barriers, flipped at each turn of the ring
  uint32_t q_phase = 0;  // of the Q barriers, flipped at each item
  auto advance = [&]() {
    if (++idx == a.stages) {
      idx = 0;
      phase ^= 1u;
    }
  };

  // The converters (float32 read in place): in the producer's order, each
  // landed tile of 64 rows x CW floats, row-major, becomes the hi plane (its
  // first half) and the lo plane (its second), rows of 2*CW bytes under the
  // swizzle TMA would have written (16-byte unit u of row r lands at u ^ f(r)).
  // Every converter reads its values before any writes; then the writes are
  // made visible to wgmma (the async proxy) and one arrival announces them.
  auto convert_tiles = [&](int ct) {
    constexpr int kUnits = kRows * CW / 8;  // 16-byte units of one plane
    constexpr int kPer = (kUnits + kConverters - 1) / kConverters;
    constexpr int kUnitsRow = CW / 8;
    auto split_in_place = [&](uint32_t at) {
      float4 x[kPer][2];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int u = ct + kConverters * i;
        if (u < kUnits) {
          const uint32_t src_at = at + (u / kUnitsRow) * (4 * CW) + (u % kUnitsRow) * 32;
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(x[i][0].x), "=f"(x[i][0].y), "=f"(x[i][0].z), "=f"(x[i][0].w)
                       : "r"(src_at));
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(x[i][1].x), "=f"(x[i][1].y), "=f"(x[i][1].z), "=f"(x[i][1].w)
                       : "r"(src_at + 16));
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConverters) : "memory");
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int u = ct + kConverters * i;
        if (u < kUnits) {
          const int row = u / kUnitsRow, unit = u % kUnitsRow;
          const int swz = kRowBytes == 128 ? (row & 7) : kRowBytes == 64 ? ((row >> 1) & 3)
                                                                         : ((row >> 2) & 1);
          const uint32_t dst = at + row * kRowBytes + ((unit ^ swz) * 16);
          uint2 hi0, lo0, hi1, lo1;
          split4(x[i][0], hi0, lo0);
          split4(x[i][1], hi1, lo1);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(hi0.x),
                       "r"(hi0.y), "r"(hi1.x), "r"(hi1.y)
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + chunk),
                       "r"(lo0.x), "r"(lo0.y), "r"(lo1.x), "r"(lo1.y)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConverters) : "memory");
    };
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
      if (a.q_resident) {  // where it is not, the launch packs instead
        for (int w = 0; w < a.nq; ++w) {
          mbarrier_wait(q_landed + 8 * w, q_phase);
          for (int c = 0; c < a.ncs; ++c)
            split_in_place(q_region + (w * a.ncs + c) * kPlanes * chunk);
          if (ct == 0) mbarrier_arrive(q_full + 8 * w);
        }
        q_phase ^= 1u;
      }
      for (int j = 0; j <= a.n_ktiles; ++j) {
        const int n = (j < a.n_ktiles ? a.ncs : 0) + (j > 0 ? NO : 0);
        for (int c = 0; c < n; ++c) {
          mbarrier_wait(landed + 8 * idx, phase);
          split_in_place(ring + idx * a.stage_bytes);
          if (ct == 0) mbarrier_arrive(full + 8 * idx);
          advance();
        }
      }
    }
  };

  if (tid >= consumer_threads + 32) {  // the converters
    if (SPLIT && a.convert) convert_tiles(tid - consumer_threads - 32);
    return;
  }
  if (tid >= consumer_threads) {  // the producer
    if (tid != consumer_threads) return;
    // float32 read in place: one box of 4-byte values a chunk, split by the converters
    const int boxes = a.convert ? 1 : kPlanes;
    const uint32_t to_full = a.convert ? landed : full, to_q_full = a.convert ? q_landed : q_full;
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
      const int cb = (int)(item % a.ncb);
      const long long rest = item / a.ncb;
      const int pair = (int)(rest % a.pairs);
      const long long bh = rest / a.pairs;
      const int map_item = (int)(bh / a.heads_per_item);
      const int head_col = (int)(bh % a.heads_per_item) * a.hd;
      // a consumer past the last query tile computes on the last one and stores nothing
      auto q_row = [&](int w) { return min(a.nq * pair + w, a.n_qtiles - 1) * kRows; };
      if (a.q_resident) {
        for (int w = 0; w < a.nq; ++w) {
          const uint32_t bar = to_q_full + 8 * w;
          mbarrier_wait(q_empty + 8 * w, q_phase ^ 1u);
          if (probe_off(kOffQ)) {
            mbarrier_arrive(bar);
            continue;
          }
          mbarrier_arrive_expect_tx(bar, a.ncs * kPlanes * chunk);
          for (int c = 0; c < a.ncs; ++c)
            for (int p = 0; p < boxes; ++p)
              tma_load_3d(q_region + ((w * a.ncs + c) * kPlanes + p) * chunk, &q_map, bar,
                          head_col + c * CW, q_row(w), map_item + p * a.lo_items);
        }
        q_phase ^= 1u;
      }
      // in the consumers' order: K of key tile j, then V of tile j - 1
      for (int j = 0; j <= a.n_ktiles; ++j) {
        for (int c = 0; c < (j < a.n_ktiles ? a.ncs : 0); ++c) {  // K's depth chunk c (and Q's)
          mbarrier_wait(empty + 8 * idx, phase ^ 1u);
          const uint32_t st = ring + idx * a.stage_bytes, bar = to_full + 8 * idx;
          mbarrier_arrive_expect_tx(bar, a.stage_bytes);
          for (int p = 0; p < boxes; ++p)
            tma_load_3d(st + p * chunk, &k_map, bar, head_col + c * CW, j * kRows,
                        map_item + p * a.lo_items);
          if (!a.q_resident)
            for (int w = 0; w < a.nq; ++w)
#pragma unroll
              for (int p = 0; p < kPlanes; ++p)
                tma_load_3d(st + ((1 + w) * kPlanes + p) * chunk, &q_map, bar, head_col + c * CW,
                            q_row(w), map_item + p * a.lo_items);
          advance();
        }
        for (int c = 0; c < (j > 0 ? NO : 0); ++c) {  // V's column chunk c of block cb
          mbarrier_wait(empty + 8 * idx, phase ^ 1u);
          const uint32_t st = ring + idx * a.stage_bytes, bar = to_full + 8 * idx;
          const int col = cb * kN + c * CW;
          if (col < a.hd16) {
            mbarrier_arrive_expect_tx(bar, kPlanes * chunk);
            for (int p = 0; p < boxes; ++p)
              tma_load_3d(st + p * chunk, &v_map, bar, head_col + col, (j - 1) * kRows,
                          map_item + p * a.lo_items);
          } else {
            mbarrier_arrive(bar);
          }
          advance();
        }
      }
    }
    return;
  }

  // a consumer: warpgroup w, its warp's 16 rows, the fragment row / column pair
  const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  float s[32];         // scores of one key tile: s[4t + 2r + e] is row gq + 8r, key 8t + 2cq + e
  float o[NO][CW / 2]; // column chunk c of the block: o[c][4t + 2r + e] is column 8t + 2cq + e
  uint32_t pa[kPlanes][kRows / 16][4];  // P of one key tile as the A fragments of P.V (hi, lo)
  float row_max[2], row_sum[2], corr[2];
  const float max_slack = resident::kMaxSlack / a.scale_log2;  // in units of the raw scores
  auto release = [&](int stage) {  // one arrival per consumer, once its products are done
    if (wt == 0) mbarrier_arrive(empty + 8 * stage);
  };

  // the online softmax of key tile j on the finished scores: route 1's
  auto softmax = [&](int j) -> bool {
    const int n0 = j * kRows;
    if (n0 + kRows > a.t_len) {  // the ragged last tile: keys >= T
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = n0 + (i >> 2) * 8 + 2 * cq + (i & 1);
        s[i] = col < a.t_len ? s[i] : -INFINITY;
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
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    }
    const bool moved = __any_sync(0xffffffffu, tile_max[0] > row_max[0] + max_slack ||
                                                   tile_max[1] > row_max[1] + max_slack);
    if (moved) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float new_max = fmaxf(row_max[r], tile_max[r]);
        corr[r] = fast_exp2((row_max[r] - new_max) * a.scale_log2);  // 0 on the first tile
        row_max[r] = new_max;
        row_sum[r] *= corr[r];
      }
    }
    const float max_scaled[2] = {row_max[0] * a.scale_log2, row_max[1] * a.scale_log2};
#pragma unroll
    for (int i = 0; i < 32; ++i)  // masked keys give 0
      s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -max_scaled[(i >> 1) & 1]));
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
    for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const float x0 = s[8 * kk + 2 * q4], x1 = s[8 * kk + 2 * q4 + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        pa[0][kk][q4] = *reinterpret_cast<const uint32_t*>(&hi);
        if constexpr (SPLIT)  // lo = bf16(p - hi)
          pa[kPlanes - 1][kk][q4] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
  };
  const uint32_t q_mine = q_region + w * a.ncs * kPlanes * chunk;  // this consumer's resident Q
  // Waits for the next n stages; returns the first. A group's stages are all
  // waited for before its first product: a spin loop between the products of
  // one group makes ptxas serialise them (C7520).
  auto wait_stages = [&](int n) -> int {
    const int first = idx;
    for (int c = 0; c < n; ++c) {
      mbarrier_wait(full + 8 * idx, phase);
      advance();
    }
    return first;
  };
  auto stage_at = [&](int first, int c) {
    const int i = first + c;
    return ring + (i < a.stages ? i : i - a.stages) * a.stage_bytes;
  };
  // S = Q . K^T of depth chunk c of one key tile, from stage st
  auto score_chunk = [&](int c, uint32_t st) {
    const uint32_t qa = a.q_resident ? q_mine + c * kPlanes * chunk
                                     : st + (1 + w) * kPlanes * chunk;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      if (!probe_off(kOffScores) || a.t_len < 0) {
        const uint64_t q_hi = wgmma_desc<kRowBytes>(qa + 32 * kk, 16, 8 * kRowBytes);
        const uint64_t k_hi = wgmma_desc<kRowBytes>(st + 32 * kk, 16, 8 * kRowBytes);
        wgmma_ss64(s, q_hi, k_hi, c > 0 || kk > 0);
        if constexpr (SPLIT) {  // + q_hi . k_lo + q_lo . k_hi
          wgmma_ss64(s, q_hi, wgmma_desc<kRowBytes>(st + chunk + 32 * kk, 16, 8 * kRowBytes), 1);
          wgmma_ss64(s, wgmma_desc<kRowBytes>(qa + chunk + 32 * kk, 16, 8 * kRowBytes), k_hi, 1);
        }
      }
  };
  // OVERLAP: all NO (== ncs) score chunks of a key tile as one group, left in
  // flight; returns the first of their stages
  auto issue_scores = [&]() -> int {
    const int first = wait_stages(NO);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NO; ++c) score_chunk(c, stage_at(first, c));
    wgmma_commit();
    return first;
  };
  // else: one score chunk a group, each stage freed once the next chunk's
  // products are issued, the last one once all are done
  auto scores_in_turn = [&]() {
    int held = -1;
    for (int c = 0; c < a.ncs; ++c) {
      mbarrier_wait(full + 8 * idx, phase);
      wgmma_fence();
      score_chunk(c, ring + idx * a.stage_bytes);
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0) release(held);
      held = idx;
      advance();
    }
    wgmma_wait<0>();
    release(held);
  };
  // O += P . V of one key tile, one column chunk of the block a stage, all left
  // in flight as one group; returns the first of its NO stages
  auto issue_pv = [&]() -> int {
    const int first = wait_stages(NO);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const uint32_t st = stage_at(first, c);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        if (!probe_off(kOffPv) || a.t_len < 0) {
          const uint32_t at = st + kk * 16 * kRowBytes;
          const uint64_t v_hi = wgmma_desc<kRowBytes>(at, kRows * kRowBytes, 8 * kRowBytes);
          WgmmaRS<CW, 1>::run(o[c], pa[0][kk], v_hi, 1);
          if constexpr (SPLIT) {  // + p_hi . v_lo + p_lo . v_hi
            WgmmaRS<CW, 1>::run(
                o[c], pa[0][kk],
                wgmma_desc<kRowBytes>(at + chunk, kRows * kRowBytes, 8 * kRowBytes), 1);
            WgmmaRS<CW, 1>::run(o[c], pa[kPlanes - 1][kk], v_hi, 1);
          }
        }
    }
    wgmma_commit();
    return first;
  };
  auto release_from = [&](int first, int n) {
    for (int c = 0; c < n; ++c) release(first + c < a.stages ? first + c : first + c - a.stages);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];
  };

  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int cb = (int)(item % a.ncb);
    const long long rest = item / a.ncb;
    const int pair = (int)(rest % a.pairs);
    const long long bh = rest / a.pairs;
    const int qt = a.nq * pair + w;
    const bool first_item = item == blockIdx.x;  // the probe's stamps: slots 1-29
    if (a.q_resident) mbarrier_wait(q_full + 8 * w, q_phase);
    if (first_item) CONDMDI_STAMP(1);  // Q in place
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) o[c][i] = 0.f;
    row_max[0] = row_max[1] = -INFINITY;
    row_sum[0] = row_sum[1] = 0.f;

    // Tiles in the producer's order: scores of j, then P.V of j - 1. With
    // OVERLAP both are in flight together and tile j's softmax runs while the
    // tensor cores work on that P.V; the first and the last tile are peeled,
    // so that every wait counts a fixed number of groups.
    auto q_done = [&](int j) {  // the item's last scores are done: Q's place is free
      if (a.q_resident && j == a.n_ktiles - 1 && wt == 0) mbarrier_arrive(q_empty + 8 * w);
    };
    if constexpr (OVERLAP) {
      int first = issue_scores();
      wgmma_wait<0>();
      fence_regs(s);
      release_from(first, NO);
      q_done(0);
      if (!probe_off(kOffSoftmax)) softmax(0);  // o is still 0: nothing to rescale
      pack_p();
      if (first_item) CONDMDI_STAMP(2);  // tile 0 softmax done
      for (int j = 1; j < a.n_ktiles; ++j) {
        if (first_item && j < 9) CONDMDI_STAMP(3 * j);  // tile j begins
        first = issue_scores();
        const int pv = issue_pv();
        wgmma_wait<1>();  // the scores are done, P.V may still run
        fence_regs(s);
        release_from(first, NO);
        q_done(j);
        if (first_item && j < 9) CONDMDI_STAMP(3 * j + 1);  // the scores done
        const bool moved = probe_off(kOffSoftmax) ? false : softmax(j);
        wgmma_wait<0>();  // P.V is done: O may be rescaled, P overwritten, its stages freed
        if (first_item && j < 9) CONDMDI_STAMP(3 * j + 2);  // softmax and P.V done
#pragma unroll
        for (int c = 0; c < NO; ++c) fence_regs(o[c]);
        release_from(pv, NO);
        if (moved) rescale_o();
        pack_p();
      }
    } else {
      scores_in_turn();
      fence_regs(s);
      q_done(0);
      if (!probe_off(kOffSoftmax)) softmax(0);
      pack_p();
      for (int j = 1; j < a.n_ktiles; ++j) {
        scores_in_turn();
        fence_regs(s);
        q_done(j);
        const int pv = issue_pv();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NO; ++c) fence_regs(o[c]);
        release_from(pv, NO);
        if (!probe_off(kOffSoftmax) && softmax(j)) rescale_o();
        pack_p();
      }
    }
    const int last_pv = issue_pv();  // the last tile's P.V
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
    release_from(last_pv, NO);
    if (a.q_resident) q_phase ^= 1u;
    if (first_item) CONDMDI_STAMP(29);  // the last P.V done

    // normalise and write rows < T, columns < hd
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      inv[r] = 1.f / row_sum[r];
    }
    const long long b = bh / a.heads, h = bh % a.heads;
    const long long d_model = (long long)a.heads * a.hd;
    const bool pairs = (a.hd & 1) == 0;  // column pairs lie 4 (8) bytes aligned
    const int t_store = probe_off(kOffStores) ? 0 : a.t_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * kRows + warp * 16 + gq + 8 * r;
      if (row >= t_store) continue;
      const long long at_row = (b * a.t_len + row) * d_model + h * a.hd;
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int t = 0; t < CW / 8; ++t) {
          const int col = cb * kN + c * CW + 8 * t + 2 * cq;
          if (col >= a.hd) continue;
          const float x0 = o[c][4 * t + 2 * r] * inv[r], x1 = o[c][4 * t + 2 * r + 1] * inv[r];
          if constexpr (SPLIT) {
            float* dst = static_cast<float*>(a.out) + at_row + col;
            if (pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
            } else {
              dst[0] = x0;
              if (col + 1 < a.hd) dst[1] = x1;
            }
          } else {
            bf16* dst = static_cast<bf16*>(a.out) + at_row + col;
            if (pairs) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
            } else {
              dst[0] = __float2bfloat16_rn(x0);
              if (col + 1 < a.hd) dst[1] = __float2bfloat16_rn(x1);
            }
          }
        }
    }
  }
  CONDMDI_STAMP(30);
}

// q, k, v as [B, T, D] views that TMA can address in place: a head width
// whose chunks never cross into the next head (16, 32 or a multiple of 64; in
// float32 at most 512, so that Q's split planes stay resident), 16-byte
// aligned pointers and row strides, unit column stride. ops/attention.py
// `stream_reads_in_place` is the same rule, asked before the planes are allocated.
bool reads_in_place(const void* q, const void* k, const void* v, int hd, long long stride_b,
                    long long stride_t, int dtype) {
  const bool width = hd == 16 || hd == 32 || (hd % 64 == 0 && (dtype == 1 || hd <= 512));
  const int size = dtype == 0 ? 4 : 2;
  const uint64_t any = (uint64_t)q | (uint64_t)k | (uint64_t)v | (uint64_t)(stride_b * size) |
                       (uint64_t)(stride_t * size);
  return width && (any & 15) == 0;
}

// float32 x [B, T, cols] (rows stride_t elements apart, 16-byte aligned) as a
// 3-D tensor (cols; T; B) in boxes of (box_cols; 64; 1), landing row-major with
// no swizzle, for the converters to split.
bool encode_map_f32(CUtensorMap* map, const void* x, int batch, int t_len, int cols,
                    long long stride_b, long long stride_t, int box_cols) {
  resident::EncodeTiled encode = resident::tensor_map_encoder();
  if (encode == nullptr) return false;
  if (batch == 1) stride_b = (long long)t_len * stride_t;  // unused, but must be a valid stride
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)stride_t * 4, (cuuint64_t)stride_b * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)kRows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(x), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the pack pass alone: q, k, v -> planes (see pack_heads_kernel)
int launch_pack(const void* q, const void* k, const void* v, void* planes, int batch, int t_len,
                int heads, int hd, long long stride_b, long long stride_t, int dtype,
                cudaStream_t stream) {
  const int t16 = (t_len + 15) & ~15, hd16 = (hd + 15) & ~15;
  const long long bh = (long long)batch * heads;
  const long long groups = bh * t16 * (hd16 / 8);  // of one of q, k, v
  if (groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // a 32 GB plane: never allocated
  const int size = dtype == 0 ? 4 : 2;
  const uint64_t any = (uint64_t)q | (uint64_t)k | (uint64_t)v | (uint64_t)(stride_b * size) |
                       (uint64_t)(stride_t * size);
  const int vec = hd % 8 == 0 && (any & 15) == 0;
  const dim3 grid((unsigned)((groups + kPackThreads - 1) / kPackThreads), 3);
  bf16* p = static_cast<bf16*>(planes);
  if (dtype == 0)
    pack_heads_kernel<float><<<grid, kPackThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        stride_b, stride_t, t_len, heads, hd, t16, hd16, (int)bh, p, (int)groups, vec);
  else
    pack_heads_kernel<bf16><<<grid, kPackThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        stride_b, stride_t, t_len, heads, hd, t16, hd16, (int)bh, p, (int)groups, vec);
  return (int)cudaGetLastError();
}

// The current device's SM count, asked once per device.
cudaError_t device_sms(int* n) {
  static std::atomic<int> sms[resident::kMaxDevices];  // 0 until asked
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= resident::kMaxDevices) return cudaErrorInvalidDevice;
  int count = sms[device].load(std::memory_order_acquire);
  if (count == 0) {
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    sms[device].store(count, std::memory_order_release);
  }
  *n = count;
  return cudaSuccess;
}

// The layout of a launch on a card of `sms` SMs: two consumers share the K and
// V copies only where the items they make still fill half the SMs; else one,
// and twice the CTAs.
bool plan_launch(long long bh, int t_len, int hd, bool split, int sms, Plan* p) {
  if (!make_plan(t_len, hd, split, kMaxConsumers, p)) return false;
  const int n_qtiles = (t_len + kRows - 1) / kRows;
  if (p->nq == 2 && bh * ((n_qtiles + 1) / 2) * p->ncb * 2 <= sms)
    return make_plan(t_len, hd, split, 1, p);
  return true;
}

template <int CW, int NO, bool SPLIT, bool OVERLAP = true>
int launch_kernel(const CUtensorMap (&maps)[3], const Args& a, const Plan& plan,
                  cudaStream_t stream) {
  static std::atomic<bool> prepared[resident::kMaxDevices];  // the attribute set, per device
  auto kernel = attention_stream_kernel<CW, NO, SPLIT, OVERLAP>;
  int device = 0, n = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = device_sms(&n);
  if (e != cudaSuccess) return (int)e;
  if (!prepared[device].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return (int)e;
    prepared[device].store(true, std::memory_order_release);
  }
  const int threads = 128 * plan.nq + kProducerThreads;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, plan.smem);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (long long)(per_sm > 0 ? per_sm : 1) * n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.items < ctas ? a.items : ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.packed && !probe_off(kOffPdl) ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Whether a float32 launch that could read q, k, v in place packs all the
// same: splitting in shared memory puts the split on each item's own path, which
// pays where the pack pass's extra bytes and launch cost more: one column block
// (else every block splits K again) and either one key tile or at least as many
// items as SMs (else a few CTAs split tile after tile while the rest idle).
bool packs_float32(long long bh, int t_len, int hd, int sms) {
  Plan plan;
  if (!plan_launch(bh, t_len, hd, true, sms, &plan)) return true;
  const int n_tiles = (t_len + kRows - 1) / kRows;
  const long long items = bh * ((n_tiles + plan.nq - 1) / plan.nq) * plan.ncb;
  return !(plan.ncb == 1 && plan.q_resident && (n_tiles == 1 || items >= sms));
}

// route 0: the pack pass into `planes` ([3][P][B*H][t16][hd16] bf16, the
// caller's scratch) unless `planes` is null and q, k, v are read in place,
// then the streaming kernel.
int launch(const void* q, const void* k, const void* v, void* out, void* planes, int batch,
           int t_len, int heads, int hd, long long stride_b, long long stride_t, int dtype,
           cudaStream_t stream) {
  const bool split = dtype == 0;
  Plan plan;
  const long long bh = (long long)batch * heads;
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  if (!plan_launch(bh, t_len, hd, split, sms, &plan) || (split ? 2 : 1) * bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int t16 = (t_len + 15) & ~15, hd16 = (hd + 15) & ~15;
  Args a = {};
  a.out = out;
  a.t_len = t_len;
  a.heads = heads;
  a.hd = hd;
  a.hd16 = hd16;
  a.n_qtiles = (t_len + kRows - 1) / kRows;
  a.n_ktiles = a.n_qtiles;
  a.pairs = (a.n_qtiles + plan.nq - 1) / plan.nq;
  a.ncb = plan.ncb;
  a.ncs = plan.ncs;
  a.items = bh * a.pairs * plan.ncb;
  a.nq = plan.nq;
  a.q_resident = plan.q_resident;
  a.stages = plan.stages;
  a.chunk_bytes = plan.chunk_bytes;
  a.stage_bytes = plan.stage_bytes;
  a.packed = planes != nullptr;
  a.scale_log2 = kLog2e / sqrtf((float)hd);
  CUtensorMap maps[3];
  if (a.packed) {
    const cudaError_t err = (cudaError_t)launch_pack(q, k, v, planes, batch, t_len, heads, hd,
                                                      stride_b, stride_t, dtype, stream);
    if (err != cudaSuccess) return (int)err;
    a.heads_per_item = 1;
    a.lo_items = split ? (int)bh : 0;
    const long long tensor = (split ? 2 : 1) * bh * t16 * hd16;  // elements of one of q, k, v
    for (int i = 0; i < 3; ++i)
      if (!resident::encode_map(&maps[i], static_cast<const bf16*>(planes) + i * tensor,
                                (split ? 2 : 1) * (int)bh, t16, hd16, (long long)t16 * hd16, hd16,
                                kRows, plan.cw))
        return (int)cudaErrorInvalidValue;
  } else {  // q, k, v in place; float32 split in shared memory by the converters
    if (!reads_in_place(q, k, v, hd, stride_b, stride_t, dtype) || (split && !plan.q_resident))
      return (int)cudaErrorInvalidValue;
    a.heads_per_item = heads;
    a.lo_items = 0;
    a.convert = split;
    const void* xs[3] = {q, k, v};
    for (int i = 0; i < 3; ++i)
      if (split ? !encode_map_f32(&maps[i], xs[i], batch, t_len, heads * hd, stride_b, stride_t,
                                  plan.cw)
                : !resident::encode_map(&maps[i], xs[i], batch, t_len, heads * hd, stride_b,
                                        stride_t, kRows, plan.cw))
        return (int)cudaErrorInvalidValue;
  }
  if (plan.cw == 16)
    return split ? launch_kernel<16, 1, true>(maps, a, plan, stream)
                 : launch_kernel<16, 1, false>(maps, a, plan, stream);
  if (plan.cw == 32)
    return split ? launch_kernel<32, 1, true>(maps, a, plan, stream)
                 : launch_kernel<32, 1, false>(maps, a, plan, stream);
  // several column blocks (a head wider than 256 columns, 128 in float32): chunks
  // at most as wide as a block's, scores one chunk at a time
  if (!plan.overlap)
    return split ? launch_kernel<64, 2, true, false>(maps, a, plan, stream)
           : plan.no == 3 ? launch_kernel<64, 3, false, false>(maps, a, plan, stream)
                          : launch_kernel<64, 4, false, false>(maps, a, plan, stream);
  if (split)
    return plan.no == 1 ? launch_kernel<64, 1, true>(maps, a, plan, stream)
                        : launch_kernel<64, 2, true>(maps, a, plan, stream);
  switch (plan.no) {
    case 1: return launch_kernel<64, 1, false>(maps, a, plan, stream);
    case 2: return launch_kernel<64, 2, false>(maps, a, plan, stream);
    case 3: return launch_kernel<64, 3, false>(maps, a, plan, stream);
    default: return launch_kernel<64, 4, false>(maps, a, plan, stream);
  }
}

}  // namespace stream

// Which kernel a self-attention of T rows and this head width and type takes:
// 1, the resident wgmma kernel (bfloat16); 2, the same kernel on hi and lo
// planes (float32); or 0, the streaming kernel, which takes every shape. The
// one place in this file that decides it, from the shape and the type alone.
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
// column stride; out: [B, T, H*hd] contiguous. dtype 0 = float32, 1 =
// bfloat16. `route` is the kernel the caller expects, as
// `condmdi_attention_route` names it. `scratch`: route 2's hi and lo planes,
// 3 * 2 * B * T * H*hd bf16 (q/k/v rows 16-byte aligned); route 0's packed
// planes, 3 * P * B*H * t16 * hd16 bf16 (P = 2 for float32, else 1; t16 and
// hd16 are T and hd rounded up to 16), or null where the streaming kernel reads
// q, k, v in place (`stream::reads_in_place`; ops/attention.py `stream_packs`
// decides); null for route 1. Launches on the current device. Returns the last launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape, a type or a
// layout that the kernels do not take and for a route that is not this
// shape's.
extern "C" int condmdi_attention_forward(const void* q, const void* k, const void* v, void* out,
                                         int batch, int t_len, int heads, int head_dim,
                                         long long stride_b, long long stride_t, int dtype,
                                         int route, void* stream, void* scratch) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim <= 0 || (dtype != 0 && dtype != 1) ||
      route != route_of(t_len, head_dim, dtype))
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
  return stream::launch(q, k, v, out, scratch, batch, t_len, heads, head_dim, stride_b, stride_t,
                        dtype, s);
}

// For q, k, v that route 0 can read in place (`stream::reads_in_place`):
// 1 where its launch should pack them all the same (float32 only, see
// `stream::packs_float32`), so that the caller passes planes; 0 otherwise.
extern "C" int condmdi_attention_stream_packs(int batch, int t_len, int heads, int head_dim,
                                              int dtype) {
  int sms = 0;
  if (dtype != 0 || stream::device_sms(&sms) != cudaSuccess) return 0;
  return stream::packs_float32((long long)batch * heads, t_len, head_dim, sms) ? 1 : 0;
}

// Route 0's pack pass alone, into `planes` as condmdi_attention_forward's
// scratch: what the card tests hold to ops/attention.py `pack_heads`.
extern "C" int condmdi_attention_pack(const void* q, const void* k, const void* v, void* planes,
                                      int batch, int t_len, int heads, int head_dim,
                                      long long stride_b, long long stride_t, int dtype,
                                      void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return stream::launch_pack(q, k, v, planes, batch, t_len, heads, head_dim, stride_b, stride_t,
                             dtype, static_cast<cudaStream_t>(stream));
}

// Route 0's layout for a shape on the current device: out[0..7] = chunk width,
// chunks a column block, column blocks, depth chunks, consumer warpgroups, Q
// resident (1) or streamed (0), ring stages, shared memory bytes. Returns 0,
// or cudaErrorInvalidValue where no layout fits (none is known).
extern "C" int condmdi_attention_stream_plan(int batch, int t_len, int heads, int head_dim,
                                             int dtype, int* out) {
  stream::Plan p;
  int sms = 0;
  const cudaError_t e = stream::device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim <= 0 ||
      !stream::plan_launch((long long)batch * heads, t_len, head_dim, dtype == 0, sms, &p))
    return (int)cudaErrorInvalidValue;
  const int values[8] = {p.cw, p.no, p.ncb, p.ncs, p.nq, p.q_resident, p.stages, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
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
