// Fused multi-head self-attention for Hopper (sm_90a):
//   out[b, t, h*hd:(h+1)*hd] = softmax(q_h[t] . k_h^T / sqrt(hd), keys < T) . v_h
// for every batch item b, head h and query row t < T.
//
// Replaces the Pallas TPU kernel condmdi_tpu/ops/attention.py:34 `_attn_kernel`
// (launched by `_pallas_self_attention`). The TPU layout (q/k/v transposed to
// [B, H, Tp, hdp] and padded to 128 x 128 tiles, one (batch, head) block in
// VMEM) is not carried over: this kernel reads the heads straight out of the
// [B, T, D] column blocks of the fused QKV projection, with a row stride.
//
// What bounds it on an H100: bytes. At the served MDM shape (B=8 rows under
// CFG, T=197, D=512, H=4, hd=128) q, k, v and out in bf16 are 6.46 MB, 1.93 us
// at 3.35 TB/s, against 4*B*H*T^2*hd = 0.64 GFLOP, 0.64 us at 989 TFLOP/s.
//
// Design: one CTA per (tile of 64 query rows, head, batch item), four warps
// of 16 query rows each. The CTA stages its Q tile in shared memory once and
// keeps each warp's Q fragments in registers, then walks the keys in tiles
// of 64: K row-major and V transposed into shared memory, S = Q.K^T on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), scale and mask
// keys >= T in f32, an online softmax (running max and sum per row in f32),
// and O += P.V with P taken from the S accumulators without a round trip
// through shared memory. The scores never reach device memory, so the
// kernel reads q, k and v and writes out: the bytes of the bound, apart from
// K and V being read once per query tile (4 times at T=197). Normalisation
// happens once at the end and only rows < T are written. float32 inputs go
// through the same tensor-core path as a hi+lo bf16 split (hi*hi + hi*lo +
// lo*hi for both products), which keeps about 16 mantissa bits. Any T works
// (the last key tile is masked, padding query rows are zero and not
// written); hd may be any multiple of 8 up to 128 (columns up to the next
// multiple of 16 are zero in shared memory). This is the simple, correct
// first version: loads are plain 16-byte loads staged through registers,
// with no cp.async/TMA pipelining, no wgmma and no K/V reuse across query
// tiles (timings in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps x 16 query rows
constexpr int kBlockM = 64;             // query rows per CTA
constexpr int kBlockN = 64;             // keys per tile
constexpr int kMaxHd = 128;             // widest head the kernel takes
constexpr int kPitch = kMaxHd + 8;      // Q/K row pitch (bf16): conflict-free fragment loads
constexpr int kVtPitch = kBlockN + 8;   // V^T row pitch (bf16)
constexpr int kQPlane = kBlockM * kPitch;
constexpr int kKPlane = kBlockN * kPitch;
constexpr int kVPlane = kMaxHd * kVtPitch;
constexpr float kLog2e = 1.4426950408889634f;

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

// two floats as one bf16x2 register, `lo` in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
attention_kernel(const T* __restrict__ q,   // [B, T, *] rows stride_t apart, head h at column h*hd
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
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBlockM - 1) / kBlockM, heads, batch);
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), stride_b, stride_t, t_len, heads, hd, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, T, H*hd] views sharing (stride_b, stride_t) in elements, unit
// column stride, 16-byte aligned rows; out: [B, T, H*hd] contiguous.
// dtype 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
extern "C" int condmdi_attention_forward(const void* q, const void* k, const void* v, void* out,
                                         int batch, int t_len, int heads, int head_dim,
                                         long long stride_b, long long stride_t, int dtype,
                                         void* stream) {
  if (batch <= 0 || batch > 65535 || t_len <= 0 || heads <= 0 || heads > 65535 ||
      head_dim <= 0 || head_dim > kMaxHd || head_dim % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, batch, t_len, heads, head_dim, stride_b, stride_t, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, batch, t_len, heads, head_dim, stride_b,
                                 stride_t, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
