// Fused resblock half for Hopper (sm_90a):
//   Conv1d(k, SAME, +bias) -> GroupNorm(n_groups, eps, affine)
//   -> optional AdaGN h*(1+scale[b])+shift[b] -> Mish -> optional +res
//
// Replaces the Pallas TPU kernel condmdi_tpu/ops/resblock.py `_kernel`
// (launched by `_fused_conv_gn_mish`). The TPU tiling (VMEM budget, bt % 8,
// 128-lane cout tiles, pltpu.roll taps, one-hot segment matmuls) is not
// carried over.
//
// What bounds it on an H100: per launch 2*B*T*Cin*Cout*k FLOPs against about
// 2*(B*T*Cin + k*Cin*Cout + B*T*Cout (+res)) bytes in bf16. At B=8, T=200,
// 1024->1024 that is 16.8 GFLOP for ~17 MB, so the tensor cores set the
// bound (~17 us at 989 TFLOP/s); at T=25 it is 2.1 GFLOP for 10.5 MB of
// weights, so memory sets it (~3 us at 3.35 TB/s).
//
// Design (one CTA per (batch item, group)): GroupNorm statistics span all of
// T and the group's channels, so a CTA that owns one (b, group) can finish
// the whole function without another pass or any intermediate in device
// memory. It walks T in blocks of 128 rows; for each block it streams Cin in
// chunks through shared memory (the x rows with a k-1 row halo, and the
// group's weights for every tap) and runs the conv as k row-shifted GEMMs on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate). The f32
// accumulator of the whole T x group tile then sits in shared memory
// (T*132*4 B, 106 KB at T=200) for the statistics (mean, then the centred
// variance) and the epilogue, which writes the output once. float32 inputs
// go through the same tensor-core path as a hi+lo bf16 split (three products
// per tile: hi*hi + hi*lo + lo*hi), which keeps about 16 mantissa bits.
// Loads are scalar, so Cin = 526 and odd T need no ragged-tail case; the
// SAME padding is the zero rows of the halo. This is the simple, correct
// first version: no cp.async/TMA pipelining, no wgmma, and only B*n_groups
// CTAs, so it reaches a fraction of the bound (timings in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along channels
constexpr int kBlockM = 128;   // output rows (time steps) per pass
constexpr int kBlockN = 128;   // output channels per CTA: one group, zero-padded
constexpr int kWarpM = 32;
constexpr int kWarpN = 64;
constexpr int kRedSlots = 64;
constexpr int kTaps = 5;       // conv width of every resblock half (SAME padding 2)

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kSplit = 1;  // bf16 planes per value
  static constexpr int kBK = 32;    // input channels per shared-memory chunk
};
template <>
struct Tile<float> {
  static constexpr int kSplit = 2;  // hi + lo
  static constexpr int kBK = 16;
};

template <typename T, int K>
struct Smem {
  static constexpr int kSplit = Tile<T>::kSplit;
  static constexpr int kBK = Tile<T>::kBK;
  static constexpr int kSK = kBK + 8;  // row pitch: conflict-free fragment loads
  static constexpr int kXRows = kBlockM + K - 1;
  static constexpr int kAccLd = kBlockN + 4;
  static constexpr int kXElems = kXRows * kSK;        // per plane
  static constexpr int kWElems = K * kBlockN * kSK;   // per plane
  static size_t bytes(int t_len) {
    return (size_t)t_len * kAccLd * 4 + (size_t)kSplit * (kXElems + kWElems) * 2 +
           kRedSlots * 4;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* d, float v) { *d = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* d, float v) { *d = __float2bfloat16_rn(v); }

// v as bf16 (kSplit == 1) or as hi + lo bf16 planes `plane` elements apart
template <int kSplit>
__device__ __forceinline__ void split_store(__nv_bfloat16* dst, int plane, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  dst[0] = hi;
  if (kSplit == 2) dst[plane] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float mish(float h) {
  const float sp = fmaxf(h, 0.f) + log1pf(expf(-fabsf(h)));  // softplus, no overflow
  return h * tanhf(sp);
}

// sum over the block, the same value in every thread; fixed order
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  return s;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const T* __restrict__ x,      // [B, T, Cin]
                const T* __restrict__ w,      // [Cout, Cin, K]
                const T* __restrict__ bias,   // [Cout]
                const T* __restrict__ gamma,  // [Cout]
                const T* __restrict__ beta,   // [Cout]
                const T* __restrict__ scale,  // [B, Cout] rows ss_stride apart, or null
                const T* __restrict__ shift,
                long long ss_stride,
                const T* __restrict__ res,    // [B, T, Cout] or null
                T* __restrict__ out,          // [B, T, Cout]
                int t_len, int cin, int cout, int group, float eps) {
  using S = Smem<T, K>;
  constexpr int kSplit = S::kSplit, kBK = S::kBK, kSK = S::kSK, kXRows = S::kXRows;
  constexpr int kAccLd = S::kAccLd, kHalo = K / 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_acc = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(s_acc + (size_t)t_len * kAccLd);
  __nv_bfloat16* s_w = s_x + kSplit * S::kXElems;
  float* s_red = reinterpret_cast<float*>(s_w + kSplit * S::kWElems);

  const int n0 = blockIdx.x * group;  // first output channel of this group
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment row / column pair
  const T* xb = x + (size_t)b * t_len * cin;
  const bool n_active = wn * kWarpN < group;

  for (int m0 = 0; m0 < t_len; m0 += kBlockM) {
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    const bool m_active = m0 + wm * kWarpM < t_len;

    for (int c0 = 0; c0 < cin; c0 += kBK) {
      __syncthreads();  // the previous chunk's fragments are consumed
      // x rows t = m0 - halo + r; rows outside [0, T) are the SAME padding
#pragma unroll 4
      for (int idx = tid; idx < kXRows * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx % kBK;
        const int t = m0 - kHalo + r, ci = c0 + kk;
        float v = 0.f;
        if (t >= 0 && t < t_len && ci < cin) v = to_f(xb[(size_t)t * cin + ci]);
        split_store<kSplit>(s_x + r * kSK + kk, S::kXElems, v);
      }
      // weights w[n0 + n, ci, tap]: contiguous over (ci, tap) for each channel
#pragma unroll 4
      for (int idx = tid; idx < kBlockN * kBK * K; idx += kThreads) {
        const int n = idx / (kBK * K), e = idx % (kBK * K);
        const int kk = e / K, tap = e % K, ci = c0 + kk;
        float v = 0.f;
        if (n < group && ci < cin) v = to_f(w[((size_t)(n0 + n) * cin + ci) * K + tap]);
        split_store<kSplit>(s_w + (tap * kBlockN + n) * kSK + kk, S::kWElems, v);
      }
      __syncthreads();

      if (m_active && n_active) {
        for (int tap = 0; tap < K; ++tap) {
#pragma unroll
          for (int ks = 0; ks < kBK; ks += 16) {
            uint32_t a[kSplit][2][4];
#pragma unroll
            for (int s = 0; s < kSplit; ++s)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                // output row m0 + row reads input row m0 + row + tap - halo = s_x row + tap
                const __nv_bfloat16* pa = s_x + s * S::kXElems +
                                          (wm * kWarpM + mt * 16 + gq + tap) * kSK + ks + 2 * cq;
                a[s][mt][0] = ld32(pa);
                a[s][mt][1] = ld32(pa + 8 * kSK);
                a[s][mt][2] = ld32(pa + 8);
                a[s][mt][3] = ld32(pa + 8 * kSK + 8);
              }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              uint32_t b0[kSplit], b1[kSplit];
#pragma unroll
              for (int s = 0; s < kSplit; ++s) {
                const __nv_bfloat16* pb = s_w + s * S::kWElems +
                                          (tap * kBlockN + wn * kWarpN + nt * 8 + gq) * kSK + ks +
                                          2 * cq;
                b0[s] = ld32(pb);
                b1[s] = ld32(pb + 8);
              }
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt][nt], a[0][mt], b0[0], b1[0]);
                if (kSplit == 2) {
                  mma_bf16(acc[mt][nt], a[0][mt], b0[kSplit - 1], b1[kSplit - 1]);
                  mma_bf16(acc[mt][nt], a[kSplit - 1][mt], b0[0], b1[0]);
                }
              }
            }
          }
        }
      }
    }

    // this row block (+ conv bias) into the shared accumulator
    if (m_active && n_active) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + wm * kWarpM + mt * 16 + gq + half * 8;
            const int col = wn * kWarpN + nt * 8 + 2 * cq;
            if (row < t_len) {
              if (col < group)
                s_acc[row * kAccLd + col] = acc[mt][nt][2 * half] + to_f(bias[n0 + col]);
              if (col + 1 < group)
                s_acc[row * kAccLd + col + 1] =
                    acc[mt][nt][2 * half + 1] + to_f(bias[n0 + col + 1]);
            }
          }
    }
  }
  __syncthreads();

  // GroupNorm statistics over T x group: the mean, then the centred variance
  const int count = t_len * group;
  float s = 0.f;
  for (int idx = tid; idx < count; idx += kThreads) s += s_acc[(idx / group) * kAccLd + idx % group];
  const float mean = block_sum(s, s_red) / count;
  float q = 0.f;
  for (int idx = tid; idx < count; idx += kThreads) {
    const float d = s_acc[(idx / group) * kAccLd + idx % group] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, s_red) / count + eps);

  // epilogue: affine, AdaGN, Mish, residual; each output written once
  for (int idx = tid; idx < count; idx += kThreads) {
    const int r = idx / group, col = idx % group, c = n0 + col;
    float h = (s_acc[r * kAccLd + col] - mean) * rstd * to_f(gamma[c]) + to_f(beta[c]);
    if (scale != nullptr)
      h = h * (1.f + to_f(scale[b * ss_stride + c])) + to_f(shift[b * ss_stride + c]);
    h = mish(h);
    const size_t o = ((size_t)b * t_len + r) * cout + c;
    if (res != nullptr) h += to_f(res[o]);
    store_f(out + o, h);
  }
}

template <typename T, int K>
int launch(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
           const void* scale, const void* shift, long long ss_stride, const void* res, void* out,
           int batch, int t_len, int cin, int cout, int n_groups, float eps, cudaStream_t stream) {
  const size_t smem = Smem<T, K>::bytes(t_len);
  cudaError_t err = cudaFuncSetAttribute(
      resblock_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resblock_kernel<T, K><<<dim3(n_groups, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(gamma), static_cast<const T*>(beta), static_cast<const T*>(scale),
      static_cast<const T*>(shift), ss_stride, static_cast<const T*>(res), static_cast<T*>(out),
      t_len, cin, cout, cout / n_groups, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int condmdi_resblock_forward(const void* x, const void* w, const void* bias,
                                        const void* gamma, const void* beta, const void* scale,
                                        const void* shift, long long ss_stride, const void* res,
                                        void* out, int batch, int t_len, int cin, int cout, int k,
                                        int n_groups, float eps, int dtype, void* stream) {
  if (batch <= 0 || t_len <= 0 || cin <= 0 || n_groups <= 0 || cout % n_groups != 0 ||
      cout / n_groups > kBlockN || k != kTaps || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kTaps>(x, w, bias, gamma, beta, scale, shift, ss_stride, res, out,
                                batch, t_len, cin, cout, n_groups, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kTaps>(x, w, bias, gamma, beta, scale, shift, ss_stride, res,
                                        out, batch, t_len, cin, cout, n_groups, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
