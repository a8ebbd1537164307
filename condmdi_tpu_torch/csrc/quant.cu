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
// call launches two kernels on the caller's stream:
//
//   1. `quantize_kernel`: x (bfloat16 or float32, any row pitch) to int8 codes
//      in a scratch buffer [B, T, Cin_pad] that the caller allocates: each
//      value converted to float, divided by the activation scale (__fdiv_rn:
//      a true division, as XLA's), rounded half to even (__float2int_rn, as
//      jnp.round) and clamped to +-127; channels Cin..Cin_pad are zero.
//      Every value is quantized once, where a first design that quantized
//      inside the conv did it once per 64-channel output tile (16 times at
//      Cout = 1024) and was bound by those divisions (4.9 ms for the 41
//      convs of a UNet-XL forward at B=8 on an NVIDIA H100 80GB HBM3, 700 W).
//   2. `conv_kernel`: one CTA (4 warps) computes 64 output rows of one batch
//      item by 64 output channels, walking Cin_pad in 64-channel steps through
//      a 3-stage ring of shared memory filled by 16-byte cp.async: per step
//      the (64-1)*stride + k code rows its outputs need (rows outside [0, T)
//      zero-filled by the copy itself, which is the padding) and the packed
//      int8 weights of its 64 output channels for all k taps
//      (ops/quant.py `pack_int8_weight`: [Cout_pad64, Cin_pad64/64, k, 64], so
//      a step's weights are k*64 contiguous bytes per output channel). The
//      product is the tensor cores' integer MMA,
//      mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: each warp owns a
//      32x32 tile, tap j reads the same code rows j*stride rows further on.
//      The sums are exact in int32 (|sum| <= 127^2*k*Cin < 2^31), so the
//      accumulators equal the plain version's. Epilogue: acc * (a_scale *
//      w_scale[n]) + bias[n] in float32 with __fmul_rn / __fadd_rn (no FMA
//      contraction, the scale product first, as XLA computes it), the cast
//      to x's dtype, stores masked on T' and Cout (263 at the final conv).
//
// What bounds it on an H100: 2*B*T'*Cin*Cout*k operations against
// B*T*Cin*(2 or 4) + Cout*Cin*k + B*T'*Cout*(2 or 4) bytes. At the UNet-XL
// shapes at B=8 (T' = 200..25, Cin 526..2048, Cout 1024, k 5) that is
// 2-17 G int8 operations for 6-20 MB: about 1-9 us of tensor-core time at
// 1979 TOPS, and at T' = 25 the weights' 5-10 MB set the bound (~2-3 us at
// 3.35 TB/s). This design is right and simple first: `mma.sync`, not
// `wgmma`; every CTA of every batch item and row tile reads its weights from
// L2 (no sharing across a cluster); the codes make one round trip through
// device memory (1 byte a value, against the 2 or 4 of x). Those are for a
// later PR. The dynamic per-tensor amax is taken by the caller (one
// torch.amax over the whole tensor, as XLA did) and arrives, like a static
// scale, as a pointer to a float on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;              // output rows per CTA
constexpr int kBN = 64;              // output channels per CTA
constexpr int kBK = 64;              // input channels per step (two MMA depths)
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kThreads = 128;        // 4 warps, 2 x 2 tiles of 32 x 32
constexpr int kXRow = kBK + 16;      // bytes per code row in shared memory (bank spread)
constexpr int kQThreads = 256;       // quantize kernel: 4 channels a thread

struct Params {
  const int8_t* codes;                     // [B, T, cin_pad] int8
  const int8_t* w;                         // packed [Cout_pad, cin_pad/64, k, 64]
  const float* a_scale;                    // [1] or [Cin]
  int a_per_channel;
  const float* w_scale;                    // [Cout]
  const float* bias;                       // [Cout] or null
  void* out;                               // [B, T_out, Cout]
  int t_len, cin_pad, cout, pad, t_out;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t quantize(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  q = max(-127, min(127, q));
  return static_cast<uint32_t>(q) & 0xffu;
}

// x [B, T, cin] at row pitch `row_stride` -> codes [B*T, cin_pad], 4 channels a thread
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* x, long long batch_stride, long long row_stride, int t_len, int cin,
                int cin_pad, const float* a_scale, int per_channel, int8_t* codes, long long n4) {
  const long long item = (long long)blockIdx.x * kQThreads + threadIdx.x;
  if (item >= n4) return;
  const int quads = cin_pad / 4;
  const long long row = item / quads;
  const int c = (int)(item - row * quads) * 4;
  const long long b = row / t_len, t = row - b * t_len;
  const T* src = x + b * batch_stride + t * row_stride;
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c + e < cin) {
      const float s = per_channel ? a_scale[c + e] : a_scale[0];
      word |= quantize(to_f32(src[c + e]), s) << (8 * e);
    }
  }
  *reinterpret_cast<uint32_t*>(codes + row * cin_pad + c) = word;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ constexpr int x_rows(int k, int stride) { return (kBM - 1) * stride + k; }
__host__ __device__ constexpr int w_row_bytes(int k) { return k * kBK + 16; }
__host__ __device__ constexpr int x_bytes(int k, int stride) {
  return (x_rows(k, stride) * kXRow + 15) / 16 * 16;
}
__host__ __device__ constexpr int stage_bytes(int k, int stride) {
  return x_bytes(k, stride) + kBN * w_row_bytes(k);
}

// Issue one step's copies into stage buffer `buf`: the code rows and the weights.
template <int K, int S>
__device__ __forceinline__ void issue_step(const Params& p, unsigned char* buf, const int8_t* cb,
                                           int tin0, int n0, int steps, int step) {
  constexpr int kRows = x_rows(K, S);
  constexpr int kXChunks = kRows * (kBK / 16);
  constexpr int kWChunks = kBN * K * (kBK / 16);
  unsigned char* xs = buf;
  unsigned char* ws = buf + x_bytes(K, S);
  const int c0 = step * kBK;
  for (int i = threadIdx.x; i < kXChunks; i += kThreads) {
    const int r = i / (kBK / 16), ch = i % (kBK / 16);
    const int tin = tin0 + r;
    const bool valid = tin >= 0 && tin < p.t_len;
    const int8_t* src = cb + (long long)(valid ? tin : 0) * p.cin_pad + c0 + ch * 16;
    cp_async16(xs + r * kXRow + ch * 16, src, valid);
  }
#pragma unroll
  for (int i = threadIdx.x; i < kWChunks; i += kThreads) {
    const int n = i / (K * kBK / 16), pc = i % (K * kBK / 16);
    cp_async16(ws + n * w_row_bytes(K) + pc * 16,
               p.w + ((long long)(n0 + n) * steps + step) * (K * kBK) + pc * 16, true);
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads) conv_kernel(const Params p) {
  constexpr int kWRow = w_row_bytes(K);
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tq = lane & 3;
  const int8_t* cb = p.codes + (long long)b * p.t_len * p.cin_pad;
  const int tin0 = t0 * S - p.pad;
  const int steps = p.cin_pad / kBK;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue_step<K, S>(p, smem + s * stage_bytes(K, S), cb, tin0, n0, steps, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's copies are in
    __syncthreads();               // ... for every thread, and the oldest buffer is free
    const int next = step + kStages - 1;
    if (next < steps)
      issue_step<K, S>(p, smem + (next % kStages) * stage_bytes(K, S), cb, tin0, n0, steps, next);
    cp_async_commit();
    const unsigned char* xs = smem + (step % kStages) * stage_bytes(K, S);
    const unsigned char* ws = xs + x_bytes(K, S);
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + g;
          const unsigned char* lo = xs + (r * S + j) * kXRow + kk * 32 + tq * 4;
          const unsigned char* hi = xs + ((r + 8) * S + j) * kXRow + kk * 32 + tq * 4;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(lo);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(hi);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(hi + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const unsigned char* col = ws + (wn + ni * 8 + g) * kWRow + j * kBK + kk * 32 + tq * 4;
          bf[ni][0] = *reinterpret_cast<const uint32_t*>(col);
          bf[ni][1] = *reinterpret_cast<const uint32_t*>(col + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], bf[ni]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: C fragment rows g / g+8, columns 2*tq, 2*tq+1 of each 16x8 tile
  const bool per_channel = p.a_per_channel != 0;
  const float s_tensor = per_channel ? 0.f : p.a_scale[0];
  T* out = static_cast<T*>(p.out) + (long long)b * p.t_out * p.cout;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + ni * 8 + tq * 2 + e;
      if (n >= p.cout) continue;
      const float scale = per_channel ? p.w_scale[n] : __fmul_rn(s_tensor, p.w_scale[n]);
      const float bias = p.bias != nullptr ? p.bias[n] : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + wm + mi * 16 + g + 8 * h;
          if (t >= p.t_out) continue;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), scale);
          if (p.bias != nullptr) v = __fadd_rn(v, bias);
          store(out + (long long)t * p.cout + n, v);
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

template <typename T, int K, int S>
cudaError_t launch_conv(const Params& p, int batch, cudaStream_t stream) {
  // the ring exceeds the default 48 KB of dynamic shared memory: allow it once per device
  static bool allowed[kMaxDevices] = {};
  constexpr int smem = kStages * stage_bytes(K, S);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(conv_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid((p.t_out + kBM - 1) / kBM, (p.cout + kBN - 1) / kBN, batch);
  conv_kernel<T, K, S><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* x, long long batch_stride, long long row_stride, const Params& p,
                int cin, int k, int stride, int batch, cudaStream_t s) {
  const long long n4 = (long long)batch * p.t_len * (p.cin_pad / 4);
  const unsigned blocks = (unsigned)((n4 + kQThreads - 1) / kQThreads);
  quantize_kernel<T><<<blocks, kQThreads, 0, s>>>(x, batch_stride, row_stride, p.t_len, cin,
                                                   p.cin_pad, p.a_scale, p.a_per_channel,
                                                   const_cast<int8_t*>(p.codes), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (k * 10 + stride) {
    case 11: return launch_conv<T, 1, 1>(p, batch, s);
    case 12: return launch_conv<T, 1, 2>(p, batch, s);
    case 31: return launch_conv<T, 3, 1>(p, batch, s);
    case 32: return launch_conv<T, 3, 2>(p, batch, s);
    case 51: return launch_conv<T, 5, 1>(p, batch, s);
    case 52: return launch_conv<T, 5, 2>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int condmdi_int8_conv1d(const void* x, int dtype, long long x_batch_stride,
                                   long long x_row_stride, const void* a_scale, int a_per_channel,
                                   const void* w_packed, const void* w_scale, const void* bias,
                                   void* codes, void* out, int batch, int t_len, int cin,
                                   int cin_pad, int cout, int k, int stride, int pad, int t_out,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || t_len <= 0 || cin <= 0 || cin_pad < cin ||
      cin_pad % kBK != 0 || cout <= 0 || (stride != 1 && stride != 2) || pad < 0 || pad >= k ||
      t_out <= 0 || t_out != (t_len + 2 * pad - k) / stride + 1 ||
      (long long)batch * t_len * (cin_pad / 4) / kQThreads >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.codes = static_cast<const int8_t*>(codes);
  p.w = static_cast<const int8_t*>(w_packed);
  p.a_scale = static_cast<const float*>(a_scale);
  p.a_per_channel = a_per_channel;
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.t_len = t_len;
  p.cin_pad = cin_pad;
  p.cout = cout;
  p.pad = pad;
  p.t_out = t_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run(static_cast<const float*>(x), x_batch_stride, x_row_stride, p, cin, k,
                    stride, batch, s);
  if (dtype == 1)
    return (int)run(static_cast<const __nv_bfloat16*>(x), x_batch_stride, x_row_stride, p, cin,
                    k, stride, batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* condmdi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
