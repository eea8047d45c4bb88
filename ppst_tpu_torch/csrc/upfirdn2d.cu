// Separable FIR filter with zero pads and a downsample, on NHWC tensors, for
// Hopper (sm_90a):
//   out[b, oy, ox, c] = sum_k sum_l f[k] f[l] xp[b, oy * down + k, ox * down + l, c]
// with xp = x zero-padded by (p0, p1) on both spatial axes, f the taps
// flipped (f[k] = taps[T - 1 - k]: the filter convolves, as upfirdn2d does),
// down in {1, 2} and an output of (H + p0 + p1 - T) / down + 1 rows (columns
// alike).
//
// Replaces the TPU kernel ppst_tpu/ops/upfirdn2d_pallas.py::upfirdn2d_pallas
// (_kernel). That kernel filters the whole padded image at full resolution,
// in x's dtype, and keeps every down-th sample; this one computes only the
// samples it keeps, sums in float32 and rounds once, at the store. For
// float32 the two agree to rounding; for bf16 this one is the more exact.
//
// Bound: bytes. Each output does T^2 multiply-adds (16 for StyleGAN's
// [1, 3, 3, 1]) on values it shares with its neighbours, far below the
// operations the card does per byte, so the least time is x read once and
// out written once at the memory rate. Design: one thread per output pixel
// and 16 bytes of channels (8 bf16 or 4 float32 when C allows, else one
// channel), channels fastest, so a warp's loads and stores are contiguous;
// the T^2 reads of neighbouring pixels hit L1/L2, not device memory. Taps
// live in the kernel's parameters. The rows of the window are summed first
// (the horizontal pass), then weighted by the vertical taps, in a fixed
// order: the result is the same from run to run.
//
// The kernel launches on the caller's stream and allocates nothing.
// ppst_upfirdn2d returns the first CUDA error of its launch (0 when it was
// accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks an SM

struct Taps {
  float v[kMaxTaps];
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
  } else {
    out[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float* out) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// VEC channels a thread (16 bytes, or 1). total = B * OH * OW * (C / VEC).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ out, Taps f, int ntaps, int h,
                     int w, int c, int oh, int ow, int p0, int down, long long total) {
  const int groups = c / VEC;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int cg = (int)(i % groups);
    long long p = i / groups;
    const int ox = (int)(p % ow);
    p /= ow;
    const int oy = (int)(p % oh);
    const long long b = p / oh;
    const int y0 = oy * down - p0, x0 = ox * down - p0;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int k = 0; k < ntaps; ++k) {
      const int y = y0 + k;
      if (y < 0 || y >= h) continue;  // a zero pad row adds nothing
      const T* row_ptr = x + ((b * h + y) * w) * (long long)c + cg * VEC;
      float row[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) row[v] = 0.f;
      for (int l = 0; l < ntaps; ++l) {
        const int xx = x0 + l;
        if (xx < 0 || xx >= w) continue;
        float val[VEC];
        load_vec<VEC>(row_ptr + (long long)xx * c, val);
#pragma unroll
        for (int v = 0; v < VEC; ++v) row[v] = fmaf(f.v[l], val[v], row[v]);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(f.v[k], row[v], acc[v]);
    }
    store_vec<VEC>(out + i * VEC, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, const Taps& f, int ntaps, int batch, int h, int w,
                   int c, int oh, int ow, int p0, int down, cudaStream_t s) {
  const long long total = (long long)batch * oh * ow * (c / VEC);
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  upfirdn2d_kernel<T, VEC><<<blocks, kThreads, 0, s>>>((const T*)x, (T*)out, f, ntaps, h, w, c,
                                                       oh, ow, p0, down, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, C) and out (B, OH, OW, C), contiguous, of one dtype (0 float32,
// 1 bf16), device pointers; taps (ntaps <= 8 floats, host memory) already
// flipped. The wrapper has checked the shapes: OH = (H + p0 + p1 - ntaps) /
// down + 1 and OW alike. 16-byte vectors need C a multiple of 16 / itemsize
// and 16-byte aligned pointers; otherwise one channel a thread.
int ppst_upfirdn2d(const void* x, void* out, int dtype, int batch, int h, int w, int c, int oh,
                   int ow, const float* taps, int ntaps, int p0, int down, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || batch < 1 || h < 1 || w < 1 || c < 1 || oh < 1 ||
      ow < 1 || p0 < 0 || (down != 1 && down != 2) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Taps f;
  for (int i = 0; i < kMaxTaps; ++i) f.v[i] = i < ntaps ? taps[i] : 0.f;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (dtype == 0) {
    if (aligned && c % 4 == 0)
      return (int)launch<float, 4>(x, out, f, ntaps, batch, h, w, c, oh, ow, p0, down, s);
    return (int)launch<float, 1>(x, out, f, ntaps, batch, h, w, c, oh, ow, p0, down, s);
  }
  if (aligned && c % 8 == 0)
    return (int)launch<bf16, 8>(x, out, f, ntaps, batch, h, w, c, oh, ow, p0, down, s);
  return (int)launch<bf16, 1>(x, out, f, ntaps, batch, h, w, c, oh, ow, p0, down, s);
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
