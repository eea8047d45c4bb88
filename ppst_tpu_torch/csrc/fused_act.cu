// Bias + leaky ReLU + gain on NHWC tensors, for Hopper (sm_90a):
//   out[..., c] = where(y >= 0, y, slope * y) * scale,  y = x[..., c] + bias[c]
// in x's dtype (float32 or bf16), bias already cast to it.
//
// Replaces the TPU kernel ppst_tpu/ops/fused_act_pallas.py::
// fused_leaky_relu_pallas (_kernel). The rounding points are those of the
// plain op (ppst_tpu_torch/ops/fused_act.py): the add, the slope product and
// the gain product each round to x's dtype, computed in float32 as PyTorch's
// elementwise kernels compute them. The intrinsics __fadd_rn and __fmul_rn
// keep the compiler from fusing any of them into an FMA, so in float32 (and
// in bf16) the kernel gives the plain op's bits.
//
// Bound: bytes. Three operations an element; the least time is x read once
// and out written once (the bias is C values) at the memory rate. Design:
// one thread per 16 bytes (8 bf16 or 4 float32 values of consecutive
// channels, when C allows; else one value), so loads and stores are 16-byte
// vectors, contiguous across a warp; a grid-stride loop over the tensor.
//
// The kernel launches on the caller's stream and allocates nothing.
// ppst_fused_leaky_relu returns the first CUDA error of its launch (0 when it
// was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 round_to<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T act(T x, T b, float slope, float scale) {
  const T y = round_to<T>(__fadd_rn(to_f(x), to_f(b)));
  const float yf = to_f(y);
  const T t = yf >= 0.f ? y : round_to<T>(__fmul_rn(yf, slope));
  return round_to<T>(__fmul_rn(to_f(t), scale));
}

// VEC consecutive elements a thread (16 bytes, or 1); n_vec = numel / VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ out,
                       long long n_vec, int c, float slope, float scale) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * kThreads) {
    const int c0 = (int)((i * VEC) % c);
    if constexpr (VEC == 1) {
      out[i] = act(x[i], bias[c0], slope, scale);
    } else {
      // 16 bytes in, 16 bytes out; c % VEC == 0, so the VEC channels are
      // c0 .. c0 + VEC - 1 of one pixel
      uint4 u = reinterpret_cast<const uint4*>(x)[i];
      T* v = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = act(v[j], bias[c0 + j], slope, scale);
      reinterpret_cast<uint4*>(out)[i] = u;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* bias, void* out, long long n, int c, float slope,
                   float scale, cudaStream_t s) {
  const long long n_vec = n / VEC;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  fused_lrelu_kernel<T, VEC><<<blocks, kThreads, 0, s>>>((const T*)x, (const T*)bias, (T*)out,
                                                         n_vec, c, slope, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out (n elements, the last axis C), bias (C,), contiguous, of one
// dtype (0 float32, 1 bf16), device pointers. 16-byte vectors need C a
// multiple of 16 / itemsize and 16-byte aligned x and out; otherwise one
// element a thread.
int ppst_fused_leaky_relu(const void* x, const void* bias, void* out, int dtype, long long n,
                          int c, float slope, float scale, void* stream) {
  if (n < 1 || c < 1 || n % c != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (dtype == 0) {
    if (aligned && c % 4 == 0)
      return (int)launch<float, 4>(x, bias, out, n, c, slope, scale, s);
    return (int)launch<float, 1>(x, bias, out, n, c, slope, scale, s);
  }
  if (aligned && c % 8 == 0) return (int)launch<bf16, 8>(x, bias, out, n, c, slope, scale, s);
  return (int)launch<bf16, 1>(x, bias, out, n, c, slope, scale, s);
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
