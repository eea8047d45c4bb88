// Device helpers shared by the fused StyledConv's forward (styled_conv.cu) and
// backward (styled_conv_bwd.cu): the chain's constants, 8-wide bf16 loads and
// stores, and the fixed-order group sum that reduces per-block partials. The
// Hopper building blocks (TMA, mbarriers, wgmma) are in hopper.cuh.

#pragma once

#include "hopper.cuh"

// An unnamed namespace: each source that includes this keeps its own copy.
namespace {

using bf16 = __nv_bfloat16;

constexpr float kSlope = 0.2f;
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// out[gy, idx] = scale * sum_i part[gy, i, idx] for i < count, in order.
// grid (ceil(len / 256), groups), 256 threads.
__global__ void __launch_bounds__(256)
group_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int len, int count,
                 float scale) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= len) return;
  const float* p = part + (long)blockIdx.y * count * len + idx;
  float s = 0.f;
  for (int i = 0; i < count; ++i) s += p[(long)i * len];
  out[(long)blockIdx.y * len + idx] = s * scale;
}

cudaError_t group_sum(const float* part, float* out, int len, int count, int groups,
                      float scale, cudaStream_t st) {
  group_sum_kernel<<<dim3((len + 255) / 256, groups), 256, 0, st>>>(part, out, len, count,
                                                                     scale);
  return cudaGetLastError();
}

}  // namespace
