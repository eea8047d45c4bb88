// Device helpers shared by the fused StyledConv's forward (styled_conv.cu) and
// backward (styled_conv_bwd.cu): cp.async copies with zero fill, ldmatrix
// fragment loads, the bf16 mma.sync product, 8-wide bf16 loads and stores, and
// the fixed-order group sum that reduces per-block partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// An unnamed namespace: each source that includes this keeps its own copy.
namespace {

using bf16 = __nv_bfloat16;

constexpr float kSlope = 0.2f;
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kEps = 1e-5f;

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled and
// nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
