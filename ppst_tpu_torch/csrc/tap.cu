// Fused 1x1 feature tap for Hopper (sm_90a):
//   out = PReLU_a2(IN(bf16(PReLU_a1(IN(t))) @ W2 + b2)),  t = bf16(bf16(IN(x)) @ W1 + b1)
// on x (B, H, W, 128) bf16 -> (B, H, W, 64) bf16, with per-(sample, channel)
// instance norms whose one-pass float32 statistics (eps 1e-5) are taken from
// the bf16 values the next stage reads.
//
// Replaces the TPU kernel ppst_tpu/ops/tap_pallas.py::_fused_tap_impl (the
// forward of fused_tap_1x1): _stats_kernel, _in_conv_kernel (twice) and
// _in_prelu_kernel.
//
// Bound: memory traffic. A 512x512 image moves >= ~302 MB through this design
// (x read twice, t and u each written and read once, out written) for ~6.4
// GFLOP, far below the tensor cores' ratio of operations to bytes. So the
// design keeps every normalization, activation and bias in registers and
// shared memory, and touches device memory only for those tensors and for
// small per-block partial statistics.
//
// The Pallas kernels walk the rows of a sample in order and carry the sums
// from one grid step to the next. Here blocks run in parallel over (chunk of
// pixels, sample): each block writes its partial sums and sums of squares to
// a (B, nblk, 2, C) scratch, and a small finalize kernel reduces them in a
// fixed order to mean and rstd. No atomics, so results are the same from run
// to run. The 1x1 convolutions run on the tensor cores through mma.sync
// (m16n8k16, bf16 in, float32 accumulation); the weights stay in shared
// memory for a block's whole chunk.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch. ppst_fused_tap_fwd returns the first CUDA error
// of its launches (0 when all were accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // pixels per tensor-core tile: 4 warps x 16 rows
constexpr int kChunk = 256;         // pixels per block, one row of partial statistics
constexpr int kConvThreads = 128;
constexpr int kStatsThreads = 256;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float prelu(float y, float a) {
  return fmaxf(y, 0.f) + a * fminf(y, 0.f);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Partial sums and sums of squares of x over one chunk of one sample.
// grid (nblk, B), kStatsThreads threads; part is (B, nblk, 2, C).
template <int C>
__global__ void __launch_bounds__(kStatsThreads)
stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part, int n, int nblk) {
  constexpr int kVecPerRow = C / 8;                    // 16-byte vectors in a row
  constexpr int kRowGroups = kStatsThreads / kVecPerRow;
  __shared__ float red[2][kRowGroups][C];
  const int b = blockIdx.y, blk = blockIdx.x, t = threadIdx.x;
  const int v = t % kVecPerRow, rg = t / kVecPerRow;
  const long base = (long)blk * kChunk;
  const int rows = (int)(n - base < kChunk ? n - base : kChunk);
  const __nv_bfloat16* xb = x + ((long)b * n + base) * C + v * 8;

  float s[8] = {}, q[8] = {};
  for (int r = rg; r < rows; r += kRowGroups) {
    uint4 raw = *reinterpret_cast<const uint4*>(xb + (long)r * C);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      s[2 * j] += f.x;
      q[2 * j] += f.x * f.x;
      s[2 * j + 1] += f.y;
      q[2 * j + 1] += f.y * f.y;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[0][rg][v * 8 + j] = s[j];
    red[1][rg][v * 8 + j] = q[j];
  }
  __syncthreads();
  for (int c = t; c < C; c += kStatsThreads) {
    float ss = 0.f, qq = 0.f;
    for (int g = 0; g < kRowGroups; ++g) {
      ss += red[0][g][c];
      qq += red[1][g][c];
    }
    float* p = part + ((long)b * nblk + blk) * 2 * C;
    p[c] = ss;
    p[C + c] = qq;
  }
}

// Reduce the partial statistics of each (sample, channel), in a fixed order,
// to mean and rstd: mr is (B, 2, C). grid (ceil(C/32), B), 256 threads.
__global__ void __launch_bounds__(256)
finalize_kernel(const float* __restrict__ part, float* __restrict__ mr, int C, int nblk, int n) {
  __shared__ float red[2][8][32];
  const int b = blockIdx.y;
  const int cl = threadIdx.x % 32, g = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cl;
  float s = 0.f, q = 0.f;
  if (c < C) {
    const float* p = part + (long)b * nblk * 2 * C + c;
    for (int i = g; i < nblk; i += 8) {
      s += p[(long)i * 2 * C];
      q += p[(long)i * 2 * C + C];
    }
  }
  red[0][g][cl] = s;
  red[1][g][cl] = q;
  __syncthreads();
  if (g == 0 && c < C) {
    float ss = 0.f, qq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ss += red[0][i][cl];
      qq += red[1][i][cl];
    }
    const float mean = ss / (float)n;
    const float var = fmaxf(qq / (float)n - mean * mean, 0.f);
    mr[(long)b * 2 * C + c] = mean;
    mr[(long)b * 2 * C + C + c] = rsqrtf(var + kEps);
  }
}

// out = bf16(bf16(PReLU?((x - mean) * rstd)) @ W^T + bias) over one chunk of
// one sample, plus the chunk's partial statistics of out.
// grid (nblk, B), kConvThreads threads. x (B, n, CIN), w (COUT, CIN) bf16,
// mr (B, 2, CIN), out (B, n, COUT), part (B, nblk, 2, COUT).
template <int CIN, int COUT, bool PRELU>
__global__ void __launch_bounds__(kConvThreads)
in_conv_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mr,
               const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ alpha, __nv_bfloat16* __restrict__ out,
               float* __restrict__ part, int n, int nblk) {
  constexpr int AS = CIN + 8;       // padded row strides (elements): no bank conflicts
  constexpr int OS = COUT + 8;      // on the fragment loads and stores
  constexpr int NT = COUT / 8;      // n-tiles of the m16n8k16 product
  constexpr int kHalves = kConvThreads / COUT;
  static_assert(CIN % 16 == 0 && COUT % 8 == 0 && kConvThreads % COUT == 0, "shape");
  static_assert(OS <= AS, "the output tile reuses the input tile's storage");
  static_assert(kTile == 16 * (kConvThreads / 32), "one warp per 16 rows");

  __shared__ __align__(16) __nv_bfloat16 ws[COUT * AS];
  __shared__ __align__(16) __nv_bfloat16 as[kTile * AS];
  __shared__ float s_mean[CIN], s_rstd[CIN], s_bias[COUT];
  __shared__ float red[2][kHalves][COUT];

  const int b = blockIdx.y, blk = blockIdx.x, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;

  for (int i = t; i < COUT * CIN / 8; i += kConvThreads) {
    const int o = i / (CIN / 8), k8 = (i % (CIN / 8)) * 8;
    *reinterpret_cast<uint4*>(&ws[o * AS + k8]) =
        *reinterpret_cast<const uint4*>(&w[(long)o * CIN + k8]);
  }
  for (int i = t; i < CIN; i += kConvThreads) {
    s_mean[i] = mr[(long)b * 2 * CIN + i];
    s_rstd[i] = mr[(long)b * 2 * CIN + CIN + i];
  }
  for (int i = t; i < COUT; i += kConvThreads) s_bias[i] = bias[i];
  const float a = PRELU ? *alpha : 0.f;
  __syncthreads();

  // each thread keeps the statistics of one channel over every kHalves-th row
  const int sc = t % COUT, sh = t / COUT;
  float ssum = 0.f, ssq = 0.f;
  const int r0 = warp * 16;
  __nv_bfloat16* os = as;

  for (int tile = 0; tile < kChunk / kTile; ++tile) {
    const long base = (long)blk * kChunk + tile * kTile;
    if (base >= n) break;
    const int rows = (int)(n - base < kTile ? n - base : kTile);
    const __nv_bfloat16* xt = x + ((long)b * n + base) * CIN;

    // 1. normalize (and PReLU) in f32, round to bf16, stage the tile
    for (int i = t; i < kTile * CIN / 8; i += kConvThreads) {
      const int r = i / (CIN / 8), k8 = (i % (CIN / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < rows) {
        raw = *reinterpret_cast<const uint4*>(xt + (long)r * CIN + k8);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k8 + 2 * j;
          float2 f = __bfloat1622float2(h[j]);
          float y0 = (f.x - s_mean[k]) * s_rstd[k];
          float y1 = (f.y - s_mean[k + 1]) * s_rstd[k + 1];
          if (PRELU) {
            y0 = prelu(y0, a);
            y1 = prelu(y1, a);
          }
          h[j] = __floats2bfloat162_rn(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(&as[r * AS + k8]) = raw;
    }
    __syncthreads();

    // 2. the 1x1 convolution: warp rows [r0, r0 + 16) x all COUT columns
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < CIN / 16; ++ks) {
      const int k0 = ks * 16 + tq * 2;
      const uint32_t a0 = lds32(&as[(r0 + g) * AS + k0]);
      const uint32_t a1 = lds32(&as[(r0 + g + 8) * AS + k0]);
      const uint32_t a2 = lds32(&as[(r0 + g) * AS + k0 + 8]);
      const uint32_t a3 = lds32(&as[(r0 + g + 8) * AS + k0 + 8]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t b0 = lds32(&ws[(j * 8 + g) * AS + k0]);
        const uint32_t b1 = lds32(&ws[(j * 8 + g) * AS + k0 + 8]);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with the input tile

    // 3. bias in f32, round to bf16, stage the output tile
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(&os[(r0 + g) * OS + c]) =
          __floats2bfloat162_rn(acc[j][0] + s_bias[c], acc[j][1] + s_bias[c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&os[(r0 + g + 8) * OS + c]) =
          __floats2bfloat162_rn(acc[j][2] + s_bias[c], acc[j][3] + s_bias[c + 1]);
    }
    __syncthreads();

    // 4. statistics of the rounded values, and a coalesced store
    for (int r = sh; r < rows; r += kHalves) {
      const float v = __bfloat162float(os[r * OS + sc]);
      ssum += v;
      ssq += v * v;
    }
    __nv_bfloat16* ot = out + ((long)b * n + base) * COUT;
    for (int i = t; i < rows * (COUT / 8); i += kConvThreads) {
      const int r = i / (COUT / 8), c8 = (i % (COUT / 8)) * 8;
      *reinterpret_cast<uint4*>(ot + (long)r * COUT + c8) =
          *reinterpret_cast<const uint4*>(&os[r * OS + c8]);
    }
    __syncthreads();  // before the next tile overwrites the staging buffer
  }

  red[0][sh][sc] = ssum;
  red[1][sh][sc] = ssq;
  __syncthreads();
  if (t < COUT) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      s += red[0][h][t];
      q += red[1][h][t];
    }
    float* p = part + ((long)b * nblk + blk) * 2 * COUT;
    p[t] = s;
    p[COUT + t] = q;
  }
}

// out = bf16(PReLU_a((u - mean) * rstd)), 8 channels per thread.
template <int C>
__global__ void __launch_bounds__(256)
in_prelu_kernel(const __nv_bfloat16* __restrict__ u, const float* __restrict__ mr,
                const float* __restrict__ alpha, __nv_bfloat16* __restrict__ out, long n,
                long nvec) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nvec) return;
  const long e = i * 8;
  const int c0 = (int)(e % C);
  const long b = e / (n * C);
  const float* m = mr + b * 2 * C;
  const float a = *alpha;
  uint4 raw = *reinterpret_cast<const uint4*>(u + e);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 2 * j;
    float2 f = __bfloat1622float2(h[j]);
    h[j] = __floats2bfloat162_rn(prelu((f.x - m[c]) * m[C + c], a),
                                 prelu((f.y - m[c + 1]) * m[C + c + 1], a));
  }
  *reinterpret_cast<uint4*>(out + e) = raw;
}

}  // namespace

extern "C" {

// Forward of the fused tap. x (B, n, 128), w1 (64, 128) and w2 (64, 64) bf16;
// b1, b2 (64,) and a1, a2 (1,) float32; t, u, out (B, n, 64) bf16;
// part (B, ceil(n / 256), 2, 128) float32 scratch. mr (B * 384 floats)
// receives the three instance norms' mean and rstd, the backward's residuals:
// (B, 2, 128) of x, then (B, 2, 64) of t and of u, back to back. All
// pointers are device pointers, 16-byte aligned, of contiguous tensors.
int ppst_fused_tap_fwd(const void* x, const void* w1, const void* b1, const void* a1,
                       const void* w2, const void* b2, const void* a2, void* t, void* u,
                       void* out, void* part, void* mr, int batch, int n, int cin, int c1,
                       int c2, void* stream) {
  if (cin != 128 || c1 != 64 || c2 != 64 || batch < 1 || batch > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (n + kChunk - 1) / kChunk;
  const dim3 grid(nblk, batch);
  const auto* xb = (const __nv_bfloat16*)x;
  auto* tb = (__nv_bfloat16*)t;
  auto* ub = (__nv_bfloat16*)u;
  auto* pf = (float*)part;
  auto* mf1 = (float*)mr;
  auto* mf2 = mf1 + (long)batch * 2 * 128;
  auto* mf3 = mf2 + (long)batch * 2 * 64;
  cudaError_t err;

  stats_kernel<128><<<grid, kStatsThreads, 0, s>>>(xb, pf, n, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  finalize_kernel<<<dim3(128 / 32, batch), 256, 0, s>>>(pf, mf1, 128, nblk, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  in_conv_kernel<128, 64, false><<<grid, kConvThreads, 0, s>>>(
      xb, mf1, (const __nv_bfloat16*)w1, (const float*)b1, (const float*)a1, tb, pf, n, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  finalize_kernel<<<dim3(64 / 32, batch), 256, 0, s>>>(pf, mf2, 64, nblk, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  in_conv_kernel<64, 64, true><<<grid, kConvThreads, 0, s>>>(
      tb, mf2, (const __nv_bfloat16*)w2, (const float*)b2, (const float*)a1, ub, pf, n, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  finalize_kernel<<<dim3(64 / 32, batch), 256, 0, s>>>(pf, mf3, 64, nblk, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long nvec = (long)batch * n * 64 / 8;
  in_prelu_kernel<64><<<(unsigned)((nvec + 255) / 256), 256, 0, s>>>(
      ub, mf3, (const float*)a2, (__nv_bfloat16*)out, n, nvec);
  return (int)cudaGetLastError();
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
