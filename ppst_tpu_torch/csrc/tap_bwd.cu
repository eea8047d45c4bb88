// Backward of the fused 1x1 feature tap (K2) for Hopper (sm_90a).
//
// Forward chain (csrc/tap.cu), per sample over its N = H*W pixels:
//   n1 = (x - m1) r1;  t = bf16(bf16(n1) @ W1^T + b1)
//   n2 = (t - m2) r2;  p2 = PReLU_a1(n2);  u = bf16(bf16(p2) @ W2^T + b2)
//   n3 = (u - m3) r3;  out = PReLU_a2(n3)
// Instance-norm backward, per (sample, channel):
//   d_in = r (d_n - mean(d_n) - n mean(d_n n))
//
// Replaces the TPU kernel ppst_tpu/ops/tap_pallas.py::_fused_tap_bwd:
// _bwd_out_stats_kernel, _bwd_stage2_kernel, _bwd_stage1_kernel and
// _bwd_dx_kernel, with the same stage-by-stage identities:
//   pass A  dn3 = g * PReLU'(n3); sums of dn3 and dn3 n3; da2 = sum g min(n3, 0)
//   pass B  du = IN3-backward(dn3); db2 = sum du; dW2 = du^T p2; dp2 = du W2;
//           da1 = sum dp2 min(n2, 0); dn2 = dp2 PReLU'(n2) (kept in float32)
//           and the sums of dn2 and dn2 n2
//   pass C  dt = IN2-backward(dn2); db1 = sum dt; dW1 = dt^T n1
//   (dx)    dn1 = dt W1, its sums, then dx = IN1-backward(dn1)
// Gradients come back in float32.
//
// Bound: memory traffic. The function must read x (256 B a pixel), t, u and
// g (128 B each): 640 B a pixel, 0.100 ms at (2, 512, 512, 128) at 3.35 TB/s,
// against 0.026 ms for its 49,152 operations a pixel on the tensor cores.
// This first design makes three passes (A reads u and g; B reads t, u, g and
// writes dn2 in float32; C reads t, dn2 and x), 1536 B a pixel without dx.
//
// The Pallas kernels walk a sample's rows in order and carry the sums and the
// dW/db/da accumulators from one grid step to the next. Here blocks run in
// parallel over (chunk of 2048 pixels, sample). Each block writes its partial
// per-(sample, channel) sums and its partial dW, db and da to scratch, and
// group_sum_kernel reduces them in a fixed order: no atomics, so the results
// are the same bits from run to run. A 2048-pixel chunk keeps the dW partials
// at 48 KB a block (25 MB at (4, 512, 512)).
//
// The four products run on the tensor cores through mma.sync (m16n8k16, bf16
// operands, float32 sums). The activation-side operands p2 and n1 are rounded
// to bf16 once, as the TPU's default-precision dots round them. The
// gradient-side operands du and dt go in as two bf16 terms, hi = bf16(v) and
// lo = bf16(v - hi), two products each: du sums to zero per channel, so dW2
// is small beside its terms, and rounding du once left dW2 several percent
// of its max off at 512px. Every normalization, activation and sum stays in
// float32.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_fused_tap_bwd_scratch_floats says how
// much). ppst_fused_tap_bwd returns the first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // pixels per tensor-core tile: 4 warps x 16 rows
constexpr int kChunk = 2048;   // pixels per block
constexpr int kThreads = 128;
constexpr int kCin = 128, kC = 64;
constexpr int S = kTile + 8;   // padded bf16 row stride of the 64-wide tiles
constexpr int SX = kCin + 8;   // padded bf16 row stride of the 128-wide tiles

__device__ __forceinline__ float prelu(float y, float a) {
  return fmaxf(y, 0.f) + a * fminf(y, 0.f);
}

__device__ __forceinline__ float prelu_grad(float y, float a) { return y > 0.f ? 1.f : a; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
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

// acc[NT][4] += A (16 rows from row r0 of a, stride sa) x B^T (NT*8 rows of b,
// stride sb), over K = 16 * KS: rows of both operands are contiguous along K.
template <int NT, int KS>
__device__ __forceinline__ void warp_mma(float (*acc)[4], const __nv_bfloat16* a, int sa,
                                         int r0, const __nv_bfloat16* b, int sb, int g,
                                         int tq) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = ks * 16 + tq * 2;
    const uint32_t a0 = lds32(&a[(r0 + g) * sa + k0]);
    const uint32_t a1 = lds32(&a[(r0 + g + 8) * sa + k0]);
    const uint32_t a2 = lds32(&a[(r0 + g) * sa + k0 + 8]);
    const uint32_t a3 = lds32(&a[(r0 + g + 8) * sa + k0 + 8]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t b0 = lds32(&b[(j * 8 + g) * sb + k0]);
      const uint32_t b1 = lds32(&b[(j * 8 + g) * sb + k0 + 8]);
      mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
    }
  }
}

// Per-thread partial sums over the 8 channels [c8, c8 + 8) of each thread's
// rows, reduced over the 16 row groups of the block (thread t holds channels
// (t % 8) * 8 .. + 8 of rows t / 8, t / 8 + 16, ...) in a fixed order and
// written to out[0..64). red holds 16 x 64 floats.
__device__ void reduce_rowgroups(const float* v, float* red, float* out) {
  const int t = threadIdx.x, c8 = (t % 8) * 8, rg = t / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[rg * kC + c8 + j] = v[j];
  __syncthreads();
  if (t < kC) {
    float s = 0.f;
    for (int i = 0; i < 16; ++i) s += red[i * kC + t];
    out[t] = s;
  }
  __syncthreads();
}

// Sum of one float per thread of the block, in thread order, into *out.
__device__ void reduce_block_scalar(float v, float* red, float* out) {
  red[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += red[i];
    *out = s;
  }
  __syncthreads();
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

// Pass A. grid (nblk, B). mr3 (B, 2, 64) mean/rstd of u; pstats (B, nblk,
// 2, 64) partial sums of dn3 and dn3 n3; pda (B * nblk) partial da2.
__global__ void __launch_bounds__(kThreads)
out_stats_kernel(const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ mr3, const float* __restrict__ alpha2,
                 float* __restrict__ pstats, float* __restrict__ pda, int n, int nblk) {
  __shared__ float s_m[kC], s_r[kC], red[16 * kC];
  const int b = blockIdx.y, blk = blockIdx.x, t = threadIdx.x;
  const int c8 = (t % 8) * 8, rg = t / 8;
  if (t < kC) {
    s_m[t] = mr3[(long)b * 2 * kC + t];
    s_r[t] = mr3[(long)b * 2 * kC + kC + t];
  }
  __syncthreads();
  const float a2 = *alpha2;
  const long base = (long)blk * kChunk;
  const int rows = (int)(n - base < kChunk ? n - base : kChunk);
  const long off = ((long)b * n + base) * kC + c8;
  float s[8] = {}, q[8] = {}, da = 0.f;
  for (int r = rg; r < rows; r += 16) {
    float uf[8], gf[8];
    load8(u + off + (long)r * kC, uf);
    load8(g + off + (long)r * kC, gf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float n3 = (uf[j] - s_m[c8 + j]) * s_r[c8 + j];
      const float d = gf[j] * prelu_grad(n3, a2);
      s[j] += d;
      q[j] += d * n3;
      da += gf[j] * fminf(n3, 0.f);
    }
  }
  float* p = pstats + ((long)b * nblk + blk) * 2 * kC;
  reduce_rowgroups(s, red, p);
  reduce_rowgroups(q, red, p + kC);
  reduce_block_scalar(da, red, pda + (long)b * nblk + blk);
}

// Pass B. grid (nblk, B), dynamic shared memory kStage2Smem. mr2/mr3 the
// forward's mean/rstd of t and u; s3 (B, 2, 64) the means of dn3 and dn3 n3;
// w2 (64, 64) bf16 (out, in). Writes dn2 (B, n, 64) float32 and the block's
// partials: pstats (B, nblk, 2, 64) of dn2 and dn2 n2, pdw (B * nblk, 64, 64)
// of dW2 (out, in), pdb (B * nblk, 64) of db2, pda (B * nblk) of da1.
constexpr int kStage2Smem = 7 * kTile * S * 2 + kTile * (kC + 4) * 4;

__global__ void __launch_bounds__(kThreads)
stage2_kernel(const __nv_bfloat16* __restrict__ t_, const __nv_bfloat16* __restrict__ u,
              const __nv_bfloat16* __restrict__ g, const float* __restrict__ mr2,
              const float* __restrict__ mr3, const float* __restrict__ s3,
              const __nv_bfloat16* __restrict__ w2, const float* __restrict__ alpha1,
              const float* __restrict__ alpha2, float* __restrict__ dn2,
              float* __restrict__ pstats, float* __restrict__ pdw, float* __restrict__ pdb,
              float* __restrict__ pda, int n, int nblk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2T = reinterpret_cast<__nv_bfloat16*>(smem);  // [i][o] = W2[o][i]
  __nv_bfloat16* duR = w2T + kC * S;                              // [p][o], hi
  __nv_bfloat16* duRl = duR + kTile * S;                          // [p][o], lo
  __nv_bfloat16* duT = duRl + kTile * S;                          // [o][p], hi
  __nv_bfloat16* duTl = duT + kC * S;                             // [o][p], lo
  __nv_bfloat16* p2T = duTl + kC * S;                             // [i][p]
  __nv_bfloat16* tR = p2T + kC * S;                               // [p][i], raw t
  float* dn2s = reinterpret_cast<float*>(tR + kTile * S);         // [p][i], stride kC + 4
  constexpr int DS = kC + 4;
  __shared__ float s_m2[kC], s_r2[kC], s_m3[kC], s_r3[kC], s_u1[kC], s_u2[kC];
  __shared__ float red[16 * kC];

  const int b = blockIdx.y, blk = blockIdx.x, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = warp * 16;
  const int c8 = (t % 8) * 8;
  for (int i = t; i < kC * kC; i += kThreads) {
    const int o = i / kC, ii = i % kC;
    w2T[ii * S + o] = w2[i];
  }
  if (t < kC) {
    s_m2[t] = mr2[(long)b * 2 * kC + t];
    s_r2[t] = mr2[(long)b * 2 * kC + kC + t];
    s_m3[t] = mr3[(long)b * 2 * kC + t];
    s_r3[t] = mr3[(long)b * 2 * kC + kC + t];
    s_u1[t] = s3[(long)b * 2 * kC + t];
    s_u2[t] = s3[(long)b * 2 * kC + kC + t];
  }
  __syncthreads();
  const float a1 = *alpha1, a2 = *alpha2;

  float acc_w[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc_w[j][0] = acc_w[j][1] = acc_w[j][2] = acc_w[j][3] = 0.f;
  float db[8] = {}, da = 0.f;
  const int sc = t % kC, sh = t / kC;  // statistics: one channel, every other row
  float ssum = 0.f, ssq = 0.f;

  for (int tile = 0; tile < kChunk / kTile; ++tile) {
    const long base = (long)blk * kChunk + tile * kTile;
    if (base >= n) break;
    const int rows = (int)(n - base < kTile ? n - base : kTile);
    const long off = ((long)b * n + base) * kC;

    // 1. du and p2 in float32, staged as bf16 in both layouts the products
    // need, du as hi and lo terms
    for (int i = t; i < kTile * 8; i += kThreads) {
      const int r = i / 8;
      float du[8] = {}, lo[8], p2[8] = {}, tf[8] = {};
      if (r < rows) {
        float uf[8], gf[8];
        load8(u + off + (long)r * kC + c8, uf);
        load8(g + off + (long)r * kC + c8, gf);
        load8(t_ + off + (long)r * kC + c8, tf);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c8 + j;
          const float n3 = (uf[j] - s_m3[c]) * s_r3[c];
          const float dn3 = gf[j] * prelu_grad(n3, a2);
          du[j] = s_r3[c] * (dn3 - s_u1[c] - n3 * s_u2[c]);
          db[j] += du[j];
          p2[j] = prelu((tf[j] - s_m2[c]) * s_r2[c], a1);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) lo[j] = du[j] - bf16_round(du[j]);
      store8(&duR[r * S + c8], du);
      store8(&duRl[r * S + c8], lo);
      store8(&tR[r * S + c8], tf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        duT[(c8 + j) * S + r] = __float2bfloat16_rn(du[j]);
        duTl[(c8 + j) * S + r] = __float2bfloat16_rn(lo[j]);
        p2T[(c8 + j) * S + r] = __float2bfloat16_rn(p2[j]);
      }
    }
    __syncthreads();

    // 2. dW2[o][i] += sum_p du[p][o] p2[p][i]: warp rows o in [r0, r0 + 16)
    warp_mma<8, 4>(acc_w, duT, S, r0, p2T, S, gq, tq);
    warp_mma<8, 4>(acc_w, duTl, S, r0, p2T, S, gq, tq);

    // 3. dp2[p][i] = sum_o du[p][o] W2[o][i]: warp rows p in [r0, r0 + 16)
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    warp_mma<8, 4>(acc, duR, S, r0, w2T, S, gq, tq);
    warp_mma<8, 4>(acc, duRl, S, r0, w2T, S, gq, tq);

    // 4. through the a1 PReLU: da1 and dn2 (padded rows have du = 0, so 0)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = r0 + gq + (e >= 2 ? 8 : 0), i = j * 8 + tq * 2 + (e & 1);
        const float n2 = (__bfloat162float(tR[p * S + i]) - s_m2[i]) * s_r2[i];
        da += acc[j][e] * fminf(n2, 0.f);
        dn2s[p * DS + i] = acc[j][e] * prelu_grad(n2, a1);
      }
    }
    __syncthreads();

    // 5. statistics of dn2, and a coalesced float32 store
    for (int r = sh; r < rows; r += 2) {
      const float v = dn2s[r * DS + sc];
      const float n2 = (__bfloat162float(tR[r * S + sc]) - s_m2[sc]) * s_r2[sc];
      ssum += v;
      ssq += v * n2;
    }
    for (int i = t; i < rows * (kC / 4); i += kThreads) {
      const int r = i / (kC / 4), c4 = (i % (kC / 4)) * 4;
      *reinterpret_cast<float4*>(dn2 + off + (long)r * kC + c4) =
          *reinterpret_cast<const float4*>(&dn2s[r * DS + c4]);
    }
    __syncthreads();  // before the next tile overwrites the staging buffers
  }

  const long id = (long)b * nblk + blk;
  float* w = pdw + id * kC * kC;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = j * 8 + tq * 2;
    w[(r0 + gq) * kC + i] = acc_w[j][0];
    w[(r0 + gq) * kC + i + 1] = acc_w[j][1];
    w[(r0 + gq + 8) * kC + i] = acc_w[j][2];
    w[(r0 + gq + 8) * kC + i + 1] = acc_w[j][3];
  }
  reduce_rowgroups(db, red, pdb + id * kC);
  reduce_block_scalar(da, red, pda + id);
  red[sh * 2 * kC + sc] = ssum;
  red[sh * 2 * kC + kC + sc] = ssq;
  __syncthreads();
  if (t < 2 * kC) pstats[id * 2 * kC + t] = red[t] + red[2 * kC + t];
}

// Pass C, three modes. grid (nblk, B), dynamic shared memory stage1_smem(MODE).
//   MODE 0: dt = IN2-backward(dn2); partial db1 (B * nblk, 64) into pdb and
//           dW1 (B * nblk, 64, 128) (out, in) into pdw.
//   MODE 1: dn1 = dt W1; partial sums of dn1 and dn1 n1 (B, nblk, 2, 128)
//           into pstats.
//   MODE 2: dx = IN1-backward(dn1) with s1 (B, 2, 128) the means of dn1 and
//           dn1 n1, as bf16 into dx.
// mr1 (B, 2, 128) and mr2 (B, 2, 64) are the forward's mean/rstd of x and t;
// s2 (B, 2, 64) the means of dn2 and dn2 n2; w1 (64, 128) bf16 (out, in).
__host__ __device__ constexpr int stage1_smem(int mode) {
  return mode == 0 ? (2 * kC * S + kCin * S) * 2
                   : (2 * kTile * S + kCin * S + kTile * SX) * 2 + kTile * (kCin + 4) * 4;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
stage1_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ t_,
              const float* __restrict__ dn2, const float* __restrict__ mr1,
              const float* __restrict__ mr2, const float* __restrict__ s2,
              const float* __restrict__ s1, const __nv_bfloat16* __restrict__ w1,
              float* __restrict__ pdw, float* __restrict__ pdb, float* __restrict__ pstats,
              __nv_bfloat16* __restrict__ dx, int n, int nblk) {
  extern __shared__ __align__(16) unsigned char smem[];
  // MODE 0: dtT [c][p] (hi, lo), n1T [j][p]; MODE 1/2: dtR [p][c] (hi, lo),
  // w1T [j][c], xR [p][j], dn1s [p][j]
  __nv_bfloat16* dtT = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dtTl = dtT + kC * S;
  __nv_bfloat16* n1T = dtTl + kC * S;
  __nv_bfloat16* dtR = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dtRl = dtR + kTile * S;
  __nv_bfloat16* w1T = dtRl + kTile * S;
  __nv_bfloat16* xR = w1T + kCin * S;
  float* dn1s = reinterpret_cast<float*>(xR + kTile * SX);
  constexpr int DS = kCin + 4;
  __shared__ float s_m1[kCin], s_r1[kCin], s_v1[kCin], s_v2[kCin];
  __shared__ float s_m2[kC], s_r2[kC], s_u1[kC], s_u2[kC];
  __shared__ float red[16 * kC];

  const int b = blockIdx.y, blk = blockIdx.x, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = warp * 16;
  const int c8 = (t % 8) * 8;
  if (MODE != 0) {
    for (int i = t; i < kC * kCin; i += kThreads) {
      const int c = i / kCin, j = i % kCin;
      w1T[j * S + c] = w1[i];
    }
  }
  if (t < kC) {
    s_m2[t] = mr2[(long)b * 2 * kC + t];
    s_r2[t] = mr2[(long)b * 2 * kC + kC + t];
    s_u1[t] = s2[(long)b * 2 * kC + t];
    s_u2[t] = s2[(long)b * 2 * kC + kC + t];
  }
  s_m1[t] = mr1[(long)b * 2 * kCin + t];
  s_r1[t] = mr1[(long)b * 2 * kCin + kCin + t];
  if (MODE == 2) {
    s_v1[t] = s1[(long)b * 2 * kCin + t];
    s_v2[t] = s1[(long)b * 2 * kCin + kCin + t];
  }
  __syncthreads();

  float acc_w[16][4];
  if (MODE == 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc_w[j][0] = acc_w[j][1] = acc_w[j][2] = acc_w[j][3] = 0.f;
  }
  float db[8] = {};
  float ssum = 0.f, ssq = 0.f;  // MODE 1: channel t over every row

  for (int tile = 0; tile < kChunk / kTile; ++tile) {
    const long base = (long)blk * kChunk + tile * kTile;
    if (base >= n) break;
    const int rows = (int)(n - base < kTile ? n - base : kTile);
    const long off = ((long)b * n + base) * kC;
    const long offx = ((long)b * n + base) * kCin;

    // 1. dt in float32 from t and dn2; n1 (MODE 0) or raw x (MODE 1/2)
    for (int i = t; i < kTile * 8; i += kThreads) {
      const int r = i / 8;
      float dt[8] = {};
      if (r < rows) {
        float tf[8];
        load8(t_ + off + (long)r * kC + c8, tf);
        const float4 d0 = *reinterpret_cast<const float4*>(dn2 + off + (long)r * kC + c8);
        const float4 d1 = *reinterpret_cast<const float4*>(dn2 + off + (long)r * kC + c8 + 4);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c8 + j;
          const float n2 = (tf[j] - s_m2[c]) * s_r2[c];
          dt[j] = s_r2[c] * (dv[j] - s_u1[c] - n2 * s_u2[c]);
          db[j] += dt[j];
        }
      }
      float lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) lo[j] = dt[j] - bf16_round(dt[j]);
      if (MODE == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dtT[(c8 + j) * S + r] = __float2bfloat16_rn(dt[j]);
          dtTl[(c8 + j) * S + r] = __float2bfloat16_rn(lo[j]);
        }
      } else {
        store8(&dtR[r * S + c8], dt);
        store8(&dtRl[r * S + c8], lo);
      }
    }
    for (int i = t; i < kTile * 16; i += kThreads) {
      const int r = i / 16, j8 = (i % 16) * 8;
      float xf[8] = {};
      if (r < rows) load8(x + offx + (long)r * kCin + j8, xf);
      if (MODE == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float n1 = r < rows ? (xf[j] - s_m1[j8 + j]) * s_r1[j8 + j] : 0.f;
          n1T[(j8 + j) * S + r] = __float2bfloat16_rn(n1);
        }
      } else {
        store8(&xR[r * SX + j8], xf);
      }
    }
    __syncthreads();

    if (MODE == 0) {
      // 2. dW1[c][j] += sum_p dt[p][c] n1[p][j]: warp rows c in [r0, r0 + 16)
      warp_mma<16, 4>(acc_w, dtT, S, r0, n1T, S, gq, tq);
      warp_mma<16, 4>(acc_w, dtTl, S, r0, n1T, S, gq, tq);
    } else {
      // 2. dn1[p][j] = sum_c dt[p][c] W1[c][j]: warp rows p in [r0, r0 + 16)
      float acc[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      warp_mma<16, 4>(acc, dtR, S, r0, w1T, S, gq, tq);
      warp_mma<16, 4>(acc, dtRl, S, r0, w1T, S, gq, tq);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = j * 8 + tq * 2;
        *reinterpret_cast<float2*>(&dn1s[(r0 + gq) * DS + c]) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(&dn1s[(r0 + gq + 8) * DS + c]) =
            make_float2(acc[j][2], acc[j][3]);
      }
      __syncthreads();
      if (MODE == 1) {
        // 3. statistics of dn1 against n1: thread t owns channel t
        for (int r = 0; r < rows; ++r) {
          const float v = dn1s[r * DS + t];
          const float n1 = (__bfloat162float(xR[r * SX + t]) - s_m1[t]) * s_r1[t];
          ssum += v;
          ssq += v * n1;
        }
      } else {
        // 3. dx = r1 (dn1 - mean(dn1) - n1 mean(dn1 n1)), bf16, coalesced
        for (int i = t; i < rows * 16; i += kThreads) {
          const int r = i / 16, j8 = (i % 16) * 8;
          float xf[8], o[8];
          load8(&xR[r * SX + j8], xf);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = j8 + j;
            const float n1 = (xf[j] - s_m1[c]) * s_r1[c];
            o[j] = s_r1[c] * (dn1s[r * DS + c] - s_v1[c] - n1 * s_v2[c]);
          }
          store8(dx + offx + (long)r * kCin + j8, o);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites the staging buffers
  }

  const long id = (long)b * nblk + blk;
  if (MODE == 0) {
    float* w = pdw + id * kC * kCin;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = j * 8 + tq * 2;
      w[(r0 + gq) * kCin + c] = acc_w[j][0];
      w[(r0 + gq) * kCin + c + 1] = acc_w[j][1];
      w[(r0 + gq + 8) * kCin + c] = acc_w[j][2];
      w[(r0 + gq + 8) * kCin + c + 1] = acc_w[j][3];
    }
    reduce_rowgroups(db, red, pdb + id * kC);
  } else if (MODE == 1) {
    pstats[id * 2 * kCin + t] = ssum;
    pstats[id * 2 * kCin + kCin + t] = ssq;
  }
}

struct Scratch {
  float *dn2, *pstats, *s3, *s2, *s1, *pdw, *pdb, *pda;
  long total;
};

Scratch scratch_layout(float* base, int batch, int n) {
  const long nblk = (n + kChunk - 1) / kChunk, blocks = (long)batch * nblk;
  Scratch s;
  long o = 0;
  auto take = [&](long count) {
    float* p = base ? base + o : nullptr;
    o += (count + 3) / 4 * 4;  // keep every buffer 16-byte aligned
    return p;
  };
  s.dn2 = take((long)batch * n * kC);
  s.pstats = take(blocks * 2 * kCin);
  s.s3 = take((long)batch * 2 * kC);
  s.s2 = take((long)batch * 2 * kC);
  s.s1 = take((long)batch * 2 * kCin);
  s.pdw = take(blocks * kC * kCin);
  s.pdb = take(blocks * kC);
  s.pda = take(blocks);
  s.total = o;
  return s;
}

cudaError_t group_sum(const float* part, float* out, int len, int count, int groups,
                      float scale, cudaStream_t st) {
  group_sum_kernel<<<dim3((len + 255) / 256, groups), 256, 0, st>>>(part, out, len, count,
                                                                     scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch ppst_fused_tap_bwd needs for a batch of B samples of n pixels.
long ppst_fused_tap_bwd_scratch_floats(int batch, int n) {
  return scratch_layout(nullptr, batch, n).total;
}

// Backward of the fused tap. x (B, n, 128) bf16; t, u, g (B, n, 64) bf16;
// mr the forward's statistics, float32: (B, 2, 128) of x, then (B, 2, 64)
// of t and of u, back to back; w1 (64, 128) and w2 (64, 64) bf16 (out, in);
// a1, a2 (1,) float32. Outputs, float32: dw1 (64, 128), db1 (64,), da1 (1,),
// dw2 (64, 64), db2 (64,), da2 (1,); dx (B, n, 128) bf16 when not null.
// scratch holds ppst_fused_tap_bwd_scratch_floats(B, n) floats. All pointers
// are device pointers, 16-byte aligned, of contiguous tensors.
int ppst_fused_tap_bwd(const void* x, const void* t, const void* u, const void* g,
                       const void* mr, const void* w1, const void* w2, const void* a1,
                       const void* a2, void* dw1, void* db1, void* da1, void* dw2, void* db2,
                       void* da2, void* dx, void* scratch, int batch, int n, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (n + kChunk - 1) / kChunk, blocks = batch * nblk;
  const dim3 grid(nblk, batch);
  const float inv_n = 1.f / (float)n;
  Scratch s = scratch_layout((float*)scratch, batch, n);
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* tb = (const __nv_bfloat16*)t;
  const auto* ub = (const __nv_bfloat16*)u;
  const auto* gb = (const __nv_bfloat16*)g;
  const float* mr1 = (const float*)mr;
  const float* mr2 = mr1 + (long)batch * 2 * kCin;
  const float* mr3 = mr2 + (long)batch * 2 * kC;
  const auto* w1b = (const __nv_bfloat16*)w1;
  const auto* w2b = (const __nv_bfloat16*)w2;
  const float* a1f = (const float*)a1;
  const float* a2f = (const float*)a2;
  cudaError_t err;
#define PPST_CHECK(call)                                 \
  if ((err = (call)) != cudaSuccess) return (int)err;
#define PPST_LAUNCHED() PPST_CHECK(cudaGetLastError())

  // pass A: the output PReLU and the sums IN3-backward needs; da2
  out_stats_kernel<<<grid, kThreads, 0, st>>>(ub, gb, mr3, a2f, s.pstats, s.pda, n, nblk);
  PPST_LAUNCHED();
  PPST_CHECK(group_sum(s.pstats, s.s3, 2 * kC, nblk, batch, inv_n, st));
  PPST_CHECK(group_sum(s.pda, (float*)da2, 1, blocks, 1, 1.f, st));

  // pass B: du, dW2, db2, dp2, da1, dn2 and the sums IN2-backward needs
  PPST_CHECK(cudaFuncSetAttribute(stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kStage2Smem));
  stage2_kernel<<<grid, kThreads, kStage2Smem, st>>>(tb, ub, gb, mr2, mr3, s.s3, w2b, a1f, a2f,
                                                     s.dn2, s.pstats, s.pdw, s.pdb, s.pda, n,
                                                     nblk);
  PPST_LAUNCHED();
  PPST_CHECK(group_sum(s.pstats, s.s2, 2 * kC, nblk, batch, inv_n, st));
  PPST_CHECK(group_sum(s.pdw, (float*)dw2, kC * kC, blocks, 1, 1.f, st));
  PPST_CHECK(group_sum(s.pdb, (float*)db2, kC, blocks, 1, 1.f, st));
  PPST_CHECK(group_sum(s.pda, (float*)da1, 1, blocks, 1, 1.f, st));

  // pass C: dt, dW1, db1
  PPST_CHECK(cudaFuncSetAttribute(stage1_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  stage1_smem(0)));
  stage1_kernel<0><<<grid, kThreads, stage1_smem(0), st>>>(xb, tb, s.dn2, mr1, mr2, s.s2,
                                                           nullptr, w1b, s.pdw, s.pdb, nullptr,
                                                           nullptr, n, nblk);
  PPST_LAUNCHED();
  PPST_CHECK(group_sum(s.pdw, (float*)dw1, kC * kCin, blocks, 1, 1.f, st));
  PPST_CHECK(group_sum(s.pdb, (float*)db1, kC, blocks, 1, 1.f, st));

  if (dx != nullptr) {
    // dn1's sums, then dx; dn1 is recomputed rather than stored
    PPST_CHECK(cudaFuncSetAttribute(
        stage1_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, stage1_smem(1)));
    stage1_kernel<1><<<grid, kThreads, stage1_smem(1), st>>>(
        xb, tb, s.dn2, mr1, mr2, s.s2, nullptr, w1b, nullptr, nullptr, s.pstats, nullptr, n,
        nblk);
    PPST_LAUNCHED();
    PPST_CHECK(group_sum(s.pstats, s.s1, 2 * kCin, nblk, batch, inv_n, st));
    PPST_CHECK(cudaFuncSetAttribute(
        stage1_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, stage1_smem(2)));
    stage1_kernel<2><<<grid, kThreads, stage1_smem(2), st>>>(
        xb, tb, s.dn2, mr1, mr2, s.s2, s.s1, w1b, nullptr, nullptr, nullptr,
        (__nv_bfloat16*)dx, n, nblk);
    PPST_LAUNCHED();
  }
#undef PPST_LAUNCHED
#undef PPST_CHECK
  return 0;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
