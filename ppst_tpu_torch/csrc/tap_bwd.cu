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
//   pass A  dn3 = g PReLU'(n3); sums of dn3 and dn3 n3; da2 = sum g min(n3, 0)
//   pass B  du = IN3-backward(dn3); db2 = sum du; dW2 = du^T p2; dp2 = du W2;
//           da1 = sum dp2 min(n2, 0); dn2 = dp2 PReLU'(n2): the sums of dn2
//           and dn2 n2 (dn2 itself is not stored)
//   pass C  du, dp2 and dn2 again with pass B's arithmetic (the same device
//           code, so the dn2 behind those sums is this dn2 to the bit);
//           dt = IN2-backward(dn2); db1 = sum dt; dW1 = dt^T n1; with dx also
//           dn1 = dt W1 and the sums of dn1 and dn1 n1
//   pass D  (dx only) the chain again to dn1, then dx = IN1-backward(dn1)
// Gradients come back in float32.
//
// Bound: memory traffic. The function must read x (256 B a pixel), t, u and
// g (128 B each): 640 B a pixel, 0.200 ms at (4, 512, 512, 128) at 3.35 TB/s,
// against 0.05 ms of tensor-core work. This design moves 256 + 384 + 640 =
// 1280 B a pixel without dx (0.401 ms there), and 2176 with dx (pass D reads
// t, u, g and x again and writes dx). Recomputing du and dp2 in pass C costs
// a second dp2 product (tensor-core time the card has) instead of a float32
// dn2 written and read back (512 B a pixel and 268 MB of scratch at that
// shape).
//
// Design: the persistent schedule of tap_common.cuh (a TMA producer
// warpgroup and two consumer warpgroups a block, one block an SM, 128-pixel
// items of which each consumer warpgroup owns 64 rows, a ring of TMA tiles,
// records of per-(sample, block) statistics summed in block order by the
// next pass).
// - The products run on wgmma. dp2 = du W2 and dn1 = dt W1 take their A
//   operand from registers: du is computed in the A-fragment layout, and dt
//   in dp2's accumulator layout, which is the A layout. W2 and W1 are loaded
//   once a block and read MN-major. dW2 = du^T p2 and dW1 = dt^T n1 reduce
//   over pixels: their operands are written back into the item's own stage
//   (du or dt over u and g, bf16(n1) over x, in place; p2 into a tile of its
//   own) and read MN-major, each thread writing only the pairs it read.
// - The activation-side operands p2 and n1 are rounded to bf16 once, as the
//   TPU's default-precision dots round them. The gradient-side operands du
//   and dt go in as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), two
//   products each: du sums to zero per channel, so dW2 is small beside its
//   terms, and rounding du once left dW2 several percent of its max off at
//   512px. Every normalization, activation and sum stays in float32; the
//   chain's arithmetic is written with _rn intrinsics so that the compiler
//   contracts nothing and passes B, C and D agree to the bit.
// - dW2, db2 and da1 are per-warpgroup partials reduced by pass C (each
//   block a slice, partials in order); dW1 and db1 are reduced at the end of
//   pass C: the last block of each group of 8 to finish sums its group's
//   partials in order, and the last group to finish sums the groups in
//   order, so the bits do not depend on which block finished last. No float
//   atomics.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_fused_tap_bwd_scratch_floats says how
// much). ppst_fused_tap_bwd returns the first CUDA error of its launches.

#include "tap_common.cuh"

namespace {

constexpr int kC = 64, kCin = 128;
constexpr int kStagesA = 6;      // u, g: 32 KB a stage
constexpr int kStagesB = 4;      // t, u, g: 48 KB
constexpr int kStagesC = 2;      // t, u, g, x: 80 KB
constexpr int kLenB = kC * kC + kC + 4;    // a pass-B partial: dW2, db2, da1 (padded)
constexpr int kLenC = kC * kCin + kC;      // a pass-C partial: dW1, db1
constexpr int kGroup = 8;                  // blocks of a group in pass C's final sum

// Per-sample constants of the chain, in shared memory: the forward's means
// and rstds, and the means of each instance norm's backward sums.
struct Consts {
  float mr1[2][kCin], s1[2][kCin];  // x's mean and rstd; the means of dn1, dn1 n1
  float mr2[2][kC], s2[2][kC];      // t's; dn2, dn2 n2
  float mr3[2][kC], s3[2][kC];      // u's; dn3, dn3 n3
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float pick(float2 v, int e) { return e ? v.y : v.x; }

// A consumer warpgroup's own barrier (ids 2 and 3).
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The chain's arithmetic, shared by passes B, C and D.
__device__ __forceinline__ float normed(float v, float m, float r) {
  return __fmul_rn(__fsub_rn(v, m), r);
}
__device__ __forceinline__ float slope(float nv, float a) { return nv > 0.f ? 1.f : a; }
// r (d - sa - nv sb): the instance-norm backward with the means sa, sb
__device__ __forceinline__ float in_bwd(float d, float nv, float r, float sa, float sb) {
  return __fmul_rn(r, __fsub_rn(__fsub_rn(d, sa), __fmul_rn(nv, sb)));
}
__device__ __forceinline__ uint32_t lo_pair(float v0, float v1) {
  return pack_bf16(__fsub_rn(v0, bf16_round(v0)), __fsub_rn(v1, bf16_round(v1)));
}

// du of the thread's 16 pairs (A-fragment layout) from the item's u and g
// tiles, as hi and lo bf16 pairs; rows past n give 0. With DB, db[2 j + e]
// gathers du of channel 8 j + 2 q + e.
template <bool DB>
__device__ __forceinline__ void du_pairs(const unsigned char* tu, const unsigned char* tg,
                                         const Consts& k, float a2, const bool* ok, int wg,
                                         int w, int g, int q, uint32_t* hi, uint32_t* lo,
                                         float* db) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int c = 8 * (p / 2) + 2 * q, row = frag_row(wg, w, g, p % 2);
    const float2 uv = lds_pair(tu, row, c), gv = lds_pair(tg, row, c);
    const float2 m = ld2(&k.mr3[0][c]), r = ld2(&k.mr3[1][c]);
    const float2 sa = ld2(&k.s3[0][c]), sb = ld2(&k.s3[1][c]);
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float n3 = normed(pick(uv, e), pick(m, e), pick(r, e));
      const float dn3 = __fmul_rn(pick(gv, e), slope(n3, a2));
      d[e] = ok[p % 2] ? in_bwd(dn3, n3, pick(r, e), pick(sa, e), pick(sb, e)) : 0.f;
      if (DB) db[2 * (p / 2) + e] += d[e];
    }
    hi[p] = pack_bf16(d[0], d[1]);
    lo[p] = lo_pair(d[0], d[1]);
  }
}

// dp2 = du W2 (64 x 64) on wgmma: hi terms, then lo; w2 MN-major at w2s.
__device__ __forceinline__ void issue_dp2(float* dp2, const uint32_t* hi, const uint32_t* lo,
                                          uint32_t w2s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dp2, hi + 4 * kk, desc_mn_major(w2s + kk * 2048));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(dp2, lo + 4 * kk, desc_mn_major(w2s + kk * 2048));
}

// dt of the thread's 16 pairs (dp2's accumulator layout) from dp2 and the t
// tile, as hi and lo bf16 pairs; rows past n give 0. db1 gathers dt.
__device__ __forceinline__ void dt_pairs(const float* dp2, const unsigned char* tt,
                                         const Consts& k, float a1, const bool* ok, int wg,
                                         int w, int g, int q, uint32_t* hi, uint32_t* lo,
                                         float* db1) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int c = 8 * (p / 2) + 2 * q, row = frag_row(wg, w, g, p % 2);
    const float2 tv = lds_pair(tt, row, c);
    const float2 m = ld2(&k.mr2[0][c]), r = ld2(&k.mr2[1][c]);
    const float2 sa = ld2(&k.s2[0][c]), sb = ld2(&k.s2[1][c]);
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float n2 = normed(pick(tv, e), pick(m, e), pick(r, e));
      const float dn2 = __fmul_rn(dp2[2 * p + e], slope(n2, a1));
      d[e] = ok[p % 2] ? in_bwd(dn2, n2, pick(r, e), pick(sa, e), pick(sb, e)) : 0.f;
      db1[2 * (p / 2) + e] += d[e];
    }
    hi[p] = pack_bf16(d[0], d[1]);
    lo[p] = lo_pair(d[0], d[1]);
  }
}

// dn1 = dt W1 (64 x 128) on wgmma: hi terms, then lo; w1 MN-major, two
// 64-column atoms 8 KB apart, at w1s.
__device__ __forceinline__ void issue_dn1(float* dn1, const uint32_t* hi, const uint32_t* lo,
                                          uint32_t w1s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs128<1>(dn1, hi + 4 * kk, desc_b128(w1s + kk * 2048, kWBytes, 1024), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs128<1>(dn1, lo + 4 * kk, desc_b128(w1s + kk * 2048, kWBytes, 1024), 1);
}

// The constants of sample b: the forward's statistics from mr, the means of
// dn3 (and dn2, dn1 as `have` says) from the records of passes A, B and C.
__device__ void load_consts(Consts& k, const float* mr, int batch, int b, const float* recA,
                            const float* recB, const float* recC, const Sched& sc, int n,
                            int have) {
  const float inv_n = 1.f / (float)n;
  const float* mr1 = mr + (long)b * 2 * kCin;
  const float* mr2 = mr + (long)batch * 2 * kCin + (long)b * 2 * kC;
  const float* mr3 = mr2 + (long)batch * 2 * kC;
  for (int i = threadIdx.x; i < 2 * kCin; i += kConsumers) k.mr1[i / kCin][i % kCin] = mr1[i];
  for (int i = threadIdx.x; i < 2 * kC; i += kConsumers) {
    k.mr2[i / kC][i % kC] = mr2[i];
    k.mr3[i / kC][i % kC] = mr3[i];
  }
  sum_records(recA, sc, b, kC, inv_n, &k.s3[0][0]);
  if (have >= 2) sum_records(recB, sc, b, kC, inv_n, &k.s2[0][0]);
  if (have >= 3) sum_records(recC, sc, b, kCin, inv_n, &k.s1[0][0]);
}

// out(i, v) for the elements i of [lo, hi): v = the sum over g < count of
// part[g stride + i], as 8 consumer threads an element each sum every 8th
// partial, then their 8 sums in order.
template <typename Out>
__device__ void sum_partials(const float* part, int count, long stride, int lo, int hi,
                             float* red, Out out) {
  for (int base = lo; base < hi; base += kConsumers / 8) {
    const int i = base + threadIdx.x / 8, s = threadIdx.x % 8;
    float acc = 0.f;
    if (i < hi)
      for (int g = s; g < count; g += 8) acc += __ldcg(part + (long)g * stride + i);
    red[threadIdx.x] = acc;
    consumer_sync();
    if (threadIdx.x < kConsumers / 8 && base + (int)threadIdx.x < hi) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += red[threadIdx.x * 8 + k];
      out(base + threadIdx.x, v);
    }
    consumer_sync();
  }
}

// The sum over a warpgroup's 4 warps, in order, of 64 per-channel values
// each thread holds as v[2 j + e] (channel 8 j + 2 q + e) over its rows,
// into dst[0, 64); red holds 8 x 64 floats. Called by both warpgroups.
__device__ void group_channel_sum(const float* v, float* red, float* dst, int wg, int g, int q) {
  const int wid = threadIdx.x / 32;
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const float s_ = sum_over_g(v[x]);
    if (g == 0) red[wid * kC + 8 * (x / 2) + 2 * q + x % 2] = s_;
  }
  group_sync(wg);
  const int t = threadIdx.x % 128;
  if (t < kC) {
    float acc = 0.f;
#pragma unroll
    for (int ww = 0; ww < 4; ++ww) acc += red[(4 * wg + ww) * kC + t];
    dst[t] = acc;
  }
}

// Pass A: record b + blk of recA (B + G - 1, 2, 64) holds the block's sums of
// dn3 and dn3 n3 over sample b, pda[blk] its part of da2. Consumer thread t
// sums channels 8 (t % 8) .. + 8 of rows t / 8 + 32 k of each item. Block 0
// also zeroes pass C's counters.
constexpr int kRingA = kStagesA * 2 * kTileBytes;
constexpr int kRedA = 32 * 2 * kC * 4;
constexpr int kSmemA = kRingA + kRedA + 16 * kStagesA + kAlign;
static_assert(kSmemA <= kMaxSmem, "pass A shared memory");

__global__ void __launch_bounds__(kThreads, 1)
pass_a_kernel(const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_g,
              const float* __restrict__ mr3, const float* __restrict__ alpha2,
              float* __restrict__ recA, float* __restrict__ pda, int* __restrict__ counters,
              int ncounters, Sched sc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(sm);
  float* red = reinterpret_cast<float*>(sm + kRingA);
  const uint32_t bar = ring + kRingA + kRedA;
  const uint32_t full = bar, empty = bar + 8 * kStagesA;
  const int blk = blockIdx.x;
  const long lo = sc.lo(blk), hi = sc.lo(blk + 1);
  init_bars(bar, kStagesA, false);
  allow_next_pass();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    const CUtensorMap* maps[2] = {&tm_u, &tm_g};
    const int boxes[2] = {1, 1};
    if (threadIdx.x == kConsumers) produce<kStagesA>(maps, boxes, ring, full, empty, sc, lo, hi);
    return;
  }
  consumer_regs();
  const int tid = threadIdx.x, lane = tid % 32, k = tid % 8, rg = tid / 8;
  if (blk == 0 && tid < ncounters) counters[tid] = 0;
  const float a2 = *alpha2;
  float m[8], r[8], s[8] = {}, q[8] = {}, da = 0.f;
  auto flush = [&](int b) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(rg * 2 + 0) * kC + 8 * k + j] = s[j];
      red[(rg * 2 + 1) * kC + 8 * k + j] = q[j];
      s[j] = q[j] = 0.f;
    }
    consumer_sync();
    if (tid < 2 * kC) {
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < 32; ++x) acc += red[(x * 2 + tid / kC) * kC + tid % kC];
      recA[(long)(b + blk) * 2 * kC + tid] = acc;
    }
    consumer_sync();
  };
  Ring rn;
  int cur = -1;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T);
    if (b != cur) {
      if (cur >= 0) flush(cur);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = mr3[(long)b * 2 * kC + 8 * k + j];
        r[j] = mr3[(long)b * 2 * kC + kC + 8 * k + j];
      }
      cur = b;
    }
    mbar_wait(full + 8 * rn.st, rn.ph);
    const unsigned char* tu = sm + rn.st * 2 * kTileBytes;
    uint4 ru[4], rgv[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      ru[x] = *reinterpret_cast<const uint4*>(tu + swz(rg + 32 * x, 16 * k));
      rgv[x] = *reinterpret_cast<const uint4*>(tu + kTileBytes + swz(rg + 32 * x, 16 * k));
    }
    release(empty + 8 * rn.st, lane);
    rn.next(kStagesA);
    // rows past n read as zeros: g = 0 adds nothing
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const __nv_bfloat162* hu = reinterpret_cast<const __nv_bfloat162*>(&ru[x]);
      const __nv_bfloat162* hg = reinterpret_cast<const __nv_bfloat162*>(&rgv[x]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 uf = __bfloat1622float2(hu[j]), gf = __bfloat1622float2(hg[j]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float n3 = normed(pick(uf, e), m[2 * j + e], r[2 * j + e]);
          const float gg = pick(gf, e);
          const float d = __fmul_rn(gg, slope(n3, a2));
          s[2 * j + e] += d;
          q[2 * j + e] += d * n3;
          da += gg * fminf(n3, 0.f);
        }
      }
    }
  }
  if (cur >= 0) flush(cur);
  da = sum_warp(da);
  if (lane == 0) red[tid / 32] = da;
  consumer_sync();
  if (tid == 0) {
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < kConsumerWarps; ++x) acc += red[x];
    pda[blk] = acc;
  }
}

// Pass B. Shared memory: W2 (8 KB), the p2 tile (16 KB), the ring of (t, u,
// g) tiles, the constants, a reduction buffer, the barriers. Writes recB (the
// sums of dn2 and dn2 n2) and each consumer warpgroup's partial pB[2 blk +
// wg] = (dW2 (64, 64) (out, in), db2, da1); block 0 also sums pda into da2.
struct LayoutB {
  static constexpr int kW2 = 0, kP2 = kWBytes, kRing = kWBytes + kTileBytes;
  static constexpr int kStage = 3 * kTileBytes;
  static constexpr int kConsts = kRing + kStagesB * kStage;
  static constexpr int kRed = kConsts + (int)sizeof(Consts);
  static constexpr int kBar = kRed + kConsumerWarps * 2 * kC * 4;
  static constexpr int kBytes = kBar + 16 * kStagesB + 8 + kAlign;
  static_assert(kBytes <= kMaxSmem, "pass B shared memory");
};

__global__ void __launch_bounds__(kThreads, 1)
pass_b_kernel(const __grid_constant__ CUtensorMap tm_t, const __grid_constant__ CUtensorMap tm_u,
              const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_w2,
              const float* __restrict__ mr, const float* __restrict__ alpha1,
              const float* __restrict__ alpha2, const float* __restrict__ recA,
              const float* __restrict__ pda, float* __restrict__ recB, float* __restrict__ pB,
              float* __restrict__ da2, Sched sc, int batch, int n) {
  typedef LayoutB L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(sm);
  Consts& k = *reinterpret_cast<Consts*>(sm + L::kConsts);
  float* red = reinterpret_cast<float*>(sm + L::kRed);
  const uint32_t bar = base + L::kBar;
  const uint32_t full = bar, empty = bar + 8 * kStagesB, wbar = bar + 16 * kStagesB;
  const int blk = blockIdx.x;
  const long lo = sc.lo(blk), hi = sc.lo(blk + 1);
  init_bars(bar, kStagesB, true);
  allow_next_pass();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(wbar, kWBytes);
      tma_load(base + L::kW2, &tm_w2, 0, 0, 0, wbar);
      const CUtensorMap* maps[3] = {&tm_t, &tm_u, &tm_g};
      const int boxes[3] = {1, 1, 1};
      produce<kStagesB>(maps, boxes, base + L::kRing, full, empty, sc, lo, hi);
    }
    return;
  }
  consumer_regs();
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const float a1 = *alpha1, a2 = *alpha2;
  wait_prior_pass();  // recA and pda
  if (blk == 0 && tid == 0) {
    float s = 0.f;
    for (int i = 0; i < sc.G; ++i) s += __ldcg(pda + i);
    *da2 = s;
  }
  float dw2[32], db[16] = {}, sum[16] = {}, sq[16] = {}, da = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dw2[i] = 0.f;

  auto flush = [&](int b) {
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float s_ = sum_over_g(sum[x]), q_ = sum_over_g(sq[x]);
      if (g == 0) {
        const int c = 8 * (x / 2) + 2 * q + x % 2;
        red[(tid / 32 * 2 + 0) * kC + c] = s_;
        red[(tid / 32 * 2 + 1) * kC + c] = q_;
      }
      sum[x] = sq[x] = 0.f;
    }
    consumer_sync();
    if (tid < 2 * kC) {
      float acc = 0.f;
#pragma unroll
      for (int ww = 0; ww < kConsumerWarps; ++ww) acc += red[(ww * 2 + tid / kC) * kC + tid % kC];
      recB[(long)(b + blk) * 2 * kC + tid] = acc;
    }
    consumer_sync();
  };

  Ring rn;
  int cur = -1, pend = -1;  // pend: the stage whose dW2 product is in flight
  bool w_ready = false;
  unsigned char* p2t = sm + L::kP2;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T);
    const long row0 = (i % sc.T) * kP;
    if (b != cur) {
      if (cur >= 0) flush(cur);
      consumer_sync();
      load_consts(k, mr, batch, b, recA, nullptr, nullptr, sc, n, 1);
      consumer_sync();
      cur = b;
    }
    const bool ok[2] = {row0 + frag_row(wg, w, g, 0) < n, row0 + frag_row(wg, w, g, 1) < n};
    mbar_wait(full + 8 * rn.st, rn.ph);
    unsigned char* tt = sm + L::kRing + rn.st * L::kStage;
    unsigned char* tu = tt + kTileBytes;
    unsigned char* tg = tt + 2 * kTileBytes;
    uint32_t hi_[16], lo_[16];
    du_pairs<true>(tu, tg, k, a2, ok, wg, w, g, q, hi_, lo_, db);
    // the last item's dW2 product (still in flight) is done once the
    // warpgroup is past this barrier: its stage goes back, the p2 tile is free
    wgmma_wait<0>();
    fence_regs<32>(dw2);
    group_sync(wg);
    if (pend >= 0) release(empty + 8 * pend, lane);
    // du in place over u and g (each thread writes the pairs it read), p2 in
    // its tile; n2 stays in registers for the sums below
    float n2[32];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int c = 8 * (p / 2) + 2 * q, row = frag_row(wg, w, g, p % 2);
      sts_pair(tu, row, c, hi_[p]);
      sts_pair(tg, row, c, lo_[p]);
      const float2 tv = lds_pair(tt, row, c);
      const float2 m = ld2(&k.mr2[0][c]), r = ld2(&k.mr2[1][c]);
      n2[2 * p] = normed(tv.x, m.x, r.x);
      n2[2 * p + 1] = normed(tv.y, m.y, r.y);
      sts_pair(p2t, row, c, pack_bf16(prelu(n2[2 * p], a1), prelu(n2[2 * p + 1], a1)));
    }
    fence_async_smem();
    group_sync(wg);
    if (!w_ready) {
      mbar_wait(wbar, 0);
      w_ready = true;
    }
    float dp2[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) dp2[x] = 0.f;
    const uint32_t au = smem_addr(tu) + wg * kHalfBytes, ag = smem_addr(tg) + wg * kHalfBytes;
    const uint32_t ap = smem_addr(p2t) + wg * kHalfBytes;
    wgmma_fence();
    issue_dp2(dp2, hi_, lo_, base + L::kW2);
    wgmma_commit();
    // dW2[o][i] += sum_p du[p][o] p2[p][i]: A = du^T and B = p2, both MN-major;
    // left in flight until the next item
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64<1, 1>(dw2, desc_mn_major(au + kk * 2048), desc_mn_major(ap + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64<1, 1>(dw2, desc_mn_major(ag + kk * 2048), desc_mn_major(ap + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(dp2);
    fence_u32<16>(hi_);
    fence_u32<16>(lo_);

    // through the a1 PReLU: da1 and the sums of dn2 (rows past n have dp2 = 0)
#pragma unroll
    for (int p = 0; p < 16; ++p) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dn2 = __fmul_rn(dp2[2 * p + e], slope(n2[2 * p + e], a1));
        da += dp2[2 * p + e] * fminf(n2[2 * p + e], 0.f);
        sum[2 * (p / 2) + e] += dn2;
        sq[2 * (p / 2) + e] += dn2 * n2[2 * p + e];
      }
    }
    pend = rn.st;
    rn.next(kStagesB);
  }
  wgmma_wait<0>();
  fence_regs<32>(dw2);
  if (pend >= 0) release(empty + 8 * pend, lane);
  if (cur >= 0) flush(cur);

  // the warpgroup's partial: dW2 as the accumulator lies, then db2 and da1
  float* part = pB + (long)(2 * blk + wg) * kLenB;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int c = 8 * (p / 2) + 2 * q, row = frag_row(0, w, g, p % 2);
    *reinterpret_cast<float2*>(part + row * kC + c) = make_float2(dw2[2 * p], dw2[2 * p + 1]);
  }
  group_channel_sum(db, red, part + kC * kC, wg, g, q);
  da = sum_warp(da);
  if (lane == 0) red[kConsumerWarps * kC + tid / 32] = da;
  group_sync(wg);
  if (tid % 128 == 0) {
    const float* r = red + kConsumerWarps * kC + 4 * wg;
    part[kC * kC + kC] = r[0] + r[1] + r[2] + r[3];
  }
}

// Passes C and D. Shared memory: W2 (8 KB), W1 (16 KB, with dx), the ring of
// (t, u, g, x) tiles (80 KB a stage), the constants, a reduction buffer
// (with dx each warp's running sums of dn1 and dn1 n1), a flag, the barriers.
template <bool DX>
struct LayoutCD {
  static constexpr int kW2 = 0, kW1 = kWBytes, kRing = (DX ? 3 : 1) * kWBytes;
  static constexpr int kStage = 5 * kTileBytes;
  static constexpr int kConsts = kRing + kStagesC * kStage;
  static constexpr int kRed = kConsts + (int)sizeof(Consts);
  static constexpr int kFlag = kRed + (DX ? kConsumerWarps * 2 * kCin : kConsumerWarps * kC) * 4;
  static constexpr int kBar = kFlag + 16;
  static constexpr int kBytes = kBar + 16 * kStagesC + 8 + kAlign;
  static_assert(kBytes <= kMaxSmem, "pass C/D shared memory");
};

// Pass C. MODE 0: without dx; MODE 1: with dx (also the sums of dn1 and
// dn1 n1 into recC). Sums pass B's partials into dw2, db2 and da1 (each
// block a slice) first; writes each consumer warpgroup's partial pC[2 blk +
// wg] = (dW1 (64, 128) (out, in), db1), and the last blocks sum those into
// dw1 and db1. Pass D (MODE 2): dx (B, n, 128) bf16.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
pass_cd_kernel(const __grid_constant__ CUtensorMap tm_t, const __grid_constant__ CUtensorMap tm_u,
               const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w2, const __grid_constant__ CUtensorMap tm_w1,
               const float* __restrict__ mr, const float* __restrict__ alpha1,
               const float* __restrict__ alpha2, const float* __restrict__ recA,
               const float* __restrict__ recB, float* __restrict__ recC,
               const float* __restrict__ pB, float* __restrict__ pC, float* __restrict__ gC,
               int* __restrict__ counters, float* __restrict__ out_dw1,
               float* __restrict__ out_db1, float* __restrict__ out_dw2,
               float* __restrict__ out_db2, float* __restrict__ out_da1, bf16* __restrict__ dx,
               Sched sc, int batch, int n) {
  constexpr bool kDx = MODE != 0;
  typedef LayoutCD<kDx> L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(sm);
  Consts& k = *reinterpret_cast<Consts*>(sm + L::kConsts);
  float* red = reinterpret_cast<float*>(sm + L::kRed);
  int* flag = reinterpret_cast<int*>(sm + L::kFlag);
  const uint32_t bar = base + L::kBar;
  const uint32_t full = bar, empty = bar + 8 * kStagesC, wbar = bar + 16 * kStagesC;
  const int blk = blockIdx.x;
  const long lo = sc.lo(blk), hi = sc.lo(blk + 1);
  init_bars(bar, kStagesC, true);
  allow_next_pass();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(wbar, (kDx ? 3 : 1) * kWBytes);
      tma_load(base + L::kW2, &tm_w2, 0, 0, 0, wbar);
      if (kDx) {
        tma_load(base + L::kW1, &tm_w1, 0, 0, 0, wbar);
        tma_load(base + L::kW1 + kWBytes, &tm_w1, 64, 0, 0, wbar);
      }
      const CUtensorMap* maps[4] = {&tm_t, &tm_u, &tm_g, &tm_x};
      const int boxes[4] = {1, 1, 1, 2};
      produce<kStagesC>(maps, boxes, base + L::kRing, full, empty, sc, lo, hi);
    }
    return;
  }
  consumer_regs();
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const float a1 = *alpha1, a2 = *alpha2;
  wait_prior_pass();  // the records and partials of the passes before

  if (MODE < 2) {
    // pass B's partials: this block's slice of (dW2, db2, da1), partials in order
    constexpr int kOut = kC * kC + kC + 1;
    sum_partials(pB, 2 * sc.G, kLenB, (int)((long)blk * kOut / sc.G),
                 (int)((long)(blk + 1) * kOut / sc.G), red, [&](int i, float v) {
                   if (i < kC * kC) out_dw2[i] = v;
                   else if (i < kC * kC + kC) out_db2[i - kC * kC] = v;
                   else *out_da1 = v;
                 });
  }
  if (MODE == 1)
    for (int i = tid; i < kConsumerWarps * 2 * kCin; i += kConsumers) red[i] = 0.f;

  // with dx: each warp's running sums of dn1, dn1 n1 into recC
  auto flush = [&](int b) {
    consumer_sync();
    for (int v = tid; v < 2 * kCin; v += kConsumers) {
      float acc = 0.f;
#pragma unroll
      for (int ww = 0; ww < kConsumerWarps; ++ww) acc += red[ww * 2 * kCin + v];
      recC[(long)(b + blk) * 2 * kCin + v] = acc;
    }
    consumer_sync();
    for (int i = tid; i < kConsumerWarps * 2 * kCin; i += kConsumers) red[i] = 0.f;
    consumer_sync();
  };

  float dw1[64], db1[16] = {};
  if (MODE < 2) {
#pragma unroll
    for (int i = 0; i < 64; ++i) dw1[i] = 0.f;
  }
  // the n1 rewrite: thread t of the warpgroup keeps channels 8 (t % 16) .. + 8
  const int nk = tid % 16;
  float nm[8], nr[8];
  Ring rn;
  int cur = -1, pend = -1;  // pend: the stage whose dW1 product is in flight
  bool w_ready = false;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T);
    const long row0 = (i % sc.T) * kP;
    if (b != cur) {
      if (MODE == 1 && cur >= 0) flush(cur);
      consumer_sync();
      load_consts(k, mr, batch, b, recA, recB, recC, sc, n, MODE == 2 ? 3 : 2);
      consumer_sync();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        nm[j] = k.mr1[0][8 * nk + j];
        nr[j] = k.mr1[1][8 * nk + j];
      }
      cur = b;
    }
    const bool ok[2] = {row0 + frag_row(wg, w, g, 0) < n, row0 + frag_row(wg, w, g, 1) < n};
    mbar_wait(full + 8 * rn.st, rn.ph);
    unsigned char* tt = sm + L::kRing + rn.st * L::kStage;
    unsigned char* tu = tt + kTileBytes;
    unsigned char* tg = tt + 2 * kTileBytes;
    unsigned char* tx = tt + 3 * kTileBytes;
    if (!w_ready) {
      mbar_wait(wbar, 0);
      w_ready = true;
    }

    // du, then dp2 = du W2: pass B's code
    uint32_t hi_[16], lo_[16];
    du_pairs<false>(tu, tg, k, a2, ok, wg, w, g, q, hi_, lo_, nullptr);
    float dp2[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) dp2[x] = 0.f;
    wgmma_fence();
    issue_dp2(dp2, hi_, lo_, base + L::kW2);
    wgmma_commit();
    wgmma_wait<0>();  // also the last item's dW1 product: its stage goes back
    fence_regs<32>(dp2);
    fence_u32<16>(hi_);
    fence_u32<16>(lo_);
    if (MODE < 2) {
      fence_regs<64>(dw1);
      if (pend >= 0) release(empty + 8 * pend, lane);
    }

    // dt, as hi and lo pairs in dp2's layout: the A operand of dt W1
    float dbx[16] = {};
    dt_pairs(dp2, tt, k, a1, ok, wg, w, g, q, hi_, lo_, MODE < 2 ? db1 : dbx);

    if (kDx) {
      float dn1[64];
      wgmma_fence();
      issue_dn1(dn1, hi_, lo_, base + L::kW1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(dn1);
      fence_u32<16>(hi_);
      fence_u32<16>(lo_);
      if (MODE == 1) {
        // the sums of dn1 and dn1 n1 (n1 in float32 from x) into the warp's
        // running sums; rows past n have dn1 = 0
        float* mine = red + (tid / 32) * 2 * kCin;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + 2 * q;
          const unsigned char* xt = tx + (c / 64) * kTileBytes;
          const float2 x0 = lds_pair(xt, frag_row(wg, w, g, 0), c % 64);
          const float2 x1 = lds_pair(xt, frag_row(wg, w, g, 1), c % 64);
          const float2 m = ld2(&k.mr1[0][c]), r = ld2(&k.mr1[1][c]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float n10 = normed(pick(x0, e), pick(m, e), pick(r, e));
            const float n11 = normed(pick(x1, e), pick(m, e), pick(r, e));
            const float d0 = dn1[4 * j + e], d1 = dn1[4 * j + 2 + e];
            const float s_ = sum_over_g(d0 + d1), q_ = sum_over_g(d0 * n10 + d1 * n11);
            if (g == 0) {
              mine[c + e] += s_;
              mine[kCin + c + e] += q_;
            }
          }
        }
        group_sync(wg);  // the warpgroup has read x before it is overwritten
      } else {
        // dx = r1 (dn1 - s1a - n1 s1b), bf16, 16 contiguous bytes a lane
#pragma unroll
        for (int qb = 0; qb < 4; ++qb) {
          uint32_t wd[2][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * qb + jj, c = 8 * j + 2 * q;
            const unsigned char* xt = tx + (c / 64) * kTileBytes;
            const float2 m = ld2(&k.mr1[0][c]), r = ld2(&k.mr1[1][c]);
            const float2 sa = ld2(&k.s1[0][c]), sb = ld2(&k.s1[1][c]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 xv = lds_pair(xt, frag_row(wg, w, g, h), c % 64);
              float o[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float n1 = normed(pick(xv, e), pick(m, e), pick(r, e));
                o[e] = in_bwd(dn1[4 * j + 2 * h + e], n1, pick(r, e), pick(sa, e), pick(sb, e));
              }
              wd[h][jj] = pack_bf16(o[0], o[1]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            quad_transpose(wd[h], q);
            if (ok[h])
              *reinterpret_cast<uint4*>(
                  dx + ((long)b * n + row0 + frag_row(wg, w, g, h)) * kCin + 8 * (4 * qb + q)) =
                  make_uint4(wd[h][0], wd[h][1], wd[h][2], wd[h][3]);
          }
        }
        release(empty + 8 * rn.st, lane);
        rn.next(kStagesC);
        continue;
      }
    }

    // dW1[c][j] += sum_p dt[p][c] n1[p][j]: dt over u and g, bf16(n1) over
    // x, in place, each warpgroup its 64 rows; A = dt^T and B = n1 (two
    // 64-channel atoms, 16 KB apart), MN-major
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int c = 8 * (p / 2) + 2 * q, row = frag_row(wg, w, g, p % 2);
      sts_pair(tu, row, c, hi_[p]);
      sts_pair(tg, row, c, lo_[p]);
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int row = 64 * wg + (tid % 128) / 16 + 8 * x;
      uint4* v = reinterpret_cast<uint4*>(tx + (nk / 8) * kTileBytes + swz(row, 16 * (nk % 8)));
      uint4 raw = *v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(normed(f.x, nm[2 * j], nr[2 * j]),
                                     normed(f.y, nm[2 * j + 1], nr[2 * j + 1]));
      }
      *v = raw;
    }
    fence_async_smem();
    group_sync(wg);
    const uint32_t au = smem_addr(tu) + wg * kHalfBytes, ag = smem_addr(tg) + wg * kHalfBytes;
    const uint32_t ax = smem_addr(tx) + wg * kHalfBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n128<1, 1>(dw1, desc_mn_major(au + kk * 2048),
                       desc_b128(ax + kk * 2048, kTileBytes, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n128<1, 1>(dw1, desc_mn_major(ag + kk * 2048),
                       desc_b128(ax + kk * 2048, kTileBytes, 1024), 1);
    wgmma_commit();  // left in flight until the next item
    pend = rn.st;
    rn.next(kStagesC);
  }
  if (MODE == 2) return;
  wgmma_wait<0>();
  fence_regs<64>(dw1);
  if (pend >= 0) release(empty + 8 * pend, lane);
  if (MODE == 1 && cur >= 0) flush(cur);

  // the warpgroup's partial: dW1 as the accumulator lies, then db1
  float* part = pC + (long)(2 * blk + wg) * kLenC;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const int c = 8 * (p / 2) + 2 * q, row = frag_row(0, w, g, p % 2);
    *reinterpret_cast<float2*>(part + row * kCin + c) = make_float2(dw1[2 * p], dw1[2 * p + 1]);
  }
  consumer_sync();
  group_channel_sum(db1, red, part + kC * kCin, wg, g, q);

  // the last block of each group of kGroup sums its group's partials in
  // order into gC; the last group sums gC in group order
  const int ng = (sc.G + kGroup - 1) / kGroup, grp = blk / kGroup;
  const int g0 = grp * kGroup, g1 = min(g0 + kGroup, sc.G);
  __threadfence();
  consumer_sync();
  if (tid == 0) *flag = atomicAdd(counters + grp, 1) == g1 - g0 - 1;
  consumer_sync();
  if (!*flag) return;
  __threadfence();
  // four floats a thread, every partial's loads in flight at once
  for (int i = 4 * tid; i < kLenC; i += 4 * kConsumers) {
    float4 v[2 * kGroup];
#pragma unroll
    for (int x = 0; x < 2 * kGroup; ++x)
      if (2 * g0 + x < 2 * g1)
        v[x] = __ldcg(reinterpret_cast<const float4*>(pC + (long)(2 * g0 + x) * kLenC + i));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int x = 0; x < 2 * kGroup; ++x)
      if (2 * g0 + x < 2 * g1) acc = add4(acc, v[x]);
    *reinterpret_cast<float4*>(gC + (long)grp * kLenC + i) = acc;
  }
  __threadfence();
  consumer_sync();
  if (tid == 0) *flag = atomicAdd(counters + ng, 1) == ng - 1;
  consumer_sync();
  if (!*flag) return;
  __threadfence();
  for (int i = 4 * tid; i < kLenC; i += 4 * kConsumers) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int x = 0;
    for (; x + 8 <= ng; x += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = __ldcg(reinterpret_cast<const float4*>(gC + (long)(x + u) * kLenC + i));
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add4(acc, v[u]);
    }
    for (; x < ng; ++x)
      acc = add4(acc, __ldcg(reinterpret_cast<const float4*>(gC + (long)x * kLenC + i)));
    const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i + e < kC * kCin) out_dw1[i + e] = a4[e];
      else out_db1[i + e - kC * kCin] = a4[e];
    }
  }
}

typedef LayoutCD<false> LayoutC;
typedef LayoutCD<true> LayoutDx;

struct Scratch {
  float *recA, *pda, *recB, *pB, *recC, *pC, *gC;
  int* counters;
  int ncounters;
  long total;
};

Scratch scratch_layout(float* base, int batch, int sms) {
  Scratch s;
  long o = 0;
  auto take = [&](long count) {
    float* p = base ? base + o : nullptr;
    o += (count + 3) / 4 * 4;  // keep every buffer 16-byte aligned
    return p;
  };
  s.recA = take(record_floats(batch, sms, kC));
  s.pda = take(sms);
  s.recB = take(record_floats(batch, sms, kC));
  s.pB = take(2L * sms * kLenB);
  s.recC = take(record_floats(batch, sms, kCin));
  s.pC = take(2L * sms * kLenC);
  const long groups = (sms + kGroup - 1) / kGroup;
  s.gC = take(groups * kLenC);
  s.ncounters = (int)groups + 1;
  s.counters = reinterpret_cast<int*>(take(s.ncounters));
  s.total = o;
  return s;
}

bool smem_set[5][64];  // per kernel and device

}  // namespace

extern "C" {

// Floats of scratch ppst_fused_tap_bwd needs for B samples on the current device.
long ppst_fused_tap_bwd_scratch_floats(int batch, int n) {
  (void)n;
  return scratch_layout(nullptr, batch, sm_count()).total;
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
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const Sched sc = make_sched(batch, n, sms);
  Scratch s = scratch_layout((float*)scratch, batch, sms);
  const float* mrf = (const float*)mr;
  const float* mr3 = mrf + (long)batch * 2 * kCin + (long)batch * 2 * kC;
  const float* a1f = (const float*)a1;
  const float* a2f = (const float*)a2;
  CUtensorMap tm_x, tm_t, tm_u, tm_g, tm_w1, tm_w2;
  if (!encode_act_map(&tm_x, x, batch, n, kCin) || !encode_act_map(&tm_t, t, batch, n, kC) ||
      !encode_act_map(&tm_u, u, batch, n, kC) || !encode_act_map(&tm_g, g, batch, n, kC) ||
      !encode_weight_map(&tm_w1, w1, kC, kCin) || !encode_weight_map(&tm_w2, w2, kC, kC))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define PPST_CHECK(call)                                 \
  if ((err = (call)) != cudaSuccess) return (int)err;
  PPST_CHECK(set_smem_once(pass_a_kernel, kSmemA, smem_set[0]));
  PPST_CHECK(set_smem_once(pass_b_kernel, LayoutB::kBytes, smem_set[1]));
  PPST_CHECK(set_smem_once(pass_cd_kernel<0>, LayoutC::kBytes, smem_set[2]));
  PPST_CHECK(set_smem_once(pass_cd_kernel<1>, LayoutDx::kBytes, smem_set[3]));
  PPST_CHECK(set_smem_once(pass_cd_kernel<2>, LayoutDx::kBytes, smem_set[4]));

  // pass A waits for whatever wrote g; B, C and D may each begin while the
  // pass before them ends (their producers read only t, u, g, x and weights)
  // pass A: the output PReLU and the sums IN3-backward needs; da2's partials
  PPST_CHECK(launch_pass(pass_a_kernel, sc.G, kSmemA, st, false, tm_u, tm_g, mr3, a2f, s.recA,
                         s.pda, s.counters, s.ncounters, sc));
  // pass B: dW2, db2, da1 partials and the sums IN2-backward needs
  PPST_CHECK(launch_pass(pass_b_kernel, sc.G, LayoutB::kBytes, st, true, tm_t, tm_u, tm_g, tm_w2,
                         mrf, a1f, a2f, (const float*)s.recA, (const float*)s.pda, s.recB, s.pB,
                         (float*)da2, sc, batch, n));
  // pass C: dW2, db2, da1; dt, dW1, db1 (and with dx the sums IN1-backward needs)
  auto pass_cd = [&](auto kernel, int smem, bf16* out_dx) {
    return launch_pass(kernel, sc.G, smem, st, true, tm_t, tm_u, tm_g, tm_x, tm_w2, tm_w1, mrf,
                       a1f, a2f, (const float*)s.recA, (const float*)s.recB, s.recC,
                       (const float*)s.pB, s.pC, s.gC, s.counters, (float*)dw1, (float*)db1,
                       (float*)dw2, (float*)db2, (float*)da1, out_dx, sc, batch, n);
  };
  if (dx == nullptr) {
    PPST_CHECK(pass_cd(pass_cd_kernel<0>, LayoutC::kBytes, nullptr));
  } else {
    PPST_CHECK(pass_cd(pass_cd_kernel<1>, LayoutDx::kBytes, nullptr));
    // pass D: dx
    PPST_CHECK(pass_cd(pass_cd_kernel<2>, LayoutDx::kBytes, (bf16*)dx));
  }
#undef PPST_CHECK
  return 0;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
