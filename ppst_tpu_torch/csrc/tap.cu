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
// Bound: memory traffic. The function must read x (256 B a pixel) and write
// out (128 B), 0.060 ms at (2, 512, 512, 128) at 3.35 TB/s, against 0.003 ms
// of tensor-core work. An instance norm needs its sample's statistics before
// the next stage can start, so without changing the function the design
// makes four passes: statistics of x; conv1 (t and its statistics); conv2 (u
// and its statistics); the apply. It moves 1152 B a pixel (x read twice, t
// and u each written and read, out written): 0.180 ms at that shape.
//
// Design: four persistent launches of the schedule in tap_common.cuh (a TMA
// producer warpgroup and two consumer warpgroups a block, one block an SM, a
// static walk of 128-pixel items, a ring of TMA tiles). The statistics of each
// pass's output go to per-(sample, block) records that the next pass sums in
// block order when it meets the sample: there is no finalize launch, and no
// float atomics. Each sample's first block of a pass writes the mean and rstd
// of that pass's input to mr, the backward's residuals.
// - Conv passes: W1 (or W2) is loaded once a block by TMA and stays in shared
//   memory, 128B-swizzled, K-major. Each consumer thread reads its A-fragment
//   pairs of its warpgroup's 64 rows of the item's tile, normalizes them (and
//   applies PReLU) in float32 with its channels' statistics in registers,
//   rounds them to bf16 and feeds them straight to wgmma m64n64k16 with A
//   from registers: the normalized tile never goes back to shared memory,
//   and the stage goes back to the producer before the product. The epilogue
//   adds the bias, rounds, sums the rounded values' statistics and stores 16
//   contiguous bytes a lane after a transpose of the bf16 pairs across each
//   lane quad (4-byte stores cost K6 a third of its conv on this card).
// - The statistics pass and the apply read 16-byte chunks of the swizzled
//   tiles; the apply stores 16 bytes a lane.
// - A thread adds each item's rows first and keeps compensated running sums:
//   a plain float32 running sum of bf16 squares over the ~2000 rows a thread
//   sees at (16, 512, 512, 128) drifted by -4e-6 (x's rstd 2e-6 off on an
//   H100, 0.5% of t flipped a bf16 step; tests/test_torch_tap_tiles.py).
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_fused_tap_fwd_scratch_floats floats).
// ppst_fused_tap_fwd returns the first CUDA error of its launches (0 when all
// were accepted).

#include "tap_common.cuh"

namespace {

constexpr int kStatsStages = 6;  // x tiles: 32 KB a stage
constexpr int kConv1Stages = 6;  // x: 32 KB
constexpr int kConv2Stages = 12; // t: 16 KB
constexpr int kApplyStages = 12; // u: 16 KB

// Pass 1: per-(sample, block) sums and sums of squares of x (128 channels)
// into rec1 (B + G - 1, 2, 128). Consumer thread t sums channels
// 8 (t % 16) .. + 8 of rows t / 16 + 16 k of each item.
constexpr int kStatsRing = kStatsStages * 2 * kTileBytes;
constexpr int kStatsRed = 16 * 2 * 128 * 4;
constexpr int kStatsSmem = kStatsRing + kStatsRed + 16 * kStatsStages + kAlign;
static_assert(kStatsSmem <= kMaxSmem, "stats shared memory");

__global__ void __launch_bounds__(kThreads, 1)
stats_kernel(const __grid_constant__ CUtensorMap tm_x, float* __restrict__ rec, Sched sc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(sm);
  float* red = reinterpret_cast<float*>(sm + kStatsRing);
  const uint32_t bar = ring + kStatsRing + kStatsRed;
  const uint32_t full = bar, empty = bar + 8 * kStatsStages;
  const int blk = blockIdx.x;
  const long lo = sc.lo(blk), hi = sc.lo(blk + 1);
  init_bars(bar, kStatsStages, false);
  allow_next_pass();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    const CUtensorMap* maps[1] = {&tm_x};
    const int boxes[1] = {2};
    if (threadIdx.x == kConsumers)
      produce<kStatsStages>(maps, boxes, ring, full, empty, sc, lo, hi);
    return;
  }
  consumer_regs();
  const int tid = threadIdx.x, lane = tid % 32, k = tid % 16, rg = tid / 16;
  // running sums of the thread's 8 channels, compensated: each item's 8 rows
  // are summed first, then added
  float s[8] = {}, q[8] = {}, cs[8] = {}, cq[8] = {};
  auto flush = [&](int b) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(rg * 2 + 0) * 128 + 8 * k + j] = __fsub_rn(s[j], cs[j]);
      red[(rg * 2 + 1) * 128 + 8 * k + j] = __fsub_rn(q[j], cq[j]);
      s[j] = q[j] = cs[j] = cq[j] = 0.f;
    }
    consumer_sync();
    {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) acc += red[(r * 2 + tid / 128) * 128 + tid % 128];
      rec[(long)(b + blk) * 256 + tid] = acc;
    }
    consumer_sync();
  };
  Ring rn;
  int cur = -1;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T);
    if (b != cur) {
      if (cur >= 0) flush(cur);
      cur = b;
    }
    mbar_wait(full + 8 * rn.st, rn.ph);
    const unsigned char* tile = sm + (rn.st * 2 + k / 8) * kTileBytes;
    uint4 raw[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      raw[r] = *reinterpret_cast<const uint4*>(tile + swz(rg + 16 * r, 16 * (k % 8)));
    release(empty + 8 * rn.st, lane);
    rn.next(kStatsStages);
    // rows past n read as zeros and add nothing
    float is[8] = {}, iq[8] = {};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        is[2 * j] += f.x;
        iq[2 * j] += f.x * f.x;
        is[2 * j + 1] += f.y;
        iq[2 * j + 1] += f.y * f.y;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kahan_add(s[j], cs[j], is[j]);
      kahan_add(q[j], cq[j], iq[j]);
    }
  }
  if (cur >= 0) flush(cur);
}

// Conv passes: out = bf16(bf16(PReLU?((in - mean) rstd)) @ W^T + bias) over
// 64 output channels, with in's statistics summed from rec_in (written to
// mr_in by each sample's first block) and out's into rec_out (B + G - 1, 2,
// 64). tm_in maps in (B, n, CIN), tm_w the weight (64, CIN).
template <int CIN, int STAGES>
struct ConvLayout {
  static constexpr int kWTiles = CIN / 64;
  static constexpr int kRing = kWTiles * kWBytes;
  static constexpr int kStats = kRing + STAGES * kWTiles * kTileBytes;  // mean, rstd (CIN each)
  static constexpr int kBias = kStats + 2 * CIN * 4;
  static constexpr int kRed = kBias + 64 * 4;  // 8 consumer warps x 2 x 64
  static constexpr int kBar = kRed + kConsumerWarps * 2 * 64 * 4;
  static constexpr int kBytes = kBar + 16 * STAGES + 8 + kAlign;
  static_assert(kBytes <= kMaxSmem, "conv shared memory");
};

template <int CIN, int STAGES, bool PRELU>
__global__ void __launch_bounds__(kThreads, 1)
conv_kernel(const __grid_constant__ CUtensorMap tm_in, const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ rec_in, float* __restrict__ mr_in,
            const float* __restrict__ bias, const float* __restrict__ alpha,
            bf16* __restrict__ out, float* __restrict__ rec_out, Sched sc, int n) {
  typedef ConvLayout<CIN, STAGES> L;
  constexpr int kBoxes = CIN / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(sm);
  float* st = reinterpret_cast<float*>(sm + L::kStats);
  float* red = reinterpret_cast<float*>(sm + L::kRed);
  float* s_bias = reinterpret_cast<float*>(sm + L::kBias);
  const uint32_t bar = base + L::kBar;
  const uint32_t full = bar, empty = bar + 8 * STAGES, wbar = bar + 16 * STAGES;
  const int blk = blockIdx.x;
  const long lo = sc.lo(blk), hi = sc.lo(blk + 1);
  init_bars(bar, STAGES, true);
  allow_next_pass();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(wbar, kBoxes * kWBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) tma_load(base + x * kWBytes, &tm_w, 64 * x, 0, 0, wbar);
      if (PRELU) wait_prior_pass();  // conv2 reads t, conv1's output; conv1 reads x
      const CUtensorMap* maps[1] = {&tm_in};
      const int boxes[1] = {kBoxes};
      produce<STAGES>(maps, boxes, base + L::kRing, full, empty, sc, lo, hi);
    }
    return;
  }
  consumer_regs();
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  if (tid < 64) s_bias[tid] = bias[tid];
  wait_prior_pass();  // rec_in
  const float a_in = PRELU ? *alpha : 0.f;
  // compensated running sums of output channel 8 (k / 2) + 2 q + k % 2 over
  // the thread's rows; each item's two rows are summed first
  float sum[16] = {}, sq[16] = {}, csum[16] = {}, csq[16] = {};
  // the statistics of the thread's input channels 8 (k / 2) + 2 q + k % 2,
  // and the biases of its output channels, in registers
  float mk[CIN / 4], rk[CIN / 4], bk[16];

  auto flush = [&](int b) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float s_ = sum_over_g(__fsub_rn(sum[k], csum[k]));
      const float q_ = sum_over_g(__fsub_rn(sq[k], csq[k]));
      if (g == 0) {
        const int c = 8 * (k / 2) + 2 * q + k % 2;
        red[(tid / 32 * 2 + 0) * 64 + c] = s_;
        red[(tid / 32 * 2 + 1) * 64 + c] = q_;
      }
      sum[k] = sq[k] = csum[k] = csq[k] = 0.f;
    }
    consumer_sync();
    if (tid < 128) {
      const int stat = tid / 64, c = tid % 64;
      float acc = 0.f;
#pragma unroll
      for (int ww = 0; ww < kConsumerWarps; ++ww) acc += red[(ww * 2 + stat) * 64 + c];
      rec_out[(long)(b + blk) * 128 + tid] = acc;
    }
    consumer_sync();
  };

  Ring rn;
  int cur = -1;
  bool w_ready = false;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T);
    const long row0 = (i % sc.T) * kP;
    if (b != cur) {
      if (cur >= 0) flush(cur);
      consumer_sync();
      sum_records(rec_in, sc, b, CIN, 1.f, st);
      consumer_sync();
      finish_moments(st, CIN, n, mr_in, b, sc.first_block(b) == blk);
      consumer_sync();
#pragma unroll
      for (int k = 0; k < CIN / 4; ++k) {
        mk[k] = st[8 * (k / 2) + 2 * q + k % 2];
        rk[k] = st[CIN + 8 * (k / 2) + 2 * q + k % 2];
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) bk[k] = s_bias[8 * (k / 2) + 2 * q + k % 2];
      cur = b;
    }
    mbar_wait(full + 8 * rn.st, rn.ph);
    const unsigned char* tile = sm + L::kRing + rn.st * kBoxes * kTileBytes;
    uint32_t a[CIN / 4];
#pragma unroll
    for (int p = 0; p < CIN / 4; ++p) {
      const int c = 8 * (p / 2) + 2 * q, k = 2 * (p / 2);
      const float2 f =
          lds_pair(tile + (c / 64) * kTileBytes, frag_row(wg, w, g, p % 2), c % 64);
      float y0 = (f.x - mk[k]) * rk[k], y1 = (f.y - mk[k + 1]) * rk[k + 1];
      if (PRELU) {
        y0 = prelu(y0, a_in);
        y1 = prelu(y1, a_in);
      }
      a[p] = pack_bf16(y0, y1);
    }
    release(empty + 8 * rn.st, lane);
    rn.next(STAGES);
    if (!w_ready) {
      mbar_wait(wbar, 0);
      w_ready = true;
    }
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CIN / 16; ++kk)
      wgmma_rs64<0>(acc, a + 4 * kk, desc_k_major(base + (kk / 4) * kWBytes + (kk % 4) * 32),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);
    fence_u32<CIN / 4>(a);

    // epilogue: bias, round, statistics of the rounded values, 16-byte stores
    const bool ok[2] = {row0 + frag_row(wg, w, g, 0) < n, row0 + frag_row(wg, w, g, 1) < n};
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      uint32_t wd[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * qb + jj;
        float is[2] = {}, iq[2] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = bf16_round(acc[4 * j + 2 * h] + bk[2 * j]);
          const float v1 = bf16_round(acc[4 * j + 2 * h + 1] + bk[2 * j + 1]);
          if (ok[h]) {
            is[0] += v0;
            iq[0] += v0 * v0;
            is[1] += v1;
            iq[1] += v1 * v1;
          }
          wd[h][jj] = pack_bf16(v0, v1);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          kahan_add(sum[2 * j + e], csum[2 * j + e], is[e]);
          kahan_add(sq[2 * j + e], csq[2 * j + e], iq[e]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        quad_transpose(wd[h], q);
        if (ok[h])
          *reinterpret_cast<uint4*>(out + ((long)b * n + row0 + frag_row(wg, w, g, h)) * 64 +
                                    8 * (4 * qb + q)) =
              make_uint4(wd[h][0], wd[h][1], wd[h][2], wd[h][3]);
      }
    }
  }
  if (cur >= 0) flush(cur);
}

// Pass 4: out = bf16(PReLU_a((u - mean) rstd)) with u's statistics summed
// from rec_in (written to mr_in by each sample's first block). Consumer
// thread t keeps channels 8 (t % 8) .. + 8 and walks rows t / 8 + 32 k of
// each item.
constexpr int kApplyRing = kApplyStages * kTileBytes;
constexpr int kApplySmem = kApplyRing + 2 * 64 * 4 + 16 * kApplyStages + kAlign;
static_assert(kApplySmem <= kMaxSmem, "apply shared memory");

__global__ void __launch_bounds__(kThreads, 1)
apply_kernel(const __grid_constant__ CUtensorMap tm_u, const float* __restrict__ rec_in,
             float* __restrict__ mr_in, const float* __restrict__ alpha, bf16* __restrict__ out,
             Sched sc, int n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(sm);
  float* st = reinterpret_cast<float*>(sm + kApplyRing);
  const uint32_t bar = ring + kApplyRing + 2 * 64 * 4;
  const uint32_t full = bar, empty = bar + 8 * kApplyStages;
  const int blk = blockIdx.x;
  const long lo = sc.lo(blk), hi = sc.lo(blk + 1);
  init_bars(bar, kApplyStages, false);
  allow_next_pass();
  wait_prior_pass();  // u and rec_in, conv2's outputs

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    const CUtensorMap* maps[1] = {&tm_u};
    const int boxes[1] = {1};
    if (threadIdx.x == kConsumers)
      produce<kApplyStages>(maps, boxes, ring, full, empty, sc, lo, hi);
    return;
  }
  consumer_regs();
  const int tid = threadIdx.x, lane = tid % 32, k = tid % 8, rg = tid / 8;
  const float a = *alpha;
  float m[8], r[8];
  Ring rn;
  int cur = -1;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T);
    const long row0 = (i % sc.T) * kP;
    if (b != cur) {
      consumer_sync();
      sum_records(rec_in, sc, b, 64, 1.f, st);
      consumer_sync();
      finish_moments(st, 64, n, mr_in, b, sc.first_block(b) == blk);
      consumer_sync();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = st[8 * k + j];
        r[j] = st[64 + 8 * k + j];
      }
      cur = b;
    }
    mbar_wait(full + 8 * rn.st, rn.ph);
    const unsigned char* tile = sm + rn.st * kTileBytes;
    uint4 raw[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      raw[x] = *reinterpret_cast<const uint4*>(tile + swz(rg + 32 * x, 16 * k));
    release(empty + 8 * rn.st, lane);
    rn.next(kApplyStages);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const long row = row0 + rg + 32 * x;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw[x]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(prelu((f.x - m[2 * j]) * r[2 * j], a),
                                     prelu((f.y - m[2 * j + 1]) * r[2 * j + 1], a));
      }
      if (row < n) *reinterpret_cast<uint4*>(out + ((long)b * n + row) * 64 + 8 * k) = raw[x];
    }
  }
}

typedef ConvLayout<128, kConv1Stages> Conv1;
typedef ConvLayout<64, kConv2Stages> Conv2;

// Floats of the three passes' records.
struct FwdScratch {
  float *rec1, *rec2, *rec3;
  long total;
};

FwdScratch fwd_scratch(float* base, int batch, int sms) {
  FwdScratch s;
  const long r1 = record_floats(batch, sms, 128), r2 = record_floats(batch, sms, 64);
  s.rec1 = base;
  s.rec2 = base ? base + r1 : nullptr;
  s.rec3 = base ? base + r1 + r2 : nullptr;
  s.total = r1 + 2 * r2;
  return s;
}

bool smem_set[4][64];  // per kernel and device

}  // namespace

extern "C" {

// Floats of scratch ppst_fused_tap_fwd needs for B samples on the current device.
long ppst_fused_tap_fwd_scratch_floats(int batch, int n) {
  (void)n;
  return fwd_scratch(nullptr, batch, sm_count()).total;
}

// Forward of the fused tap. x (B, n, 128), w1 (64, 128) and w2 (64, 64) bf16;
// b1, b2 (64,) and a1, a2 (1,) float32; t, u, out (B, n, 64) bf16; scratch
// holds ppst_fused_tap_fwd_scratch_floats(B, n) floats. mr (B * 384 floats)
// receives the three instance norms' mean and rstd, the backward's residuals:
// (B, 2, 128) of x, then (B, 2, 64) of t and of u, back to back. All
// pointers are device pointers, 16-byte aligned, of contiguous tensors.
int ppst_fused_tap_fwd(const void* x, const void* w1, const void* b1, const void* a1,
                       const void* w2, const void* b2, const void* a2, void* t, void* u,
                       void* out, void* scratch, void* mr, int batch, int n, int cin, int c1,
                       int c2, void* stream) {
  if (cin != 128 || c1 != 64 || c2 != 64 || batch < 1 || batch > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const Sched sc = make_sched(batch, n, sms);
  const FwdScratch sp = fwd_scratch((float*)scratch, batch, sms);
  float* mr1 = (float*)mr;
  float* mr2 = mr1 + (long)batch * 2 * 128;
  float* mr3 = mr2 + (long)batch * 2 * 64;
  CUtensorMap tm_x, tm_t, tm_u, tm_w1, tm_w2;
  if (!encode_act_map(&tm_x, x, batch, n, 128) || !encode_act_map(&tm_t, t, batch, n, 64) ||
      !encode_act_map(&tm_u, u, batch, n, 64) || !encode_weight_map(&tm_w1, w1, 64, 128) ||
      !encode_weight_map(&tm_w2, w2, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define PPST_CHECK(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;
  PPST_CHECK(set_smem_once(stats_kernel, kStatsSmem, smem_set[0]));
  PPST_CHECK(set_smem_once(conv_kernel<128, kConv1Stages, false>, Conv1::kBytes, smem_set[1]));
  PPST_CHECK(set_smem_once(conv_kernel<64, kConv2Stages, true>, Conv2::kBytes, smem_set[2]));
  PPST_CHECK(set_smem_once(apply_kernel, kApplySmem, smem_set[3]));

  // the first pass waits for whatever wrote x; the next three may each begin
  // while the one before them ends
  PPST_CHECK(launch_pass(stats_kernel, sc.G, kStatsSmem, s, false, tm_x, sp.rec1, sc));
  PPST_CHECK(launch_pass(conv_kernel<128, kConv1Stages, false>, sc.G, Conv1::kBytes, s, true,
                         tm_x, tm_w1, (const float*)sp.rec1, mr1, (const float*)b1,
                         (const float*)a1, (bf16*)t, sp.rec2, sc, n));
  PPST_CHECK(launch_pass(conv_kernel<64, kConv2Stages, true>, sc.G, Conv2::kBytes, s, true,
                         tm_t, tm_w2, (const float*)sp.rec2, mr2, (const float*)b2,
                         (const float*)a1, (bf16*)u, sp.rec3, sc, n));
  PPST_CHECK(launch_pass(apply_kernel, sc.G, kApplySmem, s, true, tm_u, (const float*)sp.rec3,
                         mr3, (const float*)a2, (bf16*)out, sc, n));
#undef PPST_CHECK
  return 0;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
