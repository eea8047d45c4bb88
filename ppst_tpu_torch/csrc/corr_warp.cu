// Blockwise correspondence warp for Hopper (sm_90a):
//   out[b, i, :] = sum_j softmax_j(q[b, i] . k[b, j] / T) v[b, j, :]
// with q (B, Lq, C), k (B, Lk, C), v (B, Lk, Cv) and out (B, Lq, Cv) in v's
// dtype, computed with an online softmax so the Lq x Lk matrix is never held.
//
// Replaces the TPU kernel ppst_tpu/ops/corr_pallas.py::corr_warp_blockwise
// (_kernel). Its arithmetic is kept: logits are products of input-dtype q and
// k with float32 sums, scaled by 1/T; the running max m, the running sum l
// and the accumulator stay in float32; P is rounded to bf16 for the P V
// product, as the TPU's one-pass bf16 dot did; the output is rounded once, at
// the end. Unlike the Pallas kernel, which falls back to a dense einsum when L
// is not a multiple of its block, these kernels mask the tails: keys beyond
// Lk get a logit of -inf, query rows beyond Lq are not stored, so every shape
// runs here.
//
// Bound: operations. At 1024px (Lq = Lk = 16384, C = 512, Cv = 32..256) one
// call does 2 Lq Lk (C + Cv) = 292-412 GFLOP on 17-25 MB of inputs, 0.30-0.42
// ms at the H100's dense bf16 rate, far above the tensor cores' ratio of
// operations to bytes. Both products therefore run on wgmma, the only way to
// the tensor cores' full rate on Hopper, fed by TMA so that no thread spends
// registers or instructions on copies.
//
// bf16 design: one block of three warpgroups owns 128 query rows and up to
// 256 value columns (wider values are split over gridDim.z, each split
// recomputing S) and walks the keys in tiles of 64.
// - Warpgroup 0 is the producer: setmaxnreg cuts it to 24 registers and one
//   thread issues every TMA load. Warpgroups 1 and 2 are consumers of 64 rows
//   each, raised to 240 registers: every K and V tile fetched once serves
//   both, 128 rows.
// - Q stays in shared memory: 128 rows x C as ceil(C / 64) chunks of 64
//   channels (16 KB each, 128 KB at C = 512), loaded once, 128B-swizzled.
// - K comes through a ring of 64 keys x 64 channels (8 KB, 128B-swizzled),
//   4-8 stages, with full and empty mbarriers. S = Q K^T is wgmma m64n64k16
//   with both operands read from shared memory through descriptors, summed
//   over the channel chunks of a key tile; a chunk goes back to the producer
//   as soon as the wgmmas that read it have retired.
// - V keeps its natural (keys, Cv) layout: 2 stages of 64 keys x 64 columns
//   per chunk (8 KB each, up to 4 chunks). O += P V is wgmma with A = P from
//   registers (S's accumulator rounded to bf16 in place: its layout is the A
//   fragment's) and B = V read through a transposed (MN-major) descriptor, so
//   nothing is transposed on load. Value widths round up to 64 columns.
// - Softmax: exp2f with log2(e)/T folded into one FMA; row maxima and sums
//   across a lane quad by shuffles in a fixed order. No atomics: the result
//   is the same bits from run to run.
// - TMA descriptors are 3-D (channels, L, B) maps made on the host with
//   cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so the
//   library needs no -lcuda) and passed as __grid_constant__ parameters;
//   rows past L in a batch entry, and columns past C or Cv, read as zeros.
// Budget at C = 512: shared memory 128 KB (Q) + stages x 8 KB (K) + 2 x 8 KB
// x value chunks (V) + barriers: 224 KB at Cv = 256 (4 K stages), 208 KB at
// Cv = 192 (6), 192 KB at Cv <= 128 (8). A consumer thread holds Cv/2 float32
// accumulators (128 at Cv = 256), 32 for S and 16 registers of P.
//
// float32 inputs take a plain kernel of float32 FMAs (no TF32: products of
// bf16 values are exact in float32, TF32 would round them). It serves the
// float32 checks of the port and is not tuned.
//
// Kernels launch on the caller's stream and allocate nothing. ppst_corr_warp
// returns the first CUDA error of its launch (0 when it was accepted).

#include <math.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;       // query rows per bf16 block: two consumers x 64
constexpr int kKeys = 64;        // keys per tile
constexpr int kChunk = 64;       // channels or value columns per 128-byte swizzled row
constexpr int kMaxChunks = 8;    // channel chunks of Q: C <= 512
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kChunkBytes = kKeys * kChunk * 2;   // one K or V chunk: 8 KB
constexpr int kQChunkBytes = kRows * kChunk * 2;  // one Q chunk: 16 KB
constexpr int kQBytes = kMaxChunks * kQChunkBytes;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use on sm_90
constexpr int kAlign = 1024;      // 128B swizzle atoms: 8 rows x 128 bytes

// Shared-memory layout of the bf16 kernel for NVC value chunks (Cv <= 64 NVC)
template <int NVC>
struct Layout {
  static constexpr int kBarBytes = 256;
  static constexpr int kStagesFit =
      (kMaxSmem - kAlign - kBarBytes - kQBytes - 2 * NVC * kChunkBytes) / kChunkBytes;
  static constexpr int kStages = kStagesFit < 8 ? kStagesFit : 8;  // K ring
  static constexpr int kK = kQBytes;                                // K ring offset
  static constexpr int kV = kK + kStages * kChunkBytes;             // V stages offset
  static constexpr int kBar = kV + 2 * NVC * kChunkBytes;           // mbarriers
  static constexpr int kBytes = kBar + kBarBytes + kAlign;          // with the alignment slack
  static_assert(kStages >= 4, "K ring too shallow");
  static_assert(kBytes <= kMaxSmem, "shared memory over budget");
};

// grid (ceil(Lq / 128), B, ceil(Cv / 256)), kThreads threads, Layout<NVC>::kBytes
// of dynamic shared memory. Maps: q (C, Lq, B) with boxes of 64 x 128 x 1;
// k (C, Lk, B) and v (Cv, Lk, B) with boxes of 64 x 64 x 1; all 128B-swizzled.
template <int NVC>
__global__ void __launch_bounds__(kThreads, 1)
corr_warp_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int lq,
                      int lk, int c, int cv, float inv_t) {
  typedef Layout<NVC> L;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar = base + L::kBar;  // q, k full[S], k empty[S], v full[2], v empty[2]
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (3 + 2 * kStages + s); };

  const int b = blockIdx.y, q0 = blockIdx.x * kRows, cz = blockIdx.z * 4 * kChunk;
  const int nc = (c + kChunk - 1) / kChunk, nkt = (lk + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, nc * kQChunkBytes);
      for (int ch = 0; ch < nc; ++ch)
        tma_load(sq + ch * kQChunkBytes, &tm_q, ch * kChunk, q0, b, q_full);
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(v_empty(vs), vph ^ 1);
        mbar_expect_tx(v_full(vs), NVC * kChunkBytes);
        for (int j = 0; j < NVC; ++j)
          tma_load(sv + (vs * NVC + j) * kChunkBytes, &tm_v, cz + j * kChunk, kt * kKeys, b,
                   v_full(vs));
        if (++vs == 2) vs = 0, vph ^= 1;
        for (int ch = 0; ch < nc; ++ch) {
          mbar_wait(k_empty(ks), kph ^ 1);
          mbar_expect_tx(k_full(ks), kChunkBytes);
          tma_load(sk + ks * kChunkBytes, &tm_k, ch * kChunk, kt * kKeys, b, k_full(ks));
          if (++ks == kStages) ks = 0, kph ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint32_t sq_wg = sq + wg * 64 * 128;  // this warpgroup's rows of each Q chunk
    const float scale2 = inv_t * 1.4426950408889634f;  // log2(e) / T

    float o[NVC][32];
#pragma unroll
    for (int j = 0; j < NVC; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp's 16
    float l[2] = {0.f, 0.f};              // this lane's share of the row sums
    int ks = 0, vs = 0, kprev = 0;
    uint32_t kph = 0, vph = 0;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      // S = Q K^T over the channel chunks; each chunk is released once the
      // wgmmas that read it have retired
      for (int ch = 0; ch < nc; ++ch) {
        mbar_wait(k_full(ks), kph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, desc_k_major(sq_wg + ch * kQChunkBytes + kk * 32),
                   desc_k_major(sk + ks * kChunkBytes + kk * 32), ch | kk);
        wgmma_commit();
        if (ch > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(k_empty(kprev));
        }
        kprev = ks;
        if (++ks == kStages) ks = 0, kph ^= 1;
      }
      wgmma_wait<0>();
      fence_regs<32>(s);
      if (lane == 0) mbar_arrive(k_empty(kprev));

      // online softmax; a quad of lanes holds one row's 64 logits. Entry i is
      // row g + 8 ((i / 2) % 2), key 8 (i / 4) + 2 t + i % 2 of the tile.
      const int k0 = kt * kKeys;
      if (k0 + kKeys > lk) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + 8 * (i / 4) + 2 * t + (i % 2) >= lk) s[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float corr[2], ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f((m[h] - mx[h]) * scale2);  // 0 on the first tile (m = -inf)
        m[h] = mx[h];
        ms[h] = mx[h] * scale2;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(fmaf(s[i], scale2, -ms[(i / 2) % 2]));
        s[i] = p;
        l[(i / 2) % 2] += p;
      }
      // P rounded to bf16 as the A fragments of four k16 steps
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int j = 0; j < NVC; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i / 2) % 2];

      // O += P V
      mbar_wait(v_full(vs), vph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NVC; ++j)
          wgmma_rs(o[j], pa[kk],
                   desc_mn_major(sv + (vs * NVC + j) * kChunkBytes + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NVC; ++j) fence_regs<32>(o[j]);
      if (lane == 0) mbar_arrive(v_empty(vs));
      if (++vs == 2) vs = 0, vph ^= 1;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = q0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= lq) continue;
      bf16* orow = out + ((long)b * lq + row) * cv;
#pragma unroll
      for (int j = 0; j < NVC; ++j)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = cz + j * kChunk + 8 * n8 + 2 * t;  // cv is even: col + 1 < cv too
          if (col < cv)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                o[j][4 * n8 + 2 * h] / l[h], o[j][4 * n8 + 2 * h + 1] / l[h]);
        }
    }
  }
}

// float32: grid (ceil(Lq / 32), B, ceil(Cv / 256)), 256 threads. Thread t
// owns value column c0 + t of all 32 rows; S is taken 32 channels at a time.
constexpr int kFB = 32;      // query rows and keys per step
constexpr int kFC = 32;      // channels per step of S
constexpr int kFCv = 256;    // value columns per block
constexpr int kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
corr_warp_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int lq, int lk,
                     int c, int cv, float inv_t) {
  __shared__ float qs[kFB][kFC + 1], ks[kFB][kFC + 1], ps[kFB][kFB + 1];
  __shared__ float vs[kFB][kFCv];
  __shared__ float mrow[kFB], lrow[kFB], crow[kFB];

  const int b = blockIdx.y, q0 = blockIdx.x * kFB, c0 = blockIdx.z * kFCv;
  const int tid = threadIdx.x;
  const int r = tid / 8, j0 = tid % 8;  // S entries (r, j0 + 8 e), e < 4
  const float* qb = q + ((long)b * lq + q0) * c;
  const float* kb = k + (long)b * lk * c;
  const float* vb = v + (long)b * lk * cv;
  const int qvalid = min(kFB, lq - q0);

  if (tid < kFB) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[kFB];
#pragma unroll
  for (int i = 0; i < kFB; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kFB) {
    const int kvalid = min(kFB, lk - k0);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int cc = 0; cc < c; cc += kFC) {
      __syncthreads();
      for (int i = tid; i < kFB * kFC; i += kFThreads) {
        const int rr = i / kFC, ch = cc + i % kFC;
        qs[rr][i % kFC] = rr < qvalid && ch < c ? qb[(long)rr * c + ch] : 0.f;
        ks[rr][i % kFC] = rr < kvalid && ch < c ? kb[(long)(k0 + rr) * c + ch] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e)
        for (int x = 0; x < kFC; ++x) s[e] = fmaf(qs[r][x], ks[j0 + 8 * e][x], s[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ps[r][j0 + 8 * e] = j0 + 8 * e < kvalid ? s[e] * inv_t : -INFINITY;
    for (int i = tid; i < kFB * kFCv; i += kFThreads) {
      const int rr = i / kFCv, col = c0 + i % kFCv;
      vs[rr][i % kFCv] = rr < kvalid && col < cv ? vb[(long)(k0 + rr) * cv + col] : 0.f;
    }
    __syncthreads();
    if (tid < kFB) {  // one thread per row, keys in order
      float mx = mrow[tid];
      for (int j = 0; j < kFB; ++j) mx = fmaxf(mx, ps[tid][j]);
      const float cr = expf(mrow[tid] - mx);
      float sum = 0.f;
      for (int j = 0; j < kFB; ++j) {
        const float p = expf(ps[tid][j] - mx);
        ps[tid][j] = p;
        sum += p;
      }
      lrow[tid] = lrow[tid] * cr + sum;
      mrow[tid] = mx;
      crow[tid] = cr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFB; ++i) {
      float a = acc[i] * crow[i];
      for (int j = 0; j < kFB; ++j) a = fmaf(ps[i][j], vs[j][tid], a);
      acc[i] = a;
    }
  }
  const int col = c0 + tid;
  if (col < cv) {
    for (int i = 0; i < qvalid; ++i) out[((long)b * lq + q0 + i) * cv + col] = acc[i] / lrow[i];
  }
}

// A 3-D map of a contiguous bf16 tensor (batch, rows, inner) read in boxes of
// 64 x box_rows x 1, 128B-swizzled; out-of-range elements read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int rows, int batch, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NVC>
cudaError_t launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                        bf16* out, int batch, int lq, int lk, int c, int cv, float inv_t,
                        cudaStream_t s) {
  constexpr int smem = Layout<NVC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(corr_warp_bf16_kernel<NVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kRows - 1) / kRows, batch, (cv + 4 * kChunk - 1) / (4 * kChunk));
  corr_warp_bf16_kernel<NVC><<<grid, kThreads, smem, s>>>(tq, tk, tv, out, lq, lk, c, cv, inv_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = softmax(q k^T * inv_t) v per batch entry. dtype 0: float32, 1: bf16,
// for all of q (B, lq, c), k (B, lk, c), v (B, lk, cv) and out (B, lq, cv),
// contiguous device tensors. bf16 needs c % 8 == 0, c <= 512, cv % 8 == 0
// and 16-byte aligned pointers.
int ppst_corr_warp(const void* q, const void* k, const void* v, void* out, int dtype,
                   int batch, int lq, int lk, int c, int cv, float inv_t, void* stream) {
  if (batch < 1 || batch > 65535 || lq < 1 || lk < 1 || c < 1 || cv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((lq + kFB - 1) / kFB, batch, (cv + kFCv - 1) / kFCv);
    corr_warp_f32_kernel<<<grid, kFThreads, 0, s>>>((const float*)q, (const float*)k,
                                                    (const float*)v, (float*)out, lq, lk, c,
                                                    cv, inv_t);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || c % 8 || cv % 8 || c > kMaxChunks * kChunk) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, c, lq, batch, kRows) || !make_map(&tk, k, c, lk, batch, kKeys) ||
      !make_map(&tv, v, cv, lk, batch, kKeys))
    return (int)cudaErrorInvalidValue;
  bf16* ob = (bf16*)out;
  const int w = cv < 4 * kChunk ? cv : 4 * kChunk;  // value columns per block
  cudaError_t err;
  if (w <= kChunk)
    err = launch_bf16<1>(tq, tk, tv, ob, batch, lq, lk, c, cv, inv_t, s);
  else if (w <= 2 * kChunk)
    err = launch_bf16<2>(tq, tk, tv, ob, batch, lq, lk, c, cv, inv_t, s);
  else if (w <= 3 * kChunk)
    err = launch_bf16<3>(tq, tk, tv, ob, batch, lq, lk, c, cv, inv_t, s);
  else
    err = launch_bf16<4>(tq, tk, tv, ob, batch, lq, lk, c, cv, inv_t, s);
  return (int)err;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
