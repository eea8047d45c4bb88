// Fused StyledConv forward (K6) for Hopper (sm_90a):
//   pre = conv3x3(x, w) + gain * noise + b_total
//   a   = lrelu(pre, 0.2) * sqrt(2)                       stored as bf16
//   n   = (a - mean_hw(a)) * rsqrt(var_hw(a) + 1e-5)      one-pass float32 statistics
//   out = n * s1 + shift                                  s1 = style_scale + 1; bf16
// on x (B, H, W, Cin) bf16 NHWC, zero padding 1, into (B, H, W, Cout) bf16.
// The statistics are summed from the float32 a before it is rounded; the
// apply reads the stored bf16 a (the Pallas kernels round at the same points).
//
// Replaces the TPU kernel ppst_tpu/ops/styled_conv_pallas.py::_styled_conv_impl:
// _fwd_conv_kernel, _moments and _fwd_apply_kernel. ppst_conv3x3 runs the same
// conv without the epilogue; the backward's dx (the transposed conv) uses it.
//
// Bound: tensor-core operations at the generator's widths. A launch needs
// 2 B H W 9 Cin Cout operations and must move x, noise and the weights in and
// out once: at (8, 512, 512, 128 -> 128) 0.63 ms of bf16 products at 989
// TFLOP/s against 0.63 ms for 2.1 GB at 3.35 TB/s; at 512 channels the
// operations lead by 4x. The two-pass design writes a (bf16) and reads it back
// for the apply, 4 more bytes a pixel-channel (about 0.32 ms at that shape).
//
// Design: an implicit GEMM on wgmma (M = pixels, N = Cout, K = 9 taps x Cin),
// fed by TMA, warp-specialised, persistent.
// - A tile is 4 image rows x 64 columns (256 pixels, four 64-pixel row
//   segments) x 128 output channels. Blocks of three warpgroups walk the tiles
//   in a fixed stride (one block an SM). Warpgroup 0 is the producer:
//   setmaxnreg cuts it to 40 registers, one thread issues every TMA load.
//   Warpgroups 1 and 2 are consumers, raised to 232 registers; each owns two
//   row segments (two m64n128 accumulators, 128 float32 a thread).
// - Input: for each chunk of 64 input channels one TMA load brings the haloed
//   window of 6 x 66 pixels around the tile. The 9 taps read that one window;
//   x is staged once per chunk, not nine times. TMA zero-fills the rows and
//   columns -1, H and W and the channels past Cin, so x needs no padded copy.
// - The window's layout makes a one-pixel shift a legal wgmma start address:
//   no swizzle, shared memory [channel group of 8][window row][window column]
//   [8 channels], which a 5-D tensor map over x, dimensions (8, W, H, Cin / 8,
//   B), writes in one box. A segment's A operand is K-major: core matrices of 8
//   pixels x 8 channels (128 contiguous bytes), SBO 128 bytes between pixel
//   groups, LBO 6 x 66 x 16 = 6336 bytes between channel groups. Tap (dy, dx)
//   moves the start by (dy x 66 + dx) x 16 bytes, always 16-byte aligned. The
//   128-byte swizzle (8 pixels x 128 bytes an atom) cannot take a one-pixel
//   shift; the plain layout reads each core matrix as 128 contiguous bytes,
//   which touches every bank once.
// - Weights (9, Cout, Cin) bf16, K-major, come through a ring of 7 (tap,
//   64-channel) tiles of 64 x 128, 128B-swizzled. A tile of 256 pixels reads
//   256 operations per weight byte from L2.
// - Full and empty mbarriers pace both rings; a consumer releases a stage as
//   soon as the wgmma groups that read it have retired (wait_group 1).
// - Epilogue, in registers: gain * noise + b_total (both fetched before the
//   mainloop), leaky ReLU, sqrt(2). A wgmma accumulator gives a lane 2
//   channels of a pixel; stored as they lie, those 4-byte stores took a third
//   of the conv's time at 128 channels on an H100, so the bf16 pairs of 4
//   neighbouring 8-channel blocks are transposed across each lane quad and
//   every lane stores 16 contiguous bytes. The tile's per-channel sum and sum
//   of squares of the float32 a go to a (B, pixel tiles, 2, Cout) scratch:
//   over the thread's rows, across lanes by shuffles, then over the 8
//   consumer warps in order through shared memory. moments_kernel reduces
//   the tiles in a fixed order (32 strided partials a channel, then those in
//   order) into mean and rstd: no atomics, the same bits on every run.
//   apply_kernel writes out; a thread keeps 8 channels' statistics and style
//   in registers and walks pixels, 16 bytes of a and of out each.
// Budget: shared memory 2 x 50 KB (windows) + 7 x 16 KB (weights) + 8 KB
// (statistics) + barriers = 221 KB of 227. ptxas: 168 registers at launch (a
// consumer's 128 accumulators, biases and noise fit under its 232), no
// spills. Columns past W in a segment and rows past H in a tile are computed
// on zeros and not stored.
//
// Offsets into the activations are 64-bit: B H W C passes 2^31 at 1024px.
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_styled_conv_scratch_floats). The C
// functions return the first CUDA error of their launches (0 when all were
// accepted).

#include "styled_conv_common.cuh"

namespace {

constexpr int kTileRows = 4;                // image rows of a tile
constexpr int kSeg = 64;                    // pixels of a row segment (one wgmma's M)
constexpr int BN = 128;                     // output channels of a tile
constexpr int kChunk = 64;                  // input channels per window
constexpr int kWinRows = kTileRows + 2, kWinCols = kSeg + 2;
constexpr int kGroupBytes = kWinRows * kWinCols * 16;  // one channel group: LBO, 6336 bytes
constexpr int kWinBytes = 8 * kGroupBytes;             // 50688
constexpr int kWinStride = 51200;                      // window stages, 1024-aligned
constexpr int kWBytes = kChunk * BN * 2;               // one weight tile: 16 KB
constexpr int kWinStages = 2, kWStages = 7;
constexpr int kThreads = 384;
constexpr int kAlign = 1024;
constexpr long kApplyChunk = 1024;    // pixels of one apply block at most
constexpr long kApplyBlocks = 4 * 132;  // apply blocks to aim for at least: 4 an H100 SM
constexpr int kOffW = kWinStages * kWinStride;
constexpr int kOffRed = kOffW + kWStages * kWBytes;
constexpr int kOffBar = kOffRed + 8 * 2 * BN * 4;
constexpr int kSmem = kOffBar + 256 + kAlign;
static_assert(kSmem <= 232448, "shared memory over budget");

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A 4 x 4 transpose of 32-bit words across the 4 lanes t of a quad: word c of
// lane t becomes word t of lane c, by two exchanges (lanes t ^ 2, then t ^ 1).
// w[c] holds channels 8 c + 2 t, + 1 of 4 consecutive 8-channel blocks; after
// it lane t holds the 8 channels of block t in order, 16 contiguous bytes.
__device__ __forceinline__ void quad_transpose(uint32_t* w, int t) {
  const bool a = t & 2, b = t & 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, a ? w[k] : w[2 + k], 2);
    if (a) w[k] = r; else w[2 + k] = r;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b ? w[2 * k] : w[2 * k + 1], 1);
    if (b) w[2 * k] = r; else w[2 * k + 1] = r;
  }
}

// out[b, p, n] = sum_tap sum_k in[b, p + d(tap), k] wt[tap, n, k] over the
// 3x3 neighbourhood d(tap) = (tap / 3 - 1, tap % 3 - 1) of pixel p, zero
// outside the image; tm_x maps in (B, H, W, K) as (8, W, H, K / 8, B) with
// boxes of 8 x 66 x 6 x 8 x 1, tm_w maps wt (9, N, K) as (K, N, 9) with boxes
// of 64 x 128 x 1 (128B-swizzled). out (B, H, W, N) bf16.
// EPI: out = bf16(a), a = lrelu(acc + gain noise[b, p] + bias[n]) sqrt(2),
// and pstats (B, pixel tiles, 2, N) the tile's sums of a and a^2.
// grid: at most one block an SM, each walking the tiles t = blockIdx.x +
// i gridDim.x of (B, H / 4, W / 64, N / 128), N fastest.
template <bool EPI>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const bf16* __restrict__ noise, const float* __restrict__ gain,
               const float* __restrict__ bias, bf16* __restrict__ out,
               float* __restrict__ pstats, int batch, int H, int W, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  float* red = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)) + kOffRed);
  const uint32_t bar = base + kOffBar;  // x full[2], x empty[2], w full[7], w empty[7]
  auto x_full = [&](int s) { return bar + 8 * s; };
  auto x_empty = [&](int s) { return bar + 8 * (kWinStages + s); };
  auto w_full = [&](int s) { return bar + 8 * (2 * kWinStages + s); };
  auto w_empty = [&](int s) { return bar + 8 * (2 * kWinStages + kWStages + s); };

  const int tiles_w = (W + kSeg - 1) / kSeg, tiles_h = (H + kTileRows - 1) / kTileRows;
  const int tiles_n = (N + BN - 1) / BN;
  const long tiles = (long)batch * tiles_h * tiles_w * tiles_n;
  const int nc = (K + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWinStages; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int xs = 0, ws = 0;
      uint32_t xph = 0, wph = 0;
      for (long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (int)(t % tiles_n) * BN;
        const long p = t / tiles_n;
        const int col0 = (int)(p % tiles_w) * kSeg;
        const int row0 = (int)((p / tiles_w) % tiles_h) * kTileRows;
        const int b = (int)(p / ((long)tiles_w * tiles_h));
        for (int ch = 0; ch < nc; ++ch) {
          mbar_wait(x_empty(xs), xph ^ 1);
          mbar_expect_tx(x_full(xs), kWinBytes);
          tma_load5(base + xs * kWinStride, &tm_x, 0, col0 - 1, row0 - 1, ch * (kChunk / 8), b,
                    x_full(xs));
          if (++xs == kWinStages) xs = 0, xph ^= 1;
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(w_empty(ws), wph ^ 1);
            mbar_expect_tx(w_full(ws), kWBytes);
            tma_load(base + kOffW + ws * kWBytes, &tm_w, ch * kChunk, n0, tap, w_full(ws));
            if (++ws == kWStages) ws = 0, wph ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: two row segments each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    int xs = 0, ws = 0;
    uint32_t xph = 0, wph = 0;

    for (long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (int)(t % tiles_n) * BN;
      const long p = t / tiles_n;
      const int tw = (int)(p % tiles_w), th = (int)((p / tiles_w) % tiles_h);
      const int b = (int)(p / ((long)tiles_w * tiles_h));
      const int col0 = tw * kSeg, row0 = th * kTileRows;

      // the epilogue's pixels, noise and biases, fetched before the mainloop:
      // in segment s, pixels (row0 + 2 wg + s, col0 + 16 warp + g + 8 h);
      // channels n0 + 8 j + 2 t4 + e
      bool ok[2][2];
      long pix[2][2];
      float nz[2][2], bs[16][2];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 2 * wg + s, c = col0 + 16 * warp + g + 8 * h;
          ok[s][h] = r < H && c < W;
          pix[s][h] = ((long)b * H + r) * W + c;
          nz[s][h] = EPI && ok[s][h] ? __bfloat162float(noise[pix[s][h]]) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t4;  // N is even: n + 1 < N too
        bs[j][0] = EPI && n < N ? bias[n] : 0.f;
        bs[j][1] = EPI && n < N ? bias[n + 1] : 0.f;
      }

      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
      int pend_w = -1, pend_x = -1;  // stages the last committed group read
      for (int ch = 0; ch < nc; ++ch) {
        mbar_wait(x_full(xs), xph);
        const uint32_t win = base + xs * kWinStride;
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          mbar_wait(w_full(ws), wph);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db = desc_k_major(base + kOffW + ws * kWBytes + kk * 32);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const int r = 2 * wg + s + dy;  // window row of the segment's tap
              const uint64_t da = desc_plain(
                  win + 2 * kk * kGroupBytes + (r * kWinCols + dx) * 16, kGroupBytes, 128);
              wgmma_n128<0, 0>(acc[s], da, db, (ch | tap | kk) != 0);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (lane == 0) {
            if (pend_w >= 0) mbar_arrive(w_empty(pend_w));
            if (pend_x >= 0) mbar_arrive(x_empty(pend_x));
          }
          pend_w = ws;
          pend_x = tap == 8 ? xs : -1;
          if (++ws == kWStages) ws = 0, wph ^= 1;
        }
        if (++xs == kWinStages) xs = 0, xph ^= 1;
      }
      wgmma_wait<0>();
      fence_regs<64>(acc[0]);
      fence_regs<64>(acc[1]);
      if (lane == 0) {
        mbar_arrive(w_empty(pend_w));
        mbar_arrive(x_empty(pend_x));
      }

      // epilogue: acc[s][4 j + 2 h + e] is channel n0 + 8 j + 2 t4 + e of
      // pixel pix[s][h]. Blocks of 4 j at a time: the bf16 pairs go through a
      // quad transpose, so that each lane stores 16 contiguous bytes.
      const float gn = EPI ? *gain : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t wd[2][2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj;
          float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                v[e] = acc[s][4 * j + 2 * h + e];
                if constexpr (EPI) {
                  const float pre = v[e] + gn * nz[s][h] + bs[j][e];
                  v[e] = (pre >= 0.f ? pre : pre * kSlope) * kSqrt2;
                  if (ok[s][h]) sum[e] += v[e], sq[e] += v[e] * v[e];
                }
              }
              wd[s][h][jj] = pack_bf16(v[0], v[1]);
            }
          if constexpr (EPI) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o);
                sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], o);
              }
            if (g == 0) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                red[((wg * 4 + warp) * 2 + 0) * BN + 8 * j + 2 * t4 + e] = sum[e];
                red[((wg * 4 + warp) * 2 + 1) * BN + 8 * j + 2 * t4 + e] = sq[e];
              }
            }
          }
        }
        const int n = n0 + 8 * (4 * q + t4);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            quad_transpose(wd[s][h], t4);
            if (ok[s][h] && n < N)
              *reinterpret_cast<uint4*>(out + pix[s][h] * N + n) =
                  make_uint4(wd[s][h][0], wd[s][h][1], wd[s][h][2], wd[s][h][3]);
          }
      }
      if constexpr (EPI) {
        // the tile's sums over the 8 consumer warps, in order
        consumer_sync();
        const int ct = threadIdx.x - 128, n = n0 + ct;
        if (ct < BN && n < N) {
          float s = 0.f, q = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            s += red[(i * 2 + 0) * BN + ct];
            q += red[(i * 2 + 1) * BN + ct];
          }
          float* ps = pstats + ((long)b * tiles_h * tiles_w + (long)th * tiles_w + tw) * 2 * N + n;
          ps[0] = s;
          ps[N] = q;
        }
        consumer_sync();  // red is free for the next tile
      }
    }
  }
}

// mean and rstd (B, N) from pstats (B, tiles, 2, N), as ppst_tpu's _moments:
// var = max(E[a^2] - E[a]^2, 0). grid (ceil(N / 32), B), block (32, 32):
// thread (c, y) sums the tiles y, y + 32, ... of channel c in order, then the
// 32 partials are summed in order (a fixed order: the same bits every run).
__global__ void __launch_bounds__(1024)
moments_kernel(const float* __restrict__ pstats, float* __restrict__ mean,
               float* __restrict__ rstd, int tiles, int N, float count) {
  __shared__ float red[2][32][33];
  const int c = blockIdx.x * 32 + threadIdx.x, b = blockIdx.y, y = threadIdx.y;
  float s = 0.f, q = 0.f;
  if (c < N) {
    const float* p = pstats + (long)b * tiles * 2 * N + c;
    for (int t = y; t < tiles; t += 32) {
      s += p[(long)t * 2 * N];
      q += p[(long)t * 2 * N + N];
    }
  }
  red[0][y][threadIdx.x] = s;
  red[1][y][threadIdx.x] = q;
  __syncthreads();
  if (y != 0 || c >= N) return;
  s = q = 0.f;
  for (int i = 0; i < 32; ++i) {
    s += red[0][i][threadIdx.x];
    q += red[1][i][threadIdx.x];
  }
  const float m = s / count;
  const float var = fmaxf(q / count - m * m, 0.f);
  mean[(long)b * N + c] = m;
  rstd[(long)b * N + c] = 1.f / sqrtf(var + kEps);
}

// out = ((a - mean) rstd) s1 + shift; mean, rstd, s1 and shift (B, N)
// float32. grid (pixel chunks, B), block (N / 8, ry): thread x keeps channels
// 8x .. 8x + 7 of its sample in registers and walks the chunk's pixels
// y, y + ry, ..., 16 bytes of a and of out a pixel.
__global__ void __launch_bounds__(256)
apply_kernel(const bf16* __restrict__ a, const float* __restrict__ mean,
             const float* __restrict__ rstd, const float* __restrict__ s1,
             const float* __restrict__ shift, bf16* __restrict__ out, long hw, int N, int chunk) {
  const int b = blockIdx.y, c0 = threadIdx.x * 8;
  float m[8], r[8], sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long o = (long)b * N + c0 + j;
    m[j] = mean[o];
    r[j] = rstd[o];
    sc[j] = s1[o];
    sh[j] = shift[o];
  }
  const long p0 = (long)blockIdx.x * chunk, p1 = p0 + chunk < hw ? p0 + chunk : hw;
  for (long p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
    const long e = ((long)b * hw + p) * N + c0;
    float f[8];
    load8(a + e, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = ((f[j] - m[j]) * r[j]) * sc[j] + sh[j];
    store8(out + e, f);
  }
}

long pixel_tiles(int h, int w) {
  return (long)((h + kTileRows - 1) / kTileRows) * ((w + kSeg - 1) / kSeg);
}

// The wrapper's checks (ops/styled_conv_cuda.py::check_shapes), again.
bool shape_ok(int batch, int h, int w, int k, int n) {
  return batch >= 1 && batch <= 65535 && h >= 1 && w >= 1 && (long)h * w <= (1L << 30) &&
         k >= 16 && k % 16 == 0 && n >= 16 && n % 16 == 0 &&
         (long)h * w * (k > n ? k : n) * 2 < (1L << 40);
}

template <bool EPI>
cudaError_t launch_conv(const bf16* in, const bf16* wt, const bf16* noise, const float* gain,
                        const float* bias, bf16* out, float* pstats, int batch, int h, int w,
                        int k, int n, cudaStream_t st) {
  // x as (8, W, H, K / 8, B): shared memory [channel group][row][column][8]
  const cuuint64_t xdims[5] = {8, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)k / 8,
                               (cuuint64_t)batch};
  const cuuint64_t xstrides[4] = {(cuuint64_t)k * 2, (cuuint64_t)w * k * 2, 16,
                                  (cuuint64_t)h * w * k * 2};
  const cuuint32_t xbox[5] = {8, kWinCols, kWinRows, kChunk / 8, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)k, (cuuint64_t)n, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)k * 2, (cuuint64_t)k * n * 2};
  const cuuint32_t wbox[3] = {kChunk, BN, 1};
  CUtensorMap tm_x, tm_w;
  if (!encode_bf16_map(&tm_x, in, 5, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_bf16_map(&tm_w, wt, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long tiles = pixel_tiles(h, w) * ((n + BN - 1) / BN);  // per image
  const long blocks = tiles * batch < sms ? tiles * batch : sms;
  conv3x3_kernel<EPI><<<(unsigned)blocks, kThreads, kSmem, st>>>(tm_x, tm_w, noise, gain, bias,
                                                                  out, pstats, batch, h, w, k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch ppst_styled_conv_fwd needs: the per-tile partial sums.
long ppst_styled_conv_scratch_floats(int batch, int h, int w, int cout) {
  return (long)batch * pixel_tiles(h, w) * 2 * cout;
}

// The forward. x (B, H, W, Cin) bf16; wt (9, Cout, Cin) bf16, wt[kh*3 + kw, o, i]
// = w[o, i, kh, kw]; noise (B, H, W) bf16; gain (1,), b_total (Cout,), s1 and
// shift (B, Cout) float32. Outputs: a and out (B, H, W, Cout) bf16, mean and
// rstd (B, Cout) float32. Cin and Cout multiples of 16, Cout <= 2048. Device
// pointers of contiguous tensors, 16-byte aligned.
int ppst_styled_conv_fwd(const void* x, const void* wt, const void* noise, const void* gain,
                         const void* b_total, const void* s1, const void* shift, void* a,
                         void* out, void* mean, void* rstd, void* scratch, int batch, int h,
                         int w, int cin, int cout, void* stream) {
  if (!shape_ok(batch, h, w, cin, cout) || cout > 2048) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_conv<true>((const bf16*)x, (const bf16*)wt, (const bf16*)noise,
                                      (const float*)gain, (const float*)b_total, (bf16*)a,
                                      (float*)scratch, batch, h, w, cin, cout, st);
  if (err != cudaSuccess) return (int)err;
  moments_kernel<<<dim3((cout + 31) / 32, batch), dim3(32, 32), 0, st>>>(
      (const float*)scratch, (float*)mean, (float*)rstd, (int)pixel_tiles(h, w), cout,
      (float)((long)h * w));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long hw = (long)h * w;
  const int cg = cout / 8, ry = cg >= 256 ? 1 : 256 / cg;
  // chunks small enough for kApplyBlocks blocks (64x64 heads give 32 blocks
  // of 1024 pixels), but no fewer pixels than a block has rows of threads
  long chunk = (batch * hw + kApplyBlocks - 1) / kApplyBlocks;
  chunk = chunk > kApplyChunk ? kApplyChunk : chunk < ry ? ry : chunk;
  apply_kernel<<<dim3((unsigned)((hw + chunk - 1) / chunk), batch), dim3(cg, ry), 0, st>>>(
      (const bf16*)a, (const float*)mean, (const float*)rstd, (const float*)s1,
      (const float*)shift, (bf16*)out, hw, cout, (int)chunk);
  return (int)cudaGetLastError();
}

// The plain 3x3 conv with zero padding 1: out (B, H, W, N) = bf16 of the
// float32 sums over in (B, H, W, K) and wt (9, N, K), bf16. The backward's dx.
int ppst_conv3x3(const void* in, const void* wt, void* out, int batch, int h, int w, int k,
                 int n, void* stream) {
  if (!shape_ok(batch, h, w, k, n)) return (int)cudaErrorInvalidValue;
  return (int)launch_conv<false>((const bf16*)in, (const bf16*)wt, nullptr, nullptr, nullptr,
                                 (bf16*)out, nullptr, batch, h, w, k, n, (cudaStream_t)stream);
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
