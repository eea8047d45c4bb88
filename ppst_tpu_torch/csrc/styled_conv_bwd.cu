// Backward of the fused StyledConv (K6) for Hopper (sm_90a).
//
// Forward (csrc/styled_conv.cu), per sample and channel over N = H W pixels:
//   pre = conv3x3(x, w) + gain noise + b_total;  a = bf16(lrelu(pre, 0.2) sqrt(2))
//   n = (a - m) r;  out = n s1 + shift
// Given the output's cotangent g:
//   pass 1  per (b, c): S1 = sum dn, S2 = sum dn n with dn = g s1;
//           dstyle_scale = sum g n; dstyle_shift = sum g
//   pass 2  dpre = r (dn - S1/N - n S2/N) sqrt(2) (a >= 0 ? 1 : 0.2), stored bf16;
//           db_total = sum dpre and dgain = sum dpre noise, from the float32 dpre
//   dx      the transposed conv: dpre correlated with the spatially flipped,
//           in/out-transposed kernel; the wrapper runs styled_conv.cu's
//           ppst_conv3x3 for it (the forward's conv without its epilogue)
//   dW      dW[kh, kw, i, o] = sum_p x[p + (kh - 1, kw - 1), i] dpre[p, o],
//           returned in float32, PyTorch's (Cout, Cin, 3, 3) layout
// n is recomputed from the stored bf16 a, and the leaky ReLU's slope reads
// a >= 0, as the Pallas kernels do.
//
// Replaces the TPU kernel ppst_tpu/ops/styled_conv_pallas.py::_styled_conv_bwd:
// _bwd_stats_kernel, _bwd_dpre_kernel, _bwd_dx_kernel and _bwd_dw_kernel.
// Unlike that kernel, dW keeps the weight's float32 (ROADMAP W1).
//
// Bound: tensor-core operations. dx and dW are 4 B H W 9 Cin Cout of them,
// twice the forward's; the bytes are x, a and g read and dx written once.
// At (8, 512, 512, 128 -> 128): 1.25 ms of products at 989 TFLOP/s, 0.63 ms
// of bytes at 3.35 TB/s.
//
// Design. Passes 1 and 2 are elementwise: a block owns a chunk of one
// sample's pixels, a thread 8 channels (16-byte loads) of every ry-th row;
// the block's partial sums go to scratch and group_sum_kernel reduces them in
// a fixed order.
//
// dW is a GEMM per tap, M = Cin, N = Cout, K = pixels of all samples, on
// wgmma fed by TMA, warp-specialised like the forward (styled_conv.cu). A
// block owns 128 input x 128 output channels, one kernel row dy (its three
// taps dx = 0, 1, 2) and a slice of the pixels, walked in 64-pixel row
// segments. Each segment brings, by TMA, the dpre tile (64 pixels x 128
// output channels, 128B-swizzled) and the haloed x window of the same
// forward's layout: one image row (row + dy - 1), 66 columns, 128 channels,
// shared memory [channel group of 8][column][8 channels], zero-filled past the
// image. That window, read transposed, is wgmma's A (x^T, channels x pixels)
// for all three taps: MN-major with no swizzle, core matrices of 8 pixels x 8
// channels, LBO 128 bytes between pixel groups (K), SBO 66 x 16 = 1056 bytes
// between channel groups (M); tap dx moves the start by dx x 16 bytes. dpre
// is B, MN-major, two 64-channel atoms 8 KB apart (LBO), 8-pixel groups 1024
// bytes apart (SBO). So each dpre tile and x window fetched once serves three
// taps and both consumer warpgroups (64 input channels each, 3 x 64 float32
// accumulators a thread, under the 240 registers setmaxnreg gives it; ptxas:
// 168 at launch, no spills). The producer warpgroup (24 registers) keeps a
// ring of 6 stages (33 KB each, 199 KB) in flight. Each block writes its float32 partial dW, and
// dw_reduce_kernel sums the slices in order. The scratch stays within 64 Mi
// floats (256 MB) for any shape; at the generator's 512px shapes it is 105 MB
// or less. No atomics anywhere: the gradients are the same bits on every run.
// The bf16 products of x and dpre are exact in float32, as in the Pallas
// kernel's float32 dot.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_styled_conv_bwd_scratch_floats).
// ppst_styled_conv_bwd runs passes 1-2, dW or both, and returns the first
// CUDA error of its launches.

#include "styled_conv_common.cuh"

namespace {

constexpr int kEwThreads = 256;
constexpr int kMaxChunks = 256;  // pixel chunks per sample in passes 1 and 2
// dW: 128 input x 128 output channels x one kernel row a block, steps of one
// 64-pixel row segment
constexpr int kDwM = 128, kDwN = 128, kDwSeg = 64;
constexpr int kDwWinCols = kDwSeg + 2;
constexpr int kDwGroupBytes = kDwWinCols * 16;       // SBO of A: 1056 bytes
constexpr int kDwWinBytes = (kDwM / 8) * kDwGroupBytes;  // 16896
constexpr int kDwDBytes = kDwSeg * kDwN * 2;            // dpre tile: 16 KB
constexpr int kDwStage = 33792;                          // dpre + window, 1024-aligned
constexpr int kDwStages = 6, kDwThreads = 384, kAlign = 1024;
constexpr int kDwSmem = kDwStages * kDwStage + 256 + kAlign;
static_assert(kDwDBytes + kDwWinBytes <= kDwStage, "dW stage too small");
static_assert(kDwSmem <= 232448, "shared memory over budget");
constexpr long kMaxDwScratch = 64L << 20;  // floats
constexpr int kTargetBlocks = 4 * 132;     // dW blocks to aim for: 4 waves of an H100

struct Chunks {
  int size, count;
};

Chunks pixel_chunks(long hw) {
  long size = (hw + kMaxChunks - 1) / kMaxChunks;
  if (size < 128) size = 128;
  return {(int)size, (int)((hw + size - 1) / size)};
}

struct DwGrid {
  int units, slices, per;  // units: (Cin tile, Cout tile, kernel row); per: steps a slice
  long steps;
};

DwGrid dw_grid(int batch, int h, int w, int cin, int cout) {
  DwGrid d;
  d.units = (cin + kDwM - 1) / kDwM * ((cout + kDwN - 1) / kDwN) * 3;
  d.steps = (long)batch * h * ((w + kDwSeg - 1) / kDwSeg);
  long s = (kTargetBlocks + d.units - 1) / d.units;
  const long cap = kMaxDwScratch / (9L * cin * cout);
  if (s > cap) s = cap;
  if (s > d.steps) s = d.steps;
  if (s < 1) s = 1;
  d.per = (int)((d.steps + s - 1) / s);
  d.slices = (int)((d.steps + d.per - 1) / d.per);
  return d;
}

struct Scratch {
  float *pstats, *pdb, *pdg, *pdw;
  long total;
};

Scratch scratch_layout(float* base, int batch, int h, int w, int cin, int cout) {
  const long hw = (long)h * w;
  const Chunks ch = pixel_chunks(hw);
  const DwGrid d = dw_grid(batch, h, w, cin, cout);
  const long blocks = (long)batch * ch.count;
  Scratch s;
  long o = 0;
  auto take = [&](long count) {
    float* p = base ? base + o : nullptr;
    o += (count + 3) / 4 * 4;  // keep every buffer 16-byte aligned
    return p;
  };
  s.pstats = take(blocks * 4 * cout);
  s.pdb = take(blocks * cout);
  s.pdg = take(blocks);
  s.pdw = take((long)d.slices * 9 * cin * cout);
  s.total = o;
  return s;
}

// Fixed-order sum over the block's ry rows of threads of v[0..8) per thread,
// written to out[c0 .. c0 + 8) by the threads of row 0. red holds ry * N floats.
__device__ __forceinline__ void reduce_rows(const float* v, float* red, float* out, int N) {
  const int c0 = threadIdx.x * 8, ty = threadIdx.y, ry = blockDim.y;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty * N + c0 + j] = v[j];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = 0.f;
      for (int i = 0; i < ry; ++i) s += red[i * N + c0 + j];
      out[c0 + j] = s;
    }
  }
  __syncthreads();
}

// Pass 1. grid (chunks, B), block (N / 8, ry). part (B, chunks, 4, N):
// sums of dn, dn n, g n and g over the chunk.
__global__ void __launch_bounds__(kEwThreads)
stats_kernel(const bf16* __restrict__ a, const bf16* __restrict__ g,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ s1, float* __restrict__ part, long hw, int N, int chunk) {
  extern __shared__ float red[];
  const int b = blockIdx.y, ck = blockIdx.x, c0 = threadIdx.x * 8;
  float m[8], r[8], s[8], acc[4][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = mean[(long)b * N + c0 + j];
    r[j] = rstd[(long)b * N + c0 + j];
    s[j] = s1[(long)b * N + c0 + j];
    acc[0][j] = acc[1][j] = acc[2][j] = acc[3][j] = 0.f;
  }
  const long p0 = (long)ck * chunk, p1 = p0 + chunk < hw ? p0 + chunk : hw;
  for (long p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
    const long off = ((long)b * hw + p) * N + c0;
    float af[8], gf[8];
    load8(a + off, af);
    load8(g + off, gf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float n = (af[j] - m[j]) * r[j];
      const float dn = gf[j] * s[j];
      acc[0][j] += dn;
      acc[1][j] += dn * n;
      acc[2][j] += gf[j] * n;
      acc[3][j] += gf[j];
    }
  }
  float* out = part + ((long)b * gridDim.x + ck) * 4 * N;
#pragma unroll
  for (int q = 0; q < 4; ++q) reduce_rows(acc[q], red, out + q * N, N);
}

// Pass 2. grid (chunks, B), block (N / 8, ry). sums (B, 4, N) from pass 1.
// Writes dpre (B, H, W, N) bf16, pdb (B, chunks, N) and pdg (B, chunks).
__global__ void __launch_bounds__(kEwThreads)
dpre_kernel(const bf16* __restrict__ a, const bf16* __restrict__ g,
            const bf16* __restrict__ noise, const float* __restrict__ mean,
            const float* __restrict__ rstd, const float* __restrict__ s1,
            const float* __restrict__ sums, float inv_n, bf16* __restrict__ dpre,
            float* __restrict__ pdb, float* __restrict__ pdg, long hw, int N, int chunk) {
  extern __shared__ float red[];
  const int b = blockIdx.y, ck = blockIdx.x, c0 = threadIdx.x * 8;
  float m[8], r[8], s[8], u1[8], u2[8], db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long o = (long)b * N + c0 + j;
    m[j] = mean[o];
    r[j] = rstd[o];
    s[j] = s1[o];
    u1[j] = sums[(long)b * 4 * N + c0 + j] * inv_n;
    u2[j] = sums[(long)b * 4 * N + N + c0 + j] * inv_n;
    db[j] = 0.f;
  }
  float dg = 0.f;
  const long p0 = (long)ck * chunk, p1 = p0 + chunk < hw ? p0 + chunk : hw;
  for (long p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
    const long off = ((long)b * hw + p) * N + c0;
    const float nz = __bfloat162float(noise[(long)b * hw + p]);
    float af[8], gf[8], d[8];
    load8(a + off, af);
    load8(g + off, gf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float n = (af[j] - m[j]) * r[j];
      const float dn = gf[j] * s[j];
      const float da = r[j] * (dn - u1[j] - n * u2[j]);
      d[j] = da * kSqrt2 * (af[j] >= 0.f ? 1.f : kSlope);
      db[j] += d[j];
      dg += d[j] * nz;
    }
    store8(dpre + off, d);
  }
  const long id = (long)b * gridDim.x + ck;
  reduce_rows(db, red, pdb + id * N, N);
  // dgain: every thread's sum, in thread order
  const int t = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  red[t] = dg;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int i = 0; i < nt; ++i) s += red[i];
    pdg[id] = s;
  }
}

// dW partials. grid (units, slices): unit (Cin tile, Cout tile, kernel row
// dy), the slice's steps q = (b, row, segment) of 64 pixels. tm_x maps x
// (B, H, W, Cin) as (8, W, H, Cin / 8, B) with boxes of 8 x 66 x 1 x 16 x 1;
// tm_d maps dpre (B, H, W, Cout) as (Cout, W, H, B) with boxes of 64 x 64 x
// 1 x 1 (128B-swizzled). pdw (slices, 9, Cin, Cout).
__global__ void __launch_bounds__(kDwThreads, 1)
dw_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_d,
          float* __restrict__ pdw, int H, int W, int cin, int cout, long steps, int per) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t bar = base + kDwStages * kDwStage;  // full[6], empty[6]
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kDwStages + s); };

  const int ntiles = (cout + kDwN - 1) / kDwN, segs = (W + kDwSeg - 1) / kDwSeg;
  const int dy = blockIdx.x % 3, nt = (blockIdx.x / 3) % ntiles, mt = blockIdx.x / 3 / ntiles;
  const long q0 = (long)blockIdx.y * per;
  const int count = (int)(q0 + per < steps ? per : steps - q0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int cs = (int)(q0 % segs), r = (int)((q0 / segs) % H), b = (int)(q0 / segs / H);
      int st = 0;
      uint32_t ph = 0;
      for (int i = 0; i < count; ++i) {
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t dst = base + st * kDwStage;
        mbar_expect_tx(full(st), kDwDBytes + kDwWinBytes);
        tma_load4(dst, &tm_d, nt * kDwN, cs * kDwSeg, r, b, full(st));
        tma_load4(dst + kDwDBytes / 2, &tm_d, nt * kDwN + 64, cs * kDwSeg, r, b, full(st));
        tma_load5(dst + kDwDBytes, &tm_x, 0, cs * kDwSeg - 1, r + dy - 1, mt * (kDwM / 8), b,
                  full(st));
        if (++st == kDwStages) st = 0, ph ^= 1;
        if (++cs == segs) {
          cs = 0;
          if (++r == H) r = 0, ++b;
        }
      }
    }
  } else {
    // consumer warpgroups: 64 input channels each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    float acc[3][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = acc[2][i] = 0.f;
    int st = 0, prev = -1;
    uint32_t ph = 0;
    for (int i = 0; i < count; ++i) {
      mbar_wait(full(st), ph);
      const uint32_t dp = base + st * kDwStage;
      const uint32_t win = dp + kDwDBytes + wg * 8 * kDwGroupBytes;
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n128<1, 1>(acc[dx], desc_plain(win + (16 * kk + dx) * 16, 128, kDwGroupBytes),
                           desc_b128(dp + kk * 2048, kDwDBytes / 2, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0 && prev >= 0) mbar_arrive(empty(prev));
      prev = st;
      if (++st == kDwStages) st = 0, ph ^= 1;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) fence_regs<64>(acc[dx]);
    if (lane == 0 && prev >= 0) mbar_arrive(empty(prev));

    // acc[dx][4 j + 2 h + e]: input channel 16 warp + g + 8 h of the
    // warpgroup's 64, output channel 8 j + 2 t4 + e of the tile's 128
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float* out = pdw + ((long)blockIdx.y * 9 + dy * 3 + dx) * cin * cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = mt * kDwM + wg * 64 + 16 * warp + g + 8 * h;
        if (ci >= cin) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int co = nt * kDwN + 8 * j + 2 * t4;
          if (co < cout)
            *reinterpret_cast<float2*>(out + (long)ci * cout + co) =
                make_float2(acc[dx][4 * j + 2 * h], acc[dx][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// dw[o, i, tap] = sum over slices s in order of pdw[s, tap, i, o].
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ pdw, float* __restrict__ dw, int slices, int cin,
                 int cout) {
  const long len = 9L * cin * cout;
  const long idx = blockIdx.x * 256L + threadIdx.x;  // (tap, i, o)
  if (idx >= len) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += pdw[(long)k * len + idx];
  const int tap = (int)(idx / ((long)cin * cout));
  const long io = idx - (long)tap * cin * cout;
  const int i = (int)(io / cout), o = (int)(io - (long)i * cout);
  dw[((long)o * cin + i) * 9 + tap] = s;
}

// The wrapper's checks (ops/styled_conv_cuda.py::check_shapes), again.
bool shape_ok(int batch, int h, int w, int cin, int cout) {
  return batch >= 1 && batch <= 65535 && h >= 1 && w >= 1 && (long)h * w <= (1L << 30) &&
         cin >= 16 && cin % 16 == 0 && cout >= 16 && cout % 16 == 0 && cout <= 2048 &&
         9L * cin * cout <= kMaxDwScratch &&
         (long)h * w * (cin > cout ? cin : cout) * 2 < (1L << 40);
}

cudaError_t launch_dw(const bf16* x, const bf16* dpre, float* pdw, float* dw, int batch, int h,
                      int w, int cin, int cout, cudaStream_t st) {
  const DwGrid d = dw_grid(batch, h, w, cin, cout);
  const cuuint64_t xdims[5] = {8, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)cin / 8,
                               (cuuint64_t)batch};
  const cuuint64_t xstrides[4] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2, 16,
                                  (cuuint64_t)h * w * cin * 2};
  const cuuint32_t xbox[5] = {8, kDwWinCols, 1, kDwM / 8, 1};
  const cuuint64_t ddims[4] = {(cuuint64_t)cout, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t dstrides[3] = {(cuuint64_t)cout * 2, (cuuint64_t)w * cout * 2,
                                  (cuuint64_t)h * w * cout * 2};
  const cuuint32_t dbox[4] = {64, kDwSeg, 1, 1};
  CUtensorMap tm_x, tm_d;
  if (!encode_bf16_map(&tm_x, x, 5, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_bf16_map(&tm_d, dpre, 4, ddims, dstrides, dbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return err;
  dw_kernel<<<dim3(d.units, d.slices), kDwThreads, kDwSmem, st>>>(tm_x, tm_d, pdw, h, w, cin,
                                                                  cout, d.steps, d.per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long len = 9L * cin * cout;
  dw_reduce_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(pdw, dw, d.slices, cin, cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch ppst_styled_conv_bwd needs.
long ppst_styled_conv_bwd_scratch_floats(int batch, int h, int w, int cin, int cout) {
  return scratch_layout(nullptr, batch, h, w, cin, cout).total;
}

// The backward, but for dx. x (B, H, W, Cin), a and g (B, H, W, Cout), noise
// (B, H, W) bf16; mean, rstd and s1 (B, Cout) float32. Outputs: dpre
// (B, H, W, Cout) bf16 (the input of the dx conv), sums (B, 4, Cout) float32
// (rows 2 and 3 are dstyle_scale and dstyle_shift), db (Cout,), dgain (1,)
// and dw (Cout, Cin, 3, 3) float32. scratch holds
// ppst_styled_conv_bwd_scratch_floats(...) floats. parts: 1 runs passes 1-2
// (dpre, sums, db, dgain), 2 dW from x and dpre, 3 both. Device pointers of
// contiguous tensors, 16-byte aligned.
int ppst_styled_conv_bwd(const void* x, const void* a, const void* g, const void* noise,
                         const void* mean, const void* rstd, const void* s1, void* dpre,
                         void* sums, void* db, void* dgain, void* dw, void* scratch, int batch,
                         int h, int w, int cin, int cout, int parts, void* stream) {
  if (!shape_ok(batch, h, w, cin, cout) || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long hw = (long)h * w;
  const Chunks ch = pixel_chunks(hw);
  Scratch s = scratch_layout((float*)scratch, batch, h, w, cin, cout);
  cudaError_t err;
#define PPST_CHECK(call)                                 \
  if ((err = (call)) != cudaSuccess) return (int)err;

  if (parts & 1) {
    const auto* ab = (const bf16*)a;
    const auto* gb = (const bf16*)g;
    const auto* mf = (const float*)mean;
    const auto* rf = (const float*)rstd;
    const auto* sf = (const float*)s1;
    const int cg = cout / 8;
    const int ry = cg >= kEwThreads ? 1 : kEwThreads / cg;
    const dim3 block(cg, ry), grid(ch.count, batch);
    const int red_bytes = ry * cout * 4;
    const int blocks = batch * ch.count;
    stats_kernel<<<grid, block, red_bytes, st>>>(ab, gb, mf, rf, sf, s.pstats, hw, cout, ch.size);
    PPST_CHECK(cudaGetLastError());
    PPST_CHECK(group_sum(s.pstats, (float*)sums, 4 * cout, ch.count, batch, 1.f, st));
    dpre_kernel<<<grid, block, red_bytes, st>>>(ab, gb, (const bf16*)noise, mf, rf, sf,
                                                (const float*)sums, 1.f / (float)hw, (bf16*)dpre,
                                                s.pdb, s.pdg, hw, cout, ch.size);
    PPST_CHECK(cudaGetLastError());
    PPST_CHECK(group_sum(s.pdb, (float*)db, cout, blocks, 1, 1.f, st));
    PPST_CHECK(group_sum(s.pdg, (float*)dgain, 1, blocks, 1, 1.f, st));
  }
  if (parts & 2)
    PPST_CHECK(launch_dw((const bf16*)x, (const bf16*)dpre, s.pdw, (float*)dw, batch, h, w, cin,
                         cout, st));
#undef PPST_CHECK
  return 0;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
