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
// a fixed order. dW is a GEMM over pixels (M = Cin, N = Cout, K = pixels of
// all samples) per tap. mma.sync wants both operands contiguous along the
// pixel axis, and both are stored channel-contiguous (NHWC): the tiles are
// staged as they lie, 32 pixels x 128 channels, with cp.async (zero fill for
// a neighbour outside the image), and ldmatrix.trans delivers them transposed.
// The pixels are split into a fixed number of slices per shape; each block
// writes its float32 partial dW, and dw_reduce_kernel sums the slices in
// order. The scratch stays within 64 Mi floats (256 MB) for any shape; at the
// generator's 512px shapes it is 75 MB or less. No atomics anywhere: the
// gradients are the same bits on every run. The bf16 products of x and dpre
// are exact in float32, as in the Pallas kernel's float32 dot.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_styled_conv_bwd_scratch_floats).
// ppst_styled_conv_bwd returns the first CUDA error of its launches.

#include "styled_conv_common.cuh"

namespace {

constexpr int kEwThreads = 256;
constexpr int kMaxChunks = 256;  // pixel chunks per sample in passes 1 and 2
// dW tiles: 128 input x 128 output channels, k-steps of 32 pixels
constexpr int WM = 128, WN = 128, WK = 32, WSTAGES = 4, WTHREADS = 256;
constexpr int XS = WM + 8, DS = WN + 8;  // padded bf16 rows of the staged tiles
constexpr int kDwSmem = WSTAGES * WK * (XS + DS) * 2;
constexpr long kMaxDwScratch = 64L << 20;  // floats
constexpr int kTargetBlocks = 8 * 132;     // dW blocks to aim for: 8 per SM

struct Chunks {
  int size, count;
};

Chunks pixel_chunks(long hw) {
  long size = (hw + kMaxChunks - 1) / kMaxChunks;
  if (size < 128) size = 128;
  return {(int)size, (int)((hw + size - 1) / size)};
}

struct DwGrid {
  int mtiles, ntiles, slices, per;  // per: k-steps a slice
};

DwGrid dw_grid(int batch, long hw, int cin, int cout) {
  DwGrid d;
  d.mtiles = (cin + WM - 1) / WM;
  d.ntiles = (cout + WN - 1) / WN;
  const long ksteps = ((long)batch * hw + WK - 1) / WK;
  long s = (kTargetBlocks + 9L * d.mtiles * d.ntiles - 1) / (9L * d.mtiles * d.ntiles);
  const long cap = kMaxDwScratch / (9L * cin * cout);
  if (s > cap) s = cap;
  if (s > ksteps) s = ksteps;
  if (s < 1) s = 1;
  d.per = (int)((ksteps + s - 1) / s);
  d.slices = (int)((ksteps + d.per - 1) / d.per);
  return d;
}

struct Scratch {
  float *pstats, *pdb, *pdg, *pdw;
  long total;
};

Scratch scratch_layout(float* base, int batch, int h, int w, int cin, int cout) {
  const long hw = (long)h * w;
  const Chunks ch = pixel_chunks(hw);
  const DwGrid d = dw_grid(batch, hw, cin, cout);
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

// dW partials. grid (mtiles * ntiles, 9, slices): one tap, 128 input x 128
// output channels, the slice's k-steps of 32 pixels (of all samples).
// x (B, H, W, Cin), dp (B, H, W, Cout) bf16; pdw (slices, 9, Cin, Cout).
__global__ void __launch_bounds__(WTHREADS)
dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dp, float* __restrict__ pdw,
          int H, int W, long total, int cin, int cout, int ntiles, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // [WSTAGES][WK][XS]: pixels x input channels
  bf16* Ds = Xs + WSTAGES * WK * XS;          // [WSTAGES][WK][DS]: pixels x output channels

  const int m0 = (blockIdx.x / ntiles) * WM, n0 = (blockIdx.x % ntiles) * WN;
  const int tap = blockIdx.y, dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long hw = (long)H * W;
  const long k_begin = (long)blockIdx.z * per;
  const long ksteps = (total + WK - 1) / WK;
  const int KT = (int)(k_begin + per < ksteps ? per : ksteps - k_begin);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane / 4, tq = lane % 4;

  // the loader: pixel rows lr and lr + 16, 16-byte chunk lc (of 16) of both tiles
  const int lr = tid >> 4, lc = tid & 15;
  auto load = [&](int kt, int stage) {
    bf16* xs = Xs + stage * WK * XS;
    bf16* ds = Ds + stage * WK * DS;
    const long q0 = (k_begin + kt) * WK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 16 * i;
      const long q = q0 + r;
      const bool qok = q < total;
      const long bi = qok ? q / hw : 0;
      const long p = q - bi * hw;
      const int h = (int)(p / W), w = (int)(p - (long)(p / W) * W);
      const int hh = h + dy, ww = w + dx;
      const int ci = m0 + lc * 8, co = n0 + lc * 8;
      const bool okx = qok && ci < cin && hh >= 0 && hh < H && ww >= 0 && ww < W;
      cp_async16(xs + r * XS + lc * 8,
                 okx ? x + (((bi * H + hh) * W + ww) * cin + ci) : x, okx);
      const bool okd = qok && co < cout;
      cp_async16(ds + r * DS + lc * 8, okd ? dp + (q * cout + co) : dp, okd);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    const int nk = kt + WSTAGES - 1;
    if (nk < KT) load(nk, nk % WSTAGES);
    cp_async_commit();
    const bf16* xs = Xs + (kt % WSTAGES) * WK * XS;
    const bf16* ds = Ds + (kt % WSTAGES) * WK * DS;
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
      // A = x^T (input channels x pixels): matrices (m 0-7, k 0-7), (m 8-15,
      // k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15) of the pixel-major tile
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(af[mt], xs + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * XS + wm * 64 +
                              mt * 16 + ((lane >> 3) & 1) * 8);
      // B = dpre (pixels x output channels), column-major fragments:
      // (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(bfr[np], ds + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS + wn * 32 +
                               np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  float* out = pdw + ((long)blockIdx.z * 9 + tap) * cin * cout;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (ci >= cin) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = n0 + wn * 32 + nt * 8 + 2 * tq;
        if (co < cout)
          *reinterpret_cast<float2*>(out + (long)ci * cout + co) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
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

bool shape_ok(int batch, int h, int w, int cin, int cout) {
  return batch >= 1 && batch <= 65535 && h >= 1 && w >= 1 && (long)h * w <= (1L << 30) &&
         cin >= 16 && cin % 16 == 0 && cout >= 16 && cout % 16 == 0 && cout <= 2048 &&
         9L * cin * cout <= kMaxDwScratch;
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
// ppst_styled_conv_bwd_scratch_floats(...) floats. Device pointers of
// contiguous tensors, 16-byte aligned.
int ppst_styled_conv_bwd(const void* x, const void* a, const void* g, const void* noise,
                         const void* mean, const void* rstd, const void* s1, void* dpre,
                         void* sums, void* db, void* dgain, void* dw, void* scratch, int batch,
                         int h, int w, int cin, int cout, void* stream) {
  if (!shape_ok(batch, h, w, cin, cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long hw = (long)h * w;
  const Chunks ch = pixel_chunks(hw);
  const DwGrid d = dw_grid(batch, hw, cin, cout);
  Scratch s = scratch_layout((float*)scratch, batch, h, w, cin, cout);
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
  cudaError_t err;
#define PPST_CHECK(call)                                 \
  if ((err = (call)) != cudaSuccess) return (int)err;

  stats_kernel<<<grid, block, red_bytes, st>>>(ab, gb, mf, rf, sf, s.pstats, hw, cout, ch.size);
  PPST_CHECK(cudaGetLastError());
  PPST_CHECK(group_sum(s.pstats, (float*)sums, 4 * cout, ch.count, batch, 1.f, st));

  dpre_kernel<<<grid, block, red_bytes, st>>>(ab, gb, (const bf16*)noise, mf, rf, sf,
                                              (const float*)sums, 1.f / (float)hw, (bf16*)dpre,
                                              s.pdb, s.pdg, hw, cout, ch.size);
  PPST_CHECK(cudaGetLastError());
  PPST_CHECK(group_sum(s.pdb, (float*)db, cout, blocks, 1, 1.f, st));
  PPST_CHECK(group_sum(s.pdg, (float*)dgain, 1, blocks, 1, 1.f, st));

  PPST_CHECK(cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDwSmem));
  dw_kernel<<<dim3(d.mtiles * d.ntiles, 9, d.slices), WTHREADS, kDwSmem, st>>>(
      (const bf16*)x, (const bf16*)dpre, s.pdw, h, w, (long)batch * hw, cin, cout, d.ntiles,
      d.per);
  PPST_CHECK(cudaGetLastError());
  const long len = 9L * cin * cout;
  dw_reduce_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(s.pdw, (float*)dw, d.slices,
                                                                   cin, cout);
  PPST_CHECK(cudaGetLastError());
#undef PPST_CHECK
  return 0;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
