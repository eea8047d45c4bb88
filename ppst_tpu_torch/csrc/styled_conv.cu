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
// operations lead by 4x. This first design does not hold a tile on chip
// across the two halves: it writes a (bf16) and reads it back for the
// apply, 4 more bytes a pixel-channel.
//
// Design. An implicit GEMM: M = pixels, N = Cout, K = 9 taps x Cin. A block
// of 8 warps owns 128 consecutive pixels of one image and 128 output
// channels, and walks K in steps of one tap and 32 input channels. Each step
// stages the 128 shifted input rows (the tap's neighbours of the block's
// pixels) and the 128 x 32 weight slice in shared memory with cp.async, four
// steps in flight; a neighbour outside the image, a channel past Cin or an
// output channel past Cout is a zero-filled copy, so x needs no padded copy in
// device memory. The 9 taps read overlapping rows, which L1 and L2 serve.
// Products run on mma.sync (m16n8k16, bf16 in, float32 sums) from ldmatrix
// fragments of rows padded to 80 bytes (conflict-free). The epilogue adds
// gain * noise + b_total, applies the leaky ReLU and sqrt(2), stores a in bf16
// and writes the block's per-channel sum and sum of squares of the float32 a
// to a (B, pixel tiles, 2, Cout) scratch; moments_kernel reduces them in a
// fixed order into mean and rstd (no atomics: the same bits on every run),
// and apply_kernel writes out, 8 channels (16 bytes) a thread.
//
// Offsets into the activations are 64-bit: B H W C passes 2^31 at 1024px.
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes outputs and scratch (ppst_styled_conv_scratch_floats). The C
// functions return the first CUDA error of their launches (0 when all were
// accepted).

#include "styled_conv_common.cuh"

namespace {

constexpr int BM = 128;       // output pixels per block, consecutive in one image
constexpr int BN = 128;       // output channels per block
constexpr int BK = 32;        // input channels of one tap per k-step
constexpr int STAGES = 4;     // k-steps in flight
constexpr int THREADS = 256;  // 8 warps: 2 along M (64 pixels) x 4 along N (32 channels)
constexpr int SROW = BK + 8;  // bf16 row of a staged tile, padded to 80 bytes
constexpr int kConvSmem = STAGES * (BM + BN) * SROW * 2;

// out[b, p, n] = sum_tap sum_k in[b, p + d(tap), k] wt[tap, n, k] over the
// 3x3 neighbourhood d(tap) = (tap / 3 - 1, tap % 3 - 1) of pixel p, zero
// outside the image. in (B, H, W, K), wt (9, N, K), out (B, H, W, N), bf16.
// EPI: out = bf16(a), a = lrelu(acc + gain noise[b, p] + bias[n]) sqrt(2),
// and pstats (B, pixel tiles, 2, N) the tile's sums of a and a^2.
// grid (ceil(H W / BM), ceil(N / BN), B).
template <bool EPI>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wt,
               const bf16* __restrict__ noise, const float* __restrict__ gain,
               const float* __restrict__ bias, bf16* __restrict__ out,
               float* __restrict__ pstats, int H, int W, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][SROW]: pixels x k
  bf16* Bs = As + STAGES * BM * SROW;         // [STAGES][BN][SROW]: out channels x k
  __shared__ float red[2][2][BN];             // [warp row][sum, sum of squares][channel]

  const int HW = H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane / 4, tq = lane % 4;
  const long img = (long)b * HW;

  // the loader: rows lr and lr + 64 of both tiles, 16-byte chunk lc of each
  const int lr = tid >> 2, lc = tid & 3;
  int ph[2], pw[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + lr + 64 * i;
    pv[i] = p < HW;
    ph[i] = p / W;
    pw[i] = p - ph[i] * W;
  }
  const int kc_per_tap = (K + BK - 1) / BK;
  const int KT = 9 * kc_per_tap;

  auto load = [&](int kt, int stage) {
    const int tap = kt / kc_per_tap;
    const int c = (kt - tap * kc_per_tap) * BK + lc * 8;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool cok = c < K;
    bf16* as = As + stage * BM * SROW;
    bf16* bs = Bs + stage * BN * SROW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      const int hh = ph[i] + dy, ww = pw[i] + dx;
      const bool ok = cok && pv[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      cp_async16(as + r * SROW + lc * 8, ok ? in + ((img + (long)hh * W + ww) * K + c) : in, ok);
      const int n = n0 + r;
      const bool okb = cok && n < N;
      cp_async16(bs + r * SROW + lc * 8, okb ? wt + (((long)tap * N + n) * K + c) : wt, okb);
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
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt - 1's stage
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk, nk % STAGES);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * BM * SROW;
    const bf16* bs = Bs + (kt % STAGES) * BN * SROW;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * SROW + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(bfr[np], bs + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * SROW +
                             ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows wm*64 + mt*16 + g (+ 8) and channels
  // wn*32 + nt*8 + 2 tq (+ 1)
  const float gn = EPI ? *gain : 0.f;
  float csum[4][2], csq[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) csum[nt][0] = csum[nt][1] = csq[nt][0] = csq[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (p >= HW) continue;
      const long row = (img + p) * N;
      const float nz = EPI ? __bfloat162float(noise[img + p]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq;
        if (n >= N) continue;
        float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if constexpr (EPI) {
          float p0 = v0 + gn * nz, p1 = v1 + gn * nz;
          p0 += bias[n];
          p1 += bias[n + 1];
          v0 = (p0 >= 0.f ? p0 : p0 * kSlope) * kSqrt2;
          v1 = (p1 >= 0.f ? p1 : p1 * kSlope) * kSqrt2;
          csum[nt][0] += v0;
          csum[nt][1] += v1;
          csq[nt][0] += v0 * v0;
          csq[nt][1] += v1 * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if constexpr (EPI) {
    // the tile's per-channel sums: over the 8 row groups of the warp
    // (shuffles), then over the 2 warp rows (shared memory), in a fixed order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          csum[nt][j] += __shfl_xor_sync(0xffffffffu, csum[nt][j], o);
          csq[nt][j] += __shfl_xor_sync(0xffffffffu, csq[nt][j], o);
        }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn * 32 + nt * 8 + 2 * tq + j;
          red[wm][0][col] = csum[nt][j];
          red[wm][1][col] = csq[nt][j];
        }
    }
    __syncthreads();
    if (tid < BN && n0 + tid < N) {
      float* ps = pstats + ((long)b * gridDim.x + blockIdx.x) * 2 * N + n0 + tid;
      ps[0] = red[0][0][tid] + red[1][0][tid];
      ps[N] = red[0][1][tid] + red[1][1][tid];
    }
  }
}

// mean and rstd (B, N) from pstats (B, tiles, 2, N), tiles reduced in order,
// as ppst_tpu's _moments: var = max(E[a^2] - E[a]^2, 0). grid (ceil(N/256), B).
__global__ void __launch_bounds__(256)
moments_kernel(const float* __restrict__ pstats, float* __restrict__ mean,
               float* __restrict__ rstd, int tiles, int N, float count) {
  const int c = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (c >= N) return;
  const float* p = pstats + (long)b * tiles * 2 * N + c;
  float s = 0.f, q = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s += p[(long)t * 2 * N];
    q += p[(long)t * 2 * N + N];
  }
  const float m = s / count;
  const float var = fmaxf(q / count - m * m, 0.f);
  mean[(long)b * N + c] = m;
  rstd[(long)b * N + c] = 1.f / sqrtf(var + kEps);
}

// out = ((a - mean) rstd) s1 + shift, 8 channels a thread; mean, rstd, s1
// and shift (B, N) float32. hwn = H W N.
__global__ void __launch_bounds__(256)
apply_kernel(const bf16* __restrict__ a, const float* __restrict__ mean,
             const float* __restrict__ rstd, const float* __restrict__ s1,
             const float* __restrict__ shift, bf16* __restrict__ out, long vecs, long hwn, int N) {
  for (long v = blockIdx.x * 256L + threadIdx.x; v < vecs; v += (long)gridDim.x * 256) {
    const long e = v * 8;
    const long o = (e / hwn) * N + e % N;
    float f[8];
    load8(a + e, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = ((f[j] - mean[o + j]) * rstd[o + j]) * s1[o + j] + shift[o + j];
    store8(out + e, f);
  }
}

bool shape_ok(int batch, int h, int w, int k, int n) {
  return batch >= 1 && batch <= 65535 && h >= 1 && w >= 1 && (long)h * w <= (1L << 30) &&
         k >= 16 && k % 16 == 0 && n >= 16 && n % 16 == 0 && (n + BN - 1) / BN <= 65535;
}

template <bool EPI>
cudaError_t launch_conv(const bf16* in, const bf16* wt, const bf16* noise, const float* gain,
                        const float* bias, bf16* out, float* pstats, int batch, int h, int w,
                        int k, int n, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(((long)h * w + BM - 1) / BM), (n + BN - 1) / BN, batch);
  conv3x3_kernel<EPI><<<grid, THREADS, kConvSmem, st>>>(in, wt, noise, gain, bias, out, pstats,
                                                        h, w, k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch ppst_styled_conv_fwd needs: the per-tile partial sums.
long ppst_styled_conv_scratch_floats(int batch, int h, int w, int cout) {
  return (long)batch * (((long)h * w + BM - 1) / BM) * 2 * cout;
}

// The forward. x (B, H, W, Cin) bf16; wt (9, Cout, Cin) bf16, wt[kh*3 + kw, o, i]
// = w[o, i, kh, kw]; noise (B, H, W) bf16; gain (1,), b_total (Cout,), s1 and
// shift (B, Cout) float32. Outputs: a and out (B, H, W, Cout) bf16, mean and
// rstd (B, Cout) float32. Cin and Cout multiples of 16. Device pointers of
// contiguous tensors, 16-byte aligned.
int ppst_styled_conv_fwd(const void* x, const void* wt, const void* noise, const void* gain,
                         const void* b_total, const void* s1, const void* shift, void* a,
                         void* out, void* mean, void* rstd, void* scratch, int batch, int h,
                         int w, int cin, int cout, void* stream) {
  if (!shape_ok(batch, h, w, cin, cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)(((long)h * w + BM - 1) / BM);
  cudaError_t err = launch_conv<true>((const bf16*)x, (const bf16*)wt, (const bf16*)noise,
                                      (const float*)gain, (const float*)b_total, (bf16*)a,
                                      (float*)scratch, batch, h, w, cin, cout, st);
  if (err != cudaSuccess) return (int)err;
  moments_kernel<<<dim3((cout + 255) / 256, batch), 256, 0, st>>>(
      (const float*)scratch, (float*)mean, (float*)rstd, tiles, cout, (float)((long)h * w));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long vecs = (long)batch * h * w * cout / 8;
  const long blocks = (vecs + 255) / 256;
  apply_kernel<<<(unsigned)(blocks < (1L << 20) ? blocks : (1L << 20)), 256, 0, st>>>(
      (const bf16*)a, (const float*)mean, (const float*)rstd, (const float*)s1,
      (const float*)shift, (bf16*)out, vecs, (long)h * w * cout, cout);
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
