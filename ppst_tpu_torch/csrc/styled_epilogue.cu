// The StyledConv epilogue on bf16 NHWC, for Hopper (sm_90a): what follows G's
// convolution in a StyledConv that runs without gradient,
//   t1 = bf16(y + bf16(conv_bias));  t2 = bf16(t1 + bf16(bf16(gain) * noise))
//   t3 = bf16(t2 + bf16(bias));      t4 = bf16(t3 + bf16(act_bias))
//   a  = bf16((t4 >= 0 ? t4 : bf16(t4 * 0.2)) * sqrt(2))
//   mean = sum(a) / HW,  var = max(sum(a^2) / HW - mean^2, 0)   float32, per (b, c)
//   n  = bf16((a - mean) * rsqrt(var + 1e-5))
//   out = bf16(bf16(n * bf16(scale + 1)) + shift)
// on y (B, H, W, C), the convolution's output before its bias, with noise
// (B, H, W, 1) (or none), three float32 (C,) biases, a float32 gain and the
// StyleMod linear's (B, 2C) row [scale, shift]. The rounding points are the
// plain composite's (ppst_tpu_torch/nn/layers.py styled_conv_epilogue, which
// PyTorch runs as ~28 elementwise, copy and reduction launches): every bf16
// add and product is one rounding of the exact value (add.rn / mul.rn on
// bf16 pairs, which PyTorch's float op and its cast give too); the two
// float32 constants multiply in float32, rounded, then to bf16, as PyTorch
// does. Only the statistics' summation order differs from the composite's.
//
// Replaces no TPU kernel: XLA fused this chain on the TPU
// (ppst_tpu/nn/layers.py StyledConv, NoiseInjection, StyleMod, instance_norm).
//
// Bound: bytes. About 20 operations an element against 4 bytes (y read once,
// out written once; the noise is 2 bytes a pixel, the parameters C and B C
// values). An instance norm needs its (b, c) statistics before the first
// output, so the design makes two passes over y and moves ~6 bytes an
// element: at most ~67% of the bound.
//
// Design:
// - Blocks of (C / 8) x R threads (R = 256 / (C / 8) pixel rows; 8 channels
//   a thread, 16-byte loads, coalesced along C) on a grid of (slabs, B): a
//   block owns one slab of pixels of one image. The caller sizes the slabs
//   from (B, H W, C) and the blocks an SM holds (three at 256 threads) so that
//   every shape fills one wave over the card, and no block waits for a
//   second.
// - Both passes read y through a ring of 16-byte slots in shared memory a
//   thread fills by cp.async, 7 rows ahead of the one it computes: the bytes
//   in flight (up to ~100 KB an SM) need no registers, which a pass's
//   per-channel constants and arithmetic already fill.
// - Pass 1, styled_epi_stats: a thread computes a in registers and sums a
//   and a^2 for its channels in float32; the block sums its rows in shared
//   memory in a fixed order into a per-slab record. The last block of each
//   group of 16 slabs (a ticket counter) sums the group's records in slab
//   order; the last group of an image sums the group sums in group order
//   into mean and rstd (an image of one group: the group's block does).
//   Those sums read 8 records at a time, 16 bytes a thread. The counters
//   decide only who sums, never the order: every run gives the same bits.
//   The summing block sets its counter back to 0, so the counters (zeroed
//   once by the caller, kept per stream) are ready for the next launch.
// - Pass 2, styled_epi_apply: launched as a programmatic dependent of pass 1
//   (as K1's passes): its blocks fetch their channels' biases and style row,
//   then wait for pass 1, re-read y and the noise, recompute a and store
//   16-byte chunks of out. It walks the slabs in the reverse of pass 1's
//   order, so that its first reads find the last of pass 1's in L2.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes out, scratch (ppst_styled_epilogue_scratch_floats floats: the slab
// records, the group sums and the (B, 2, C) mean and rstd) and the counters
// (ppst_styled_epilogue_counters). ppst_styled_epilogue returns the first
// CUDA error of its launches (0 when both were accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kThreads = 256;  // threads a block, at most
constexpr int kMaxC = 2048;    // C / 8 threads a pixel row, at most kThreads
constexpr int kGroup = 16;     // slab records a first-level sum reads
constexpr int kDepth = 8;      // slots of a thread's ring: kDepth - 1 pixel rows in flight
constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.2f;
constexpr float kGain = 1.41421356237309515f;  // float(math.sqrt(2))

struct Args {
  const bf16* y;          // (B, n, c)
  const bf16* noise;      // (B, n) or null
  const float* conv_bias; // (c,)
  const float* bias;      // (c,)
  const float* act_bias;  // (c,)
  const float* gain;      // (1,)
  const bf16* style;      // (B, style_stride), [scale (c), shift (c)]
  long long style_stride;
  bf16* out;              // (B, n, c)
  float* rec;             // (B, slabs, 2, c) slab records
  float* grp;             // (B, groups, 2, c) group sums
  float* mr;              // (B, 2, c) mean, rstd
  unsigned* count;        // (B, groups + 1) tickets
  int n, c, slabs, groups, cols, rows;
  float inv_n;
};

__device__ __forceinline__ unsigned as_u32(bf162 v) { return *reinterpret_cast<unsigned*>(&v); }
__device__ __forceinline__ bf162 as_bf162(unsigned v) { return *reinterpret_cast<bf162*>(&v); }

// one rounding of the exact sum and product of bf16 pairs
__device__ __forceinline__ bf162 add_rn(bf162 a, bf162 b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(as_u32(a)), "r"(as_u32(b)));
  return as_bf162(d);
}
__device__ __forceinline__ bf162 mul_rn(bf162 a, bf162 b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(as_u32(a)), "r"(as_u32(b)));
  return as_bf162(d);
}

// A thread's 8 channels' biases, each rounded to bf16, in pairs.
struct Chan {
  bf162 cb[4], bb[4], ab[4];
};

__device__ __forceinline__ void load_chan(const Args& p, int c0, Chan& ch) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 2 * j;
    ch.cb[j] = __floats2bfloat162_rn(p.conv_bias[c], p.conv_bias[c + 1]);
    ch.bb[j] = __floats2bfloat162_rn(p.bias[c], p.bias[c + 1]);
    ch.ab[j] = __floats2bfloat162_rn(p.act_bias[c], p.act_bias[c + 1]);
  }
}

// Asynchronous 16-byte copies from global to shared memory (cp.async, L2
// only), in groups a thread commits and waits for.
__device__ __forceinline__ void copy16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Walks a thread's pixel rows px = lo + row + i rows < hi (i = 0, 1, ...) of
// image row `base`, calling f(16 bytes of y, the pixel's noise, pixel) for
// each. The y chunks come through a ring of kDepth 16-byte slots of shared
// memory that only this thread writes and reads (slot k at ring[k blockDim
// + tid]: a warp's slots are 512 contiguous bytes): kDepth - 1 rows are in
// flight while f computes, without registers to hold them. The noise (2
// bytes a row, the same for a pixel's threads) comes by plain loads, sent
// as early.
template <typename F>
__device__ __forceinline__ void walk(const Args& p, uint4* ring, long base, int lo, int hi,
                                     int row, int col, F&& f) {
  const uint4* yv = reinterpret_cast<const uint4*>(p.y);
  const int step = p.rows;
  uint4* slot = ring + threadIdx.x;
  bf16 z[kDepth];
  auto fetch = [&](int i, int k) {  // row i into slot k
    const int px = lo + row + i * step;
    if (px < hi) {
      const long pix = base + px;
      copy16(slot + k * blockDim.x, yv + pix * p.cols + col);
      z[k] = p.noise ? __ldg(p.noise + pix) : __float2bfloat16_rn(0.f);
    }
    commit_copies();
  };
#pragma unroll
  for (int k = 0; k < kDepth - 1; ++k) fetch(k, k);
  for (int i0 = 0;; i0 += kDepth) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int i = i0 + k, px = lo + row + i * step;
      if (px >= hi) {
        wait_copies<0>();
        return;
      }
      fetch(i + kDepth - 1, (k + kDepth - 1) % kDepth);
      wait_copies<kDepth - 1>();
      f(slot[k * blockDim.x], z[k], base + px);
    }
  }
}

// a of 8 channels from their 16 bytes of y and the pixel's noise z
__device__ __forceinline__ void activate(uint4 raw, bf16 z, bf162 g2, bool noisy,
                                         const Chan& ch, float (&a)[8]) {
  const bf162* v = reinterpret_cast<const bf162*>(&raw);
  const bf162 gn = mul_rn(g2, bf162(z, z));  // bf16(bf16(gain) * noise), twice
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bf162 t = add_rn(v[j], ch.cb[j]);
    if (noisy) t = add_rn(t, gn);
    t = add_rn(add_rn(t, ch.bb[j]), ch.ab[j]);
    const float2 f = __bfloat1622float2(t);
    const float2 m = __bfloat1622float2(
        __floats2bfloat162_rn(__fmul_rn(f.x, kSlope), __fmul_rn(f.y, kSlope)));
    const float lx = f.x >= 0.f ? f.x : m.x, ly = f.y >= 0.f ? f.y : m.y;
    const float2 o = __bfloat1622float2(
        __floats2bfloat162_rn(__fmul_rn(lx, kGain), __fmul_rn(ly, kGain)));
    a[2 * j] = o.x;
    a[2 * j + 1] = o.y;
  }
}

// Slab s of an image holds its pixels [s n / slabs, (s + 1) n / slabs).
__device__ __forceinline__ int slab_start(const Args& p, int s) {
  return (int)((long)s * p.n / p.slabs);
}

__device__ __forceinline__ void allow_next_pass() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Adds to acc, in record order, the 4 floats at src of `count` records
// `stride` floats apart, read from L2: 8 loads in flight at a time.
__device__ __forceinline__ float4 add_records(float4 acc, const float* src, int count,
                                              long stride) {
  constexpr int kLoads = 8;
  for (int i0 = 0; i0 < count; i0 += kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      if (i0 + i < count) v[i] = __ldcg(reinterpret_cast<const float4*>(src + (i0 + i) * stride));
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      if (i0 + i < count) {
        acc.x += v[i].x;
        acc.y += v[i].y;
        acc.z += v[i].z;
        acc.w += v[i].w;
      }
  }
  return acc;
}

// mean and rstd of image b's channels from the sums and sums of squares of
// `count` records (2 c floats each, from src), summed in record order.
__device__ __forceinline__ void finish(const Args& p, int b, const float* src, int count) {
  const int c = p.c;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float* mr = p.mr + (long)b * 2 * c;
  for (int k = 4 * threadIdx.x; k < c; k += 4 * blockDim.x) {
    const float4 s1 = add_records(zero, src + k, count, 2 * c);
    const float4 s2 = add_records(zero, src + c + k, count, 2 * c);
    const float sums[4] = {s1.x, s1.y, s1.z, s1.w}, squares[4] = {s2.x, s2.y, s2.z, s2.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mean = sums[j] * p.inv_n, ex2 = squares[j] * p.inv_n;
      const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
      mr[k + j] = mean;
      mr[c + k + j] = rsqrtf(__fadd_rn(var, kEps));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) styled_epi_stats(const Args p) {
  allow_next_pass();
  // the ring of the walk, then the block's sums: [sum, sum of squares][row][c]
  __shared__ uint4 ring[kDepth * kThreads];
  __shared__ unsigned last;
  float* red = reinterpret_cast<float*>(ring);
  static_assert(kDepth * kThreads * 4 >= 2 * kThreads * 8, "the sums fit in the ring");
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int col = tid % p.cols, row = tid / p.cols, c0 = 8 * col;
  Chan ch;
  load_chan(p, c0, ch);
  const bf16 g = __float2bfloat16_rn(*p.gain);
  const bf162 g2(g, g);
  const bool noisy = p.noise != nullptr;
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  walk(p, ring, (long)b * p.n, slab_start(p, s), slab_start(p, s + 1), row, col,
       [&](uint4 raw, bf16 z, long) {
         float a[8];
         activate(raw, z, g2, noisy, ch, a);
#pragma unroll
         for (int j = 0; j < 8; ++j) {
           s1[j] += a[j];
           s2[j] = fmaf(a[j], a[j], s2[j]);
         }
       });

  // the block's rows, summed in row order, into its slab's record
  __syncthreads();  // every thread is done with its ring
  const int c = p.c, plane = p.rows * c;
  float4* r1 = reinterpret_cast<float4*>(red + row * c + c0);
  float4* r2 = reinterpret_cast<float4*>(red + plane + row * c + c0);
  r1[0] = make_float4(s1[0], s1[1], s1[2], s1[3]);
  r1[1] = make_float4(s1[4], s1[5], s1[6], s1[7]);
  r2[0] = make_float4(s2[0], s2[1], s2[2], s2[3]);
  r2[1] = make_float4(s2[4], s2[5], s2[6], s2[7]);
  __syncthreads();
  float* rec = p.rec + ((long)b * p.slabs + s) * 2 * c;
  for (int k = tid; k < 2 * c; k += blockDim.x) {
    const float* src = red + (k / c) * plane + k % c;
    float acc = 0.f;
    for (int r = 0; r < p.rows; ++r) acc += src[r * c];
    rec[k] = acc;
  }

  // the last block of the group sums the group's records in slab order
  __threadfence();
  __syncthreads();
  const int grp = s / kGroup, first = grp * kGroup, in_grp = min(kGroup, p.slabs - first);
  unsigned* tickets = p.count + (long)b * (p.groups + 1);
  if (tid == 0) last = atomicAdd(tickets + grp, 1u) == (unsigned)(in_grp - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* recs = p.rec + ((long)b * p.slabs + first) * 2 * c;
  if (tid == 0) tickets[grp] = 0;
  if (p.groups == 1) {  // the image's only group: its sums are the image's
    finish(p, b, recs, in_grp);
    return;
  }
  float* gsum = p.grp + ((long)b * p.groups + grp) * 2 * c;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 4 * tid; k < 2 * c; k += 4 * blockDim.x)
    *reinterpret_cast<float4*>(gsum + k) = add_records(zero, recs + k, in_grp, 2 * c);

  // the last group of the image sums the group sums in group order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + p.groups, 1u) == (unsigned)(p.groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) tickets[p.groups] = 0;
  finish(p, b, p.grp + (long)b * p.groups * 2 * c, p.groups);
}

__global__ void __launch_bounds__(kThreads, 3) styled_epi_apply(const Args p) {
  // the reverse of pass 1's block order
  const int blocks = gridDim.x * gridDim.y;
  const int lin = blocks - 1 - (blockIdx.y * gridDim.x + blockIdx.x);
  const int s = lin % p.slabs, b = lin / p.slabs, tid = threadIdx.x;
  const int col = tid % p.cols, row = tid / p.cols, c0 = 8 * col;
  Chan ch;
  load_chan(p, c0, ch);
  const bf16 g = __float2bfloat16_rn(*p.gain);
  const bf162 g2(g, g);
  const bool noisy = p.noise != nullptr;
  bf162 sp1[4], shift[4];
  const bf16* st = p.style + (long)b * p.style_stride;
  const bf162 one = __floats2bfloat162_rn(1.f, 1.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 2 * j;
    sp1[j] = add_rn(bf162(st[c], st[c + 1]), one);
    shift[j] = bf162(st[p.c + c], st[p.c + c + 1]);
  }
  wait_prior_pass();  // mean and rstd, pass 1's
  float mean[8], rstd[8];
  const float* mr = p.mr + (long)b * 2 * p.c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mean[j] = mr[c0 + j];
    rstd[j] = mr[p.c + c0 + j];
  }

  __shared__ uint4 ring[kDepth * kThreads];
  uint4* ov = reinterpret_cast<uint4*>(p.out);
  walk(p, ring, (long)b * p.n, slab_start(p, s), slab_start(p, s + 1), row, col,
       [&](uint4 raw, bf16 z, long pix) {
    float a[8];
    activate(raw, z, g2, noisy, ch, a);
    uint4 o;
    bf162* h = reinterpret_cast<bf162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf162 nn = __floats2bfloat162_rn(
          __fmul_rn(__fsub_rn(a[2 * j], mean[2 * j]), rstd[2 * j]),
          __fmul_rn(__fsub_rn(a[2 * j + 1], mean[2 * j + 1]), rstd[2 * j + 1]));
      h[j] = add_rn(mul_rn(nn, sp1[j]), shift[j]);
    }
    ov[pix * p.cols + col] = o;
  });
}

int groups_of(int slabs) { return (slabs + kGroup - 1) / kGroup; }

}  // namespace

extern "C" {

// Floats of scratch for B images of C channels in `slabs` slabs.
long long ppst_styled_epilogue_scratch_floats(int batch, int c, int slabs) {
  return (long long)batch * (slabs + groups_of(slabs) + 1) * 2 * c;
}

// Counters (unsigned ints, zero before the first launch) for B images in `slabs` slabs.
long long ppst_styled_epilogue_counters(int batch, int slabs) {
  return (long long)batch * (groups_of(slabs) + 1);
}

// Blocks of `threads` threads of either pass an SM can hold at once (0 on error).
int ppst_styled_epilogue_resident(int threads) {
  int stats = 0, apply = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&stats, styled_epi_stats, threads, 0) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&apply, styled_epi_apply, threads, 0) !=
          cudaSuccess)
    return 0;
  return stats < apply ? stats : apply;
}

// The epilogue. y, out (B, n, c) bf16; noise (B, n) bf16 or null; conv_bias,
// bias, act_bias (c,) and gain (1,) float32; style (B, style_stride) bf16,
// scale then shift; scratch and counters as above. c a multiple of 8 up to
// 2048; y and out 16-byte aligned; every pointer a device pointer of a
// contiguous tensor; 1 <= slabs <= n.
int ppst_styled_epilogue(const void* y, const void* noise, const void* conv_bias,
                         const void* bias, const void* act_bias, const void* gain,
                         const void* style, long long style_stride, void* out, void* scratch,
                         void* counters, int batch, int n, int c, int slabs, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0 || slabs < 1 ||
      slabs > n || style_stride < 2 * c || (uintptr_t)y % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.y = (const bf16*)y;
  p.noise = (const bf16*)noise;
  p.conv_bias = (const float*)conv_bias;
  p.bias = (const float*)bias;
  p.act_bias = (const float*)act_bias;
  p.gain = (const float*)gain;
  p.style = (const bf16*)style;
  p.style_stride = style_stride;
  p.out = (bf16*)out;
  p.n = n;
  p.c = c;
  p.slabs = slabs;
  p.groups = groups_of(slabs);
  p.cols = c / 8;
  p.rows = p.cols >= kThreads ? 1 : kThreads / p.cols;
  p.inv_n = 1.0f / (float)n;
  p.rec = (float*)scratch;
  p.grp = p.rec + (long)batch * slabs * 2 * c;
  p.mr = p.grp + (long)batch * p.groups * 2 * c;
  p.count = (unsigned*)counters;
  const int threads = p.cols * p.rows;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;

  styled_epi_stats<<<dim3(slabs, batch), threads, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // pass 2 may begin as pass 1's blocks start; it waits before reading mr
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, styled_epi_apply, p)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
