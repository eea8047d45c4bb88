// K8: an instance norm and what follows it, on bf16 NHWC, for Hopper
// (sm_90a): the chains after extraction's convolutions that run without
// gradient (E1's ConvLayers, G's 3x3 feature taps and the fuse blocks'
// _ResidualBlocks),
//   t = bf16(y + bf16(pre_bias))       (or t = y without a pre-bias)
//   mean = sum(t) / HW,  var = max(sum(t^2) / HW - mean^2, 0)   float32, per (b, c)
//   u = bf16((t - mean) * rsqrt(var + 1e-5))
//   v = bf16(u + residual)             (or v = u without a residual)
//   out = v                                                   no activation
//       = bf16(l * sqrt(2)), l = w >= 0 ? w : bf16(w * 0.2),
//         w = bf16(v + bf16(act_bias))                        leaky ReLU
//       = v >= 0 ? v : bf16(v * bf16(slope))                  PReLU
// on y (B, H, W, C), the convolution's output before its bias, with a
// float32 (C,) pre-bias and act_bias, a float32 scalar slope and a bf16
// (B, H, W, C) residual. The variant (pre-bias or not, residual or not, the
// activation) is a template parameter of the kernels; the C entry picks it
// from the pointers it is given. The rounding points are the plain
// composite's (ppst_tpu_torch/nn/layers.py norm_act_chain: instance_norm,
// fused_leaky_relu, prelu; PyTorch runs it as 12-20 elementwise, copy and
// reduction launches): every bf16 add and product is one rounding of the
// exact value; the float32 constants multiply in float32, rounded, then to
// bf16, as PyTorch does. Only the statistics' summation order differs from
// the composite's.
//
// Replaces no TPU kernel: XLA fused this chain on the TPU
// (ppst_tpu/nn/layers.py instance_norm, ConvLayer, PReLU;
// ppst_tpu/models/generator.py).
//
// Bound: bytes. A few operations an element against 4 bytes (y read once,
// out written once; 6 with the residual read once). The statistics are
// needed before the first output, so the design reads y twice and moves 6
// bytes an element (8 with the residual): at most 67% (75%) of the bound.
//
// Design: K7's (styled_epilogue.cu), whose walk and fold this file copies
// (K7 built on a shared copy of them ran 1-2% slower on the card, for
// reasons not found, so it keeps its own).
// - Blocks of (C / 8) x R threads (R = 256 / (C / 8) pixel rows; 8 channels
//   a thread, 16-byte chunks coalesced along C) on a grid of (slabs, B): a
//   block owns one slab of pixels of one image, slab s holding pixels
//   [s n / slabs, (s + 1) n / slabs). The caller sizes the slabs from
//   (B, H W, C) and the blocks an SM holds so that both passes fill one wave
//   of blocks over the card.
// - Both passes read through cp.async rings in shared memory that a thread
//   fills kDepth - 1 pixel rows ahead of the one it computes (y alone: 8
//   slots of 16 bytes a thread; y and the residual: 4 slots of 2 x 16 bytes,
//   the same 32 KB a block): the bytes in flight need no registers.
// - Pass 1, norm_act_stats: t and the float32 sums of t and t^2 a thread;
//   the block sums its rows in shared memory in row order into its slab's
//   record. The last block of each group of kGroup slabs (a ticket counter)
//   sums the group's records in slab order; the last group of an image sums
//   the group sums in group order into mean and rstd (an image of one group:
//   the group's block does). The counters decide only who sums, never the
//   order: every run gives the same bits. The summing block sets its counter
//   back to 0, so the counters (zeroed once by the caller, kept per stream)
//   are ready for the next launch.
// - Pass 2, norm_act_apply: a programmatic dependent of pass 1. Its blocks
//   fetch their channels' parameters, wait for pass 1, re-read y (and the
//   residual) and store 16-byte chunks of out, walking the slabs in the
//   reverse of pass 1's order so that its first reads find pass 1's last in
//   L2.
//
// Kernels launch on the caller's stream and allocate nothing: the caller
// passes out, scratch (ppst_norm_act_scratch_floats floats: the (B, slabs, 2,
// C) slab records, the (B, groups, 2, C) group sums and the (B, 2, C) mean
// and rstd) and the counters ((B, groups + 1), ppst_norm_act_counters).
// ppst_norm_act returns the first CUDA error of its launches (0 when both
// were accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block, at most
constexpr int kMaxC = 2048;    // C / 8 threads a pixel row, at most kThreads
constexpr int kDepth = 8;      // 16-byte slots of a thread's ring
constexpr int kGroup = 16;     // slab records a first-level sum reads
constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.2f;                 // leaky ReLU's
constexpr float kGain = 1.41421356237309515f;  // float(math.sqrt(2))

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

enum Act { kNone = 0, kLeakyRelu = 1, kPrelu = 2 };

struct Args {
  const bf16* y;           // (B, n, c)
  const float* pre_bias;   // (c,) or null
  const bf16* residual;    // (B, n, c) or null
  const float* act_bias;   // (c,): the leaky ReLU's
  const float* slope;      // (1,): the PReLU's
  bf16* out;               // (B, n, c)
  float* rec;              // (B, slabs, 2, c) slab records
  float* grp;              // (B, groups, 2, c) group sums
  float* mr;               // (B, 2, c) mean, rstd
  unsigned* count;         // (B, groups + 1) tickets
  int n, c, slabs, groups, cols, rows;
  float inv_n;

  __device__ __forceinline__ int slab_start(int s) const { return (int)((long)s * n / slabs); }
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

// leaky ReLU and its gain on a bf16 pair, rounded where PyTorch rounds:
// bf16(t * 0.2) where t < 0, then bf16(. * sqrt(2)), each product in float32
__device__ __forceinline__ bf162 leaky_relu_gain(bf162 t) {
  const float2 f = __bfloat1622float2(t);
  const float2 m = __bfloat1622float2(
      __floats2bfloat162_rn(__fmul_rn(f.x, kSlope), __fmul_rn(f.y, kSlope)));
  const float lx = f.x >= 0.f ? f.x : m.x, ly = f.y >= 0.f ? f.y : m.y;
  return __floats2bfloat162_rn(__fmul_rn(lx, kGain), __fmul_rn(ly, kGain));
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

__device__ __forceinline__ void allow_next_pass() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A thread's 16 bytes of each stream at one pixel.
template <int kStreams>
struct Chunks {
  uint4 v[kStreams];
};

// Walks a thread's pixel rows px = lo + row + i R < hi (i = 0, 1, ...) of the
// image whose first pixel is `base`, calling f(chunks, pixel) for each:
// chunks.v[s] is the thread's 16 bytes of stream s (src[s], cols chunks a
// pixel). The chunks come through a ring of kDepth slots of kStreams x 16
// bytes of shared memory that only this thread writes and reads (slot (k, s)
// at ring[(k kStreams + s) blockDim + tid]: a warp's slots are 512
// contiguous bytes): kDepth - 1 rows are in flight while f computes, without
// registers to hold them.
template <int kStreams, int kDepth, typename F>
__device__ __forceinline__ void walk(const Args& p, const uint4* const (&src)[kStreams],
                                     uint4* ring, long base, int lo, int hi, int row, int col,
                                     F&& f) {
  const int step = p.rows;
  uint4* slot = ring + threadIdx.x;
  auto fetch = [&](int i, int k) {  // row i into slot k
    const int px = lo + row + i * step;
    if (px < hi) {
      const long pix = base + px;
#pragma unroll
      for (int s = 0; s < kStreams; ++s)
        copy16(slot + (k * kStreams + s) * blockDim.x, src[s] + pix * p.cols + col);
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
      Chunks<kStreams> in;
#pragma unroll
      for (int s = 0; s < kStreams; ++s) in.v[s] = slot[(k * kStreams + s) * blockDim.x];
      f(in, base + px);
    }
  }
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

// A statistics pass's end: the block's sums s1 and sums of squares s2 (a
// thread's 8 channels from c0, its pixel row `row`) into slab s's record of
// image b, then the fold above. `red` is shared memory of at least 2 R c
// floats that no thread reads any more (the walk's ring). Every thread of
// the block calls it.
__device__ __forceinline__ void fold(const Args& p, float* red, int b, int s, int row, int c0,
                                     const float (&s1)[8], const float (&s2)[8]) {
  __shared__ unsigned last;
  const int tid = threadIdx.x;
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

// a thread's 8 channels of a float32 (c,) vector from c0, rounded to bf16, in pairs
__device__ __forceinline__ void load_pairs(const float* v, int c0, bf162 (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __floats2bfloat162_rn(v[c0 + 2 * j], v[c0 + 2 * j + 1]);
}

template <bool kPre>
__global__ void __launch_bounds__(kThreads, 3) norm_act_stats(const Args p) {
  allow_next_pass();
  // the ring of the walk, then the block's sums: [sum, sum of squares][row][c]
  __shared__ uint4 ring[kDepth * kThreads];
  static_assert(kDepth * kThreads * 4 >= 2 * kThreads * 8, "the sums fit in the ring");
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int col = tid % p.cols, row = tid / p.cols, c0 = 8 * col;
  bf162 pb[4];
  if (kPre) load_pairs(p.pre_bias, c0, pb);
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  const uint4* src[1] = {reinterpret_cast<const uint4*>(p.y)};
  walk<1, kDepth>(p, src, ring, (long)b * p.n, p.slab_start(s), p.slab_start(s + 1), row, col,
                  [&](const Chunks<1>& in, long) {
    const bf162* v = reinterpret_cast<const bf162*>(&in.v[0]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(kPre ? add_rn(v[j], pb[j]) : v[j]);
      s1[2 * j] += t.x;
      s1[2 * j + 1] += t.y;
      s2[2 * j] = fmaf(t.x, t.x, s2[2 * j]);
      s2[2 * j + 1] = fmaf(t.y, t.y, s2[2 * j + 1]);
    }
  });
  fold(p, reinterpret_cast<float*>(ring), b, s, row, c0, s1, s2);
}

template <bool kPre, bool kRes, int kAct>
__global__ void __launch_bounds__(kThreads, 3) norm_act_apply(const Args p) {
  constexpr int kStreams = kRes ? 2 : 1;
  // the reverse of pass 1's block order
  const int blocks = gridDim.x * gridDim.y;
  const int lin = blocks - 1 - (blockIdx.y * gridDim.x + blockIdx.x);
  const int s = lin % p.slabs, b = lin / p.slabs, tid = threadIdx.x;
  const int col = tid % p.cols, row = tid / p.cols, c0 = 8 * col;
  bf162 pb[4], ab[4], w2;
  if (kPre) load_pairs(p.pre_bias, c0, pb);
  if (kAct == kLeakyRelu) load_pairs(p.act_bias, c0, ab);
  if (kAct == kPrelu) w2 = __float2bfloat162_rn(*p.slope);
  wait_prior_pass();  // mean and rstd, pass 1's
  float mean[8], rstd[8];
  const float* mr = p.mr + (long)b * 2 * p.c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mean[j] = mr[c0 + j];
    rstd[j] = mr[p.c + c0 + j];
  }

  __shared__ uint4 ring[kDepth * kThreads];
  const uint4* src[kStreams];
  src[0] = reinterpret_cast<const uint4*>(p.y);
  if constexpr (kRes) src[1] = reinterpret_cast<const uint4*>(p.residual);
  uint4* ov = reinterpret_cast<uint4*>(p.out);
  walk<kStreams, kDepth / kStreams>(
      p, src, ring, (long)b * p.n, p.slab_start(s), p.slab_start(s + 1), row, col,
      [&](const Chunks<kStreams>& in, long pix) {
    const bf162* v = reinterpret_cast<const bf162*>(&in.v[0]);
    const bf162* r = reinterpret_cast<const bf162*>(&in.v[kStreams - 1]);
    uint4 o;
    bf162* h = reinterpret_cast<bf162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(kPre ? add_rn(v[j], pb[j]) : v[j]);
      bf162 u = __floats2bfloat162_rn(__fmul_rn(__fsub_rn(t.x, mean[2 * j]), rstd[2 * j]),
                                      __fmul_rn(__fsub_rn(t.y, mean[2 * j + 1]), rstd[2 * j + 1]));
      if (kRes) u = add_rn(u, r[j]);
      if (kAct == kLeakyRelu) {
        u = leaky_relu_gain(add_rn(u, ab[j]));
      } else if (kAct == kPrelu) {
        const bf162 m = mul_rn(u, w2);
        const float2 f = __bfloat1622float2(u);
        u = __halves2bfloat162(f.x >= 0.f ? __low2bfloat16(u) : __low2bfloat16(m),
                               f.y >= 0.f ? __high2bfloat16(u) : __high2bfloat16(m));
      }
      h[j] = u;
    }
    ov[pix * p.cols + col] = o;
  });
}

typedef void (*Kernel)(Args);

int groups_of(int slabs) { return (slabs + kGroup - 1) / kGroup; }

const Kernel kStats[2] = {norm_act_stats<false>, norm_act_stats<true>};

// the apply pass of each variant, at [pre-bias][residual][activation]
const Kernel kApply[2][2][3] = {
    {{norm_act_apply<false, false, kNone>, norm_act_apply<false, false, kLeakyRelu>,
      norm_act_apply<false, false, kPrelu>},
     {norm_act_apply<false, true, kNone>, norm_act_apply<false, true, kLeakyRelu>,
      norm_act_apply<false, true, kPrelu>}},
    {{norm_act_apply<true, false, kNone>, norm_act_apply<true, false, kLeakyRelu>,
      norm_act_apply<true, false, kPrelu>},
     {norm_act_apply<true, true, kNone>, norm_act_apply<true, true, kLeakyRelu>,
      norm_act_apply<true, true, kPrelu>}}};

}  // namespace

extern "C" {

// Floats of scratch for B images of C channels in `slabs` slabs.
long long ppst_norm_act_scratch_floats(int batch, int c, int slabs) {
  return (long long)batch * (slabs + groups_of(slabs) + 1) * 2 * c;
}

// Counters (unsigned ints, zero before the first launch) for B images in `slabs` slabs.
long long ppst_norm_act_counters(int batch, int slabs) {
  return (long long)batch * (groups_of(slabs) + 1);
}

// Blocks of `threads` threads that an SM can hold at once of every kernel of
// every variant (0 on error).
int ppst_norm_act_resident(int threads) {
  int least = 1 << 30;
  auto take = [&](Kernel k) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, 0) != cudaSuccess)
      blocks = 0;
    least = blocks < least ? blocks : least;
  };
  for (Kernel k : kStats) take(k);
  for (const auto& by_res : kApply)
    for (const auto& by_act : by_res)
      for (Kernel k : by_act) take(k);
  return least;
}

// The chain. y, out (B, n, c) bf16; pre_bias (c,) float32 or null; residual
// (B, n, c) bf16 or null; act_bias (c,) float32 for the leaky ReLU, slope
// (1,) float32 for the PReLU, or both null (not both given); scratch and
// counters as above. c a multiple of 8 up to 2048; y, residual and out
// 16-byte aligned; every pointer a device pointer of a contiguous tensor;
// 1 <= slabs <= n.
int ppst_norm_act(const void* y, const void* pre_bias, const void* residual,
                  const void* act_bias, const void* slope, void* out, void* scratch,
                  void* counters, int batch, int n, int c, int slabs, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0 || slabs < 1 ||
      slabs > n || (act_bias && slope) || (uintptr_t)y % 16 != 0 ||
      (uintptr_t)residual % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.y = (const bf16*)y;
  p.pre_bias = (const float*)pre_bias;
  p.residual = (const bf16*)residual;
  p.act_bias = (const float*)act_bias;
  p.slope = (const float*)slope;
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
  const int act = act_bias ? kLeakyRelu : slope ? kPrelu : kNone;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;

  kStats[pre_bias != nullptr]<<<dim3(slabs, batch), threads, 0, s>>>(p);
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
  err = cudaLaunchKernelEx(&cfg, kApply[pre_bias != nullptr][residual != nullptr][act], p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
