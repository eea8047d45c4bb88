// Device and host helpers shared by the fused tap's forward (tap.cu, K1) and
// backward (tap_bwd.cu, K2): the static schedule of persistent blocks, the
// per-(sample, block) records of partial statistics and their fixed-order
// sums, the 128-byte swizzle of the TMA tiles, the wgmma shapes the two
// kernels issue, and the bf16 pair helpers. The Hopper building blocks (TMA,
// mbarriers, descriptors) are in hopper.cuh.
//
// Every pass of both kernels has the same shape, that of K3 and K6: one block
// an SM of three warpgroups. Warpgroups 0 and 1 are consumers (setmaxnreg
// raises them to 232 registers); warpgroup 2 is the producer (cut to 40),
// whose one thread keeps a ring of item tiles in flight by TMA. A sample's n
// pixels make T = ceil(n / 128) items of 128 pixels; item i = b T + tile;
// consumer warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item (one
// wgmma's M). Block g of G walks the contiguous items [lo(g), lo(g + 1)),
// lo(g) = floor(g total / G): a static schedule, the same on every run. The
// tensor maps are 3-D over (channels, pixels, samples) with boxes of 64 x 128
// x 1, 128B-swizzled, so that a tile never crosses a sample and the ragged
// tail reads as zeros; the consumers wait on each stage's full mbarrier and
// give it back on its empty one.
//
// Statistics: a block keeps per-thread running sums while its items stay in
// one sample, and when the sample changes (or its items end) it sums them
// over its threads in a fixed order into record b + g of a (B + G - 1, 2, C)
// buffer: along the staircase of (sample, block) pairs that meet, b + g grows
// by one or two at each step, so no two pairs share a record. The next pass
// sums sample b's records over its blocks g in order: every block that needs
// them gets the same bits, and no float atomics are used anywhere.

#pragma once

#include "hopper.cuh"

// An unnamed namespace: each source that includes this keeps its own copy.
namespace {

using bf16 = __nv_bfloat16;

constexpr int kP = 128;                // pixels of an item
constexpr int kTileBytes = kP * 128;   // 128 pixels x 64 bf16 channels: 16 KB
constexpr int kHalfBytes = kTileBytes / 2;  // a consumer warpgroup's 64 rows of it
constexpr int kWBytes = 64 * 128;      // a 64 x 64 bf16 weight tile: 8 KB
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block can use on sm_90
constexpr int kAlign = 1024;           // 128B swizzle atoms: 8 rows x 128 bytes
constexpr float kEps = 1e-5f;

// The static schedule of a pass over `total` items of T a sample on G blocks.
struct Sched {
  long total;
  int T, G;
  __host__ __device__ long lo(int g) const { return (long)g * total / G; }
  // the block whose items hold item i: the largest g with lo(g) <= i
  __host__ __device__ int block_of(long i) const { return (int)(((i + 1) * G - 1) / total); }
  __host__ __device__ int first_block(int b) const { return block_of((long)b * T); }
  __host__ __device__ int last_block(int b) const { return block_of((long)b * T + T - 1); }
};

// G = the SMs, or fewer when there are fewer items: every block gets at
// least one.
inline Sched make_sched(int batch, int n, int sms) {
  Sched s;
  s.T = (n + kP - 1) / kP;
  s.total = (long)batch * s.T;
  const long g = sms > 0 ? sms : 1;
  s.G = (int)(g < s.total ? g : s.total);
  return s;
}

// Floats of a pass's records: B + G - 1 of 2 C floats, for any G <= sms.
inline long record_floats(int batch, int sms, int c) {
  return ((long)batch + sms - 1) * 2 * c;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The register split of the three warpgroups (as K3's and K6's).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// Programmatic dependent launch. A pass is launched so that its blocks may
// start as the previous pass's blocks exit (a block of either fills an SM's
// shared memory, so the two never share an SM): its producer prefetches the
// tensors no earlier pass writes, and it waits here before it reads anything
// the previous pass wrote (the CUDA runtime guarantees those writes are then
// complete and visible). Every pass lets the next one launch at its start.
__device__ __forceinline__ void wait_prior_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_pass() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launches a pass on `grid` blocks of kThreads on `st`; with `after_pass` it
// may begin before the launch ahead of it on the stream ends (see above).
template <typename... Exp, typename... Act>
cudaError_t launch_pass(void (*kernel)(Exp...), int grid, int smem, cudaStream_t st,
                        bool after_pass, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after_pass ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Generic-proxy writes to shared memory, made visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of byte `b` of row `r` in a tile of 128-byte rows that TMA
// wrote with the 128-byte swizzle (tile 1024-byte aligned): the 16-byte
// chunks of a row are permuted by the row's index mod 8.
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// Channels c, c + 1 (c even, < 64) of row r of a swizzled tile.
__device__ __forceinline__ float2 lds_pair(const unsigned char* tile, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swz(r, 2 * c)));
}

__device__ __forceinline__ void sts_pair(unsigned char* tile, int r, int c, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + swz(r, 2 * c)) = v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A compensated (Kahan) running sum: s - c is the sum with its lost low bits.
// A thread's plain float32 running sum of bf16 squares over thousands of
// rows drifts systematically (-4e-6 relative at 2000 rows: the squares' short
// mantissas round to even at the same points); the compensated one does not.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

__device__ __forceinline__ float prelu(float y, float a) {
  return fmaxf(y, 0.f) + a * fminf(y, 0.f);
}

// Keeps the compiler from reusing A-fragment registers while a wgmma reads them.
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The fragment layouts (one thread of consumer warpgroup wg: warp w of the
// warpgroup, lane l, g = l / 4, q = l % 4). Accumulator element 4 j + 2 h + e
// of an m64nN tile is row 16 w + g + 8 h, column 8 j + 2 q + e. A bf16 pair
// p = 2 j + h is that row and columns 8 j + 2 q, + 1; for the A operand of a
// k16 step kk, registers 0-3 are the pairs 4 kk .. 4 kk + 3 of the same
// layout over K: an accumulator rounded to bf16 pairs is an A operand as it
// lies. frag_row gives the row within the item: warpgroup wg's rows follow
// 64 wg.
__device__ __forceinline__ int frag_row(int wg, int w, int g, int h) {
  return 64 * wg + 16 * w + g + 8 * h;
}

#define TAP_ACC32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define TAP_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TAP_D64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, float32) (+)= A (64 x 16, bf16 pairs in registers) B (16 x 64,
// bf16 in shared memory; TB = 0 K-major, 1 MN-major); overwritten when
// accumulate is 0.
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TAP_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : TAP_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// The same with N = 128.
template <int TB>
__device__ __forceinline__ void wgmma_rs128(float* d, const uint32_t* a, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TAP_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : TAP_ACC32(d), TAP_ACC32((d + 32))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (64 x 64, float32) (+)= A (64 x 16) B (16 x 64), both bf16 in shared
// memory; TA / TB = 1 reads A / B MN-major (transposed), 0 K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TAP_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : TAP_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef TAP_ACC32
#undef TAP_D32
#undef TAP_D64

// A 4 x 4 transpose of 32-bit words across the 4 lanes q of a quad: word c of
// lane q becomes word q of lane c (csrc/styled_conv.cu's). w[c] holds
// channels 8 c + 2 q, + 1 of 4 consecutive 8-channel blocks; after it lane q
// holds the 8 channels of block q in order, 16 contiguous bytes.
__device__ __forceinline__ void quad_transpose(uint32_t* w, int q) {
  const bool a = q & 2, b = q & 1;
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

// The sum of v over the 8 lanes of a warp that share l % 4 (lanes g = 0..7),
// in a fixed order; lanes 0-3 hold it.
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float sum_warp(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Ring cursor of a consumer.
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ void next(int stages) {
    if (++st == stages) st = 0, ph ^= 1;
  }
};

// A consumer warp gives its stage back: one arrival on the empty barrier
// after every lane is done with it. The proxy fence orders the lanes' reads
// of the stage (generic proxy) before the producer's next TMA write into it
// (async proxy): without it, a few rows a call were read after that write
// had begun (K1 returned 2-19 wrong rows of u a call on an H100).
__device__ __forceinline__ void release(uint32_t empty_bar, int lane) {
  fence_async_smem();
  __syncwarp();
  if (lane == 0) mbar_arrive(empty_bar);
}

// The producer thread: for each item, boxes[k] 64-channel tiles of maps[k],
// in order, back to back into stage i % STAGES.
template <int STAGES, int NMAPS>
__device__ void produce(const CUtensorMap* const (&maps)[NMAPS], const int (&boxes)[NMAPS],
                        uint32_t ring, uint32_t full, uint32_t empty, const Sched& sc, long lo,
                        long hi) {
  int tiles = 0;
#pragma unroll
  for (int k = 0; k < NMAPS; ++k) tiles += boxes[k];
  const int stage_bytes = tiles * kTileBytes;
  int st = 0;
  uint32_t ph = 0;
  for (long i = lo; i < hi; ++i) {
    const int b = (int)(i / sc.T), p0 = (int)(i % sc.T) * kP;
    mbar_wait(empty + 8 * st, ph ^ 1);
    mbar_expect_tx(full + 8 * st, stage_bytes);
    uint32_t dst = ring + st * stage_bytes;
#pragma unroll
    for (int k = 0; k < NMAPS; ++k)
      for (int x = 0; x < boxes[k]; ++x, dst += kTileBytes)
        tma_load(dst, maps[k], 64 * x, p0, b, full + 8 * st);
    if (++st == STAGES) st = 0, ph ^= 1;
  }
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (smem_addr(raw) & (kAlign - 1))) & (kAlign - 1));
}

// full[s] (the producer's expect_tx) and empty[s] (one arrival a consumer
// warp) for each stage, then the weights' barrier when `weights`.
__device__ void init_bars(uint32_t bar, int stages, bool weights) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (stages + s), kConsumerWarps);
    }
    if (weights) mbar_init(bar + 16 * stages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// out[i] = scale * (sum over sample b's records of `rec`, in block order) for
// the 2 C values i, by the consumer threads, 16 loads in flight a thread.
__device__ void sum_records(const float* rec, const Sched& s, int b, int c, float scale,
                            float* out) {
  const int g0 = s.first_block(b), g1 = s.last_block(b) + 1;
  for (int i = threadIdx.x; i < 2 * c; i += kConsumers) {
    const float* r = rec + (long)b * 2 * c + i;
    float acc = 0.f;
    int g = g0;
    for (; g + 16 <= g1; g += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = __ldcg(r + (long)(g + u) * 2 * c);
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += v[u];
    }
    for (; g < g1; ++g) acc += __ldcg(r + (long)g * 2 * c);
    out[i] = acc * scale;
  }
}

// Mean and rstd of c channels from the sums in st[0, c) and squares in
// st[c, 2 c) over n pixels (one pass, var = max(E[v^2] - E[v]^2, 0)), in
// place; sample b's first block of this pass also writes them to mr (B, 2, c).
__device__ void finish_moments(float* st, int c, int n, float* mr, int b, bool owner) {
  for (int i = threadIdx.x; i < c; i += kConsumers) {
    const float mean = st[i] / (float)n;
    const float var = fmaxf(st[c + i] / (float)n - mean * mean, 0.f);
    const float rstd = rsqrtf(var + kEps);
    st[i] = mean;
    st[c + i] = rstd;
    if (owner) {
      mr[(long)b * 2 * c + i] = mean;
      mr[(long)b * 2 * c + c + i] = rstd;
    }
  }
}

// A 3-D bf16 map over a (B, n, c) tensor as (c, n, B), boxes of 64 channels x
// 128 pixels x 1 sample, 128B-swizzled; pixels past n read as zeros.
bool encode_act_map(CUtensorMap* map, const void* ptr, int batch, int n, int c) {
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)n * c * 2};
  const cuuint32_t box[3] = {64, kP, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A weight (rows, cols) bf16, row-major, as (cols, rows, 1), boxes of 64 x 64.
bool encode_weight_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Sets a kernel's dynamic shared memory once per process and device; `done`
// holds a flag for each of the first 64 devices.
template <typename K>
cudaError_t set_smem_once(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (dev < 64) done[dev] = err == cudaSuccess;
  return err;
}

}  // namespace
