// Separable FIR filter with zero pads and a downsample, on NHWC tensors, for
// Hopper (sm_90a):
//   out[b, oy, ox, c] = sum_k sum_l f[k] f[l] xp[b, oy * down + k, ox * down + l, c]
// with xp = x zero-padded by (p0, p1) on both spatial axes, f the taps
// flipped (f[k] = taps[T - 1 - k]: the filter convolves, as upfirdn2d does),
// down in {1, 2} and an output of (H + p0 + p1 - T) / down + 1 rows (columns
// alike).
//
// Replaces the TPU kernel ppst_tpu/ops/upfirdn2d_pallas.py::upfirdn2d_pallas
// (_kernel). That kernel filters the whole padded image at full resolution,
// in x's dtype, and keeps every down-th sample; this one computes only the
// samples it keeps, sums in float32 and rounds once, at the store. For
// float32 the two agree to rounding; for bf16 this one is the more exact.
//
// Bound: bytes. Each output does 2T (down 1) or 3T (down 2) multiply-adds
// in the separable form, far below the operations the card does per byte, so
// the least time is x read once and out written once at the memory rate.
//
// Two routes; the wrapper (ops/upfirdn2d_cuda.py) picks one from the shape
// and the pointers, never from a failure:
//
// TMA route (ppst_upfirdn2d_tma), when C * itemsize is a multiple of 16 and
// both pointers are 16-byte aligned (the StyleGAN stack's C of 128-512 all
// are). Work is cut into items: one sample, a strip of `tw` output columns x
// `cg` 16-byte channel groups (up to 256 bytes of each pixel), and `rh`
// output rows. The wrapper's tma_plan chooses every number of the items'
// geometry; the C entry only checks that they cover the output and fit the
// block. A persistent grid (about two blocks an SM) walks the items in a
// static order (block g
// takes items g, g + grid, ...; channel strips fastest, then column strips,
// so the blocks in flight share their halo columns in L2). A block is 8
// consumer warps (one thread per output column and channel group) and one
// producer warp, whose one thread keeps a ring of kStages bands in flight:
// each band is one TMA box of `rows` input rows x bw = (tw - 1) down + T
// input columns x cg groups from a 4-D map over (C, W, H, B), started at
// (channel strip, ox0 down - p0, oy0 down - p0 + k rows, b). Negative starts
// and reads past W or H come back as zeros, which is the zero pad: the load
// side masks nothing. Each input row reaches the SM once (only the T - 1
// halo columns of a strip and rows of an item are read twice, mostly from
// L2), in bands completed on mbarriers; the consumers hand a band back on its
// empty mbarrier after a proxy fence (their plain shared loads must be
// ordered before the next TMA write into it).
// A consumer sums its column's input row horizontally once (T taps, float32,
// read from the band in shared memory) and keeps the last T row sums in
// registers; at each kept output row it weights them by the vertical taps
// and stores 16 bytes (channels fastest, so a warp's stores are contiguous).
// T = 4 and down in {1, 2} are template parameters with the taps unrolled; a
// general instance takes any T <= 8. Tile indices are 32-bit; only the
// output row pointer is 64-bit.
//
// Generic route (ppst_upfirdn2d), for every other shape: one thread per
// output element (one channel of a pixel), channels fastest; the T^2 reads of
// neighbouring pixels hit L1/L2.
//
// Both sum in a fixed order (each row horizontally, then the rows weighted
// by the vertical taps): the result is the same from run to run. The
// kernels launch on the caller's stream and allocate nothing. Each C entry
// returns the first CUDA error of its launch (0 when it was accepted).

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks an SM

struct Taps {
  float v[kMaxTaps];
};

// 16 bytes of channels (4 float32 or 8 bf16) to and from float32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
}

__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// one element to and from float32
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------- TMA route

constexpr int kConsumers = 256;               // 8 consumer warps
constexpr int kTmaThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 3;                    // bands in the ring
constexpr int kMaxBox = 256;                  // TMA's largest box side
constexpr int kMaxSmem = 232448;              // bytes of shared memory a block can use

// The items' geometry, as the wrapper's tma_plan chose it (ppst_upfirdn2d_tma
// only checks it).
struct Plan {
  int oh, ow, c, p0, nt;
  int groups;       // 16-byte channel groups of a pixel
  int cg;           // groups a strip
  int tw, bw;       // output columns of a strip, input columns of a band
  int rows;         // input rows of a band
  int rh;           // output rows of an item
  int ncs, nxs, nys, items;
  int stage_bytes;  // a band's bytes, a multiple of 128
};

struct Item {
  int b, cs, ox0, oy0, nin, nbands;
};

template <int DOWN>
__device__ __forceinline__ Item decode(int i, const Plan& p, int nt) {
  Item it;
  it.cs = i % p.ncs;
  i /= p.ncs;
  it.ox0 = (i % p.nxs) * p.tw;
  i /= p.nxs;
  it.oy0 = (i % p.nys) * p.rh;
  it.b = i / p.nys;
  const int nrows = min(p.rh, p.oh - it.oy0);
  it.nin = (nrows - 1) * DOWN + nt;
  it.nbands = (it.nin + p.rows - 1) / p.rows;
  return it;
}

// kTmaThreads threads, kStages * p.stage_bytes + 128 + 16 kStages bytes of
// dynamic shared memory. NT = 0 is the general instance (p.nt <= 8 taps).
// fh: the flipped taps; fv: the same right-aligned in KT slots (fv[KT - nt +
// k] = f[k]), so that the vertical sum indexes its row history statically.
template <typename T, int NT, int DOWN>
__global__ void __launch_bounds__(kTmaThreads, NT ? 2 : 1)
    upfirdn2d_tma_kernel(const __grid_constant__ CUtensorMap tm_x, T* __restrict__ out, Taps fh,
                         Taps fv, Plan p) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KT = NT ? NT : kMaxTaps;
  const int nt = NT ? NT : p.nt;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* const bands = smem_raw + (base - raw);
  const uint32_t bar = base + kStages * p.stage_bytes;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread walks the block's items band by band
    if (threadIdx.x == kConsumers) {
      const uint32_t box_bytes = p.rows * p.bw * p.cg * 16;
      const int cge = p.cg * VEC;  // channels of a strip
      int s = 0;
      uint32_t ph = 0;
      for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
        const Item it = decode<DOWN>(i, p, nt);
        const int ix0 = it.ox0 * DOWN - p.p0, iy0 = it.oy0 * DOWN - p.p0;
        for (int k = 0; k < it.nbands; ++k) {
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), box_bytes);
          tma_load4(base + s * p.stage_bytes, &tm_x, it.cs * cge, ix0, iy0 + k * p.rows, it.b,
                    full(s));
          if (++s == kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: thread (j, g) owns output column j of the strip, channel group g
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x / p.cg, g = threadIdx.x - j * p.cg;
  const bool active = j < p.tw;
  const int row_bytes = p.bw * p.cg * 16;  // one input row of a band
  const unsigned char* const mine = bands + (j * DOWN * p.cg + g) * 16;
  const size_t out_row = (size_t)p.ow * p.c;
  int s = 0;
  uint32_t ph = 0;
  for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
    const Item it = decode<DOWN>(i, p, nt);
    const int group = it.cs * p.cg + g;
    const bool keep = active && it.ox0 + j < p.ow && group < p.groups;
    T* optr = keep ? out + ((size_t)it.b * p.oh + it.oy0) * out_row +
                         (size_t)(it.ox0 + j) * p.c + group * VEC
                   : nullptr;
    float hist[KT][VEC];  // the last KT row sums, oldest first
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) hist[k][v] = 0.f;
    int row = 0;  // input row of the item
    for (int k = 0; k < it.nbands; ++k) {
      mbar_wait(full(s), ph);
      if (active) {
        const int nr = min(p.rows, it.nin - k * p.rows);
        const unsigned char* src = mine + s * p.stage_bytes;
        for (int r = 0; r < nr; ++r, ++row, src += row_bytes) {
          float h[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) h[v] = 0.f;
#pragma unroll
          for (int l = 0; l < KT; ++l) {
            if (NT || l < nt) {
              float x[VEC];
              load16(reinterpret_cast<const T*>(src + l * p.cg * 16), x);
#pragma unroll
              for (int v = 0; v < VEC; ++v) h[v] = fmaf(fh.v[l], x[v], h[v]);
            }
          }
#pragma unroll
          for (int kk = 0; kk + 1 < KT; ++kk)
#pragma unroll
            for (int v = 0; v < VEC; ++v) hist[kk][v] = hist[kk + 1][v];
#pragma unroll
          for (int v = 0; v < VEC; ++v) hist[KT - 1][v] = h[v];
          // output row (row - nt + 1) / DOWN is complete at this input row
          const int r0 = row - (nt - 1);
          if (r0 >= 0 && (DOWN == 1 || (r0 & 1) == 0)) {
            float o[VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v) o[v] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
              if (NT || kk >= KT - nt) {
#pragma unroll
                for (int v = 0; v < VEC; ++v) o[v] = fmaf(fv.v[kk], hist[kk][v], o[v]);
              }
            }
            if (keep) {
              store16(optr, o);
              optr += out_row;
            }
          }
        }
      }
      // plain shared loads, ordered before the next TMA write into the band
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (++s == kStages) s = 0, ph ^= 1;
    }
  }
}

template <typename T, int NT, int DOWN>
cudaError_t launch_tma(const CUtensorMap& map, void* out, const Taps& fh, const Taps& fv,
                       const Plan& p, int grid, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(upfirdn2d_tma_kernel<T, NT, DOWN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  upfirdn2d_tma_kernel<T, NT, DOWN><<<grid, kTmaThreads, smem, s>>>(map, (T*)out, fh, fv, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tma(const CUtensorMap& map, void* out, const Taps& fh, const Taps& fv,
                         const Plan& p, int down, int grid, int smem, cudaStream_t s) {
  if (p.nt == 4)
    return down == 1 ? launch_tma<T, 4, 1>(map, out, fh, fv, p, grid, smem, s)
                     : launch_tma<T, 4, 2>(map, out, fh, fv, p, grid, smem, s);
  return down == 1 ? launch_tma<T, 0, 1>(map, out, fh, fv, p, grid, smem, s)
                   : launch_tma<T, 0, 2>(map, out, fh, fv, p, grid, smem, s);
}

// ------------------------------------------------------------ generic route

// One channel of an output pixel a thread. total = B * OH * OW * C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ out, Taps f, int ntaps, int h,
                     int w, int c, int oh, int ow, int p0, int down, long long total) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int ch = (int)(i % c);
    long long p = i / c;
    const int ox = (int)(p % ow);
    p /= ow;
    const int oy = (int)(p % oh);
    const long long b = p / oh;
    const int y0 = oy * down - p0, x0 = ox * down - p0;
    float acc = 0.f;
    for (int k = 0; k < ntaps; ++k) {
      const int y = y0 + k;
      if (y < 0 || y >= h) continue;  // a zero pad row adds nothing
      const T* row_ptr = x + ((b * h + y) * w) * (long long)c + ch;
      float row = 0.f;
      for (int l = 0; l < ntaps; ++l) {
        const int xx = x0 + l;
        if (xx < 0 || xx >= w) continue;
        row = fmaf(f.v[l], to_float(row_ptr[(long long)xx * c]), row);
      }
      acc = fmaf(f.v[k], row, acc);
    }
    store1(out + i, acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const Taps& f, int ntaps, int batch, int h, int w,
                   int c, int oh, int ow, int p0, int down, cudaStream_t s) {
  const long long total = (long long)batch * oh * ow * c;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  upfirdn2d_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)x, (T*)out, f, ntaps, h, w, c, oh,
                                                  ow, p0, down, total);
  return cudaGetLastError();
}

bool valid_args(int dtype, int batch, int h, int w, int c, int oh, int ow, int ntaps, int p0,
                int down) {
  return ntaps >= 1 && ntaps <= kMaxTaps && batch >= 1 && h >= 1 && w >= 1 && c >= 1 &&
         oh >= 1 && ow >= 1 && p0 >= 0 && (down == 1 || down == 2) && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// x (B, H, W, C) and out (B, OH, OW, C), contiguous, of one dtype (0 float32,
// 1 bf16), device pointers; taps (ntaps <= 8 floats, host memory) already
// flipped. The wrapper has checked the shapes: OH = (H + p0 + p1 - ntaps) /
// down + 1 and OW alike.
int ppst_upfirdn2d(const void* x, void* out, int dtype, int batch, int h, int w, int c, int oh,
                   int ow, const float* taps, int ntaps, int p0, int down, void* stream) {
  if (!valid_args(dtype, batch, h, w, c, oh, ow, ntaps, p0, down))
    return (int)cudaErrorInvalidValue;
  Taps f;
  for (int i = 0; i < kMaxTaps; ++i) f.v[i] = i < ntaps ? taps[i] : 0.f;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch<float>(x, out, f, ntaps, batch, h, w, c, oh, ow, p0, down, s)
                          : launch<bf16>(x, out, f, ntaps, batch, h, w, c, oh, ow, p0, down, s));
}

// The TMA route, same arguments, plus the plan (ops/upfirdn2d_cuda.py's
// TmaPlan): cg 16-byte channel groups and tw output columns a strip, bw input
// columns and `rows` input rows a band, rh output rows an item, ncs, nxs and
// nys strips along channels, columns and rows, `items` in all, `stage` bytes
// a band, `smem` bytes of dynamic shared memory, `grid` persistent blocks.
// Returns cudaErrorInvalidValue unless C * itemsize is a multiple of 16, both
// pointers are 16-byte aligned, the strips and items cover the output, a
// band holds its columns (bw >= (tw - 1) down + ntaps), a block has at most
// 256 consumer threads, a box side is at most 256 and the ring fits `smem`
// within a block's shared memory.
int ppst_upfirdn2d_tma(const void* x, void* out, int dtype, int batch, int h, int w, int c,
                       int oh, int ow, const float* taps, int ntaps, int p0, int down, int cg,
                       int tw, int bw, int rows, int rh, int ncs, int nxs, int nys, int items,
                       int stage, int smem, int grid, void* stream) {
  if (!valid_args(dtype, batch, h, w, c, oh, ow, ntaps, p0, down))
    return (int)cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : 2;
  if ((c * isz) % 16 || (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const int groups = c * isz / 16;
  const bool fits = cg >= 1 && cg <= 16 && tw >= 1 && (long long)tw * cg <= kConsumers &&
                    bw >= (tw - 1) * down + ntaps && bw <= kMaxBox && rows >= 1 &&
                    rows <= kMaxBox && rh >= 1 && stage % 128 == 0 &&
                    (long long)stage >= (long long)rows * bw * cg * 16 &&
                    (long long)kStages * stage + 128 + 16 * kStages <= smem && smem <= kMaxSmem;
  const bool covers = (long long)ncs * cg >= groups && (long long)nxs * tw >= ow &&
                      (long long)nys * rh >= oh &&
                      (long long)items == (long long)batch * ncs * nxs * nys;
  if (!fits || !covers || grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
  Plan p;
  p.oh = oh, p.ow = ow, p.c = c, p.p0 = p0, p.nt = ntaps, p.groups = groups;
  p.cg = cg, p.tw = tw, p.bw = bw, p.rows = rows, p.rh = rh;
  p.ncs = ncs, p.nxs = nxs, p.nys = nys, p.items = items, p.stage_bytes = stage;
  Taps fh, fv;
  for (int i = 0; i < kMaxTaps; ++i) {
    fh.v[i] = i < ntaps ? taps[i] : 0.f;
    // right-aligned for the general instance; the T = 4 instance reads fv[0..3]
    const int kt = ntaps == 4 ? 4 : kMaxTaps, k = i - (kt - ntaps);
    fv.v[i] = k >= 0 && k < ntaps ? taps[k] : 0.f;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)c * isz, (cuuint64_t)c * w * isz,
                                 (cuuint64_t)c * w * h * isz};
  const cuuint32_t box[4] = {(cuuint32_t)(p.cg * 16 / isz), (cuuint32_t)p.bw, (cuuint32_t)rows,
                             1};
  CUtensorMap map;
  if (!encode_map(&map,
                  dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_tma<float>(map, out, fh, fv, p, down, grid, smem, s)
                          : dispatch_tma<bf16>(map, out, fh, fv, p, down, grid, smem, s));
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
