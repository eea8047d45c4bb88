// Blockwise correspondence warp for Hopper (sm_90a):
//   out[b, i, :] = sum_j softmax_j(q[b, i] . k[b, j] / T) v[b, j, :]
// with q (B, Lq, C), k (B, Lk, C), v (B, Lk, Cv) and out (B, Lq, Cv) in v's
// dtype, computed with an online softmax so the Lq x Lk matrix is never held.
//
// Replaces the TPU kernel ppst_tpu/ops/corr_pallas.py::corr_warp_blockwise
// (_kernel). Its arithmetic is kept: logits are products of input-dtype q and
// k with float32 sums, scaled by 1/T; the running max m, the running sum l
// and the accumulator stay in float32; the output is rounded once, at the
// end. Unlike the Pallas kernel, which falls back to a dense einsum when L is
// not a multiple of its block, these kernels mask the tails: keys beyond Lk
// get a logit of -inf, query rows beyond Lq are not stored, so every shape
// runs here.
//
// Bound: operations. At 1024px (Lq = Lk = 16384, C = 512, Cv <= 256) one call
// does 2 Lq Lk (C + Cv) >= 2.3e11 operations on ~35 MB of inputs, far above
// the tensor cores' ratio of operations to bytes. So the bf16 kernel runs
// both products on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// sums): S = Q K^T from shared-memory tiles, and P V with P taken straight
// from S's accumulator registers, rounded to bf16. That rounding of P is what
// the TPU did too (its float32 P V dot ran at default precision, one bf16
// pass); the plain PyTorch version keeps P in float32, and the tolerance
// against it follows from one bf16 rounding of P and of the output.
//
// Block layout (bf16): one block of 4 warps owns 64 query rows (16 a warp)
// and up to 256 value columns; it walks the keys in tiles of 64. The whole
// query tile and one key tile (all C channels, C <= 752) and the value tile,
// transposed, sit in shared memory, padded by 8 elements a row so the
// fragment loads hit 32 distinct banks. Values wider than 256 columns are
// split over gridDim.z; each split recomputes S. Rows are reduced within a
// quad of lanes by shuffles in a fixed order: no atomics, the same result
// from run to run.
//
// float32 inputs take a plain kernel of float32 FMAs (no TF32: products of
// bf16 values are exact in float32, TF32 would round them). It serves the
// float32 checks of the port and is not tuned.
//
// Kernels launch on the caller's stream and allocate nothing. ppst_corr_warp
// returns the first CUDA error of its launch (0 when it was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;       // query rows per bf16 block: 4 warps x 16
constexpr int kBK = 64;       // keys per step
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of padding per shared-memory row
constexpr int kLdv = kBK + kPad;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use on sm_90

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows x cp tile of a row-major (.., c) matrix into shared memory with row
// stride ld; rows >= valid and channels >= c are zero. c % 8 == 0.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int valid,
                                          int rows, int c, int cp) {
  const int vpr = cp / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, e = (i % vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid && e < c) val = *reinterpret_cast<const uint4*>(src + (long)r * c + e);
    *reinterpret_cast<uint4*>(dst + r * ld + e) = val;
  }
}

// Value columns [c0, c0 + NV * 8) of kBK rows, transposed: vt[col][key].
template <int NV>
__device__ __forceinline__ void load_vt(bf16* vt, const bf16* src, int valid, int cv, int c0) {
  constexpr int vpr = NV;  // 16-byte vectors per row of the slice
  for (int i = threadIdx.x; i < kBK * vpr; i += kThreads) {
    const int r = i / vpr, e = (i % vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid && c0 + e < cv)
      val = *reinterpret_cast<const uint4*>(src + (long)r * cv + c0 + e);
    const bf16* h = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(e + j) * kLdv + r] = h[j];
  }
}

// grid (ceil(Lq / 64), B, ceil(Cv / (NV * 8))), kThreads threads; dynamic
// shared memory (kBQ + kBK) * (cp + kPad) + NV * 8 * kLdv bf16 elements.
template <int NV>
__global__ void __launch_bounds__(kThreads)
corr_warp_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int lq, int lk,
                      int c, int cv, float inv_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cp = (c + 15) & ~15;
  const int ldq = cp + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * ldq;
  bf16* vt = ks + kBK * ldq;

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ, c0 = blockIdx.z * NV * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (long)b * lk * c;
  const bf16* vb = v + (long)b * lk * cv;

  load_rows(qs, ldq, q + ((long)b * lq + q0) * c, min(kBQ, lq - q0), kBQ, c, cp);

  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp's 16
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  const bf16* qa = qs + (warp * 16 + g) * ldq + 2 * t;

  for (int k0 = 0; k0 < lk; k0 += kBK) {
    const int kvalid = min(kBK, lk - k0);
    __syncthreads();  // the previous tile is no longer read
    load_rows(ks, ldq, kb + (long)k0 * c, kvalid, kBK, c, cp);
    load_vt<NV>(vt, vb + (long)k0 * cv, kvalid, cv, c0);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int kk = 0; kk < cp; kk += 16) {
      const uint32_t a0 = lds32(qa + kk), a1 = lds32(qa + 8 * ldq + kk);
      const uint32_t a2 = lds32(qa + kk + 8), a3 = lds32(qa + 8 * ldq + kk + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = ks + (nt * 8 + g) * ldq + kk + 2 * t;
        mma_bf16(s[nt], a0, a1, a2, a3, lds32(kp), lds32(kp + 8));
      }
    }

    // online softmax; a quad of lanes holds one row's 64 logits
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < lk ? s[nt][e] * inv_t : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m[h] - mx[h]);  // 0 on the first tile (m = -inf)
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += P V: S's accumulator layout is the A-operand layout of the next
    // product, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const bf16* vp = vt + (j * 8 + g) * kLdv + kk * 16 + 2 * t;
        mma_bf16(acc[j], a0, a1, a2, a3, lds32(vp), lds32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= lq) continue;
    bf16* orow = out + ((long)b * lq + row) * cv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = c0 + j * 8 + 2 * t;  // cv is even, so col + 1 < cv too
      if (col < cv)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[j][2 * h] / l[h], acc[j][2 * h + 1] / l[h]);
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

template <int NV>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int batch,
                        int lq, int lk, int c, int cv, float inv_t, cudaStream_t s) {
  const int cp = (c + 15) & ~15;
  const size_t smem = ((size_t)(kBQ + kBK) * (cp + kPad) + NV * 8 * kLdv) * sizeof(bf16);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(corr_warp_bf16_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, batch, (cv + NV * 8 - 1) / (NV * 8));
  corr_warp_bf16_kernel<NV><<<grid, kThreads, smem, s>>>(q, k, v, out, lq, lk, c, cv, inv_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = softmax(q k^T * inv_t) v per batch entry. dtype 0: float32, 1: bf16,
// for all of q (B, lq, c), k (B, lk, c), v (B, lk, cv) and out (B, lq, cv),
// contiguous device tensors. bf16 needs c % 8 == 0, c <= 752, cv % 8 == 0
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
  if (dtype != 1 || c % 8 || cv % 8) return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)out;
  const int w = cv < 256 ? cv : 256;  // value columns per block
  cudaError_t err;
  if (w <= 32)
    err = launch_bf16<4>(qb, kb, vb, ob, batch, lq, lk, c, cv, inv_t, s);
  else if (w <= 64)
    err = launch_bf16<8>(qb, kb, vb, ob, batch, lq, lk, c, cv, inv_t, s);
  else if (w <= 128)
    err = launch_bf16<16>(qb, kb, vb, ob, batch, lq, lk, c, cv, inv_t, s);
  else
    err = launch_bf16<32>(qb, kb, vb, ob, batch, lq, lk, c, cv, inv_t, s);
  return (int)err;
}

const char* ppst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
