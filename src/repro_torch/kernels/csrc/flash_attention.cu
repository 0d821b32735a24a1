// Flash attention forward for Hopper (sm_90a): causal or non-causal
// attention with an optional sliding window and grouped-query heads,
// softmax(q k^T * D^-0.5) v with an online softmax, f32 accumulation, the
// output in q's type.
//
// Replaces the TPU kernel flash_attention_pallas / _kernel
// (src/repro/kernels/flash_attention/flash_attention.py:81). That kernel
// walks a sequential grid (B*H, S/BQ, S/BK) and keeps the (BQ, D) output
// block and the running max and denominator in VMEM scratch across the KV
// axis. Hopper's blocks run in parallel and in no order, so here the KV
// axis is a loop inside the block: one block owns one (batch, head, 64-row
// query tile) from start to end and carries its running state in
// registers.
//
//   q (B, H, S, D), k and v (B, KV, S, D), o (B, H, S, D), each read and
//   written through its own element strides for b, h and s (d is
//   contiguous), so the caller can pass (B, S, H, D) projections as
//   transposed views with no copy. Query head h reads kv head h / (H / KV):
//   K and V are never expanded to H heads.
//   T is float or __nv_bfloat16; D is 64 or 128; any S >= 1.
//
// What bounds it on this card: operations. A causal prefill does about
// 2 * 2 * B*H * S^2/2 * D flops on 4 * B*H*S*D elements; at the llama3.2-1b
// shape (B=1, H=32, S=4096, D=64) that is 68.7 GFLOP on 67 MB of bf16, so
// the least time is the tensor cores' 0.0695 ms. This first version uses the
// CUDA cores in f32 (67 TFLOP/s: 1.03 ms for the same work); tensor cores,
// wgmma and TMA are a later version's.
//
// What the design does about it, within the CUDA cores. Tiles of 64 query
// rows by 64 keys; 256 threads, thread (ty, tx) in a 16 x 16 grid owns rows
// ty + 16i and key columns tx + 16j (i, j < 4) of the score tile, and rows
// ty + 16i by columns 64c + 4tx + e of the output. Q, K, V and P are staged
// in shared memory as f32 with rows padded to D + 4 (or 68) floats, so every
// inner-loop read is a 16-byte vector that is either a broadcast or
// conflict-free: 8 vector loads feed 64 FMAs. The row max and sum of a row
// are reduced across the 16 lanes that hold it with warp shuffles. Query
// tiles are issued heaviest first (the last causal tile sees the most keys)
// to shorten the tail wave.
//
// Masking follows the TPU kernel. Masked scores get the finite sentinel
// -1e30, not -inf: when a row's first visited tile is fully masked (a
// window), exp(s - m) = exp(0) adds junk to the row's sum and output that
// the next tile's alpha = exp(-1e30 - m) wipes out exactly; with -inf it
// would be exp(-inf + inf) = NaN. Tiles are skipped with the TPU kernel's
// predicate: causal tiles wholly above the diagonal, and tiles wholly left
// of the window. Keys past S (the ragged last tile) are masked as well, and
// query rows past S are computed but not stored.
//
// The kernel allocates nothing, launches on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPP = kBK + 4;  // padded row of the P tile, in floats
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, KV;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int causal, window;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 4) + kBQ * kPP);
}

// rows [s0, s0 + rows) of a (S, D) head with row stride `rs` into a padded
// f32 tile; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int s0,
                                          int S, long long rs) {
  constexpr int P = D + 4;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * P + d] = s0 + r < S ? to_f32(src[(s0 + r) * rs + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  constexpr int P = D + 4;
  constexpr int C = D / 64;  // 64-wide column groups of the output
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kBQ * P;
  float* sv = sk + kBK * P;
  float* sp = sv + kBK * P;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const T* q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* k = static_cast<const T*>(a.k) + b * a.kb + kvh * a.kh;
  const T* v = static_cast<const T*>(a.v) + b * a.vb + kvh * a.vh;
  T* o = static_cast<T*>(a.o) + b * a.ob + h * a.oh;

  load_tile<T, D>(sq, q, q0, a.S, a.qs);

  float m[4], l[4], acc[4][C][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int nk = (a.S + kBK - 1) / kBK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    // the TPU kernel's block skip (uniform across the block)
    if (a.causal && k0 > q0 + kBQ - 1) break;
    if (a.window > 0 && !(k0 + kBK - 1 > q0 - a.window)) continue;

    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, D>(sk, k, k0, a.S, a.ks);
    load_tile<T, D>(sv, v, k0, a.S, a.vs);
    __syncthreads();

    // scores: s[i][j] = q[ty + 16i] . k[tx + 16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * P + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * P + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < a.S;
        if (a.causal) ok = ok && col <= row;
        if (a.window > 0) ok = ok && col > row - a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_cur);
        sum += p;
        sp[(ty + 16 * i) * kPP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_cur);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc[i][c][e] += sum over keys of p[ty + 16i][key] v[key][64c + 4tx + e]
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&sp[(ty + 16 * i) * kPP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sv[(kk + u) * P + 64 * c + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                           : u == 2 ? pr[i].z : pr[i].w;
            acc[i][c][0] = fmaf(pu, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pu, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pu, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pu, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&o[row * a.os + 64 * c + 4 * tx + e], acc[i][c][e] / denom);
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, B * a.H);
  flash_fwd<T, D><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, for q, k,
// v and o in turn, of the batch, head and sequence axes (d is contiguous).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int D,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || S < 1 || H % KV != 0 || window < 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, S, H, KV,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11], causal, window, scale};
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)o;
  if (addr % (dtype == 0 ? 4 : 2) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return launch<float, 64>(a, B, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, B, st);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(a, B, st);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
