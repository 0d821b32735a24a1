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
// axis is a loop inside the block: one block owns one (batch, head, query
// tile) from start to end and carries its running state in registers.
//
//   q (B, H, S, D), k and v (B, KV, S, D), o (B, H, S, D), each read and
//   written through its own element strides for b, h and s (d is
//   contiguous), so the caller can pass (B, S, H, D) projections as
//   transposed views with no copy. Query head h reads kv head h / (H / KV):
//   K and V are never expanded to H heads. D is 64, 128 or 256; any S >= 1.
//
// Two kernels, one per input type:
//   flash_fwd_wgmma (bf16): both products on the tensor cores (wgmma), fed
//     by TMA; described below.
//   f32::flash_fwd (f32): the products in exact f32 on the CUDA cores. The
//     tensor cores would take f32 as TF32 (about 10 bits of mantissa),
//     which misses the f32 path's 1e-4 checks.
//
// What bounds it on this card: operations. A causal prefill does about
// 2 * 2 * B*H * S^2/2 * D flops on 4 * B*H*S*D elements; at the llama3.2-1b
// shape (B=1, H=32, S=4096, D=64) that is 68.7 GFLOP on 67 MB of bf16, so
// the least time is the tensor cores' 0.0695 ms (the CUDA cores' f32 rate
// would need 1.03 ms). recurrentgemma-2b's local layers (10 heads over one
// kv head, D = 256, window 2048) do 64.4 GFLOP per S = 4096 prefill.
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
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// ------------------------------------------------------------------ f32
// Tiles of 64 query rows by 64 keys; 256 threads, thread (ty, tx) in a
// 16 x 16 grid owns rows ty + 16i and key columns tx + 16j (i, j < 4) of
// the score tile, and rows ty + 16i by columns 64c + 4tx + e of the output.
// Q, K, V and P are staged in shared memory as f32 with rows padded to D + 4
// (or 68) floats, so every inner-loop read is a 16-byte vector that is
// either a broadcast or conflict-free: 8 vector loads feed 64 FMAs. The row
// max and sum of a row are reduced across the 16 lanes that hold it with
// warp shuffles. Query tiles are issued heaviest first (the last causal
// tile sees the most keys) to shorten the tail wave. At D = 256 the three
// staged tiles and P take 217,088 bytes of shared memory, under the
// 232,448 a block may opt in to.
namespace f32 {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPP = kBK + 4;  // padded row of the P tile, in floats
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

}  // namespace f32

// ----------------------------------------------------------------- bf16
// flash_fwd_wgmma: at D = 64 and 128 a block of 288 threads owns 128 query
// rows of one (batch, head): two consumer warpgroups of 64 rows each
// (wgmma's M) and one producer warp; at D = 256 a block of 160 threads owns
// 64 rows, with one consumer warpgroup (see the register budget below).
// The producer's first lane loads the Q tile once and
// then streams K/V tiles of BK keys (128 at D = 64, else 64) through
// a ring of two shared-memory stages with TMA; each stage has a "full"
// mbarrier (the TMA bytes have landed) and an "empty" one (all 8 consumer
// warps are done with it). TMA
// reads q, k and v through 4-d tensor maps (d, s, head, batch) built from
// their strides on the host, writes 128-byte-swizzled tiles, and
// zero-fills rows past S.
//
// Per K/V tile a consumer warpgroup computes
//   S = Q·Kᵀ   wgmma m64nBKk16, Q and K from shared memory (K-major), D/16
//              steps, f32 accumulators in registers (BK/2 a thread);
//   P = 2^(S·D^-0.5·log2(e) − m)  with the running row max m, -1e30 where
//              masked; only tiles that cut the diagonal, the window's edge
//              or the end of the sequence compute the mask;
//   O += P·V   as two wgmma m64nDk16 per 16 keys, O += P_hi·V + P_lo·V with
//              P_hi = bf16(P) and P_lo = bf16(P − P_hi) in registers (the
//              accumulator layout of S is the A-operand layout of P), V
//              from shared memory (MN-major, the transpose bit).
// P rounded once to bf16 would put a relative error of up to 2^-8 on each
// weight, which adds up to several times the one bf16 rounding of the
// output that the bf16 path is held to; P_hi + P_lo carries P to within
// 2^-16 of itself, for 1.5 times the tensor-core work of the plain
// algorithm. The row sum l is taken from the
// f32 P. At the end O / max(l, 1e-30) is rounded once to bf16, staged in
// shared memory and stored through o's strides in 16-byte rows (rows past
// S are not stored).
//
// Registers bound the tile: 9 warps share an SM's four register files as
// 3 + 2 + 2 + 2, so ptxas may give a thread at most 168. At D = 128 the O
// accumulator takes 64 of them, so K/V tiles are 64 keys there (S and the
// split P take half as many) and nothing spills. At D = 256 the O
// accumulator alone is 128 registers a thread, so two consumer warpgroups
// cannot fit under 168: that instantiation runs one consumer warpgroup
// (BQ = 64) and the producer warp, 5 warps whose threads may hold up to
// 255 registers, with no need to move registers between warpgroups
// (setmaxnreg). Its shared memory, Q 32 KB + 2 stages of K/V at BK = 64
// (128 KB) + the O staging rows (33 KB), is 194 KB. One such block fits on
// an SM, so nothing overlaps one block's softmax with another's wgmma.
//
// What the design leaves for later: a persistent scheduler over the query
// tiles, two consumer warpgroups that take turns on the tensor cores
// (ping-pong), and softmax overlapped with the next tile's wgmma.
namespace tc {

constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

// The tile at head dim D and the shared memory, byte offsets from a
// 1024-byte-aligned base. A tile of D columns is D / 64 halves of 64
// columns, each as TMA writes one box.
template <int D>
struct Layout {
  static constexpr int kWG = D == 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int kBQ = 64 * kWG;          // query rows per block
  static constexpr int kThreads = kWG * 128 + 32;
  static constexpr int kBK = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int kHalves = D / 64;
  static constexpr uint32_t kQHalf = kBQ * 128;
  static constexpr uint32_t kTileHalf = kBK * 128;
  static constexpr uint32_t kTile = kTileHalf * kHalves;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQHalf * kHalves;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kO = kV + kStages * kTile;
  static constexpr int kOPitch = D + 8;  // bf16 per staged output row
  static constexpr uint32_t kBar = kO + kWG * 64 * kOPitch * 2;
  // mbarriers: Q, full[kStages], empty[kStages]; slack for the alignment
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct Args {
  void* o;
  int S, H, KV;
  long long ob, oh, os;
  int causal, window;
  float scale_log2;  // D^-0.5 * log2(e)
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  using L = Layout<D>;
  using namespace hopper;
  constexpr int kBK = L::kBK, kBQ = L::kBQ, kWG = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t bar_q = base + L::kBar;
  auto full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto empty = [&](int st) { return bar_q + 8 * (1 + kStages + st); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  // the K/V tiles this block visits: the TPU kernel's block skip
  const int nk = (a.S + kBK - 1) / kBK;
  const int t_end = a.causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
  int t_begin = 0;
  if (a.window > 0 && q0 - a.window - kBK + 1 >= 0)
    t_begin = (q0 - a.window - kBK + 1) / kBK + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWG * 4) {  // the producer
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, kBQ * D * 2);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load_4d(base + L::kQ + c * L::kQHalf, &tq, bar_q, 64 * c, q0, h,
                    b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(st), 2 * L::kTile);
        for (int c = 0; c < L::kHalves; ++c) {
          const uint32_t off = st * L::kTile + c * L::kTileHalf;
          tma_load_4d(base + L::kK + off, &tk, full(st), 64 * c, t * kBK,
                      kvh, b);
          tma_load_4d(base + L::kV + off, &tv, full(st), 64 * c, t * kBK,
                      kvh, b);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows [r_lo, r_lo + 64) of the tile; this
  // thread's accumulator rows are row0 and row0 + 8
  const int wg = warp / 4, w = warp % 4;
  const int r_lo = q0 + 64 * wg;
  const int row0 = r_lo + 16 * w + lane / 4;
  const int qd = 2 * (lane % 4);
  const uint32_t q_base = base + L::kQ + wg * 64 * 128;
  float o[D / 2], s[kBK / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) s[e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int st = i % kStages;
    const uint32_t kb = base + L::kK + st * L::kTile;
    const uint32_t vb = base + L::kV + st * L::kTile;
    mbar_wait(full(st), (i / kStages) & 1);

    // S = Q·Kᵀ
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;
      wgmma_ss<kBK>(s,
                    sw128_desc(q_base + (kk / 4) * L::kQHalf + step, 16,
                               1024),
                    sw128_desc(kb + (kk / 4) * L::kTileHalf + step, 16,
                               1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale into the log2 domain; mask only where the tile needs it
    const int k0 = t * kBK;
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) s[e] *= a.scale_log2;
    if (k0 + kBK > a.S || (a.causal && k0 + kBK - 1 > r_lo) ||
        (a.window > 0 && k0 <= r_lo + 63 - a.window)) {
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + qd + (e & 1);
        const int row = row0 + 8 * ((e >> 1) & 1);
        bool ok = col < a.S;
        if (a.causal) ok = ok && col <= row;
        if (a.window > 0) ok = ok && col > row - a.window;
        if (!ok) s[e] = kNegInf;
      }
    }

    // online softmax: the row max over the 4 lanes that hold a row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P as A fragments, split into P_hi + P_lo; this thread's part of the
    // row sums (the 4 lanes of a row are summed once, at the end)
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * kk + 2 * j;
        const float mr = (j & 1) ? mn1 : mn0;
        const float p0 = ex2(s[e] - mr), p1 = ex2(s[e + 1] - mr);
        if (j & 1)
          sum1 += p0 + p1;
        else
          sum0 += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][j] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }

    // O += P_hi·V + P_lo·V
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = sw128_desc(vb + kk * 2048, L::kTileHalf, 1024);
      wgmma_rs_tb<D>(o, p_hi[kk], dv);
      wgmma_rs_tb<D>(o, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // O / l rounded once to bf16, staged in shared memory, then stored in
  // 16-byte pieces of whole rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  constexpr int P = L::kOPitch;
  __nv_bfloat16* so =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kO) + wg * 64 * P;
  const int lr = 16 * w + lane / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(&so[lr * P + 8 * j + qd]) =
        __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(&so[(lr + 8) * P + 8 * j + qd]) =
        __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  named_sync(1 + wg, 128);
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(a.o) + b * a.ob + h * a.oh;
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  for (int c = threadIdx.x % 128; c < 64 * kChunks; c += 128) {
    const int r = c / kChunks, x = 8 * (c % kChunks);
    if (r_lo + r < a.S)
      *reinterpret_cast<uint4*>(&out[(r_lo + r) * a.os + x]) =
          *reinterpret_cast<const uint4*>(&so[r * P + x]);
  }
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Args& a, int B, cudaStream_t st) {
  using L = Layout<D>;
  const int smem = (int)L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + L::kBQ - 1) / L::kBQ, B * a.H);
  flash_fwd_wgmma<D><<<grid, L::kThreads, smem, st>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a bf16 (B, heads, S, D) tensor as 4-d (d, s, head, batch) with
// the given element strides of batch, head and s, read in boxes of 64
// columns by `rows` rows, 128-byte swizzled; rows past S read as zeros.
// The stride of an axis of size 1 is never used: it is replaced by a dense
// one, since TMA wants every stride a multiple of 16 bytes.
int make_map(CUtensorMap* map, const void* ptr, int B, int heads, int S,
             int D, long long sb, long long sh, long long ss, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (S == 1) ss = D;
  if (heads == 1) sh = (long long)S * D;
  if (B == 1) sb = (long long)heads * S * D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tc

// true when every stride of an axis longer than 1 is a multiple of 16
// bytes (8 bf16 values)
static bool tma_strides_ok(const long long* st, int B, int heads, int S) {
  return (B == 1 || st[0] % 8 == 0) && (heads == 1 || st[1] % 8 == 0) &&
         (S == 1 || st[2] % 8 == 0);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, for q, k,
// v and o in turn, of the batch, head and sequence axes (d is contiguous).
// bf16 wants 16-byte-aligned pointers and strides that are multiples of 16
// bytes (TMA's rule), else it returns cudaErrorMisalignedAddress.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int D,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || S < 1 || H % KV != 0 || window < 0 ||
      (long long)B * H > 65535 || (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)o;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (addr % 4 != 0) return (int)cudaErrorMisalignedAddress;
    f32::Args a{q, k, v, o, S, H, KV,
                strides[0], strides[1], strides[2], strides[3], strides[4],
                strides[5], strides[6], strides[7], strides[8], strides[9],
                strides[10], strides[11], causal, window, scale};
    return D == 64    ? f32::launch<float, 64>(a, B, st)
           : D == 128 ? f32::launch<float, 128>(a, B, st)
                      : f32::launch<float, 256>(a, B, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (addr % 16 != 0 || !tma_strides_ok(strides, B, H, S) ||
      !tma_strides_ok(strides + 3, B, KV, S) ||
      !tma_strides_ok(strides + 6, B, KV, S) ||
      !tma_strides_ok(strides + 9, B, H, S))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  const int bq = D == 64    ? tc::Layout<64>::kBQ
                 : D == 128 ? tc::Layout<128>::kBQ
                            : tc::Layout<256>::kBQ;
  const int bk = D == 64    ? tc::Layout<64>::kBK
                 : D == 128 ? tc::Layout<128>::kBK
                            : tc::Layout<256>::kBK;
  int err = tc::make_map(&tq, q, B, H, S, D, strides[0], strides[1],
                         strides[2], bq);
  if (err == 0)
    err = tc::make_map(&tk, k, B, KV, S, D, strides[3], strides[4],
                       strides[5], bk);
  if (err == 0)
    err = tc::make_map(&tv, v, B, KV, S, D, strides[6], strides[7],
                       strides[8], bk);
  if (err != 0) return err;
  const tc::Args a{o, S, H, KV, strides[9], strides[10], strides[11],
                   causal, window, scale * 1.4426950408889634f};
  return D == 64    ? tc::launch<64>(tq, tk, tv, a, B, st)
         : D == 128 ? tc::launch<128>(tq, tk, tv, a, B, st)
                    : tc::launch<256>(tq, tk, tv, a, B, st);
}

// dynamic shared memory per block of the bf16 kernel at head dim D
extern "C" int flash_attention_bf16_smem_bytes(int D) {
  return D == 64    ? (int)tc::Layout<64>::kBytes
         : D == 128 ? (int)tc::Layout<128>::kBytes
         : D == 256 ? (int)tc::Layout<256>::kBytes
                    : -1;
}
