// Block-CSR SpMM for Hopper (sm_90a), with K split across the grid:
// out = A @ x over padded tiles.
//
// Replaces the TPU kernel spmm_bcsr_pallas / _kernel
// (src/repro/kernels/spmm/spmm.py:37), the reference's unfused impl
// (spmm_bcsr(impl="pallas"), src/repro/kernels/spmm/ops.py:132-137). Its grid
// is (R, F/BF, K): K is the innermost, sequential grid axis, and the output
// block stays resident in VMEM across it while each step adds one
// vals[r, k] @ x[cols[r, k]*B : +B, f-block] product.
//
//   tile_cols (R, K) int32     column-tile index of each of row tile r's K slots
//   tile_vals (R, K, B, B) f32 dense tiles; padded slots are all zero
//   x         (C*B, F) f32     row-major
//   ws        (S, R*B, F) f32  partial sums, one slice per K split (S > 1)
//   out       (R*B, F) f32     row-major
//
// What bounds it on this card. Every tile slot is multiplied: 2*R*K*B*B*F
// f32 operations, against R*K*B*B*4 bytes of tile_vals read once: F/2
// operations per byte of tiles, 128 at F = 256 against the card's balance
// point of 67 TFLOP/s over 3.35 TB/s = 20, so the padded work is bound by
// operations. Counted over the nonzero tiles only (the bound chip_smoke.py
// reports), F = 256 stays bound by operations and F = 40 is bound by bytes.
//
// What the design does about it. On Hopper the grid's blocks run in
// parallel and in no order, so nothing can stay resident across a grid
// axis. K therefore stays a grid axis (blockIdx.z), but each block owns a
// contiguous range of K/S slots: it sums its range into registers and
// writes one (B, 64) partial to its own slice of the workspace. A second,
// small kernel in this file sums the S partials of every output in split
// order 0..S-1, so the result is deterministic from run to run (no
// atomics). The wrapper picks S so that R * ceil(F/64) * S blocks cover at
// least two waves of the card's resident blocks (a single row-tile sweep,
// as the fused kernel runs, leaves F = 40 at 79 blocks on 132 SMs); with
// S = 1 the partial kernel writes the output directly and no reduction
// runs. Inside a block the work is a CUDA-core f32 FMA loop, no TF32: the
// (B, B) value tile and the x stripe pass through shared memory in 32-wide
// chunks of the inner dimension (24 KB), and each thread keeps up to 32
// outputs of one feature column in registers. Zero-tile skipping, tensor
// cores and TMA are left for later work.
//
// B is taken at run time, 1 <= B <= 128; F is any width. The kernels
// allocate nothing, launch on the caller's stream and do not synchronise;
// the C entry point returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBF = 64;                          // output features per block
constexpr int kRowGroups = kThreads / kBF;       // 4 threads share a column
constexpr int kMaxB = 128;
constexpr int kRowsPerThread = kMaxB / kRowGroups;  // 32 accumulators
constexpr int kJC = 32;                          // inner-dimension chunk
constexpr int kReduceThreads = 256;

// One block: row tile blockIdx.x, feature block blockIdx.y, K split
// blockIdx.z covering slots [z * k_per_split, min(K, (z + 1) * k_per_split)).
__global__ void __launch_bounds__(kThreads)
spmm_bcsr_partial_kernel(const int32_t* __restrict__ cols,
                         const float* __restrict__ vals,
                         const float* __restrict__ x,
                         float* __restrict__ part,
                         int K, int B, int C, int F, int k_per_split,
                         long long split_stride) {
  __shared__ __align__(16) float vs[kMaxB][kJC];   // vals[:, j0:j0+kJC]
  __shared__ float xs[kJC][kBF];                   // x rows j0..j0+kJC

  const int r = blockIdx.x;
  const int f0 = blockIdx.y * kBF;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % kBF;        // feature column within the block
  const int ty = tid / kBF;        // this thread's rows: ty, ty+4, ty+8, ...

  float acc[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.f;

  for (int k = k_lo; k < k_hi; ++k) {
    const int c = cols[(size_t)r * K + k];
    // a column tile outside x cannot come from csr_to_bcsr; the test is
    // uniform across the block, so no thread skips a barrier alone
    if (c < 0 || c >= C) continue;
    const float* tile = vals + ((size_t)r * K + k) * B * B;
    const float* stripe = x + (size_t)c * B * F;
    for (int j0 = 0; j0 < B; j0 += kJC) {
      for (int e = tid; e < B * kJC; e += kThreads) {
        const int i = e / kJC, jj = e % kJC;
        vs[i][jj] = (j0 + jj < B) ? tile[(size_t)i * B + j0 + jj] : 0.f;
      }
      for (int e = tid; e < kJC * kBF; e += kThreads) {
        const int jj = e / kBF, t = e % kBF;
        xs[jj][t] = (j0 + jj < B && f0 + t < F)
                        ? stripe[(size_t)(j0 + jj) * F + f0 + t] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kJC; jj += 4) {
        const float x0 = xs[jj][tx], x1 = xs[jj + 1][tx];
        const float x2 = xs[jj + 2][tx], x3 = xs[jj + 3][tx];
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int i = m * kRowGroups + ty;
          if (i < B) {
            const float4 v = *reinterpret_cast<const float4*>(&vs[i][jj]);
            acc[m] = fmaf(v.x, x0, acc[m]);
            acc[m] = fmaf(v.y, x1, acc[m]);
            acc[m] = fmaf(v.z, x2, acc[m]);
            acc[m] = fmaf(v.w, x3, acc[m]);
          }
        }
      }
      __syncthreads();
    }
  }

  if (f0 + tx < F) {
    float* dst = part + (size_t)blockIdx.z * (size_t)split_stride;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int i = m * kRowGroups + ty;
      if (i < B) dst[((size_t)r * B + i) * F + f0 + tx] = acc[m];
    }
  }
}

// out[e] = sum over s = 0..S-1, in that order, of part[s][e].
__global__ void __launch_bounds__(kReduceThreads)
spmm_bcsr_reduce_kernel(const float* __restrict__ part,
                        float* __restrict__ out, int S, long long n) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = part[e];
    for (int s = 1; s < S; ++s) sum += part[(size_t)s * n + e];
    out[e] = sum;
  }
}

}  // namespace

// ws may be null when S == 1 (the partial kernel then writes out).
extern "C" int spmm_bcsr_unfused_f32(const void* tile_cols,
                                     const void* tile_vals, const void* x,
                                     void* ws, void* out, int R, int K, int B,
                                     int C, int F, int S, int k_per_split,
                                     void* stream) {
  if (R <= 0 || F <= 0 || B < 1 || B > kMaxB || K < 0 || C < 0 || S < 1 ||
      S > 65535 || k_per_split < 0 || (long long)S * k_per_split < K ||
      (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)R * B * F;
  const dim3 grid(R, (F + kBF - 1) / kBF, S);
  spmm_bcsr_partial_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(tile_cols),
      static_cast<const float*>(tile_vals), static_cast<const float*>(x),
      static_cast<float*>(S == 1 ? out : ws), K, B, C, F, k_per_split, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  long long blocks = (n + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 4096) blocks = 4096;
  spmm_bcsr_reduce_kernel<<<(int)blocks, kReduceThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), S, n);
  return (int)cudaGetLastError();
}
