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
// What bounds it on this card: the bytes of tile_vals, as for the fused
// kernel (spmm_bcsr.cu): every padded value must be read to know which are
// zero (150 MB on the arxiv-like train batch 0, 347 MB on test batch 0),
// while the arithmetic the data needs, 2*nnz*F operations, takes under a
// microsecond. With S > 1 the partials add 2*(S-1)*R*B*F*4 bytes.
//
// What the design does about it. On Hopper the grid's blocks run in
// parallel and in no order, so nothing can stay resident across a grid
// axis. K therefore stays a grid axis (blockIdx.z), but each block owns a
// contiguous range of K/S slots and sums it with the fused kernel's loop
// (spmm_tile.cuh: RB = 8 rows and up to 256 features per block, the value
// slabs streamed once through a ring of bulk copies, arithmetic only for
// the nonzero entries), then writes its partial to its own slice of the
// workspace. A second, small kernel in this file sums the S partials of
// every output in split order 0..S-1, so the result is deterministic from
// run to run (no atomics). The wrapper picks S by weighing the partials'
// extra bytes against the share of the SMs that R*ceil(B/8)*ceil(F/256)
// blocks leave idle (kernels/spmm/ops.py:k_splits): S = 1 (no workspace,
// the partial kernel writes the output) wherever the blocks cover the SMs,
// as on the main path's 832-1264 blocks; S > 1 only for few row tiles.
//
// Non-finite values: only nonzero entries are multiplied, so a NaN or Inf
// in x spreads to the outputs of the rows whose nonzero entries read it and
// nowhere else, as through the reference's `segment` backend; not through
// the zeros of a dense tile or through padding slots. The dense plain
// versions do spread it through zeros.
//
// B is taken at run time, 1 <= B <= 128; F is any width; f32 throughout,
// no TF32. Column tiles outside [0, C) are skipped. The kernels allocate
// nothing, launch on the caller's stream and do not synchronise; the C
// entry point returns cudaGetLastError() so the caller can raise.

#include "spmm_tile.cuh"

namespace {

using spmm::kRB;
constexpr int kReduceThreads = 256;

// One block: rows blockIdx.x of the (row tile, 16-row group) pairs,
// feature block blockIdx.y, K split blockIdx.z covering slots
// [z * k_per_split, min(K, (z + 1) * k_per_split)).
template <int T, bool kBulk>
__global__ void __launch_bounds__(spmm::kThreads)
spmm_bcsr_partial_kernel(const int32_t* __restrict__ cols,
                         const float* __restrict__ vals,
                         const float* __restrict__ x,
                         float* __restrict__ part, int K, int B, int C, int F,
                         int k_per_split, long long split_stride) {
  const int groups = (B + kRB - 1) / kRB;
  const int r = blockIdx.x / groups;
  const int i0 = (blockIdx.x % groups) * kRB;
  const int k_lo = blockIdx.z * k_per_split;
  spmm::block_rows<T, kBulk>(
      cols, vals, x, part + (size_t)blockIdx.z * (size_t)split_stride, K, B,
      C, F, r, i0, blockIdx.y * spmm::kFB, k_lo, min(K, k_lo + k_per_split));
}

using Kernel = void (*)(const int32_t*, const float*, const float*, float*,
                        int, int, int, int, int, long long);
// [bulk][log2 T]
const Kernel kKernels[2][4] = {
    {spmm_bcsr_partial_kernel<1, false>, spmm_bcsr_partial_kernel<2, false>,
     spmm_bcsr_partial_kernel<4, false>, spmm_bcsr_partial_kernel<8, false>},
    {spmm_bcsr_partial_kernel<1, true>, spmm_bcsr_partial_kernel<2, true>,
     spmm_bcsr_partial_kernel<4, true>, spmm_bcsr_partial_kernel<8, true>}};

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
  if (R <= 0 || F <= 0 || B < 1 || B > spmm::kMaxB || K < 0 || C < 0 ||
      S < 1 || S > 65535 || k_per_split < 0 ||
      (long long)S * k_per_split < K || (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)R * B * F;
  const bool bulk = spmm::bulk_ok(tile_vals, B);
  const dim3 grid(R * ((B + kRB - 1) / kRB), (F + spmm::kFB - 1) / spmm::kFB,
                  S);
  kKernels[bulk][spmm::log2_features_per_lane(F)]
      <<<grid, spmm::kThreads, bulk ? spmm::smem_bytes(B) : 0, st>>>(
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
