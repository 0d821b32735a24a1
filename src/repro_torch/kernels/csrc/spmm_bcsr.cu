// Block-CSR SpMM for Hopper (sm_90a): out = A @ x over padded tiles.
//
// Replaces the TPU kernel spmm_bcsr_fused_pallas / _fused_kernel
// (src/repro/kernels/spmm/fused.py:96), the impl the JAX package runs for
// the bcsr aggregation backend on a TPU (src/repro/models/gnn/ops.py:120).
// As there, one program owns one output block and loops over K inside
// itself, and the gather of x is an address computation, not a tensor.
//
//   tile_cols (R, K) int32     column-tile index of each of row tile r's K slots
//   tile_vals (R, K, B, B) f32 dense tiles; padded slots are all zero
//   x         (C*B, F) f32     row-major
//   out       (R*B, F) f32     row-major, each element written once
//
// What bounds it on this card: the bytes of tile_vals. The kernel must read
// every value of the padded dense tiles to know which are zero, R*K*B*B*4
// bytes: 150 MB on the arxiv-like train batch 0 (R = 52, K = 44, B = 128),
// 347 MB on test batch 0 (R = 79, K = 67), 0.045 and 0.104 ms at 3.35 TB/s.
// The arithmetic the data needs is 2*nnz*F operations, 1.2 MFLOP at train
// batch 0 and F = 40, 38 MFLOP at test batch 0 and F = 256: under a
// microsecond at the f32 peak. The tiles are 0.1% full, so multiplying
// them densely (this kernel's first version) was bound by operations that
// were almost all products with zero.
//
// What the design does about it: stream tile_vals once, at the rate of
// device memory, and do arithmetic only for nonzero entries (the loop in
// spmm_tile.cuh: a ring of bulk copies into shared memory, a ballot per
// 32-wide window of a row, one shuffle and one x row load per nonzero
// entry). A block owns RB = 8 rows of one row tile (a warp per row) and
// up to 256 features, and walks all K slots in slot order. Grid:
// R*ceil(B/8) blocks by ceil(F/256) feature blocks: 832 blocks on train
// batch 0, 1264 on test batch 0, at either width of the GCN (256 and 40);
// a wider F re-reads the values once per 256 features. Blocks of 16 rows
// (two per warp) took about twice the registers at F = 256, so fewer fit
// on an SM, and ran slower (PERF.md); tools/spmm_variants.py times the
// ring's depth and L2 policy. Each output is written once, by one thread,
// as the sum over its nonzero entries in (k, j) order: bitwise the same
// result on every call, no atomics, no workspace.
//
// Non-finite values: only nonzero entries are multiplied, so a NaN or Inf
// in x spreads to the outputs of the rows whose nonzero entries read it and
// nowhere else, as through the reference's `segment` backend; not through
// the zeros of a dense tile or through padding slots. The dense plain
// versions do spread it through zeros.
//
// B is taken at run time, 1 <= B <= 128; F is any width; f32 throughout
// (CUDA-core FMAs, no TF32: parity with the f32 reference needs full f32).
// Column tiles outside [0, C) are skipped. B % 4 != 0 (or an unaligned
// tile_vals) reads the slabs with plain loads, in the same kernel. The
// kernel allocates nothing, launches on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError() so the caller
// can raise.
//
// Pattern mode (spmm_bcsr_pattern_f32): out = (A != 0) @ x, the neighbour
// sum of GraphSAGE's mean aggregation under the bcsr backend. The
// reference materialises bin_tiles = (tile_vals != 0) as a second f32
// tensor of the tiles' size in every layer and runs the same kernel on it
// (src/repro/models/gnn/ops.py:177-182); here the ballot that already
// finds the nonzero entries drives the same walk, and each entry counts
// as 1 (a NaN value too, since NaN != 0). It reads exactly the bytes the
// weighted kernel reads and skips the shuffle of the value.

#include "spmm_tile.cuh"

namespace {

using spmm::kRB;

template <int T, bool kBulk, bool kPattern>
__global__ void __launch_bounds__(spmm::kThreads)
spmm_bcsr_kernel(const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ out, int K, int B, int C, int F) {
  const int groups = (B + kRB - 1) / kRB;
  const int r = blockIdx.x / groups;
  const int i0 = (blockIdx.x % groups) * kRB;
  spmm::block_rows<T, kBulk, kPattern>(cols, vals, x, out, K, B, C, F, r,
                                       i0, blockIdx.y * spmm::kFB, 0, K);
}

using Kernel = void (*)(const int32_t*, const float*, const float*, float*,
                        int, int, int, int);
// [pattern][bulk][log2 T]
const Kernel kKernels[2][2][4] = {
    {{spmm_bcsr_kernel<1, false, false>, spmm_bcsr_kernel<2, false, false>,
      spmm_bcsr_kernel<4, false, false>, spmm_bcsr_kernel<8, false, false>},
     {spmm_bcsr_kernel<1, true, false>, spmm_bcsr_kernel<2, true, false>,
      spmm_bcsr_kernel<4, true, false>, spmm_bcsr_kernel<8, true, false>}},
    {{spmm_bcsr_kernel<1, false, true>, spmm_bcsr_kernel<2, false, true>,
      spmm_bcsr_kernel<4, false, true>, spmm_bcsr_kernel<8, false, true>},
     {spmm_bcsr_kernel<1, true, true>, spmm_bcsr_kernel<2, true, true>,
      spmm_bcsr_kernel<4, true, true>, spmm_bcsr_kernel<8, true, true>}}};

int launch(bool pattern, const void* tile_cols, const void* tile_vals,
           const void* x, void* out, int R, int K, int B, int C, int F,
           void* stream) {
  if (R <= 0 || F <= 0 || B < 1 || B > spmm::kMaxB || K < 0 || C < 0)
    return (int)cudaErrorInvalidValue;
  const bool bulk = spmm::bulk_ok(tile_vals, B);
  const dim3 grid(R * ((B + kRB - 1) / kRB), (F + spmm::kFB - 1) / spmm::kFB);
  kKernels[pattern][bulk][spmm::log2_features_per_lane(F)]
      <<<grid, spmm::kThreads, bulk ? spmm::smem_bytes(B) : 0,
         (cudaStream_t)stream>>>(
          static_cast<const int32_t*>(tile_cols),
          static_cast<const float*>(tile_vals), static_cast<const float*>(x),
          static_cast<float*>(out), K, B, C, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spmm_bcsr_f32(const void* tile_cols, const void* tile_vals,
                             const void* x, void* out, int R, int K, int B,
                             int C, int F, void* stream) {
  return launch(false, tile_cols, tile_vals, x, out, R, K, B, C, F, stream);
}

extern "C" int spmm_bcsr_pattern_f32(const void* tile_cols,
                                     const void* tile_vals, const void* x,
                                     void* out, int R, int K, int B, int C,
                                     int F, void* stream) {
  return launch(true, tile_cols, tile_vals, x, out, R, K, B, C, F, stream);
}
