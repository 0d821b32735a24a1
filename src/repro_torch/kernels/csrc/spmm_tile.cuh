// The inner loop that both block-CSR SpMM kernels share (spmm_bcsr.cu and
// spmm_bcsr_unfused.cu): one thread block sums the products of a range of
// K slots for RB = 8 rows of one row tile and up to 256 features, reading
// the value slabs once, at the rate of device memory, and multiplying only
// the entries that are not zero.
//
//   tile_cols (R, K) int32     column-tile index of each of row tile r's K slots
//   tile_vals (R, K, B, B) f32 dense tiles; padded slots are all zero
//   x         (C*B, F) f32     row-major
//
// Values. The slab vals[r, k, i0:i0+RB, :] of one slot is contiguous
// (RB*B*4 bytes, 4 KB at B = 128). With B % 4 == 0 and a 16-byte-aligned
// tile_vals, slabs stream through a ring of kStages = 3 shared-memory
// stages: thread 0 issues one 1-d bulk copy per slot (the TMA unit; SASS
// UBLKCP) under an L2 evict-first policy, so that the stream does not push
// x out of L2, and the stage's mbarrier counts its bytes. Every warp waits
// on the stage's barrier, reads its row, and after a __syncthreads thread 0
// refills the stage with the slot kStages further on. The blocks are small
// (40 registers a thread at 256 features, a 12 KB ring), so six to eight
// share an SM and the main path's 832-1264 blocks end in a short tail.
// Other B (1, 7, ...) or an unaligned tile_vals read the slab straight
// from global memory with plain loads: the same loop, without the ring.
//
// Arithmetic. Warp w owns row w of the group. For one slot, lane l reads
// values j = 32q + l of the row (q < 4), and __ballot_sync gives the
// nonzero columns of each 32-wide window. The warp walks the set bits in
// ascending column order: it takes each value with __shfl_sync, and every
// lane loads its T features of x row cols[r, k]*B + j (features 32t + l,
// straight from global memory: x stays in L2) before their T FMAs.
// Accumulators stay in registers for the whole K range (T floats a
// thread), and each output is written once, by one thread, as the fmaf
// chain over the nonzero entries in (k, j) order: the result is bitwise
// the same from run to run, with no atomics. A row or slot with no
// nonzero costs one ballot per window.
//
// Non-finite values. No zero entry is multiplied: a NaN or Inf in x
// reaches only the outputs of rows whose nonzero entries read it, as the
// reference's `segment` backend (an edge list) spreads it, and a padding
// slot (all zero, column tile 0) spreads nothing. A NaN value in tile_vals
// is not zero, so it is multiplied. The dense plain versions
// (spmm_bcsr_ref, spmm_bcsr_stream) also spread NaN through zero entries.
//
// Slots whose column tile lies outside [0, C) are skipped (their slab is
// still read: the ring is indifferent to what a slot holds).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace spmm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = kWarps;                   // rows of a row tile per block
constexpr int kFB = 256;                      // features per block
constexpr int kMaxB = 128;
constexpr int kWindows = kMaxB / 32;          // 32-wide column windows
constexpr int kStages = 3;
constexpr int kRingOffset = 128;              // the barriers come first
constexpr uint32_t kFull = 0xffffffffu;

// dynamic shared memory of a block: the barriers, then the ring
__host__ __device__ constexpr int smem_bytes(int B) {
  return kRingOffset + kStages * kRB * B * 4;
}
static_assert(smem_bytes(kMaxB) <= 48 * 1024,
              "the ring fits the default dynamic shared memory limit");
static_assert(kStages * 8 <= kRingOffset, "the barriers fit before the ring");

// log2 of the x features per lane T for F features: the least T in
// {1, 2, 4, 8} with 32*T >= min(F, kFB); kernels are instantiated per T
inline int log2_features_per_lane(int F) {
  const int nf = F < kFB ? F : kFB;
  return nf <= 32 ? 0 : nf <= 64 ? 1 : nf <= 128 ? 2 : 3;
}

// The next set bit of a row's four window ballots, in ascending column
// order: its column j and its value (lane `bit` of v[q]). m is uniform
// across the warp, so every lane takes the same branches.
__device__ __forceinline__ bool next_entry(uint32_t (&m)[kWindows],
                                           const float (&v)[kWindows],
                                           int& j, float& a) {
  if (!(m[0] | m[1] | m[2] | m[3])) return false;
  int q = 3;
  uint32_t mq = m[3];
  float vq = v[3];
  if (m[2]) { q = 2; mq = m[2]; vq = v[2]; }
  if (m[1]) { q = 1; mq = m[1]; vq = v[1]; }
  if (m[0]) { q = 0; mq = m[0]; vq = v[0]; }
  const int bit = __ffs(mq) - 1;
  j = 32 * q + bit;
  a = __shfl_sync(kFull, vq, bit);
  const uint32_t rest = mq & (mq - 1);
#pragma unroll
  for (int w = 0; w < kWindows; ++w)
    if (w == q) m[w] = rest;
  return true;
}

// Add one slot's products to the warp's accumulators. `slab` holds `rows`
// rows of B values (shared or global memory); `xt` is x's row block of the
// slot's column tile at the block's first feature; nf features are live.
template <int T>
__device__ __forceinline__ void accumulate_slot(
    const float* slab, int B, int rows, const float* __restrict__ xt,
    int F, int nf, int warp, int lane, float (&acc)[T]) {
  float v[kWindows];
  uint32_t m[kWindows];
#pragma unroll
  for (int q = 0; q < kWindows; ++q) {
    const int j = 32 * q + lane;
    v[q] = (warp < rows && j < B) ? slab[warp * B + j] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kWindows; ++q)
    m[q] = __ballot_sync(kFull, v[q] != 0.f);
  int j;
  float a;
  while (next_entry(m, v, j, a)) {
    const float* xr = xt + (size_t)j * F;
    float xv[T];
#pragma unroll
    for (int t = 0; t < T; ++t)
      xv[t] = 32 * t + lane < nf ? __ldg(xr + 32 * t + lane) : 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = fmaf(a, xv[t], acc[t]);
  }
}

// One block's work: rows i0 .. i0+kRB-1 of row tile r (fewer at the end of
// the tile), features f0 .. f0+kFB-1 (fewer at the end of x), slots
// [k_lo, k_hi); the sums go to dst (R*B, F), row-major. Every thread of
// the block calls this with the same arguments.
template <int T, bool kBulk>
__device__ __forceinline__ void block_rows(
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ dst, int K, int B,
    int C, int F, int r, int i0, int f0, int k_lo, int k_hi) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = min(kRB, B - i0);
  const int nf = min(kFB, F - f0);
  const int nk = k_hi - k_lo;
  const size_t tile = (size_t)B * B;
  // slot k's slab is at slab0 + k * tile
  const float* slab0 = vals + (size_t)r * K * tile + (size_t)i0 * B;
  const int32_t* rcols = cols + (size_t)r * K;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kRingOffset);
  const uint32_t slab_bytes = (uint32_t)rows * B * 4;
  uint64_t policy = 0;
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s)
        hopper::mbar_init(hopper::smem_addr(&bars[s]), 1);
      hopper::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      policy = hopper::l2_evict_first();
      for (int s = 0; s < kStages && s < nk; ++s) {
        const uint32_t bar = hopper::smem_addr(&bars[s]);
        hopper::mbar_arrive_expect_tx(bar, slab_bytes);
        hopper::bulk_load(hopper::smem_addr(ring + s * kRB * B),
                          slab0 + (size_t)(k_lo + s) * tile, slab_bytes,
                          bar, policy);
      }
    }
  }

  float acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.f;

  for (int n = 0; n < nk; ++n) {
    const int k = k_lo + n;
    const int c = __ldg(rcols + k);
    const int s = n % kStages;
    const float* slab;
    if constexpr (kBulk) {
      hopper::mbar_wait(hopper::smem_addr(&bars[s]), (n / kStages) & 1);
      slab = ring + s * kRB * B;
    } else {
      slab = slab0 + (size_t)k * tile;
    }
    // uniform across the block: no thread skips a barrier alone
    if (c >= 0 && c < C)
      accumulate_slot<T>(slab, B, rows, x + (size_t)c * B * F + f0, F, nf,
                         warp, lane, acc);
    if constexpr (kBulk) {
      __syncthreads();                  // every warp is done with stage s
      if (threadIdx.x == 0 && n + kStages < nk) {
        const uint32_t bar = hopper::smem_addr(&bars[s]);
        hopper::mbar_arrive_expect_tx(bar, slab_bytes);
        hopper::bulk_load(hopper::smem_addr(ring + s * kRB * B),
                          slab0 + (size_t)(k + kStages) * tile, slab_bytes,
                          bar, policy);
      }
    }
  }

  if (warp < rows) {
    float* out = dst + ((size_t)r * B + i0 + warp) * F + f0;
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (32 * t + lane < nf) out[32 * t + lane] = acc[t];
  }
}

// Whether a call can stream its slabs by bulk copies: every slab address
// and size a multiple of 16 bytes.
inline bool bulk_ok(const void* vals, int B) {
  return B % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
}

}  // namespace spmm
