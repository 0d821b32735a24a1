// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :].
//
// Replaces the TPU kernel gather_rows_pallas / _kernel
// (src/repro/kernels/gather_rows/gather_rows.py:29), which copies one
// (1, BF) stripe per grid step, its source row picked by the
// scalar-prefetched index: HBM -> VMEM -> HBM with no arithmetic.
//
//   table (N, row_bytes) any 2- or 4-byte type (f32, bf16), row-major
//   idx   (M,) int32
//   out   (M, row_bytes)
//
// What bounds it on this card: bytes. It reads M rows of the table and the
// index once and writes M rows, with no arithmetic, so its least time is
// (2 * M * row_bytes + 4 * M) / 3.35 TB/s.
//
// What the design does about it. One warp copies one output row, its 32
// lanes on neighbouring addresses, so every row read is one run of
// coalesced transactions however scattered the indices are. Each lane
// moves the widest unit that divides the row's byte width and the
// alignment of both base pointers: 16-byte vectors (uint4) when the row is
// a multiple of 16 bytes (f32 rows of F % 4 == 0, bf16 rows of
// F % 8 == 0), else 8, 4, 2 or 1 bytes. Warps stride over rows, so a fixed
// grid of a few blocks per SM covers any M.
//
// An index outside [0, N) reads nothing: its output row is written with
// zeros. (The plain version, table[idx], raises for such an index.)
//
// The kernel allocates nothing, launches on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table,
                   const int32_t* __restrict__ idx, T* __restrict__ out,
                   long long N, long long M, long long units) {
  const int lane = threadIdx.x % 32;
  const long long first = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = first; row < M; row += stride) {
    const long long src = idx[row];
    T* dst = out + row * units;
    if (src < 0 || src >= N) {
      for (long long u = lane; u < units; u += 32) dst[u] = T{};
    } else {
      const T* s = table + src * units;
      for (long long u = lane; u < units; u += 32) dst[u] = s[u];
    }
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, long long N,
           long long M, long long row_bytes, cudaStream_t st) {
  long long blocks = (M + kWarps - 1) / kWarps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gather_rows_kernel<T><<<(int)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), N, M, row_bytes / (long long)sizeof(T));
  return (int)cudaGetLastError();
}

}  // namespace

// unit_bytes: the width each lane moves, 16, 8, 4, 2 or 1; it must divide
// row_bytes and the addresses of table and out (the wrapper picks it).
extern "C" int gather_rows_bytes(const void* table, const void* idx, void* out,
                                 long long N, long long M, long long row_bytes,
                                 int unit_bytes, void* stream) {
  if (N < 0 || M < 0 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (unit_bytes != 16 && unit_bytes != 8 && unit_bytes != 4 &&
      unit_bytes != 2 && unit_bytes != 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)table | (uintptr_t)out;
  if (row_bytes % unit_bytes != 0 || addr % unit_bytes != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit_bytes) {
    case 16: return launch<uint4>(table, idx, out, N, M, row_bytes, st);
    case 8: return launch<uint2>(table, idx, out, N, M, row_bytes, st);
    case 4: return launch<uint32_t>(table, idx, out, N, M, row_bytes, st);
    case 2: return launch<uint16_t>(table, idx, out, N, M, row_bytes, st);
    default: return launch<uint8_t>(table, idx, out, N, M, row_bytes, st);
  }
}
