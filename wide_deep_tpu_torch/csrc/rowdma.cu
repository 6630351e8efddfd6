// K3: in-place row write-back of the fused sparse optimizer.
//
// Replaces wide_deep_tpu/ops/rowdma.py::rowdma_scatter_rows (Pallas body
// _kernel), which issues one DMA per touched row with a ring of semaphores:
// table.at[uids].set(new_rows, mode="drop") for sorted-unique uids whose
// out-of-range sentinel padding is skipped.
//
// One warp per uid; each of its 32 lanes moves one float4, so a warp moves
// one 512-byte row (128 float32) with one coalesced read and one coalesced
// write.  Uids outside [0, R) are skipped.  Bound on the card: bytes, one
// read and one write of each touched row plus the uids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerRow = 32;  // 128 float32 = 32 float4

__global__ void rowdma_kernel(float4* __restrict__ table, int64_t n_rows,
                              const int* __restrict__ uids,
                              const float4* __restrict__ rows, int n) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t k = gid >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= n) return;
  const int u = uids[k];
  if (u < 0 || (int64_t)u >= n_rows) return;  // sentinel padding
  table[(int64_t)u * kVecPerRow + lane] = rows[k * kVecPerRow + lane];
}

}  // namespace

// table: float32 [n_rows, 128]; rows: float32 [n, 128]; uids: int32 [n].
extern "C" int wdt_rowdma_scatter_rows(float* table, long long n_rows,
                                       const int* uids, const float* rows,
                                       int n, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = ((int64_t)n * 32 + kThreads - 1) / kThreads;
    rowdma_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(table), (int64_t)n_rows, uids,
        reinterpret_cast<const float4*>(rows), n);
  }
  return (int)cudaGetLastError();
}
