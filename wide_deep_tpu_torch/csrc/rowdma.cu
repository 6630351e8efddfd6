// K3: in-place row write-back of the fused sparse optimizer.
//
// Replaces wide_deep_tpu/ops/rowdma.py::rowdma_scatter_rows (Pallas body
// _kernel), which issues one DMA per touched row with a ring of semaphores:
// table.at[uids].set(new_rows, mode="drop") for sorted-unique uids whose
// out-of-range sentinel padding is skipped.
//
// One thread per float4 of the rows to write, in row order: a row of
// `width` float32 is width / 4 consecutive threads, so a 128-wide row (the
// fused tables of every rule but RowwiseAdagrad) is one warp whose 32
// lanes move one float4 each, one 512-byte row read and written
// coalesced, and a RowwiseAdagrad d128 row of 132 floats is 33 threads
// that straddle warps: the reads stay one contiguous stream, each write a
// whole row.  Uids outside [0, R) are skipped.  Bound on the card: bytes,
// one read and one write of each touched row plus the uids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void rowdma_kernel(float4* __restrict__ table, int64_t n_rows,
                              const int* __restrict__ uids,
                              const float4* __restrict__ rows, int n,
                              int vec) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t k = gid / vec;
  const int v = (int)(gid - k * vec);
  if (k >= n) return;
  const int u = uids[k];
  if (u < 0 || (int64_t)u >= n_rows) return;  // sentinel padding
  table[(int64_t)u * vec + v] = rows[k * vec + v];
}

}  // namespace

// table: float32 [n_rows, width]; rows: float32 [n, width]; uids: int32
// [n]; width a multiple of 4, both 16-byte aligned.
extern "C" int wdt_rowdma_scatter_rows(float* table, long long n_rows,
                                       const int* uids, const float* rows,
                                       int n, int width,
                                       cudaStream_t stream) {
  if (width <= 0 || width % 4) return (int)cudaErrorInvalidValue;
  const int vec = width / 4;
  if (n > 0) {
    const int64_t blocks = ((int64_t)n * vec + kThreads - 1) / kThreads;
    rowdma_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(table), (int64_t)n_rows, uids,
        reinterpret_cast<const float4*>(rows), n, vec);
  }
  return (int)cudaGetLastError();
}
