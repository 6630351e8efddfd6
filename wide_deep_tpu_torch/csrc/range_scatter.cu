// K1: sorted-stream scatter-add under a range plan.
//
// Replaces wide_deep_tpu/ops/scatter.py::range_scatter_add (Pallas body
// _kernel), which computes zeros[rows, D].at[ids_sorted].add(g_sorted) with
// one-hot MXU matmuls over a sequential grid of tiles.  Here every tile is
// one block, and the blocks run in parallel:
//
// * Inside a tile the ids are sorted, so each run of equal ids is summed in
//   float32 registers by one thread per (run, column) and written once.
//   Reading g[perm[i]] in the kernel avoids materialising g_sorted.
// * Tiles partition the stream, so only the first and the last run of a
//   tile can share a row with a neighbouring tile: those two use atomicAdd
//   into the zeroed float32 accumulator, every other run a plain store.
// * A bfloat16 output takes one cast pass over the accumulator, so each
//   row is rounded once (the TPU kernel rounds once per tile it touches).
//
// Bound on the card: bytes.  The ids, the permutation and the gradient rows
// are read once and the [rows, D] output written once; the float32
// accumulator adds its zeroing and one re-read for bfloat16 outputs.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// tiles: int32 [4, nt] = starts, offs, counts, row_los.  The live ids of
// tile t are ids[starts[t] + offs[t] + i] for i < counts[t].
template <typename T>
__global__ void range_scatter_kernel(const int* __restrict__ ids,
                                     const int* __restrict__ perm,
                                     const T* __restrict__ g,
                                     const int* __restrict__ tiles, int nt,
                                     int rows, int d,
                                     float* __restrict__ acc) {
  const int t = blockIdx.x;
  const int count = tiles[2 * nt + t];
  if (count <= 0) return;  // trailing empty tiles
  const int base = tiles[t] + tiles[nt + t];
  const int64_t work = (int64_t)count * d;
  for (int64_t w = threadIdx.x; w < work; w += blockDim.x) {
    const int i = (int)(w / d);
    const int c = (int)(w - (int64_t)i * d);
    const int row = ids[base + i];
    if (i > 0 && ids[base + i - 1] == row) continue;  // not a run head
    float sum = wdt::load_f(g, (int64_t)perm[base + i] * d + c);
    int j = i + 1;
    while (j < count && ids[base + j] == row) {
      sum += wdt::load_f(g, (int64_t)perm[base + j] * d + c);
      ++j;
    }
    if (row < 0 || row >= rows) continue;  // outside the plan contract
    float* dst = acc + (int64_t)row * d + c;
    if (i == 0 || j == count) {
      atomicAdd(dst, sum);  // the row may continue in a neighbouring tile
    } else {
      *dst = sum;  // the whole run lies in this tile
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ acc,
                                 __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __float2bfloat16(acc[i]);
  }
}

}  // namespace

// acc: float32 [rows, d], zeroed by the caller.  out: bfloat16 [rows, d]
// when out_bf16, else unused (acc is the output).
extern "C" int wdt_range_scatter_add(const int* ids, const int* perm,
                                     const void* g, int g_bf16,
                                     const int* tiles, int nt, int rows,
                                     int d, float* acc, void* out,
                                     int out_bf16, cudaStream_t stream) {
  if (nt > 0) {
    if (g_bf16) {
      range_scatter_kernel<__nv_bfloat16><<<nt, kThreads, 0, stream>>>(
          ids, perm, static_cast<const __nv_bfloat16*>(g), tiles, nt, rows,
          d, acc);
    } else {
      range_scatter_kernel<float><<<nt, kThreads, 0, stream>>>(
          ids, perm, static_cast<const float*>(g), tiles, nt, rows, d, acc);
    }
  }
  const int64_t n = (int64_t)rows * d;
  if (out_bf16 && n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    cast_bf16_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        acc, static_cast<__nv_bfloat16*>(out), n);
  }
  return (int)cudaGetLastError();
}
