// K2: sorted-stream scatter-add over fixed write-only row windows.
//
// Replaces wide_deep_tpu/ops/scatter.py::window_scatter_add (Pallas body
// _window_kernel): window t owns rows [t * 2048, (t + 1) * 2048) and the
// sorted ids that fall there (at most window_cap of them, or the plan says
// ok=0 and the caller takes the plain sum instead).
//
// One block per window.  Windows partition the rows, so each block writes
// its whole window exactly once, zeros where no id falls: no atomics and
// no zeroing pass.  The block stages its window's ids in shared memory; one
// thread per (row, column) finds the row's run by binary search, sums it in
// float32 (reading g[perm[k]], so g_sorted is never built) and stores the
// result, rounded once, in the output dtype.  Neighbouring threads write
// neighbouring elements of the [rows, D] output.
//
// Bound on the card: bytes, dominated by writing the dense [rows, D] output
// (1.5M x 17 bfloat16 for the production d16 group).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// tiles: int32 [3, nt] = starts, offs, counts, one column per window.
template <typename T, typename O>
__global__ void window_scatter_kernel(const int* __restrict__ ids,
                                      const int* __restrict__ perm,
                                      const T* __restrict__ g,
                                      const int* __restrict__ tiles, int nt,
                                      int rows, int d, O* __restrict__ out) {
  __shared__ int s_ids[wdt::kTIds];
  const int t = blockIdx.x;
  const int count = tiles[2 * nt + t];
  const int base = tiles[t] + tiles[nt + t];
  const bool staged = count <= wdt::kTIds;
  if (staged) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      s_ids[i] = ids[base + i];
    }
  }
  __syncthreads();
  const int* wids = staged ? s_ids : ids + base;
  const int row_lo = t * wdt::kMaxr;
  const int row_hi = min(row_lo + wdt::kMaxr, rows);
  if (row_hi <= row_lo) return;
  const int64_t work = (int64_t)(row_hi - row_lo) * d;
  for (int64_t w = threadIdx.x; w < work; w += blockDim.x) {
    const int r = row_lo + (int)(w / d);
    const int c = (int)(w % d);
    int lo = 0;
    int hi = count;
    while (lo < hi) {  // first k with wids[k] >= r
      const int mid = (lo + hi) >> 1;
      if (wids[mid] < r) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    float sum = 0.f;
    for (int k = lo; k < count && wids[k] == r; ++k) {
      sum += wdt::load_f(g, (int64_t)perm[base + k] * d + c);
    }
    wdt::store_f(out, (int64_t)r * d + c, sum);
  }
}

template <typename T>
void launch(const int* ids, const int* perm, const T* g, const int* tiles,
            int nt, int rows, int d, void* out, int out_bf16,
            cudaStream_t stream) {
  if (out_bf16) {
    window_scatter_kernel<T, __nv_bfloat16><<<nt, kThreads, 0, stream>>>(
        ids, perm, g, tiles, nt, rows, d, static_cast<__nv_bfloat16*>(out));
  } else {
    window_scatter_kernel<T, float><<<nt, kThreads, 0, stream>>>(
        ids, perm, g, tiles, nt, rows, d, static_cast<float*>(out));
  }
}

}  // namespace

// out: [rows, d] in float32 or bfloat16 (out_bf16), fully written here.
extern "C" int wdt_window_scatter_add(const int* ids, const int* perm,
                                      const void* g, int g_bf16,
                                      const int* tiles, int nt, int rows,
                                      int d, void* out, int out_bf16,
                                      cudaStream_t stream) {
  if (nt > 0) {
    if (g_bf16) {
      launch(ids, perm, static_cast<const __nv_bfloat16*>(g), tiles, nt,
             rows, d, out, out_bf16, stream);
    } else {
      launch(ids, perm, static_cast<const float*>(g), tiles, nt, rows, d,
             out, out_bf16, stream);
    }
  }
  return (int)cudaGetLastError();
}
