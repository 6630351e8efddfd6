// K2: sorted-stream scatter-add over fixed write-only row windows.
//
// Replaces wide_deep_tpu/ops/scatter.py::window_scatter_add (Pallas body
// _window_kernel): window t owns rows [t * 2048, (t + 1) * 2048) and the
// sorted ids that fall there (at most kTIds of them under the plan's
// contract, or the plan says ok=0 and the caller takes the plain sum).
//
// Bound on the card: bytes, nearly all of them the dense [rows, D] output
// write.  At the production d16 group that is 1,500,160 x 17 bfloat16 =
// 51 MB, most of it zeros, against 4.3 MB of ids, perm and gradient rows.
// So the design spends its instructions on the ids, not on the output
// elements, and writes the output as one contiguous 16-byte stream:
//   * a block owns a sub-window: the S rows [b * S, (b + 1) * S) of one
//     window, S the largest power of two <= 2048 whose slab of S x D output
//     elements fits kSlabBytes (512 rows, 17 KB at d16 bfloat16;
//     wdt_window_sub_rows reports it, and ops/scatter.window_sub_rows
//     makes the same choice on the host).  The slab lives in
//     shared memory and several blocks share an SM;
//   * the block zeroes its slab with 16-byte stores and stages its window's
//     ids and perm (<= kTIds each) with coalesced loads.  How many staged
//     ids lie below each edge of the sub-window (one block reduction) gives
//     its range of the sorted stream, once per block;
//   * work items are (id position, column) over that range.  Only the head
//     of a run works: it sums g[perm[j]] over its run in float32, in stream
//     order, rounds once and writes its slab element.  Each row is one run,
//     so there are no atomics and every call gives the same bits;
//   * the slab's rows are contiguous in [rows, D], so it leaves as one
//     range: 16-byte stores, neighbouring threads on neighbouring addresses,
//     and a 2-byte tail where the last, partial sub-window's length is not a
//     multiple of 16.
// No 64-bit division: 32-bit offsets inside a sub-window and one 64-bit
// base per block.  A window count above kTIds breaks the plan's contract;
// the kernel traps rather than read past its staging buffers.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = wdt::kTIds / kThreads;  // staged ids per thread
constexpr int kMaxrShift = 11;               // wdt::kMaxr == 1 << 11
constexpr int kSlabBytes = 32 * 1024;        // slab of one sub-window
// The fewest rows a sub-window has: 16 rows of 2- or 4-byte elements keep
// every slab's output offset (row_lo * D * sizeof(O)) a multiple of 16.
constexpr int kMinSubShift = 4;

static_assert(wdt::kMaxr == 1 << kMaxrShift, "window rows");
static_assert(wdt::kTIds % kThreads == 0, "staging");
static_assert(wdt::kTIds < (1 << 16), "two counts packed in 32 bits");

// tiles: int32 [3, nt] = starts, offs, counts, one column per window.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    window_scatter_kernel(const int* __restrict__ ids,
                          const int* __restrict__ perm,
                          const T* __restrict__ g,
                          const int* __restrict__ tiles, int nt, int rows,
                          int d, int sub_shift, O* __restrict__ out) {
  __shared__ int s_ids[wdt::kTIds];
  __shared__ int s_perm[wdt::kTIds];
  __shared__ unsigned s_warp[kThreads / 32];
  extern __shared__ __align__(16) unsigned char slab_raw[];
  O* slab = reinterpret_cast<O*>(slab_raw);
  uint4* slab4 = reinterpret_cast<uint4*>(slab_raw);

  const int tid = threadIdx.x;
  const int t = blockIdx.x >> (kMaxrShift - sub_shift);
  const int row_lo = blockIdx.x << sub_shift;
  const int n_rows = min(1 << sub_shift, rows - row_lo);
  const int count = tiles[2 * nt + t];
  const int base = tiles[t] + tiles[nt + t];
  if (count < 0 || count > wdt::kTIds) __trap();

  const int slab_vecs = (d << sub_shift) * (int)sizeof(O) / 16;
  for (int i = tid; i < slab_vecs; i += kThreads) {
    slab4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // below = (ids < row_lo) + (ids < row_lo + n_rows) << 16, this thread's
  unsigned below = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = r * kThreads + tid;
    if (i < count) {
      const int id = ids[base + i];
      s_ids[i] = id;
      s_perm[i] = perm[base + i];
      below += (unsigned)(id < row_lo) +
               ((unsigned)(id < row_lo + n_rows) << 16);
    }
  }
  below = __reduce_add_sync(0xffffffffu, below);
  if ((tid & 31) == 0) s_warp[tid >> 5] = below;
  __syncthreads();
  below = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) below += s_warp[w];
  const int lo = (int)(below & 0xffffu);  // the sub-window's ids: [lo, hi)
  const int hi = (int)(below >> 16);

  // item w = (k, c): k = lo + w / d, c = w % d, stepped without dividing
  int k = lo + tid / d;
  int c = tid % d;
  const int k_step = kThreads / d;
  const int c_step = kThreads % d;
  const int items = (hi - lo) * d;
  for (int w = tid; w < items; w += kThreads) {
    const int r = s_ids[k];
    if (k == lo || s_ids[k - 1] != r) {
      int e = k + 1;
      while (e < hi && s_ids[e] == r) ++e;
      float sum = 0.f;
#pragma unroll 4
      for (int j = k; j < e; ++j) {
        sum += wdt::load_f(g, (int64_t)s_perm[j] * d + c);
      }
      const int row = r - row_lo;  // in [0, n_rows) for a sorted stream
      if ((unsigned)row < (unsigned)n_rows) wdt::store_f(slab, row * d + c, sum);
    }
    k += k_step;
    c += c_step;
    if (c >= d) {
      c -= d;
      ++k;
    }
  }
  __syncthreads();

  const int n_bytes = n_rows * d * (int)sizeof(O);
  unsigned char* dst = reinterpret_cast<unsigned char*>(out) +
                       (int64_t)row_lo * d * (int64_t)sizeof(O);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  const int n_vecs = n_bytes >> 4;
  for (int i = tid; i < n_vecs; i += kThreads) dst4[i] = slab4[i];
  // the tail, in 2-byte units (sizeof(O) is 2 or 4)
  if (tid < (n_bytes & 15) >> 1) {
    reinterpret_cast<uint16_t*>(dst + (n_vecs << 4))[tid] =
        reinterpret_cast<const uint16_t*>(slab_raw + (n_vecs << 4))[tid];
  }
}

// log2 of the sub-window's rows for rows of row_bytes, or -1 when even
// 1 << kMinSubShift rows overflow the slab.
int sub_shift(int64_t row_bytes) {
  int shift = kMaxrShift;
  while (shift > kMinSubShift && (row_bytes << shift) > kSlabBytes) --shift;
  return (row_bytes << shift) > kSlabBytes ? -1 : shift;
}

template <typename T, typename O>
int launch(const int* ids, const int* perm, const T* g, const int* tiles,
           int nt, int rows, int d, O* out, cudaStream_t stream) {
  const int64_t row_bytes = (int64_t)d * (int64_t)sizeof(O);
  const int shift = sub_shift(row_bytes);
  if (shift < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + (1 << shift) - 1) >> shift;
  window_scatter_kernel<T, O>
      <<<blocks, kThreads, (int)(row_bytes << shift), stream>>>(
          ids, perm, g, tiles, nt, rows, d, shift, out);
  return (int)cudaSuccess;
}

template <typename T>
int launch_out(const int* ids, const int* perm, const T* g, const int* tiles,
               int nt, int rows, int d, void* out, int out_bf16,
               cudaStream_t stream) {
  if (out_bf16) {
    return launch(ids, perm, g, tiles, nt, rows, d,
                  static_cast<__nv_bfloat16*>(out), stream);
  }
  return launch(ids, perm, g, tiles, nt, rows, d, static_cast<float*>(out),
                stream);
}

}  // namespace

// out: [rows, d] in float32 or bfloat16 (out_bf16), 16-byte aligned, fully
// written here.  Refuses (cudaErrorInvalidValue) rows wider than a slab of
// 16 rows takes, too few windows for rows, or a misaligned out.
extern "C" int wdt_window_scatter_add(const int* ids, const int* perm,
                                      const void* g, int g_bf16,
                                      const int* tiles, int nt, int rows,
                                      int d, void* out, int out_bf16,
                                      cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return (int)cudaGetLastError();
  if ((int64_t)nt * wdt::kMaxr < rows ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int err =
      g_bf16 ? launch_out(ids, perm, static_cast<const __nv_bfloat16*>(g),
                          tiles, nt, rows, d, out, out_bf16, stream)
             : launch_out(ids, perm, static_cast<const float*>(g), tiles, nt,
                          rows, d, out, out_bf16, stream);
  return err ? err : (int)cudaGetLastError();
}

// The rows of one block's sub-window that wdt_window_scatter_add launches
// for rows of d elements of elem_bytes each, or 0 when it refuses them.
extern "C" int wdt_window_sub_rows(int d, int elem_bytes) {
  if (d <= 0 || elem_bytes <= 0) return 0;
  const int shift = sub_shift((int64_t)d * elem_bytes);
  return shift < 0 ? 0 : 1 << shift;
}
