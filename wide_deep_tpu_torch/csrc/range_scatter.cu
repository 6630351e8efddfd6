// K1: sorted-stream scatter-add, as a chunked segmented sum.
//
// Replaces wide_deep_tpu/ops/scatter.py::range_scatter_add (Pallas body
// _kernel), which computes zeros[rows, D].at[ids_sorted].add(g_sorted) with
// one-hot MXU matmuls over a sequential grid of range tiles.  Here the sum
// is out[ids[i]] += g[perm[i]] over the sorted stream, in float32, each
// output row rounded once to the output type; ids outside [0, rows) (the
// plan's sentinels, sorted to the tail) drop.  The plan's tiles are not
// read: the stream's order is all the kernel needs.
//
// Bound on the card: bytes (the ids, the permutation and the gradient rows
// read once, the [rows, D] output written once).  In practice the gather of
// gradient rows in stream order bounds it: they lie at random, and a row of
// 9 bfloat16 (d8) touches one or two 32-byte sectors for 18 bytes.  The
// design:
//   * balanced chunks: warp w of block b owns the kChunk = 32 stream
//     positions of chunk c = b * kWarps + w, one per lane, whatever the runs
//     of equal ids look like (a plan tile's count no longer sets anyone's
//     work), and each warp works alone: no block barrier.  Block row y
//     (gridDim.y of them) takes the columns [c0, c0 + nc) of its chunks,
//     one 32-byte sector of a gradient row each (d32 float32: 4 column
//     groups, so 25,600 positions are 3,200 warps; d8 and d4 bfloat16: 1);
//   * a lane loads its position's id and perm, and the neighbours' ids come
//     by shuffles; the gradient rows of live positions (the sentinels' rows
//     are never read) are staged in the warp's shared-memory slab as
//     float32, item k = (position, column) by lane k % 32, so neighbouring
//     lanes read neighbouring columns of one row;
//   * the runs are summed column by column by a segmented inclusive scan of
//     warp shuffles: no lane walks a run, however long it is, and the order
//     of the adds depends only on the positions, so every call gives the
//     same bits;
//   * each run's sums go back to the slab at its tail and leave the same way
//     they came, item by item over the run tails in order: a run that starts
//     and ends in the chunk is rounded once and stored straight into the
//     output, in its type (no float32 accumulator over the table and no cast
//     pass);
//   * a run cut by a chunk edge leaves its float32 partial in a scratch slot
//     of its chunk, keyed by its id (slot 0: the chunk's first run, begun
//     in an earlier chunk; slot 1: its last run, going on into the next; a
//     chunk that one run passes through keeps its partial in slot 0 and a
//     zero in slot 1, so the run's slots stay one run); slots of runs that
//     no edge cuts are keyed -1.  Those 2 slots a chunk, in chunk order, are
//     a stream of width d whose equal live keys are adjacent again:
//     range_carry_kernel sums it the same way, one warp per 32 slots, and
//     leaves the runs it cuts to the next level, each level 16 times
//     shorter, until one chunk holds the rest.  So a run over C chunks (a
//     hot row; a pool's padding on row 0) is finished within
//     1 + log16(C) levels, no warp adds more than 32 partials in order, and
//     the host knows the levels from n alone (5 for 7,577,600 positions);
//   * rows that no id touches are zero: the C entry clears the output with
//     cudaMemsetAsync before the first launch.
// No atomics anywhere.  What each choice bought on an H100 (a block-wide
// chunk of 256 with barriers, registers per warp, the column groups) is in
// PERF.md, under K1's redesign.

#include "common.cuh"

namespace {

constexpr int kChunk = 32;   // stream positions per chunk: a lane each
constexpr int kWarps = 8;    // chunks (warps) per block of both kernels
constexpr int kCols = 16;    // most columns a chunk's warp takes (32 bytes
                             // of bfloat16; 8 float32 columns take 32)
constexpr unsigned kFull = 0xffffffffu;

// One warp sums chunk b of a stream: the kChunk positions from b * kChunk
// of ids (live: in [0, rows); equal live ids adjacent), whose rows are
// g[perm[i]] (perm null: g[i]).  Runs that start and end in the chunk are
// stored into out; a run cut by an edge leaves its partial in next_vals,
// keyed in next_ids (2 slots a chunk, see the notes above).
template <typename T, typename O>
__device__ __forceinline__ void sum_chunk(
    const int* __restrict__ ids, const int* __restrict__ perm,
    const T* __restrict__ g, int n, int rows, int d, O* __restrict__ out,
    int* __restrict__ next_ids, float* __restrict__ next_vals) {
  __shared__ float s_slab[kWarps][kChunk * (kCols + 1)];  // a warp's [32, nc]
  __shared__ int s_tail_lane[kWarps][kChunk];  // r-th run tail: lane | where
  __shared__ int s_tail_id[kWarps][kChunk];    // ... and its id

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  const int s = b * kChunk;
  if (s >= n) return;  // the whole warp
  const int m = min(kChunk, n - s);  // positions in this chunk
  int id = -1;
  int pr = 0;
  if (lane < m) {
    id = ids[s + lane];
    pr = perm ? perm[s + lane] : s + lane;
  }
  const int before = s > 0 ? ids[s - 1] : -1;
  const int after = kChunk < n - s ? ids[s + kChunk] : -1;
  int prev = __shfl_up_sync(kFull, id, 1);
  int next = __shfl_down_sync(kFull, id, 1);
  if (lane == 0) prev = before;
  if (lane == 31) next = after;
  const int first = __shfl_sync(kFull, id, 0);
  const int last = __shfl_sync(kFull, id, m - 1);
  const bool live = (unsigned)id < (unsigned)rows;
  const bool tail = live && (lane == m - 1 || next != id);  // in the chunk
  // the run ending here began in an earlier chunk / goes on into the next
  const bool cut_lo = live && id == first && before == id;
  const bool cut_hi = live && lane == m - 1 && next == id;
  // the chunk's first run began earlier (slot 0); its last run goes on
  // (slot 1); one run both (through: its partial in slot 0, zero in 1)
  const bool lo = (unsigned)first < (unsigned)rows && before == first;
  const bool hi = (unsigned)last < (unsigned)rows && m == kChunk &&
                  after == last;
  const bool through = lo && hi && first == last;
  if (lane == 0 && blockIdx.y == 0) {
    next_ids[2 * b] = lo ? first : -1;
    next_ids[2 * b + 1] = hi ? last : -1;
  }
  // segments start at run heads and at lane 0
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
  // the run tails in position order, and where each one's sums go
  const unsigned tails = __ballot_sync(kFull, tail);
  const int n_tails = __popc(tails);
  if (tail) {
    const int rank = __popc(tails & ((1u << lane) - 1));
    s_tail_lane[warp][rank] = lane | (cut_lo ? 1 : cut_hi ? 2 : 0) << 8;
    s_tail_id[warp][rank] = id;
  }

  // this block row's columns [c0, c0 + nc), nc <= kCols; item k of the
  // [32, nc] slab is (q, c) = divmod(k, nc), stepped without dividing
  const int c0 = (int)((int64_t)d * blockIdx.y / gridDim.y);
  const int nc = (int)((int64_t)d * (blockIdx.y + 1) / gridDim.y) - c0;
  if (through && lane < nc) {
    next_vals[((int64_t)b * 2 + 1) * d + c0 + lane] = 0.f;
  }
  const int stride = nc | 1;  // odd: a lane's own slab row is conflict-free
  const int q_step = kChunk / nc;
  const int c_step = kChunk - q_step * nc;
  float* slab = s_slab[warp];
  int q = lane / nc;
  int c = lane - q * nc;
  const int items = m * nc;
#pragma unroll 8
  for (int base = 0; base < items; base += kChunk) {
    const int idq = __shfl_sync(kFull, id, q & 31);
    const int pq = __shfl_sync(kFull, pr, q & 31);
    if (base + lane < items) {
      slab[q * stride + c] = (unsigned)idq < (unsigned)rows
                                 ? wdt::load_f(g, (int64_t)pq * d + c0 + c)
                                 : 0.f;
    }
    q += q_step;
    c += c_step;
    if (c >= nc) {
      c -= nc;
      ++q;
    }
  }
  __syncwarp();
  // segmented inclusive scan of each column; a run's sum lands at its tail
#pragma unroll 4
  for (int j = 0; j < nc; ++j) {
    float x = live ? slab[lane * stride + j] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, x, off);
      if (lane - off >= start) x += up;
    }
    if (tail) slab[lane * stride + j] = x;
  }
  __syncwarp();
  // item k = (r, c): column c of the r-th run tail's sums
  int r = lane / nc;
  c = lane - r * nc;
  const int out_items = n_tails * nc;
#pragma unroll 4
  for (int base = 0; base < out_items; base += kChunk) {
    if (base + lane < out_items) {
      const int e = s_tail_lane[warp][r];
      const float x = slab[(e & 0xff) * stride + c];
      if (e >> 8) {  // a cut run: its partial, in slot (e >> 8) - 1
        next_vals[((int64_t)b * 2 + (e >> 8) - 1) * d + c0 + c] = x;
      } else {
        wdt::store_f(out, (int64_t)s_tail_id[warp][r] * d + c0 + c, x);
      }
    }
    r += q_step;
    c += c_step;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// The stream's chunks: one warp each.
template <typename T, typename O>
__global__ void __launch_bounds__(kWarps * 32)
    range_chunk_kernel(const int* __restrict__ ids,
                       const int* __restrict__ perm,
                       const T* __restrict__ g, int n, int rows, int d,
                       O* __restrict__ out, int* __restrict__ next_ids,
                       float* __restrict__ next_vals) {
  sum_chunk<T, O>(ids, perm, g, n, rows, d, out, next_ids, next_vals);
}

// One carry level: the previous pass's n slots (keys, float32 partials),
// summed as a stream of their own.
template <typename O>
__global__ void __launch_bounds__(kWarps * 32)
    range_carry_kernel(const int* __restrict__ ids,
                       const float* __restrict__ vals, int n, int rows,
                       int d, O* __restrict__ out, int* __restrict__ next_ids,
                       float* __restrict__ next_vals) {
  sum_chunk<float, O>(ids, nullptr, vals, n, rows, d, out, next_ids,
                      next_vals);
}

int64_t n_chunks_for(int64_t n) { return (n + kChunk - 1) / kChunk; }

// The chunks of the next carry level after a pass of c chunks (2 slots
// each); the levels run while the pass before had more than one chunk.
int64_t next_level(int64_t c) { return n_chunks_for(2 * c); }

int blocks_for(int64_t chunks) {
  return (int)((chunks + kWarps - 1) / kWarps);
}

template <typename T, typename O>
void launch(const int* ids, const int* perm, const T* g, int n, int rows,
            int d, O* out, float* scratch, cudaStream_t stream) {
  // a pass of c chunks writes 2c keys, then 2c partial rows, into scratch
  int64_t chunks = n_chunks_for(n);
  int* next_ids = reinterpret_cast<int*>(scratch);
  float* next_vals = scratch + 2 * chunks;
  // column groups of one 32-byte sector of a row: nc <= kCols
  const int groups = (int)(((int64_t)d * sizeof(T) + 31) / 32);
  range_chunk_kernel<T, O><<<dim3(blocks_for(chunks), groups), kWarps * 32,
                             0, stream>>>(ids, perm, g, n, rows, d, out,
                                          next_ids, next_vals);
  const int carry_groups = (int)(((int64_t)d * sizeof(float) + 31) / 32);
  while (chunks > 1) {
    const int* level_ids = next_ids;
    const float* level_vals = next_vals;
    const int slots = (int)(2 * chunks);
    float* level_end = next_vals + 2 * chunks * d;
    chunks = next_level(chunks);
    next_ids = reinterpret_cast<int*>(level_end);
    next_vals = level_end + 2 * chunks;
    range_carry_kernel<O><<<dim3(blocks_for(chunks), carry_groups),
                            kWarps * 32, 0, stream>>>(
        level_ids, level_vals, slots, rows, d, out, next_ids, next_vals);
  }
}

template <typename T>
void launch_out(const int* ids, const int* perm, const T* g, int n, int rows,
                int d, void* out, int out_bf16, float* scratch,
                cudaStream_t stream) {
  if (out_bf16) {
    launch(ids, perm, g, n, rows, d, static_cast<__nv_bfloat16*>(out),
           scratch, stream);
  } else {
    launch(ids, perm, g, n, rows, d, static_cast<float*>(out), scratch,
           stream);
  }
}

}  // namespace

// The carry levels (range_carry_kernel launches) wdt_range_scatter_add
// makes for n stream positions.
extern "C" int wdt_range_carry_levels(int n) {
  int levels = 0;
  for (int64_t c = n_chunks_for(n); c > 1; c = next_level(c)) ++levels;
  return levels;
}

// float32 elements of the scratch wdt_range_scatter_add needs for n stream
// positions of width d: per chunk of the chunk pass and of every carry
// level, two keys and two partial rows.
extern "C" int64_t wdt_range_scratch_floats(int n, int d) {
  int64_t c = n_chunks_for(n);
  int64_t chunks = c;
  while (c > 1) {
    c = next_level(c);
    chunks += c;
  }
  return chunks * (2 + 2 * (int64_t)d);
}

// ids, perm: int32 [n], ids sorted; g: [n, d] float32 or bfloat16 (g_bf16);
// out: [rows, d] float32 or bfloat16 (out_bf16), cleared and then written
// here; scratch: float32, at least wdt_range_scratch_floats(n, d) of them.
// One memset, the chunk pass and wdt_range_carry_levels(n) carry levels on
// stream; returns the launch error.
extern "C" int wdt_range_scatter_add(const int* ids, const int* perm,
                                     const void* g, int g_bf16, int n,
                                     int rows, int d, void* out, int out_bf16,
                                     float* scratch, int64_t scratch_floats,
                                     cudaStream_t stream) {
  if (n < 0 || rows < 0 || d < 0 ||
      scratch_floats < wdt_range_scratch_floats(n, d)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)rows * d * (out_bf16 ? 2 : 4);
  if (bytes) {
    const cudaError_t err = cudaMemsetAsync(out, 0, bytes, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0 && rows > 0 && d > 0) {
    if (g_bf16) {
      launch_out(ids, perm, static_cast<const __nv_bfloat16*>(g), n, rows, d,
                 out, out_bf16, scratch, stream);
    } else {
      launch_out(ids, perm, static_cast<const float*>(g), n, rows, d, out,
                 out_bf16, scratch, stream);
    }
  }
  return (int)cudaGetLastError();
}
