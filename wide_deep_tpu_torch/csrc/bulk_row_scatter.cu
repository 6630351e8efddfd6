// P2: in-place row scatter through the bulk-copy unit.
//
// Replaces tools/microbench_rowdma_scatter.py::kernel_scatter (Pallas body
// _scatter_kernel; kernel_scatter_viewed only calls it):
// table.at[uids].set(rows) for sorted unique uids, as one async HBM->HBM
// row DMA per uid with a ring of 32 DMA semaphores, 512 uids per grid step.
//
// Hopper's counterpart of that row DMA is the bulk-copy unit (cp.async.bulk,
// the one-dimensional form of TMA): one thread asks for a whole run of bytes
// to be copied and spends no registers on them.  It copies between global
// and shared memory only, so each row is staged in shared memory, and every
// row's store to the table is a shared->global bulk copy of its own: that is
// what this probe measures against K3 (csrc/rowdma.cu, a warp's lanes per
// row).
//
// Bound on the card: bytes (each live row read once and written once, plus
// the uids).  What held the first design back was latency, not bytes: one
// issuing thread per block of 512 uids (the other 127 returned at once), so
// 25,600 uids filled 50 blocks on 132 SMs with at most 16 loads in flight
// each, every store waiting on a spin for its own row's load; and the C
// entry set the shared-memory attribute on every call.  The design:
//   * a warp per 32 uids: warp w of block b owns the chunk of kLanes = 32
//     uids at (b * kWarps + w) * 32, one per lane, and works alone (no block
//     barrier after the mbarriers' set-up);
//   * one load per round: the chunk's live rows (uid in [0, R)) are
//     contiguous in rows[] because the uids are sorted (negative uids first,
//     sentinels >= R last), so the warp's first live lane asks for all of
//     them with one bulk load into the warp's slab, completing on the warp's
//     mbarrier; skipped rows at either end take no slab traffic;
//   * after one wait on the barrier, every live lane issues its own row's
//     bulk store to the table;
//   * one wave: kWarps = 4 warps a block and a 16 KB slab a warp (32 rows of
//     512 bytes) make 64 KB a block, 3 blocks an SM; the tool's 25,600 uids
//     are 200 blocks, so every load of the scatter is in flight at once.  A
//     row wider than 512 bytes takes min(32, 16 KB / row) rows a round, and
//     the warp loops (its stores must have read the slab,
//     cp.async.bulk.wait_group.read, before the next round loads over it);
//   * host: the C entry sets the kernel's dynamic shared-memory ceiling once
//     per device and process.
// What each choice bought on an H100 (a bulk load per lane, loads through
// the lanes, a persistent block per SM with a two-stage ring) is in PERF.md,
// under P2's redesign.  Uids outside [0, R) are skipped.  A row must be a
// multiple of 16 bytes at 16-byte aligned addresses (the unit's rule; the
// wrapper checks it), and at most kMaxRowBytes (wdt_bulk_max_row_bytes;
// ops/rowdma.BULK_MAX_ROW_BYTES must agree).  No clusters, no tensor map, no
// atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLanes = 32;          // uids per warp, one a lane
constexpr int kWarps = 4;           // warps per block
constexpr int kSlabBytes = 16384;   // a warp's slab: 32 rows of 512 bytes
constexpr int kMaxRowBytes = 7168;  // the first design's limit (its 32 ring
                                    // slots); a round then holds two rows
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int rows_per_round(int row_bytes) {
  return kSlabBytes / row_bytes < kLanes ? kSlabBytes / row_bytes : kLanes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kWarps * kLanes)
    bulk_row_scatter_kernel(char* __restrict__ table, int64_t n_rows,
                            const int* __restrict__ uids,
                            const char* __restrict__ rows, int n,
                            uint32_t row_bytes) {
  __shared__ __align__(8) uint64_t bars[kWarps];
  extern __shared__ __align__(128) unsigned char slabs[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kWarps) {  // one arrival (with the bytes) a phase
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bars[threadIdx.x]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int base = (blockIdx.x * kWarps + warp) * kLanes;
  if (base >= n) return;  // the whole warp
  const int m = min(kLanes, n - base);
  int u = -1;
  if (lane < m) u = __ldg(uids + base + lane);
  const bool live = lane < m && u >= 0 && (int64_t)u < n_rows;
  const int per_round = rows_per_round((int)row_bytes);
  unsigned char* slab = slabs + (size_t)warp * per_round * row_bytes;
  const uint32_t bar = smem_addr(&bars[warp]);
  uint32_t parity = 0;

  for (int r0 = 0; r0 < m; r0 += per_round) {
    const int j = lane - r0;  // this lane's row is slot j of the round
    const bool mine = live && j >= 0 && j < per_round;
    const unsigned mask = __ballot_sync(kFull, mine);
    if (mask == 0) continue;  // the whole warp
    // chunk rows [lo, hi): the round's live rows (any skipped row between
    // them, which sorted uids never give, is loaded and not stored)
    const int lo = __ffs(mask) - 1;
    const int hi = 32 - __clz(mask);
    if (lane == lo) {
      const uint32_t bytes = (uint32_t)(hi - lo) * row_bytes;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(slab + (size_t)(lo - r0) * row_bytes)),
          "l"(rows + (int64_t)(base + lo) * row_bytes), "r"(bytes), "r"(bar)
          : "memory");
    }
    wait_phase(bar, parity);
    parity ^= 1u;
    if (mine) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              table + (int64_t)u * row_bytes),
          "r"(smem_addr(slab + (size_t)j * row_bytes)), "r"(row_bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (r0 + per_round < m) {  // the next round loads over the slab
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
    }
  }
  // the slab outlives every store's read of it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;
std::atomic<uint64_t> g_smem_set{0};  // a bit per device

}  // namespace

// The widest row wdt_bulk_row_scatter takes, in bytes.
extern "C" int wdt_bulk_max_row_bytes() { return kMaxRowBytes; }

// table: [n_rows, row_bytes] bytes; rows: [n, row_bytes] bytes; uids: int32
// [n].  row_bytes % 16 == 0, 16-byte aligned pointers, row_bytes <=
// wdt_bulk_max_row_bytes().  One launch on stream (none for n = 0); returns
// the launch error.
extern "C" int wdt_bulk_row_scatter(void* table, long long n_rows,
                                    const int* uids, const void* rows, int n,
                                    int row_bytes, cudaStream_t stream) {
  if (row_bytes <= 0 || row_bytes % 16 || row_bytes > kMaxRowBytes || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < kMaxDevices ? 1ull << dev : 0;
  if (!(g_smem_set.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(bulk_row_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWarps * kSlabBytes);
    if (e != cudaSuccess) return (int)e;
    g_smem_set.fetch_or(bit, std::memory_order_release);
  }
  const int smem = kWarps * rows_per_round(row_bytes) * row_bytes;
  const int per_block = kWarps * kLanes;
  const int blocks = (int)(((int64_t)n + per_block - 1) / per_block);
  bulk_row_scatter_kernel<<<blocks, per_block, smem, stream>>>(
      static_cast<char*>(table), (int64_t)n_rows, uids,
      static_cast<const char*>(rows), n, (uint32_t)row_bytes);
  return (int)cudaGetLastError();
}
