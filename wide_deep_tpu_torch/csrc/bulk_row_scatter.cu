// P2: in-place row scatter through the bulk-copy unit.
//
// Replaces tools/microbench_rowdma_scatter.py::kernel_scatter (Pallas body
// _scatter_kernel; kernel_scatter_viewed only calls it):
// table.at[uids].set(rows) for sorted unique uids, as one async HBM->HBM
// row DMA per uid with a ring of 32 DMA semaphores, 512 uids per grid step.
//
// Hopper's counterpart of that row DMA is the bulk-copy unit (cp.async.bulk,
// the one-dimensional form of TMA): one thread asks for a whole row to be
// copied and spends no registers on its bytes.  It copies between global and
// shared memory only, so each row is staged:
//   * one block per chunk of 512 uids (the probe's CHUNK);
//   * a ring of 32 row-sized slots in shared memory, one mbarrier each (the
//     probe's RING = 32; the write-back kernel it probes,
//     wide_deep_tpu/ops/rowdma.py, rings 8);
//   * one elected thread, per live uid: a global->shared bulk copy of the
//     row that completes on its slot's mbarrier, then, once the barrier's
//     phase is done, a shared->global bulk copy to the uid's row, committed
//     as a bulk async-group of its own;
//   * loads run kAhead = 16 rows ahead of stores; a slot is reclaimed for a
//     new load once the store that last used it has read it
//     (cp.async.bulk.wait_group.read); the last wait lets every store end.
// Uids outside [0, R) are skipped and take no slot.  A row must be a
// multiple of 16 bytes at 16-byte aligned addresses (the unit's rule; the
// wrapper checks it), and at most kMaxRowBytes so that 32 slots fit.
//
// Bound on the card: bytes (each live row read once and written once, plus
// the uids).  No clusters, no tensor map, no warp specialisation.  What
// limits this design is latency: one thread per block waits on the round
// trips of its own copies, with <= 16 row loads in flight (50 blocks at
// the probe's N = 25,600 and 512 uids per block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;  // uids per block
constexpr int kRing = 32;    // row slots in shared memory
constexpr int kAhead = 16;   // loads in flight ahead of the store
constexpr int kThreads = 128;
constexpr int kMaxRowBytes = 7168;  // 32 slots + the static part < 227 KB

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

__global__ void __launch_bounds__(kThreads)
    bulk_row_scatter_kernel(char* __restrict__ table, int64_t n_rows,
                            const int* __restrict__ uids,
                            const char* __restrict__ rows, int n,
                            uint32_t row_bytes) {
  __shared__ __align__(8) uint64_t bars[kRing];
  __shared__ int s_uid[kChunk];
  extern __shared__ __align__(128) unsigned char slots[];

  const int base = blockIdx.x * kChunk;
  const int m = min(kChunk, n - base);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int u = uids[base + i];
    s_uid[i] = (u >= 0 && (int64_t)u < n_rows) ? u : -1;  // -1: skipped
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bars[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  auto next_live = [&](int i) {
    while (i < m && s_uid[i] < 0) ++i;
    return i;
  };
  // chunk row i is the k-th live row: it takes slot k % kRing
  auto load = [&](int i, int k) {
    const int s = k % kRing;
    const uint32_t bar = smem_addr(&bars[s]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(row_bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slots + (size_t)s * row_bytes)),
        "l"(rows + (int64_t)(base + i) * row_bytes), "r"(row_bytes), "r"(bar)
        : "memory");
  };

  int ld = next_live(0);
  int n_ld = 0;
  for (; ld < m && n_ld < kAhead; ld = next_live(ld + 1)) load(ld, n_ld++);
  int n_st = 0;
  for (int i = next_live(0); i < m; i = next_live(i + 1), ++n_st) {
    const int s = n_st % kRing;
    wait_phase(smem_addr(&bars[s]), (uint32_t)(n_st / kRing) & 1u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            table + (int64_t)s_uid[i] * row_bytes),
        "r"(smem_addr(slots + (size_t)s * row_bytes)), "r"(row_bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (ld < m) {
      // live row n_ld (= n_st + kAhead) takes the slot of live row
      // n_st + kAhead - kRing; the kRing - kAhead stores committed after
      // that one may still be reading their slots
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kRing - kAhead)
                   : "memory");
      load(ld, n_ld++);
      ld = next_live(ld + 1);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// table: [n_rows, row_bytes] bytes; rows: [n, row_bytes] bytes; uids: int32
// [n].  row_bytes % 16 == 0, 16-byte aligned pointers, row_bytes <= 7168.
extern "C" int wdt_bulk_row_scatter(void* table, long long n_rows,
                                    const int* uids, const void* rows, int n,
                                    int row_bytes, cudaStream_t stream) {
  if (row_bytes <= 0 || row_bytes % 16 || row_bytes > kMaxRowBytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int smem = kRing * row_bytes;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          bulk_row_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n + kChunk - 1) / kChunk;
    bulk_row_scatter_kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<char*>(table), (int64_t)n_rows, uids,
        static_cast<const char*>(rows), n, (uint32_t)row_bytes);
  }
  return (int)cudaGetLastError();
}
