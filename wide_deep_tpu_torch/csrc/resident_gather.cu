// P1: row gather from a resident pool, scaled per row.
//
// Replaces tools/microbench_vmem_gather.py::kernel_gather (Pallas body
// _gather_kernel), which holds the whole pooled gradient dpool [B, D] in
// VMEM and gathers 1024 of its rows per grid step:
// out[i] = w[i] * dpool[seg[i]].  (Mosaic could not lower that gather.)
//
// Bound on the card: bytes.  seg, w and out stream through once; dpool is
// read once per output row, but at the probe's [25600, 8] float32 it is
// 0.8 MB and stays in the 50 MB L2 cache -- Hopper's "resident", since the
// 227 KB of shared memory a block can have cannot hold it.  dpool is read
// through the read-only path (__ldg).  A 2-D block puts threadIdx.x on the
// columns (one float4 each when D % 4 == 0, else one float) and threadIdx.y
// on the rows, so neighbouring threads write neighbouring addresses and the
// output, the largest stream, is written coalesced, with no division.
//
// Every row is written, for any n (the TPU grid, n / 1024 steps, left the
// rows after the last whole tile unwritten).  Out-of-range seg follows
// jnp's x[idx]: a negative index wraps once, then it is clamped to [0, B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t pool_row(int s, int64_t b) {
  const int64_t r = s < 0 ? (int64_t)s + b : (int64_t)s;
  return r < 0 ? 0 : (r >= b ? b - 1 : r);
}

__device__ __forceinline__ float4 scale(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ float scale(float v, float s) { return v * s; }

// T is float4 (vecs = D / 4) or float (vecs = D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                  const T* __restrict__ dpool, int64_t b, int vecs,
                  T* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const float wi = __ldg(w + i);
  const T* src = dpool + pool_row(__ldg(seg + i), b) * vecs;
  T* dst = out + i * vecs;
  for (int j = threadIdx.x; j < vecs; j += blockDim.x) {
    dst[j] = scale(__ldg(src + j), wi);
  }
}

template <typename T>
void launch(const int* seg, const float* w, const void* dpool, int64_t b,
            int vecs, void* out, int64_t n, cudaStream_t stream) {
  const int bx = vecs < kThreads ? vecs : kThreads;
  const int by = kThreads / bx;
  const int64_t blocks = (n + by - 1) / by;
  gather_kernel<T><<<(unsigned)blocks, dim3(bx, by), 0, stream>>>(
      seg, w, static_cast<const T*>(dpool), b, vecs, static_cast<T*>(out),
      n);
}

}  // namespace

// seg: int32 [n]; w: float32 [n]; dpool: float32 [b, d]; out: float32
// [n, d].  vec4: d % 4 == 0 and dpool 16-byte aligned.
extern "C" int wdt_resident_gather(const int* seg, const float* w,
                                   const float* dpool, long long b, int d,
                                   long long n, int vec4, float* out,
                                   cudaStream_t stream) {
  if (n > 0 && d > 0) {
    if (vec4) {
      launch<float4>(seg, w, dpool, b, d / 4, out, n, stream);
    } else {
      launch<float>(seg, w, dpool, b, d, out, n, stream);
    }
  }
  return (int)cudaGetLastError();
}
