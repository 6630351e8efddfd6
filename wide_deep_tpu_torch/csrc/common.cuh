// Shared helpers of the port's scatter kernels: element loads and stores
// in float32 or bfloat16, always summing in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wdt {

constexpr int kTIds = 1024;  // max ids in one plan tile (ops/scatter.T_IDS)
constexpr int kMaxr = 2048;  // rows in one window (ops/scatter.MAXR)

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

}  // namespace wdt
