// The dense optimizer sweeps: one FTRL or Adagrad step over a whole leaf in
// one pass.
//
// Replaces no Pallas kernel: the JAX package leaves these updates to XLA,
// which fuses each into one loop (wide_deep_tpu/optim/__init__.py).  In
// PyTorch the same formulas ran as an eager chain of about 25 (FTRL) or 15
// (Adagrad) elementwise launches, each reading and writing whole tensors,
// the roots widened to float64.  Here each element is read once and
// written once: FTRL reads w, g, n, z and writes w, n, z (28 bytes an
// element in float32); Adagrad reads w, g, s and writes w, s (20 bytes in
// float32, 10 in bfloat16).  Bound on the card: bytes.
//
// The bits are those of the eager versions on the host
// (optim/__init__.py `_ftrl_`, `_adagrad_`), 0 ulp: every rounding they
// make is made here, in the same order, and no other.  Each float32 op is
// an intrinsic that rounds once (__fadd_rn, __fmul_rn, __fdiv_rn: never
// contracted into a fused multiply-add); a bfloat16 op is the float32 op
// rounded to bfloat16 (`rnd`), as torch computes it; a root is the
// float64 root rounded to float32 (`root`, the host's `_sqrt`), and a
// reciprocal correctly rounded (`_rsqrt`).  Scalars come by value from the
// host already rounded as torch rounds them: no device sync, no scalar
// tensor.
//
// A grid-stride loop over 16-byte packs of the param (4 float32 or 8
// bfloat16 elements; FTRL's float32 slots two packs at bfloat16), then a
// scalar tail; a leaf whose pointers are not all 16-byte aligned (a view
// into a flat buffer) takes the scalar loop throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int N>
struct alignas(16) Pack {
  T v[N];
};

__device__ __forceinline__ float f(float x) { return x; }
__device__ __forceinline__ float f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T to(float x);
template <>
__device__ __forceinline__ float to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, back in float32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return f(to<T>(x));
}

__device__ __forceinline__ float root(float x) {
  return __double2float_rn(__dsqrt_rn((double)x));
}

// _ftrl_: n2 = n + g*g; z2 = (z + g) - (root(n2) - root(n)) / lr * w;
// w_new = |z2| <= l1 ? 0 : (sign(z2) l1 - z2) / (root(n2) / lr + 2 l2);
// w += (w_new - w) in w's dtype.  `first`: the root of n is taken in w's
// dtype.
template <typename W>
__device__ __forceinline__ void ftrl_one(W& w, float g, float& n, float& z,
                                         float lr, float l1, float l2x2,
                                         bool first) {
  const float wf = f(w);
  const float n2 = __fadd_rn(n, __fmul_rn(g, g));
  const float root_n2 = root(n2);
  const float root_n = first ? rnd<W>(root(rnd<W>(n))) : root(n);
  const float sigma = __fdiv_rn(__fsub_rn(root_n2, root_n), lr);
  const float z2 = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, wf));
  float w_new = 0.0f;
  if (!(fabsf(z2) <= l1)) {
    const float sgn = (float)((z2 > 0.0f) - (z2 < 0.0f));  // torch.sign
    w_new = __fdiv_rn(__fsub_rn(__fmul_rn(sgn, l1), z2),
                      __fadd_rn(__fdiv_rn(root_n2, lr), l2x2));
  }
  w = to<W>(__fadd_rn(wf, rnd<W>(__fsub_rn(w_new, wf))));
  n = n2;
  z = z2;
}

// _adagrad_, every op in T: s = g*g + s; inv = s > 0 ? 1 / root(s + eps)
// : 0; w = w + (-lr) * (inv * g).
template <typename T>
__device__ __forceinline__ void adagrad_one(T& w, float g, T& s,
                                            float neg_lr, float eps) {
  const float s2 = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(g, g)), f(s)));
  float inv = 0.0f;
  if (s2 > 0.0f) inv = rnd<T>(__frcp_rn(root(rnd<T>(__fadd_rn(s2, eps)))));
  const float u = rnd<T>(__fmul_rn(neg_lr, rnd<T>(__fmul_rn(inv, g))));
  w = to<T>(__fadd_rn(f(w), u));
  s = to<T>(s2);
}

template <typename W>
__global__ void optim_elementwise_ftrl_kernel(W* __restrict__ w,
                                              const W* __restrict__ g,
                                              float* __restrict__ n,
                                              float* __restrict__ z,
                                              int64_t count, int64_t packs,
                                              float lr, float l1, float l2x2,
                                              int first) {
  constexpr int V = 16 / sizeof(W);
  using PW = Pack<W, V>;
  using PF = Pack<float, V>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = t; i < packs; i += stride) {
    PW pw = reinterpret_cast<const PW*>(w)[i];
    const PW pg = reinterpret_cast<const PW*>(g)[i];
    PF pn = reinterpret_cast<const PF*>(n)[i];
    PF pz = reinterpret_cast<const PF*>(z)[i];
#pragma unroll
    for (int k = 0; k < V; ++k)
      ftrl_one(pw.v[k], f(pg.v[k]), pn.v[k], pz.v[k], lr, l1, l2x2, first);
    reinterpret_cast<PW*>(w)[i] = pw;
    reinterpret_cast<PF*>(n)[i] = pn;
    reinterpret_cast<PF*>(z)[i] = pz;
  }
  for (int64_t i = packs * V + t; i < count; i += stride)
    ftrl_one(w[i], f(g[i]), n[i], z[i], lr, l1, l2x2, first);
}

template <typename T>
__global__ void optim_elementwise_adagrad_kernel(T* __restrict__ w,
                                                 const T* __restrict__ g,
                                                 T* __restrict__ s,
                                                 int64_t count, int64_t packs,
                                                 float neg_lr, float eps) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = t; i < packs; i += stride) {
    P pw = reinterpret_cast<const P*>(w)[i];
    const P pg = reinterpret_cast<const P*>(g)[i];
    P ps = reinterpret_cast<const P*>(s)[i];
#pragma unroll
    for (int k = 0; k < V; ++k)
      adagrad_one(pw.v[k], f(pg.v[k]), ps.v[k], neg_lr, eps);
    reinterpret_cast<P*>(w)[i] = pw;
    reinterpret_cast<P*>(s)[i] = ps;
  }
  for (int64_t i = packs * V + t; i < count; i += stride)
    adagrad_one(w[i], f(g[i]), s[i], neg_lr, eps);
}

// The blocks of `kernel` that fit on the card at once (read once per
// kernel: the process's cards are alike).
template <typename K>
int64_t wave_of(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// Blocks for `work` items of a grid-stride kernel: one wave, fewer for a
// short leaf.
unsigned grid_for(int64_t wave, int64_t work) {
  const int64_t need = (work + kThreads - 1) / kThreads;
  return (unsigned)(need < wave ? (need > 0 ? need : 1) : wave);
}

template <typename W>
int launch_ftrl(void* w, const void* g, float* n, float* z, long long count,
                int aligned, float lr, float l1, float l2x2, int first,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(W);
  const int64_t packs = aligned ? count / V : 0;
  const auto kernel = optim_elementwise_ftrl_kernel<W>;
  static const int64_t wave = wave_of(kernel);
  kernel<<<grid_for(wave, packs ? packs : count), kThreads, 0, stream>>>(
      static_cast<W*>(w), static_cast<const W*>(g), n, z, count, packs, lr,
      l1, l2x2, first);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_adagrad(void* w, const void* g, void* s, long long count,
                   int aligned, float neg_lr, float eps,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t packs = aligned ? count / V : 0;
  const auto kernel = optim_elementwise_adagrad_kernel<T>;
  static const int64_t wave = wave_of(kernel);
  kernel<<<grid_for(wave, packs ? packs : count), kThreads, 0, stream>>>(
      static_cast<T*>(w), static_cast<const T*>(g), static_cast<T*>(s),
      count, packs, neg_lr, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// One FTRL step in place over `count` elements.  w, g: the param's dtype
// (bf16 0: float32, 1: bfloat16); n, z: float32.  lr, l1: float32; l2x2:
// 2 * l2 in float32; `aligned`: every pointer is 16-byte aligned.
extern "C" int wdt_ftrl_sweep(void* w, const void* g, float* n, float* z,
                              long long count, int bf16, int aligned,
                              float lr, float l1, float l2x2, int first,
                              cudaStream_t stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_ftrl<__nv_bfloat16>(w, g, n, z, count, aligned, lr,
                                          l1, l2x2, first, stream)
              : launch_ftrl<float>(w, g, n, z, count, aligned, lr, l1, l2x2,
                                   first, stream);
}

// One Adagrad step in place over `count` elements; w, g and s all in the
// param's dtype (bf16 as above).  neg_lr: -lr rounded to that dtype; eps
// likewise.
extern "C" int wdt_adagrad_sweep(void* w, const void* g, void* s,
                                 long long count, int bf16, int aligned,
                                 float neg_lr, float eps,
                                 cudaStream_t stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_adagrad<__nv_bfloat16>(w, g, s, count, aligned,
                                              neg_lr, eps, stream)
              : launch_adagrad<float>(w, g, s, count, aligned, neg_lr, eps,
                                      stream);
}
