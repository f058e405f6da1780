// Multi-tensor Adam update with the non-finite guard, float32.
//
// Replaces the per-parameter Adam step inside mxnet_tpu/executor.py
// fused_train_update: Adam.jax_apply (mxnet_tpu/optimizer.py:377-391) over
// _adam_update (mxnet_tpu/ops/defs_optimizer.py:78-87) with _prep_grad's
// wd-before-clip order (:33-43), unrolled over every parameter and fused by
// XLA, and the MXNET_NONFINITE_GUARD select (executor.py:1539,1614-1652).
// See mxnet_tpu_torch/kernels/adam_multi.py for the wrapper, the table it
// builds and the plain version. Per element of parameter e, in place, with
// the reference's order of operations (lr_e already bias-corrected by the
// host: lr * sqrt(1 - beta2^t) / (1 - beta1^t) in float32):
//
//   g = grad * rescale;  g = g + wd_e * w;  g = clip(g, -clip, clip) if clip >= 0
//   mean = beta1 * mean + (1 - beta1) * g
//   var = beta2 * var + (1 - beta2) * (g * g)
//   w = w - (lr_e * mean) / (sqrt(var) + eps)
//
// Under the guard a probe launch (mxt_adam_probe_f32, over the same
// (weight, mean, numel) table) first adds every gradient element into one
// device float; when it is not finite this launch writes
// no weight, mean or variance, copies each restore entry's source back over
// its destination, and block 0 advances the [total, consecutive] skip
// counters: no host synchronisation per step.
//
// Bound: device-memory bandwidth, 28 bytes per parameter element (read w,
// g, mean, var; write w, mean, var). Design: one launch over all tensors
// from a device table of (weight, mean, numel) entries, a parallel array of
// variance pointers, a (lr, wd) row per entry and a block map that cuts
// every tensor into chunks of `chunk` elements; the wrapper keeps them on
// the device until a tensor moves. Gradient pointers are one int64 per
// tensor beside the table, uploaded when they move.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Entry {       // one update tensor (int64 x 3), the probe's layout
  long long w, m, numel;
};
struct Restore {     // one guarded restore (int64 x 3)
  long long dst, src, numel;
};

__device__ __forceinline__ float clip_nan(float g, float clip) {
  // jnp.clip lets NaN through
  return g < -clip ? -clip : (g > clip ? clip : g);
}

__global__ void __launch_bounds__(kThreads)
adam_probe_kernel(const Entry* __restrict__ entries,
                  const long long* __restrict__ grads,
                  const long long* __restrict__ blocks, int n_entries,
                  long long chunk, float* probe) {
  __shared__ float scratch[kThreads / 32];
  const long long e = blocks[2 * blockIdx.x];
  if (e >= n_entries) return;  // a restore block
  const long long start = blocks[2 * blockIdx.x + 1];
  const Entry en = entries[e];
  const long long end = start + chunk < en.numel ? start + chunk : en.numel;
  const float* g = reinterpret_cast<const float*>(grads[e]);
  float s = 0.f;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) s += g[i];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += scratch[w];
    atomicAdd(probe, t);
  }
}

__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const Entry* __restrict__ entries,
                  const long long* __restrict__ vars,
                  const long long* __restrict__ grads,
                  const float* __restrict__ hyper,
                  const Restore* __restrict__ restores,
                  const long long* __restrict__ blocks, int n_entries,
                  long long chunk, float beta1, float beta2, float one_b1,
                  float one_b2, float eps, float rescale, float clip,
                  const float* __restrict__ probe, int* counters) {
  const bool finite = probe == nullptr || isfinite(*probe);
  if (counters != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    if (finite) {
      counters[1] = 0;
    } else {
      counters[0] += 1;
      counters[1] += 1;
    }
  }
  const long long e = blocks[2 * blockIdx.x];
  const long long start = blocks[2 * blockIdx.x + 1];
  if (e >= n_entries) {  // restore the pre-forward values of a skipped step
    if (finite) return;
    const Restore r = restores[e - n_entries];
    const long long end = start + chunk < r.numel ? start + chunk : r.numel;
    float* dst = reinterpret_cast<float*>(r.dst);
    const float* src = reinterpret_cast<const float*>(r.src);
    for (long long i = start + threadIdx.x; i < end; i += kThreads)
      dst[i] = src[i];
    return;
  }
  if (!finite) return;
  const Entry en = entries[e];
  const long long end = start + chunk < en.numel ? start + chunk : en.numel;
  const float lr = hyper[2 * e], wd = hyper[2 * e + 1];
  float* w = reinterpret_cast<float*>(en.w);
  float* m = reinterpret_cast<float*>(en.m);
  float* v = reinterpret_cast<float*>(vars[e]);
  const float* gr = reinterpret_cast<const float*>(grads[e]);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float wi = w[i];
    float g = __fmul_rn(gr[i], rescale);
    g = __fadd_rn(g, __fmul_rn(wd, wi));
    if (clip >= 0.f) g = clip_nan(g, clip);
    const float mi = __fadd_rn(__fmul_rn(beta1, m[i]), __fmul_rn(one_b1, g));
    const float vi = __fadd_rn(__fmul_rn(beta2, v[i]),
                               __fmul_rn(one_b2, __fmul_rn(g, g)));
    m[i] = mi;
    v[i] = vi;
    w[i] = __fsub_rn(wi, __fdiv_rn(__fmul_rn(lr, mi),
                                   __fadd_rn(__fsqrt_rn(vi), eps)));
  }
}

}  // namespace

// Zero the probe and add every gradient into it (one launch).
extern "C" int mxt_adam_probe_f32(const void* entries, const void* grads,
                                  const void* blocks, int n_blocks,
                                  int n_entries, long long chunk, void* probe,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(probe, 0, sizeof(float), s);
  if (n_blocks > 0) {
    adam_probe_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
        (const Entry*)entries, (const long long*)grads,
        (const long long*)blocks, n_entries, chunk, (float*)probe);
  }
  return (int)cudaGetLastError();
}

// probe and counters are null without the guard.
extern "C" int mxt_adam_multi_f32(const void* entries, const void* vars,
                                  const void* grads, const void* hyper,
                                  const void* restores, const void* blocks,
                                  int n_blocks, int n_entries,
                                  long long chunk, float beta1, float beta2,
                                  float one_b1, float one_b2, float eps,
                                  float rescale, float clip,
                                  const void* probe, void* counters,
                                  void* stream) {
  if (n_blocks > 0) {
    adam_multi_kernel<<<(unsigned)n_blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const Entry*)entries, (const long long*)vars,
        (const long long*)grads, (const float*)hyper,
        (const Restore*)restores, (const long long*)blocks, n_entries, chunk,
        beta1, beta2, one_b1, one_b2, eps, rescale, clip,
        (const float*)probe, (int*)counters);
  }
  return (int)cudaGetLastError();
}
