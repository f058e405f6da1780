// Multi-tensor SGD(-momentum) update with the non-finite guard, float32.
//
// Replaces the per-parameter update inside mxnet_tpu/executor.py
// fused_train_update (the optimizer's jax_apply over _prep_grad and
// _sgd_mom_update, mxnet_tpu/ops/defs_optimizer.py:34-72, unrolled over
// every parameter and fused by XLA) and its MXNET_NONFINITE_GUARD select
// (executor.py:1614-1652); see mxnet_tpu_torch/kernels/sgd_mom_multi.py for
// the wrapper, the table it builds and the plain version. Per element of
// parameter e, in place, with the reference's order of operations:
//
//   g = grad * rescale;  g = clip(g, -clip, clip) if clip >= 0;  g += wd_e * w
//   mom = momentum * mom - lr_e * g;  w = w + mom        (with momentum)
//   w = w - lr_e * g                                      (without)
//
// Under the guard a probe launch first adds every gradient element into one
// device float; the update launch reads it and, when it is not finite,
// writes no weight or momentum and copies each restore entry's source (the
// BatchNorm statistics as they were before the forward) back over its
// destination. Block 0 advances the [total, consecutive] skip counters on
// the device: no host synchronisation per step.
//
// Bound: device-memory bandwidth, 20 bytes per parameter element (read w,
// g, mom; write w, mom). Design: one launch over all tensors. The wrapper
// builds a table of tensors (weight and momentum pointers, sizes) and a
// block map that cuts each tensor into chunks of `chunk` elements, one
// block per chunk, and keeps both on the device until a tensor moves. The
// gradients are new tensors every step (autograd allocates them), so their
// pointers are a separate array of one int64 per tensor, uploaded when
// they move.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Entry {       // one update tensor (int64 x 3 in the table)
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
probe_kernel(const Entry* __restrict__ entries,
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
sgd_mom_multi_kernel(const Entry* __restrict__ entries,
                     const long long* __restrict__ grads,
                     const float* __restrict__ hyper,
                     const Restore* __restrict__ restores,
                     const long long* __restrict__ blocks, int n_entries,
                     long long chunk, float momentum, int has_mom,
                     float rescale, float clip,
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
  const float* gr = reinterpret_cast<const float*>(grads[e]);
  float* m = reinterpret_cast<float*>(en.m);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float wi = w[i];
    float g = __fmul_rn(gr[i], rescale);
    if (clip >= 0.f) g = clip_nan(g, clip);
    g = __fadd_rn(g, __fmul_rn(wd, wi));
    if (has_mom) {
      const float mi = __fsub_rn(__fmul_rn(momentum, m[i]), __fmul_rn(lr, g));
      m[i] = mi;
      w[i] = __fadd_rn(wi, mi);
    } else {
      w[i] = __fsub_rn(wi, __fmul_rn(lr, g));
    }
  }
}

}  // namespace

// Zero the probe and add every gradient into it (one launch).
extern "C" int mxt_sgd_probe_f32(const void* entries, const void* grads,
                                 const void* blocks, int n_blocks,
                                 int n_entries, long long chunk, void* probe,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(probe, 0, sizeof(float), s);
  if (n_blocks > 0) {
    probe_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
        (const Entry*)entries, (const long long*)grads,
        (const long long*)blocks, n_entries, chunk, (float*)probe);
  }
  return (int)cudaGetLastError();
}

// probe and counters are null without the guard.
extern "C" int mxt_sgd_mom_multi_f32(const void* entries, const void* grads,
                                     const void* hyper,
                                     const void* restores, const void* blocks,
                                     int n_blocks, int n_entries,
                                     long long chunk, float momentum,
                                     int has_mom, float rescale, float clip,
                                     const void* probe, void* counters,
                                     void* stream) {
  if (n_blocks > 0) {
    sgd_mom_multi_kernel<<<(unsigned)n_blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const Entry*)entries, (const long long*)grads, (const float*)hyper,
        (const Restore*)restores,
        (const long long*)blocks, n_entries, chunk, momentum, has_mom,
        rescale, clip, (const float*)probe, (int*)counters);
  }
  return (int)cudaGetLastError();
}
