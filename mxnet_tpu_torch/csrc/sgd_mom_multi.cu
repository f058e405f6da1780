// Multi-tensor SGD(-momentum) update with the non-finite guard, float32.
//
// Replaces the per-parameter update inside mxnet_tpu/executor.py
// fused_train_update (the optimizer's jax_apply over _prep_grad and
// _sgd_mom_update, mxnet_tpu/ops/defs_optimizer.py:34-72, unrolled over
// every parameter and fused by XLA) and its MXNET_NONFINITE_GUARD select
// (executor.py:1606,1614-1652); see mxnet_tpu_torch/kernels/sgd_mom_multi.py
// for the wrapper, the launch parameters it packs and the plain version.
// Per element of parameter e, in place, with the reference's order of
// operations (no FMA contraction: __fmul_rn/__fadd_rn):
//
//   g = grad * rescale;  g = clip(g, -clip, clip) if clip >= 0;  g += wd_e * w
//   mom = momentum * mom - lr_e * g;  w = w + mom        (with momentum)
//   w = w - lr_e * g                                      (without)
//
// Under the guard a probe launch first adds every gradient element into one
// device float; the update launch reads it and, when it is not finite,
// writes no weight or momentum and copies each restore entry's source (the
// BatchNorm statistics as they were before the forward) back over its
// destination. The first update launch of a call advances the
// [total, consecutive] skip counters on the device: no host
// synchronisation per step.
//
// Bound: device-memory bandwidth, 20 bytes per parameter element (read w,
// g, mom; write w, mom): 511 MB and 0.153 ms for ResNet-50's 25.55 M
// values. Design: all per-step metadata travels in the launch's parameters
// (CUDA 12.1+ takes up to 32764 bytes): a Pack of up to kCap entries,
// each the pointers of a weight, its gradient and its momentum (or a
// restore's destination and source), its size and its (lr, wd), and the
// cumulative chunk count in front of each entry. The wrapper keeps the
// packs in host memory and rewrites only the gradient pointers per step;
// nothing is copied to the device. A list longer than kCap entries takes
// several launches. A grid of a few blocks per SM walks the chunks of
// kChunk elements; a block finds a chunk's entry by binary search over the
// cumulative counts (uniform across the block, so the parameter bank
// broadcasts it). A chunk moves 16 bytes a thread per access where its
// weight, gradient and momentum are 16-byte aligned (a whole chunk: four
// float4 of each a thread, loaded before any is stored), with a scalar
// tail; a view whose offset breaks the alignment takes the scalar path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements; a multiple of 4 * kThreads
constexpr int kUnroll = kChunk / (4 * kThreads);
constexpr int kBlocksPerSM = 4;
constexpr int kMaxDevices = 64;

constexpr int kCap = 320;  // entries per launch (CAP in the wrapper)

// The launch parameters; kernels/sgd_mom_multi.py builds the same layout
// (pack_layout). Entries [0, n_update) are updates, [n_update, n_entries)
// restores (p0 destination, p1 source).
struct Pack {
  long long p0[kCap];     // weight | restore destination
  long long p1[kCap];     // gradient | restore source
  long long p2[kCap];     // momentum (0 without)
  long long numel[kCap];
  float lr[kCap];
  float wd[kCap];
  int first[kCap + 1];    // chunks before each entry; first[n_entries] total
  int n_update;
  int n_entries;
};
static_assert(sizeof(Pack) <= 32764 - 64, "launch parameter limit");

__device__ __forceinline__ float clip_nan(float g, float clip) {
  // jnp.clip lets NaN through
  return g < -clip ? -clip : (g > clip ? clip : g);
}

// the entry that holds chunk c: the last e with first[e] <= c
__device__ __forceinline__ int entry_of(const Pack& pk, int c) {
  int lo = 0, hi = pk.n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pk.first[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

struct Hyper {
  float lr, wd, momentum, rescale, clip;
};

template <bool kMom>
__device__ __forceinline__ void step(float& w, float g, float& m,
                                     const Hyper& h) {
  g = __fmul_rn(g, h.rescale);
  if (h.clip >= 0.f) g = clip_nan(g, h.clip);
  g = __fadd_rn(g, __fmul_rn(h.wd, w));
  if (kMom) {
    m = __fsub_rn(__fmul_rn(h.momentum, m), __fmul_rn(h.lr, g));
    w = __fadd_rn(w, m);
  } else {
    w = __fsub_rn(w, __fmul_rn(h.lr, g));
  }
}

template <bool kMom>
__device__ __forceinline__ void step4(float4& w, const float4& g, float4& m,
                                      const Hyper& h) {
  step<kMom>(w.x, g.x, m.x, h);
  step<kMom>(w.y, g.y, m.y, h);
  step<kMom>(w.z, g.z, m.z, h);
  step<kMom>(w.w, g.w, m.w, h);
}

// one chunk of n elements at w, g, m (m null without momentum)
template <bool kMom>
__device__ __forceinline__ void update_chunk(float* __restrict__ w,
                                             const float* __restrict__ g,
                                             float* __restrict__ m, int n,
                                             const Hyper& h) {
  const int t = threadIdx.x;
  if (aligned16(w, g, m)) {
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    if (n == kChunk) {
      float4 a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = k * kThreads + t;
        a[k] = w4[i];
        b[k] = g4[i];
        if (kMom) c[k] = m4[i];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = k * kThreads + t;
        step4<kMom>(a[k], b[k], c[k], h);
        w4[i] = a[k];
        if (kMom) m4[i] = c[k];
      }
      return;
    }
    const int n4 = n >> 2;
    for (int i = t; i < n4; i += kThreads) {
      float4 a = w4[i], c = kMom ? m4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      step4<kMom>(a, g4[i], c, h);
      w4[i] = a;
      if (kMom) m4[i] = c;
    }
    for (int i = (n4 << 2) + t; i < n; i += kThreads) {
      float a = w[i], c = kMom ? m[i] : 0.f;
      step<kMom>(a, g[i], c, h);
      w[i] = a;
      if (kMom) m[i] = c;
    }
    return;
  }
  for (int i = t; i < n; i += kThreads) {
    float a = w[i], c = kMom ? m[i] : 0.f;
    step<kMom>(a, g[i], c, h);
    w[i] = a;
    if (kMom) m[i] = c;
  }
}

__device__ __forceinline__ void copy_chunk(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int n) {
  const int t = threadIdx.x;
  if (aligned16(dst, src, dst)) {
    const int n4 = n >> 2;
    for (int i = t; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    for (int i = (n4 << 2) + t; i < n; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = t; i < n; i += kThreads) dst[i] = src[i];
  }
}

// the elements of chunk c of entry e: [start, start + n)
__device__ __forceinline__ int chunk_span(const Pack& pk, int e, int c,
                                          long long* start) {
  *start = (long long)(c - pk.first[e]) * kChunk;
  const long long left = pk.numel[e] - *start;
  return left < kChunk ? (int)left : kChunk;
}

__global__ void __launch_bounds__(kThreads)
sgd_probe_kernel(const __grid_constant__ Pack pk, float* probe) {
  __shared__ float scratch[kThreads / 32];
  float s = 0.f;
  const int chunks = pk.first[pk.n_update];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int e = entry_of(pk, c);
    long long start;
    const int n = chunk_span(pk, e, c, &start);
    const float* g = reinterpret_cast<const float*>(pk.p1[e]) + start;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const int n4 = n >> 2;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 v = reinterpret_cast<const float4*>(g)[i];
        s += (v.x + v.y) + (v.z + v.w);
      }
      for (int i = (n4 << 2) + threadIdx.x; i < n; i += kThreads) s += g[i];
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) s += g[i];
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += scratch[w];
    atomicAdd(probe, t);
  }
}

template <bool kMom>
__global__ void __launch_bounds__(kThreads)
sgd_mom_multi_kernel(const __grid_constant__ Pack pk, float momentum,
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
  // a finite step walks the updates' chunks, a skipped one the restores'
  const int split = pk.first[pk.n_update];
  const int lo = finite ? 0 : split;
  const int hi = finite ? split : pk.first[pk.n_entries];
  for (int c = lo + blockIdx.x; c < hi; c += gridDim.x) {
    const int e = entry_of(pk, c);
    long long start;
    const int n = chunk_span(pk, e, c, &start);
    if (e >= pk.n_update) {  // restore the pre-forward values
      copy_chunk(reinterpret_cast<float*>(pk.p0[e]) + start,
                 reinterpret_cast<const float*>(pk.p1[e]) + start, n);
      continue;
    }
    const Hyper h{pk.lr[e], pk.wd[e], momentum, rescale, clip};
    float* m = kMom ? reinterpret_cast<float*>(pk.p2[e]) + start : nullptr;
    update_chunk<kMom>(reinterpret_cast<float*>(pk.p0[e]) + start,
                       reinterpret_cast<const float*>(pk.p1[e]) + start, m, n,
                       h);
  }
}

int grid_for(int chunks, unsigned* grid) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int most = sms[dev] * kBlocksPerSM;
  *grid = (unsigned)(chunks < 1 ? 1 : (chunks < most ? chunks : most));
  return 0;
}

}  // namespace

// Bytes of the Pack: the wrapper checks its own layout against it.
extern "C" int mxt_sgd_pack_bytes() { return (int)sizeof(Pack); }

// Add every gradient of the pack's update entries into *probe; `zero`
// clears it first (the first probe launch of a call).
extern "C" int mxt_sgd_probe_f32(const void* pack, void* probe, int zero,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (zero) {
    cudaError_t err = cudaMemsetAsync(probe, 0, sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  const Pack& pk = *static_cast<const Pack*>(pack);
  unsigned grid = 1;
  int err = grid_for(pk.first[pk.n_update], &grid);
  if (err != 0) return err;
  sgd_probe_kernel<<<grid, kThreads, 0, s>>>(pk, (float*)probe);
  return (int)cudaGetLastError();
}

// probe is null without the guard; counters null without the guard and on
// every launch of a call but the first.
extern "C" int mxt_sgd_mom_multi_f32(const void* pack, float momentum,
                                     int has_mom, float rescale, float clip,
                                     const void* probe, void* counters,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Pack& pk = *static_cast<const Pack*>(pack);
  // a skipped step walks the restores' chunks only
  const int chunks = probe != nullptr ? pk.first[pk.n_entries]
                                      : pk.first[pk.n_update];
  unsigned grid = 1;
  int err = grid_for(chunks, &grid);
  if (err != 0) return err;
  if (has_mom)
    sgd_mom_multi_kernel<true><<<grid, kThreads, 0, s>>>(
        pk, momentum, rescale, clip, (const float*)probe, (int*)counters);
  else
    sgd_mom_multi_kernel<false><<<grid, kThreads, 0, s>>>(
        pk, momentum, rescale, clip, (const float*)probe, (int*)counters);
  return (int)cudaGetLastError();
}
