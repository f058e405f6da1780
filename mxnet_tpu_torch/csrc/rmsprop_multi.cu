// Multi-tensor RMSProp update (plain and centred) with the non-finite
// guard folded in, float32.
//
// Replaces the per-parameter RMSProp step inside mxnet_tpu/executor.py
// fused_train_update: RMSProp.jax_apply (mxnet_tpu/optimizer.py:466-486)
// over _rmsprop_update / _rmspropalex_update
// (mxnet_tpu/ops/defs_optimizer.py:104-163) with _prep_grad's clip-then-wd
// order (:33-43), unrolled over every parameter and fused by XLA, and the
// MXNET_NONFINITE_GUARD select (executor.py:1381,1614-1652). See
// mxnet_tpu_torch/kernels/rmsprop_multi.py for the wrapper, the table it
// builds and the plain version. Per element of parameter e, in place, with
// the reference's order of operations (no FMA contraction):
//
//   g = grad * rescale;  g = clip(g, -clip, clip) if clip >= 0;  g += wd_e * w
//   n = (1 - gamma1) * (g * g) + gamma1 * n
//   plain:    w = w - (lr_e * g) / sqrt(n + eps)
//   centred:  gm = (1 - gamma1) * g + gamma1 * gm
//             delta = gamma2 * delta - (lr_e * g) / sqrt((n - gm * gm) + eps)
//             w = w + delta
//   w = clip(w, -clip_weights, clip_weights) if clip_weights > 0
//
// The guard is folded into the one launch: under it the launch is
// cooperative (every block resident), each block first adds the gradient
// elements of its chunks into one device float (the reference's probe: a
// non-finite element makes the sum non-finite), the grid synchronises
// (cooperative_groups grid.sync(), which builds without -rdc), and every
// block reads the sum. A finite step updates; a non-finite one writes no
// weight or state and copies each restore entry's source (the BatchNorm
// statistics as they were before the forward) back over its destination.
// Block 0 advances the [total, consecutive] skip counters. No value goes
// through the host and no second kernel runs.
//
// Bound: device-memory bandwidth, 20 bytes per parameter element (read w,
// g, n; write w, n), 36 centred (read w, g, n, gm, delta; write w, n, gm,
// delta): the GRU language model's 4.49 M values move 89.8 MB (0.0268 ms
// at 3.35 TB/s), centred 161.7 MB (0.0483 ms). Design: as adam_multi, one
// launch over all tensors from a device table of (w, n, gm, delta, numel)
// entries, a (lr, wd) row per entry and a block map of (entry, start) rows
// that cuts every tensor into chunks of `chunk` elements; a grid of the
// card's resident blocks walks the chunks. The wrapper keeps the tables on
// the device until a tensor moves, and uploads the gradients' pointers and
// the (lr, wd) rows when they change.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Entry {  // one update tensor (int64 x 5)
  long long w, n, gm, delta, numel;
};
struct Restore {  // one guarded restore (int64 x 3)
  long long dst, src, numel;
};

struct Args {
  const Entry* entries;
  const long long* grads;
  const float* hyper;  // (lr, wd) per entry
  const Restore* restores;
  const long long* blocks;  // (entry, start) per chunk: updates, then restores
  long long n_update, n_chunks, n_entries, chunk;
  float gamma1, one_g1, gamma2, eps, rescale, clip, clip_weights;
  float* probe;   // null without the guard
  int* counters;  // null without the guard
};

__device__ __forceinline__ float clip_nan(float v, float c) {
  // jnp.clip lets NaN through
  return v < -c ? -c : (v > c ? c : v);
}

template <bool kCentered>
__device__ __forceinline__ void update_chunk(const Args& a, long long e,
                                             long long start) {
  const Entry en = a.entries[e];
  const long long end = start + a.chunk < en.numel ? start + a.chunk
                                                   : en.numel;
  const float lr = a.hyper[2 * e], wd = a.hyper[2 * e + 1];
  float* w = reinterpret_cast<float*>(en.w);
  float* n = reinterpret_cast<float*>(en.n);
  float* gm = reinterpret_cast<float*>(en.gm);
  float* dl = reinterpret_cast<float*>(en.delta);
  const float* gr = reinterpret_cast<const float*>(a.grads[e]);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float wi = w[i];
    float g = __fmul_rn(gr[i], a.rescale);
    if (a.clip >= 0.f) g = clip_nan(g, a.clip);
    g = __fadd_rn(g, __fmul_rn(wd, wi));
    const float ni = __fadd_rn(__fmul_rn(a.one_g1, __fmul_rn(g, g)),
                               __fmul_rn(a.gamma1, n[i]));
    n[i] = ni;
    const float step = __fmul_rn(lr, g);
    float nw;
    if (kCentered) {
      const float gi = __fadd_rn(__fmul_rn(a.one_g1, g),
                                 __fmul_rn(a.gamma1, gm[i]));
      const float di = __fsub_rn(
          __fmul_rn(a.gamma2, dl[i]),
          __fdiv_rn(step, __fsqrt_rn(__fadd_rn(
                              __fsub_rn(ni, __fmul_rn(gi, gi)), a.eps))));
      gm[i] = gi;
      dl[i] = di;
      nw = __fadd_rn(wi, di);
    } else {
      nw = __fsub_rn(wi, __fdiv_rn(step, __fsqrt_rn(__fadd_rn(ni, a.eps))));
    }
    if (a.clip_weights > 0.f) nw = clip_nan(nw, a.clip_weights);
    w[i] = nw;
  }
}

__device__ __forceinline__ void restore_chunk(const Args& a, long long e,
                                              long long start) {
  const Restore r = a.restores[e - a.n_entries];
  const long long end = start + a.chunk < r.numel ? start + a.chunk : r.numel;
  float* dst = reinterpret_cast<float*>(r.dst);
  const float* src = reinterpret_cast<const float*>(r.src);
  for (long long i = start + threadIdx.x; i < end; i += kThreads)
    dst[i] = src[i];
}

// the gradient sum of the update chunks this block walks, into *probe
__device__ void probe_chunks(const Args& a) {
  __shared__ float scratch[kThreads / 32];
  float s = 0.f;
  for (long long c = blockIdx.x; c < a.n_update; c += gridDim.x) {
    const long long e = a.blocks[2 * c], start = a.blocks[2 * c + 1];
    const long long numel = a.entries[e].numel;
    const long long end = start + a.chunk < numel ? start + a.chunk : numel;
    const float* g = reinterpret_cast<const float*>(a.grads[e]);
    for (long long i = start + threadIdx.x; i < end; i += kThreads) s += g[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) t += scratch[k];
    atomicAdd(a.probe, t);
  }
}

template <bool kCentered, bool kGuard>
__global__ void __launch_bounds__(kThreads)
rmsprop_multi_kernel(const Args a) {
  bool finite = true;
  if (kGuard) {
    probe_chunks(a);
    cg::this_grid().sync();
    finite = isfinite(*(volatile float*)a.probe);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (finite) {
        a.counters[1] = 0;
      } else {
        a.counters[0] += 1;
        a.counters[1] += 1;
      }
    }
  }
  // a finite step walks the updates' chunks, a skipped one the restores'
  const long long lo = finite ? 0 : a.n_update;
  const long long hi = finite ? a.n_update : a.n_chunks;
  for (long long c = lo + blockIdx.x; c < hi; c += gridDim.x) {
    const long long e = a.blocks[2 * c], start = a.blocks[2 * c + 1];
    if (e >= a.n_entries)
      restore_chunk(a, e, start);
    else
      update_chunk<kCentered>(a, e, start);
  }
}

typedef void (*Kernel)(const Args);

Kernel kernel_of(bool centered, bool guard) {
  if (centered)
    return guard ? rmsprop_multi_kernel<true, true>
                 : rmsprop_multi_kernel<true, false>;
  return guard ? rmsprop_multi_kernel<false, true>
               : rmsprop_multi_kernel<false, false>;
}

// blocks of kThreads resident on the whole card at once, per device and
// kernel (the cooperative launch's limit, and the most any launch takes)
int resident_blocks(bool centered, bool guard, long long* out) {
  static long long cap[kMaxDevices][4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  long long& slot = cap[dev][(centered ? 2 : 0) + (guard ? 1 : 0)];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of(centered, guard), kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    slot = (long long)sms * per_sm;
  }
  *out = slot;
  return 0;
}

// the packed arguments of mxt_rmsprop_multi_f32
// (kernels/rmsprop_multi.py _PACK, "=5Q5q7d3Q")
struct Packed {
  unsigned long long entries, grads, hyper, restores, blocks;
  long long n_update, n_chunks, n_entries, chunk, centered;
  double gamma1, one_g1, gamma2, eps, rescale, clip, clip_weights;
  unsigned long long probe, counters, stream;
};
static_assert(sizeof(Packed) == 20 * 8, "Packed: 20 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch over every tensor; cooperative under the guard (probe and
// counters given), which zeroes the probe first.
extern "C" int mxt_rmsprop_multi_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const bool guard = in.probe != 0;
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  Args a;
  a.entries = ptr<const Entry>(in.entries);
  a.grads = ptr<const long long>(in.grads);
  a.hyper = ptr<const float>(in.hyper);
  a.restores = ptr<const Restore>(in.restores);
  a.blocks = ptr<const long long>(in.blocks);
  a.n_update = in.n_update;
  a.n_chunks = in.n_chunks;
  a.n_entries = in.n_entries;
  a.chunk = in.chunk;
  a.gamma1 = (float)in.gamma1;
  a.one_g1 = (float)in.one_g1;
  a.gamma2 = (float)in.gamma2;
  a.eps = (float)in.eps;
  a.rescale = (float)in.rescale;
  a.clip = (float)in.clip;
  a.clip_weights = (float)in.clip_weights;
  a.probe = ptr<float>(in.probe);
  a.counters = ptr<int>(in.counters);
  long long most = 0;
  int err = resident_blocks(in.centered != 0, guard, &most);
  if (err != 0) return err;
  // without the guard a skipped step cannot happen: the updates' chunks
  const long long work = guard ? in.n_chunks : in.n_update;
  const long long blocks = work < 1 ? 1 : (work < most ? work : most);
  Kernel kern = kernel_of(in.centered != 0, guard);
  if (!guard) {
    kern<<<(unsigned)blocks, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(a.probe, 0, sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)blocks),
                                  dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
