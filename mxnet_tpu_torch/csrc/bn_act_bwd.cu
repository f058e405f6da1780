// BatchNorm backward with the following (leaky) ReLU's mask fused, NCHW
// float32.
//
// Replaces the VJP of mxnet_tpu/ops/defs_nn.py _batch_norm (training
// branch, the anchor m0 under stop_gradient) composed with the
// Activation(relu) or LeakyReLU(act_type="leaky") after it; see
// mxnet_tpu_torch/kernels/bn_act_bwd.py for the wrapper, the plain version
// and the regime planner. With dy' = y > 0 ? dy : slope * dy (slope >= 0;
// the ReLU is slope 0, and then dy' is +0.0 where y <= 0) or dy (a
// negative or NaN slope: no activation), x^ = (x - mean) * invstd,
// invstd = 1 / sqrt(var + eps), g = gamma (1 under fix_gamma) and
// n = N*H*W, per channel:
//
//   dbeta  = sum(dy')        dgamma = sum(dy' * x^)   (0 under fix_gamma)
//   dx     = g * invstd * (dy' - km * dbeta / n - kvar * x^ * sum(dy' x^) / n)
//
// km = 1 and kvar from bn_stats.cu (1, 0.5 or 0: the clamp's derivative)
// for batch statistics; km = kvar = 0 for use_global_stats, where mean and
// var are the moving statistics and do not depend on x, and then
// dx = g * invstd * dy'. The mask reads the sign from the output y, whose
// sign is t's for slope >= 0; at t == 0 it gives slope * dy, the gradient
// of the reference's where(t > 0, ...). The leaky route (slope > 0) runs
// under kernel names of its own (bn_bwd_leaky_*), so that a profile tells
// it from the ReLU's; every kernel here is named bn_bwd_*.
//
// Bound: device-memory bandwidth, 16 bytes per element: dy, y and x read
// once (8 bytes without the activation), dx written once. The wrapper
// plans one of three regimes from the per-channel element count m:
//
// - block (m fits one block's shared memory at 8 bytes an element): one
//   launch. A group of threads per channel (several channels to a block
//   when m is at most a few thousand) reads the channel's dy, y and x
//   once, keeps d' and x^ in shared memory, reduces sum(d') and
//   sum(d' x^) in the block, and writes dx, dgamma and dbeta from what it
//   holds: 16 bytes an element.
// - cluster (m fits a cluster of k <= 16 such blocks): one launch of
//   k-block clusters, one per channel (cudaLaunchKernelEx with a cluster
//   dimension; 16 needs the non-portable size). Each block holds a
//   contiguous k-th of the channel; the cluster adds the k partial sums
//   through distributed shared memory in rank order, and each block writes
//   dx for its part: 16 bytes an element.
// - two-phase (larger channels): a per-channel reduction that ends in its
//   last block (atomic ticket), then the dx pass: two launches that read
//   the inputs twice, 28 bytes an element, with 16-byte accesses where the
//   planes allow them.
//
// The one-pass kernels walk a channel's elements in one flat order (image
// by image, each plane in turn), so a warp's lanes stay busy on planes of
// 16 or 49 elements; where h*w % 4 == 0 and every array is 16-byte
// aligned they read and write 16 bytes a thread. Without batch statistics
// nothing is kept on chip: dx needs no sums and is written in the same
// loop. Every sum runs in a fixed order (each thread's elements in turn, a
// shuffle tree, the warps in order, the cluster's blocks in rank order), so
// two calls on the same inputs give the same bits; no floating-point
// atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // two-phase blocks
constexpr int kThreads = kWarps * 32;
constexpr int kMaxThreads = 1024;  // one-pass blocks, at most
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float masked(float dy, float y, int act,
                                        float slope) {
  if (!act || y > 0.f) return dy;
  return slope == 0.f ? 0.f : __fmul_rn(slope, dy);
}

__device__ __forceinline__ float invstd_of(float var, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// --- one pass: the block and cluster regimes -------------------------------

struct OnePass {
  const float* dy;
  const float* y;  // null without the activation
  const float* x;
  const float* mean;
  const float* var;
  const float* gamma;
  const float* kvar;  // null: the moving statistics
  float* dx;
  float* dgamma;
  float* dbeta;
  long long channels;
  unsigned hw;     // H*W
  unsigned m;      // N*H*W, a channel's elements (< 2^31)
  unsigned chunk;  // a channel's elements per block (% 4 == 0)
  int group;       // threads per channel (whole warps)
  int cpb;         // channels per block (1 in a cluster)
  int k;           // blocks per channel: the cluster's size
  float eps, slope, count;
  int fix_gamma;
};

// W consecutive floats of one plane: a 16-byte access (W = 4) or one float
template <int W>
struct Pack {
  float v[W];
};

template <int W>
__device__ __forceinline__ Pack<W> load(const float* p, long long off) {
  Pack<W> r;
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + off);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = __ldg(p + off);
  }
  return r;
}

template <int W>
__device__ __forceinline__ Pack<W> load_shared(const float* p, unsigned off) {
  Pack<W> r;
  if constexpr (W == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[off];
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = p[off];
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store(float* p, long long off,
                                      const Pack<W>& r) {
  if constexpr (W == 4)
    reinterpret_cast<float4*>(p)[off] =
        make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  else
    p[off] = r.v[0];
}

// dy' under the activation ACT: 0 none, 1 the ReLU, 2 the leaky ReLU
template <int ACT>
__device__ __forceinline__ float mask(float dy, float y, float slope) {
  if (ACT == 0 || y > 0.f) return dy;
  return ACT == 1 ? 0.f : __fmul_rn(slope, dy);
}

// Adds s1 and s2 over the thread's group (whole warps of the block): every
// thread of the group gets the group's sums, its warps added in order.
// Every thread of the block must call it.
__device__ __forceinline__ void group_sum(float& s1, float& s2, int group,
                                          float (*red)[32]) {
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = s1;
    red[1][threadIdx.x >> 5] = s2;
  }
  __syncthreads();
  const int w0 = (int)(threadIdx.x / group) * (group >> 5);
  s1 = 0.f;
  s2 = 0.f;
  for (int w = w0; w < w0 + (group >> 5); ++w) {
    s1 += red[0][w];
    s2 += red[1][w];
  }
}

template <int ACT, int W, bool BATCH>
__device__ __forceinline__ void onepass(const OnePass& a) {
  extern __shared__ float4 held4[];
  __shared__ float red[2][32];
  __shared__ float part[2];
  constexpr int kU = W == 4 ? 2 : 4;  // loads in flight per thread
  const int grp = (int)threadIdx.x / a.group;
  const unsigned t = threadIdx.x - grp * a.group;
  const unsigned group = (unsigned)a.group;
  const int rank = (int)(blockIdx.x % (unsigned)a.k);
  const long long c = (long long)(blockIdx.x / (unsigned)a.k) * a.cpb + grp;
  const bool live = c < a.channels;
  // this block's part of the channel, in units of W floats
  const unsigned lo = (unsigned)rank * a.chunk / W;
  const unsigned hi = min(a.m, (unsigned)rank * a.chunk + a.chunk) / W;
  const unsigned hw_w = a.hw / W;
  float* held = reinterpret_cast<float*>(held4) + (size_t)grp * 2 * a.chunk;
  float* held_x = held + a.chunk;  // x^; held itself keeps d'
  const float mu = live ? a.mean[c] : 0.f;
  const float inv = live ? invstd_of(a.var[c], a.eps) : 0.f;
  const float scale = live ? (a.fix_gamma ? inv : a.gamma[c] * inv) : 0.f;
  // unit e of the channel -> its offset in the NCHW arrays, in units of W
  auto offset = [&](unsigned e) {
    const unsigned n = e / hw_w;
    return ((long long)n * a.channels + c) * hw_w + (e - n * hw_w);
  };
  float s1 = 0.f, s2 = 0.f;
  auto take = [&](unsigned e, long long off, const Pack<W>& dv,
                  const Pack<W>& yv, const Pack<W>& xv) {
    Pack<W> d, xh;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      d.v[j] = mask<ACT>(dv.v[j], yv.v[j], a.slope);
      xh.v[j] = __fmul_rn(__fsub_rn(xv.v[j], mu), inv);
      s1 += d.v[j];
      s2 = fmaf(d.v[j], xh.v[j], s2);
    }
    if constexpr (BATCH) {
      store<W>(held, e - lo, d);
      store<W>(held_x, e - lo, xh);
    } else {
      Pack<W> o;
#pragma unroll
      for (int j = 0; j < W; ++j) o.v[j] = scale * d.v[j];
      store<W>(a.dx, off, o);
    }
  };
  if (live) {
    unsigned e = lo + t;
    for (; e + (kU - 1) * group < hi; e += kU * group) {
      Pack<W> dv[kU], yv[kU], xv[kU];
      long long off[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        off[u] = offset(e + u * group);
        dv[u] = load<W>(a.dy, off[u]);
        if constexpr (ACT != 0) yv[u] = load<W>(a.y, off[u]);
        xv[u] = load<W>(a.x, off[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        take(e + u * group, off[u], dv[u], ACT != 0 ? yv[u] : dv[u], xv[u]);
    }
    for (; e < hi; e += group) {
      const long long off = offset(e);
      const Pack<W> dv = load<W>(a.dy, off);
      take(e, off, dv, ACT != 0 ? load<W>(a.y, off) : dv, load<W>(a.x, off));
    }
  }
  group_sum(s1, s2, a.group, red);
  if (a.k > 1) {
    // the cluster's partials, added in rank order by every block
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      part[0] = s1;
      part[1] = s2;
    }
    cluster.sync();
    if (threadIdx.x < 32) {
      float p1 = 0.f, p2 = 0.f;
      if ((int)threadIdx.x < a.k) {
        const float* rp = cluster.map_shared_rank(part, (int)threadIdx.x);
        p1 = rp[0];
        p2 = rp[1];
      }
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < a.k; ++r) {
        t1 += __shfl_sync(0xffffffffu, p1, r);
        t2 += __shfl_sync(0xffffffffu, p2, r);
      }
      if (threadIdx.x == 0) {
        red[0][0] = t1;
        red[1][0] = t2;
      }
    }
    // no block leaves (its partials read) before all have read them; the
    // block's threads see red[.][0]
    cluster.sync();
    s1 = red[0][0];
    s2 = red[1][0];
  }
  if (!live) return;
  if (rank == 0 && t == 0) {
    a.dbeta[c] = s1;
    a.dgamma[c] = a.fix_gamma ? 0.f : s2;
  }
  if constexpr (BATCH) {
    const float am = s1 / a.count;
    const float bm = a.kvar[c] * s2 / a.count;
    for (unsigned e = lo + t; e < hi; e += group) {
      const Pack<W> d = load_shared<W>(held, e - lo);
      const Pack<W> xh = load_shared<W>(held_x, e - lo);
      Pack<W> o;
#pragma unroll
      for (int j = 0; j < W; ++j) o.v[j] = scale * (d.v[j] - am - xh.v[j] * bm);
      store<W>(a.dx, offset(e), o);
    }
  }
}

// no activation (ACT 0) or the ReLU (ACT 1); W = 4: 16-byte accesses
template <int ACT, int W, bool BATCH>
__global__ void __launch_bounds__(kMaxThreads)
bn_bwd_onepass_kernel(const OnePass a) {
  onepass<ACT, W, BATCH>(a);
}

// the leaky ReLU, slope > 0
template <int W, bool BATCH>
__global__ void __launch_bounds__(kMaxThreads)
bn_bwd_leaky_onepass_kernel(const OnePass a) {
  onepass<2, W, BATCH>(a);
}

using OnePassKernel = void (*)(const OnePass);

template <int ACT>
OnePassKernel pick(int vec, int batch) {
  if constexpr (ACT == 2)
    return vec ? (batch ? bn_bwd_leaky_onepass_kernel<4, true>
                        : bn_bwd_leaky_onepass_kernel<4, false>)
               : (batch ? bn_bwd_leaky_onepass_kernel<1, true>
                        : bn_bwd_leaky_onepass_kernel<1, false>);
  else
    return vec ? (batch ? bn_bwd_onepass_kernel<ACT, 4, true>
                        : bn_bwd_onepass_kernel<ACT, 4, false>)
               : (batch ? bn_bwd_onepass_kernel<ACT, 1, true>
                        : bn_bwd_onepass_kernel<ACT, 1, false>);
}

OnePassKernel kernel_of(int act, int vec, int batch) {
  return act == 2 ? pick<2>(vec, batch)
                  : act == 1 ? pick<1>(vec, batch) : pick<0>(vec, batch);
}

struct Caps {
  int smem;     // dynamic shared memory one block may take, bytes
  int cluster;  // the largest cluster of such blocks that can run
};

// Per device, once: every one-pass kernel configured for the card's opt-in
// shared memory (less the kernels' static shared memory) and for
// non-portable cluster sizes; the largest cluster of full blocks that
// cudaOccupancyMaxActiveClusters finds room for.
int caps(Caps** out) {
  static Caps lim[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    int fixed = 0;
    for (int i = 0; i < 12; ++i) {
      cudaFuncAttributes fa;
      err = cudaFuncGetAttributes(&fa, kernel_of(i / 4, (i / 2) % 2, i % 2));
      if (err != cudaSuccess) return (int)err;
      if ((int)fa.sharedSizeBytes > fixed) fixed = (int)fa.sharedSizeBytes;
    }
    const int smem = optin - fixed;
    bool nonportable = true;
    for (int i = 0; i < 12; ++i) {
      const OnePassKernel k = kernel_of(i / 4, (i / 2) % 2, i % 2);
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      if (cudaFuncSetAttribute(
              k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess)
        nonportable = false;
    }
    cudaGetLastError();  // a refused non-portable size is not an error
    int cluster = 1;
    for (int kk = nonportable ? kMaxCluster : 8; kk > 1; kk /= 2) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = kk;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(kk);
      cfg.blockDim = dim3(kMaxThreads);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel_of(1, 1, 1), &cfg) ==
              cudaSuccess &&
          n >= 1) {
        cluster = kk;
        break;
      }
      cudaGetLastError();
    }
    lim[dev].smem = smem;
    lim[dev].cluster = cluster;
    ready[dev] = true;
  }
  *out = &lim[dev];
  return 0;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// --- two phases: channels past a cluster -----------------------------------

__device__ __forceinline__ float block_sum(float a, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = a;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

// The reduction walks planes as bn_stats.cu does: block (c, s) gives its
// warps whole (n, c) planes, and the last block of a channel (atomic
// ticket) adds the partials in a fixed order. W = 4: 16-byte accesses
// (h*w % 4 == 0 and every array 16-byte aligned).
template <int W>
__device__ __forceinline__ void bwd_reduce(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ sums,
    float* __restrict__ dgamma, float* __restrict__ dbeta, float* partial,
    unsigned int* ticket, int n_batch, int channels, long long hw, int splits,
    float eps, int fix_gamma, int act, float slope) {
  __shared__ float scratch[kWarps];
  __shared__ bool last;
  const int c = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float m = mean[c];
  const float inv = invstd_of(var[c], eps);

  float sd = 0.f, sdx = 0.f;
  for (int n = s * kWarps + warp; n < n_batch; n += splits * kWarps) {
    const long long base = ((long long)n * channels + c) * hw;
    const float* dp = dy + base;
    const float* xp = x + base;
    const float* yp = act ? y + base : dp;  // y only read under act
    for (long long i = lane; i < hw / W; i += 32) {
      const Pack<W> dv = load<W>(dp, i);
      const Pack<W> yv = act ? load<W>(yp, i) : dv, xv = load<W>(xp, i);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float d = masked(dv.v[j], yv.v[j], act, slope);
        sd += d;
        sdx = fmaf(d, __fmul_rn(__fsub_rn(xv.v[j], m), inv), sdx);
      }
    }
  }
  sd = block_sum(sd, scratch);
  sdx = block_sum(sdx, scratch);
  if (threadIdx.x == 0) {
    partial[2 * ((long long)c * splits + s)] = sd;
    partial[2 * ((long long)c * splits + s) + 1] = sdx;
    __threadfence();
    last = atomicAdd(&ticket[c], 1u) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  float t1 = 0.f, t2 = 0.f;
  for (int j = 0; j < splits; ++j) {
    t1 += __ldcg(&partial[2 * ((long long)c * splits + j)]);
    t2 += __ldcg(&partial[2 * ((long long)c * splits + j) + 1]);
  }
  sums[2 * c] = t1;
  sums[2 * c + 1] = t2;
  dbeta[c] = t1;
  dgamma[c] = fix_gamma ? 0.f : t2;
  ticket[c] = 0u;
}

// The dx pass gives one warp to each plane, as bn_act.cu does.
template <int W>
__device__ __forceinline__ void bwd_dx(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ gamma,
    const float* __restrict__ kvar, const float* __restrict__ sums,
    float* __restrict__ dx, long long planes, int channels, long long hw,
    float count, float eps, int fix_gamma, int act, float slope,
    int batch_stats) {
  const int lane = threadIdx.x & 31;
  const long long plane = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (plane >= planes) return;
  const int c = (int)(plane % channels);
  const float m = mean[c];
  const float inv = invstd_of(var[c], eps);
  const float scale = fix_gamma ? inv : gamma[c] * inv;
  const float a = batch_stats ? sums[2 * c] / count : 0.f;
  const float b = batch_stats ? kvar[c] * sums[2 * c + 1] / count : 0.f;
  const long long base = plane * hw;
  const float* dp = dy + base;
  const float* xp = x + base;
  const float* yp = act ? y + base : dp;
  float* op = dx + base;
  for (long long i = lane; i < hw / W; i += 32) {
    const Pack<W> dv = load<W>(dp, i);
    const Pack<W> yv = act ? load<W>(yp, i) : dv, xv = load<W>(xp, i);
    Pack<W> o;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float d = masked(dv.v[j], yv.v[j], act, slope);
      const float xh = __fmul_rn(__fsub_rn(xv.v[j], m), inv);
      o.v[j] = batch_stats ? scale * (d - a - xh * b) : scale * d;
    }
    store<W>(op, i, o);
  }
}

// no activation (act 0) or the ReLU (act 1)
template <int W>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                     const float* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ var, float* __restrict__ sums,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     float* partial, unsigned int* ticket, int n_batch,
                     int channels, long long hw, int splits, float eps,
                     int fix_gamma, int act) {
  bwd_reduce<W>(dy, y, x, mean, var, sums, dgamma, dbeta, partial, ticket,
                n_batch, channels, hw, splits, eps, fix_gamma, act, 0.f);
}

// the leaky ReLU, slope > 0
template <int W>
__global__ void __launch_bounds__(kThreads)
bn_bwd_leaky_reduce_kernel(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ sums,
    float* __restrict__ dgamma, float* __restrict__ dbeta, float* partial,
    unsigned int* ticket, int n_batch, int channels, long long hw, int splits,
    float eps, int fix_gamma, float slope) {
  bwd_reduce<W>(dy, y, x, mean, var, sums, dgamma, dbeta, partial, ticket,
                n_batch, channels, hw, splits, eps, fix_gamma, 1, slope);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                 const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ var,
                 const float* __restrict__ gamma,
                 const float* __restrict__ kvar,
                 const float* __restrict__ sums, float* __restrict__ dx,
                 long long planes, int channels, long long hw, float count,
                 float eps, int fix_gamma, int act, int batch_stats) {
  bwd_dx<W>(dy, y, x, mean, var, gamma, kvar, sums, dx, planes, channels, hw,
            count, eps, fix_gamma, act, 0.f, batch_stats);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
bn_bwd_leaky_dx_kernel(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ gamma,
    const float* __restrict__ kvar, const float* __restrict__ sums,
    float* __restrict__ dx, long long planes, int channels, long long hw,
    float count, float eps, int fix_gamma, float slope, int batch_stats) {
  bwd_dx<W>(dy, y, x, mean, var, gamma, kvar, sums, dx, planes, channels, hw,
            count, eps, fix_gamma, 1, slope, batch_stats);
}

// 16-byte accesses for the two-phase kernels: planes a multiple of 4 long
// and every array they touch 16-byte aligned
bool vec_planes(long long hw, const void* dy, const void* y, const void* x,
                const void* dx, bool act) {
  return hw % 4 == 0 && aligned(dy) && aligned(x) &&
         (dx == nullptr || aligned(dx)) && (!act || aligned(y));
}

}  // namespace

// out[0]: the dynamic shared memory one one-pass block may take (bytes);
// out[1]: the largest cluster of such blocks the card runs. The wrapper's
// planner reads both once per device.
extern "C" int mxt_bn_bwd_caps(int* out, void* stream) {
  (void)stream;
  Caps* lim = nullptr;
  const int err = caps(&lim);
  if (err != 0) return err;
  out[0] = lim->smem;
  out[1] = lim->cluster;
  return 0;
}

// The block (k == 1) and cluster (k > 1) regimes, one launch, as planned
// by the wrapper: grid blocks of cpb * group threads, k blocks per channel,
// chunk elements of a channel per block (all of it with k == 1). kvar null
// means the moving statistics. The arguments come packed in one struct of
// 8-byte fields (the wrapper packs them with struct.pack: one ctypes
// argument costs less host time than twenty-two). Returns
// cudaErrorInvalidValue for a plan that does not fit this call or the card.
namespace {

struct OnePassArgs {
  unsigned long long dy, y, x, mean, var, gamma, kvar, dx, dgamma, dbeta;
  long long n, c, hw;
  double eps;
  long long fix_gamma;
  double slope;
  long long grid, k, cpb, group, chunk;
  unsigned long long stream;
};

// the wrapper's struct format "=10Q3qdqd5qQ"
static_assert(sizeof(OnePassArgs) == 22 * 8,
              "OnePassArgs: 22 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

extern "C" int mxt_bn_bwd_onepass_f32(const void* packed) {
  const OnePassArgs& in = *static_cast<const OnePassArgs*>(packed);
  const long long n = in.n, c = in.c, hw = in.hw, grid = in.grid,
                  chunk = in.chunk;
  const long long k = in.k, cpb = in.cpb, group = in.group;
  if (n <= 0 || c <= 0 || hw <= 0) return (int)cudaGetLastError();
  Caps* lim = nullptr;
  const int err = caps(&lim);
  if (err != 0) return err;
  const long long m = n * hw;
  const int batch = in.kvar != 0;
  const long long smem = batch ? cpb * chunk * 8 : 0;
  if (m >= (1LL << 31) || k < 1 || k > lim->cluster ||
      (k > 1 && cpb != 1) || cpb < 1 || group < 32 || group % 32 != 0 ||
      cpb * group > kMaxThreads || chunk < 4 || chunk % 4 != 0 ||
      chunk * k < m || smem > lim->smem ||
      grid != (c + cpb - 1) / cpb * k || grid >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float slope = (float)in.slope;
  const int act = slope > 0.f ? 2 : slope == 0.f ? 1 : 0;
  const int vec = hw % 4 == 0 && aligned(ptr<void>(in.dy)) &&
                  aligned(ptr<void>(in.x)) && aligned(ptr<void>(in.dx)) &&
                  (act == 0 || aligned(ptr<void>(in.y)));
  OnePass a;
  a.dy = ptr<const float>(in.dy);
  a.y = act ? ptr<const float>(in.y) : nullptr;
  a.x = ptr<const float>(in.x);
  a.mean = ptr<const float>(in.mean);
  a.var = ptr<const float>(in.var);
  a.gamma = ptr<const float>(in.gamma);
  a.kvar = ptr<const float>(in.kvar);
  a.dx = ptr<float>(in.dx);
  a.dgamma = ptr<float>(in.dgamma);
  a.dbeta = ptr<float>(in.dbeta);
  a.channels = c;
  a.hw = (unsigned)hw;
  a.m = (unsigned)m;
  a.chunk = (unsigned)chunk;
  a.group = (int)group;
  a.cpb = (int)cpb;
  a.k = (int)k;
  a.eps = (float)in.eps;
  a.slope = slope;
  a.count = (float)m;
  a.fix_gamma = (int)in.fix_gamma;
  const OnePassKernel kern = kernel_of(act, vec, batch);
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  if (k == 1) {
    kern<<<(unsigned)grid, (unsigned)(cpb * group), (size_t)smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)group);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int mxt_bn_bwd_reduce_f32(const void* dy, const void* y,
                                     const void* x, const void* mean,
                                     const void* var, void* sums,
                                     void* dgamma, void* dbeta, void* partial,
                                     void* ticket, long long n, long long c,
                                     long long hw, int splits, float eps,
                                     int fix_gamma, float slope,
                                     void* stream) {
  if (n > 0 && c > 0 && hw > 0) {
    const unsigned blocks = (unsigned)(c * splits);
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = vec_planes(hw, dy, y, x, nullptr, slope >= 0.f);
#define MXT_REDUCE(KERNEL, W, ACT)                                          \
  KERNEL<W><<<blocks, kThreads, 0, st>>>(                                   \
      (const float*)dy, (const float*)y, (const float*)x,                   \
      (const float*)mean, (const float*)var, (float*)sums, (float*)dgamma,  \
      (float*)dbeta, (float*)partial, (unsigned int*)ticket, (int)n, (int)c, \
      hw, splits, eps, fix_gamma, ACT)
    if (slope > 0.f) {
      if (vec) MXT_REDUCE(bn_bwd_leaky_reduce_kernel, 4, slope);
      else MXT_REDUCE(bn_bwd_leaky_reduce_kernel, 1, slope);
    } else {
      const int act = slope == 0.f ? 1 : 0;
      if (vec) MXT_REDUCE(bn_bwd_reduce_kernel, 4, act);
      else MXT_REDUCE(bn_bwd_reduce_kernel, 1, act);
    }
#undef MXT_REDUCE
  }
  return (int)cudaGetLastError();
}

extern "C" int mxt_bn_bwd_dx_f32(const void* dy, const void* y, const void* x,
                                 const void* mean, const void* var,
                                 const void* gamma, const void* kvar,
                                 const void* sums, void* dx, long long n,
                                 long long c, long long hw, float eps,
                                 int fix_gamma, float slope,
                                 int batch_stats, void* stream) {
  const long long planes = n * c;
  if (planes > 0 && hw > 0) {
    const unsigned blocks = (unsigned)((planes + kWarps - 1) / kWarps);
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = vec_planes(hw, dy, y, x, dx, slope >= 0.f);
#define MXT_DX(KERNEL, W, ACT)                                              \
  KERNEL<W><<<blocks, kThreads, 0, st>>>(                                   \
      (const float*)dy, (const float*)y, (const float*)x,                   \
      (const float*)mean, (const float*)var, (const float*)gamma,           \
      (const float*)kvar, (const float*)sums, (float*)dx, planes, (int)c,   \
      hw, (float)(n * hw), eps, fix_gamma, ACT, batch_stats)
    if (slope > 0.f) {
      if (vec) MXT_DX(bn_bwd_leaky_dx_kernel, 4, slope);
      else MXT_DX(bn_bwd_leaky_dx_kernel, 1, slope);
    } else {
      const int act = slope == 0.f ? 1 : 0;
      if (vec) MXT_DX(bn_bwd_dx_kernel, 4, act);
      else MXT_DX(bn_bwd_dx_kernel, 1, act);
    }
#undef MXT_DX
  }
  return (int)cudaGetLastError();
}
