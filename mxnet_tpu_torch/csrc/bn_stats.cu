// Anchored one-pass BatchNorm training statistics, NCHW float32.
//
// Replaces the batch-statistics branch of mxnet_tpu/ops/defs_nn.py
// _batch_norm (the training forward); see mxnet_tpu_torch/kernels/bn_stats.py
// for the wrapper, the planner and the plain version. Per channel c, over
// the m = N*H*W elements of the channel, with the anchor m0 = moving_mean[c]:
//
//   dmean = sum(x - m0) / m        mean = m0 + dmean
//   raw   = sum((x - m0)^2) / m - dmean^2      var = max(raw, 0)
//   moving_mean = moving_mean * momentum + mean * (1 - momentum)
//   moving_var  = moving_var  * momentum + var  * (1 - momentum)
//
// written in place, plus kvar = 1 (raw > 0), 0.5 (raw == 0) or 0 (raw < 0):
// the derivative of the clamp max(raw, 0) as jax.vjp takes it, which the
// backward (bn_act_bwd.cu) multiplies into the variance term.
//
// Bound: device-memory bandwidth, 4 bytes read per element. One launch per
// call, planned by the wrapper from m and C as bn_act_bwd's one-pass
// regimes are (its planner, kernels/bn_act_bwd.py plan): a group of threads
// per channel, several channels to a block when m is small (block), or a
// cluster of k <= 16 blocks per channel, each taking a contiguous k-th of
// the channel (cluster; cudaLaunchKernelEx with a cluster dimension, 16
// the non-portable size). The statistics keep nothing on chip but two sums,
// so no shared memory bounds a block.
//
// A group walks its part of the channel in one flat order (image by
// image, each plane in turn), so a warp's lanes stay busy on planes of 49
// or 16 elements; where h*w % 4 == 0 and x is 16-byte aligned every thread
// reads 16 bytes an access, four accesses in flight, else 4 bytes, eight in
// flight. Each sum runs in one fixed order (each thread's elements in
// turn, a shuffle tree, the warps in order, the cluster's blocks in rank
// order through distributed shared memory), so two calls on the same
// inputs give the same bits: no ticket, no partial buffer, no atomics.
// Rank 0 writes the statistics; every block reads the anchor before the
// cluster's first barrier, so the in-place moving-mean write cannot race a
// read.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

struct Stats {
  const float* x;
  float* moving_mean;
  float* moving_var;
  float* out;  // (3, C): mean, var, kvar
  long long channels;
  unsigned hw;     // H*W
  unsigned m;      // N*H*W, a channel's elements (< 2^31)
  unsigned chunk;  // a channel's elements per block (% 4 == 0)
  int group;       // threads per channel (whole warps)
  int cpb;         // channels per block (1 in a cluster)
  int k;           // blocks per channel: the cluster's size
  float count, momentum, one_minus_momentum;
};

__device__ __forceinline__ void acc(float v, float m0, float& s1, float& s2) {
  const float d = __fsub_rn(v, m0);
  s1 = __fadd_rn(s1, d);
  s2 = __fmaf_rn(d, d, s2);
}

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

// Adds s1 and s2 over the thread's group (whole warps of the block): every
// thread of the group gets the group's sums, its warps added in order.
// Every thread of the block must call it.
__device__ __forceinline__ void group_sum(float& s1, float& s2, int group,
                                          float (*red)[32]) {
  for (int off = 16; off > 0; off >>= 1) {
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, off));
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
    s1 = __fadd_rn(s1, red[0][w]);
    s2 = __fadd_rn(s2, red[1][w]);
  }
}

template <int W>
__global__ void __launch_bounds__(kMaxThreads)
bn_stats_kernel(const Stats a) {
  __shared__ float red[2][32];
  __shared__ float part[2];
  constexpr int kU = W == 4 ? 4 : 8;  // loads in flight per thread
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
  const float m0 = live ? a.moving_mean[c] : 0.f;
  // unit e of the channel -> its offset in x, in units of W
  auto offset = [&](unsigned e) {
    const unsigned n = e / hw_w;
    return ((long long)n * a.channels + c) * hw_w + (e - n * hw_w);
  };
  float s1 = 0.f, s2 = 0.f;
  if (live) {
    unsigned e = lo + t;
    for (; e + (kU - 1) * group < hi; e += kU * group) {
      Pack<W> v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = load<W>(a.x, offset(e + u * group));
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < W; ++j) acc(v[u].v[j], m0, s1, s2);
    }
    for (; e < hi; e += group) {
      const Pack<W> v = load<W>(a.x, offset(e));
#pragma unroll
      for (int j = 0; j < W; ++j) acc(v.v[j], m0, s1, s2);
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
        t1 = __fadd_rn(t1, __shfl_sync(0xffffffffu, p1, r));
        t2 = __fadd_rn(t2, __shfl_sync(0xffffffffu, p2, r));
      }
      s1 = t1;
      s2 = t2;
    }
    // no block leaves (its partials read) before all have read them
    cluster.sync();
  }
  if (!live || rank != 0 || t != 0) return;
  const float dmean = __fdiv_rn(s1, a.count);
  const float mean = __fadd_rn(m0, dmean);
  const float raw = __fsub_rn(__fdiv_rn(s2, a.count), __fmul_rn(dmean, dmean));
  // max(raw, 0) that lets NaN through, as jnp.maximum does
  const float var = (raw < 0.f) ? 0.f : raw;
  a.out[c] = mean;
  a.out[a.channels + c] = var;
  a.out[2 * a.channels + c] = raw > 0.f ? 1.f : (raw == 0.f ? 0.5f : 0.f);
  a.moving_mean[c] = __fadd_rn(__fmul_rn(m0, a.momentum),
                               __fmul_rn(mean, a.one_minus_momentum));
  a.moving_var[c] = __fadd_rn(__fmul_rn(a.moving_var[c], a.momentum),
                              __fmul_rn(var, a.one_minus_momentum));
}

using Kernel = void (*)(const Stats);

Kernel kernel_of(int vec) {
  return vec ? bn_stats_kernel<4> : bn_stats_kernel<1>;
}

// Per device, once: both kernels configured for non-portable cluster sizes,
// and the largest cluster of 1024-thread blocks that
// cudaOccupancyMaxActiveClusters finds room for.
int caps(int* out) {
  static int lim[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    bool nonportable = true;
    for (int v = 0; v < 2; ++v)
      if (cudaFuncSetAttribute(kernel_of(v),
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1) != cudaSuccess)
        nonportable = false;
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
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel_of(1), &cfg) ==
              cudaSuccess &&
          n >= 1) {
        cluster = kk;
        break;
      }
      cudaGetLastError();
    }
    lim[dev] = cluster;
    ready[dev] = true;
  }
  *out = lim[dev];
  return 0;
}

// the packed arguments of mxt_bn_stats_f32 (kernels/bn_stats.py _PACK,
// "=4Q3q2d5qQ")
struct Packed {
  unsigned long long x, moving_mean, moving_var, out;
  long long n, c, hw;
  double momentum, one_minus_momentum;
  long long grid, k, cpb, group, chunk;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 15 * 8, "Packed: 15 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// out[0]: the largest cluster the card runs for these kernels. The
// wrapper's planner reads it once per device.
extern "C" int mxt_bn_stats_caps(int* out, void* stream) {
  (void)stream;
  return caps(out);
}

// One launch, as planned by the wrapper: grid blocks of cpb * group
// threads, k blocks per channel, chunk elements of a channel per block
// (all of it with k == 1). The arguments come packed in one struct of
// 8-byte fields. Returns cudaErrorInvalidValue for a plan that does not fit
// this call or the card.
extern "C" int mxt_bn_stats_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long n = in.n, c = in.c, hw = in.hw, grid = in.grid,
                  chunk = in.chunk, k = in.k, cpb = in.cpb, group = in.group;
  if (n <= 0 || c <= 0 || hw <= 0) return (int)cudaGetLastError();
  int cluster = 1;
  const int err = caps(&cluster);
  if (err != 0) return err;
  const long long m = n * hw;
  if (m >= (1LL << 31) || k < 1 || k > cluster || (k > 1 && cpb != 1) ||
      cpb < 1 || group < 32 || group % 32 != 0 ||
      cpb * group > kMaxThreads || chunk < 4 || chunk % 4 != 0 ||
      chunk * k < m || chunk * (k - 1) >= m ||
      grid != (c + cpb - 1) / cpb * k || grid >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int vec =
      hw % 4 == 0 && (reinterpret_cast<uintptr_t>(ptr<void>(in.x)) & 15) == 0;
  Stats a;
  a.x = ptr<const float>(in.x);
  a.moving_mean = ptr<float>(in.moving_mean);
  a.moving_var = ptr<float>(in.moving_var);
  a.out = ptr<float>(in.out);
  a.channels = c;
  a.hw = (unsigned)hw;
  a.m = (unsigned)m;
  a.chunk = (unsigned)chunk;
  a.group = (int)group;
  a.cpb = (int)cpb;
  a.k = (int)k;
  a.count = (float)m;
  a.momentum = (float)in.momentum;
  a.one_minus_momentum = (float)in.one_minus_momentum;
  const Kernel kern = kernel_of(vec);
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  if (k == 1) {
    kern<<<(unsigned)grid, (unsigned)(cpb * group), 0, st>>>(a);
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
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
