// BatchNorm backward with the following (leaky) ReLU's mask fused, NCHW
// float32.
//
// Replaces the VJP of mxnet_tpu/ops/defs_nn.py _batch_norm (training
// branch, the anchor m0 under stop_gradient) composed with the
// Activation(relu) or LeakyReLU(act_type="leaky") after it; see
// mxnet_tpu_torch/kernels/bn_act_bwd.py for the wrapper and the plain
// version. With dy' = y > 0 ? dy : slope * dy (slope >= 0; the ReLU is
// slope 0, and then dy' is +0.0 where y <= 0) or dy (a negative or NaN
// slope: no activation), x^ = (x - mean) * invstd,
// invstd = 1 / sqrt(var + eps), g = gamma (1 under fix_gamma) and
// n = N*H*W, per channel:
//
//   dbeta  = sum(dy')        dgamma = sum(dy' * x^)   (0 under fix_gamma)
//   dx     = g * invstd * (dy' - km * dbeta / n - kvar * x^ * sum(dy' x^) / n)
//
// km = 1 and kvar from bn_stats.cu (1, 0.5 or 0: the clamp's derivative)
// for batch statistics; km = kvar = 0 for use_global_stats, where mean and
// var are the moving statistics and do not depend on x. The mask reads the
// sign from the output y, whose sign is t's for slope >= 0; at t == 0 it
// gives slope * dy, the gradient of the reference's where(t > 0, ...). The
// leaky route (slope > 0) runs under its own kernel names,
// bn_bwd_leaky_reduce_kernel and bn_bwd_leaky_dx_kernel, so that a profile
// tells it from the ReLU's.
//
// Bound: device-memory bandwidth. Two phases, two launches: the reduction
// reads dy, y and x (12 bytes per element, 8 without the activation), the
// dx pass reads them again and writes dx (16 bytes), against the one-pass
// minimum of 16. The reduction walks planes as bn_stats.cu does: block
// (c, s) gives its warps whole (n, c) planes, and the last block of a
// channel (atomic ticket) adds the partials in a fixed order. The dx pass
// gives one warp to each plane, as bn_act.cu does. Both read with 4-byte
// loads, coalesced across the warp; 16-byte loads are left for a later
// change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float masked(float dy, float y, int act,
                                        float slope) {
  if (!act || y > 0.f) return dy;
  return slope == 0.f ? 0.f : __fmul_rn(slope, dy);
}

__device__ __forceinline__ float invstd_of(float var, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

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
    for (long long i = lane; i < hw; i += 32) {
      const float d = masked(dp[i], yp[i], act, slope);
      sd += d;
      sdx = fmaf(d, __fmul_rn(__fsub_rn(xp[i], m), inv), sdx);
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
  for (long long i = lane; i < hw; i += 32) {
    const float d = masked(dp[i], yp[i], act, slope);
    const float xh = __fmul_rn(__fsub_rn(xp[i], m), inv);
    op[i] = scale * (d - a - xh * b);
  }
}

// no activation (act 0) or the ReLU (act 1)
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                     const float* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ var, float* __restrict__ sums,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     float* partial, unsigned int* ticket, int n_batch,
                     int channels, long long hw, int splits, float eps,
                     int fix_gamma, int act) {
  bwd_reduce(dy, y, x, mean, var, sums, dgamma, dbeta, partial, ticket,
             n_batch, channels, hw, splits, eps, fix_gamma, act, 0.f);
}

// the leaky ReLU, slope > 0
__global__ void __launch_bounds__(kThreads)
bn_bwd_leaky_reduce_kernel(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ sums,
    float* __restrict__ dgamma, float* __restrict__ dbeta, float* partial,
    unsigned int* ticket, int n_batch, int channels, long long hw, int splits,
    float eps, int fix_gamma, float slope) {
  bwd_reduce(dy, y, x, mean, var, sums, dgamma, dbeta, partial, ticket,
             n_batch, channels, hw, splits, eps, fix_gamma, 1, slope);
}

__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                 const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ var,
                 const float* __restrict__ gamma,
                 const float* __restrict__ kvar,
                 const float* __restrict__ sums, float* __restrict__ dx,
                 long long planes, int channels, long long hw, float count,
                 float eps, int fix_gamma, int act, int batch_stats) {
  bwd_dx(dy, y, x, mean, var, gamma, kvar, sums, dx, planes, channels, hw,
         count, eps, fix_gamma, act, 0.f, batch_stats);
}

__global__ void __launch_bounds__(kThreads)
bn_bwd_leaky_dx_kernel(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ gamma,
    const float* __restrict__ kvar, const float* __restrict__ sums,
    float* __restrict__ dx, long long planes, int channels, long long hw,
    float count, float eps, int fix_gamma, float slope, int batch_stats) {
  bwd_dx(dy, y, x, mean, var, gamma, kvar, sums, dx, planes, channels, hw,
         count, eps, fix_gamma, 1, slope, batch_stats);
}

}  // namespace

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
    if (slope > 0.f)
      bn_bwd_leaky_reduce_kernel<<<blocks, kThreads, 0, st>>>(
          (const float*)dy, (const float*)y, (const float*)x,
          (const float*)mean, (const float*)var, (float*)sums,
          (float*)dgamma, (float*)dbeta, (float*)partial,
          (unsigned int*)ticket, (int)n, (int)c, hw, splits, eps, fix_gamma,
          slope);
    else
      bn_bwd_reduce_kernel<<<blocks, kThreads, 0, st>>>(
          (const float*)dy, (const float*)y, (const float*)x,
          (const float*)mean, (const float*)var, (float*)sums,
          (float*)dgamma, (float*)dbeta, (float*)partial,
          (unsigned int*)ticket, (int)n, (int)c, hw, splits, eps, fix_gamma,
          slope == 0.f ? 1 : 0);
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
    if (slope > 0.f)
      bn_bwd_leaky_dx_kernel<<<blocks, kThreads, 0, st>>>(
          (const float*)dy, (const float*)y, (const float*)x,
          (const float*)mean, (const float*)var, (const float*)gamma,
          (const float*)kvar, (const float*)sums, (float*)dx, planes, (int)c,
          hw, (float)(n * hw), eps, fix_gamma, slope, batch_stats);
    else
      bn_bwd_dx_kernel<<<blocks, kThreads, 0, st>>>(
          (const float*)dy, (const float*)y, (const float*)x,
          (const float*)mean, (const float*)var, (const float*)gamma,
          (const float*)kvar, (const float*)sums, (float*)dx, planes, (int)c,
          hw, (float)(n * hw), eps, fix_gamma, slope == 0.f ? 1 : 0,
          batch_stats);
  }
  return (int)cudaGetLastError();
}
