// BatchNorm's normalize and affine with an optional fused (leaky) ReLU,
// NCHW float32.
//
// Replaces the normalize and affine of mxnet_tpu/ops/defs_nn.py:_batch_norm
// together with the Activation(relu) or LeakyReLU(act_type="leaky") that
// follows it; see mxnet_tpu_torch/kernels/bn_act.py for the wrapper and the
// plain version.
//
//   t = ((x - mean) * rsqrt(var + eps)) * gamma + beta
//   y = t > 0 ? t : slope * t          (slope >= 0; ReLU is slope 0)
//
// A negative (or NaN) slope means no activation. The operations run in
// exactly this order with round-to-nearest intrinsics (no FMA
// contraction), so the result matches the reference formula at float32
// rounding. Slope 0 keeps the ReLU's +0.0 for negative t (0 * t would give
// -0.0). The leaky route (slope > 0) runs under its own kernel name,
// bn_act_leaky_kernel, so that a profile tells it from the ReLU's.
//
// Bound: device-memory bandwidth (8 bytes moved per element, a handful of
// flops). One warp streams one (n, c) plane: it computes the channel's
// constants once, peels scalars up to a 16-byte boundary, then moves the
// plane with 16-byte vector loads and stores, and finishes the ragged tail
// (H*W not a multiple of 4, e.g. 7*7 = 49) with scalars.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float bn_one(float x, float m, float inv, float g,
                                        float b, int act, float slope) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), inv), g), b);
  // NaN, +0.0 and -0.0 pass as they are: where(t > 0, t, slope * t) gives
  // the same for them, and max(t, 0) keeps NaN.
  if (!act || !(y < 0.f)) return y;
  return slope == 0.f ? 0.f : __fmul_rn(slope, y);
}

__device__ __forceinline__ void bn_act_plane(
    const float* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ y, long long planes,
    int channels, long long hw, float eps, int fix_gamma, int act,
    float slope) {
  const int lane = threadIdx.x & 31;
  const long long plane =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (plane >= planes) return;
  const int c = (int)(plane % channels);
  const float m = mean[c];
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[c], eps)));
  const float g = fix_gamma ? 1.f : gamma[c];
  const float b = beta[c];

  const float* xp = x + plane * hw;
  float* yp = y + plane * hw;
  // x and y are both 16-byte aligned at element 0 (checked by the
  // wrapper), so one head length aligns both.
  long long head = (long long)(((16u - ((uintptr_t)xp & 15u)) & 15u) >> 2);
  if (head > hw) head = hw;
  for (long long i = lane; i < head; i += 32)
    yp[i] = bn_one(xp[i], m, inv, g, b, act, slope);

  const long long nvec = (hw - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xp + head);
  float4* yv = reinterpret_cast<float4*>(yp + head);
  for (long long i = lane; i < nvec; i += 32) {
    float4 v = xv[i];
    v.x = bn_one(v.x, m, inv, g, b, act, slope);
    v.y = bn_one(v.y, m, inv, g, b, act, slope);
    v.z = bn_one(v.z, m, inv, g, b, act, slope);
    v.w = bn_one(v.w, m, inv, g, b, act, slope);
    yv[i] = v;
  }

  for (long long i = head + nvec * 4 + lane; i < hw; i += 32)
    yp[i] = bn_one(xp[i], m, inv, g, b, act, slope);
}

// no activation (act 0) or the ReLU (act 1)
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bn_act_kernel(const float* __restrict__ x, const float* __restrict__ mean,
              const float* __restrict__ var, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ y,
              long long planes, int channels, long long hw, float eps,
              int fix_gamma, int act) {
  bn_act_plane(x, mean, var, gamma, beta, y, planes, channels, hw, eps,
               fix_gamma, act, 0.f);
}

// the leaky ReLU, slope > 0
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bn_act_leaky_kernel(const float* __restrict__ x,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ y,
                    long long planes, int channels, long long hw, float eps,
                    int fix_gamma, float slope) {
  bn_act_plane(x, mean, var, gamma, beta, y, planes, channels, hw, eps,
               fix_gamma, 1, slope);
}

}  // namespace

extern "C" int mxt_bn_act_f32(const void* x, const void* mean, const void* var,
                              const void* gamma, const void* beta, void* y,
                              long long n, long long c, long long hw,
                              float eps, int fix_gamma, float slope,
                              void* stream) {
  const long long planes = n * c;
  if (planes > 0 && hw > 0) {
    const unsigned blocks =
        (unsigned)((planes + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t st = (cudaStream_t)stream;
    if (slope > 0.f)
      bn_act_leaky_kernel<<<blocks, kWarpsPerBlock * 32, 0, st>>>(
          (const float*)x, (const float*)mean, (const float*)var,
          (const float*)gamma, (const float*)beta, (float*)y, planes, (int)c,
          hw, eps, fix_gamma, slope);
    else
      bn_act_kernel<<<blocks, kWarpsPerBlock * 32, 0, st>>>(
          (const float*)x, (const float*)mean, (const float*)var,
          (const float*)gamma, (const float*)beta, (float*)y, planes, (int)c,
          hw, eps, fix_gamma, slope == 0.f ? 1 : 0);
  }
  return (int)cudaGetLastError();
}
