// Inference BatchNorm with an optional fused ReLU, NCHW float32.
//
// Replaces the use_global branch of mxnet_tpu/ops/defs_nn.py:_batch_norm
// together with the Activation(relu) that follows it; see
// mxnet_tpu_torch/kernels/bn_act.py for the wrapper and the plain version.
//
//   y = max(((x - mean) * rsqrt(var + eps)) * gamma + beta, 0)
//
// The operations run in exactly this order with round-to-nearest
// intrinsics (no FMA contraction), so the result matches the reference
// formula at float32 rounding.
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
                                        float b, int relu) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), inv), g), b);
  // NaN propagates as in max(y, 0) of the reference.
  return (relu && y < 0.f) ? 0.f : y;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bn_act_kernel(const float* __restrict__ x, const float* __restrict__ mean,
              const float* __restrict__ var, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ y,
              long long planes, int channels, long long hw, float eps,
              int fix_gamma, int relu) {
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
    yp[i] = bn_one(xp[i], m, inv, g, b, relu);

  const long long nvec = (hw - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xp + head);
  float4* yv = reinterpret_cast<float4*>(yp + head);
  for (long long i = lane; i < nvec; i += 32) {
    float4 v = xv[i];
    v.x = bn_one(v.x, m, inv, g, b, relu);
    v.y = bn_one(v.y, m, inv, g, b, relu);
    v.z = bn_one(v.z, m, inv, g, b, relu);
    v.w = bn_one(v.w, m, inv, g, b, relu);
    yv[i] = v;
  }

  for (long long i = head + nvec * 4 + lane; i < hw; i += 32)
    yp[i] = bn_one(xp[i], m, inv, g, b, relu);
}

}  // namespace

extern "C" int mxt_bn_act_f32(const void* x, const void* mean, const void* var,
                              const void* gamma, const void* beta, void* y,
                              long long n, long long c, long long hw,
                              float eps, int fix_gamma, int relu,
                              void* stream) {
  const long long planes = n * c;
  if (planes > 0 && hw > 0) {
    const long long blocks = (planes + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bn_act_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                    (cudaStream_t)stream>>>(
        (const float*)x, (const float*)mean, (const float*)var,
        (const float*)gamma, (const float*)beta, (float*)y, planes, (int)c,
        hw, eps, fix_gamma, relu);
  }
  return (int)cudaGetLastError();
}
