// Anchored one-pass BatchNorm training statistics, NCHW float32.
//
// Replaces the batch-statistics branch of mxnet_tpu/ops/defs_nn.py
// _batch_norm (the training forward); see mxnet_tpu_torch/kernels/bn_stats.py
// for the wrapper and the plain version. Per channel c, over the N*H*W
// elements of the channel, with the anchor m0 = moving_mean[c]:
//
//   dmean = sum(x - m0) / n        mean = m0 + dmean
//   raw   = sum((x - m0)^2) / n - dmean^2      var = max(raw, 0)
//   moving_mean = moving_mean * momentum + mean * (1 - momentum)
//   moving_var  = moving_var  * momentum + var  * (1 - momentum)
//
// written in place, plus kvar = 1 (raw > 0), 0.5 (raw == 0) or 0 (raw < 0):
// the derivative of the clamp max(raw, 0) as jax.vjp takes it, which the
// backward (bn_act_bwd.cu) multiplies into the variance term.
//
// Bound: device-memory bandwidth, 4 bytes read per element. Design: block
// (c, s) of S blocks per channel gives each of its 8 warps whole (n, c)
// planes (planes n = s*8 + w, s*8 + w + 8*S, ...); a warp streams a plane
// with 16-byte loads (scalar head and tail for planes that start unaligned,
// e.g. 7*7 = 49), four loads in flight per lane. Each block writes its two
// partial sums; the last block of the channel to finish (an atomic ticket)
// adds the S partials in a fixed order, so the result does not depend on
// block scheduling, and writes the statistics. Every block reads the anchor
// before it takes its ticket, so the in-place moving-mean write by the last
// block cannot race a read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void acc(float v, float m0, float& s1, float& s2) {
  const float d = __fsub_rn(v, m0);
  s1 = __fadd_rn(s1, d);
  s2 = __fmaf_rn(d, d, s2);
}

__device__ __forceinline__ void acc4(const float4 v, float m0, float& s1,
                                     float& s2) {
  acc(v.x, m0, s1, s2);
  acc(v.y, m0, s1, s2);
  acc(v.z, m0, s1, s2);
  acc(v.w, m0, s1, s2);
}

// Sum of a over the block; every thread gets the result.
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

__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const float* __restrict__ x, float* moving_mean,
                float* moving_var, float* __restrict__ mean_out,
                float* __restrict__ var_out, float* __restrict__ kvar_out,
                float* partial, unsigned int* ticket, int n_batch,
                int channels, long long hw, int splits, float count,
                float momentum, float one_minus_momentum) {
  __shared__ float scratch[kWarps];
  __shared__ bool last;
  const int c = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float m0 = moving_mean[c];

  float s1 = 0.f, s2 = 0.f;
  for (int n = s * kWarps + warp; n < n_batch; n += splits * kWarps) {
    const float* p = x + ((long long)n * channels + c) * hw;
    long long head = (long long)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2);
    if (head > hw) head = hw;
    for (long long i = lane; i < head; i += 32) acc(p[i], m0, s1, s2);
    const long long nvec = (hw - head) >> 2;
    const float4* v = reinterpret_cast<const float4*>(p + head);
    long long i = lane;
    for (; i + 96 < nvec; i += 128) {
      const float4 a = v[i], b = v[i + 32], d = v[i + 64], e = v[i + 96];
      acc4(a, m0, s1, s2);
      acc4(b, m0, s1, s2);
      acc4(d, m0, s1, s2);
      acc4(e, m0, s1, s2);
    }
    for (; i < nvec; i += 32) acc4(v[i], m0, s1, s2);
    for (long long j = head + nvec * 4 + lane; j < hw; j += 32)
      acc(p[j], m0, s1, s2);
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    partial[2 * ((long long)c * splits + s)] = s1;
    partial[2 * ((long long)c * splits + s) + 1] = s2;
    __threadfence();
    last = atomicAdd(&ticket[c], 1u) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  float t1 = 0.f, t2 = 0.f;
  for (int j = 0; j < splits; ++j) {
    t1 = __fadd_rn(t1, __ldcg(&partial[2 * ((long long)c * splits + j)]));
    t2 = __fadd_rn(t2, __ldcg(&partial[2 * ((long long)c * splits + j) + 1]));
  }
  const float dmean = __fdiv_rn(t1, count);
  const float mean = __fadd_rn(m0, dmean);
  const float raw = __fsub_rn(__fdiv_rn(t2, count), __fmul_rn(dmean, dmean));
  // max(raw, 0) that lets NaN through, as jnp.maximum does
  const float var = (raw < 0.f) ? 0.f : raw;
  mean_out[c] = mean;
  var_out[c] = var;
  kvar_out[c] = raw > 0.f ? 1.f : (raw == 0.f ? 0.5f : 0.f);
  moving_mean[c] = __fadd_rn(__fmul_rn(moving_mean[c], momentum),
                             __fmul_rn(mean, one_minus_momentum));
  moving_var[c] = __fadd_rn(__fmul_rn(moving_var[c], momentum),
                            __fmul_rn(var, one_minus_momentum));
  ticket[c] = 0u;  // ready for the next launch
}

}  // namespace

extern "C" int mxt_bn_stats_f32(const void* x, void* moving_mean,
                                void* moving_var, void* mean, void* var,
                                void* kvar, void* partial, void* ticket,
                                long long n, long long c, long long hw,
                                int splits, float momentum,
                                float one_minus_momentum, void* stream) {
  if (n > 0 && c > 0 && hw > 0) {
    bn_stats_kernel<<<(unsigned)(c * splits), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const float*)x, (float*)moving_mean, (float*)moving_var,
        (float*)mean, (float*)var, (float*)kvar, (float*)partial,
        (unsigned int*)ticket, (int)n, (int)c, hw, splits,
        (float)(n * hw), momentum, one_minus_momentum);
  }
  return (int)cudaGetLastError();
}
