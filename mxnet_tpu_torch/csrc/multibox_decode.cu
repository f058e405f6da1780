// SSD detection head, per anchor: class softmax, best foreground class,
// and box decode. float32.
//
// Replaces the per-anchor part of mxnet_tpu/ops/defs_contrib.py
// _multibox_detection (:256-279: `_decode_boxes` :134-146, the foreground
// max/argmax) together with the channel SoftmaxActivation that feeds it on
// the SSD path (mxnet_tpu/ops/defs_nn.py:671-676); see
// mxnet_tpu_torch/kernels/multibox_decode.py for the wrapper and the plain
// version. For one (image b, anchor a):
//
//   p_c   = exp(x_c - max_c x) / sum_c exp(x_c - max_c x)   (softmax = 1;
//           else p_c = x_c, already probabilities)
//   score = max_{c >= 1} p_c, cls = its first index minus 1
//   box   = decode(loc[b, a], anchor[a]) with the variances, clipped to
//           [0, 1] when clip is set
//
// Every product, sum and quotient is rounded once with round-to-nearest
// intrinsics in the reference's order (no FMA contraction), and the
// exponentials are expf, as jax.nn.softmax and jnp.exp compute them.
//
// The class scores arrive as a strided view, (n, C+1, A) with strides
// (sn, sc, sa) in elements: on the SSD path a transpose(0, 2, 1) of an
// (n, A, C+1) array, so sc = 1 and sa = C+1. The kernel reads through the
// strides; nothing is copied.
//
// Bound: launch latency. At SSD-300, batch 8, A = 8096, C+1 = 21, the
// function reads 5.4 MB of scores, 1.0 MB of offsets and 0.13 MB of anchors
// and writes 1.6 MB: ~2.4 us at 3.35 TB/s. One thread per (b, a).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
multibox_decode_kernel(const float* __restrict__ cls, long long sn,
                       long long sc, long long sa,
                       const float* __restrict__ loc,
                       const float* __restrict__ anchors,
                       float* __restrict__ boxes, float* __restrict__ score,
                       int* __restrict__ cls_id, long long n, int c1,
                       long long a_count, float v0, float v1, float v2,
                       float v3, int clip, int softmax) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * a_count) return;
  const long long b = idx / a_count, a = idx - b * a_count;
  const float* x = cls + b * sn + a * sa;

  float m = 0.f, s = 1.f;
  if (softmax) {
    m = x[0];
    for (int c = 1; c < c1; ++c) m = fmaxf(m, x[c * sc]);
    s = 0.f;
    for (int c = 0; c < c1; ++c)
      s = __fadd_rn(s, expf(__fsub_rn(x[c * sc], m)));
  }
  float best = 0.f;
  int arg = 0;
  for (int c = 1; c < c1; ++c) {
    const float p = softmax ? __fdiv_rn(expf(__fsub_rn(x[c * sc], m)), s)
                            : x[c * sc];
    if (c == 1 || p > best) {  // strictly greater: the first index wins
      best = p;
      arg = c - 1;
    }
  }
  score[idx] = best;
  cls_id[idx] = arg;

  const float4 an = reinterpret_cast<const float4*>(anchors)[a];
  const float4 l = reinterpret_cast<const float4*>(loc)[idx];
  const float aw = __fsub_rn(an.z, an.x), ah = __fsub_rn(an.w, an.y);
  const float acx = __fdiv_rn(__fadd_rn(an.x, an.z), 2.f);
  const float acy = __fdiv_rn(__fadd_rn(an.y, an.w), 2.f);
  const float cx = __fadd_rn(__fmul_rn(__fmul_rn(l.x, v0), aw), acx);
  const float cy = __fadd_rn(__fmul_rn(__fmul_rn(l.y, v1), ah), acy);
  const float w = __fdiv_rn(__fmul_rn(expf(__fmul_rn(l.z, v2)), aw), 2.f);
  const float h = __fdiv_rn(__fmul_rn(expf(__fmul_rn(l.w, v3)), ah), 2.f);
  float4 out = make_float4(__fsub_rn(cx, w), __fsub_rn(cy, h),
                           __fadd_rn(cx, w), __fadd_rn(cy, h));
  if (clip) {
    out.x = fminf(fmaxf(out.x, 0.f), 1.f);
    out.y = fminf(fmaxf(out.y, 0.f), 1.f);
    out.z = fminf(fmaxf(out.z, 0.f), 1.f);
    out.w = fminf(fmaxf(out.w, 0.f), 1.f);
  }
  reinterpret_cast<float4*>(boxes)[idx] = out;
}

}  // namespace

extern "C" int mxt_multibox_decode_f32(
    const void* cls, long long sn, long long sc, long long sa,
    const void* loc, const void* anchors, void* boxes, void* score,
    void* cls_id, long long n, int c1, long long a_count, float v0, float v1,
    float v2, float v3, int clip, int softmax, void* stream) {
  const long long total = n * a_count;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    multibox_decode_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)cls, sn, sc, sa, (const float*)loc,
        (const float*)anchors, (float*)boxes, (float*)score, (int*)cls_id,
        n, c1, a_count, v0, v1, v2, v3, clip, softmax);
  }
  return (int)cudaGetLastError();
}
