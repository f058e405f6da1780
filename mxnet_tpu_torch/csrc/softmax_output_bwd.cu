// SoftmaxOutput loss-layer backward, float32.
//
// Replaces `bwd` inside mxnet_tpu/ops/defs_nn.py _softmax_output (the
// custom_vjp that ignores the head gradient); see
// mxnet_tpu_torch/kernels/softmax_output_bwd.py for the wrapper and the
// plain version. The probabilities p (the forward's output) are viewed as
// (outer, C, inner) with the class axis in the middle (inner = 1 for the
// flattened and preserve_shape layouts, H*W... for multi_output), the
// labels as (outer, inner):
//
//   g = (p - onehot(label)) [* valid] [/ N or / max(sum(valid), 1)] * scale
//
// in exactly that order, valid = (label != ignore_label) under use_ignore.
//
// Bound: launch latency on the training path ((32, 1000): 256 KB moved).
// Design: one thread per element, a grid-stride loop; the label is read
// per element (it sits in L1). normalization='valid' needs the number of
// valid labels over the whole batch before any element can be scaled: a
// one-block count kernel launched first writes it to a device scalar that
// the element kernel reads, so there is no host round trip.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool is_class(float label, int c) {
  // the reference casts the label to int32 (truncation toward zero)
  return label > -2147483648.f && label < 2147483648.f && (int)label == c;
}

__global__ void __launch_bounds__(1024)
count_valid_kernel(const float* __restrict__ label, long long n,
                   float ignore_label, int use_ignore, float* count) {
  __shared__ long long scratch[32];
  long long k = 0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    k += (!use_ignore || label[i] != ignore_label) ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1) k += __shfl_xor_sync(0xffffffffu, k, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += scratch[w];
    *count = (float)t;
  }
}

__global__ void __launch_bounds__(kThreads)
softmax_output_bwd_kernel(const float* __restrict__ p,
                          const float* __restrict__ label,
                          float* __restrict__ g, long long total, int classes,
                          long long inner, float grad_scale,
                          float ignore_label, int use_ignore, int norm_mode,
                          float batch, const float* __restrict__ count) {
  const float norm = norm_mode == 1 ? batch
                   : norm_mode == 2 ? fmaxf(*count, 1.f) : 1.f;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const long long i = idx % inner;
    const long long t = idx / inner;
    const int c = (int)(t % classes);
    const long long o = t / classes;
    const float l = label[o * inner + i];
    float v = __fsub_rn(p[idx], is_class(l, c) ? 1.f : 0.f);
    if (use_ignore) v = __fmul_rn(v, l != ignore_label ? 1.f : 0.f);
    if (norm_mode) v = __fdiv_rn(v, norm);
    g[idx] = __fmul_rn(v, grad_scale);
  }
}

}  // namespace

// norm_mode: 0 null, 1 batch (divide by `batch`), 2 valid (count kernel).
extern "C" int mxt_softmax_output_bwd_f32(
    const void* p, const void* label, void* g, void* count, long long outer,
    long long classes, long long inner, float grad_scale, float ignore_label,
    int use_ignore, int norm_mode, float batch, void* stream) {
  const long long total = outer * classes * inner;
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (norm_mode == 2) {
    count_valid_kernel<<<1, 1024, 0, s>>>((const float*)label, outer * inner,
                                          ignore_label, use_ignore,
                                          (float*)count);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  softmax_output_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)p, (const float*)label, (float*)g, total, (int)classes,
      inner, grad_scale, ignore_label, use_ignore, norm_mode, batch,
      (const float*)count);
  return (int)cudaGetLastError();
}
