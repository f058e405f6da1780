// Row softmax over a contiguous (rows, cols) float32 array.
//
// Replaces `forward` inside mxnet_tpu/ops/defs_nn.py:_softmax_output (the
// SoftmaxOutput forward); see mxnet_tpu_torch/kernels/softmax_rows.py for
// the wrapper and the plain version.
//
//   out[r, j] = exp(x[r, j] - max_j x[r, :]) / sum_j exp(x[r, j] - max)
//
// Bound: on the serving path the array is (bucket, 1000): 32 x 1000 x 8 B
// is 256 KB, under a microsecond of device-memory time, so the kernel is
// bound by its launch latency. Design: one block per row, a loop over the
// columns for any width, the float32 max and sum reduced with warp
// shuffles and then across the block's warps in shared memory. The row is
// read three times; after the first pass it sits in L1/L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, scratch[w]) : v + scratch[w];
  return v;
}

__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                    long long cols) {
  __shared__ float scratch[kWarps];
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;

  float m = -INFINITY;
  for (long long j = threadIdx.x; j < cols; j += kThreads) m = fmaxf(m, xr[j]);
  m = block_reduce<true>(m, scratch);

  float s = 0.f;
  for (long long j = threadIdx.x; j < cols; j += kThreads) s += expf(xr[j] - m);
  s = block_reduce<false>(s, scratch);

  for (long long j = threadIdx.x; j < cols; j += kThreads)
    yr[j] = expf(xr[j] - m) / s;
}

}  // namespace

extern "C" int mxt_softmax_rows_f32(const void* x, void* y, long long rows,
                                    long long cols, void* stream) {
  if (rows > 0 && cols > 0) {
    softmax_rows_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, cols);
  }
  return (int)cudaGetLastError();
}
