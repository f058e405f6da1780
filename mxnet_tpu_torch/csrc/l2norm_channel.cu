// Channel L2 normalization with a fused scale, NCHW float32.
//
// Replaces mxnet_tpu/ops/defs_nn.py:_l2_normalization in mode "channel"
// together with the `* 20.0` (`_mul_scalar`) that follows it on the SSD
// path (mxnet_tpu/models/ssd.py:132-133); see
// mxnet_tpu_torch/kernels/l2norm_channel.py for the wrapper and the plain
// version.
//
//   y[n, c, p] = (x[n, c, p] / sqrt(sum_c x[n, c, p]^2 + eps)) * scale
//
// The square, the sum, the sqrt, the division and the scale are each
// rounded once with round-to-nearest intrinsics (no FMA contraction), in
// this order: the reference's two roundings, not x * (scale / norm).
//
// Bound: device-memory bandwidth. At SSD-300's conv4_3, (8, 512, 37, 37),
// the function reads 22.4 MB and writes 22.4 MB for ~4 flops an element.
// Design: a block of 32 x 16 threads takes 32 neighbouring (n, h*w)
// positions; each of its 16 rows of threads sums the squares of every
// 16th channel with stride H*W, so a warp reads 32 neighbouring addresses
// for each channel and 16 times as many loads are in flight as with one
// thread per position. The 16 partial sums are added in a fixed order in
// shared memory, and each thread then reads its channels again (still in
// L2) and writes the result.

#include <cuda_runtime.h>

namespace {

constexpr int kPos = 32;     // positions per block (a warp's width)
constexpr int kSlices = 16;  // channel slices per position

__global__ void __launch_bounds__(kPos * kSlices)
l2norm_channel_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n, long long c, long long hw, float eps,
                      float scale) {
  __shared__ float part[kSlices][kPos];
  const long long pos = (long long)blockIdx.x * kPos + threadIdx.x;
  const bool live = pos < n * hw;
  const long long img = live ? pos / hw : 0, p = live ? pos - img * hw : 0;
  const float* xc = x + img * c * hw + p;
  float* yc = y + img * c * hw + p;
  float s = 0.f;
  if (live) {
#pragma unroll 4
    for (long long k = threadIdx.y; k < c; k += kSlices) {
      const float v = xc[k * hw];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (!live) return;
  float total = 0.f;
  for (int j = 0; j < kSlices; ++j)
    total = __fadd_rn(total, part[j][threadIdx.x]);
  const float norm = __fsqrt_rn(__fadd_rn(total, eps));
#pragma unroll 4
  for (long long k = threadIdx.y; k < c; k += kSlices)
    yc[k * hw] = __fmul_rn(__fdiv_rn(xc[k * hw], norm), scale);
}

}  // namespace

extern "C" int mxt_l2norm_channel_f32(const void* x, void* y, long long n,
                                      long long c, long long hw, float eps,
                                      float scale, void* stream) {
  const long long total = n * hw;
  if (total > 0 && c > 0) {
    const long long blocks = (total + kPos - 1) / kPos;
    l2norm_channel_kernel<<<(unsigned)blocks, dim3(kPos, kSlices), 0,
                            (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, n, c, hw, eps, scale);
  }
  return (int)cudaGetLastError();
}
