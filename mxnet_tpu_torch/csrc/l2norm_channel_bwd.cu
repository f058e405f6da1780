// Backward of the channel L2 normalization with a fused scale, NCHW float32.
//
// Replaces the VJP of mxnet_tpu/ops/defs_nn.py:_l2_normalization in mode
// "channel" together with the `* 20.0` (`_mul_scalar`) that follows it on
// the SSD path (mxnet_tpu/models/ssd.py:132-133), which XLA fuses into one
// pass; see mxnet_tpu_torch/kernels/l2norm_channel.py for the wrapper and
// the plain version.
//
//   y  = (x / n) * s,   n = sqrt(sum_c x^2 + eps)
//   dx = s * g / n - x * (s * sum_c g * x) / n^3
//
// The norm is recomputed from x rather than saved by the forward, so the
// serving path's kernel keeps its single output. Each product and sum is
// rounded once with round-to-nearest intrinsics (no FMA contraction); the
// order of operations is not jax.vjp's, and the wrapper's tolerance says
// how far apart the two may be.
//
// Bound: device-memory bandwidth. At SSD-300's conv4_3 in training,
// (32, 512, 37, 37), the function reads x and g (89.7 MB each) and writes
// dx (89.7 MB) for ~8 flops an element. Design: the layout of
// l2norm_channel.cu — a block of 32 x 16 threads takes 32 neighbouring
// (n, h*w) positions, each of its 16 rows of threads sums x^2 and g*x over
// every 16th channel with stride H*W, so a warp reads 32 neighbouring
// addresses for each channel; the 16 partial pairs are added in a fixed
// order in shared memory, and each thread then reads its channels of x and
// g again (still in L2) and writes dx.

#include <cuda_runtime.h>

namespace {

constexpr int kPos = 32;     // positions per block (a warp's width)
constexpr int kSlices = 16;  // channel slices per position

__global__ void __launch_bounds__(kPos * kSlices)
l2norm_channel_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ dx, long long n, long long c,
                          long long hw, float eps, float scale) {
  __shared__ float part_xx[kSlices][kPos];
  __shared__ float part_gx[kSlices][kPos];
  const long long pos = (long long)blockIdx.x * kPos + threadIdx.x;
  const bool live = pos < n * hw;
  const long long img = live ? pos / hw : 0, p = live ? pos - img * hw : 0;
  const long long base = img * c * hw + p;
  float sxx = 0.f, sgx = 0.f;
  if (live) {
#pragma unroll 4
    for (long long k = threadIdx.y; k < c; k += kSlices) {
      const float v = x[base + k * hw], w = g[base + k * hw];
      sxx = __fadd_rn(sxx, __fmul_rn(v, v));
      sgx = __fadd_rn(sgx, __fmul_rn(w, v));
    }
  }
  part_xx[threadIdx.y][threadIdx.x] = sxx;
  part_gx[threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (!live) return;
  float txx = 0.f, tgx = 0.f;
  for (int j = 0; j < kSlices; ++j) {
    txx = __fadd_rn(txx, part_xx[j][threadIdx.x]);
    tgx = __fadd_rn(tgx, part_gx[j][threadIdx.x]);
  }
  const float norm = __fsqrt_rn(__fadd_rn(txx, eps));
  const float n3 = __fmul_rn(__fmul_rn(norm, norm), norm);
  const float coef = __fdiv_rn(__fmul_rn(scale, tgx), n3);
  const float gs = __fdiv_rn(scale, norm);
#pragma unroll 4
  for (long long k = threadIdx.y; k < c; k += kSlices) {
    const long long i = base + k * hw;
    dx[i] = __fsub_rn(__fmul_rn(gs, g[i]), __fmul_rn(x[i], coef));
  }
}

}  // namespace

extern "C" int mxt_l2norm_channel_bwd_f32(const void* x, const void* g,
                                          void* dx, long long n, long long c,
                                          long long hw, float eps,
                                          float scale, void* stream) {
  const long long total = n * hw;
  if (total > 0 && c > 0) {
    const long long blocks = (total + kPos - 1) / kPos;
    l2norm_channel_bwd_kernel<<<(unsigned)blocks, dim3(kPos, kSlices), 0,
                                (cudaStream_t)stream>>>(
        (const float*)x, (const float*)g, (float*)dx, n, c, hw, eps, scale);
  }
  return (int)cudaGetLastError();
}
