// Backward of the channel L2 normalization with a fused scale, NCHW float32.
//
// Replaces the VJP of mxnet_tpu/ops/defs_nn.py:_l2_normalization in mode
// "channel" together with the `* 20.0` (`_mul_scalar`) that follows it on
// the SSD path (mxnet_tpu/models/ssd.py:132-133), which XLA fuses into one
// pass; see mxnet_tpu_torch/kernels/l2norm_channel.py for the wrapper, the
// plain version and the planner that picks the regime.
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
// dx (89.7 MB), 12 bytes an element, for ~8 flops an element.
//
// Design, the on-chip regime (every path shape): a block of 32 x 16
// threads takes 32 neighbouring (n, h*w) positions (a block may straddle
// two images); the 16 threads of a position take every 16th channel, K of
// them each (K the least power of 2 with 16 K >= C, at most 32: C <= 512).
// Each thread issues all of its 2K loads before it adds anything (a warp
// reads 32 neighbouring addresses of one channel: H*W is odd on the SSD
// path, so no 16-byte access lines up), keeps the values in registers, sums
// x^2 and g*x over its channels in order, and the 16 partial pairs are
// added in slice order in shared memory; then dx is written from the values
// still in registers. So x and g come from device memory once. The
// two-pass regime, for channel counts past 512, sums first and reads x and
// g a second time to write dx (the layout of l2norm_channel.cu). Both
// regimes add in the same order, so they give the same bits. Shared-memory
// storage and other block shapes lost to this setting at every shape tried
// on the H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPos = 32;
constexpr int kSlices = 16;

template <int K>
__global__ void __launch_bounds__(kPos * kSlices)
l2norm_channel_bwd_onchip_kernel(const float* __restrict__ x,
                                 const float* __restrict__ g,
                                 float* __restrict__ dx, long long n, int c,
                                 long long hw, float eps, float scale) {
  __shared__ float part_xx[kSlices][kPos];
  __shared__ float part_gx[kSlices][kPos];
  const long long pos = (long long)blockIdx.x * kPos + threadIdx.x;
  const bool live = pos < n * hw;
  const long long img = live ? pos / hw : 0, p = live ? pos - img * hw : 0;
  const long long first = img * c * hw + p + (long long)threadIdx.y * hw;
  const long long step = (long long)kSlices * hw;
  float xv[K], gv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = live && (int)threadIdx.y + j * kSlices < c;
    const long long i = first + j * step;
    xv[j] = in ? x[i] : 0.f;
    gv[j] = in ? g[i] : 0.f;
  }
  float sxx = 0.f, sgx = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (live && (int)threadIdx.y + j * kSlices < c) {
      sxx = __fadd_rn(sxx, __fmul_rn(xv[j], xv[j]));
      sgx = __fadd_rn(sgx, __fmul_rn(gv[j], xv[j]));
    }
  }
  part_xx[threadIdx.y][threadIdx.x] = sxx;
  part_gx[threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (!live) return;
  float txx = 0.f, tgx = 0.f;
  for (int s = 0; s < kSlices; ++s) {
    txx = __fadd_rn(txx, part_xx[s][threadIdx.x]);
    tgx = __fadd_rn(tgx, part_gx[s][threadIdx.x]);
  }
  const float norm = __fsqrt_rn(__fadd_rn(txx, eps));
  const float n3 = __fmul_rn(__fmul_rn(norm, norm), norm);
  const float coef = __fdiv_rn(__fmul_rn(scale, tgx), n3);
  const float gsc = __fdiv_rn(scale, norm);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if ((int)threadIdx.y + j * kSlices < c)
      dx[first + j * step] =
          __fsub_rn(__fmul_rn(gsc, gv[j]), __fmul_rn(xv[j], coef));
  }
}

// the two-pass regime: the sums first, then a second read of x and g to
// write dx
__global__ void __launch_bounds__(kPos * kSlices)
l2norm_channel_bwd_two_pass_kernel(const float* __restrict__ x,
                                   const float* __restrict__ g,
                                   float* __restrict__ dx, long long n,
                                   long long c, long long hw, float eps,
                                   float scale) {
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

using Kernel = void (*)(const float*, const float*, float*, long long, int,
                        long long, float, float);

// K in {1, 2, 4, ..., 32}: at most 32 of x and 32 of g in registers
Kernel onchip_of(long long k) {
  switch (k) {
    case 1: return l2norm_channel_bwd_onchip_kernel<1>;
    case 2: return l2norm_channel_bwd_onchip_kernel<2>;
    case 4: return l2norm_channel_bwd_onchip_kernel<4>;
    case 8: return l2norm_channel_bwd_onchip_kernel<8>;
    case 16: return l2norm_channel_bwd_onchip_kernel<16>;
    case 32: return l2norm_channel_bwd_onchip_kernel<32>;
    default: return nullptr;
  }
}

// the packed arguments of mxt_l2norm_channel_bwd_f32
// (kernels/l2norm_channel.py _BWD_PACK, "=3Q3q2d2qQ")
struct Packed {
  unsigned long long x, g, dx;
  long long n, c, hw;
  double eps, scale;
  long long regime, k;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 11 * 8, "Packed: 11 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch, as planned by the wrapper (regime 0: on chip, k channels a
// thread; regime 1: two passes). Returns cudaErrorInvalidValue for a plan
// that does not fit this call.
extern "C" int mxt_l2norm_channel_bwd_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long n = in.n, c = in.c, hw = in.hw;
  if (n <= 0 || c <= 0 || hw <= 0) return (int)cudaGetLastError();
  const float eps = (float)in.eps, scale = (float)in.scale;
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  const float* x = ptr<const float>(in.x);
  const float* g = ptr<const float>(in.g);
  float* dx = ptr<float>(in.dx);
  const long long grid = (n * hw + kPos - 1) / kPos;
  const dim3 block(kPos, kSlices);
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (in.regime == 1) {
    l2norm_channel_bwd_two_pass_kernel<<<(unsigned)grid, block, 0, st>>>(
        x, g, dx, n, c, hw, eps, scale);
    return (int)cudaGetLastError();
  }
  const Kernel kern = in.regime == 0 ? onchip_of(in.k) : nullptr;
  if (kern == nullptr || kSlices * in.k < c) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, block, 0, st>>>(x, g, dx, n, (int)c, hw, eps,
                                         scale);
  return (int)cudaGetLastError();
}
