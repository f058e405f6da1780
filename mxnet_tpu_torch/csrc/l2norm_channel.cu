// Channel L2 normalization with a fused scale, NCHW float32.
//
// Replaces mxnet_tpu/ops/defs_nn.py:_l2_normalization in mode "channel"
// together with the `* 20.0` (`_mul_scalar`) that follows it on the SSD
// path (mxnet_tpu/models/ssd.py:132-133); see
// mxnet_tpu_torch/kernels/l2norm_channel.py for the wrapper, the plain
// version and the planner that picks the regime and the tile.
//
//   y[n, c, p] = (x[n, c, p] / sqrt(sum_c x[n, c, p]^2 + eps)) * scale
//
// The square, the sum, the sqrt, the division and the scale are each
// rounded once with round-to-nearest intrinsics (no FMA contraction), in
// this order: the reference's two roundings, not x * (scale / norm). The
// thread of slice j sums the squares of channels j, j + 16, j + 32, ... in
// order; the 16 partial sums are added in slice order 0..15.
//
// Bound: device-memory bandwidth. The function reads x once and writes y
// once, 8 bytes an element for ~4 flops: at SSD-300's conv4_3 in training,
// (32, 512, 37, 37), 89.7 MB each way (0.0536 ms at 3.35 TB/s); in serving
// at bucket 8, 22.4 MB each way.
//
// Design, the on-chip regime (C <= 512, every path shape): a block of POS
// neighbouring (n, h*w) positions x 16 channel slices (a block may
// straddle two images); the thread of slice j holds its K channels (K the
// least power of 2 with 16 K >= C: 32 at C = 512) in registers from the
// load to the store. It issues all K loads before it adds anything (a
// warp reads POS neighbouring addresses of 32 / POS channels: H*W is odd
// on the SSD path, so no 16-byte access lines up), the partial sums meet
// in shared memory, and y is written from the values still in registers,
// so x comes from device memory once. POS is 64 on large grids (SSD
// training: neighbouring warps of a block share the 32-byte sectors that
// H*W's odd stride splits), 32 on middle ones (serving at bucket 8) and
// narrower where wider blocks would leave SMs idle (serving at bucket 1:
// 1369 positions); PERF.md has the readings. The two-pass regime, for
// channel counts past 512, sums first and reads x a second time to write
// y. Both regimes add in the same order, so they give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlices = 16;  // channel slices per position
constexpr int kWidePos = 32;  // positions per block of the two-pass regime

// (image, position in the image) of flat position `pos` < n * hw
__device__ __forceinline__ void split(long long pos, long long n,
                                      long long hw, long long* img,
                                      long long* p) {
  if (n * hw <= 0xffffffffLL) {  // 32-bit division
    const unsigned q = (unsigned)pos / (unsigned)hw;
    *img = q;
    *p = pos - (long long)q * hw;
  } else {
    *img = pos / hw;
    *p = pos - *img * hw;
  }
}

// x / norm correctly rounded. Where norm > 0 (NaN fails the test) a zero x
// is its own quotient, sign and all: __fdiv_rn takes its slow path for a
// zero dividend, and half of the SSD path's inputs (ReLU outputs) are zero.
// A norm of 0 or NaN takes the division, which gives NaN as the reference
// does. norm is the same for every thread of a position.
__device__ __forceinline__ float quotient(float x, float norm) {
  return (x == 0.f && norm > 0.f) ? x : __fdiv_rn(x, norm);
}

template <int K, int POS>
__global__ void __launch_bounds__(POS * kSlices)
l2norm_channel_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n, int c, long long hw, float eps,
                      float scale) {
  __shared__ float part[kSlices][POS];
  const long long pos = (long long)blockIdx.x * POS + threadIdx.x;
  const bool live = pos < n * hw;
  long long img = 0, p = 0;
  if (live) split(pos, n, hw, &img, &p);
  const long long first = img * c * hw + p + (long long)threadIdx.y * hw;
  const long long step = (long long)kSlices * hw;
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = live && (int)threadIdx.y + j * kSlices < c;
    v[j] = in ? x[first + j * step] : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if ((int)threadIdx.y + j * kSlices < c)
      s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (!live) return;
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < kSlices; ++j)
    total = __fadd_rn(total, part[j][threadIdx.x]);
  const float norm = __fsqrt_rn(__fadd_rn(total, eps));
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if ((int)threadIdx.y + j * kSlices < c)
      y[first + j * step] = __fmul_rn(quotient(v[j], norm), scale);
  }
}

// the two-pass regime: the sums first, then a second read of x to write y
__global__ void __launch_bounds__(kWidePos * kSlices)
l2norm_channel_kernel_two_pass(const float* __restrict__ x,
                               float* __restrict__ y, long long n,
                               long long c, long long hw, float eps,
                               float scale) {
  __shared__ float part[kSlices][kWidePos];
  const long long pos = (long long)blockIdx.x * kWidePos + threadIdx.x;
  const bool live = pos < n * hw;
  long long img = 0, p = 0;
  if (live) split(pos, n, hw, &img, &p);
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
    yc[k * hw] = __fmul_rn(quotient(xc[k * hw], norm), scale);
}

using Kernel = void (*)(const float*, float*, long long, int, long long,
                        float, float);

template <int POS>
Kernel onchip_at(long long k) {
  switch (k) {
    case 1: return l2norm_channel_kernel<1, POS>;
    case 2: return l2norm_channel_kernel<2, POS>;
    case 4: return l2norm_channel_kernel<4, POS>;
    case 8: return l2norm_channel_kernel<8, POS>;
    case 16: return l2norm_channel_kernel<16, POS>;
    case 32: return l2norm_channel_kernel<32, POS>;
    default: return nullptr;
  }
}

// K in {1, 2, 4, ..., 32}: at most 32 of x in registers; POS in {16, 32,
// 64}
Kernel onchip_of(long long k, long long pos) {
  switch (pos) {
    case 16: return onchip_at<16>(k);
    case 32: return onchip_at<32>(k);
    case 64: return onchip_at<64>(k);
    default: return nullptr;
  }
}

// The wrapper's packed arguments, struct format "=2Q3q2d3qQ": x, y, n, c,
// hw, eps, scale, the plan's regime (0: on chip, 1: two passes), k and
// positions per block, the stream.
struct Packed {
  unsigned long long x, y;
  long long n, c, hw;
  double eps, scale;
  long long regime, k, pos;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 11 * 8, "Packed: 11 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch, as planned by the wrapper. Returns cudaErrorInvalidValue for
// a plan that does not fit this call.
extern "C" int mxt_l2norm_channel_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long n = in.n, c = in.c, hw = in.hw;
  if (n <= 0 || c <= 0 || hw <= 0) return (int)cudaGetLastError();
  const float eps = (float)in.eps, scale = (float)in.scale;
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  const float* x = ptr<const float>(in.x);
  float* y = ptr<float>(in.y);
  if (in.regime == 1) {
    const long long grid = (n * hw + kWidePos - 1) / kWidePos;
    if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    l2norm_channel_kernel_two_pass<<<(unsigned)grid, dim3(kWidePos, kSlices),
                                     0, st>>>(x, y, n, c, hw, eps, scale);
    return (int)cudaGetLastError();
  }
  const Kernel kern = in.regime == 0 ? onchip_of(in.k, in.pos) : nullptr;
  if (kern == nullptr || kSlices * in.k < c) return (int)cudaErrorInvalidValue;
  const long long grid = (n * hw + in.pos - 1) / in.pos;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, dim3((unsigned)in.pos, kSlices), 0, st>>>(
      x, y, n, (int)c, hw, eps, scale);
  return (int)cudaGetLastError();
}
