// BatchNorm's normalize and affine with an optional fused (leaky) ReLU,
// NCHW float32.
//
// Replaces the normalize and affine of mxnet_tpu/ops/defs_nn.py:_batch_norm
// together with the Activation(relu) or LeakyReLU(act_type="leaky") that
// follows it; see mxnet_tpu_torch/kernels/bn_act.py for the wrapper, the
// plain version and the planner that picks the regime.
//
//   t = ((x - mean) * (1 / sqrt(var + eps))) * gamma + beta
//   y = t > 0 ? t : slope * t          (slope >= 0; ReLU is slope 0)
//
// A negative (or NaN) slope means no activation. The operations run in
// exactly this order with round-to-nearest intrinsics (no FMA
// contraction), so the result matches the reference formula at float32
// rounding, and every regime gives the same bits. Slope 0 keeps the ReLU's
// +0.0 for negative t (0 * t would give -0.0). The leaky route (slope > 0)
// runs under its own kernel name, bn_act_leaky_kernel, so that a profile
// tells it from the ReLU's.
//
// Bound: device-memory bandwidth (8 bytes moved per element, a handful of
// flops). Design: the grid covers the tensor's elements flat, in units of
// a float4 (regime vec: H*W a multiple of 4 and x, y 16-byte aligned, so
// every plane starts on a 16-byte boundary) or of a float (regime scalar:
// 7x7 planes, views off the alignment), and every lane of every warp
// works whatever the plane's length: a warp's round crosses plane borders
// where planes are short (DCGAN's 4x4, ResNet's 7x7). A block of `threads`
// takes kUnits * threads neighbouring units, each thread kUnits of them
// `threads` apart, all loaded before any is used. A unit's plane is its
// index over H*W / unit by a 32-bit multiply-high with a magic number the
// planner prepares on the host (no 64-bit division), and a plane's channel
// the plane modulo C the same way. While the loads are in flight the block
// computes the constants of each plane it touches once, into shared
// memory (on the H100 this beat every thread computing its own at every
// path shape, most at 7x7: PERF.md). Regime wide (2^31 units or more)
// walks the elements with 64-bit indices and divisions, each thread
// computing its constants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnits = 4;  // units a thread has in flight
enum Regime { kVec = 0, kScalar = 1, kWide = 2 };

struct Args {
  const float* x;
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  float* y;
  unsigned units;            // float4s (vec) or floats (scalar)
  unsigned d_magic, c_magic;  // plane = unit / d, channel = plane % C:
  int d_shift, c_shift;       //   q / d == (umulhi(q, magic) + q) >> shift
  unsigned channels;
  long long total, hw;       // regime wide: elements, H*W
  float eps, slope;
  int fix_gamma;
};

__device__ __forceinline__ unsigned quotient(unsigned q, unsigned magic,
                                             int shift) {
  return (__umulhi(q, magic) + q) >> shift;
}

// the channel's mean, 1 / sqrt(var + eps), gamma (1 under fix_gamma), beta
__device__ __forceinline__ float4 constants(const Args& a, unsigned c) {
  const float inv =
      __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__ldg(a.var + c), a.eps)));
  return make_float4(__ldg(a.mean + c), inv,
                     a.fix_gamma ? 1.f : __ldg(a.gamma + c),
                     __ldg(a.beta + c));
}

// ACT 0: none, 1: the ReLU, 2: the leaky ReLU
template <int ACT>
__device__ __forceinline__ float bn_one(float x, float4 k, float slope) {
  const float y =
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, k.x), k.y), k.z), k.w);
  // NaN, +0.0 and -0.0 pass as they are: where(t > 0, t, slope * t) gives
  // the same for them, and max(t, 0) keeps NaN.
  if (ACT == 0 || !(y < 0.f)) return y;
  return ACT == 1 ? 0.f : __fmul_rn(slope, y);
}

template <int ACT>
__device__ __forceinline__ float4 bn_four(float4 v, float4 k, float slope) {
  return make_float4(bn_one<ACT>(v.x, k, slope), bn_one<ACT>(v.y, k, slope),
                     bn_one<ACT>(v.z, k, slope), bn_one<ACT>(v.w, k, slope));
}

template <int ACT>
__device__ __forceinline__ float bn_unit(float v, float4 k, float slope) {
  return bn_one<ACT>(v, k, slope);
}

template <int ACT>
__device__ __forceinline__ float4 bn_unit(float4 v, float4 k, float slope) {
  return bn_four<ACT>(v, k, slope);
}

// regimes vec (V = float4) and scalar (V = float)
template <typename V, int ACT>
__device__ __forceinline__ void flat(const Args& a) {
  __shared__ float4 chan[kMaxThreads * kUnits];  // the block's planes
  const V* __restrict__ xv = reinterpret_cast<const V*>(a.x);
  V* __restrict__ yv = reinterpret_cast<V*>(a.y);
  const unsigned first = blockIdx.x * blockDim.x * kUnits;
  const unsigned base = first + threadIdx.x;
  V v[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned q = base + u * blockDim.x;
    if (q < a.units) v[u] = xv[q];
  }
  // a block of kUnits * threads units touches at most that many planes
  const unsigned last = min(first + blockDim.x * kUnits, a.units) - 1;
  const unsigned p0 = quotient(first, a.d_magic, a.d_shift);
  const unsigned planes = quotient(last, a.d_magic, a.d_shift) - p0 + 1;
  for (unsigned j = threadIdx.x; j < planes; j += blockDim.x) {
    const unsigned p = p0 + j;
    chan[j] = constants(a, p - quotient(p, a.c_magic, a.c_shift) * a.channels);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned q = base + u * blockDim.x;
    if (q < a.units)
      yv[q] = bn_unit<ACT>(v[u], chan[quotient(q, a.d_magic, a.d_shift) - p0],
                           a.slope);
  }
}

template <int ACT>
__device__ __forceinline__ void wide(const Args& a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.total; i += stride) {
    const unsigned c = (unsigned)((i / a.hw) % a.channels);
    a.y[i] = bn_one<ACT>(a.x[i], constants(a, c), a.slope);
  }
}

template <int REGIME, int ACT>
__device__ __forceinline__ void run(const Args& a) {
  if constexpr (REGIME == kVec)
    flat<float4, ACT>(a);
  else if constexpr (REGIME == kScalar)
    flat<float, ACT>(a);
  else
    wide<ACT>(a);
}

// no activation (ACT 0) or the ReLU (ACT 1)
template <int REGIME, int ACT>
__global__ void __launch_bounds__(kMaxThreads) bn_act_kernel(const Args a) {
  run<REGIME, ACT>(a);
}

// the leaky ReLU, slope > 0
template <int REGIME>
__global__ void __launch_bounds__(kMaxThreads)
bn_act_leaky_kernel(const Args a) {
  run<REGIME, 2>(a);
}

using Kernel = void (*)(const Args);

template <int REGIME>
Kernel kernel_of(int act) {
  if (act == 2) return bn_act_leaky_kernel<REGIME>;
  return act == 1 ? bn_act_kernel<REGIME, 1> : bn_act_kernel<REGIME, 0>;
}

// The wrapper's packed arguments, struct format "=6Qdqd10qQ": x, mean,
// var, gamma, beta, y, eps, fix_gamma, slope (negative: no activation), n,
// c, hw, the plan's regime, threads, grid, d_magic, d_shift, c_magic,
// c_shift, the stream.
struct Packed {
  unsigned long long x, mean, var, gamma, beta, y;
  double eps;
  long long fix_gamma;
  double slope;
  long long n, c, hw, regime, threads, grid, d_magic, d_shift, c_magic,
      c_shift;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 20 * 8, "Packed: 20 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch, as planned by the wrapper. Returns cudaErrorInvalidValue for
// a plan that does not fit this call.
extern "C" int mxt_bn_act_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long n = in.n, c = in.c, hw = in.hw;
  const long long total = n * c * hw;
  if (n <= 0 || c <= 0 || hw <= 0) return (int)cudaGetLastError();
  const long long threads = in.threads, grid = in.grid;
  const long long units = in.regime == kVec ? total / 4 : total;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      grid < 1 || grid >= (1LL << 31) || c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (in.regime == kVec &&
      (hw % 4 != 0 || (in.x | in.y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (in.regime != kWide &&
      (units > 0x7fffffffLL ||
       grid != (units + threads * kUnits - 1) / (threads * kUnits)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = ptr<const float>(in.x);
  a.mean = ptr<const float>(in.mean);
  a.var = ptr<const float>(in.var);
  a.gamma = ptr<const float>(in.gamma);
  a.beta = ptr<const float>(in.beta);
  a.y = ptr<float>(in.y);
  a.units = (unsigned)units;
  a.d_magic = (unsigned)in.d_magic;
  a.d_shift = (int)in.d_shift;
  a.c_magic = (unsigned)in.c_magic;
  a.c_shift = (int)in.c_shift;
  a.channels = (unsigned)c;
  a.total = total;
  a.hw = hw;
  a.eps = (float)in.eps;
  const float slope = (float)in.slope;
  a.slope = slope > 0.f ? slope : 0.f;
  a.fix_gamma = (int)in.fix_gamma;
  const int act = slope > 0.f ? 2 : slope == 0.f ? 1 : 0;
  Kernel kern;
  if (in.regime == kVec)
    kern = kernel_of<kVec>(act);
  else if (in.regime == kScalar)
    kern = kernel_of<kScalar>(act);
  else if (in.regime == kWide)
    kern = kernel_of<kWide>(act);
  else
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, (unsigned)threads, 0, ptr<CUstream_st>(in.stream)>>>(
      a);
  return (int)cudaGetLastError();
}
