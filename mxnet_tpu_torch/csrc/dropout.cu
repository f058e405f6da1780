// Dropout with counter-based random bits: y and the mask in one pass over x.
//
// Replaces the Bernoulli draw and the products of mxnet_tpu/ops/defs_nn.py
// _dropout (:627-645: mask = bernoulli(keep) / keep, y = x * mask) and of the
// RNN op's dropout between layers, mxnet_tpu/ops/defs_rnn.py (:176-179:
// x * bernoulli(keep) / keep), which XLA fuses into one pass over x with
// the TPU's own random bits. See mxnet_tpu_torch/kernels/dropout.py for the
// wrapper and the plain version, which computes the same bits.
//
// The bits are Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011; Random123's constants): key (k0, k1) the low
// and high words of the 64-bit key, counter (i / 4, stream, serial, step)
// for element i, which takes word i % 4. Element i is kept when
// (word >> 8) * 2^-24 < keep32, keep32 = float32(1 - p); both sides are
// exact in float32, so the test is exact. Then, per element:
//
//   mask = float32(kept) / keep32, in x's type (0 or 1/keep32; NaN for
//          every element at p = 1, where the reference divides 0 by 0)
//   y    = x * mask,              or with divide: (x * kept) / keep32
//
// computed in float32 and rounded once to x's type (float32, float16 or
// bfloat16: the product of two 16-bit values is exact in float32, so the
// rounding is the one of PyTorch's 16-bit product). No FMA contraction
// can enter: each step is an explicitly rounded intrinsic.
//
// Bound: bytes. The kernel reads x and writes y and the mask, 12 bytes an
// element in float32 (8 with divide, which writes no mask): at the LSTM
// LM's (20, 650) 156 KB, 0.047 us at 3.35 TB/s, where a launch's fixed
// cost dominates; at the RNN op's (35, 20, 650) with divide 3.64 MB, 1.09
// us. Ten Philox rounds for four elements are ~40 integer operations an
// element, far below the card's integer rate. Design: a simple grid-stride
// kernel, one Philox call (four elements) a thread and iteration, with
// 16-byte loads and stores where float32 data is 16-byte aligned, scalar
// ones elsewhere (a view at an offset, a ragged end, 16-bit types).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

struct DropoutArgs {
  unsigned long long x, y, mask;
  long long n;
  unsigned long long key;
  long long step, serial, stream;
  double keep;
  long long dtype, divide;
  unsigned long long cuda_stream;
};

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// one element: (y, mask) from x and its word
template <typename T, bool kDivide>
__device__ __forceinline__ void one(T xv, uint32_t word, float keep,
                                    T* y, T* mask) {
  const float kept = __fmul_rn((float)(word >> 8), 5.9604644775390625e-8f) <
                             keep ? 1.0f : 0.0f;
  const float x = to_f<T>(xv);
  if (kDivide) {
    *y = from_f<T>(__fdiv_rn(__fmul_rn(x, kept), keep));
  } else {
    const T m = from_f<T>(__fdiv_rn(kept, keep));
    *mask = m;
    *y = from_f<T>(__fmul_rn(x, to_f<T>(m)));
  }
}

template <typename T, bool kDivide, bool kVec>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ mask, long long n, uint32_t k0, uint32_t k1,
               uint32_t step, uint32_t serial, uint32_t stream, float keep) {
  const long long groups = (n + 3) / 4;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const uint4 w = philox(make_uint4((uint32_t)g, stream, serial, step),
                           k0, k1);
    const long long i = g * 4;
    if (kVec && i + 4 <= n) {
      const float4 xv = reinterpret_cast<const float4*>(x)[g];
      float4 yv, mv;
      one<float, kDivide>(xv.x, w.x, keep, &yv.x, &mv.x);
      one<float, kDivide>(xv.y, w.y, keep, &yv.y, &mv.y);
      one<float, kDivide>(xv.z, w.z, keep, &yv.z, &mv.z);
      one<float, kDivide>(xv.w, w.w, keep, &yv.w, &mv.w);
      reinterpret_cast<float4*>(y)[g] = yv;
      if (!kDivide) reinterpret_cast<float4*>(mask)[g] = mv;
      continue;
    }
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < n) {
        T mv;
        one<T, kDivide>(x[i + k], words[k], keep, &y[i + k], &mv);
        if (!kDivide) mask[i + k] = mv;
      }
    }
  }
}

template <typename T, bool kDivide, bool kVec>
int launch(const DropoutArgs& a) {
  const long long groups = (a.n + 3) / 4;
  // enough blocks to fill the card several times over; the grid strides
  // past that
  const long long blocks =
      std::min<long long>((groups + kThreads - 1) / kThreads, 132LL * 16);
  dropout_kernel<T, kDivide, kVec>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)a.cuda_stream>>>(
          reinterpret_cast<const T*>(a.x), reinterpret_cast<T*>(a.y),
          reinterpret_cast<T*>(a.mask), a.n, (uint32_t)a.key,
          (uint32_t)(a.key >> 32), (uint32_t)a.step, (uint32_t)a.serial,
          (uint32_t)a.stream, (float)a.keep);
  return (int)cudaGetLastError();
}

template <typename T>
int scalar(const DropoutArgs& a) {
  return a.divide ? launch<T, true, false>(a) : launch<T, false, false>(a);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. n up to 2^34 (the counter's
// first word numbers groups of four); the wrapper refuses more. mask may
// be null with divide.
extern "C" int mxt_dropout(const void* packed) {
  const DropoutArgs& a = *static_cast<const DropoutArgs*>(packed);
  if (a.n <= 0) return 0;
  if (a.n > (1LL << 34) || (!a.divide && a.mask == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (a.dtype) {
    case 0: {
      const bool vec = a.x % 16 == 0 && a.y % 16 == 0 &&
                       (a.divide || a.mask % 16 == 0);
      if (vec) {
        return a.divide ? launch<float, true, true>(a)
                        : launch<float, false, true>(a);
      }
      return scalar<float>(a);
    }
    case 1:
      return scalar<__half>(a);
    case 2:
      return scalar<__nv_bfloat16>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
