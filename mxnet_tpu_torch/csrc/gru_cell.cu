// GRU cell step, forward and backward, float32.
//
// Replaces the gate chain of one GRUCell step, mxnet_tpu/rnn/rnn_cell.py
// GRUCell.__call__ (:301-330) — the same arithmetic as the gru scan body of
// mxnet_tpu/ops/defs_rnn.py _run_layer (:112-125) — which XLA fuses into
// one pass and eager PyTorch would run as about twelve launches per step
// (two slices, four adds, two multiplies, a subtraction, two sigmoids and
// a tanh), and its VJP (jax.vjp of the same chain). See
// mxnet_tpu_torch/kernels/gru_cell.py for the wrappers and the plain
// versions. Per (n, j), with the reference's order of operations:
//
//   r = sigmoid(i2h[j] + h2h[j]);  z = sigmoid(i2h[H + j] + h2h[H + j])
//   o = tanh(i2h[2H + j] + r * h2h[2H + j])
//   next_h = o + z * (h_prev - o)
//
// sigmoid(x) = 1 / (1 + exp(-x)), as lax.logistic and torch.sigmoid take it.
// The backward takes the derivatives the way jax.vjp transposes them, with
// g = dnext_h:
//
//   do = g - z * g;  da_o = tanh'(do, o);  da_z = sigmoid'(g * (h_prev - o), z)
//   da_r = sigmoid'(da_o * h2h[2H + j], r)
//   di2h = [da_r, da_z, da_o];  dh2h = [da_r, da_z, r * da_o]
//   dh_prev (the direct part) = z * g
//
// sigmoid' as ct * (s * (1 - s)); tanh' as a + a * t with a = ct * (1 - t).
// The rest of dh_prev flows through the h2h product, outside the kernel.
//
// Bound: launch latency. At N = 32, H = 200 a training forward moves
// 32*200*(3+3+1+1+3)*4 B = 282 KB (205 KB without the saved gates) and a
// backward 32*200*(1+3+1+1+3+3+1)*4 B = 333 KB, about 0.1 us each at
// 3.35 TB/s. Design: one thread per (n, j); consecutive threads take
// consecutive j, so each of the three gate reads at j, H+j and 2H+j is
// coalesced. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn), so no FMA contraction changes a result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float sigmoid_grad(float ct, float s) {
  return __fmul_rn(ct, __fmul_rn(s, __fsub_rn(1.f, s)));
}

__device__ __forceinline__ float tanh_grad(float ct, float t) {
  const float a = __fmul_rn(ct, __fsub_rn(1.f, t));
  return __fadd_rn(a, __fmul_rn(a, t));
}

__global__ void __launch_bounds__(kThreads)
gru_cell_kernel(const float* __restrict__ i2h, const float* __restrict__ h2h,
                const float* __restrict__ h_prev, float* __restrict__ next_h,
                float* __restrict__ act, long long total, int hidden) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / hidden;
  const int j = (int)(idx - n * hidden);
  const long long b = n * 3 * hidden + j;
  const float r = sigmoid_rn(__fadd_rn(i2h[b], h2h[b]));
  const float z = sigmoid_rn(__fadd_rn(i2h[b + hidden], h2h[b + hidden]));
  const float o = tanhf(__fadd_rn(i2h[b + 2 * hidden],
                                  __fmul_rn(r, h2h[b + 2 * hidden])));
  next_h[idx] = __fadd_rn(o, __fmul_rn(z, __fsub_rn(h_prev[idx], o)));
  if (act != nullptr) {
    act[b] = r;
    act[b + hidden] = z;
    act[b + 2 * hidden] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
gru_cell_bwd_kernel(const float* __restrict__ dnext_h,
                    const float* __restrict__ act,
                    const float* __restrict__ h2h,
                    const float* __restrict__ h_prev,
                    float* __restrict__ di2h, float* __restrict__ dh2h,
                    float* __restrict__ dh_prev, long long total,
                    int hidden) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / hidden;
  const int j = (int)(idx - n * hidden);
  const long long b = n * 3 * hidden + j;
  const float r = act[b];
  const float z = act[b + hidden];
  const float o = act[b + 2 * hidden];
  const float ho = h2h[b + 2 * hidden];
  const float g = dnext_h != nullptr ? dnext_h[idx] : 0.f;
  const float zg = __fmul_rn(z, g);
  const float da_z = sigmoid_grad(__fmul_rn(g, __fsub_rn(h_prev[idx], o)), z);
  const float da_o = tanh_grad(__fsub_rn(g, zg), o);
  const float da_r = sigmoid_grad(__fmul_rn(da_o, ho), r);
  di2h[b] = da_r;
  di2h[b + hidden] = da_z;
  di2h[b + 2 * hidden] = da_o;
  dh2h[b] = da_r;
  dh2h[b + hidden] = da_z;
  dh2h[b + 2 * hidden] = __fmul_rn(r, da_o);
  dh_prev[idx] = zg;
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

// The entries take their arguments packed in one struct of 8-byte fields
// (the wrapper packs them with struct.pack): one ctypes argument costs
// less host time than ten. Pointers and the stream are addresses; a
// pointer of 0 is null.
struct CellArgs {
  unsigned long long i2h, h2h, h_prev, next_h, act;
  long long rows, hidden;
  unsigned long long stream;
};

struct CellBwdArgs {
  unsigned long long dnext_h, act, h2h, h_prev, di2h, dh2h, dh_prev;
  long long rows, hidden;
  unsigned long long stream;
};

// the wrapper's struct formats "=5Q2qQ" and "=7Q2qQ"
static_assert(sizeof(CellArgs) == 8 * 8, "CellArgs: 8 fields of 8 bytes");
static_assert(sizeof(CellBwdArgs) == 10 * 8,
              "CellBwdArgs: 10 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// act is null when no backward follows (inference): the gates are then not
// written.
extern "C" int mxt_gru_cell_f32(const void* packed) {
  const CellArgs& a = *static_cast<const CellArgs*>(packed);
  const long long total = a.rows * a.hidden;
  if (total > 0) {
    gru_cell_kernel<<<blocks_for(total), kThreads, 0,
                      ptr<CUstream_st>(a.stream)>>>(
        ptr<const float>(a.i2h), ptr<const float>(a.h2h),
        ptr<const float>(a.h_prev), ptr<float>(a.next_h), ptr<float>(a.act),
        total, (int)a.hidden);
  }
  return (int)cudaGetLastError();
}

// dnext_h may be null: a state no later step consumes has no gradient,
// which counts as zero.
extern "C" int mxt_gru_cell_bwd_f32(const void* packed) {
  const CellBwdArgs& a = *static_cast<const CellBwdArgs*>(packed);
  const long long total = a.rows * a.hidden;
  if (total > 0) {
    gru_cell_bwd_kernel<<<blocks_for(total), kThreads, 0,
                          ptr<CUstream_st>(a.stream)>>>(
        ptr<const float>(a.dnext_h), ptr<const float>(a.act),
        ptr<const float>(a.h2h), ptr<const float>(a.h_prev),
        ptr<float>(a.di2h), ptr<float>(a.dh2h), ptr<float>(a.dh_prev), total,
        (int)a.hidden);
  }
  return (int)cudaGetLastError();
}
