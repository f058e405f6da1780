// LSTM cell step, forward and backward, float32.
//
// Replaces the gate chain of one LSTMCell step, mxnet_tpu/rnn/rnn_cell.py
// LSTMCell.__call__ (:245-279) — the same arithmetic as the scan body of
// mxnet_tpu/ops/defs_rnn.py _run_layer (:98-108) — which XLA fuses into
// one pass and eager PyTorch would run as about eleven launches per step,
// and its VJP (jax.vjp of the same chain). See
// mxnet_tpu_torch/kernels/lstm_cell.py for the wrappers and the plain
// versions. Per (n, j), with the reference's order of operations:
//
//   gates = i2h + h2h;  f_in = gates[H + j] + forget_bias
//   i = sigmoid(gates[j]); f = sigmoid(f_in); g = tanh(gates[2H + j]);
//   o = sigmoid(gates[3H + j])
//   next_c = f * c_prev + i * g;  next_h = o * tanh(next_c)
//
// sigmoid(x) = 1 / (1 + exp(-x)), as lax.logistic and torch.sigmoid take it.
// The backward takes the derivatives the way jax.vjp transposes them:
// sigmoid' as ct * (s * (1 - s)); tanh' as a + a * t with a = ct * (1 - t).
//
// Bound: launch latency. At N = 32, H = 200 a forward moves 32*200*(8+1+2
// +4)*4 B = 384 KB and a backward 32*200*(2+4+2+4+1)*4 B = 333 KB, about
// 0.1 us each at 3.35 TB/s. Design: one thread per (n, j); consecutive
// threads take consecutive j, so each of the four gate reads at j, H+j,
// 2H+j and 3H+j is coalesced. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn), so no FMA contraction changes a result.

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
lstm_cell_kernel(const float* __restrict__ i2h, const float* __restrict__ h2h,
                 const float* __restrict__ c_prev, float* __restrict__ next_h,
                 float* __restrict__ next_c, float* __restrict__ act,
                 long long total, int hidden, float forget_bias) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / hidden;
  const int j = (int)(idx - n * hidden);
  const long long b = n * 4 * hidden + j;
  const float gi = __fadd_rn(i2h[b], h2h[b]);
  const float gf = __fadd_rn(__fadd_rn(i2h[b + hidden], h2h[b + hidden]),
                             forget_bias);
  const float gg = __fadd_rn(i2h[b + 2 * hidden], h2h[b + 2 * hidden]);
  const float go = __fadd_rn(i2h[b + 3 * hidden], h2h[b + 3 * hidden]);
  const float i = sigmoid_rn(gi);
  const float f = sigmoid_rn(gf);
  const float g = tanhf(gg);
  const float o = sigmoid_rn(go);
  const float c = __fadd_rn(__fmul_rn(f, c_prev[idx]), __fmul_rn(i, g));
  next_c[idx] = c;
  next_h[idx] = __fmul_rn(o, tanhf(c));
  if (act != nullptr) {
    act[b] = i;
    act[b + hidden] = f;
    act[b + 2 * hidden] = g;
    act[b + 3 * hidden] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_kernel(const float* __restrict__ dnext_h,
                     const float* __restrict__ dnext_c,
                     const float* __restrict__ act,
                     const float* __restrict__ c_prev,
                     const float* __restrict__ next_c,
                     float* __restrict__ dgates, float* __restrict__ dc_prev,
                     long long total, int hidden) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / hidden;
  const int j = (int)(idx - n * hidden);
  const long long b = n * 4 * hidden + j;
  const float i = act[b];
  const float f = act[b + hidden];
  const float g = act[b + 2 * hidden];
  const float o = act[b + 3 * hidden];
  const float tc = tanhf(next_c[idx]);
  const float dh = dnext_h != nullptr ? dnext_h[idx] : 0.f;
  float dc = tanh_grad(__fmul_rn(dh, o), tc);
  if (dnext_c != nullptr) dc = __fadd_rn(dnext_c[idx], dc);
  dgates[b] = sigmoid_grad(__fmul_rn(dc, g), i);
  dgates[b + hidden] = sigmoid_grad(__fmul_rn(dc, c_prev[idx]), f);
  dgates[b + 2 * hidden] = tanh_grad(__fmul_rn(dc, i), g);
  dgates[b + 3 * hidden] = sigmoid_grad(__fmul_rn(dh, tc), o);
  dc_prev[idx] = __fmul_rn(dc, f);
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

// The entries take their arguments packed in one struct of 8-byte fields
// (the wrapper packs them with struct.pack): one ctypes argument costs
// less host time than ten. Pointers and the stream are addresses; a
// pointer of 0 is null.
struct CellArgs {
  unsigned long long i2h, h2h, c_prev, next_h, next_c, act;
  long long rows, hidden;
  double forget_bias;
  unsigned long long stream;
};

struct CellBwdArgs {
  unsigned long long dnext_h, dnext_c, act, c_prev, next_c, dgates, dc_prev;
  long long rows, hidden;
  unsigned long long stream;
};

// the wrapper's struct formats "=6Q2qdQ" and "=7Q2qQ"
static_assert(sizeof(CellArgs) == 10 * 8, "CellArgs: 10 fields of 8 bytes");
static_assert(sizeof(CellBwdArgs) == 10 * 8,
              "CellBwdArgs: 10 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// act is null when no backward follows (inference): the gates are then not
// written.
extern "C" int mxt_lstm_cell_f32(const void* packed) {
  const CellArgs& a = *static_cast<const CellArgs*>(packed);
  const long long total = a.rows * a.hidden;
  if (total > 0) {
    lstm_cell_kernel<<<blocks_for(total), kThreads, 0,
                       ptr<CUstream_st>(a.stream)>>>(
        ptr<const float>(a.i2h), ptr<const float>(a.h2h),
        ptr<const float>(a.c_prev), ptr<float>(a.next_h),
        ptr<float>(a.next_c), ptr<float>(a.act), total, (int)a.hidden,
        (float)a.forget_bias);
  }
  return (int)cudaGetLastError();
}

// dnext_h and dnext_c may be null: a state no later step consumes has no
// gradient, which counts as zero.
extern "C" int mxt_lstm_cell_bwd_f32(const void* packed) {
  const CellBwdArgs& a = *static_cast<const CellBwdArgs*>(packed);
  const long long total = a.rows * a.hidden;
  if (total > 0) {
    lstm_cell_bwd_kernel<<<blocks_for(total), kThreads, 0,
                           ptr<CUstream_st>(a.stream)>>>(
        ptr<const float>(a.dnext_h), ptr<const float>(a.dnext_c),
        ptr<const float>(a.act), ptr<const float>(a.c_prev),
        ptr<const float>(a.next_c), ptr<float>(a.dgates),
        ptr<float>(a.dc_prev), total, (int)a.hidden);
  }
  return (int)cudaGetLastError();
}
