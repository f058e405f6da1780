// Vanilla RNN cell step, forward and backward, float32: the recurrent
// product and the activation in one launch each way; and the sequence
// entry, every step of one layer of the RNN op's rnn modes in one launch
// (mxt_rnn_seq_f32, below the step kernels: it replaces the scan of
// mxnet_tpu/ops/defs_rnn.py _run_layer, :90-140, that XLA compiles into
// one loop).
//
// Replaces one RNNCell step, mxnet_tpu/rnn/rnn_cell.py RNNCell.__call__
// (:202-217) from the h2h FullyConnected on — the same arithmetic as the
// rnn_tanh/rnn_relu scan body of mxnet_tpu/ops/defs_rnn.py _run_layer
// (:126-134) — which XLA fuses around its dot, and its VJP (jax.vjp of the
// same chain). Eager PyTorch would run it as the product's GEMM plus an add
// and the activation. See mxnet_tpu_torch/kernels/rnn_cell.py for the
// wrappers and the plain versions. Per (n, j):
//
//   h2h = sum_k h_prev[k] * Wh[j][k] + bh[j]
//   next_h = act(i2h[j] + h2h),  act = tanh or relu
//
// The backward takes the derivative from the output, the way jax.vjp
// transposes it, with g = dnext_h:
//
//   da = tanh'(g, next_h) = a + a * next_h with a = g * (1 - next_h)
//   da = relu'(g, next_h) = g where next_h > 0, else 0 (jax.nn.relu's VJP:
//        0 at exactly 0)
//   dh_prev = sum_c da[c] * Wh[c][j]
//
// da is both di2h and dh2h; dWh = da.T @ h_prev and dbh = sum(da) stay
// outside (torch.mm/sum), as the FC's backward computed them. The
// activation's arithmetic rounds every product and sum on its own
// (__fmul_rn/__fadd_rn/__fsub_rn), so no FMA contraction changes it. The
// products are float32 FMAs on the CUDA cores: no tensor cores, because the
// path runs float32 with TF32 off and its parity with the reference rests on
// that. They sum in a fixed order that differs from cuBLAS's (see each
// kernel), so a result may differ from the plain version's by the rounding
// of a sum of H products.
//
// Bound: bytes, and in practice a launch's fixed costs. At N = 32, H = 200
// a forward reads i2h, h_prev, Wh and bh and writes next_h: 3*N*H + H*H + H
// floats = 237.6 KB, 0.071 us at 3.35 TB/s; a backward reads dnext_h,
// next_h and Wh and writes da and dh_prev: 4*N*H + H*H floats = 262.4 KB,
// 0.078 us. The 2.56 MFLOP of either product take 0.04 us at 67 TFLOP/s.
// Wh (160 KB at H = 200) stays in the 50 MB L2 from step to step. The
// layout is gru_cell.cu's with one gate in place of three: the tiles come in
// by the copy engine (the Tensor Memory Accelerator: bulk and 2D tensor
// copies completing on an mbarrier) in few, large copies, all requested
// before anything else; 4-byte cp.async where H is not a multiple of 4 or a
// pointer is not 16-byte aligned.
//
// Forward design: a block of 256 threads per tile of kFwdJ = 4 hidden units
// and kFwdRows = 16 rows (100 blocks at N = 32, H = 200). The tile's h_prev
// rows and its 4 rows of Wh come into shared memory whole (H floats a row,
// in passes of kFwdMaxK columns past that): unpadded, the h_prev rows are
// one contiguous copy and the Wh rows another. Thread (jl, rg, s) keeps rows
// rg + 4r (r < 4) of partial sums over k = s (mod kFwdS = 16), read from
// shared memory (5 reads for 4 FMAs; the row stride puts a warp's 8
// distinct addresses in 8 banks). The 16 partials of an output are then
// added in s order by the output's own thread, which adds the bias, the
// input projection and the activation; its i2h and bias values are
// requested before the sums start. The order of a product: for each s, k =
// s, s + 16, ... by fmaf from 0; then ((p0 + p1) + ...) + p15; then the
// bias; then i2h + that.
//
// Backward design: a block of 512 threads per kBwdJ = 16 columns of dh_prev
// and up to kBwdRows = 4 rows (104 blocks at N = 32, H = 200). Bulk copies
// bring the block rows' two planes [next_h, dnext_h] (one contiguous copy
// each) and 2D tensor copies the H x 16 slice of Wh, read by columns (boxes
// of kBox x 16; rows and columns past Wh arrive as zeros), all requested at
// the start. Phase A: the block computes da of its rows for all H columns
// into shared memory, and writes da for its own 16 columns only, so each
// element is written by one block. Phase B: thread (jc, s) sums c = s (mod
// kBwdS = 32) for its column over the block's rows, and the 32 partials are
// added in s order: dh_prev = ((p0 + p1) + ...) + p31.

// cuda.h for CUtensorMap and its enums; the encoder comes via the runtime
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cstring>

namespace {

constexpr int kTanh = 0;  // the activation codes of the C entries
constexpr int kRelu = 1;

constexpr int kFwdJ = 4;       // hidden units a block
constexpr int kFwdRows = 16;   // rows a block
constexpr int kFwdR = 4;       // rows a thread: rg, rg + 4, rg + 8, rg + 12
constexpr int kFwdS = 16;      // thread group s sums k = s (mod kFwdS)
constexpr int kFwdThreads = kFwdJ * (kFwdRows / kFwdR) * kFwdS;
constexpr int kFwdOut = kFwdRows * kFwdJ;   // (n, j) outputs a block
constexpr int kFwdTiles = kFwdRows + kFwdJ;  // h_prev rows + Wh rows
constexpr int kFwdMaxK = 1408;  // columns of the tiles a pass

constexpr int kBwdJ = 16;      // columns of dh_prev a block, one a thread
constexpr int kBwdRows = 4;    // rows a block, all of them in each thread
constexpr int kBwdS = 32;      // thread group s sums c = s (mod kBwdS)
constexpr int kBwdThreads = kBwdJ * kBwdS;
constexpr int kBwdOut = kBwdRows * kBwdJ;
constexpr int kBwdMaxC = 1536;  // rows of the Wh slice a pass
constexpr int kBox = 128;       // rows of a tensor copy of the slice

template <int kAct>
__device__ __forceinline__ float activate(float x) {
  // relu: NaN passes through, as jax.nn.relu and torch.relu give it
  return kAct == kTanh ? tanhf(x) : (x <= 0.f ? 0.f : x);
}

// the derivative from the output y = act(x), for the cotangent ct
template <int kAct>
__device__ __forceinline__ float activation_grad(float ct, float y) {
  if (kAct == kRelu) return y > 0.f ? ct : 0.f;
  const float a = __fmul_rn(ct, __fsub_rn(1.f, y));
  return __fadd_rn(a, __fmul_rn(a, y));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- bulk copies (the Tensor Memory Accelerator) completing on an mbarrier
// one arrival a phase; bar_fence() after the inits, before any copy
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void bar_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of a phase, announcing the bytes its copies bring
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned `src` to `dst`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of `map` at (x, y) (columns, rows) to `dst`; parts of the box
// outside the tensor arrive as zeros and count toward the bytes
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map,
                                            int x, int y,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// the 4-byte path, for rows and pointers a bulk copy does not take
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Warp 0: the bulk copies of a pass's tiles (columns k0 .. k0 + kc) on
// `bar`, lane 0 announcing their bytes first.
__device__ __forceinline__ void issue_fwd_tiles(
    float* tile, const float* __restrict__ h_prev,
    const float* __restrict__ w, int hidden, int n0, int j0, int nrows,
    int ncols, int ld, int k0, int kc, unsigned long long* bar) {
  const unsigned bytes = kc * 4;
  const int l = threadIdx.x, q = l - kFwdRows;
  if (l == 0) bar_expect(bar, bytes * (nrows + ncols));
  __syncwarp();
  if (ld == hidden) {
    // whole unpadded rows: the h_prev rows are one run, and so are the Wh
    // rows
    if (l == 0) {
      bulk_copy(tile, h_prev + (long long)n0 * hidden, nrows * bytes, bar);
    } else if (l == 1) {
      bulk_copy(tile + kFwdRows * ld, w + (long long)j0 * hidden,
                ncols * bytes, bar);
    }
  } else if (l < nrows) {
    bulk_copy(tile + l * ld, h_prev + (long long)(n0 + l) * hidden + k0,
              bytes, bar);
  } else if (q >= 0 && q < ncols) {
    bulk_copy(tile + l * ld, w + (long long)(j0 + q) * hidden + k0, bytes,
              bar);
  }
}

// Dynamic shared memory: the tiles, kFwdRows rows of h_prev then the kFwdJ
// rows of Wh, ld floats apart, columns k0 .. k0 + kc of a pass; then the
// partial sums. Threads: jl = t % kFwdJ, rg = t / kFwdJ % 4, s = t / 16. A
// thread keeps rows rg + 4 r of partial sums; at a k it reads 4 h values
// and one weight for 4 FMAs, and ld (a multiple of 4, not of 16) puts the 8
// distinct addresses of a warp's read in 8 banks. The kFwdS partials of an
// output are then added in s order by the output's own thread (o <
// kFwdOut), which applies the bias, the input projection and the
// activation.
template <int kAct, bool kBulk>
__global__ void __launch_bounds__(kFwdThreads)
rnn_cell_kernel(const float* __restrict__ i2h,
                const float* __restrict__ h_prev,
                const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ next_h, int rows, int hidden, int kmax,
                int ld) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar;
  float* tile = smem;
  float* part = smem + kFwdTiles * ld;
  const int j0 = blockIdx.x * kFwdJ, n0 = blockIdx.y * kFwdRows;
  const int nrows = min(kFwdRows, rows - n0);
  const int ncols = min(kFwdJ, hidden - j0);
  if (kBulk && threadIdx.x == 0) {
    bar_init(&bar);
    bar_fence();
  }
  __syncthreads();
  if (kBulk && threadIdx.x < 32) {
    issue_fwd_tiles(tile, h_prev, w, hidden, n0, j0, nrows, ncols, ld, 0,
                    min(kmax, hidden), &bar);
  }
  // the epilogue's operands, requested now so that they arrive during the
  // copies and the sums
  const int o = threadIdx.x;
  const int n = n0 + o / kFwdJ, j = j0 + o % kFwdJ;
  const bool mine = o < kFwdOut && n < rows && j < hidden;
  const long long idx = (long long)n * hidden + j;
  float x = 0.f, bj = 0.f;
  if (mine) {
    x = i2h[idx];
    if (bias != nullptr) bj = bias[j];
  }
  const int jl = threadIdx.x % kFwdJ;
  const int rg = threadIdx.x / kFwdJ % (kFwdRows / kFwdR);
  const int s = threadIdx.x / (kFwdJ * (kFwdRows / kFwdR));
  float acc[kFwdR];
#pragma unroll
  for (int r = 0; r < kFwdR; ++r) acc[r] = 0.f;
  int pass = 0;
  for (int k0 = 0; k0 < hidden; k0 += kmax, ++pass) {
    const int kc = min(kmax, hidden - k0);
    if (kBulk) {
      if (pass > 0 && threadIdx.x < 32) {
        issue_fwd_tiles(tile, h_prev, w, hidden, n0, j0, nrows, ncols, ld,
                        k0, kc, &bar);
      }
      bar_wait(&bar, pass & 1);
    } else {
      for (int i = threadIdx.x; i < kFwdTiles * kc; i += kFwdThreads) {
        const int l = i / kc, c = i - l * kc, q = l - kFwdRows;
        if (l < nrows) {
          cp_async4(tile + l * ld + c,
                    h_prev + (long long)(n0 + l) * hidden + k0 + c);
        } else if (q >= 0 && q < ncols) {
          cp_async4(tile + l * ld + c,
                    w + (long long)(j0 + q) * hidden + k0 + c);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const float* hb = tile + rg * ld;
    const float* wb = tile + (kFwdRows + jl) * ld;
#pragma unroll 4
    for (int k = s; k < kc; k += kFwdS) {
      const float wv = wb[k];
#pragma unroll
      for (int r = 0; r < kFwdR; ++r) {
        acc[r] = fmaf(hb[4 * r * ld + k], wv, acc[r]);
      }
    }
    __syncthreads();  // the tiles are free for the next pass
  }
#pragma unroll
  for (int r = 0; r < kFwdR; ++r) {
    part[s * kFwdOut + (rg + 4 * r) * kFwdJ + jl] = acc[r];
  }
  __syncthreads();
  if (!mine) return;
  float sum = part[o];
#pragma unroll
  for (int q = 1; q < kFwdS; ++q) sum = __fadd_rn(sum, part[q * kFwdOut + o]);
  if (bias != nullptr) sum = __fadd_rn(sum, bj);
  next_h[idx] = activate<kAct>(__fadd_rn(x, sum));
}

// One pass of the block's Wh slice: rows c0 .. c0 + cc, columns j0 ..
// j0 + ncols, into `dst` (rows kBwdJ floats apart). kBulk: thread 0 asks
// for ceil(cc / kBox) tensor copies of kBwdJ x kBox boxes (the copy engine
// walks the rows' stride itself; one copy a 64-byte row costs far more) on
// `bar`; else 4-byte copies, committed as one group.
template <bool kBulk>
__device__ __forceinline__ void load_w_slice(float* dst,
                                             const CUtensorMap* map,
                                             const float* __restrict__ w,
                                             int hidden, int j0, int ncols,
                                             int c0, int cc,
                                             unsigned long long* bar) {
  if (kBulk) {
    if (threadIdx.x == 0) {
      const int boxes = (cc + kBox - 1) / kBox;
      bar_expect(bar, (unsigned)boxes * kBox * kBwdJ * 4);
      for (int b = 0; b < boxes; ++b) {
        tensor_copy(dst + b * kBox * kBwdJ, map, j0, c0 + b * kBox, bar);
      }
    }
  } else {
    for (int i = threadIdx.x; i < cc * kBwdJ; i += kBwdThreads) {
      const int r = i / kBwdJ, q = i % kBwdJ;
      if (q < ncols) {
        cp_async4(dst + i, w + (long long)(c0 + r) * hidden + j0 + q);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Dynamic shared memory: with kBulk, the planes [next_h, dnext_h] of the
// block's rows (2 x rb x H, one bulk copy each); da of those rows (rb x H);
// a pass of the Wh slice (cmax x kBwdJ); the partial sums (kBwdS x
// kBwdOut). Phase B's threads: jc = t % kBwdJ (the column), s = t / kBwdJ
// (c = s mod kBwdS); each keeps rb partial sums and at a c reads rb values
// of da and one weight (a warp's 32 weights are 32 consecutive floats) for
// rb FMAs.
template <int kAct, bool kBulk>
__global__ void __launch_bounds__(kBwdThreads)
rnn_cell_bwd_kernel(const float* __restrict__ dnext_h,
                    const float* __restrict__ next_h,
                    const float* __restrict__ w, float* __restrict__ da,
                    float* __restrict__ dh_prev, int rows, int hidden, int rb,
                    int cmax, const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar, wbar;
  const int j0 = blockIdx.x * kBwdJ, n0 = blockIdx.y * rb;
  const int nrows = min(rb, rows - n0);
  const int ncols = min(kBwdJ, hidden - j0);
  const int span = nrows * hidden;  // floats of a plane's block rows
  const long long at = (long long)n0 * hidden;
  // the slice's tensor copies land 128-byte aligned, first
  float* wt = smem + ((128 - (smem_addr(smem) & 127)) & 127) / 4;
  float* planes = wt + (cmax + kBox - 1) / kBox * kBox * kBwdJ;
  float* dg = planes + (kBulk ? 2 * rb * hidden : 0);
  float* part = dg + rb * hidden;
  if (kBulk && threadIdx.x == 0) {
    bar_init(&bar);
    bar_init(&wbar);
    bar_fence();
    bar_expect(&bar, (dnext_h != nullptr ? 2u : 1u) * span * 4);
  }
  __syncthreads();
  if (kBulk && threadIdx.x == 0) {
    bulk_copy(planes, next_h + at, span * 4, &bar);
  } else if (kBulk && threadIdx.x == 1 && dnext_h != nullptr) {
    bulk_copy(planes + rb * hidden, dnext_h + at, span * 4, &bar);
  }
  load_w_slice<kBulk>(wt, &wmap, w, hidden, j0, ncols, 0, min(cmax, hidden),
                      &wbar);
  const int o = threadIdx.x;  // thread o < kBwdOut owns output o
  const int n = n0 + o / kBwdJ, j = j0 + o % kBwdJ;
  const bool mine = o < kBwdOut && o / kBwdJ < rb && n < rows && j < hidden;

  // phase A: da of the block's rows, every column
  if (kBulk) {
    if (dnext_h == nullptr) {
      for (int e = threadIdx.x; e < span; e += kBwdThreads) {
        planes[rb * hidden + e] = 0.f;
      }
    }
    bar_wait(&bar, 0);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < span; e += kBwdThreads) {
    float y, g;
    if (kBulk) {
      y = planes[e];
      g = planes[rb * hidden + e];
    } else {
      y = next_h[at + e];
      g = dnext_h != nullptr ? dnext_h[at + e] : 0.f;
    }
    const float d = activation_grad<kAct>(g, y);
    dg[e] = d;
    const int jj = e % hidden;
    if (jj >= j0 && jj < j0 + kBwdJ) da[at + e] = d;
  }

  // phase B, a pass of the Wh slice at a time
  const int jc = threadIdx.x % kBwdJ;
  const int s = threadIdx.x / kBwdJ;
  float acc[kBwdRows];
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.f;
  for (int c0 = 0, pass = 0; c0 < hidden; c0 += cmax, ++pass) {
    const int cc = min(cmax, hidden - c0);
    if (pass > 0) {
      load_w_slice<kBulk>(wt, &wmap, w, hidden, j0, ncols, c0, cc, &wbar);
    }
    if (kBulk) {
      bar_wait(&wbar, pass & 1);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // and, in the first pass, da is done
#pragma unroll 4
    for (int c = s; c < cc; c += kBwdS) {
      const float wv = wt[c * kBwdJ + jc];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        acc[r] = fmaf(dg[min(r, rb - 1) * hidden + c0 + c], wv, acc[r]);
      }
    }
    __syncthreads();  // the slice's buffer is free for the next pass
  }
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    part[(s * kBwdRows + r) * kBwdJ + jc] = acc[r];
  }
  __syncthreads();
  if (!mine) return;
  float sum = part[o];
#pragma unroll
  for (int q = 1; q < kBwdS; ++q) sum = __fadd_rn(sum, part[q * kBwdOut + o]);
  dh_prev[(long long)n * hidden + j] = sum;
}

constexpr int kMaxDevices = 64;
// the dynamic shared memory each kernel variant (activation x direction x
// copy path) is opted into on each device so far
std::atomic<long long> g_smem_set[8][kMaxDevices];

// opts `kernel` (index `which`) into `smem` bytes of dynamic shared memory
// on the current device, once per device and size beyond the default 48 KB
int ensure_smem(const void* kernel, int which, long long smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::atomic<long long>* set =
      dev < kMaxDevices ? &g_smem_set[which][dev] : nullptr;
  if (set != nullptr && set->load() >= smem) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (set != nullptr) {
    long long seen = set->load();
    while (seen < smem && !set->compare_exchange_weak(seen, smem)) {
    }
  }
  return 0;
}

// the largest dynamic shared memory a block may ask for on this device
int smem_optin() {
  static const int optin = [] {
    int dev = 0, v = 48 * 1024;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
    }
    return v;
  }();
  return optin;
}

// The entries take their arguments packed in one struct of 8-byte fields
// (the wrapper packs them with struct.pack): one ctypes argument costs
// less host time than nine. Pointers and the stream are addresses; a
// pointer of 0 is null.
struct CellArgs {
  unsigned long long i2h, h_prev, weight, bias, next_h;
  long long rows, hidden, act;
  unsigned long long stream;
};

struct CellBwdArgs {
  unsigned long long dnext_h, next_h, weight, da, dh_prev;
  long long rows, hidden, act;
  unsigned long long stream;
};

// the wrapper's struct format "=5Q3qQ", both ways
static_assert(sizeof(CellArgs) == 9 * 8, "CellArgs: 9 fields of 8 bytes");
static_assert(sizeof(CellBwdArgs) == 9 * 8,
              "CellBwdArgs: 9 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

bool aligned16(unsigned long long p) { return p % 16 == 0; }

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of Wh (H rows of H floats) in kBwdJ x kBox boxes; the
// last one made is kept for the next call (the path passes the same
// weight step after step). Returns false when the driver refuses.
bool w_map(unsigned long long weight, long long hidden, CUtensorMap* out) {
  thread_local unsigned long long key_ptr = 0;
  thread_local long long key_hidden = 0;
  thread_local CUtensorMap held;
  if (key_ptr == weight && key_hidden == hidden) {
    *out = held;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)hidden, (cuuint64_t)hidden};
  const cuuint64_t strides[1] = {(cuuint64_t)hidden * 4};
  const cuuint32_t box[2] = {kBwdJ, kBox};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(&held, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
         reinterpret_cast<void*>(static_cast<uintptr_t>(weight)), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    key_ptr = 0;
    return false;
  }
  key_ptr = weight;
  key_hidden = hidden;
  *out = held;
  return true;
}

template <int kAct, bool kBulk>
int launch_fwd(const CellArgs& a, dim3 grid, long long smem, int kmax,
               int ld) {
  const void* kernel = (const void*)rnn_cell_kernel<kAct, kBulk>;
  const int err = ensure_smem(kernel, kAct * 4 + (kBulk ? 1 : 0), smem);
  if (err != 0) return err;
  rnn_cell_kernel<kAct, kBulk>
      <<<grid, kFwdThreads, smem, ptr<CUstream_st>(a.stream)>>>(
          ptr<const float>(a.i2h), ptr<const float>(a.h_prev),
          ptr<const float>(a.weight), ptr<const float>(a.bias),
          ptr<float>(a.next_h), (int)a.rows, (int)a.hidden, kmax, ld);
  return (int)cudaGetLastError();
}

template <int kAct, bool kBulk>
int launch_bwd(const CellBwdArgs& a, dim3 grid, long long smem, int rb,
               int cmax, const CUtensorMap& map) {
  const void* kernel = (const void*)rnn_cell_bwd_kernel<kAct, kBulk>;
  const int err = ensure_smem(kernel, kAct * 4 + 2 + (kBulk ? 1 : 0), smem);
  if (err != 0) return err;
  rnn_cell_bwd_kernel<kAct, kBulk>
      <<<grid, kBwdThreads, smem, ptr<CUstream_st>(a.stream)>>>(
          ptr<const float>(a.dnext_h), ptr<const float>(a.next_h),
          ptr<const float>(a.weight), ptr<float>(a.da),
          ptr<float>(a.dh_prev), (int)a.rows, (int)a.hidden, rb, cmax, map);
  return (int)cudaGetLastError();
}

// --- the sequence entry: one launch runs every step of a layer -----------
//
// Thread-block clusters of 8 or 16 CTAs (seq_plan picks). A cluster owns
// one direction and a block of `rows` batch rows; CTA rank c owns the hidden
// units [c * units, (c + 1) * units) and keeps their rows of Wh in shared
// memory for the whole sequence, each row padded to ld = round16(H) + 8
// floats (ld = 8 mod 16: the float4 reads of a quarter-warp, two groups
// on rows 2 apart, fall in the two halves of the banks). Every CTA also
// holds the cluster's whole state h (rows x H) twice: step i reads buffer
// i % 2, and each CTA sends its slice of its output into buffer (i + 1) % 2
// of every CTA of the cluster by st.async (a remote store that completes
// its bytes on the receiver's mbarrier of that buffer, at mapa addresses).
// A CTA starts step i + 1 once that mbarrier has counted the whole state,
// rows x H x 4 bytes: no cluster barrier a step, and no fence that would
// wait for the step's global loads and stores. Step i + 1's stores into
// buffer i % 2 of a peer cannot race the peer's reads of step i - 1: the
// sender holds the peer's step i output, sent after those reads. A CTA
// re-arms a buffer's mbarrier (arrive.expect_tx) after a __syncthreads
// that follows every thread's wait on it, so no thread can miss a phase.
// One cluster barrier after setup (every CTA started, its mbarriers armed)
// and one at exit (no CTA leaves while a peer may still store into it);
// clusters never wait on each other.
//
// Thread layout: groups of four lanes, group = a tile of 2 rows x 2 units,
// lane g of the group the residues s = 4g .. 4g + 3 (k = 16m + 4g + x, one
// float4 of h and of Wh a row and chunk of 16 columns). Each lane keeps the
// 16 partial sums of its residues (4 outputs x 4 residues) by fmaf from 0
// in k order; lane 0 of the group then adds p0 .. p3, its peers' p4 .. p15
// (shuffles) in s order, and hands output g of the tile to lane g, which
// adds the bias, i2h and the activation: per output exactly the per-step
// kernel's order, so ys equals T launches of rnn_cell bit for bit. i2h of
// step i + 1 is loaded during step i.
//
// Shared memory: 4 * ld * (round2(units) + 2 * round2(rows)) bytes; with
// 16-CTA clusters and rows = 1 it fits the H100's 227 KB up to H = 928
// (the wrapper's SEQ_MAX_HIDDEN): wider layers keep the per-step launches
// (the op decides that from the shape), and a launch no plan fits is
// refused. Wh's rows and h0 come in by one bulk copy
// a row (the Tensor Memory Accelerator) where H % 4 == 0 and the pointers
// are 16-byte aligned, else by 4-byte cp.async; either way once a launch.
//
// Bound at the RNN op's (T, N, H) = (32, 32, 200), one direction: the
// 2 * T * N * H * H = 81.9 MFLOP of float32 FMAs take 1.22 us at 67
// TFLOP/s, the bytes (i2h, ys, Wh, bh, h0) 1.8 MB 0.54 us; the steps run
// one after another, so a launch takes T times a step's latency (its
// products, the shuffles, the remote stores and the mbarrier wait).

constexpr int kSeqMaxThreads = 512;   // 128 tiles of 2 x 2 outputs
constexpr int kSeqTileFloor = 32;     // tiles that cost a step's latency
constexpr unsigned kFull = 0xffffffffu;

struct SeqParams {
  const float* xi[2];
  const float* w[2];
  const float* b[2];
  const float* h0[2];
  float* ys;
  int steps, rows, hidden;  // T, N, H
  int cluster;              // CTAs a cluster
  int crows;                // batch rows a cluster
  int units;                // hidden units a CTA
  int ld;                   // floats a row of shared memory
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address of `addr` (a shared::cta address) in CTA
// `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// `v` into shared::cluster address `addr`, its 4 bytes completed on the
// mbarrier at shared::cluster address `bar` (in the same CTA as addr)
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fma4(float* a, float4 h, float4 w) {
  a[0] = fmaf(h.x, w.x, a[0]);
  a[1] = fmaf(h.y, w.y, a[1]);
  a[2] = fmaf(h.z, w.z, a[2]);
  a[3] = fmaf(h.w, w.w, a[3]);
}

// the last chunk's first `cnt` residues only: no product past H enters
__device__ __forceinline__ void fma4_tail(float* a, float4 h, float4 w,
                                          int cnt) {
  if (cnt > 0) a[0] = fmaf(h.x, w.x, a[0]);
  if (cnt > 1) a[1] = fmaf(h.y, w.y, a[1]);
  if (cnt > 2) a[2] = fmaf(h.z, w.z, a[2]);
  if (cnt > 3) a[3] = fmaf(h.w, w.w, a[3]);
}

template <int kAct, bool kBulk>
__global__ void __launch_bounds__(kSeqMaxThreads)
rnn_seq_kernel(const __grid_constant__ SeqParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar;
  // each state buffer's arrivals (st.async bytes)
  __shared__ __align__(8) unsigned long long ready[2];
  const int d = blockIdx.y;
  const int H = p.hidden, ld = p.ld, T = p.steps;
  const unsigned rank = cluster_rank();
  const int up = (p.units + 1) & ~1, rp = (p.crows + 1) & ~1;
  const int j0 = (int)rank * p.units;
  const int jn = max(0, min(p.units, H - j0));       // units of this CTA
  const int n0 = (int)(blockIdx.x / p.cluster) * p.crows;
  const int nn = min(p.crows, p.rows - n0);          // rows of the cluster
  float* wsm = smem;                                 // up x ld
  float* hb = smem + up * ld;                        // 2 x rp x ld
  const float* __restrict__ w = d == 0 ? p.w[0] : p.w[1];
  const float* __restrict__ h0 = d == 0 ? p.h0[0] : p.h0[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;

  // zeros where no copy lands: the padding columns, the rows past the
  // CTA's units and the cluster's rows, all of buffer 1
  for (int r = warp; r < up; r += warps) {
    for (int c = (r < jn ? H : 0) + lane; c < ld; c += 32) {
      wsm[r * ld + c] = 0.f;
    }
  }
  for (int r = warp; r < rp; r += warps) {
    for (int c = (r < nn ? H : 0) + lane; c < ld; c += 32) {
      hb[r * ld + c] = 0.f;
    }
    for (int c = lane; c < ld; c += 32) hb[(rp + r) * ld + c] = 0.f;
  }
  // the state's bytes a step; each buffer's first phase armed here
  const unsigned step_bytes = (unsigned)(nn * H * 4);
  if (threadIdx.x == 0) {
    bar_init(&bar);
    bar_init(&ready[0]);
    bar_init(&ready[1]);
    bar_fence();
    bar_expect(&ready[0], step_bytes);
    bar_expect(&ready[1], step_bytes);
  }
  __syncthreads();
  if (kBulk) {
    if (warp == 0) {
      const unsigned bytes = H * 4;
      if (lane == 0) bar_expect(&bar, bytes * (jn + nn));
      __syncwarp();
      for (int r = lane; r < jn + nn; r += 32) {
        if (r < jn) {
          bulk_copy(wsm + r * ld, w + (long long)(j0 + r) * H, bytes, &bar);
        } else {
          bulk_copy(hb + (r - jn) * ld, h0 + (long long)(n0 + r - jn) * H,
                    bytes, &bar);
        }
      }
    }
    bar_wait(&bar, 0);
  } else {
    for (int r = warp; r < jn + nn; r += warps) {
      const float* src = r < jn ? w + (long long)(j0 + r) * H
                                : h0 + (long long)(n0 + r - jn) * H;
      float* dst = r < jn ? wsm + r * ld : hb + (r - jn) * ld;
      for (int c = lane; c < H; c += 32) cp_async4(dst + c, src + c);
    }
    cp_async_wait_all();
  }

  // this lane's tile and, after the fold, its output (row g / 2, unit g % 2)
  const int g = threadIdx.x & 3, tile = threadIdx.x >> 2;
  const int uts = up / 2;
  const bool active = tile < uts * (rp / 2);
  const int ut = active ? tile % uts : 0, rt = active ? tile / uts : 0;
  const int nl = 2 * rt + (g >> 1), jl = 2 * ut + (g & 1);
  const bool mine = active && nl < nn && jl < jn;
  const int n = n0 + nl, j = j0 + jl;
  const float* __restrict__ xi = d == 0 ? p.xi[0] : p.xi[1];
  const float* __restrict__ bias = d == 0 ? p.b[0] : p.b[1];
  const float bj = mine && bias != nullptr ? bias[j] : 0.f;
  const bool reverse = d == 1;
  const long long step_floats = (long long)p.rows * H;
  const long long at = (long long)n * H + j;
  float* ys = p.ys + (long long)d * T * step_floats + at;
  float xnext = mine ? xi[(reverse ? T - 1 : 0) * step_floats + at] : 0.f;
  const float* wr = wsm + 2 * ut * ld + 4 * g;
  const int full = H / 16;                  // whole chunks of 16 columns
  const int tail = min(4, max(0, H - full * 16 - 4 * g));
  const unsigned hb_addr = smem_addr(hb + nl * ld + j);
  const unsigned ready_addr = smem_addr(&ready[0]);
  cluster_sync_all();  // every CTA has started and holds Wh, h0 and zeros

  for (int i = 0; i < T; ++i) {
    const int t = reverse ? T - 1 - i : i;
    const int cur = i & 1;
    if (i > 0) {
      // step i - 1's state: phase (i - 1) / 2 of buffer cur's mbarrier,
      // then armed for its next phase (step i + 1's state)
      bar_wait(&ready[cur], ((i - 1) >> 1) & 1);
      __syncthreads();
      if (threadIdx.x == 0) bar_expect(&ready[cur], step_bytes);
    }
    const float x = xnext;
    if (mine && i + 1 < T) {
      xnext = xi[(long long)(reverse ? t - 1 : t + 1) * step_floats + at];
    }
    const float* hr = hb + cur * rp * ld + 2 * rt * ld + 4 * g;
    float acc[4][4];  // [output: row * 2 + unit][residue 4g + x]
#pragma unroll
    for (int o = 0; o < 4; ++o) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[o][q] = 0.f;
    }
#pragma unroll 4
    for (int m = 0; m < full; ++m) {
      const int k = 16 * m;
      const float4 h0v = *reinterpret_cast<const float4*>(hr + k);
      const float4 h1v = *reinterpret_cast<const float4*>(hr + ld + k);
      const float4 w0v = *reinterpret_cast<const float4*>(wr + k);
      const float4 w1v = *reinterpret_cast<const float4*>(wr + ld + k);
      fma4(acc[0], h0v, w0v);
      fma4(acc[1], h0v, w1v);
      fma4(acc[2], h1v, w0v);
      fma4(acc[3], h1v, w1v);
    }
    if (tail > 0) {
      const int k = 16 * full;
      const float4 h0v = *reinterpret_cast<const float4*>(hr + k);
      const float4 h1v = *reinterpret_cast<const float4*>(hr + ld + k);
      const float4 w0v = *reinterpret_cast<const float4*>(wr + k);
      const float4 w1v = *reinterpret_cast<const float4*>(wr + ld + k);
      fma4_tail(acc[0], h0v, w0v, tail);
      fma4_tail(acc[1], h0v, w1v, tail);
      fma4_tail(acc[2], h1v, w0v, tail);
      fma4_tail(acc[3], h1v, w1v, tail);
    }
    // the 16 partials of each output in s order: lane 0's p0 .. p3, then
    // lane 1's p4 .. p7, lane 2's, lane 3's
    float sum[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      sum[o] = acc[o][0];
#pragma unroll
      for (int q = 1; q < 4; ++q) sum[o] = __fadd_rn(sum[o], acc[o][q]);
    }
#pragma unroll
    for (int src = 1; src < 4; ++src) {
#pragma unroll
      for (int o = 0; o < 4; ++o) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sum[o] = __fadd_rn(sum[o],
                             __shfl_down_sync(kFull, acc[o][q], src, 4));
        }
      }
    }
    float s[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) s[o] = __shfl_sync(kFull, sum[o], 0, 4);
    if (mine) {
      float v = g == 0 ? s[0] : g == 1 ? s[1] : g == 2 ? s[2] : s[3];
      if (bias != nullptr) v = __fadd_rn(v, bj);
      const float y = activate<kAct>(__fadd_rn(x, v));
      if (i + 1 < T) {
        const unsigned dst = hb_addr + (unsigned)((cur ^ 1) * rp * ld * 4);
        const unsigned fb = ready_addr + (unsigned)((cur ^ 1) * 8);
        for (int r = 0; r < p.cluster; ++r) {
          st_async(map_rank(dst, r), y, map_rank(fb, r));
        }
      }
      ys[(long long)t * step_floats] = y;
    }
  }
  cluster_sync_all();  // no CTA leaves while a peer may store into it
}

// The sequence plan of one (T, N, H, D) on the current device: the cluster
// size, the rows a cluster, the clusters a direction, the threads, units
// and row stride of a CTA, and its dynamic shared memory.
struct SeqPlan {
  int cluster, crows, clusters, threads, units, ld;
  long long smem;
};

long long seq_smem(long long hidden, int cluster, long long crows) {
  const long long ld = (hidden + 15) / 16 * 16 + 8;
  const long long units = (hidden + cluster - 1) / cluster;
  return 4 * ld * (((units + 1) & ~1LL) + 2 * ((crows + 1) & ~1LL));
}

int seq_threads(long long hidden, int cluster, long long crows) {
  const long long units = (hidden + cluster - 1) / cluster;
  const long long tiles = ((units + 1) / 2) * ((crows + 1) / 2);
  return (int)((4 * tiles + 31) / 32 * 32);
}

using SeqKernel = void (*)(SeqParams);

SeqKernel seq_kernel(int act, bool bulk) {
  if (act == kTanh) {
    return bulk ? rnn_seq_kernel<kTanh, true> : rnn_seq_kernel<kTanh, false>;
  }
  return bulk ? rnn_seq_kernel<kRelu, true> : rnn_seq_kernel<kRelu, false>;
}

// Once per device: the four variants opted into the card's shared memory
// (less their static shared memory, returned) and non-portable cluster
// sizes (16 is refused where the card does not allow it).
int seq_setup(long long* smem_limit, bool* allow16) {
  static long long limit[kMaxDevices];
  static bool big[kMaxDevices];
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load()) {
    int fixed = 0;
    for (int i = 0; i < 4; ++i) {
      cudaFuncAttributes fa;
      err = cudaFuncGetAttributes(&fa, (const void*)seq_kernel(i / 2, i % 2));
      if (err != cudaSuccess) return (int)err;
      fixed = std::max(fixed, (int)fa.sharedSizeBytes);
    }
    const long long lim = smem_optin() - fixed;
    bool allow = true;
    for (int i = 0; i < 4; ++i) {
      const void* k = (const void*)seq_kernel(i / 2, i % 2);
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lim);
      if (err != cudaSuccess) return (int)err;
      if (cudaFuncSetAttribute(
              k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess) {
        allow = false;
      }
    }
    cudaGetLastError();  // a refused non-portable size is not an error
    limit[dev] = lim;
    big[dev] = allow;
    ready[dev].store(true);
  }
  *smem_limit = limit[dev];
  *allow16 = big[dev];
  return 0;
}

// clusters of `cluster` CTAs of (threads, smem) the card runs at once
int seq_active(SeqKernel kernel, int cluster, int threads, long long smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// Every cluster size (8 and 16) and every number of batch rows a cluster
// (up to what the shared memory and kSeqMaxThreads allow), each with the
// clusters of its kind the card runs at once: the plan of least cost wins.
// Cost: waves of clusters times (tiles a CTA + kSeqTileFloor), since a
// step of few tiles costs its latency (the chain of 16-column chunks, the
// fold, the remote stores) more than its issue slots, plus the cluster
// size. On a tie, 8 over 16 and more rows over fewer (fewer CTAs to load
// Wh). Returns false when nothing fits.
bool seq_plan(SeqKernel kernel, long long rows, long long hidden,
              long long dirs, long long limit, bool allow16, SeqPlan* out) {
  bool found = false;
  long long best = 0;
  for (int cluster : {8, 16}) {
    if (cluster == 16 && !allow16) continue;
    const long long units = (hidden + cluster - 1) / cluster;
    for (long long crows = 1; crows <= rows; ++crows) {
      const long long smem = seq_smem(hidden, cluster, crows);
      const int threads = seq_threads(hidden, cluster, crows);
      if (smem > limit || threads > kSeqMaxThreads) break;
      const int active = seq_active(kernel, cluster, threads, smem);
      if (active < 1) continue;
      const long long clusters = (rows + crows - 1) / crows;
      const long long waves = (dirs * clusters + active - 1) / active;
      const long long cost =
          waves * (((crows + 1) / 2) * ((units + 1) / 2) + kSeqTileFloor) +
          cluster;
      if (found && (cost > best || (cost == best && cluster != out->cluster))) {
        continue;
      }
      found = true;
      best = cost;
      out->cluster = cluster;
      out->crows = (int)crows;
      out->clusters = (int)clusters;
      out->threads = threads;
      out->units = (int)units;
      out->ld = (int)((hidden + 15) / 16 * 16 + 8);
      out->smem = smem;
    }
  }
  return found;
}

}  // namespace

// act is 0 (tanh) or 1 (relu); bias is null for an FC with no_bias. The
// tiles come in by bulk copies where H is a multiple of 4 and h_prev and Wh
// are 16-byte aligned, else by 4-byte copies; H past kFwdMaxK is summed in
// passes.
extern "C" int mxt_rnn_cell_f32(const void* packed) {
  const CellArgs& a = *static_cast<const CellArgs*>(packed);
  if (a.act != kTanh && a.act != kRelu) return (int)cudaErrorInvalidValue;
  if (a.rows <= 0 || a.hidden <= 0) return 0;
  const long long gy = (a.rows + kFwdRows - 1) / kFwdRows;
  if (gy > 65535 || a.hidden > (1LL << 28)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((a.hidden + kFwdJ - 1) / kFwdJ), (unsigned)gy);
  const bool bulk = a.hidden % 4 == 0 && aligned16(a.h_prev) &&
                    aligned16(a.weight);
  const int kmax = (int)std::min<long long>(a.hidden, kFwdMaxK);
  int ld = (kmax + 3) & ~3;
  if (ld % 16 == 0) ld += 4;  // rows 16 banks apart would share them
  const long long smem = (kFwdTiles * (long long)ld + kFwdS * kFwdOut) * 4;
  if (a.act == kTanh) {
    return bulk ? launch_fwd<kTanh, true>(a, grid, smem, kmax, ld)
                : launch_fwd<kTanh, false>(a, grid, smem, kmax, ld);
  }
  return bulk ? launch_fwd<kRelu, true>(a, grid, smem, kmax, ld)
              : launch_fwd<kRelu, false>(a, grid, smem, kmax, ld);
}

// dnext_h may be null: a state no later step consumes has no gradient,
// which counts as zero. Bulk copies where H is a multiple of 4 and every
// input is 16-byte aligned, else 4-byte copies and loads. A block takes
// kBwdRows rows, or 2 or 1 where 4 would not fit in the card's shared
// memory; H where even 1 would not is refused (cudaErrorInvalidValue).
extern "C" int mxt_rnn_cell_bwd_f32(const void* packed) {
  const CellBwdArgs& a = *static_cast<const CellBwdArgs*>(packed);
  if (a.act != kTanh && a.act != kRelu) return (int)cudaErrorInvalidValue;
  if (a.rows <= 0 || a.hidden <= 0) return 0;
  if (a.hidden > (1LL << 26)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const bool bulk = a.hidden % 4 == 0 && aligned16(a.next_h) &&
                    aligned16(a.weight) && aligned16(a.dnext_h) &&
                    w_map(a.weight, a.hidden, &map);
  const int cmax = (int)std::min<long long>(a.hidden, kBwdMaxC);
  const long long fixed =
      ((long long)(cmax + kBox - 1) / kBox * kBox * kBwdJ +
       kBwdS * kBwdOut) * 4 + 128;  // and the alignment of the slice
  const long long per_row = (bulk ? 2 * a.hidden : 0) * 4 + a.hidden * 4;
  int rb = kBwdRows;
  while (rb > 1 && fixed + rb * per_row > smem_optin()) rb /= 2;
  const long long smem = fixed + rb * per_row;
  const long long gy = (a.rows + rb - 1) / rb;
  if (smem > smem_optin() || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.hidden + kBwdJ - 1) / kBwdJ), (unsigned)gy);
  if (a.act == kTanh) {
    return bulk ? launch_bwd<kTanh, true>(a, grid, smem, rb, cmax, map)
                : launch_bwd<kTanh, false>(a, grid, smem, rb, cmax, map);
  }
  return bulk ? launch_bwd<kRelu, true>(a, grid, smem, rb, cmax, map)
              : launch_bwd<kRelu, false>(a, grid, smem, rb, cmax, map);
}

namespace {

// The sequence entries' packed arguments (the wrapper's struct "=9Q5qQ"):
// per direction the input projection (T, N, H), Wh (H, H), bh (null: no
// bias) and h0 (N, H); ys (D, T, N, H); then T, N, H, D, the activation
// and the stream.
struct SeqArgs {
  unsigned long long xi[2], weight[2], bias[2], h0[2], ys;
  long long steps, rows, hidden, dirs, act;
  unsigned long long stream;
};

static_assert(sizeof(SeqArgs) == 15 * 8, "SeqArgs: 15 fields of 8 bytes");

// the plan of `a` (kept for the last shapes seen on this thread) and the
// kernel (with bulk copies or not); an error code, or
// cudaErrorInvalidValue for what the kernel does not take
int seq_prepare(const SeqArgs& a, SeqPlan* plan, SeqKernel* kernel) {
  if (a.act != kTanh && a.act != kRelu) return (int)cudaErrorInvalidValue;
  if (a.dirs < 1 || a.dirs > 2 || a.rows < 1 || a.rows >= (1LL << 31) ||
      a.hidden < 1 || a.hidden >= (1LL << 31) || a.steps < 1 ||
      a.steps >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  bool b = a.hidden % 4 == 0;
  for (int d = 0; d < a.dirs; ++d) {
    b = b && aligned16(a.weight[d]) && aligned16(a.h0[d]);
  }
  *kernel = seq_kernel((int)a.act, b);
  long long limit = 0;
  bool allow16 = false;
  const int err = seq_setup(&limit, &allow16);
  if (err != 0) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  struct Entry {
    long long key[5];
    SeqPlan plan;
  };
  thread_local Entry seen[8];
  thread_local int used = 0, next = 0;
  const long long key[5] = {dev, a.act * 2 + (b ? 1 : 0), a.rows, a.hidden,
                            a.dirs};
  for (int i = 0; i < used; ++i) {
    if (std::equal(key, key + 5, seen[i].key)) {
      *plan = seen[i].plan;
      return 0;
    }
  }
  if (!seq_plan(*kernel, a.rows, a.hidden, a.dirs, limit, allow16, plan)) {
    return (int)cudaErrorInvalidValue;
  }
  std::copy(key, key + 5, seen[next].key);
  seen[next].plan = *plan;
  next = (next + 1) % 8;
  used = std::max(used, next == 0 ? 8 : next);
  return 0;
}

}  // namespace

// Every step of one layer of the RNN op's rnn_tanh / rnn_relu modes, both
// directions, in one launch of clusters (see rnn_seq_kernel): direction 1
// runs from t = T - 1 down to 0. Where no cluster fits the card (on the
// H100 past H = 928), cudaErrorInvalidValue (the wrapper raises).
extern "C" int mxt_rnn_seq_f32(const void* packed) {
  const SeqArgs& a = *static_cast<const SeqArgs*>(packed);
  SeqPlan plan;
  SeqKernel kernel = nullptr;
  const int err = seq_prepare(a, &plan, &kernel);
  if (err != 0) return err;
  SeqParams p;
  for (int d = 0; d < 2; ++d) {
    const int s = d < a.dirs ? d : 0;
    p.xi[d] = ptr<const float>(a.xi[s]);
    p.w[d] = ptr<const float>(a.weight[s]);
    p.b[d] = ptr<const float>(a.bias[s]);
    p.h0[d] = ptr<const float>(a.h0[s]);
  }
  p.ys = ptr<float>(a.ys);
  p.steps = (int)a.steps;
  p.rows = (int)a.rows;
  p.hidden = (int)a.hidden;
  p.cluster = plan.cluster;
  p.crows = plan.crows;
  p.units = plan.units;
  p.ld = plan.ld;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)plan.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(plan.cluster * plan.clusters),
                     (unsigned)a.dirs);
  cfg.blockDim = dim3((unsigned)plan.threads);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = ptr<CUstream_st>(a.stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
