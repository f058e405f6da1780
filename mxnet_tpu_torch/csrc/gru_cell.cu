// GRU cell step, forward and backward, float32: the recurrent product and
// the gate chain in one launch each way.
//
// Replaces one GRUCell step, mxnet_tpu/rnn/rnn_cell.py GRUCell.__call__
// (:301-330) from the h2h FullyConnected on — the same arithmetic as the
// gru scan body of mxnet_tpu/ops/defs_rnn.py _run_layer (:112-125) — which
// XLA fuses around its dot, and its VJP (jax.vjp of the same chain). Eager
// PyTorch would run it as the product's GEMM plus about twelve launches. See
// mxnet_tpu_torch/kernels/gru_cell.py for the wrappers and the plain
// versions. Per (n, j), with the reference's order of operations:
//
//   h2h[c] = sum_k h_prev[k] * Wh[c][k] + bh[c]    for c = j, H + j, 2H + j
//   r = sigmoid(i2h[j] + h2h[j]);  z = sigmoid(i2h[H + j] + h2h[H + j])
//   o = tanh(i2h[2H + j] + r * h2h[2H + j])
//   next_h = o + z * (h_prev - o)
//
// sigmoid(x) = 1 / (1 + exp(-x)), as lax.logistic and torch.sigmoid take it.
// The backward takes the derivatives the way jax.vjp transposes them, with
// g = dnext_h and ho = h2h[2H + j]:
//
//   do = g - z * g;  da_o = tanh'(do, o)
//   da_z = sigmoid'(g * (h_prev - o), z)
//   da_r = sigmoid'(da_o * ho, r)
//   di2h = [da_r, da_z, da_o];  dh2h = [da_r, da_z, r * da_o]
//   dh_prev = z * g + sum_c dh2h[c] * Wh[c][j]
//
// sigmoid' as ct * (s * (1 - s)); tanh' as a + a * t with a = ct * (1 - t).
// The gate arithmetic rounds every product and sum on its own
// (__fmul_rn/__fadd_rn/__fsub_rn), so no FMA contraction changes it. The
// products are float32 FMAs on the CUDA cores: no tensor cores, because the
// path runs float32 with TF32 off and its parity with the reference rests on
// that. They sum in a fixed order that differs from cuBLAS's (see each
// kernel), so a result may differ from the plain version's by the rounding
// of a sum of H (forward) or 3H (backward) products.
//
// Bound: bytes, and in practice a launch's fixed costs. At N = 32, H = 200
// a training forward reads i2h, h_prev, Wh and bh and writes next_h and the
// saved planes [r, z, o, ho]: (3+1+1+4)*N*H + 3H*H + 3H floats = 713 KB,
// 0.21 us at 3.35 TB/s; a backward reads dnext_h, the planes, h_prev and Wh
// and writes di2h, dh2h and dh_prev: 13*N*H + 3H*H floats = 813 KB, 0.24 us.
// The 7.7 MFLOP of either product take 0.11 us at 67 TFLOP/s. Wh (480 KB at
// H = 200) stays in the 50 MB L2 from step to step. What a block spends is
// mostly the wait for its tiles and the instructions that ask for them, so
// the tiles come in by the copy engine (the Tensor Memory Accelerator: bulk
// and 2D tensor copies completing on an mbarrier) in few, large copies,
// all requested before anything else; 4-byte cp.async where H is not a
// multiple of 4 or a pointer is not 16-byte aligned.
//
// Forward design: a block of 256 threads per tile of kFwdJ = 4 hidden units
// and kFwdRows = 16 rows (100 blocks at N = 32, H = 200). The tile's h_prev
// rows and its 3 x 4 rows of Wh come into shared memory whole (H floats a
// row, in passes of kFwdMaxK columns past that): unpadded, the h_prev rows
// are one contiguous copy and each gate's 4 Wh rows another. Thread (jl,
// rg, s) keeps rows rg + 4r (r < 4) x 3 gates of partial sums over k = s
// (mod kFwdS = 16), read from shared memory (7 reads for 12 FMAs; the row
// stride puts a warp's 8 distinct addresses in 8 banks). The 16 partials of
// an output are then added in s order by the output's own thread, which
// adds the bias and runs the gates; its i2h, h_prev and bias values are
// requested before the sums start. The order of a product: for each s, k =
// s, s + 16, ... by fmaf from 0; then ((p0 + p1) + ...) + p15; then the
// bias.
//
// Backward design: a block of 512 threads per kBwdJ = 16 columns of dh_prev
// and up to kBwdRows = 4 rows (104 blocks at N = 32, H = 200). Bulk copies
// bring the block rows' six planes [r, z, o, ho, dnext_h, h_prev] (one
// contiguous copy each, 19 KB) and 2D tensor copies the 3H x 16 slice of Wh
// (boxes of kBox x 16, 38 KB; rows and columns past Wh arrive as zeros),
// all requested at the start. Phase A: the block computes the gate
// gradients of its rows for all 3H columns into shared memory, and writes
// di2h and dh2h for its own 16 columns only, so each element is written by
// one block. Phase B: thread (jc, s) sums c = s (mod kBwdS = 32) for its
// column over the block's rows, and the 32 partials are added in s order:
// dh_prev = z * g + (((p0 + p1) + ...) + p31). A thread-block cluster
// sharing the gate gradients through distributed shared memory would read
// each plane element once instead of once a column tile, but the planes
// are the smaller share of a block's bytes, arrive in six copies, and the
// cluster would add a barrier across blocks, so each block recomputes them.

// cuda.h for CUtensorMap and its enums; the encoder comes via the runtime
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cstring>

namespace {

constexpr int kFwdJ = 4;       // hidden units a block
constexpr int kFwdRows = 16;   // rows a block
constexpr int kFwdR = 4;       // rows a thread: rg, rg + 4, rg + 8, rg + 12
constexpr int kFwdS = 16;      // thread group s sums k = s (mod kFwdS)
constexpr int kFwdThreads = kFwdJ * (kFwdRows / kFwdR) * kFwdS;
constexpr int kFwdOut = kFwdRows * kFwdJ;      // (n, j) outputs a block
constexpr int kFwdTiles = kFwdRows + 3 * kFwdJ;  // h_prev rows + Wh rows
constexpr int kFwdMaxK = 1408;  // columns of the tiles a pass

constexpr int kBwdJ = 16;      // columns of dh_prev a block, one a thread
constexpr int kBwdRows = 4;    // rows a block, all of them in each thread
constexpr int kBwdS = 32;      // thread group s sums c = s (mod kBwdS)
constexpr int kBwdThreads = kBwdJ * kBwdS;
constexpr int kBwdOut = kBwdRows * kBwdJ;
constexpr int kBwdMaxC = 1536;  // rows of the Wh slice a pass
constexpr int kBox = 128;       // rows of a tensor copy of the slice

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
  if (l == 0) bar_expect(bar, bytes * (nrows + 3 * ncols));
  __syncwarp();
  if (ld == hidden) {
    // whole unpadded rows: the h_prev rows are one run, and so are each
    // gate's Wh rows
    if (l == 0) {
      bulk_copy(tile, h_prev + (long long)n0 * hidden, nrows * bytes, bar);
    } else if (l <= 3) {
      bulk_copy(tile + (kFwdRows + (l - 1) * kFwdJ) * ld,
                w + ((long long)(l - 1) * hidden + j0) * hidden,
                ncols * bytes, bar);
    }
  } else if (l < nrows) {
    bulk_copy(tile + l * ld, h_prev + (long long)(n0 + l) * hidden + k0,
              bytes, bar);
  } else if (q >= 0 && q < 3 * kFwdJ && q % kFwdJ < ncols) {
    bulk_copy(tile + l * ld,
              w + ((long long)(q / kFwdJ) * hidden + j0 + q % kFwdJ) *
                      hidden + k0,
              bytes, bar);
  }
}

// Dynamic shared memory: the tiles, kFwdRows rows of h_prev then the 3 *
// kFwdJ rows of Wh (gate g, unit jl at row g * kFwdJ + jl), ld floats
// apart, columns k0 .. k0 + kc of a pass; then the partial sums. Threads:
// jl = t % kFwdJ, rg = t / kFwdJ % 4, s = t / 16. A thread keeps rows rg +
// 4 r x 3 gates of partial sums; at a k it reads 4 h values and 3 weights
// for 12 FMAs, and ld (a multiple of 4, not of 16) puts the 8 distinct
// addresses of a warp's read in 8 banks. The kFwdS partials of an output
// are then added in s order by the output's own thread (o < kFwdOut), which
// applies the bias and the gates.
template <bool kBulk>
__global__ void __launch_bounds__(kFwdThreads)
gru_cell_kernel(const float* __restrict__ i2h,
                const float* __restrict__ h_prev,
                const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ next_h, float* __restrict__ saved,
                int rows, int hidden, int kmax, int ld) {
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
  const long long b = (long long)n * 3 * hidden + j;
  const long long idx = (long long)n * hidden + j;
  float xr = 0.f, xz = 0.f, xo = 0.f, hp = 0.f, br = 0.f, bz = 0.f,
        bo = 0.f;
  if (mine) {
    xr = i2h[b];
    xz = i2h[b + hidden];
    xo = i2h[b + 2 * hidden];
    hp = h_prev[idx];
    if (bias != nullptr) {
      br = bias[j];
      bz = bias[hidden + j];
      bo = bias[2 * hidden + j];
    }
  }
  const int jl = threadIdx.x % kFwdJ;
  const int rg = threadIdx.x / kFwdJ % (kFwdRows / kFwdR);
  const int s = threadIdx.x / (kFwdJ * (kFwdRows / kFwdR));
  float acc[kFwdR][3];
#pragma unroll
  for (int r = 0; r < kFwdR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
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
        } else if (q >= 0 && q % kFwdJ < ncols) {
          cp_async4(tile + l * ld + c,
                    w + ((long long)(q / kFwdJ) * hidden + j0 + q % kFwdJ) *
                            hidden + k0 + c);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const float* hb = tile + rg * ld;
    const float* wb = tile + (kFwdRows + jl) * ld;
#pragma unroll 4
    for (int k = s; k < kc; k += kFwdS) {
      const float w0 = wb[k];
      const float w1 = wb[kFwdJ * ld + k];
      const float w2 = wb[2 * kFwdJ * ld + k];
#pragma unroll
      for (int r = 0; r < kFwdR; ++r) {
        const float x = hb[4 * r * ld + k];
        acc[r][0] = fmaf(x, w0, acc[r][0]);
        acc[r][1] = fmaf(x, w1, acc[r][1]);
        acc[r][2] = fmaf(x, w2, acc[r][2]);
      }
    }
    __syncthreads();  // the tiles are free for the next pass
  }
#pragma unroll
  for (int r = 0; r < kFwdR; ++r) {
    float* pp = part + (s * kFwdOut + (rg + 4 * r) * kFwdJ + jl) * 3;
    pp[0] = acc[r][0];
    pp[1] = acc[r][1];
    pp[2] = acc[r][2];
  }
  __syncthreads();
  if (!mine) return;
  const float* po = part + o * 3;
  float ar = po[0], az = po[1], ao = po[2];
#pragma unroll
  for (int q = 1; q < kFwdS; ++q) {
    ar = __fadd_rn(ar, po[q * kFwdOut * 3]);
    az = __fadd_rn(az, po[q * kFwdOut * 3 + 1]);
    ao = __fadd_rn(ao, po[q * kFwdOut * 3 + 2]);
  }
  if (bias != nullptr) {
    ar = __fadd_rn(ar, br);
    az = __fadd_rn(az, bz);
    ao = __fadd_rn(ao, bo);
  }
  const float r = sigmoid_rn(__fadd_rn(xr, ar));
  const float z = sigmoid_rn(__fadd_rn(xz, az));
  const float on = tanhf(__fadd_rn(xo, __fmul_rn(r, ao)));
  next_h[idx] = __fadd_rn(on, __fmul_rn(z, __fsub_rn(hp, on)));
  if (saved != nullptr) {
    const long long plane = (long long)rows * hidden;
    saved[idx] = r;
    saved[plane + idx] = z;
    saved[2 * plane + idx] = on;
    saved[3 * plane + idx] = ao;
  }
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

// Dynamic shared memory: with kBulk, the planes [r, z, o, ho, dnext_h,
// h_prev] of the block's rows (6 x rb x H, one bulk copy each); the gate
// gradients (rb x 3H); a pass of the Wh slice (cmax x kBwdJ); the partial
// sums (kBwdS x kBwdOut). Phase B's threads: jc = t % kBwdJ (the column), s
// = t / kBwdJ (c = s mod kBwdS); each keeps rb partial sums and at a c
// reads rb gate gradients and one weight (a warp's 32 weights are 32
// consecutive floats) for rb FMAs.
template <bool kBulk>
__global__ void __launch_bounds__(kBwdThreads)
gru_cell_bwd_kernel(const float* __restrict__ dnext_h,
                    const float* __restrict__ saved,
                    const float* __restrict__ h_prev,
                    const float* __restrict__ w, float* __restrict__ di2h,
                    float* __restrict__ dh2h, float* __restrict__ dh_prev,
                    int rows, int hidden, int rb, int cmax,
                    const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar, wbar;
  const int gates = 3 * hidden;
  const int j0 = blockIdx.x * kBwdJ, n0 = blockIdx.y * rb;
  const int nrows = min(rb, rows - n0);
  const int ncols = min(kBwdJ, hidden - j0);
  const long long plane = (long long)rows * hidden;
  const int span = nrows * hidden;  // floats of a plane's block rows
  // the slice's tensor copies land 128-byte aligned, first
  float* wt = smem + ((128 - (smem_addr(smem) & 127)) & 127) / 4;
  float* planes = wt + (cmax + kBox - 1) / kBox * kBox * kBwdJ;
  float* dg = planes + (kBulk ? 6 * rb * hidden : 0);
  float* part = dg + rb * gates;
  if (kBulk && threadIdx.x == 0) {
    bar_init(&bar);
    bar_init(&wbar);
    bar_fence();
    bar_expect(&bar, (dnext_h != nullptr ? 6u : 5u) * span * 4);
  }
  __syncthreads();
  if (kBulk && threadIdx.x < 6) {
    const long long at = (long long)n0 * hidden;
    const float* src = threadIdx.x < 4 ? saved + threadIdx.x * plane + at
                       : threadIdx.x == 4 ? dnext_h : h_prev + at;
    if (threadIdx.x != 4 || dnext_h != nullptr) {
      bulk_copy(planes + threadIdx.x * rb * hidden,
                threadIdx.x == 4 ? src + at : src, span * 4, &bar);
    }
  }
  load_w_slice<kBulk>(wt, &wmap, w, hidden, j0, ncols, 0, min(cmax, gates),
                      &wbar);
  // the epilogue's operands (thread o < kBwdOut owns output o), requested
  // now
  const int o = threadIdx.x;
  const int n = n0 + o / kBwdJ, j = j0 + o % kBwdJ;
  const bool mine = o < kBwdOut && o / kBwdJ < rb && n < rows && j < hidden;
  const long long idx = (long long)n * hidden + j;
  float zo = 0.f, go = 0.f;
  if (mine) {
    zo = saved[plane + idx];
    go = dnext_h != nullptr ? dnext_h[idx] : 0.f;
  }

  // phase A: the gate gradients of the block's rows, every column
  if (kBulk) {
    if (dnext_h == nullptr) {
      for (int e = threadIdx.x; e < span; e += kBwdThreads) {
        planes[4 * rb * hidden + e] = 0.f;
      }
    }
    bar_wait(&bar, 0);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < span; e += kBwdThreads) {
    float rg, z, on, ho, g, hp;
    if (kBulk) {
      rg = planes[e];
      z = planes[rb * hidden + e];
      on = planes[2 * rb * hidden + e];
      ho = planes[3 * rb * hidden + e];
      g = planes[4 * rb * hidden + e];
      hp = planes[5 * rb * hidden + e];
    } else {
      const long long i = (long long)n0 * hidden + e;
      rg = saved[i];
      z = saved[plane + i];
      on = saved[2 * plane + i];
      ho = saved[3 * plane + i];
      g = dnext_h != nullptr ? dnext_h[i] : 0.f;
      hp = h_prev[i];
    }
    const int r = e / hidden, jj = e - r * hidden;
    const float zgu = __fmul_rn(z, g);
    const float da_z = sigmoid_grad(__fmul_rn(g, __fsub_rn(hp, on)), z);
    const float da_o = tanh_grad(__fsub_rn(g, zgu), on);
    const float da_r = sigmoid_grad(__fmul_rn(da_o, ho), rg);
    const float dh_o = __fmul_rn(rg, da_o);
    float* d = dg + r * gates;
    d[jj] = da_r;
    d[hidden + jj] = da_z;
    d[2 * hidden + jj] = dh_o;
    if (jj >= j0 && jj < j0 + kBwdJ) {
      const long long bb = (long long)(n0 + r) * gates + jj;
      di2h[bb] = da_r;
      di2h[bb + hidden] = da_z;
      di2h[bb + 2 * hidden] = da_o;
      dh2h[bb] = da_r;
      dh2h[bb + hidden] = da_z;
      dh2h[bb + 2 * hidden] = dh_o;
    }
  }

  // phase B, a pass of the Wh slice at a time
  const int jc = threadIdx.x % kBwdJ;
  const int s = threadIdx.x / kBwdJ;
  float acc[kBwdRows];
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.f;
  for (int c0 = 0, pass = 0; c0 < gates; c0 += cmax, ++pass) {
    const int cc = min(cmax, gates - c0);
    if (pass > 0) {
      load_w_slice<kBulk>(wt, &wmap, w, hidden, j0, ncols, c0, cc, &wbar);
    }
    if (kBulk) {
      bar_wait(&wbar, pass & 1);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // and, in the first pass, the gate gradients are done
#pragma unroll 4
    for (int c = s; c < cc; c += kBwdS) {
      const float wv = wt[c * kBwdJ + jc];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        acc[r] = fmaf(dg[min(r, rb - 1) * gates + c0 + c], wv, acc[r]);
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
  for (int q = 1; q < kBwdS; ++q) {
    sum = __fadd_rn(sum, part[q * kBwdOut + o]);
  }
  dh_prev[idx] = __fadd_rn(__fmul_rn(zo, go), sum);
}

constexpr int kMaxDevices = 64;
// the dynamic shared memory each kernel is opted into on each device so far
std::atomic<long long> g_smem_set[4][kMaxDevices];

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
// less host time than ten. Pointers and the stream are addresses; a
// pointer of 0 is null.
struct CellArgs {
  unsigned long long i2h, h_prev, weight, bias, next_h, saved;
  long long rows, hidden;
  unsigned long long stream;
};

struct CellBwdArgs {
  unsigned long long dnext_h, saved, h_prev, weight, di2h, dh2h, dh_prev;
  long long rows, hidden;
  unsigned long long stream;
};

// the wrapper's struct formats "=6Q2qQ" and "=7Q2qQ"
static_assert(sizeof(CellArgs) == 9 * 8, "CellArgs: 9 fields of 8 bytes");
static_assert(sizeof(CellBwdArgs) == 10 * 8,
              "CellBwdArgs: 10 fields of 8 bytes");

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

// The tensor map of Wh (3H rows of H floats) in kBwdJ x kBox boxes; the
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
  const cuuint64_t dims[2] = {(cuuint64_t)hidden, (cuuint64_t)(3 * hidden)};
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

}  // namespace

// bias is null for an FC with no_bias; saved is null when no backward
// follows (inference): the planes are then not written. The tiles come in
// by bulk copies where H is a multiple of 4 and h_prev and Wh are 16-byte
// aligned, else by 4-byte copies; H past kFwdMaxK is summed in passes.
extern "C" int mxt_gru_cell_f32(const void* packed) {
  const CellArgs& a = *static_cast<const CellArgs*>(packed);
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
  const long long smem = (kFwdTiles * (long long)ld + kFwdS * kFwdOut * 3) * 4;
  const void* kernel = bulk ? (const void*)gru_cell_kernel<true>
                            : (const void*)gru_cell_kernel<false>;
  int err = ensure_smem(kernel, bulk ? 1 : 0, smem);
  if (err != 0) return err;
  cudaStream_t stream = ptr<CUstream_st>(a.stream);
  if (bulk) {
    gru_cell_kernel<true><<<grid, kFwdThreads, smem, stream>>>(
        ptr<const float>(a.i2h), ptr<const float>(a.h_prev),
        ptr<const float>(a.weight), ptr<const float>(a.bias),
        ptr<float>(a.next_h), ptr<float>(a.saved), (int)a.rows,
        (int)a.hidden, kmax, ld);
  } else {
    gru_cell_kernel<false><<<grid, kFwdThreads, smem, stream>>>(
        ptr<const float>(a.i2h), ptr<const float>(a.h_prev),
        ptr<const float>(a.weight), ptr<const float>(a.bias),
        ptr<float>(a.next_h), ptr<float>(a.saved), (int)a.rows,
        (int)a.hidden, kmax, ld);
  }
  return (int)cudaGetLastError();
}

// dnext_h may be null: a state no later step consumes has no gradient,
// which counts as zero. Bulk copies where H is a multiple of 4 and every
// input is 16-byte aligned, else 4-byte copies and loads. A block takes
// kBwdRows rows, or 2 or 1 where 4 would not fit in the card's shared
// memory; H where even 1 would not is refused (cudaErrorInvalidValue).
extern "C" int mxt_gru_cell_bwd_f32(const void* packed) {
  const CellBwdArgs& a = *static_cast<const CellBwdArgs*>(packed);
  if (a.rows <= 0 || a.hidden <= 0) return 0;
  if (a.hidden > (1LL << 26)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const bool bulk = a.hidden % 4 == 0 && aligned16(a.saved) &&
                    aligned16(a.h_prev) && aligned16(a.weight) &&
                    aligned16(a.dnext_h) && w_map(a.weight, a.hidden, &map);
  const long long gates = 3 * a.hidden;
  const int cmax = (int)std::min<long long>(gates, kBwdMaxC);
  const long long fixed =
      ((long long)(cmax + kBox - 1) / kBox * kBox * kBwdJ +
       kBwdS * kBwdOut) * 4 + 128;  // and the alignment of the slice
  const long long per_row = (bulk ? 6 * a.hidden : 0) * 4 + gates * 4;
  int rb = kBwdRows;
  while (rb > 1 && fixed + rb * per_row > smem_optin()) rb /= 2;
  const long long smem = fixed + rb * per_row;
  const long long gy = (a.rows + rb - 1) / rb;
  if (smem > smem_optin() || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.hidden + kBwdJ - 1) / kBwdJ), (unsigned)gy);
  const void* kernel = bulk ? (const void*)gru_cell_bwd_kernel<true>
                            : (const void*)gru_cell_bwd_kernel<false>;
  int err = ensure_smem(kernel, bulk ? 3 : 2, smem);
  if (err != 0) return err;
  cudaStream_t stream = ptr<CUstream_st>(a.stream);
  if (bulk) {
    gru_cell_bwd_kernel<true><<<grid, kBwdThreads, smem, stream>>>(
        ptr<const float>(a.dnext_h), ptr<const float>(a.saved),
        ptr<const float>(a.h_prev), ptr<const float>(a.weight),
        ptr<float>(a.di2h), ptr<float>(a.dh2h), ptr<float>(a.dh_prev),
        (int)a.rows, (int)a.hidden, rb, cmax, map);
  } else {
    gru_cell_bwd_kernel<false><<<grid, kBwdThreads, smem, stream>>>(
        ptr<const float>(a.dnext_h), ptr<const float>(a.saved),
        ptr<const float>(a.h_prev), ptr<const float>(a.weight),
        ptr<float>(a.di2h), ptr<float>(a.dh2h), ptr<float>(a.dh_prev),
        (int)a.rows, (int)a.hidden, rb, cmax, map);
  }
  return (int)cudaGetLastError();
}
