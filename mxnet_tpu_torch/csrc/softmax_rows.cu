// Row softmax over a contiguous (rows, cols) float32 array.
//
// Replaces `forward` inside mxnet_tpu/ops/defs_nn.py:_softmax_output (the
// SoftmaxOutput forward, jax.nn.softmax at :703); see
// mxnet_tpu_torch/kernels/softmax_rows.py for the wrapper and the plain
// version.
//
//   out[r, j] = exp(x[r, j] - max_j x[r, :]) / sum_j exp(x[r, j] - max)
//
// with expf (not __expf), the maximum subtracted first and an IEEE
// division by the sum, as the plain version computes it.
//
// Bound: device-memory bandwidth, 8 bytes per element (each input read
// once, each output written once); at the paths' shapes 43.5 MB for SSD
// training's (259072, 21) (0.013 ms), 82 MB for the LSTM head's
// (1024, 10000) (0.0245 ms) and 256 KB for ResNet's (32, 1000), where the
// launch is the cost. Every regime below reads each element from device
// memory once and writes it once. The C entry picks the regime by the
// column count C:
//
// - narrow, C <= 32 (SSD's 21 classes): a block takes a tile of 256
//   contiguous rows. One thread issues one bulk asynchronous copy
//   (cp.async.bulk, completion on an mbarrier) of the tile's 16-byte
//   aligned span into shared memory; the threads load the ragged head and
//   tail (under 16 bytes each) with 4-byte loads. One thread owns one row
//   and computes it in shared memory; an even C is first repacked at the
//   odd stride C + 1, so a warp's 32 rows fall in 32 different banks. The
//   tile goes back in one bulk store (cp.async.bulk ... bulk_group), or
//   with coalesced 4-byte stores when the output's alignment differs from
//   the input's (an input view at an odd float offset).
// - middle, 32 < C <= 4096 (ResNet's 1000 classes): one warp per row,
//   eight rows per block; the row stays in registers (at most 32 float4 a
//   lane), read and written with 16-byte accesses from the first aligned
//   column on and 4-byte ones for the head and tail; the max and the sum
//   come from warp shuffles alone.
// - wide, C > 4096 (the LSTM head's 10000): one block per row; the row is
//   staged once in shared memory (40 KB at 10000; above 48 KB through
//   cudaFuncAttributeMaxDynamicSharedMemorySize, up to the card's opt-in
//   limit), read and written with 16-byte accesses, the reductions by warp
//   shuffle and then across the block's warps.
// - a row wider than the opt-in shared memory (over ~58000 columns on the
//   H100) takes a loop over device memory that reads the row three times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNarrowCols = 32;
constexpr int kNarrowRows = 256;  // rows per tile = threads per block
constexpr int kMiddleCols = 4096;
constexpr int kWarpRows = 8;  // middle regime: rows (warps) per block
constexpr int kWideThreads = 512;
constexpr int kLoopThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// max (kMax) or sum over the block; every thread gets the result
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    v = kMax ? fmaxf(v, scratch[w]) : v + scratch[w];
  return v;
}

// floats from p down to the 16-byte boundary at or below it
__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- narrow: a tile of rows through shared memory by bulk copies --------
__device__ __forceinline__ void softmax_row_smem(float* row, int cols) {
  float m = -INFINITY;
  for (int j = 0; j < cols; ++j) m = fmaxf(m, row[j]);
  float s = 0.f;
  for (int j = 0; j < cols; ++j) {
    const float e = expf(row[j] - m);
    row[j] = e;
    s += e;
  }
  for (int j = 0; j < cols; ++j) row[j] = row[j] / s;
}

// floats of the narrow tile: 256 rows of C, after a shift of up to 3
__host__ __device__ constexpr int narrow_tile_floats(int cols) {
  return (3 + kNarrowRows * cols + 3) & ~3;
}

// bytes of shared memory of a narrow tile, with the padded copy of an even C
__host__ __device__ constexpr int narrow_smem(int cols) {
  return narrow_tile_floats(cols) * 4 +
         (cols % 2 == 0 ? kNarrowRows * (cols + 1) * 4 : 0);
}

// kPad: an even C, computed in a copy at the odd row stride C + 1
template <bool kPad>
__global__ void __launch_bounds__(kNarrowRows)
softmax_rows_narrow_kernel(const float* __restrict__ x, float* __restrict__ y,
                           long long rows, int cols) {
  extern __shared__ __align__(16) float tile[];
  __shared__ __align__(8) unsigned long long bar;
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kNarrowRows;
  const long long left = rows - r0;
  const int nrows = left < kNarrowRows ? (int)left : kNarrowRows;
  const int n = nrows * cols;  // floats of this tile
  const float* src = x + r0 * cols;
  float* dst = y + r0 * cols;
  // tile[shift + k] holds src[k]: tile + shift + k is 16-byte aligned
  // exactly where src + k is
  const int shift = misalign(src);
  const int head = min((4 - shift) & 3, n);
  const int body = ((n - head) >> 2) << 2;  // floats of the bulk copy
  float* buf = tile + shift;

  if (t == 0 && body > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0 && body > 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem(&bar)),
        "r"(body * 4)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem(buf + head)),
        "l"(src + head), "r"(body * 4), "r"(smem(&bar))
        : "memory");
  }
  // the ragged head and tail, 4-byte loads
  if (t < head) buf[t] = src[t];
  if (t < n - head - body) buf[head + body + t] = src[head + body + t];
  if (body > 0) {
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem(&bar)), "r"(0u)
          : "memory");
    }
  }
  __syncthreads();

  if (kPad) {
    float* pad = tile + narrow_tile_floats(cols);
    const int stride = cols + 1;
    for (int k = t; k < n; k += kNarrowRows) {
      const int r = k / cols;
      pad[r * stride + (k - r * cols)] = buf[k];
    }
    __syncthreads();
    if (t < nrows) softmax_row_smem(pad + t * stride, cols);
    __syncthreads();
    for (int k = t; k < n; k += kNarrowRows) {
      const int r = k / cols;
      buf[k] = pad[r * stride + (k - r * cols)];
    }
  } else {
    if (t < nrows) softmax_row_smem(buf + t * cols, cols);
  }

  if (misalign(dst) == shift) {
    // make the generic-proxy writes visible to the bulk copy's async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (t == 0 && body > 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              dst + head),
          "r"(smem(buf + head)), "r"(body * 4)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (t < head) dst[t] = buf[t];
    if (t < n - head - body) dst[head + body + t] = buf[head + body + t];
    if (t == 0 && body > 0) {
      // shared memory must outlive the copy's reads of it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  } else {
    __syncthreads();
    for (int k = t; k < n; k += kNarrowRows) dst[k] = buf[k];
  }
}

// --- middle: one warp per row, the row in registers ---------------------
// a[4 i + c] holds column head + 4 (32 i + lane) + c when `vec`, else
// column 32 (4 i + c) + lane; hv the head column `lane`, tv the tail
// column head + 4 nb + lane
template <int K>
__global__ void __launch_bounds__(kWarpRows * 32)
softmax_rows_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                         long long rows, int cols, int vec) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* xr = x + r * cols;
  float* yr = y + r * cols;
  const int head = vec ? min((4 - misalign(xr)) & 3, cols) : 0;
  const int nb = vec ? (cols - head) >> 2 : 0;
  const int ts = head + 4 * nb;
  const int tail = vec ? cols - ts : 0;
  float a[4 * K];
  float hv = -INFINITY, tv = -INFINITY;
  if (vec) {
    const float4* b = reinterpret_cast<const float4*>(xr + head);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int q = i * 32 + lane;
      float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (q < nb) v = b[q];
      a[4 * i] = v.x;
      a[4 * i + 1] = v.y;
      a[4 * i + 2] = v.z;
      a[4 * i + 3] = v.w;
    }
    if (lane < head) hv = xr[lane];
    if (lane < tail) tv = xr[ts + lane];
  } else {
#pragma unroll
    for (int k = 0; k < 4 * K; ++k) {
      const int j = 32 * k + lane;
      a[k] = j < cols ? xr[j] : -INFINITY;
    }
  }
  float m = fmaxf(hv, tv);
#pragma unroll
  for (int k = 0; k < 4 * K; ++k) m = fmaxf(m, a[k]);
  m = warp_max(m);
  // slots past the row hold -inf: exp gives 0 there
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4 * K; ++k) {
    a[k] = expf(a[k] - m);
    s += a[k];
  }
  hv = expf(hv - m);
  tv = expf(tv - m);
  if (lane < head) s += hv;
  if (lane < tail) s += tv;
  s = warp_sum(s);
  if (vec) {
    float4* b = reinterpret_cast<float4*>(yr + head);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int q = i * 32 + lane;
      if (q < nb)
        b[q] = make_float4(a[4 * i] / s, a[4 * i + 1] / s, a[4 * i + 2] / s,
                           a[4 * i + 3] / s);
    }
    if (lane < head) yr[lane] = hv / s;
    if (lane < tail) yr[ts + lane] = tv / s;
  } else {
#pragma unroll
    for (int k = 0; k < 4 * K; ++k) {
      const int j = 32 * k + lane;
      if (j < cols) yr[j] = a[k] / s;
    }
  }
}

// --- wide: one block per row, the row staged in shared memory -----------
// row[shift + j] holds column j (shift 0 without `vec`)
__global__ void __launch_bounds__(kWideThreads)
softmax_rows_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                          int cols, int vec) {
  extern __shared__ __align__(16) float stage[];
  __shared__ float scratch[kWideThreads / 32];
  const int t = threadIdx.x;
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;
  const int shift = vec ? misalign(xr) : 0;
  const int head = vec ? min((4 - shift) & 3, cols) : 0;
  const int nb = vec ? (cols - head) >> 2 : 0;
  const int ts = head + 4 * nb;  // the first column after the body
  float* row = stage + shift;
  float4* row4 = reinterpret_cast<float4*>(row + head);

  float m = -INFINITY;
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  for (int q = t; q < nb; q += kWideThreads) {
    const float4 v = x4[q];
    row4[q] = v;
    m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  if (t < head) {
    row[t] = xr[t];
    m = fmaxf(m, row[t]);
  }
  for (int j = ts + t; j < cols; j += kWideThreads) {
    row[j] = xr[j];
    m = fmaxf(m, row[j]);
  }
  m = block_reduce<true>(m, scratch);

  float s = 0.f;
  for (int q = t; q < nb; q += kWideThreads) {
    float4 v = row4[q];
    v.x = expf(v.x - m);
    v.y = expf(v.y - m);
    v.z = expf(v.z - m);
    v.w = expf(v.w - m);
    row4[q] = v;
    s += (v.x + v.y) + (v.z + v.w);
  }
  if (t < head) {
    row[t] = expf(row[t] - m);
    s += row[t];
  }
  for (int j = ts + t; j < cols; j += kWideThreads) {
    row[j] = expf(row[j] - m);
    s += row[j];
  }
  s = block_reduce<false>(s, scratch);

  if (vec) {
    float4* y4 = reinterpret_cast<float4*>(yr + head);
    for (int q = t; q < nb; q += kWideThreads) {
      const float4 v = row4[q];
      y4[q] = make_float4(v.x / s, v.y / s, v.z / s, v.w / s);
    }
    if (t < head) yr[t] = row[t] / s;
  }
  for (int j = ts + t; j < cols; j += kWideThreads) yr[j] = row[j] / s;
}

// --- wider than shared memory: three passes over device memory ----------
__global__ void __launch_bounds__(kLoopThreads)
softmax_rows_loop_kernel(const float* __restrict__ x, float* __restrict__ y,
                         long long cols) {
  __shared__ float scratch[kLoopThreads / 32];
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;
  float m = -INFINITY;
  for (long long j = threadIdx.x; j < cols; j += kLoopThreads)
    m = fmaxf(m, xr[j]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
  for (long long j = threadIdx.x; j < cols; j += kLoopThreads)
    s += expf(xr[j] - m);
  s = block_reduce<false>(s, scratch);
  for (long long j = threadIdx.x; j < cols; j += kLoopThreads)
    yr[j] = expf(xr[j] - m) / s;
}

struct DeviceLimits {
  int wide_most;  // bytes of dynamic shared memory the wide kernel may take
  int wide_set;   // bytes the wide kernel is configured for so far
};

int limits(DeviceLimits** out) {
  static DeviceLimits lim[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    int optin = 0;
    cudaFuncAttributes wide;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&wide, softmax_rows_block_kernel);
    // the opt-in limit covers the kernel's static shared memory too
    lim[dev].wide_most = optin - (int)wide.sharedSizeBytes;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(softmax_rows_narrow_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 narrow_smem(kNarrowCols));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(softmax_rows_narrow_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 narrow_smem(kNarrowCols - 1));
    if (err != cudaSuccess) return (int)err;
    lim[dev].wide_set = 48 * 1024 - (int)wide.sharedSizeBytes;
    ready[dev] = true;
  }
  *out = &lim[dev];
  return 0;
}

template <int K>
void launch_warp(const float* x, float* y, long long rows, int cols, int vec,
                 cudaStream_t s) {
  const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
  softmax_rows_warp_kernel<K><<<(unsigned)blocks, kWarpRows * 32, 0, s>>>(
      x, y, rows, cols, vec);
}

}  // namespace

// rows < 2^31 (the wrapper checks); returns a cudaError_t
extern "C" int mxt_softmax_rows_f32(const void* xp, void* yp, long long rows,
                                    long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  const float* x = (const float*)xp;
  float* y = (float*)yp;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte accesses where the input's and the output's columns share
  // their alignment (always, unless the input is a view at an odd offset)
  const int vec = ((reinterpret_cast<uintptr_t>(x) ^
                    reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  DeviceLimits* lim = nullptr;
  int err = limits(&lim);
  if (err != 0) return err;
  if (cols <= kNarrowCols) {
    const long long blocks = (rows + kNarrowRows - 1) / kNarrowRows;
    if (cols % 2 == 0)
      softmax_rows_narrow_kernel<true>
          <<<(unsigned)blocks, kNarrowRows, narrow_smem((int)cols), s>>>(
              x, y, rows, (int)cols);
    else
      softmax_rows_narrow_kernel<false>
          <<<(unsigned)blocks, kNarrowRows, narrow_smem((int)cols), s>>>(
              x, y, rows, (int)cols);
  } else if (cols <= kMiddleCols) {
    const int c = (int)cols;
    if (c <= 128) launch_warp<1>(x, y, rows, c, vec, s);
    else if (c <= 256) launch_warp<2>(x, y, rows, c, vec, s);
    else if (c <= 512) launch_warp<4>(x, y, rows, c, vec, s);
    else if (c <= 1024) launch_warp<8>(x, y, rows, c, vec, s);
    else if (c <= 2048) launch_warp<16>(x, y, rows, c, vec, s);
    else launch_warp<32>(x, y, rows, c, vec, s);
  } else if ((cols + 4) * 4 <= lim->wide_most) {
    const int bytes = (int)((cols + 4) * 4);
    if (bytes > lim->wide_set) {
      cudaError_t e = cudaFuncSetAttribute(
          softmax_rows_block_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, lim->wide_most);
      if (e != cudaSuccess) return (int)e;
      lim->wide_set = lim->wide_most;
    }
    softmax_rows_block_kernel<<<(unsigned)rows, kWideThreads, bytes, s>>>(
        x, y, (int)cols, vec);
  } else {
    softmax_rows_loop_kernel<<<(unsigned)rows, kLoopThreads, 0, s>>>(x, y,
                                                                    cols);
  }
  return (int)cudaGetLastError();
}
