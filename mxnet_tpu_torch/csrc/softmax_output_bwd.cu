// SoftmaxOutput loss-layer backward, float32.
//
// Replaces `bwd` inside mxnet_tpu/ops/defs_nn.py _softmax_output (the
// custom_vjp that ignores the head gradient); see
// mxnet_tpu_torch/kernels/softmax_output_bwd.py for the wrapper, the plain
// version and the planner. The probabilities p (the forward's output) are
// viewed as (outer, C, inner) with the class axis in the middle (inner = 1
// for the flattened and preserve_shape layouts, H*W... for multi_output),
// the labels as (outer, inner):
//
//   g = (p - onehot(label)) [* valid] [/ N or / max(sum(valid), 1)] * scale
//
// in exactly that order, each step rounded once (the divisions are
// correctly rounded, as on the CPU), valid = (label != ignore_label) under
// use_ignore.
//
// Bound: device-memory bandwidth, one read of p and of the labels and one
// write of g: 44.6 MB at SSD-300's (32 x 8096, 21), 82 MB at the LSTM
// head's (1024, 10000).
//
// Design: one launch a call. Regime `rows` (inner = 1, p and g 16-byte
// aligned, fewer than 2^31 elements: every path): each thread takes
// 16-byte chunks of the flat buffer in a grid-stride loop, finds the row
// and class of a chunk's first element by one 32-bit multiply-high
// division by the planner's magic number (no 64-bit division), reads that
// row's label once and steps to the next row by an incremental counter
// where the chunk crosses one. Regime `general` (multi_output with inner >
// 1, views off the 16-byte alignment, 2^31 elements or more) takes one
// element at a time with 64-bit division. normalization='valid' under
// use_ignore needs the number of valid labels before any element is
// scaled: the launch is cooperative (every block resident), each block
// counts a slice of the labels into its own integer slot (a buffer of
// the launch's stream, so launches that share it run in order), the grid
// synchronises (cooperative_groups grid.sync(), which builds without
// -rdc), and each block adds the slots in integers, exact in any order; a
// block loads its first chunk before it counts, so the barrier overlaps
// that chunk's read. No value goes through the host and no second kernel
// runs. Without use_ignore the count is outer * inner, known on the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;
// the count's slot buffer the wrapper gives (kernels/softmax_output_bwd.py
// SLOTS): a counting launch takes at most this many blocks
constexpr long long kSlots = 4096;
enum Regime { kRows = 0, kGeneral = 1 };
enum Norm { kNull = 0, kBatch = 1, kValid = 2 };

struct Args {
  const float* p;
  const float* label;
  float* g;
  unsigned* slots;         // one per block, for the count of valid labels
  long long total;         // elements of p
  long long labels;        // outer * inner
  long long inner;
  int classes;
  unsigned magic;          // regime kRows: i / classes ==
  int shift;               //   (umulhi(i, magic) + i) >> shift
  float grad_scale, ignore_label;
  float norm;              // kBatch: N; kValid without counting:
                           // max(outer * inner, 1)
  int use_ignore, norm_mode;
};

__device__ __forceinline__ bool is_class(float label, int c) {
  // the reference casts the label to int32 (truncation toward zero)
  return label > -2147483648.f && label < 2147483648.f && (int)label == c;
}

__device__ __forceinline__ float grad_of(const Args& a, float p, float l,
                                         int c, float div) {
  float v = __fsub_rn(p, is_class(l, c) ? 1.f : 0.f);
  if (a.use_ignore) v = __fmul_rn(v, l != a.ignore_label ? 1.f : 0.f);
  if (a.norm_mode != kNull) v = __fdiv_rn(v, div);
  return __fmul_rn(v, a.grad_scale);
}

__device__ __forceinline__ unsigned row_of(const Args& a, unsigned i) {
  return (__umulhi(i, a.magic) + i) >> a.shift;
}

// the count of valid labels over the grid: every block's own count into
// its slot, a grid barrier, then the slots added in integers
__device__ float valid_divisor(const Args& a) {
  __shared__ unsigned warp_sums[kThreads / 32];
  __shared__ float divisor;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned k = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.labels; i += stride)
    k += a.label[i] != a.ignore_label;
  for (int off = 16; off > 0; off >>= 1)
    k += __shfl_xor_sync(0xffffffffu, k, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += warp_sums[w];
    a.slots[blockIdx.x] = t;
  }
  cg::this_grid().sync();
  if (threadIdx.x < 32) {
    unsigned long long t = 0;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += 32)
      t += __ldcg(a.slots + b);
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0) divisor = fmaxf((float)t, 1.f);
  }
  __syncthreads();
  return divisor;
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
softmax_output_bwd_rows_kernel(const Args a) {
  const unsigned C = (unsigned)a.classes;
  const unsigned chunks = (unsigned)(a.total >> 2);
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (q < chunks) v = __ldcs(reinterpret_cast<const float4*>(a.p) + q);
  const float div = COUNT ? valid_divisor(a) : a.norm;
  for (; q < chunks; q += stride) {
    if (q != blockIdx.x * blockDim.x + threadIdx.x)
      v = __ldcs(reinterpret_cast<const float4*>(a.p) + q);
    const unsigned i = q * 4;
    unsigned row = row_of(a, i);
    unsigned c = i - row * C;
    float l = a.label[row];
    float in[4] = {v.x, v.y, v.z, v.w}, out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c == C) {
        c = 0;
        l = a.label[++row];
      }
      out[e] = grad_of(a, in[e], l, (int)c, div);
      ++c;
    }
    __stcs(reinterpret_cast<float4*>(a.g) + q,
           make_float4(out[0], out[1], out[2], out[3]));
  }
  // the last total % 4 elements
  const unsigned i = chunks * 4 + blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (unsigned)a.total) {
    const unsigned row = row_of(a, i);
    a.g[i] = grad_of(a, a.p[i], a.label[row], (int)(i - row * C), div);
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
softmax_output_bwd_general_kernel(const Args a) {
  const float div = COUNT ? valid_divisor(a) : a.norm;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < a.total; idx += stride) {
    const long long i = idx % a.inner;
    const long long t = idx / a.inner;
    const int c = (int)(t % a.classes);
    const long long o = t / a.classes;
    a.g[idx] = grad_of(a, a.p[idx], a.label[o * a.inner + i], c, div);
  }
}

using Kernel = void (*)(const Args);

Kernel kernel_of(int regime, bool count) {
  if (regime == kRows)
    return count ? softmax_output_bwd_rows_kernel<true>
                 : softmax_output_bwd_rows_kernel<false>;
  return count ? softmax_output_bwd_general_kernel<true>
               : softmax_output_bwd_general_kernel<false>;
}

// blocks of kThreads resident on the whole card at once, per device and
// kernel (the cooperative launch's limit, and the grid of every launch)
int resident_blocks(int regime, bool count, long long* out) {
  static long long cap[kMaxDevices][4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  long long& slot = cap[dev][regime * 2 + (count ? 1 : 0)];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of(regime, count), kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    slot = (long long)sms * per_sm;
  }
  *out = slot;
  return 0;
}

// the packed arguments of mxt_softmax_output_bwd_f32
// (kernels/softmax_output_bwd.py _PACK, "=4Q3q2d6qQ")
struct Packed {
  unsigned long long p, label, g, slots;
  long long outer, classes, inner;
  double grad_scale, ignore_label;
  long long use_ignore, norm_mode, batch, regime, magic, shift;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 16 * 8, "Packed: 16 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch (cooperative when it counts valid labels), as planned by the
// wrapper. norm_mode: 0 null, 1 batch, 2 valid. Returns
// cudaErrorInvalidValue for a plan that does not fit this call.
extern "C" int mxt_softmax_output_bwd_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long total = in.outer * in.classes * in.inner;
  if (total <= 0) return (int)cudaGetLastError();
  const int regime = (int)in.regime;
  const bool count = in.norm_mode == kValid && in.use_ignore;
  Args a;
  a.p = ptr<const float>(in.p);
  a.label = ptr<const float>(in.label);
  a.g = ptr<float>(in.g);
  a.slots = ptr<unsigned>(in.slots);
  a.total = total;
  a.labels = in.outer * in.inner;
  a.inner = in.inner;
  a.classes = (int)in.classes;
  a.magic = (unsigned)in.magic;
  a.shift = (int)in.shift;
  a.grad_scale = (float)in.grad_scale;
  a.ignore_label = (float)in.ignore_label;
  a.norm = in.norm_mode == kBatch ? (float)in.batch
                                  : fmaxf((float)a.labels, 1.f);
  a.use_ignore = (int)(in.use_ignore != 0);
  a.norm_mode = (int)in.norm_mode;
  const bool aligned = ((in.p | in.g) & 15) == 0;
  if ((regime != kRows && regime != kGeneral) || in.norm_mode < 0 ||
      in.norm_mode > 2 || in.classes >= (1LL << 31) ||
      (count && in.slots == 0) ||
      (regime == kRows &&
       (in.inner != 1 || !aligned || total >= (1LL << 31) ||
        in.shift < 0 || in.shift > 31 || (1LL << in.shift) < in.classes ||
        in.magic < 0 || in.magic >= (1LL << 32))))
    return (int)cudaErrorInvalidValue;
  long long cap = 0;
  const int err = resident_blocks(regime, count, &cap);
  if (err != 0) return err;
  const long long work = regime == kRows ? (total + 3) / 4 : total;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (count) {
    const long long lb = (a.labels + kThreads - 1) / kThreads;
    if (lb > blocks) blocks = lb;
  }
  if (blocks > cap) blocks = cap;
  if (count && blocks > kSlots) blocks = kSlots;
  const Kernel kern = kernel_of(regime, count);
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  if (!count) {
    kern<<<(unsigned)blocks, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kern, dim3((unsigned)blocks), dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
