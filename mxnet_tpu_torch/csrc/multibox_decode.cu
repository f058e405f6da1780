// SSD detection head, per anchor: class softmax, best foreground class,
// and box decode. float32.
//
// Replaces the per-anchor part of mxnet_tpu/ops/defs_contrib.py
// _multibox_detection (:256-279: `_decode_boxes` :134-146, the foreground
// max/argmax) together with the channel SoftmaxActivation that feeds it on
// the SSD path (mxnet_tpu/ops/defs_nn.py:671-676); see
// mxnet_tpu_torch/kernels/multibox_decode.py for the wrapper, the plain
// version and the planner that picks the body. For one (image b, anchor a):
//
//   p_c   = exp(x_c - max_c x) / sum_c exp(x_c - max_c x)   (softmax = 1;
//           else p_c = x_c, already probabilities)
//   score = max_{c >= 1} p_c, cls = its first index minus 1
//   box   = decode(loc[b, a], anchor[a]) with the variances, clipped to
//           [0, 1] when clip is set
//
// Every product, sum and quotient is rounded once with round-to-nearest
// intrinsics in the reference's order (no FMA contraction), and the
// exponentials are expf, as jax.nn.softmax and jnp.exp compute them. Each
// exp(x_c - max) is computed once and kept; the argmax compares the rounded
// quotients, so the first index wins ties of the probabilities.
//
// The class scores arrive as a view (n, C+1, A) with strides (sn, sc, sa)
// in elements. On both SSD paths that is a transpose(0, 2, 1) of an (n, A,
// C+1) array (serving: the head's logits; training: softmax_rows'
// probabilities), so sc = 1 and sa = C+1: one thread per anchor reading
// its classes directly would make every warp load touch 32 addresses
// 4 (C+1) bytes apart. Nothing is copied; the kernel has a body for each
// layout:
//
//   rows     sc = 1, sa = C+1, the rows of all images contiguous and
//            16-byte aligned: a block of T anchors first stages its T (C+1)
//            contiguous floats in shared memory with coalesced 16-byte
//            loads; each thread then takes its row;
//   strided  any other strides or alignment: each thread reads its scores
//            through the strides into its column of shared memory (a
//            class-major view, sa = 1, makes these reads coalesced);
//   wide     more classes than a block's shared memory holds: the scores
//            read from device memory for each pass, each exponential
//            computed twice.
//
// Bound: device-memory bandwidth. The function reads the scores, the
// offsets and the anchors once and writes 24 bytes an anchor: at SSD-300,
// batch 8 (A = 8096, C+1 = 21) 5.4 MB of scores, 1.0 MB of offsets, 0.13 MB
// of anchors and 1.55 MB out, ~2.4 us at 3.35 TB/s; at batch 32 four times
// the scores, offsets and outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;  // the wrapper's ANCHORS
enum Body { kRows = 0, kStrided = 1, kWide = 2 };

struct Args {
  const float* cls;
  long long sn, sc, sa;
  const float* loc;
  const float* anchors;
  float* boxes;
  float* score;
  int* cls_id;
  long long total, a_count;
  int c1;
  float v0, v1, v2, v3;
  int clip, softmax;
};

// the decoded box of (image, anchor a) at flat index idx, written there
__device__ __forceinline__ void write_box(const Args& g, long long idx,
                                          long long a) {
  const float4 an = reinterpret_cast<const float4*>(g.anchors)[a];
  const float4 l = reinterpret_cast<const float4*>(g.loc)[idx];
  const float aw = __fsub_rn(an.z, an.x), ah = __fsub_rn(an.w, an.y);
  const float acx = __fdiv_rn(__fadd_rn(an.x, an.z), 2.f);
  const float acy = __fdiv_rn(__fadd_rn(an.y, an.w), 2.f);
  const float cx = __fadd_rn(__fmul_rn(__fmul_rn(l.x, g.v0), aw), acx);
  const float cy = __fadd_rn(__fmul_rn(__fmul_rn(l.y, g.v1), ah), acy);
  const float w = __fdiv_rn(__fmul_rn(expf(__fmul_rn(l.z, g.v2)), aw), 2.f);
  const float h = __fdiv_rn(__fmul_rn(expf(__fmul_rn(l.w, g.v3)), ah), 2.f);
  float4 out = make_float4(__fsub_rn(cx, w), __fsub_rn(cy, h),
                           __fadd_rn(cx, w), __fadd_rn(cy, h));
  if (g.clip) {
    out.x = fminf(fmaxf(out.x, 0.f), 1.f);
    out.y = fminf(fmaxf(out.y, 0.f), 1.f);
    out.z = fminf(fmaxf(out.z, 0.f), 1.f);
    out.w = fminf(fmaxf(out.w, 0.f), 1.f);
  }
  reinterpret_cast<float4*>(g.boxes)[idx] = out;
}

// The staged bodies: the thread's row of C+1 scores at `row` in shared
// memory, `rs` floats apart; the exponentials replace the scores there.
template <int BODY>
__global__ void __launch_bounds__(kMaxThreads)
multibox_decode_kernel(const Args g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int t = blockDim.x, c1 = g.c1;
  const long long i0 = (long long)blockIdx.x * t;
  const long long idx = i0 + threadIdx.x;
  float* row;
  int rs;
  if (BODY == kRows) {
    // the block's rows are contiguous: i0 (C+1) floats from the start, a
    // multiple of 4 since t is
    const int span = (int)(min((long long)t, g.total - i0) * c1);
    const float* src = g.cls + i0 * c1;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < span / 4; i += t)
      smem4[i] = __ldg(src4 + i);
    for (int i = (span & ~3) + threadIdx.x; i < span; i += t)
      sm[i] = __ldg(src + i);
    __syncthreads();
    row = sm + threadIdx.x * c1;
    rs = 1;
  } else {
    row = sm + threadIdx.x;
    rs = t;
  }
  if (idx >= g.total) return;
  const long long b = idx / g.a_count, a = idx - b * g.a_count;
  if (BODY != kRows) {
    const float* x = g.cls + b * g.sn + a * g.sa;
    for (int c = 0; c < c1; ++c) row[c * rs] = __ldg(x + c * g.sc);
  }

  float s = 1.f;
  if (g.softmax) {
    float m = row[0];
    for (int c = 1; c < c1; ++c) m = fmaxf(m, row[c * rs]);
    s = 0.f;
    for (int c = 0; c < c1; ++c) {
      const float e = expf(__fsub_rn(row[c * rs], m));
      row[c * rs] = e;
      s = __fadd_rn(s, e);
    }
  }
  float best = 0.f;
  int arg = 0;
  for (int c = 1; c < c1; ++c) {
    const float p = g.softmax ? __fdiv_rn(row[c * rs], s) : row[c * rs];
    if (c == 1 || p > best) {  // strictly greater: the first index wins
      best = p;
      arg = c - 1;
    }
  }
  g.score[idx] = best;
  g.cls_id[idx] = arg;
  write_box(g, idx, a);
}

// many classes: no staging; the scores are read for each pass
__global__ void __launch_bounds__(kMaxThreads)
multibox_decode_kernel_wide(const Args g) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.total) return;
  const long long b = idx / g.a_count, a = idx - b * g.a_count;
  const float* x = g.cls + b * g.sn + a * g.sa;
  const long long sc = g.sc;
  const int c1 = g.c1;
  float m = 0.f, s = 1.f;
  if (g.softmax) {
    m = x[0];
    for (int c = 1; c < c1; ++c) m = fmaxf(m, x[c * sc]);
    s = 0.f;
    for (int c = 0; c < c1; ++c)
      s = __fadd_rn(s, expf(__fsub_rn(x[c * sc], m)));
  }
  float best = 0.f;
  int arg = 0;
  for (int c = 1; c < c1; ++c) {
    const float p = g.softmax ? __fdiv_rn(expf(__fsub_rn(x[c * sc], m)), s)
                              : x[c * sc];
    if (c == 1 || p > best) {
      best = p;
      arg = c - 1;
    }
  }
  g.score[idx] = best;
  g.cls_id[idx] = arg;
  write_box(g, idx, a);
}

// The wrapper's packed arguments, struct format "=6Q6q4d6qQ": cls, loc,
// anchors, boxes, score, cls_id, sn, sc, sa, n, c1, a, v0..v3, clip,
// softmax, the plan's body, threads (anchors a block), grid and dynamic
// shared-memory bytes, the stream.
struct Packed {
  unsigned long long cls, loc, anchors, boxes, score, cls_id;
  long long sn, sc, sa, n, c1, a;
  double v0, v1, v2, v3;
  long long clip, softmax, body, threads, grid, smem;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 23 * 8, "Packed: 23 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch, as planned by the wrapper. Returns cudaErrorInvalidValue for
// a plan that does not fit this call.
extern "C" int mxt_multibox_decode_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long total = in.n * in.a;
  if (total <= 0) return (int)cudaGetLastError();
  const long long t = in.threads, grid = in.grid;
  if (t < 32 || t > kMaxThreads || t % 32 != 0 || grid < 1 ||
      grid >= (1LL << 31) || grid * t < total || in.smem > 48 * 1024 ||
      in.c1 < 2 || in.c1 >= (1LL << 24) ||
      (in.body != kWide && in.smem < t * in.c1 * 4) ||
      (in.body == kRows && (in.sc != 1 || in.sa != in.c1 ||
                            (in.n > 1 && in.sn != in.a * in.c1) ||
                            in.cls % 16 != 0)) ||
      (in.loc | in.anchors) % 16)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.cls = ptr<const float>(in.cls);
  g.sn = in.sn;
  g.sc = in.sc;
  g.sa = in.sa;
  g.loc = ptr<const float>(in.loc);
  g.anchors = ptr<const float>(in.anchors);
  g.boxes = ptr<float>(in.boxes);
  g.score = ptr<float>(in.score);
  g.cls_id = ptr<int>(in.cls_id);
  g.total = total;
  g.a_count = in.a;
  g.c1 = (int)in.c1;
  g.v0 = (float)in.v0;
  g.v1 = (float)in.v1;
  g.v2 = (float)in.v2;
  g.v3 = (float)in.v3;
  g.clip = (int)in.clip;
  g.softmax = (int)in.softmax;
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  const unsigned blocks = (unsigned)grid, threads = (unsigned)t;
  const size_t smem = (size_t)in.smem;
  switch (in.body) {
    case kRows:
      multibox_decode_kernel<kRows><<<blocks, threads, smem, st>>>(g);
      break;
    case kStrided:
      multibox_decode_kernel<kStrided><<<blocks, threads, smem, st>>>(g);
      break;
    case kWide:
      multibox_decode_kernel_wide<<<blocks, threads, 0, st>>>(g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
