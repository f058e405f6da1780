// SSD training targets: anchor matching, box encoding and hard-negative
// mining, float32.
//
// Replaces mxnet_tpu/ops/defs_contrib.py:_multibox_target (:150-213, with
// _iou_matrix :103 and _encode_boxes :116); see
// mxnet_tpu_torch/kernels/multibox_target.py for the wrapper and the plain
// version. Per image, with IoU -1 for a padded object (class < 0):
//
//   best_gt[a]   = first argmax_g IoU[a, g],  best_iou[a] its value
//   best_anc[g]  = first argmax_a IoU[a, g]   (anchor 0 for a padded row)
//   forced[a]    = valid[g] of the LAST g with best_anc[g] == a (the
//                  reference's scatter with duplicate indices: last wins)
//   matched      = forced | best_iou >= overlap_threshold
//   gt of a      = forced ? first argmax_g (hit ? IoU + 2 : IoU) : best_gt
//   loc_target   = _encode_boxes(gt, anchor) on matched anchors, else 0
//   loc_mask     = 1 on the four coordinates of a matched anchor
//   cls_target   = cls + 1 where matched; with mining, 0 for a candidate
//                  (unmatched, best_iou < negative_mining_thresh) whose
//                  rank in the stable ascending order of the background
//                  logits (-0.0 equal to 0.0; every other anchor at +inf)
//                  is below max(int(ratio * num_pos), min_neg), else
//                  ignore_label; without mining 0.
//
// IoU and the encoding are rounded as the reference's order of operations
// has them, one round-to-nearest intrinsic each (no FMA contraction): a
// match sits on `best_iou >= 0.5`, and an ulp flips it.
//
// Bound: device-memory bytes. At SSD-300 training, batch 32, A = 8096,
// G = 16: the background logits are read through the class-major view's
// stride (one 32-byte sector each, ~8 MB), the anchors once (0.13 MB), and
// 9.3 MB of targets are written. Design: one block of 1024 threads per
// image. The image's objects sit in shared memory; each object's best
// anchor comes from per-thread sweeps of the anchors and one warp-shuffle
// and cross-warp reduction (first index on ties); each thread then matches
// and encodes its anchors (a = tid, tid + 1024, ...). The mining rank needs
// no sort: each anchor's background logit becomes an order-preserving
// 32-bit key in shared memory, a 4-pass radix select (256-bin shared
// histograms) finds the key K of rank max_neg - 1 and how many anchors of
// key K it keeps, and a block scan over the anchors in index order keeps
// the first of those equal keys. Only 32 of the card's 132 SMs work at
// batch 32: a simple first design.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kInfKey = 0xFF800000u;  // the ordered key of +inf
constexpr float kEncEps = 1e-8f;           // _encode_boxes' eps

// candidate state of an anchor, in shared memory
constexpr unsigned char kMatched = 0, kCandidate = 1, kOther = 2;

__device__ __forceinline__ unsigned ordered_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0.0 sorts as 0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// _iou_matrix's order: max(0, min - max) per axis, inter / union where
// union > 0, else 0
__device__ __forceinline__ float iou_of(float ax1, float ay1, float ax2,
                                        float ay2, float area_a,
                                        const float* g, float area_g) {
  const float iw = fmaxf(0.f, __fsub_rn(fminf(ax2, g[2]), fmaxf(ax1, g[0])));
  const float ih = fmaxf(0.f, __fsub_rn(fminf(ay2, g[3]), fmaxf(ay1, g[1])));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(fmaxf(0.f, __fsub_rn(x2, x1)),
                   fmaxf(0.f, __fsub_rn(y2, y1)));
}

__global__ void __launch_bounds__(kThreads)
multibox_target_kernel(const float* __restrict__ anchors,
                       const float* __restrict__ label,
                       const float* __restrict__ bg,
                       float* __restrict__ loc_t, float* __restrict__ loc_m,
                       float* __restrict__ cls_t, int A, int G, long long W,
                       long long sn, long long sa, float thr, float ignore,
                       float ratio, float neg_thr, float v0, float v1,
                       float v2, float v3, int min_neg, int mining) {
  extern __shared__ float smem[];
  float* gt = smem;                       // G x [x1, y1, x2, y2]
  float* gcls = gt + 4 * G;               // G
  float* garea = gcls + G;                // G
  int* gvalid = (int*)(garea + G);        // G
  int* best_anc = gvalid + G;             // G
  float* wv = (float*)(best_anc + G);     // G x kWarps
  int* wi = (int*)(wv + G * kWarps);      // G x kWarps
  unsigned* key = (unsigned*)(wi + G * kWarps);  // A
  unsigned char* state = (unsigned char*)(key + A);  // A
  __shared__ unsigned hist[256];
  __shared__ int red[kWarps];
  __shared__ int sel[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* lb = label + (long long)b * G * W;
  for (int g = tid; g < G; g += kThreads) {
    const float* r = lb + g * W;
    gcls[g] = r[0];
    gvalid[g] = r[0] >= 0.f;
    gt[4 * g] = r[1];
    gt[4 * g + 1] = r[2];
    gt[4 * g + 2] = r[3];
    gt[4 * g + 3] = r[4];
    garea[g] = area_of(r[1], r[2], r[3], r[4]);
  }
  __syncthreads();

  // each object's best anchor: the first maximum of its IoU column
  for (int g = 0; g < G; ++g) {
    if (!gvalid[g]) continue;  // a column of -1: anchor 0
    float bv = -__int_as_float(0x7f800000);
    int bi = 0x7fffffff;
    for (int a = tid; a < A; a += kThreads) {
      const float* an = anchors + 4LL * a;
      const float v = iou_of(an[0], an[1], an[2], an[3],
                             area_of(an[0], an[1], an[2], an[3]), gt + 4 * g,
                             garea[g]);
      if (v > bv) {
        bv = v;
        bi = a;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      wv[g * kWarps + warp] = bv;
      wi[g * kWarps + warp] = bi;
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    int bi = 0;
    if (gvalid[g]) {
      float bv = wv[g * kWarps];
      bi = wi[g * kWarps];
      for (int w = 1; w < kWarps; ++w) {
        const float ov = wv[g * kWarps + w];
        const int oi = wi[g * kWarps + w];
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
    }
    best_anc[g] = bi;
  }
  __syncthreads();

  // match, encode, and mark the mining candidates
  const long long row = (long long)b * A;
  int pos_count = 0;
  for (int a = tid; a < A; a += kThreads) {
    const float* an = anchors + 4LL * a;
    const float ax1 = an[0], ay1 = an[1], ax2 = an[2], ay2 = an[3];
    const float area_a = area_of(ax1, ay1, ax2, ay2);
    float best = -1.f;
    int best_g = 0;
    bool forced = false;
    for (int g = 0; g < G; ++g) {
      const float v = gvalid[g] ? iou_of(ax1, ay1, ax2, ay2, area_a,
                                         gt + 4 * g, garea[g])
                                : -1.f;
      if (g == 0 || v > best) {
        best = v;
        best_g = g;
      }
      if (best_anc[g] == a) forced = gvalid[g] != 0;
    }
    const bool matched = forced || best >= thr;
    float* lt = loc_t + 4 * (row + a);
    float* lm = loc_m + 4 * (row + a);
    if (matched) {
      int mg = best_g;
      if (forced) {
        float fv = 0.f;
        for (int g = 0; g < G; ++g) {
          float v = gvalid[g] ? iou_of(ax1, ay1, ax2, ay2, area_a,
                                       gt + 4 * g, garea[g])
                              : -1.f;
          if (best_anc[g] == a && gvalid[g]) v = __fadd_rn(v, 2.f);
          if (g == 0 || v > fv) {
            fv = v;
            mg = g;
          }
        }
      }
      const float* m = gt + 4 * mg;
      const float aw = __fsub_rn(ax2, ax1), ah = __fsub_rn(ay2, ay1);
      const float acx = __fmul_rn(__fadd_rn(ax1, ax2), 0.5f);
      const float acy = __fmul_rn(__fadd_rn(ay1, ay2), 0.5f);
      const float gw = __fsub_rn(m[2], m[0]), gh = __fsub_rn(m[3], m[1]);
      const float gcx = __fmul_rn(__fadd_rn(m[0], m[2]), 0.5f);
      const float gcy = __fmul_rn(__fadd_rn(m[1], m[3]), 0.5f);
      const float awe = fmaxf(aw, kEncEps), ahe = fmaxf(ah, kEncEps);
      lt[0] = __fdiv_rn(__fdiv_rn(__fsub_rn(gcx, acx), awe), v0);
      lt[1] = __fdiv_rn(__fdiv_rn(__fsub_rn(gcy, acy), ahe), v1);
      lt[2] = __fdiv_rn(logf(fmaxf(__fdiv_rn(gw, awe), kEncEps)), v2);
      lt[3] = __fdiv_rn(logf(fmaxf(__fdiv_rn(gh, ahe), kEncEps)), v3);
      lm[0] = lm[1] = lm[2] = lm[3] = 1.f;
      cls_t[row + a] = __fadd_rn(gcls[mg], 1.f);
      state[a] = kMatched;
      key[a] = kInfKey;
      ++pos_count;
    } else {
      lt[0] = lt[1] = lt[2] = lt[3] = 0.f;
      lm[0] = lm[1] = lm[2] = lm[3] = 0.f;
      const bool cand = best < neg_thr;
      state[a] = cand ? kCandidate : kOther;
      key[a] = (mining && cand) ? ordered_key(bg[b * sn + a * sa]) : kInfKey;
      if (!mining) cls_t[row + a] = 0.f;
    }
  }
  if (!mining) return;

  // num_pos, then max_neg = max(int(ratio * num_pos), min_neg)
  for (int off = 16; off > 0; off >>= 1)
    pos_count += __shfl_down_sync(0xffffffffu, pos_count, off);
  if (lane == 0) red[warp] = pos_count;
  __syncthreads();
  int num_pos = 0;
  for (int w = 0; w < kWarps; ++w) num_pos += red[w];
  __syncthreads();  // red is reused below
  const int max_neg = max((int)__fmul_rn(ratio, (float)num_pos), min_neg);

  // the key of rank max_neg - 1 among all A keys, and how many anchors of
  // that key rank below max_neg
  unsigned kstar = kInfKey;
  int take = A;  // keep every anchor of key kstar
  if (max_neg <= 0) {
    kstar = 0u;
    take = 0;
  } else if (max_neg < A) {
    unsigned prefix = 0u, pmask = 0u;
    int r = max_neg - 1;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
      __syncthreads();
      for (int a = tid; a < A; a += kThreads) {
        const unsigned k = key[a];
        if ((k & pmask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        unsigned cum = 0u;
        int d = 0;
        for (; d < 255; ++d) {
          if (cum + hist[d] > (unsigned)r) break;
          cum += hist[d];
        }
        sel[0] = d;
        sel[1] = r - (int)cum;
      }
      __syncthreads();
      prefix |= (unsigned)sel[0] << shift;
      pmask |= 255u << shift;
      r = sel[1];
      __syncthreads();
    }
    kstar = prefix;
    take = r + 1;
  }

  // in index order: the first `take` anchors of key kstar are kept, and
  // every anchor of a smaller key
  __shared__ int woff[kWarps];
  __shared__ int tile_total;
  int carry = 0;
  for (int s = 0; s < A; s += kThreads) {
    const int a = s + tid;
    const bool live = a < A;
    const unsigned k = live ? key[a] : 0xffffffffu;
    const bool eq = live && k == kstar;
    const unsigned ball = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) red[warp] = __popc(ball);
    __syncthreads();
    if (warp == 0) {
      const int v = red[lane];
      int incl = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      woff[lane] = incl - v;
      if (lane == 31) tile_total = incl;
    }
    __syncthreads();
    if (live && state[a] != kMatched) {
      const int pos = carry + woff[warp] + __popc(ball & ((1u << lane) - 1u));
      const bool keep = state[a] == kCandidate &&
                        (k < kstar || (eq && pos < take));
      cls_t[row + a] = keep ? 0.f : ignore;
    }
    carry += tile_total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int mxt_multibox_target_f32(
    const void* anchors, const void* label, const void* bg, void* loc_t,
    void* loc_mask, void* cls_t, long long n, long long a, long long g,
    long long w, long long sn, long long sa, float thr, float ignore,
    float ratio, float neg_thr, float v0, float v1, float v2, float v3,
    int min_neg, int mining, void* stream) {
  if (n > 0 && a > 0) {
    const size_t smem = (size_t)g * (8 + 2 * kWarps) * 4 + (size_t)a * 5;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          multibox_target_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    multibox_target_kernel<<<(unsigned)n, kThreads, smem,
                             (cudaStream_t)stream>>>(
        (const float*)anchors, (const float*)label, (const float*)bg,
        (float*)loc_t, (float*)loc_mask, (float*)cls_t, (int)a, (int)g, w,
        sn, sa, thr, ignore, ratio, neg_thr, v0, v1, v2, v3, min_neg,
        mining);
  }
  return (int)cudaGetLastError();
}
