// SSD training targets: anchor matching, box encoding and hard-negative
// mining, float32.
//
// Replaces mxnet_tpu/ops/defs_contrib.py:_multibox_target (:150-213, with
// _iou_matrix :103 and _encode_boxes :116); see
// mxnet_tpu_torch/kernels/multibox_target.py for the wrapper, the plain
// version and the planner. Per image, with IoU -1 for a padded object
// (class < 0):
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
// 9.3 MB of targets are written; the (A, G) IoUs (~4.1 M) are the work.
//
// Design: each image is a thread-block cluster of kCluster blocks of
// kThreads, each block a contiguous span of the anchors (the planner's
// span) and each thread a contiguous run of `apt` of them, so the
// cluster's ranks, the threads and a thread's anchors lie in index order.
// 1. The background logits stream into shared memory (cp.async) while the
//    IoUs are computed.
// 2. Every (anchor, valid object) IoU is computed once (a division only
//    where the boxes meet; a padded row's -1 never wins, so it is
//    skipped), two anchors a thread at a time: folded at once into the
//    anchor's row maximum (in shared memory across sweeps of kGC objects)
//    and the object's column maximum (kGC pairs in registers). A warp
//    reduces its columns by a transposed shuffle tree (each step halves
//    the objects a lane holds), the block over its warps.
// 3. Each anchor's mining key (its background logit as an order-preserving
//    32-bit key) is set as if no anchor were forced, since the forced
//    matches need the whole image, and counted into a 256-bin histogram
//    of top bytes; the threshold matches are counted.
// 4. One cluster barrier. Every block reads the ranks' column maxima
//    (each object's best anchor, the first on ties), match counts and
//    histograms through distributed shared memory, finds the forced
//    anchors (each the last object row's choice; only their IoUs are
//    computed again), and corrects for them: num_pos, and each forced
//    candidate's key moved to +inf.
// 5. The key K* of rank max_neg - 1 without a sort: its top byte from the
//    corrected histogram, the others a pass each (every block counts its
//    keys of the prefix, a cluster barrier, the sums corrected the same
//    way); one warp picks each bin by a parallel prefix.
// 6. Every block writes its anchors' targets a tile of kThreads at a time
//    (contiguous 16-byte rows of loc_target and loc_mask in every warp);
//    where fewer keys equal to K* are kept than exist, a scan in index
//    order from the lower ranks' count keeps the first of them.
// The global writes come last, so that no cluster barrier waits for them;
// a block leaves only after every block has read its shared memory (a
// relaxed split barrier). On the H100, clusters of 2 blocks of 1024
// threads ran SSD's call in the least device time of 2, 4 or 8 blocks of
// 256, 512 or 1024 threads (PERF.md).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // a block's threads
constexpr int kGC = 16;  // objects a column sweep keeps in registers
static_assert(kGC == 16, "the warp's transposed reduction takes 4 steps");
constexpr int kCluster = 2;     // blocks an image takes
static_assert(kCluster == 2, "sum_cluster adds two ranks' histograms");
constexpr unsigned kInfKey = 0xFF800000u;  // the ordered key of +inf
constexpr float kEncEps = 1e-8f;           // _encode_boxes' eps
constexpr unsigned kFull = 0xffffffffu;


struct Args {
  const float* anchors;
  const float* label;
  const float* bg;
  float* loc_t;
  float* loc_m;
  float* cls_t;
  int A, G;
  long long W, sn, sa;
  float thr, ignore, ratio, neg_thr, v0, v1, v2, v3;
  int min_neg, mining;
  int span;  // anchors a block takes
  int apt;   // anchors a thread takes
};

__device__ __forceinline__ unsigned ordered_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0.0 sorts as 0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// _iou_matrix's order: max(0, min - max) per axis, inter / union where
// union > 0, else 0. inter is +0.0 or more (or NaN, from inf * 0, where
// the union is NaN too): 0 / union is +0.0 for a positive union, so boxes
// that do not meet need no division.
__device__ __forceinline__ float iou_of(float ax1, float ay1, float ax2,
                                        float ay2, float area_a, float4 g,
                                        float area_g) {
  const float iw = fmaxf(0.f, __fsub_rn(fminf(ax2, g.z), fmaxf(ax1, g.x)));
  const float ih = fmaxf(0.f, __fsub_rn(fminf(ay2, g.w), fmaxf(ay1, g.y)));
  const float inter = __fmul_rn(iw, ih);
  if (!(inter > 0.f)) return 0.f;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(fmaxf(0.f, __fsub_rn(x2, x1)),
                   fmaxf(0.f, __fsub_rn(y2, y1)));
}

// (v, i) beats (bv, bi): the larger value, the smaller index on ties
__device__ __forceinline__ void take_best(float& bv, int& bi, float v,
                                          int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// the split barrier that keeps every block's shared memory alive until
// the last remote read: it orders no memory, so a block's own global
// stores do not hold it up
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// One warp: the bin of h (8 bins a lane, 256 in all) that holds the key
// of rank r, by a prefix over the bins. The results in sel: the bin, r
// less the keys of the bins below it, and the bin's count.
__device__ __forceinline__ void pick_bin(const unsigned (&h)[8], int r,
                                         int lane, int* sel) {
  unsigned total = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) total += h[i];
  unsigned incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  const unsigned ball = __ballot_sync(kFull, incl > (unsigned)r);
  if (lane == __ffs(ball) - 1) {
    unsigned cum = incl - total, count = 0u;
    int bin = 0;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!found && cum + h[i] > (unsigned)r) {
        found = true;
        bin = i;
        count = h[i];
      } else if (!found) {
        cum += h[i];
      }
    }
    sel[0] = 8 * lane + bin;
    sel[1] = r - (int)cum;
    sel[2] = (int)count;
  }
}

// lane's 8 bins of the sum of the cluster's histograms `hist`, through
// distributed shared memory, both ranks' loads in flight at once
__device__ __forceinline__ void sum_cluster(cg::cluster_group& cluster,
                                            unsigned* hist, int lane,
                                            unsigned (&h)[8]) {
  uint4 lo[kCluster], hi[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    const uint4* hp =
        reinterpret_cast<const uint4*>(cluster.map_shared_rank(hist, r)) +
        2 * lane;
    lo[r] = hp[0];
    hi[r] = hp[1];
  }
  h[0] = lo[0].x + lo[1].x;
  h[1] = lo[0].y + lo[1].y;
  h[2] = lo[0].z + lo[1].z;
  h[3] = lo[0].w + lo[1].w;
  h[4] = hi[0].x + hi[1].x;
  h[5] = hi[0].y + hi[1].y;
  h[6] = hi[0].z + hi[1].z;
  h[7] = hi[0].w + hi[1].w;
}

// adds d to the count of key kk's bin (its byte at `shift`) in lane's 8
// bins, if kk has the prefix of this pass
__device__ __forceinline__ void move_bin(unsigned (&h)[8], unsigned kk,
                                         unsigned prefix, unsigned pmask,
                                         int shift, int lane, int d) {
  if ((kk & pmask) != prefix) return;
  const unsigned bin = (kk >> shift) & 255u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (bin == 8u * lane + i) h[i] += (unsigned)d;
}

// anchors a thread takes at a time (four at a time spilled registers at
// 1024 threads and ran slower on the H100)
constexpr int kGroup = 2;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
multibox_target_kernel(const Args a) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float4 smem4[];
  const int G = a.G;
  float4* gt = smem4;                      // G x [x1, y1, x2, y2]
  float* gcls = (float*)(gt + G);          // G
  float* garea = gcls + G;                 // G
  float* colv = garea + G;                 // G: the block's column maxima
  int* gvalid = (int*)(colv + G);          // G
  int* best_anc = gvalid + G;              // G
  int* coli = best_anc + G;                // G: ... and their anchors
  unsigned* fkey = (unsigned*)(coli + G);  // G: the key a forced anchor
                                           //   had as a candidate, or 0
  int* vidx = (int*)(fkey + G);            // G: the valid objects
  unsigned* fcand = (unsigned*)(vidx + G);  // G: the forced candidates'
                                            //   keys, n_fcand of them
  float* rbv = (float*)(fcand + G);        // span: each anchor's best IoU
  int* rbg = (int*)(rbv + a.span);         // span: ... and its object
  int* flast = rbg + a.span;               // span: the last object that
                                           //   chose the anchor, or -1
  unsigned* key = (unsigned*)(flast + a.span);  // span: the mining keys as
                                                //   if no anchor were forced
  __shared__ float wv[kGC][kWarps];
  __shared__ int wi[kGC][kWarps];
  __shared__ __align__(16) unsigned hist[4][256];  // this block's keys,
                                                   //   a byte a pass
  __shared__ int wcount[kWarps];
  __shared__ int thr_total, mode, sel[3], eq_base, n_valid, n_fcand;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;  // the image
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a0 = rank * a.span;  // the block's first anchor
  const int count = max(0, min(a.span, a.A - a0));
  const int l0 = min(tid * a.apt, count), l1 = min(l0 + a.apt, count);
  const long long row = (long long)b * a.A;
  const float* bg = a.bg + b * a.sn;
  const float ninf = -__int_as_float(0x7f800000);

  // the background logits stream into shared memory (as raw bits in key)
  // while the IoUs are computed
  if (a.mining)
    for (int l = l0; l < l1; ++l)
      __pipeline_memcpy_async(key + l, bg + (a0 + l) * a.sa, 4);
  __pipeline_commit();
  const float* lb = a.label + (long long)b * G * a.W;
  for (int g = tid; g < G; g += kThreads) {
    const float* r = lb + g * a.W;
    gcls[g] = r[0];
    gvalid[g] = r[0] >= 0.f;
    gt[g] = make_float4(r[1], r[2], r[3], r[4]);
    garea[g] = area_of(r[1], r[2], r[3], r[4]);
  }
  for (int i = tid; i < 4 * 256; i += kThreads) (&hist[0][0])[i] = 0u;
  for (int l = l0; l < l1; ++l) {
    flast[l] = -1;
    rbv[l] = -1.f;  // no valid object: the first row's -1
    rbg[l] = 0;
  }
  __syncthreads();
  if (tid == 0) {  // the valid objects in order (a padded row's IoUs are
                   // -1, beaten by any other and by none)
    int n = 0;
    for (int g = 0; g < G; ++g)
      if (gvalid[g]) vidx[n++] = g;
    n_valid = n;
    n_fcand = 0;
  }
  __syncthreads();

  // every IoU once: each anchor's row maximum, each object's column
  // maximum over the block's anchors (first index on ties throughout);
  // kGroup anchors at a time, so each object is read once for them all
  const int nv = n_valid;
  for (int g0 = 0; g0 < nv; g0 += kGC) {
    float cv[kGC];
    int ci[kGC];
#pragma unroll
    for (int u = 0; u < kGC; ++u) {
      cv[u] = ninf;
      ci[u] = 0x7fffffff;
    }
    for (int l = l0; l < l1; l += kGroup) {
      float4 p[kGroup];
      float pa[kGroup], pv[kGroup];
      int pg[kGroup];
      bool live[kGroup];
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        live[e] = l + e < l1;
        p[e] = __ldg(reinterpret_cast<const float4*>(a.anchors) + a0 +
                     (live[e] ? l + e : l));
        pa[e] = area_of(p[e].x, p[e].y, p[e].z, p[e].w);
        pv[e] = live[e] ? rbv[l + e] : 0.f;
        pg[e] = live[e] ? rbg[l + e] : 0;
      }
#pragma unroll
      for (int u = 0; u < kGC; ++u) {
        if (g0 + u < nv) {
          const int g = vidx[g0 + u];
          const float4 o = gt[g];
          const float oa = garea[g];
#pragma unroll
          for (int e = 0; e < kGroup; ++e) {
            const float v =
                iou_of(p[e].x, p[e].y, p[e].z, p[e].w, pa[e], o, oa);
            if (live[e] && v > cv[u]) {
              cv[u] = v;
              ci[u] = a0 + l + e;
            }
            if (v > pv[e]) {
              pv[e] = v;
              pg[e] = g;
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        if (live[e]) {
          rbv[l + e] = pv[e];
          rbg[l + e] = pg[e];
        }
      }
    }
    // the warp's maxima: each step a lane keeps the half of its objects
    // that its lane bit names and takes its partner's partial of them;
    // after four steps lane pair (2o, 2o + 1) holds object o's
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int half = (kGC / 2) >> step, off = 16 >> step;
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int u = 0; u < kGC / 2; ++u) {
        if (u < half) {
          float kv = upper ? cv[u + half] : cv[u];
          int ki = upper ? ci[u + half] : ci[u];
          const float ov =
              __shfl_xor_sync(kFull, upper ? cv[u] : cv[u + half], off);
          const int oi =
              __shfl_xor_sync(kFull, upper ? ci[u] : ci[u + half], off);
          take_best(kv, ki, ov, oi);
          cv[u] = kv;
          ci[u] = ki;
        }
      }
    }
    take_best(cv[0], ci[0], __shfl_xor_sync(kFull, cv[0], 1),
              __shfl_xor_sync(kFull, ci[0], 1));
    if (!(lane & 1)) {
      wv[lane >> 1][warp] = cv[0];
      wi[lane >> 1][warp] = ci[0];
    }
    __syncthreads();
    // the block's maxima: warp w takes objects w, w + kWarps, ...
    for (int u = warp; u < kGC && g0 + u < nv; u += kWarps) {
      float v = lane < kWarps ? wv[u][lane] : ninf;
      int i = lane < kWarps ? wi[u][lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_best(v, i, __shfl_xor_sync(kFull, v, off),
                  __shfl_xor_sync(kFull, i, off));
      if (lane == 0) {
        colv[vidx[g0 + u]] = v;
        coli[vidx[g0 + u]] = i;
      }
    }
    __syncthreads();  // wv and wi are written again by the next sweep
  }

  // each anchor's key as if no anchor were forced (a candidate's ordered
  // background logit, else +inf), counted by top byte, and the threshold
  // matches counted
  __pipeline_wait_prior(0);
  int thr_matched = 0;
  for (int l = l0; l < l1; ++l) {
    const float best = rbv[l];
    unsigned kk = kInfKey;
    if (best >= a.thr)
      ++thr_matched;
    else if (a.mining && best < a.neg_thr)
      kk = ordered_key(__uint_as_float(key[l]));
    key[l] = kk;
    if (a.mining) atomicAdd(&hist[0][kk >> 24], 1u);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    thr_matched += __shfl_xor_sync(kFull, thr_matched, off);
  if (lane == 0) wcount[warp] = thr_matched;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += wcount[w];
    thr_total = t;
  }

  // every block's column maxima, threshold matches and keys' top bytes
  cluster.sync();

  // each object's best anchor from every rank's partial (anchor 0 for a
  // padded row); each anchor of this block learns the last object that
  // chose it; and every block finds the forced anchors of the image that
  // were candidates in the keys above
  for (int g = tid; g < G; g += kThreads) {
    float v = ninf;
    int i = 0;  // a padded row's: anchor 0
    if (gvalid[g]) {
      float rv[kCluster];
      int ri[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        rv[r] = cluster.map_shared_rank(colv, r)[g];
        ri[r] = cluster.map_shared_rank(coli, r)[g];
      }
      i = 0x7fffffff;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) take_best(v, i, rv[r], ri[r]);
    }
    best_anc[g] = i;
    if (i >= a0 && i < a0 + count) atomicMax(flast + (i - a0), g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    const int an = best_anc[g];
    bool last = gvalid[g] != 0;
    for (int h = g + 1; h < G && last; ++h) last = best_anc[h] != an;
    unsigned fk = 0u;  // 0: no correction (0 is no candidate's key)
    if (last) {
      // anchor an is forced: its best IoU decides what it was above
      const float4 p = __ldg(reinterpret_cast<const float4*>(a.anchors) + an);
      const float logit = a.mining ? __ldg(bg + an * a.sa) : 0.f;
      const float pa = area_of(p.x, p.y, p.z, p.w);
      float best = 0.f;
      for (int h = 0; h < G; ++h) {
        const float v =
            gvalid[h] ? iou_of(p.x, p.y, p.z, p.w, pa, gt[h], garea[h]) : -1.f;
        if (h == 0 || v > best) best = v;
      }
      if (best >= a.thr)
        fk = 1u;  // a threshold match already
      else if (a.mining && best < a.neg_thr)
        fk = ordered_key(logit);
      else
        fk = 2u;  // +inf already, counted as no match
    }
    fkey[g] = fk;
    if (fk >= 3u) fcand[atomicAdd(&n_fcand, 1)] = fk;
  }
  __syncthreads();
  if (warp == 0) {
    // num_pos: the threshold matches, and each forced anchor that was not
    // one; the top byte's histogram with the forced candidates moved to
    // +inf; then max_neg = max(int(ratio * num_pos), min_neg)
    int num_pos =
        lane < kCluster ? *cluster.map_shared_rank(&thr_total, lane) : 0;
    unsigned h[8];
    if (a.mining) sum_cluster(cluster, hist[0], lane, h);
    for (int g = lane; g < G; g += 32) num_pos += fkey[g] >= 2u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      num_pos += __shfl_xor_sync(kFull, num_pos, off);
    for (int f = 0; f < n_fcand; ++f) {
      move_bin(h, fcand[f], 0u, 0u, 24, lane, -1);
      move_bin(h, kInfKey, 0u, 0u, 24, lane, 1);
    }
    const int max_neg =
        max((int)__fmul_rn(a.ratio, (float)num_pos), a.min_neg);
    // 0: no candidate kept; 1: every one; 2: the select decides
    const int m = !a.mining ? 0 : max_neg <= 0 ? 0 : max_neg >= a.A ? 1 : 2;
    if (m == 2) pick_bin(h, max_neg - 1, lane, sel);
    if (lane == 0) mode = m;
  }
  __syncthreads();
  if (mode != 2) cluster_arrive();  // the last read of another block


  // the other three bytes of K*, 8 bits a pass: each block counts its keys
  // of the prefix so far, and after a barrier every block adds the
  // cluster's counts, with each forced candidate moved to +inf
  unsigned kstar = 0u;
  int take = 0, lower = 0;
  bool scan = false;
  if (mode == 2) {
    unsigned pmask = 0xFF000000u;
    kstar = (unsigned)sel[0] << 24;
    for (int p = 1; p < 4; ++p) {
      const int shift = 24 - 8 * p;
      const int r = sel[1];
      for (int l = l0; l < l1; ++l) {
        const unsigned kk = key[l];
        if ((kk & pmask) == kstar)
          atomicAdd(&hist[p][(kk >> shift) & 255u], 1u);
      }
      cluster.sync();
      if (warp == 0) {
        unsigned h[8];
        sum_cluster(cluster, hist[p], lane, h);
        for (int f = 0; f < n_fcand; ++f) {
          move_bin(h, fcand[f], kstar, pmask, shift, lane, -1);
          move_bin(h, kInfKey, kstar, pmask, shift, lane, 1);
        }
        pick_bin(h, r, lane, sel);
      }
      __syncthreads();
      kstar |= (unsigned)sel[0] << shift;
      pmask |= 255u << shift;
    }
    take = sel[1] + 1;
    // keep the first `take` anchors of key K* in index order: all of them
    // unless fewer are kept than exist (sel[2]), and then the count of the
    // lower ranks (their last histograms' bin, with their forced
    // candidates moved) starts this block's
    scan = take < sel[2];
    if (scan && warp == 0) {
      int c = lane < rank ? (int)cluster.map_shared_rank(
                                &hist[3][0], lane)[kstar & 255u]
                          : 0;
      for (int g = lane; g < G; g += 32) {
        const unsigned fk = fkey[g];
        if (fk >= 3u && best_anc[g] < a0)
          c += (kInfKey == kstar) - (fk == kstar);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(kFull, c, off);
      if (lane == 0) eq_base = c;
    }
    __syncthreads();
    lower = eq_base;
    cluster_arrive();  // the last read of another block
  }

  // match and encode (loc_target and loc_mask as 16-byte rows), and mine:
  // the block's anchors a tile of kThreads at a time, so every warp's
  // stores are contiguous; in index order the candidates of keys below K*
  // are kept, and of key K* the first `take` (a forced anchor is matched,
  // its key +inf)
  int carry = lower;  // keys equal to K* before this tile
  for (int t0 = 0; t0 < count; t0 += kThreads) {
    const int l = t0 + tid;
    const bool live = l < count;
    const int an = a0 + l;
    const int last = live ? flast[l] : -1;
    const bool forced = last >= 0 && gvalid[last];
    const unsigned kk = !live ? 0u : forced ? kInfKey : key[l];
    int at = carry;
    if (scan) {
      const unsigned ball = __ballot_sync(kFull, live && kk == kstar);
      if (lane == 0) wcount[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? wcount[w] : 0;
        total += wcount[w];
      }
      at += before + __popc(ball & ((1u << lane) - 1u));
      carry += total;
      __syncthreads();  // wcount is written again by the next tile
    }
    if (!live) continue;
    float4 lt = make_float4(0.f, 0.f, 0.f, 0.f), lm = lt;
    if (forced || rbv[l] >= a.thr) {
      const float4 p = __ldg(reinterpret_cast<const float4*>(a.anchors) + an);
      int mg = rbg[l];
      if (forced) {
        // the first maximum of IoU + 2 over the objects that chose this
        // anchor: every other object's IoU is at most 1
        const float pa = area_of(p.x, p.y, p.z, p.w);
        float fv = 0.f;
        bool first = true;
        for (int g = 0; g <= last; ++g) {
          if (best_anc[g] != an || !gvalid[g]) continue;
          const float v = __fadd_rn(
              iou_of(p.x, p.y, p.z, p.w, pa, gt[g], garea[g]), 2.f);
          if (first || v > fv) {
            fv = v;
            mg = g;
            first = false;
          }
        }
      }
      const float4 m = gt[mg];
      const float aw = __fsub_rn(p.z, p.x), ah = __fsub_rn(p.w, p.y);
      const float acx = __fmul_rn(__fadd_rn(p.x, p.z), 0.5f);
      const float acy = __fmul_rn(__fadd_rn(p.y, p.w), 0.5f);
      const float gw = __fsub_rn(m.z, m.x), gh = __fsub_rn(m.w, m.y);
      const float gcx = __fmul_rn(__fadd_rn(m.x, m.z), 0.5f);
      const float gcy = __fmul_rn(__fadd_rn(m.y, m.w), 0.5f);
      const float awe = fmaxf(aw, kEncEps), ahe = fmaxf(ah, kEncEps);
      lt.x = __fdiv_rn(__fdiv_rn(__fsub_rn(gcx, acx), awe), a.v0);
      lt.y = __fdiv_rn(__fdiv_rn(__fsub_rn(gcy, acy), ahe), a.v1);
      lt.z = __fdiv_rn(logf(fmaxf(__fdiv_rn(gw, awe), kEncEps)), a.v2);
      lt.w = __fdiv_rn(logf(fmaxf(__fdiv_rn(gh, ahe), kEncEps)), a.v3);
      lm = make_float4(1.f, 1.f, 1.f, 1.f);
      a.cls_t[row + an] = __fadd_rn(gcls[mg], 1.f);
    } else {
      const bool keep =
          a.mining && rbv[l] < a.neg_thr &&
          (mode == 1 ||
           (mode == 2 &&
            (kk < kstar || (kk == kstar && (!scan || at < take)))));
      a.cls_t[row + an] = keep || !a.mining ? 0.f : a.ignore;
    }
    reinterpret_cast<float4*>(a.loc_t)[row + an] = lt;
    reinterpret_cast<float4*>(a.loc_m)[row + an] = lm;
  }
  cluster_wait();
}

constexpr int kMaxDevices = 64;
// the dynamic shared memory the kernel is opted into on each device so far
std::atomic<long long> g_smem_set[kMaxDevices];

// opts the kernel into `smem` bytes of dynamic shared memory on the
// current device, once per device and size beyond the default 48 KB
int ensure_smem(long long smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::atomic<long long>* set = dev < kMaxDevices ? &g_smem_set[dev] : nullptr;
  if (set != nullptr && set->load() >= smem) return 0;
  err = cudaFuncSetAttribute(multibox_target_kernel,
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

// The wrapper's packed arguments, struct format "=6Q6q8d5qQ": anchors,
// label, the background logits, loc_target, loc_mask, cls_target, n, A,
// G, the label's row width, the logits' image and anchor strides, the
// overlap threshold, ignore_label, the mining ratio and threshold, the four
// variances, min_neg, mining, the plan's span, apt and dynamic shared
// memory, the stream.
struct Packed {
  unsigned long long anchors, label, bg, loc_t, loc_m, cls_t;
  long long n, a, g, w, sn, sa;
  double thr, ignore, ratio, neg_thr, v0, v1, v2, v3;
  long long min_neg, mining, span, apt, smem;
  unsigned long long stream;
};
static_assert(sizeof(Packed) == 26 * 8, "Packed: 26 fields of 8 bytes");

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

// One launch of n clusters of kCluster blocks, as planned by the wrapper.
// Returns cudaErrorInvalidValue for a plan that does not fit this call.
extern "C" int mxt_multibox_target_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  if (in.n <= 0 || in.a <= 0) return (int)cudaGetLastError();
  if (in.g < 1 || in.a >= (1LL << 31) || in.n * kCluster >= (1LL << 31) ||
      in.span < 1 || in.span * kCluster < in.a ||
      in.apt * kThreads < in.span || in.smem < 52 * in.g + 16 * in.span ||
      (in.anchors | in.loc_t | in.loc_m) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int err = ensure_smem(in.smem);
  if (err != 0) return err;
  Args a;
  a.anchors = ptr<const float>(in.anchors);
  a.label = ptr<const float>(in.label);
  a.bg = ptr<const float>(in.bg);
  a.loc_t = ptr<float>(in.loc_t);
  a.loc_m = ptr<float>(in.loc_m);
  a.cls_t = ptr<float>(in.cls_t);
  a.A = (int)in.a;
  a.G = (int)in.g;
  a.W = in.w;
  a.sn = in.sn;
  a.sa = in.sa;
  a.thr = (float)in.thr;
  a.ignore = (float)in.ignore;
  a.ratio = (float)in.ratio;
  a.neg_thr = (float)in.neg_thr;
  a.v0 = (float)in.v0;
  a.v1 = (float)in.v1;
  a.v2 = (float)in.v2;
  a.v3 = (float)in.v3;
  a.min_neg = (int)in.min_neg;
  a.mining = (int)in.mining;
  a.span = (int)in.span;
  a.apt = (int)in.apt;
  multibox_target_kernel<<<(unsigned)(in.n * kCluster), kThreads,
                           (size_t)in.smem, ptr<CUstream_st>(in.stream)>>>(a);
  return (int)cudaGetLastError();
}
