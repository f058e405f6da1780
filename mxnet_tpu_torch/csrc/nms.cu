// Greedy non-maximum suppression of SSD detections, float32 boxes.
//
// Replaces mxnet_tpu/ops/defs_contrib.py:_nms_keep (:234-253) and the
// assembly of _multibox_detection's rows (:274-277); see
// mxnet_tpu_torch/kernels/nms.py for the wrapper, the planner and the plain
// version. Per image, with the anchors taken in `order` (the stable
// descending sort of the scores):
//
//   valid_i = score_i > threshold
//   sup(i, j) = iou(i, j) > nms_threshold && (force || cls_i == cls_j)
//   keep_i = valid_i && no kept j before i has sup(j, i)
//
// and the output row of anchor a is (keep ? cls : -1, score, box), in
// anchor order. A box that is not kept (invalid or suppressed) never
// suppresses another.
//
// IoU is computed exactly as _iou_matrix (:103-113) does, each operation
// rounded once with round-to-nearest intrinsics (no FMA contraction), and
// compared strictly against the threshold in float32, so the keep mask is
// the reference's bit for bit on the same inputs. iou(i, j) == iou(j, i)
// exactly (min, max, + and * commute), and a box's area is the same value
// wherever it is computed.
//
// Bound: operations, the same-class IoUs that the kept boxes need (~15
// flops each): 17.1 M at SSD-300 batch 8, 38.8 M at batch 32. What holds a
// greedy NMS back on this card is the dependency chain, not the IoUs: a
// box's fate waits on every kept box before it.
//
// Design: segments. Without force_suppress a box only suppresses boxes of
// its own class, so the keep decisions of class c depend only on class c's
// valid boxes, taken in the same order: greedy NMS splits exactly into
// (image, class) segments. With force, or without the class count, the
// segment is the image's valid boxes (the class test then stays in the
// IoU test). A segment's block walks the image's `order` and gathers its
// members (valid, of its class) by a stable ballot compaction, in sorted
// order: no sort, no atomics. Block 0 of each image also writes the rows
// of the image's invalid anchors on that walk, so every row is written
// exactly once. The classes are far from even: on SSD-300's random-weight
// heads the longest of 20 classes holds 2480 of an image's 8096 valid
// boxes (median 238), so the segments take two routes by length:
//
// - short (at most L_max = 256 boxes: nms_segment_kernel, grid (segments,
//   images), everything in 8.3 KB of shared memory, several blocks an SM):
//   diagonal words (for every box, the later boxes of its 64-box chunk it
//   suppresses), then chunk by chunk warp 0 resolves the chunk's boxes
//   against what earlier chunks removed (boxes no box of the chunk
//   suppresses at once, the rest one step per kept box) and every
//   later box not removed yet is tested against the chunk's kept boxes
//   alone. Only kept boxes' IoUs are computed, and the IoU's comparison
//   with the threshold skips the division wherever a margin decides it
//   exactly (Thr).
// - long (more than L_max): the tests of one chain on one SM grow as L^2
//   (0.65 ms for 2480 boxes), so the segment block writes the members to
//   the scratch and two more launches spread the IoUs over the card:
//   nms_mask_kernel computes the upper-triangle suppression words of every
//   long segment, one 64 x 64 tile a block at a time over a fixed grid
//   (tiles enumerated from the segment kernel's descriptors), stored word
//   by word so that a tile's 64 rows are consecutive (coalesced); then
//   nms_chain_kernel, one block per long segment, resolves its chunks
//   from the diagonal words (the next chunk's prefetched while the current
//   one runs) and ORs each kept row's later words into a removed bitmap in
//   shared memory, one warp a word, 64 consecutive rows a load.
//
// A valid anchor whose class id lies outside [0, classes) turns its whole
// image into one segment (class test on), taken by block 0: no silent drop
// of such an anchor. The mask and chain kernels are launched only where a
// long segment is possible (A > L_max); their blocks return at once where
// there is none.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kChunk = 64;  // boxes per chain step and bits per word
constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int kUnroll = 4;  // positions of `order` per thread in flight
constexpr int kMaskThreads = kChunk;  // a mask tile: one row a thread
constexpr int kMaxEntries = 12287;  // (images x segments + 1) ints <= 48 KB
constexpr int kPrefetch = 4;  // later words a chain warp loads ahead

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(0.f, __fsub_rn(b.z, b.x)),
                   fmaxf(0.f, __fsub_rn(b.w, b.y)));
}

// The threshold t of the test fl(inter / uni) > t, and h = ulp(t) / 2:
// fl(q) > t exactly when q > t + h (or q == t + h and the tie rounds up),
// that is when r = inter - t * uni > h * uni. Where t >= 2^-20 and uni lies
// in [2^-60, 2^60], d = fma(-t, uni, inter) is r to 2^-24 of itself and
// h * uni is exact, so d above uni * h (1 + 2^-22) or below uni * h
// (1 - 2^-22) (both products exact but for their one rounding: h is a
// power of two) decides the test exactly without the division; the rest,
// and any NaN or infinity, divide. A pair that does not intersect (inter
// 0) has d = -t * uni and is decided false.
struct Thr {
  float t, hp, hm;
  bool fast;
};

__device__ __forceinline__ Thr make_thr(float t) {
  Thr th;
  const float h = __fmul_rn(__fsub_rn(nextafterf(t, INFINITY), t), 0.5f);
  th.t = t;
  th.hp = __fmul_rn(h, 1.f + 0x1p-22f);
  th.hm = __fmul_rn(h, 1.f - 0x1p-22f);
  th.fast = t >= 0x1p-20f && t < 0x1p60f;
  return th;
}

// iou(a, g) > t, with iou as _iou_matrix computes it (area_a, area_g the
// boxes' areas), without a branch where the margin decides.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 g,
                                           float area_g, const Thr& th) {
  const float iw = fmaxf(0.f, __fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)));
  const float ih = fmaxf(0.f, __fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  const float d = __fmaf_rn(-th.t, uni, inter);
  const bool above = d > __fmul_rn(uni, th.hp);
  const bool below = d < __fmul_rn(uni, th.hm);
  if (th.fast && uni >= 0x1p-60f && uni <= 0x1p60f && (above || below))
    return above;
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > th.t;
}

struct Args {
  const float4* boxes;     // (n, A) boxes, corner format
  const float* score;      // (n, A)
  const int* cls;          // (n, A)
  const long long* order;  // (n, A): each image's anchors, sorted
  float* out;              // (n, A, 6)
  // long segments (scratch): members, segment s of image img at
  // [img][offset_s + i] of each (n, A) array, its suppression words at
  // mask[(img * words_a + w) * A + offset_s + i], and per (image, segment)
  // a descriptor {L (0: not long), offset, kind (1 a class, 2 the image)}
  float4* sbox;
  int* scls;
  int* sidx;
  u64* mask;
  int* desc;               // null when no segment can be long
  long long a;             // anchors per image
  int words_a;             // ceil(A / 64)
  int segments;            // per image: classes, or 1 (the whole image)
  int classes;             // class ids checked against [0, classes); 0: none
  int cap;                 // boxes a segment block holds (L_max, % 64 == 0)
  int force;
  float threshold, nms_threshold;
};

// A short segment's storage in shared memory: cap boxes, then cap
// diagonal words, classes and anchor indices, cap / 64 keep words, cap
// removed flags: 33.125 bytes a box (kernels/nms.py seg_bytes).
struct Seg {
  float4* box;
  u64* diag;
  int* cls;
  int* idx;
  u64* keep;
  unsigned char* removed;
};

__device__ __forceinline__ Seg carve(unsigned char* base, int cap) {
  Seg s;
  s.box = reinterpret_cast<float4*>(base);
  s.diag = reinterpret_cast<u64*>(base + 16 * (size_t)cap);
  s.cls = reinterpret_cast<int*>(base + 24 * (size_t)cap);
  s.idx = reinterpret_cast<int*>(base + 28 * (size_t)cap);
  s.keep = reinterpret_cast<u64*>(base + 32 * (size_t)cap);
  s.removed = base + 32 * (size_t)cap + cap / 8;
  return s;
}

__device__ __forceinline__ void write_row(const Args& k, long long img,
                                          int a, float id, float4 b) {
  float* r = k.out + (img * k.a + a) * 6;
  r[0] = id;
  r[1] = k.score[img * k.a + a];
  r[2] = b.x;
  r[3] = b.y;
  r[4] = b.z;
  r[5] = b.w;
}

// The members of segment s of image img (valid, and of class s unless
// `whole`), in the order of `order`, by a stable ballot compaction: the
// first `cap` go to box/cls/idx. Returns the member count L (also past cap)
// to every thread; *below: the valid anchors of a class below s (where
// segment s starts among the image's long-segment storage); *oob: some
// valid anchor's class id lies outside [0, classes) (classes > 0). With
// `invalid_rows`, writes the rows of the image's invalid anchors on the way.
__device__ int gather(const Args& k, long long img, int s, bool whole,
                      float4* box, int* cls, int* idx, int cap,
                      bool invalid_rows, int* oob, int* below) {
  __shared__ int cnt[2][kUnroll * 32];
  __shared__ int tot[2];
  __shared__ int under;
  const int T = blockDim.x, t = threadIdx.x;
  const int nw = T >> 5, warp = t >> 5, lane = t & 31;
  const long long* ord = k.order + img * k.a;
  const float* sc = k.score + img * k.a;
  const int* cl = k.cls + img * k.a;
  const float4* bx = k.boxes + img * k.a;
  const unsigned lower = (1u << lane) - 1u;
  if (t == 0) under = 0;
  int base = 0, buf = 0, mine = 0;
  bool bad = false;
  for (long long p0 = 0; p0 < k.a; p0 += (long long)kUnroll * T) {
    int an[kUnroll];
    bool mem[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + (long long)u * T + t;
      an[u] = p < k.a ? (int)ord[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      mem[u] = false;
      if (an[u] < 0) continue;
      const float v = sc[an[u]];
      const int c = cl[an[u]];
      const bool valid = v > k.threshold;
      bad |= valid && k.classes > 0 && (c < 0 || c >= k.classes);
      mem[u] = valid && (whole || c == s);
      mine += valid && c < s;
      if (invalid_rows && !valid) write_row(k, img, an[u], -1.f, bx[an[u]]);
    }
    unsigned bits[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bits[u] = __ballot_sync(0xffffffffu, mem[u]);
      if (lane == 0) cnt[buf][u * nw + warp] = __popc(bits[u]);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive offsets of the (u, warp) counts, in that order: lane l
      // holds entries 4l .. 4l+3
      const int e = kUnroll * nw;
      int v[4], local = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = 4 * lane + i < e ? cnt[buf][4 * lane + i] : 0;
        local += v[i];
      }
      int incl = local;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      int run = incl - local;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * lane + i < e) cnt[buf][4 * lane + i] = run;
        run += v[i];
      }
      if (lane == 31) tot[buf] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!mem[u]) continue;
      const int pos =
          base + cnt[buf][u * nw + warp] + __popc(bits[u] & lower);
      if (pos < cap) {
        box[pos] = bx[an[u]];
        cls[pos] = cl[an[u]];
        idx[pos] = an[u];
      }
    }
    base += tot[buf];
    buf ^= 1;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0 && mine) atomicAdd(&under, mine);
  *oob = __syncthreads_or(bad);
  *below = under;
  __syncthreads();  // every thread has read `under` before a next call
  return base;
}

// The OR of x over the warp, to every lane.
__device__ __forceinline__ u64 or_warp(u64 x) {
  return (u64)__reduce_or_sync(0xffffffffu, (unsigned)(x >> 32)) << 32 |
         __reduce_or_sync(0xffffffffu, (unsigned)x);
}

// The kept boxes of a 64-box chunk (a whole warp calls it; every lane gets
// them): `left` the boxes not removed by earlier chunks, dw[0..len) the
// chunk's diagonal words. A box that no box of the chunk suppresses is
// kept, and what those boxes suppress goes; the rest are resolved in
// order, one step per kept box.
__device__ __forceinline__ u64 resolve(const u64* dw, int len, u64 left,
                                       int lane) {
  const u64 dlo = lane < len ? dw[lane] : 0ull;
  const u64 dhi = lane + 32 < len ? dw[lane + 32] : 0ull;
  const u64 sure = left & ~or_warp(dlo | dhi);
  const u64 gone = or_warp((((sure >> lane) & 1ull) ? dlo : 0ull) |
                           (((sure >> (lane + 32)) & 1ull) ? dhi : 0ull));
  u64 kept = sure;
  left &= ~(sure | gone);
  while (left) {
    const int b = __ffsll((long long)left) - 1;
    kept |= 1ull << b;
    left &= ~(dw[b] | (1ull << b));
  }
  return kept;
}

// Greedy NMS over the L boxes of g, in their order; fills g.keep. With
// by_class, a box suppresses only boxes of its class (a segment of one
// class needs no test). Every thread of the block calls it.
__device__ void chain(const Seg& g, int L, const Thr& th, bool by_class) {
  __shared__ float4 kept_box[kChunk];  // the chunk's kept boxes, in order
  __shared__ float kept_area[kChunk];
  __shared__ int kept_cls[kChunk];
  __shared__ int kept_n;
  const int T = blockDim.x, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int words = (L + kChunk - 1) / kChunk;
  for (int i = t; i < L; i += T) g.removed[i] = 0;
  // diagonal words, one 64-box chunk a pass: P threads a row, each taking
  // 64 / P columns; the P partial words are ORed over their lanes
  const int P = T / kChunk, span = kChunk / P;
  const int row = t / P, sub = t % P;
  for (int r0 = 0; r0 < words * kChunk; r0 += kChunk) {
    const int r = r0 + row;
    u64 bits = 0ull;
    if (r < L) {
      const float4 br = g.box[r];
      const float ar = area(br);
      const int cr = g.cls[r];
      const int q0 = r0 + sub * span;
      const int q1 = min(q0 + span, L);
      for (int q = max(q0, r + 1); q < q1; ++q) {
        const float4 bq = g.box[q];
        if ((!by_class || g.cls[q] == cr) &&
            suppresses(br, ar, bq, area(bq), th))
          bits |= 1ull << (q - r0);
      }
    }
    for (int off = P >> 1; off > 0; off >>= 1)
      bits |= __shfl_xor_sync(0xffffffffu, bits, off);
    if (sub == 0 && r < L) g.diag[r] = bits;
  }
  __syncthreads();
  for (int w = 0; w < words; ++w) {
    const int base = w * kChunk;
    const int len = min(kChunk, L - base);
    if (warp == 0) {
      const unsigned lo =
          __ballot_sync(0xffffffffu, lane < len && g.removed[base + lane]);
      const unsigned hi = __ballot_sync(
          0xffffffffu, lane + 32 < len && g.removed[base + 32 + lane]);
      u64 left = ~((u64)hi << 32 | lo);
      if (len < kChunk) left &= (1ull << len) - 1ull;
      const u64 kept = resolve(g.diag + base, len, left, lane);
      if (lane == 0) {
        g.keep[w] = kept;
        kept_n = __popcll(kept);
      }
      // the kept boxes, compacted in order, for the later boxes' tests
      for (int b = lane; b < len; b += 32) {
        if ((kept >> b) & 1ull) {
          const int pos = __popcll(kept & ((1ull << b) - 1ull));
          kept_box[pos] = g.box[base + b];
          kept_area[pos] = area(g.box[base + b]);
          kept_cls[pos] = g.cls[base + b];
        }
      }
    }
    __syncthreads();
    // every later box not removed yet against the chunk's kept boxes, two
    // boxes a thread so that each kept box read serves both
    const int nk = kept_n;
    for (int j0 = base + kChunk + t; nk && j0 < L; j0 += 2 * T) {
      const int j1 = j0 + T;
      const bool a0 = !g.removed[j0];
      const bool a1 = j1 < L && !g.removed[j1];
      if (!(a0 || a1)) continue;
      const int jb = j1 < L ? j1 : j0;
      const float4 b0 = g.box[j0], b1 = g.box[jb];
      const float r0 = area(b0), r1 = area(b1);
      const int c0 = g.cls[j0], c1 = g.cls[jb];
      bool h0 = false, h1 = false;
      for (int i = 0; i < nk; ++i) {
        const float4 q = kept_box[i];
        const float aq = kept_area[i];
        const int cq = kept_cls[i];
        h0 = h0 || (a0 && (!by_class || cq == c0) &&
                    suppresses(q, aq, b0, r0, th));
        h1 = h1 || (a1 && (!by_class || cq == c1) &&
                    suppresses(q, aq, b1, r1, th));
        if ((h0 || !a0) && (h1 || !a1)) break;
      }
      if (h0) g.removed[j0] = 1;
      if (h1) g.removed[j1] = 1;
    }
    __syncthreads();
  }
}

__device__ void write_rows(const Args& k, long long img, const float4* box,
                           const int* cls, const int* idx, const u64* keep,
                           int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const bool kept = (keep[i / kChunk] >> (i % kChunk)) & 1ull;
    write_row(k, img, idx[i], kept ? (float)cls[i] : -1.f, box[i]);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
nms_segment_kernel(const Args k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const long long img = blockIdx.y;
  const Seg g = carve(smem, k.cap);
  int* d = k.desc ? k.desc + (img * k.segments + s) * 4 : nullptr;
  bool whole = k.segments == 1;
  int oob = 0, below = 0;
  int L = gather(k, img, s, whole, g.box, g.cls, g.idx, k.cap, s == 0, &oob,
                 &below);
  if (oob) {
    // a valid class id outside [0, classes): the image is one segment,
    // the class test in the IoU test, taken by block 0
    if (s != 0) {
      if (d && threadIdx.x == 0) d[0] = 0;
      return;
    }
    whole = true;
    L = gather(k, img, 0, true, g.box, g.cls, g.idx, k.cap, false, &oob,
               &below);
  }
  if (L > k.cap) {
    // long: the members to the scratch for the mask and chain kernels
    const long long at = img * k.a + (whole ? 0 : below);
    gather(k, img, s, whole, k.sbox + at, k.scls + at, k.sidx + at, L,
           false, &oob, &below);
    if (threadIdx.x == 0) {
      d[0] = L;
      d[1] = (int)(at - img * k.a);
      d[2] = whole ? 2 : 1;
    }
    return;
  }
  if (d && threadIdx.x == 0) d[0] = 0;
  chain(g, L, make_thr(k.nms_threshold), !k.force && whole);
  write_rows(k, img, g.box, g.cls, g.idx, g.keep, L);
}

// The suppression words of every long segment: tiles (r, c >= r) of 64
// rows x 64 columns, enumerated over the descriptors (tile counts W (W + 1)
// / 2 for a segment of W chunks, their prefix in shared memory), each block
// of the fixed grid taking a run of consecutive tiles. Row i of chunk r
// gets, in word c, the columns of chunk c after it that it suppresses.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const Args k, int entries) {
  extern __shared__ int pre[];  // entries + 1 exclusive tile offsets
  __shared__ float4 cbox[kChunk];
  __shared__ float carea[kChunk];
  __shared__ int ccls[kChunk];
  __shared__ int wsum[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (entries + kMaskThreads - 1) / kMaskThreads;
  const int e0 = min(entries, t * per), e1 = min(entries, e0 + per);
  // each descriptor read once: its tile count into pre[], then the scan
  for (int e = t; e < entries; e += kMaskThreads) {
    const int w = (k.desc[e * 4] + kChunk - 1) / kChunk;
    pre[e] = w * (w + 1) / 2;
  }
  __syncthreads();
  int sum = 0;
  for (int e = e0; e < e1; ++e) sum += pre[e];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 1) incl += wsum[0];
  int run = incl - sum;
  for (int e = e0; e < e1; ++e) {
    const int n = pre[e];
    pre[e] = run;
    run += n;
  }
  if (t == kMaskThreads - 1) pre[entries] = incl;
  __syncthreads();
  const int total = pre[entries];
  const Thr th = make_thr(k.nms_threshold);
  // this block's run of consecutive tiles: the first one found by a
  // binary search over the prefix, the rest by walking (r, c) and the
  // segments, every thread the same walk; a row's box stays in registers
  // while its chunk r does
  const int span = (total + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * span, t1 = min(total, t0 + span);
  if (t0 >= t1) return;
  int e = 0, r = 0, c = 0;
  {
    int hi = entries - 1;  // the last entry starting at or before t0
    while (e < hi) {
      const int mid = (e + hi + 1) / 2;
      if (pre[mid] <= t0) e = mid; else hi = mid - 1;
    }
    int local = t0 - pre[e];
    const int w = (k.desc[e * 4] + kChunk - 1) / kChunk;
    while (local >= w - r) {
      local -= w - r;
      ++r;
    }
    c = r + local;
  }
  int L = 0, words = 0, off = 0;
  long long img = 0, at = 0;
  bool by_class = false;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  float ab = 0.f;
  int ci = 0, row_e = -1, row_r = -1;
  for (int tile = t0; tile < t1; ++tile) {
    if (e != row_e) {
      const int* d = k.desc + e * 4;
      L = d[0];
      off = d[1];
      by_class = !k.force && d[2] == 2;
      words = (L + kChunk - 1) / kChunk;
      img = e / k.segments;
      at = img * k.a + off;
    }
    const int i = r * kChunk + t;
    if ((e != row_e || r != row_r) && i < L) {
      b = k.sbox[at + i];
      ab = area(b);
      ci = k.scls[at + i];
    }
    row_e = e;
    row_r = r;
    const int q = c * kChunk + t;
    if (q < L) {
      cbox[t] = k.sbox[at + q];
      carea[t] = area(cbox[t]);
      ccls[t] = k.scls[at + q];
    }
    __syncthreads();
    if (i < L) {
      const int ncols = min(kChunk, L - c * kChunk);
      u64 bits = 0ull;
      if (c != r && ncols == kChunk) {  // a whole tile off the diagonal
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j)
          if ((!by_class || ccls[j] == ci) &&
              suppresses(b, ab, cbox[j], carea[j], th))
            bits |= 1ull << j;
      } else {
        for (int j = c == r ? t + 1 : 0; j < ncols; ++j)
          if ((!by_class || ccls[j] == ci) &&
              suppresses(b, ab, cbox[j], carea[j], th))
            bits |= 1ull << j;
      }
      k.mask[(img * k.words_a + c) * k.a + off + i] = bits;
    }
    __syncthreads();
    // the next tile: the next column, else the next row chunk, else the
    // next long segment
    if (++c == words) {
      if (++r == words) {
        r = 0;
        do {
          ++e;
        } while (tile + 1 < t1 && k.desc[e * 4] == 0);
      }
      c = r;
    }
  }
}

// The chain of one long segment (grid (segments, images); a block whose
// segment is not long returns): chunk by chunk, warp 0 resolves the
// chunk from its diagonal words (prefetched into a double buffer by warps
// 1-2 while the chunk before runs) and the removed bitmap; then every
// later word of the bitmap gets the OR of the kept rows' words, one warp a
// word (its first kPrefetch words loaded before the resolve, so that their
// latency overlaps it). Then the segment's rows.
__global__ void __launch_bounds__(kMaxThreads)
nms_chain_kernel(const Args k) {
  extern __shared__ u64 bitmaps[];  // removed[words_a], keep[words_a]
  __shared__ u64 diag[2][kChunk];
  const int s = blockIdx.x;
  const long long img = blockIdx.y;
  const int* d = k.desc + (img * k.segments + s) * 4;
  const int L = d[0];
  if (!L) return;
  const int T = blockDim.x, t = threadIdx.x;
  const int nw = T >> 5, warp = t >> 5, lane = t & 31;
  const int words = (L + kChunk - 1) / kChunk;
  const long long at = img * k.a + d[1];
  const u64* m = k.mask + img * k.words_a * k.a + d[1];  // word w: m[w * A]
  u64* removed = bitmaps;
  u64* keep = bitmaps + k.words_a;
  for (int i = t; i < words; i += T) removed[i] = 0ull;
  if (t < kChunk && t < L) diag[0][t] = m[t];
  __syncthreads();
  for (int w = 0; w < words; ++w) {
    const int base = w * kChunk;
    const int len = min(kChunk, L - base);
    // the chunk's rows' words for this warp's first later words, loaded
    // before the resolve says which rows are kept
    u64 pre_lo[kPrefetch], pre_hi[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int x = w + 1 + warp + i * nw;
      const u64* col = m + (long long)x * k.a + base;
      pre_lo[i] = x < words && lane < len ? col[lane] : 0ull;
      pre_hi[i] = x < words && lane + 32 < len ? col[lane + 32] : 0ull;
    }
    if (t >= 32 && t < 32 + kChunk && w + 1 < words) {
      const int q = base + kChunk + t - 32;
      if (q < L) diag[(w + 1) & 1][t - 32] = m[(long long)(w + 1) * k.a + q];
    }
    if (warp == 0) {
      u64 left = ~removed[w];
      if (len < kChunk) left &= (1ull << len) - 1ull;
      const u64 kept = resolve(diag[w & 1], len, left, lane);
      if (lane == 0) keep[w] = kept;
    }
    __syncthreads();
    const u64 kept = keep[w];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int x = w + 1 + warp + i * nw;
      if (!kept || x >= words) break;
      const u64 r = or_warp((((kept >> lane) & 1ull) ? pre_lo[i] : 0ull) |
                            (((kept >> (lane + 32)) & 1ull) ? pre_hi[i] : 0ull));
      if (lane == 0) removed[x] |= r;
    }
    for (int x = w + 1 + warp + kPrefetch * nw; kept && x < words; x += nw) {
      const u64* col = m + (long long)x * k.a + base;
      u64 r = 0ull;
      if ((kept >> lane) & 1ull) r |= col[lane];
      if ((kept >> (lane + 32)) & 1ull) r |= col[lane + 32];
      r = or_warp(r);
      if (lane == 0) removed[x] |= r;
    }
    __syncthreads();
  }
  write_rows(k, img, k.sbox + at, k.scls + at, k.sidx + at, keep, L);
}

// The dynamic shared memory a segment block may take on the current
// device: the opt-in limit less the kernel's static shared memory (once
// per device). The wrapper's plan keeps L_max within it.
int caps(int* smem) {
  static int lim[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, nms_segment_kernel);
    if (err != cudaSuccess) return (int)err;
    const int bytes = optin - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(nms_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    lim[dev] = bytes;
    ready[dev] = true;
  }
  *smem = lim[dev];
  return 0;
}

// bytes of a segment of cap boxes (kernels/nms.py seg_bytes)
long long seg_bytes(long long cap) { return 33 * cap + cap / 8; }

// the packed arguments of mxt_nms_f32 (kernels/nms.py _PACK, "=6Q4q2d7qQ")
struct Packed {
  u64 boxes, score, cls, order, out, scratch;
  long long n, a, classes, force;
  double threshold, nms_threshold;
  long long segments, cap, threads, smem, mask_blocks, scratch_bytes,
      launches;
  u64 stream;
};
static_assert(sizeof(Packed) == 20 * 8, "Packed: 20 fields of 8 bytes");

template <typename T>
T* ptr(u64 p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

bool pow2_threads(long long t) {
  return t >= kChunk && t <= kMaxThreads && (t & (t - 1)) == 0;
}

}  // namespace

// out[0]: the dynamic shared memory one segment block may take (bytes);
// the wrapper's planner reads it once per device.
extern "C" int mxt_nms_caps(int* out, void* stream) {
  (void)stream;
  return caps(out);
}

// The kernels of one call, as planned by the wrapper (kernels/nms.py
// plan): the segment kernel on a (segments, n) grid with `smem` bytes of
// dynamic shared memory; then, when a segment can be longer than cap
// (launches == 3), the mask kernel on mask_blocks blocks and the chain
// kernel on a (segments, n) grid of blocks of `threads`, over the scratch: the long segments'
// members (24 bytes an anchor), their words (8 bytes an anchor per 64) and
// the descriptors. Returns cudaErrorInvalidValue for a plan that does not
// fit this call or the card.
extern "C" int mxt_nms_f32(const void* packed) {
  const Packed& in = *static_cast<const Packed*>(packed);
  const long long n = in.n, a = in.a;
  if (n <= 0 || a <= 0) return (int)cudaGetLastError();
  int limit = 0;
  const int err = caps(&limit);
  if (err != 0) return err;
  const long long words_a = (a + kChunk - 1) / kChunk;
  const long long apad = words_a * kChunk;
  const long long S = in.segments;
  const bool longs = a > in.cap;
  const long long need =
      longs ? n * a * 24 + n * words_a * a * 8 + n * S * 16 : 0;
  if (in.cap < kChunk || in.cap % kChunk != 0 || in.cap > apad ||
      in.smem != seg_bytes(in.cap) || in.smem > limit || S < 1 ||
      (S > 1 && (in.force || S != in.classes)) ||
      !pow2_threads(in.threads) ||
      n > 65535 || a >= (1LL << 31) || S >= (1LL << 31) ||
      in.launches != (longs ? 3 : 1) || in.scratch_bytes != need ||
      (longs && (in.scratch == 0 || n * S + 1 > kMaxEntries ||
                 in.mask_blocks < 1 || 16 * words_a > 48 * 1024)))
    return (int)cudaErrorInvalidValue;
  unsigned char* scratch = ptr<unsigned char>(in.scratch);
  Args k;
  k.boxes = ptr<const float4>(in.boxes);
  k.score = ptr<const float>(in.score);
  k.cls = ptr<const int>(in.cls);
  k.order = ptr<const long long>(in.order);
  k.out = ptr<float>(in.out);
  k.sbox = longs ? reinterpret_cast<float4*>(scratch) : nullptr;
  k.mask = longs ? reinterpret_cast<u64*>(scratch + n * a * 16) : nullptr;
  k.scls = longs ? reinterpret_cast<int*>(scratch + n * a * 16 +
                                          n * words_a * a * 8)
                 : nullptr;
  k.sidx = longs ? k.scls + n * a : nullptr;
  k.desc = longs ? k.sidx + n * a : nullptr;
  k.a = a;
  k.words_a = (int)words_a;
  k.segments = (int)S;
  k.classes = S > 1 ? (int)S : 0;
  k.cap = (int)in.cap;
  k.force = (int)in.force;
  k.threshold = (float)in.threshold;
  k.nms_threshold = (float)in.nms_threshold;
  cudaStream_t st = ptr<CUstream_st>(in.stream);
  const dim3 grid((unsigned)S, (unsigned)n);
  nms_segment_kernel<<<grid, (unsigned)in.threads, (size_t)in.smem, st>>>(k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !longs) return (int)e;
  const int entries = (int)(n * S);
  nms_mask_kernel<<<(unsigned)in.mask_blocks, kMaskThreads,
                    (size_t)(entries + 1) * sizeof(int), st>>>(k, entries);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_chain_kernel<<<grid, (unsigned)in.threads,
                     (size_t)(2 * words_a * sizeof(u64)), st>>>(k);
  return (int)cudaGetLastError();
}
