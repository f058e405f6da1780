// Greedy non-maximum suppression of SSD detections, float32 boxes.
//
// Replaces mxnet_tpu/ops/defs_contrib.py:_nms_keep (:234-253) and the
// assembly of _multibox_detection's rows (:274-277); see
// mxnet_tpu_torch/kernels/nms.py for the wrapper and the plain version.
// Per image, with the anchors taken in `order` (the stable descending sort
// of the scores):
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
// exactly (min, max, + and * commute), so the upper triangle suffices; a
// box's area is the same value wherever it is computed, so it is computed
// once per box.
//
// Two kernels:
// - nms_mask_kernel: grid (column block, row block, image) of 64-box
//   blocks, upper triangle only. Each block stages its 64 column boxes and
//   their areas in shared memory, and each thread writes, for its row box
//   i, one 64-bit word with bit k set when row i suppresses column box
//   64*col + k > i. Boxes and classes are read through `order`; no sorted
//   copy is made. A row whose box is invalid writes nothing: it is never
//   kept, so the scan never reads its words.
// - nms_scan_kernel: one block per image walks the sorted boxes in 64-box
//   chunks. It first stages every chunk's diagonal words and validity bits
//   in shared memory (8.4 bytes a box: A <= 27712). Then, per chunk, one
//   thread resolves the chunk against its diagonal words (a 64-step
//   dependency chain in shared memory) and the block ORs the words of the
//   chunk's kept rows into the removed vector of the later chunks, each
//   later word's rows split over the threads to spare. Finally it writes
//   the (A, 6) rows in anchor order.
//
// Bound, SSD-300 at batch 8, A = 8096: the mask kernel does n * A^2 / 2 ~
// 262 M IoUs of ~15 flops each, so operations bound it; it writes
// 8 * 8096 * 127 * 8 B = 65.8 MB of words. The scan is a chain of 127
// chunks per image; per chunk it reads the 64 diagonal words and the kept
// rows' words of the later chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;      // boxes per block and bits per word
constexpr int kScanThreads = 1024;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(0.f, __fsub_rn(b.z, b.x)),
                   fmaxf(0.f, __fsub_rn(b.w, b.y)));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 g,
                                     float area_g) {
  const float iw = fmaxf(0.f, __fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)));
  const float ih = fmaxf(0.f, __fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kBlock)
nms_mask_kernel(const float* __restrict__ boxes, const int* __restrict__ cls,
                const float* __restrict__ score,
                const long long* __restrict__ order,
                unsigned long long* __restrict__ mask, long long a_count,
                long long words, float threshold, float nms_threshold,
                int force) {
  const long long col = blockIdx.x, row = blockIdx.y, img = blockIdx.z;
  if (col < row) return;
  __shared__ float4 cbox[kBlock];
  __shared__ float carea[kBlock];
  __shared__ int ccls[kBlock];
  const float4* bx = reinterpret_cast<const float4*>(boxes) + img * a_count;
  const int* cl = cls + img * a_count;
  const long long* ord = order + img * a_count;
  const int t = threadIdx.x;
  const long long j = col * kBlock + t;
  if (j < a_count) {
    const long long a = ord[j];
    cbox[t] = bx[a];
    carea[t] = area(cbox[t]);
    ccls[t] = cl[a];
  }
  __syncthreads();
  const long long i = row * kBlock + t;
  if (i >= a_count) return;
  const long long a = ord[i];
  // an invalid box is never kept, so the scan never reads its words
  if (!(score[img * a_count + a] > threshold)) return;
  const float4 box = bx[a];
  const float box_area = area(box);
  const int c = cl[a];
  const long long left = a_count - col * kBlock;
  const int ncols = left < kBlock ? (int)left : kBlock;
  unsigned long long bits = 0ull;
  for (int k = (col == row) ? t + 1 : 0; k < ncols; ++k) {
    if ((force || ccls[k] == c) &&
        iou(box, box_area, cbox[k], carea[k]) > nms_threshold)
      bits |= 1ull << k;
  }
  mask[(img * a_count + i) * words + col] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const float* __restrict__ boxes,
                const float* __restrict__ score, const int* __restrict__ cls,
                const long long* __restrict__ order,
                float* __restrict__ out, long long a_count, long long words,
                float threshold) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* diag = smem;                   // [words * 64]
  unsigned long long* removed = diag + words * kBlock;  // [words]
  unsigned long long* keep = removed + words;        // [words]
  unsigned long long* valid = keep + words;          // [words]
  const long long img = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned long long* m = mask + img * a_count * words;
  const float* sc = score + img * a_count;
  const long long* ord = order + img * a_count;

  // prologue: every chunk's diagonal words and validity bits, so the
  // chain below waits on no device-memory load of its own
  for (long long w = t; w < words; w += kScanThreads) removed[w] = 0ull;
  for (long long i = t; i < words * kBlock; i += kScanThreads)
    diag[i] = i < a_count ? m[i * words + i / kBlock] : 0ull;
  unsigned int* valid32 = reinterpret_cast<unsigned int*>(valid);
  for (long long i0 = (long long)warp * 32; i0 < words * kBlock;
       i0 += kScanThreads) {
    const long long i = i0 + lane;
    const unsigned int v = __ballot_sync(
        0xffffffffu, i < a_count && sc[i < a_count ? ord[i] : 0] > threshold);
    if (lane == 0) valid32[i0 / 32] = v;
  }
  __syncthreads();

  for (long long chunk = 0; chunk < words; ++chunk) {
    const long long base = chunk * kBlock;
    if (t == 0) {
      const unsigned long long* d = diag + base;
      const unsigned long long ok = valid[chunk];
      unsigned long long rem = removed[chunk], kept = 0ull;
      for (int k = 0; k < kBlock; ++k) {
        const unsigned long long bit = 1ull << k;
        if ((ok & bit) && !(rem & bit)) {
          kept |= bit;
          rem |= d[k];
        }
      }
      keep[chunk] = kept;
    }
    __syncthreads();
    const unsigned long long kept = keep[chunk];
    const long long later = words - chunk - 1;
    if (kept && later > 0) {
      // split each later word's 64 rows over as many threads as the block
      // has to spare, so that more loads are in flight as words run out
      int per = 1;
      while (per < kBlock && 2 * per * later <= kScanThreads) per *= 2;
      const int rows = kBlock / per;
      for (long long slot = t; slot < later * per; slot += kScanThreads) {
        const long long w = chunk + 1 + slot / per;
        const int k0 = (int)(slot % per) * rows;
        unsigned long long r = 0ull;
#pragma unroll 8
        for (int k = k0; k < k0 + rows; ++k)
          if ((kept >> k) & 1ull) r |= m[(base + k) * words + w];
        if (r) atomicOr(&removed[w], r);
      }
    }
    __syncthreads();
  }
  const float4* bx = reinterpret_cast<const float4*>(boxes) + img * a_count;
  const int* cl = cls + img * a_count;
  float* o = out + img * a_count * 6;
  for (long long i = t; i < a_count; i += kScanThreads) {
    const long long a = ord[i];
    const bool kept = (keep[i / kBlock] >> (i % kBlock)) & 1ull;
    const float4 b = bx[a];
    float* r = o + a * 6;
    r[0] = kept ? (float)cl[a] : -1.f;
    r[1] = sc[a];
    r[2] = b.x;
    r[3] = b.y;
    r[4] = b.z;
    r[5] = b.w;
  }
}

}  // namespace

extern "C" int mxt_nms_mask_f32(const void* boxes, const void* cls,
                                const void* score, const void* order,
                                void* mask, long long n, long long a_count,
                                float threshold, float nms_threshold,
                                int force, void* stream) {
  const long long words = (a_count + kBlock - 1) / kBlock;
  if (n > 0 && a_count > 0) {
    dim3 grid((unsigned)words, (unsigned)words, (unsigned)n);
    nms_mask_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)boxes, (const int*)cls, (const float*)score,
        (const long long*)order, (unsigned long long*)mask, a_count, words,
        threshold, nms_threshold, force);
  }
  return (int)cudaGetLastError();
}

extern "C" int mxt_nms_scan_f32(const void* mask, const void* boxes,
                                const void* score, const void* cls,
                                const void* order, void* out, long long n,
                                long long a_count, float threshold,
                                void* stream) {
  const long long words = (a_count + kBlock - 1) / kBlock;
  if (n > 0 && a_count > 0) {
    // the diagonal words, removed, keep and validity words
    const size_t smem =
        (kBlock + 3) * (size_t)words * sizeof(unsigned long long);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    nms_scan_kernel<<<(unsigned)n, kScanThreads, smem, (cudaStream_t)stream>>>(
        (const unsigned long long*)mask, (const float*)boxes,
        (const float*)score, (const int*)cls, (const long long*)order,
        (float*)out, a_count, words, threshold);
  }
  return (int)cudaGetLastError();
}
