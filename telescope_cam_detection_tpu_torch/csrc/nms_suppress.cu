// Greedy NMS suppression for Hopper (sm_90a): the keep mask over
// score-descending, class-offset boxes.
//
//   keep[b, i] = valid[b, i] && no kept j < i has IoU(j, i) > thr
//
// Replaces telescope_cam_detection_tpu/ops/pallas_nms.py _suppress_kernel
// (the Pallas TPU kernel) and telescope_cam_detection_tpu/ops/nms.py
// _greedy_suppress (the XLA fixpoint the JAX package runs under
// nms_impl=auto). The plain PyTorch version is
// telescope_cam_detection_tpu_torch/ops/nms.py _greedy_suppress; the result
// is bit-identical to it, so callers compare keep masks with torch.equal.
//
// Bound at B = 8, K = 1000 (the main path): about 4.0e6 IoU pairs x about
// 15 fp32 operations = 6e7 operations, roughly 1 us on the CUDA cores at
// 67 TFLOP/s; about 144 KB of input and output (boxes 128 KB, valid and keep
// 8 KB each), roughly 0.04 us at 3.35 TB/s. So the bound is compute.
//
// Design: two launches from one call.
//   1. iou_mask_kernel, grid (ceil(K/64), ceil(K/64), B), 64 threads. A block
//      stages 64 column boxes and their areas in shared memory; thread r
//      sets bit c of mask[b, r, colblock] when c > r and IoU(r, c) > thr.
//      Blocks wholly below the diagonal write zeros. The mask is a uint64
//      scratch (B, K, ceil(K/64)) that the wrapper allocates: 128 KB per
//      image at K = 1000.
//   2. greedy_scan_kernel, one warp per image. It keeps a `removed` bitset of
//      ceil(K/64) words in shared memory and walks i = 0..K-1: if valid[i]
//      and bit i is clear, keep[i] = 1 and row i of the mask is ORed into
//      `removed`. Invalid rows never suppress anything.
// The IoU pass is parallel over all pairs; the K-step serial scan, not the
// IoU, is what this simple design pays for. A parallel scan or one fused
// launch is later work.
//
// Exactness: every operation is written with the IEEE round-to-nearest
// intrinsics in the plain version's order (area = w * h; union =
// (area_r + area_c) - inter; iou = inter / union), and the build passes
// -fmad=false as well, so no a*b+c is contracted into an FMA. Never build
// this file with --use_fast_math.
//
// The launch function allocates nothing, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float clamped_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

__global__ void __launch_bounds__(kTile)
iou_mask_kernel(const float4* __restrict__ boxes, int k, int words,
                float thr, unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const float4* img = boxes + static_cast<size_t>(b) * k;

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int c0 = col_block * kTile;
  if (c0 + t < k) {
    const float4 cb = img[c0 + t];
    cols[t] = cb;
    col_area[t] = clamped_area(cb);
  }
  __syncthreads();

  const int r = row_block * kTile + t;
  if (r >= k) return;
  unsigned long long bits = 0ull;
  if (col_block >= row_block) {
    const float4 rb = img[r];
    const float r_area = clamped_area(rb);
    const int n_cols = min(kTile, k - c0);              // ragged last tile
    const int start = (col_block == row_block) ? t + 1 : 0;  // c > r only
    for (int j = start; j < n_cols; ++j) {
      if (iou_over(rb, r_area, cols[j], col_area[j], thr)) {
        bits |= 1ull << j;
      }
    }
  }
  mask[(static_cast<size_t>(b) * k + r) * words + col_block] = bits;
}

__global__ void __launch_bounds__(32)
greedy_scan_kernel(const unsigned long long* __restrict__ mask,
                   const uint8_t* __restrict__ valid, int k, int words,
                   uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                       // words
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(smem + words);  // k bytes
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + static_cast<size_t>(b) * k * words;
  const uint8_t* v = valid + static_cast<size_t>(b) * k;
  uint8_t* out = keep + static_cast<size_t>(b) * k;

  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  for (int i = lane; i < k; i += 32) valid_s[i] = v[i];
  __syncwarp();

  for (int i = 0; i < k; ++i) {
    const bool kept = valid_s[i] != 0 &&
                      ((removed[i >> 6] >> (i & 63)) & 1ull) == 0ull;
    __syncwarp();  // every lane has read bit i before any lane ORs
    if (lane == 0) out[i] = kept ? 1 : 0;
    if (kept) {
      const unsigned long long* row = m + static_cast<size_t>(i) * words;
      for (int w = lane; w < words; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int nms_suppress_launch(const float* boxes, const uint8_t* valid,
                                   int batch, int k, float thr,
                                   unsigned long long* mask, uint8_t* keep,
                                   cudaStream_t stream) {
  const int words = (k + kTile - 1) / kTile;
  const dim3 grid(words, words, batch);
  iou_mask_kernel<<<grid, kTile, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), k, words, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long) + k;
  greedy_scan_kernel<<<batch, 32, smem, stream>>>(mask, valid, k, words, keep);
  return static_cast<int>(cudaGetLastError());
}
