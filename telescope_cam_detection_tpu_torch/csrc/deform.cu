// Multi-scale deformable sampling for Hopper (sm_90a), RT-DETR's
// cross-attention:
//
//   out[b, q, h, :] = sum_p sum_l w[b, q, h, l, p] *
//                     bilinear(V_l[b, :, :, h, :], loc[b, q, h, l, p])
//
// with half-pixel centres and every corner index clamped to the border
// (a location outside [0, 1] reads the edge pixel; not the zero padding of
// upstream MSDeformAttn). Values of all levels come as one (B, S, H, D)
// tensor, S = sum of h_l * w_l, each level row-major from its start offset;
// locs are (B, Q, H, L, P, 2) normalised xy, weights (B, Q, H, L, P)
// softmaxed, out (B, Q, H, D). All fp32. RT-DETR's decoder fixes L = 3,
// P = 4 and D = 256 / 8 = 32; the kernel takes those and nothing else.
//
// Replaces telescope_cam_detection_tpu/ops/pallas_deform.py _deform_kernel
// (the Pallas TPU kernel behind ms_deformable_attention_pallas). The plain
// PyTorch version is telescope_cam_detection_tpu_torch/ops/deform.py
// ms_deformable_attention_reference.
//
// Design (the TPU kernel built a weighted one-hot (Q, HW) tile per 512-wide
// slab and multiplied it on the MXU, because a TPU has no fast gather; a GPU
// has one):
//   - one warp per (b, q, h), a lane per channel: each corner read is one
//     coalesced 128-byte line.
//   - the warp walks the L * P * 4 = 48 corners itself: it computes each
//     corner's index and bilinear weight from the location (every lane the
//     same, broadcast loads), so nothing is precomputed or padded outside,
//     and the sum stays in registers. One launch covers every level. The
//     loops are unrolled, so the compiler may issue the loads ahead of the
//     sums.
//   - order of arithmetic, as the plain version: per level the four corner
//     terms (1-fy)(1-fx) g00 + (1-fy) fx g01 + fy (1-fx) g10 + fy fx g11 left
//     to right, times the weight; summed over levels, then over points.
//
// Exact corner indices: floor(loc * w - 0.5) is discontinuous, so the
// coordinate must round as the plain version's does. Every step is written
// with the round-to-nearest intrinsics and the build passes -fmad=false: no
// a*b+c is contracted into an FMA. Never build this file with
// --use_fast_math.
//
// The launch function allocates nothing, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 3;
constexpr int kPoints = 4;
constexpr int kHeadDim = 32;  // one lane per channel
constexpr int kWarps = 4;     // warps (one (b, q, h) each) per block

struct Levels {
  int h[kLevels];
  int w[kLevels];
  int start[kLevels];
};

__device__ __forceinline__ int clamp_index(float v, int n) {
  const int i = static_cast<int>(v);  // v is integral: floor or floor + 1
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__global__ void __launch_bounds__(kWarps * 32)
deform_kernel(const float* __restrict__ values, Levels lv,
              const float2* __restrict__ locs,
              const float* __restrict__ weights, float* __restrict__ out,
              int total_s, int queries, int heads, long long items) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % heads);
  const long long b = item / heads / queries;
  const float2* loc = locs + item * (kLevels * kPoints);
  const float* wgt = weights + item * (kLevels * kPoints);
  const size_t row = static_cast<size_t>(heads) * kHeadDim;  // floats/position
  const float* vb = values + static_cast<size_t>(b) * total_s * row +
                    static_cast<size_t>(h) * kHeadDim + lane;

  float total = 0.0f;
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const float2 xy = loc[l * kPoints + p];
      const float x = __fsub_rn(__fmul_rn(xy.x, static_cast<float>(wl)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, static_cast<float>(hl)), 0.5f);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float fx = __fsub_rn(x, x0);
      const float fy = __fsub_rn(y, y0);
      const int xa = clamp_index(x0, wl);
      const int xb = clamp_index(__fadd_rn(x0, 1.0f), wl);
      const int ya = clamp_index(y0, hl);
      const int yb = clamp_index(__fadd_rn(y0, 1.0f), hl);
      const float* vl = vb + static_cast<size_t>(lv.start[l]) * row;
      const float g00 = vl[static_cast<size_t>(ya * wl + xa) * row];
      const float g01 = vl[static_cast<size_t>(ya * wl + xb) * row];
      const float g10 = vl[static_cast<size_t>(yb * wl + xa) * row];
      const float g11 = vl[static_cast<size_t>(yb * wl + xb) * row];
      const float ox = __fsub_rn(1.0f, fx);
      const float oy = __fsub_rn(1.0f, fy);
      float s = __fmul_rn(__fmul_rn(oy, ox), g00);
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(oy, fx), g01));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(fy, ox), g10));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(fy, fx), g11));
      acc = __fadd_rn(acc, __fmul_rn(s, wgt[l * kPoints + p]));
    }
    total = __fadd_rn(total, acc);
  }
  out[item * kHeadDim + lane] = total;
}

}  // namespace

// values (batch, total_s, heads, 32); level_hws: 3 triples (h, w, start) in
// host memory; locs (batch, queries, heads, 3, 4, 2) 8-byte aligned; weights
// (batch, queries, heads, 3, 4); out (batch, queries, heads, 32). All
// contiguous fp32.
extern "C" int deform_launch(const float* values, const int* level_hws,
                             const float* locs, const float* weights,
                             float* out, int batch, int total_s, int queries,
                             int heads, cudaStream_t stream) {
  Levels lv = {};
  for (int l = 0; l < kLevels; ++l) {
    lv.h[l] = level_hws[3 * l];
    lv.w[l] = level_hws[3 * l + 1];
    lv.start[l] = level_hws[3 * l + 2];
  }
  const long long items = static_cast<long long>(batch) * queries * heads;
  const long long blocks = (items + kWarps - 1) / kWarps;
  deform_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0, stream>>>(
      values, lv, reinterpret_cast<const float2*>(locs), weights, out, total_s,
      queries, heads, items);
  return static_cast<int>(cudaGetLastError());
}
