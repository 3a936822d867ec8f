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
// Bound: bytes. Each (b, q, h) reads L * P * 4 = 48 rows of D = 32 floats
// (128 B); at the decoder's shape (B = 4, Q = 300, 8 heads) that is 59 MB of
// gathered rows, most of them repeats of the ~53,000 distinct rows (6.8 MB)
// that the locations touch, so the floor is those rows plus locs, weights
// and out read or written once, ~2.8 us at 3.35 TB/s. The operations
// (2 * 48 * 32 per item) are a tenth of that at the fp32 rate. What is left
// above the floor is the 59 MB of gathers between L2 and the SMs.
//
// Design (the TPU kernel built a weighted one-hot (Q, HW) tile per 512-wide
// slab and multiplied it on the MXU, because a TPU has no fast gather; a GPU
// has one). One warp per (b, q, h) item, in two phases:
//   1. geometry, once per sample: lanes 0..11 each read one (level, point)
//      sample's location and weight (neighbouring lanes on neighbouring
//      addresses) and write to the warp's table in shared memory its four
//      clamped corner offsets (int32, in floats from the image's first row),
//      the four bilinear products (1-fy)(1-fx), (1-fy) fx, fy (1-fx), fy fx
//      and the weight (36 B). The first design had all 32 lanes compute
//      every sample's geometry (31 of them redundantly), twice the bytes
//      bound in instruction issue alone.
//   2. gather: lane group g = lane / 8 takes point g; each of its 8 lanes
//      owns 4 channels as one float4, so a corner row is eight 16-byte
//      loads on neighbouring addresses, and a lane has its point's 3 levels
//      x 4 corners = 12 loads in flight. Group 0 then adds the other groups'
//      sums through shuffles, in point order.
//   A block is 4 warps: 4 consecutive queries of one head and image, so the
//   grid is (Q / 4, heads, B): 2,400 blocks at B = 4, 12 resident on each
//   SM at up to 40 registers a thread. Four items a warp (8 lanes each over
//   all 12 samples) kept fewer loads in flight per item and was slower.
//
// Order of arithmetic, as the plain version: per level the four corner terms
// (1-fy)(1-fx) g00 + (1-fy) fx g01 + fy (1-fx) g10 + fy fx g11 left to right,
// times the weight; summed over levels, then over points.
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
constexpr int kHeadDim = 32;
constexpr int kSamples = kLevels * kPoints;      // per (b, q, h) item
constexpr int kLanesPerPoint = kHeadDim / 4;     // a float4 each
constexpr int kWarps = 4;                        // items (queries) per block
constexpr int kMinBlocks = 12;                   // resident per SM
constexpr unsigned kFullMask = 0xffffffffu;

struct Levels {
  int h[kLevels];
  int w[kLevels];
  int start[kLevels];
};

__device__ __forceinline__ int clamp_index(float v, int n) {
  const int i = static_cast<int>(v);  // v is integral: floor or floor + 1
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// s = c00 g00 + c01 g01 + c10 g10 + c11 g11 (left to right); acc += s * w
__device__ __forceinline__ float corner_sum(float acc, const float c[4],
                                            float g00, float g01, float g10,
                                            float g11, float w) {
  float s = __fmul_rn(c[0], g00);
  s = __fadd_rn(s, __fmul_rn(c[1], g01));
  s = __fadd_rn(s, __fmul_rn(c[2], g10));
  s = __fadd_rn(s, __fmul_rn(c[3], g11));
  return __fadd_rn(acc, __fmul_rn(s, w));
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
deform_kernel(const float* __restrict__ values, Levels lv,
              const float2* __restrict__ locs,
              const float* __restrict__ weights, float* __restrict__ out,
              int total_s, int heads, int queries) {
  // the geometry table: corner offsets, bilinear products, weight
  __shared__ int s_off[4][kWarps * kSamples];
  __shared__ float s_coef[4][kWarps * kSamples];
  __shared__ float s_w[kWarps * kSamples];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= queries) return;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long item = (b * queries + q) * heads + h;
  const int row = heads * kHeadDim;  // floats per position

  // phase 1: one lane per (level, point) sample
  if (lane < kSamples) {
    const int i = warp * kSamples + lane;
    const int l = lane / kPoints;
    const int hl = l == 0 ? lv.h[0] : (l == 1 ? lv.h[1] : lv.h[2]);
    const int wl = l == 0 ? lv.w[0] : (l == 1 ? lv.w[1] : lv.w[2]);
    const int start =
        l == 0 ? lv.start[0] : (l == 1 ? lv.start[1] : lv.start[2]);
    const float2 xy = locs[item * kSamples + lane];
    const float x = __fsub_rn(__fmul_rn(xy.x, static_cast<float>(wl)), 0.5f);
    const float y = __fsub_rn(__fmul_rn(xy.y, static_cast<float>(hl)), 0.5f);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = __fsub_rn(x, x0);
    const float fy = __fsub_rn(y, y0);
    const int xa = clamp_index(x0, wl);
    const int xb = clamp_index(__fadd_rn(x0, 1.0f), wl);
    const int ya = start + clamp_index(y0, hl) * wl;
    const int yb = start + clamp_index(__fadd_rn(y0, 1.0f), hl) * wl;
    s_off[0][i] = (ya + xa) * row;
    s_off[1][i] = (ya + xb) * row;
    s_off[2][i] = (yb + xa) * row;
    s_off[3][i] = (yb + xb) * row;
    const float ox = __fsub_rn(1.0f, fx);
    const float oy = __fsub_rn(1.0f, fy);
    s_coef[0][i] = __fmul_rn(oy, ox);
    s_coef[1][i] = __fmul_rn(oy, fx);
    s_coef[2][i] = __fmul_rn(fy, ox);
    s_coef[3][i] = __fmul_rn(fy, fx);
    s_w[i] = weights[item * kSamples + lane];
  }
  __syncwarp();

  // phase 2: lane group p gathers point p over the levels, a float4 a lane
  const int p = lane / kLanesPerPoint;
  const int j = lane % kLanesPerPoint;
  const float* vb =
      values + static_cast<size_t>(b) * total_s * row + h * kHeadDim + j * 4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int i = warp * kSamples + l * kPoints + p;
    const float4 g00 = __ldg(reinterpret_cast<const float4*>(vb + s_off[0][i]));
    const float4 g01 = __ldg(reinterpret_cast<const float4*>(vb + s_off[1][i]));
    const float4 g10 = __ldg(reinterpret_cast<const float4*>(vb + s_off[2][i]));
    const float4 g11 = __ldg(reinterpret_cast<const float4*>(vb + s_off[3][i]));
    const float c[4] = {s_coef[0][i], s_coef[1][i], s_coef[2][i],
                        s_coef[3][i]};
    const float w = s_w[i];
    acc.x = corner_sum(acc.x, c, g00.x, g01.x, g10.x, g11.x, w);
    acc.y = corner_sum(acc.y, c, g00.y, g01.y, g10.y, g11.y, w);
    acc.z = corner_sum(acc.z, c, g00.z, g01.z, g10.z, g11.z, w);
    acc.w = corner_sum(acc.w, c, g00.w, g01.w, g10.w, g11.w, w);
  }
  // total = ((point 0 + point 1) + point 2) + point 3, in lane group 0
  float4 total = acc;
#pragma unroll
  for (int g = 1; g < kPoints; ++g) {
    const int d = g * kLanesPerPoint;
    total.x = __fadd_rn(total.x, __shfl_down_sync(kFullMask, acc.x, d));
    total.y = __fadd_rn(total.y, __shfl_down_sync(kFullMask, acc.y, d));
    total.z = __fadd_rn(total.z, __shfl_down_sync(kFullMask, acc.z, d));
    total.w = __fadd_rn(total.w, __shfl_down_sync(kFullMask, acc.w, d));
  }
  if (p == 0) reinterpret_cast<float4*>(out + item * kHeadDim)[j] = total;
}

}  // namespace

// values (batch, total_s, heads, 32), 16-byte aligned, total_s * heads * 32
// below 2^31; level_hws: 3 triples (h, w, start) in host memory; locs
// (batch, queries, heads, 3, 4, 2) 8-byte aligned; weights (batch, queries,
// heads, 3, 4); out (batch, queries, heads, 32) 16-byte aligned. All
// contiguous fp32; batch and heads at most 65535, none of the sizes 0.
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
  const dim3 grid((queries + kWarps - 1) / kWarps, heads, batch);
  deform_kernel<<<grid, kWarps * 32, 0, stream>>>(
      values, lv, reinterpret_cast<const float2*>(locs), weights, out, total_s,
      heads, queries);
  return static_cast<int>(cudaGetLastError());
}
