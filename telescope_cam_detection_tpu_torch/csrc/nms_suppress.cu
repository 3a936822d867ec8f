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
// 8 KB each), roughly 0.04 us at 3.35 TB/s. So the bound is compute; in
// practice the two launches and the serial part of the greedy rule set the
// time.
//
// Design: two launches from one call.
//   1. iou_mask_kernel, grid (ceil(K/64), ceil(K/64), B), 256 threads: one
//      64 x 64 tile, four threads a row (each every fourth column, ORed by
//      shuffles), so that a wave holds enough warps to hide the latency of
//      the pair arithmetic. The tile's 64 column boxes and their areas are
//      staged in shared memory; bit c of mask[b, r, colblock] is set when
//      c > r and IoU(r, c) > thr. Tiles below the diagonal return at once:
//      the scan never reads those words. The division runs only for pairs
//      that intersect (0 / union is 0 whatever the union). The mask is a
//      uint64 scratch (B, K, ceil(K/64)) that the wrapper allocates: 128 KB
//      per image at K = 1000.
//   2. greedy_scan_kernel, one warp per image, in chunks of 64 rows (one
//      mask word). Per chunk c:
//        - the chunk's 64 mask rows, words [c, c + 32), were copied into
//          shared memory with cp.async (a lane a word) while chunk c - 1
//          was resolved (a ring of two 16.9 KB stages, rows padded to 33
//          words so a column of 32 rows falls in 32 banks), and the chunk's
//          valid bytes were loaded into registers then too;
//        - `removed` lives in registers: lane l holds the word of the
//          32-word window [c, c + 32) that is l mod 32; words past the
//          window wait in shared memory (`far`) and enter the window, one a
//          chunk, in the lane whose word just left it;
//        - the owner of word c broadcasts it; the candidates (valid and
//          not removed) are resolved in rounds, each two warp ORs
//          (__reduce_or_sync) of the diagonal words mask[i][c] that lanes
//          i and i + 32 hold: a candidate that no undecided candidate
//          suppresses is kept (nothing before it can be), and what the
//          rows kept in a round suppress is removed. The lowest undecided
//          candidate is kept in every round, so the rounds end; on the
//          main path's boxes one or two rounds settle a chunk;
//        - keep is written once per chunk (two coalesced 32-byte stores);
//        - each lane ORs the kept rows' mask words into its own later word
//          (64 shared-memory reads, no branch), and into its `far` words
//          from global memory when K > 2048. At K <= 1024 (16 words or
//          fewer, the main path) half the lanes own no word, so each word
//          takes two lanes, 32 rows each, for its staging and its ORs.
//      Invalid rows never suppress anything.
//   What the old scan lost: one warp walked all K rows one at a time (two
//   __syncwarp, a shared-memory bitset, and an unprefetched L2 read of 16
//   words for each kept row), about 350 ns a row, 0.35 ms at K = 1000.
//   Walking only the kept rows (__ffsll and a dependent shuffle each) still
//   cost a warp about 80 cycles a kept row, where rounds cost one or two
//   warp ORs a chunk. What is left is the fixed work of a chunk on one
//   warp, about 0.7-0.9 us: four warps sharing it (with `removed` in shared
//   memory and a barrier a chunk), a four-stage ring and 16-byte copies
//   were each slower (PERF.md).
//
// Resources (nvcc 12.8, -Xptxas -v): printed by chip_smoke.py phase 1; the
// scan takes (2 * 64 * 33 + ceil(K/64)) * 8 bytes of dynamic shared memory,
// 41.8 KB at the wrapper's largest K (65,536), within the 48 KB default.
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

typedef unsigned long long u64;

constexpr int kTile = 64;       // rows of a chunk = bits of a mask word
constexpr int kWindow = 32;     // mask words of a chunk staged per row
constexpr int kPitch = kWindow + 1;   // staged row pitch: column 0 of the
                                      // 32 rows a warp reads, in 32 banks
constexpr int kIouParts = 4;    // threads that share a row of an IoU tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamped_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  float iou = 0.0f;                       // 0 / union == 0: no division
  if (inter != 0.0f) {
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  }
  return iou > thr;
}

__global__ void __launch_bounds__(kTile * kIouParts)
iou_mask_kernel(const float4* __restrict__ boxes, int k, int words,
                float thr, u64* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_block < row_block) return;      // never read by the scan
  const int b = blockIdx.z;
  const int t = threadIdx.x / kIouParts;  // this thread's row of the tile
  const int part = threadIdx.x % kIouParts;
  const float4* img = boxes + static_cast<size_t>(b) * k;

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int c0 = col_block * kTile;
  if (threadIdx.x < kTile && c0 + threadIdx.x < k) {
    const float4 cb = img[c0 + threadIdx.x];
    cols[threadIdx.x] = cb;
    col_area[threadIdx.x] = clamped_area(cb);
  }
  __syncthreads();

  const int r = row_block * kTile + t;
  const int n_cols = min(kTile, k - c0);                    // ragged last tile
  const int start = (col_block == row_block) ? t + 1 : 0;   // c > r only
  u64 bits = 0ull;
  if (r < k) {
    const float4 rb = img[r];
    const float r_area = clamped_area(rb);
#pragma unroll
    for (int i = 0; i < kTile / kIouParts; ++i) {
      const int j = i * kIouParts + part;   // the parts read adjacent boxes
      if (j >= start && j < n_cols &&
          iou_over(rb, r_area, cols[j], col_area[j], thr)) {
        bits |= 1ull << j;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kIouParts; off <<= 1) {   // the row's parts: lanes
    bits |= __shfl_xor_sync(kFull, bits, off);
  }
  if (part == 0 && r < k) {
    mask[(static_cast<size_t>(b) * k + r) * words + col_block] = bits;
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The diagonal words of the rows of `set` that this lane holds (rows lane
// and lane + 32 of the chunk), ORed.
__device__ __forceinline__ u64 pick(u64 set, u64 diag_lo, u64 diag_hi,
                                    int lane) {
  return (((set >> lane) & 1ull) ? diag_lo : 0ull) |
         (((set >> (32 + lane)) & 1ull) ? diag_hi : 0ull);
}

// OR across the warp (two REDUX instructions).
__device__ __forceinline__ u64 warp_or(u64 x) {
  return static_cast<u64>(__reduce_or_sync(kFull, static_cast<unsigned>(x))) |
         static_cast<u64>(
             __reduce_or_sync(kFull, static_cast<unsigned>(x >> 32)))
             << 32;
}

// Rows [64c, 64c + 64) of one image's mask, words [c, c + 32), into stage:
// a lane a word, over the rows [row0, row0 + rows_per_lane).
__device__ __forceinline__ void stage_chunk(u64 (*stage)[kPitch],
                                            const u64* __restrict__ m, int c,
                                            int k, int words, int col,
                                            int row0, int rows_per_lane) {
  const int rows = min(row0 + rows_per_lane, k - c * kTile);
  if (col < min(kWindow, words - c)) {
    const u64* src = m + static_cast<size_t>(c) * kTile * words + c + col;
#pragma unroll 8
    for (int r = row0; r < rows; ++r) {
      cp_async8(&stage[r][col], src + static_cast<size_t>(r) * words);
    }
  }
}

// OR of the kept rows [row0, row0 + 32) of one staged word column.
__device__ __forceinline__ u64 or_kept_rows(const u64 (*rows)[kPitch],
                                            u64 kept, int row0, int col) {
  const unsigned bits = static_cast<unsigned>(kept >> row0);
  u64 acc = 0ull;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const u64 x = rows[row0 + r][col];
    acc |= ((bits >> r) & 1u) ? x : 0ull;
  }
  return acc;
}

__global__ void __launch_bounds__(32)
greedy_scan_kernel(const u64* __restrict__ mask,
                   const uint8_t* __restrict__ valid, int k, int words,
                   uint8_t* __restrict__ keep) {
  extern __shared__ u64 smem[];
  u64(*ring)[kTile][kPitch] = reinterpret_cast<u64(*)[kTile][kPitch]>(smem);
  u64* far = smem + 2 * kTile * kPitch;         // words past the window
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* m = mask + static_cast<size_t>(b) * k * words;
  const uint8_t* v = valid + static_cast<size_t>(b) * k;
  uint8_t* out = keep + static_cast<size_t>(b) * k;

  for (int w = lane; w < words; w += 32) far[w] = 0ull;
  u64 removed = 0ull;          // this lane's word of the window [c, c + 32)
  // With 16 words or fewer (K <= 1024) half the lanes own no word: each
  // word's column then takes two lanes, the owner (lane l, rows 0..31) and
  // lane l ^ 16 (rows 32..63), which halves the staging and the ORs.
  const bool paired = words <= 16;
  auto stage = [&](int c) {
    const int j = (lane - c) & 31;
    stage_chunk(ring[c & 1], m, c, k, words, paired ? j & 15 : j,
                paired ? 32 * (j >> 4) : 0, paired ? 32 : kTile);
  };
  stage(0);
  cp_async_commit();
  int v_lo = lane < k ? v[lane] : 0;
  int v_hi = 32 + lane < k ? v[32 + lane] : 0;

  for (int c = 0; c < words; ++c) {
    const int j = (lane - c) & 31;      // this lane's word is c + j
    if (c + 1 < words) stage(c + 1);
    cp_async_commit();                  // maybe empty: wait_group 1 below
    const int base = c * kTile;
    const u64 valid_bits =
        static_cast<u64>(__ballot_sync(kFull, v_lo != 0)) |
        static_cast<u64>(__ballot_sync(kFull, v_hi != 0)) << 32;
    const int next = base + kTile;      // the next chunk's valid bytes
    v_lo = next + lane < k ? v[next + lane] : 0;
    v_hi = next + 32 + lane < k ? v[next + 32 + lane] : 0;
    cp_async_wait<1>();                 // this chunk's stage has landed
    __syncwarp();
    const u64(*rows)[kPitch] = ring[c & 1];

    // resolve the chunk in rounds over the undecided candidates
    const int owner = c & 31;
    const u64 diag_lo = rows[lane][0];        // rows past K: never picked
    const u64 diag_hi = rows[32 + lane][0];
    u64 undecided = valid_bits & ~__shfl_sync(kFull, removed, owner);
    u64 kept = 0ull;
    while (undecided) {
      // no undecided row can suppress these: the greedy rule keeps them
      const u64 sure =
          undecided & ~warp_or(pick(undecided, diag_lo, diag_hi, lane));
      kept |= sure;
      undecided &= ~sure;
      // and removes what they suppress
      undecided &= ~warp_or(pick(sure, diag_lo, diag_hi, lane));
    }
    if (base + lane < k) out[base + lane] = (kept >> lane) & 1ull;
    if (base + 32 + lane < k) out[base + 32 + lane] = (kept >> (32 + lane)) & 1ull;

    // OR the kept rows into the later words
    if (kept) {
      if (paired) {
        const int col = j & 15;
        u64 acc = col != 0 && c + col < words
                      ? or_kept_rows(rows, kept, 32 * (j >> 4), col)
                      : 0ull;
        acc |= __shfl_xor_sync(kFull, acc, 16);
        if (j < 16) removed |= acc;
      } else if (j != 0 && c + j < words) {
        removed |= or_kept_rows(rows, kept, 0, j) |
                   or_kept_rows(rows, kept, 32, j);
      }
      for (int w = c + kWindow + j; w < words; w += 32) {
        u64 acc = far[w];
        for (u64 rest = kept; rest; rest &= rest - 1) {
          const int r = __ffsll(static_cast<long long>(rest)) - 1;
          acc |= m[static_cast<size_t>(base + r) * words + w];
        }
        far[w] = acc;
      }
    }
    if (j == 0) {                 // word c leaves the window, c + 32 enters
      removed = c + kWindow < words ? far[c + kWindow] : 0ull;
    }
    __syncwarp();                 // the stage is read before it is refilled
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int nms_suppress_launch(const float* boxes, const uint8_t* valid,
                                   int batch, int k, float thr, u64* mask,
                                   uint8_t* keep, cudaStream_t stream) {
  const int words = (k + kTile - 1) / kTile;
  const dim3 grid(words, words, batch);
  iou_mask_kernel<<<grid, kTile * kIouParts, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), k, words, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (2 * kTile * kPitch + static_cast<size_t>(words)) *
                      sizeof(u64);
  greedy_scan_kernel<<<batch, 32, smem, stream>>>(mask, valid, k, words, keep);
  return static_cast<int>(cudaGetLastError());
}
