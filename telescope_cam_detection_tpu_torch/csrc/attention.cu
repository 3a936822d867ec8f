// Fused multi-head attention for Hopper (sm_90a), on the tensor cores:
//
//   out[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D)) v[b, j, h, :]
//
// over (B, T, H, D) tensors, no mask across real tokens, fp32 or bf16 inputs,
// fp32 accumulation and softmax, output in the input type.
//
// Replaces telescope_cam_detection_tpu/ops/pallas_attention.py _attn_kernel
// (the Pallas TPU kernel behind flash_attention). The plain PyTorch version
// is telescope_cam_detection_tpu_torch/ops/attention.py attention_reference.
// Both matrix products and the softmax are computed here; nothing is left to
// a library.
//
// Bound: 4 B H T^2 D floating-point operations against 4 B H T D elements
// moved. At the widest shape the classifier gives it (B = 16, T = 577,
// H = 16, D = 64) that is 2.18e10 operations and 151 MB (fp32): operations
// bound it, 0.022 ms in bf16 at 989 TFLOP/s; in fp32 0.326 ms on the CUDA
// cores at 67 TFLOP/s, or 0.132 ms for the three TF32 products a product
// takes here (3 x 2.18e10 at 495 TFLOP/s). The tensor-core route bounds
// the fp32 kernel below the CUDA cores' bound, so the kernel is held to the
// lower of the two.
//
// What the first design lost (PR 2: two threads per query row, fp32 FMAs on
// the CUDA cores): bf16 was widened to fp32 in shared memory and ran at the
// fp32 rate; every four FMAs cost a 16-byte shared-memory read and every
// score a shuffle; K and V were copied through registers in step with the
// math. 1.0 ms in both types, 32% of the CUDA cores' peak in fp32.
//
// This design (FlashAttention-2 on mma.sync, one route for both types):
//   - grid (ceil(T / 64), B * H), 128 threads. A block owns 64 query rows of
//     one (batch, head); each of its four warps 16 of them. A warp whose 16
//     rows all lie past T (the last block at T = 577) skips the math.
//   - K and V stream through shared memory in tiles of 64 keys, a ring of
//     two stages filled with cp.async (16 bytes a copy, zero-filled past T):
//     the next tile lands while this one is computed. The tensors are read
//     with their (B, T, H, D) strides; nothing is transposed or padded
//     outside.
//   - Q is read once into registers as mma A fragments. S = Q K^T goes into
//     fp32 accumulator registers (16 rows x 64 keys per warp); the online
//     softmax runs on them, row max and sum reduced across the four lanes
//     that share a row, exp2f with log2(e) folded into the scale. Only the
//     last, ragged tile masks keys past T, and it skips the groups of 8
//     keys that hold none (seven of its eight at T = 577, and at T = 65,
//     the eva02-tiny classifier's, seven of two tiles' sixteen). P is
//     converted in registers into the A operand of P V (the accumulator
//     layout of S is the operand layout of P, so no data moves between
//     lanes).
//   - bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate); K and V fragments
//     from shared memory by ldmatrix (.trans for V), rows padded by 16 bytes
//     so the eight rows of a matrix fall in distinct banks. p is rounded to
//     bf16 for P V; l sums the unrounded p.
//   - fp32: 3xTF32 on mma.sync.m16n8k8. Each operand is split x = hi + lo,
//     hi = tf32(x), lo = tf32(x - hi) (cvt.rna: round to nearest, ties
//     away), and a product is taken as lo hi' + hi lo' + hi hi' with fp32
//     accumulation; the dropped lo lo' is about 2^-22 relative, so the
//     result holds fp32's tolerance (2e-5) without TF32's loss. TF32 stays
//     off for cuBLAS and cuDNN. The tf32 B fragment has no ldmatrix: K is
//     read as 8-byte pairs (the d order inside an mma step is permuted to
//     make b0, b1 adjacent), V as two 4-byte reads, from rows padded by 8
//     and 4 floats, conflict-free for both patterns. Scores of q and k
//     rounded to quarters stay exact: such values have lo = 0.
//   - The rescale changes the order of summation against the plain
//     version; agreement is to a tolerance (2e-5 fp32, 2e-2 bf16), not bit
//     for bit.
// wgmma (the card's full tensor-core rate) and TMA are later work: mma.sync
// with cp.async was the route that could be made right first, for every
// D in 16..128 in both types (16 instances).
//
// Resources (-Xptxas -v, nvcc 12.8; chip_smoke.py phase 1 prints the D = 64
// instances): fp32 168 registers at D = 64 (bounded for three blocks an
// SM; 40 bytes of spill), 255 with spills from D = 96 on; bf16 128 at
// D = 64 (8 bytes of spill). Dynamic shared memory 2 x 64 x ((D + 8) +
// (D + 4)) x 4 bytes in fp32 (71.7 KB at D = 64), 2 x 64 x 2 (D + 8) x 2
// bytes in bf16 (36.9 KB), opted in above 48 KB once per instance. The 16
// instances (8 head dims x 2 types) build in about 27-30 s on the H100
// host, in parallel with the other kernels.
//
// The launch function allocates nothing, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError() (or -1 for a head
// dim it has no instance for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kRows = 64;       // query rows of a block, 16 per warp
constexpr int kKeys = 64;       // keys per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Row strides of the K and V tiles in elements (see the header note).
template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kStrideK = D + 8;
  static constexpr int kStrideV = D + (kF32 ? 4 : 8);
  static constexpr int kStage = kKeys * (kStrideK + kStrideV);   // elements
  static constexpr size_t kSmemBytes = 2 * kStage * sizeof(T);
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where `real` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Keys [j0, j0 + 64) of K and V into one stage of the ring.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k,
                                          const T* v, size_t base,
                                          size_t token_stride, int j0, int t,
                                          int tid) {
  typedef Layout<T, D> L;
  constexpr int kVec = 16 / sizeof(T);     // elements per copy
  constexpr int kChunks = D / kVec;        // copies per row
  static_assert((kKeys * kChunks) % kThreads == 0, "ragged tile copy");
#pragma unroll
  for (int n = 0; n < kKeys * kChunks / kThreads; ++n) {
    const int idx = tid + n * kThreads;
    const int key = idx / kChunks;
    const int c = idx % kChunks;
    const bool real = j0 + key < t;
    const size_t off =
        base + (real ? static_cast<size_t>(j0 + key) * token_stride : 0) +
        c * kVec;
    cp_async16(ks + key * L::kStrideK + c * kVec, k + off, real);
    cp_async16(vs + key * L::kStrideV + c * kVec, v + off, real);
  }
}

// ---- fp32: 3xTF32 on mma.sync.m16n8k8 ------------------------------------

// cvt.rna.tf32.f32 in two integer operations: round the magnitude to
// nearest, ties away, at bit 13, then clear the 13 bits the tensor cores
// ignore.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float b0,
                                           float b1) {
  uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
  split(b0, b0_hi, b0_lo);
  split(b1, b1_hi, b1_lo);
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// ---- bf16: mma.sync.m16n8k16 ---------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---- the two products of one tile, per warp ------------------------------
//
// Fragment coordinates: g = lane / 4 (row g and g + 8 of the warp's 16),
// q4 = lane % 4. An S accumulator s[n] holds S[g][8n + 2 q4 + {0, 1}] in
// s[n][0..1] and S[g + 8][...] in s[n][2..3]; O's o[m] likewise over d.

template <typename T, int D>
struct QFrag;

template <int D>
struct QFrag<float, D> {   // split once: hi = tf32(q), lo = tf32(q - hi)
  uint32_t hi[D / 8][4];
  uint32_t lo[D / 8][4];
};

template <int D>
struct QFrag<bf16, D> {
  uint32_t a[D / 16][4];
};

// Q rows of this warp from global memory into A fragments; rows past T are
// zero. fp32 step s covers d = 8s + 2 q4 + {0, 1} as k = q4 and q4 + 4.
template <int D>
__device__ __forceinline__ void load_q(QFrag<float, D>& f, const float* q,
                                       size_t row_g, size_t row_g8, bool ok_g,
                                       bool ok_g8, int q4) {
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    const int d = 8 * s + 2 * q4;
    const float2 x = ok_g ? *reinterpret_cast<const float2*>(q + row_g + d)
                          : make_float2(0.f, 0.f);
    const float2 y = ok_g8 ? *reinterpret_cast<const float2*>(q + row_g8 + d)
                           : make_float2(0.f, 0.f);
    split(x.x, f.hi[s][0], f.lo[s][0]);
    split(y.x, f.hi[s][1], f.lo[s][1]);
    split(x.y, f.hi[s][2], f.lo[s][2]);
    split(y.y, f.hi[s][3], f.lo[s][3]);
  }
}

template <int D>
__device__ __forceinline__ void load_q(QFrag<bf16, D>& f, const bf16* q,
                                       size_t row_g, size_t row_g8, bool ok_g,
                                       bool ok_g8, int q4) {
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const int d = 16 * s + 2 * q4;
    f.a[s][0] = ok_g ? *reinterpret_cast<const uint32_t*>(q + row_g + d) : 0u;
    f.a[s][1] = ok_g8 ? *reinterpret_cast<const uint32_t*>(q + row_g8 + d) : 0u;
    f.a[s][2] = ok_g ? *reinterpret_cast<const uint32_t*>(q + row_g + d + 8) : 0u;
    f.a[s][3] =
        ok_g8 ? *reinterpret_cast<const uint32_t*>(q + row_g8 + d + 8) : 0u;
  }
}

// Only the first `live` groups of 8 keys hold a real key; the ragged last
// tile (kRagged) skips the rest. Full tiles take a copy without the checks
// (a branch inside the unrolled loops slowed them).
template <int D, bool kRagged>
__device__ __forceinline__ void tile_scores(float (&s)[kKeys / 8][4],
                                            const QFrag<float, D>& f,
                                            const float* ks, int lane,
                                            int live) {
  typedef Layout<float, D> L;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int step = 0; step < D / 8; ++step) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      if (kRagged && n >= live) break;
      const float2 kk = *reinterpret_cast<const float2*>(
          ks + (8 * n + g) * L::kStrideK + 8 * step + 2 * q4);
      mma_3xtf32(s[n], f.hi[step], f.lo[step], kk.x, kk.y);
    }
  }
}

template <int D, bool kRagged>
__device__ __forceinline__ void tile_scores(float (&s)[kKeys / 8][4],
                                            const QFrag<bf16, D>& f,
                                            const bf16* ks, int lane,
                                            int live) {
  typedef Layout<bf16, D> L;
  // ldmatrix x4 row addresses: keys +0..7 / +8..15, d +0 / +8
  const int key = (lane & 7) + ((lane >> 4) << 3);
  const int dd = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int step = 0; step < D / 16; ++step) {
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np) {
      if (kRagged && 2 * np >= live) break;
      uint32_t b[4];
      ldmatrix_x4(b, ks + (16 * np + key) * L::kStrideK + 16 * step + dd);
      mma_bf16(s[2 * np], f.a[step], b[0], b[1]);
      mma_bf16(s[2 * np + 1], f.a[step], b[2], b[3]);
    }
  }
}

// o += p v over the tile's live keys. fp32: key step n covers keys
// 8n + 2 q4 + {0, 1} as k = q4 and q4 + 4, so p's A fragment is s[n] as is.
template <int D, bool kRagged>
__device__ __forceinline__ void tile_pv(float (&o)[D / 8][4],
                                        const float (&p)[kKeys / 8][4],
                                        const float* vs, int lane, int live) {
  typedef Layout<float, D> L;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    if (kRagged && n >= live) break;
    uint32_t a_hi[4], a_lo[4];
    split(p[n][0], a_hi[0], a_lo[0]);
    split(p[n][2], a_hi[1], a_lo[1]);
    split(p[n][1], a_hi[2], a_lo[2]);
    split(p[n][3], a_hi[3], a_lo[3]);
    const float* v0 = vs + (8 * n + 2 * q4) * L::kStrideV + g;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      mma_3xtf32(o[m], a_hi, a_lo, v0[8 * m], v0[L::kStrideV + 8 * m]);
    }
  }
}

template <int D, bool kRagged>
__device__ __forceinline__ void tile_pv(float (&o)[D / 8][4],
                                        const float (&p)[kKeys / 8][4],
                                        const bf16* vs, int lane, int live) {
  typedef Layout<bf16, D> L;
  // ldmatrix.trans x4 row addresses: keys +0..7 / +8..15, d +0 / +8
  const int key = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int dd = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    if (kRagged && 2 * kk >= live) break;
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int mp = 0; mp < D / 16; ++mp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (16 * kk + key) * L::kStrideV + 16 * mp + dd);
      mma_bf16(o[2 * mp], a, b[0], b[1]);
      mma_bf16(o[2 * mp + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Blocks an SM should hold at D <= 64: fp32 is held by its 71.7 KB of
// shared memory to three (170 registers a thread), bf16 to four (128).
template <typename T, int D>
struct Occupancy {
  static constexpr int kBlocks =
      D > 64 ? 1 : (std::is_same<T, float>::value ? 3 : 4);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (Occupancy<T, D>::kBlocks))
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int t, int h,
                 float scale_log2) {
  typedef Layout<T, D> L;
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "bad head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int b = blockIdx.y / h;
  const int head = blockIdx.y % h;
  const size_t token_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(b) * t * h + head) * D;
  const int row0 = blockIdx.x * kRows + warp * 16;   // this warp's rows
  const int r_g = row0 + g, r_g8 = row0 + g + 8;
  const bool busy = row0 < t;           // warp-uniform

  const int n_tiles = (t + kKeys - 1) / kKeys;
  load_tile<T, D>(smem, smem + kKeys * L::kStrideK, k, v, base, token_stride,
                  0, t, tid);
  cp_async_commit();

  QFrag<T, D> qf;
  load_q<D>(qf, q, base + r_g * token_stride, base + r_g8 * token_stride,
            r_g < t, r_g8 < t, q4);

  float o[D / 8][4];
#pragma unroll
  for (int m = 0; m < D / 8; ++m) o[m][0] = o[m][1] = o[m][2] = o[m][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running row maxima
  float l_run[2] = {0.f, 0.f};        // this lane's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      T* next = smem + ((it + 1) & 1) * L::kStage;
      load_tile<T, D>(next, next + kKeys * L::kStrideK, k, v, base,
                      token_stride, (it + 1) * kKeys, t, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                 // tile `it` has landed
    __syncthreads();
    const T* ks = smem + (it & 1) * L::kStage;
    const T* vs = ks + kKeys * L::kStrideK;
    if (busy) {
      float s[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int j0 = it * kKeys;
      const int live = min(kKeys, t - j0 + 7) / 8;   // groups with a real key
      const bool ragged = j0 + kKeys > t;
      if (ragged) {
        tile_scores<D, true>(s, qf, ks, lane, live);
      } else {
        tile_scores<D, false>(s, qf, ks, lane, live);
      }

      if (ragged) {                     // the last tile: mask keys >= T
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          const int key = j0 + 8 * n + 2 * q4;
          if (key >= t) s[n][0] = s[n][2] = -CUDART_INF_F;
          if (key + 1 >= t) s[n][1] = s[n][3] = -CUDART_INF_F;
        }
      }
      // online softmax over rows g (r = 0) and g + 8 (r = 1); key j0 is
      // real, so each row's tile maximum is finite
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        const float corr = exp2f((m_run[r] - m_new) * scale_log2);  // 0 first
        const float m_scaled = m_new * scale_log2;
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          s[n][2 * r] = exp2f(fmaf(s[n][2 * r], scale_log2, -m_scaled));
          s[n][2 * r + 1] = exp2f(fmaf(s[n][2 * r + 1], scale_log2, -m_scaled));
          sum += s[n][2 * r] + s[n][2 * r + 1];
        }
        l_run[r] = l_run[r] * corr + sum;
#pragma unroll
        for (int m = 0; m < D / 8; ++m) {
          o[m][2 * r] *= corr;
          o[m][2 * r + 1] *= corr;
        }
      }
      if (ragged) {
        tile_pv<D, true>(o, s, vs, lane, live);
      } else {
        tile_pv<D, false>(o, s, vs, lane, live);
      }
    }
    __syncthreads();                    // the stage is read before refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
  }
  if (!busy) return;
  const float inv_g = 1.f / l_run[0], inv_g8 = 1.f / l_run[1];
#pragma unroll
  for (int m = 0; m < D / 8; ++m) {
    const int d = 8 * m + 2 * q4;
    if (r_g < t) {
      store2(out + base + r_g * token_stride + d, o[m][0] * inv_g,
             o[m][1] * inv_g);
    }
    if (r_g8 < t) {
      store2(out + base + r_g8 * token_stride + d, o[m][2] * inv_g8,
             o[m][3] * inv_g8);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int t, int h, float scale, cudaStream_t stream) {
  typedef Layout<T, D> L;
  // once per instance (a driver call per launch costs the host microseconds)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t + kRows - 1) / kRows, batch * h);
  attention_kernel<T, D><<<grid, kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), t, h, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int d, const void* q, const void* k, const void* v,
                      void* out, int batch, int t, int h, float scale,
                      cudaStream_t stream) {
  switch (d) {
#define ATTENTION_CASE(DIM) \
  case DIM:                 \
    return launch<T, DIM>(q, k, v, out, batch, t, h, scale, stream);
    ATTENTION_CASE(16)
    ATTENTION_CASE(32)
    ATTENTION_CASE(48)
    ATTENTION_CASE(64)
    ATTENTION_CASE(80)
    ATTENTION_CASE(96)
    ATTENTION_CASE(112)
    ATTENTION_CASE(128)
#undef ATTENTION_CASE
    default:
      return -1;
  }
}

}  // namespace

// q, k, v, out: contiguous (batch, t, h, d), 16-byte aligned, fp32 or bf16
// (is_bf16).
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* out, int batch, int t, int h, int d,
                                float scale, int is_bf16,
                                cudaStream_t stream) {
  if (is_bf16) {
    return dispatch_head_dim<bf16>(d, q, k, v, out, batch, t, h, scale,
                                   stream);
  }
  return dispatch_head_dim<float>(d, q, k, v, out, batch, t, h, scale, stream);
}
