// Fused multi-head attention for Hopper (sm_90a):
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
// H = 16, D = 64, fp32) that is 2.18e10 operations and 151 MB: operations
// bound the kernel on the CUDA cores by a wide margin, so the design keeps
// the FMA units fed and never writes the (T, T) scores anywhere.
//
// Design (written for the card; the TPU kernel held all of K and V of one
// head in on-chip memory, which at T = 577 is more than one SM has):
//   - grid (ceil(T / rows), B * H), 128 threads. A block owns `rows` =
//     128 / G query rows of one (batch, head); G = 2 threads share a row,
//     each holding D / G elements of q and of the output accumulator in
//     registers. The D axis is dealt to the G threads in interleaved groups
//     of four, so that their shared-memory reads are contiguous.
//   - K and V stream through shared memory in tiles of 32 keys, converted
//     to fp32 on the way in. The tensors are read with their (B, T, H, D)
//     strides; nothing is transposed or padded outside.
//   - Online softmax in steps of 8 keys: the 8 scores of a row are computed
//     (partial dot products summed across the G threads with shuffles),
//     the running maximum m and sum l are updated, the accumulator is
//     rescaled once per step, and p v is added.
//   - The last tile is ragged (T = 65, 130, 577 divide by no tile): keys
//     past T are zero-filled and their scores set to -inf; a step that
//     holds no real key is never entered, so m is finite whenever
//     exp(m_old - m_new) is taken and -inf - (-inf) cannot arise. Query
//     rows past T compute on zeros and are not written.
//   - bf16: q, k, v are widened exactly; p is rounded to bf16 before p v as
//     the TPU kernel does, while l sums the unrounded p.
// The rescale changes the order of summation against the plain version;
// agreement is to a tolerance (2e-5 fp32, 2e-2 bf16), not bit for bit.
//
// Tensor cores (wgmma), TMA and a deeper pipeline are later work: this
// version pays one 16-byte shared-memory read per four FMAs.
//
// The launch function allocates nothing, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError() (or -1 for a head
// dim it has no instance for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 32;  // keys per shared-memory tile
constexpr int kStep = 8;      // keys per online-softmax step

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// p as the second product sees it: cast to v's type first.
template <typename T>
__device__ __forceinline__ float as_value_type(float p);
template <>
__device__ __forceinline__ float as_value_type<float>(float p) {
  return p;
}
template <>
__device__ __forceinline__ float as_value_type<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int t, int h,
                 float scale) {
  constexpr int kRows = kThreads / G;  // query rows of a block
  constexpr int kVec = D / 4;          // float4 groups in a row
  constexpr int kOwn = kVec / G;       // float4 groups one thread holds
  static_assert(D % 16 == 0 && kVec % G == 0 && 32 % G == 0, "bad D or G");

  __shared__ float4 ks[kKeyTile][kVec];
  __shared__ float4 vs[kKeyTile][kVec];

  const int tid = threadIdx.x;
  const int part = tid % G;
  const int row = blockIdx.x * kRows + tid / G;
  const int b = blockIdx.y / h;
  const int head = blockIdx.y % h;
  const size_t token_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(b) * t * h + head) * D;

  float4 qr[kOwn];
  float4 acc[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    qr[i] = row < t ? load4(q + base + row * token_stride + (i * G + part) * 4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -CUDART_INF_F;  // running maximum of the row's scores
  float l = 0.f;            // running sum of exp(score - m)

  for (int j0 = 0; j0 < t; j0 += kKeyTile) {
    const int n = min(kKeyTile, t - j0);  // real keys in this tile
    for (int idx = tid; idx < kKeyTile * kVec; idx += kThreads) {
      const int key = idx / kVec;
      const int c = idx % kVec;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (key < n) {
        const size_t off = base + (j0 + key) * token_stride + c * 4;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[key][c] = kk;
      vs[key][c] = vv;
    }
    __syncthreads();

    for (int c0 = 0; c0 < n; c0 += kStep) {  // key c0 is real in every step
      float s[kStep];
      float step_max = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          const float4 kk = ks[c0 + jj][i * G + part];
          dot = fmaf(qr[i].x, kk.x, dot);
          dot = fmaf(qr[i].y, kk.y, dot);
          dot = fmaf(qr[i].z, kk.z, dot);
          dot = fmaf(qr[i].w, kk.w, dot);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        s[jj] = (c0 + jj < n) ? dot * scale : -CUDART_INF_F;
        step_max = fmaxf(step_max, s[jj]);
      }
      const float m_new = fmaxf(m, step_max);  // finite: s[0] is real
      const float corr = expf(m - m_new);      // 0 on the first step
      l *= corr;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        acc[i].x *= corr;
        acc[i].y *= corr;
        acc[i].z *= corr;
        acc[i].w *= corr;
      }
      m = m_new;
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        const float p = expf(s[jj] - m);  // 0 for a masked key
        l += p;
        const float pv = as_value_type<T>(p);
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          const float4 vv = vs[c0 + jj][i * G + part];
          acc[i].x = fmaf(pv, vv.x, acc[i].x);
          acc[i].y = fmaf(pv, vv.y, acc[i].y);
          acc[i].z = fmaf(pv, vv.z, acc[i].z);
          acc[i].w = fmaf(pv, vv.w, acc[i].w);
        }
      }
    }
    __syncthreads();
  }

  if (row < t) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const float4 o = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l,
                                   acc[i].w / l);
      store4(out + base + row * token_stride + (i * G + part) * 4, o);
    }
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int t, int h, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  const dim3 grid((t + kRows - 1) / kRows, batch * h);
  attention_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), t, h, scale);
  return static_cast<int>(cudaGetLastError());
}

// Threads that share one query row. Measured on an H100 at D = 64: 2 is as
// fast as 1 when the grid is large and faster when it is small (fewer
// registers, more blocks in flight); 4 pays too much for its shuffles.
constexpr int kGroup = 2;

template <typename T>
int dispatch_head_dim(int d, const void* q, const void* k, const void* v,
                      void* out, int batch, int t, int h, float scale,
                      cudaStream_t stream) {
  switch (d) {
#define ATTENTION_CASE(DIM) \
  case DIM:                 \
    return launch<T, DIM, kGroup>(q, k, v, out, batch, t, h, scale, stream);
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
    return dispatch_head_dim<__nv_bfloat16>(d, q, k, v, out, batch, t, h,
                                            scale, stream);
  }
  return dispatch_head_dim<float>(d, q, k, v, out, batch, t, h, scale, stream);
}
