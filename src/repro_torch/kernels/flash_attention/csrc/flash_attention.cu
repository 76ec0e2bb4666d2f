// Blocked flash-attention forward for Hopper (sm_90a), plain C interface.
//
//   o[b, q, h] = softmax_k(q[b, q, h] . k[b, k, h/G] / sqrt(D)) v[b, k, h/G]
//
// over the keys k with k <= q (causal, top-left aligned), k > q - window
// (sliding window), k < Skv; a row with no such key gives 0.  GQA: query
// head h reads kv head h / (H / KVH), and K/V are never repeated.
// Replaces src/repro/kernels/flash_attention/kernel.py _flash_kernel (the
// JAX model path is models/layers.py chunked_attention in prefill/train).
//
// Layout: q and o are (B, Sq, H, D), k and v (B, Skv, KVH, D), the model's
// own layout, read through element strides (the last dim contiguous), so
// there is no transpose and no pad copy: the ragged edge of Sq and Skv is
// masked in the kernel.  Inputs f32 or bf16, o in q's dtype; scores,
// softmax statistics and the output accumulator are f32, and P stays f32
// for the PV product.
//
// Bound: at the main path's shape (recurrentgemma-2b prefill, S=4096,
// window 2048, D=256) the work is ~2.6e11 flops against ~185 MB moved, so
// it is bound by operations.  This first kernel computes in f32 on the SIMT
// cores (no tensor cores yet; wgmma + TMA is later work), so its own floor
// is the 67 TFLOP/s f32 rate.  What the design does about it:
//   * one block per (q-tile of 64 rows, head, batch), online softmax over
//     kv-tiles of 32 keys, and kv-tiles wholly outside the causal/window
//     band are skipped, so the work is O(S * window), not O(S^2) (the
//     Pallas grid visits every tile and masks it);
//   * 256 threads as a 16 x 16 grid; a thread owns 4 query rows and 2
//     key columns of a score tile and the same 4 rows x D/16 columns of the
//     output, so each shared-memory read feeds several FMAs (float4 reads
//     along D for Q K^T, rows padded by 4 floats so 16 K rows hit distinct
//     banks);
//   * D <= 256: the f32 accumulator of a row is spread over 16 threads
//     (at most 16 registers a row), and Q, K, V tiles sit in dynamic
//     shared memory (141 KB at D = 256).
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises if it is not cudaSuccess.  Nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 32;        // keys of a kv-tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kRowsPerThread = kBQ / 16;
constexpr int kColsPerThread = kBK / 16;
constexpr int kMaxD = 256;
constexpr int kDPerThread = kMaxD / 16;
constexpr float kNegInf = -1e30f;

enum Dtype : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max / sum over the 16 threads of one row group (lanes sharing ty)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {  // element strides of (batch, seq, head); dim D is contiguous
  long long b, s, h;
};

size_t smem_bytes(int D) {
  const int ld = D + 4;
  return sizeof(float) *
         static_cast<size_t>(kBQ * ld + kBK * ld + kBK * D + kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KVH,
                 int Sq, int Skv, int D, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 4;                  // 16-byte rows, conflict-free
  float* Qs = smem;                      // kBQ x ld
  float* Ks = Qs + kBQ * ld;             // kBK x ld
  float* Vs = Ks + kBK * ld;             // kBK x D
  float* Ps = Vs + kBK * D;              // kBQ x (kBK + 1)
  const int ldp = kBK + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qs[r * ld + d] = qi < Sq ? to_f32(qb[qi * qs.s + d]) : 0.f;
  }

  // keys any row of this tile can see
  const int q_last = min(Sq, q0 + kBQ) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  if (causal) kv_hi = min(Skv, q_last + 1);

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kDPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * ld + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

    // mask, online softmax statistics, P to shared memory
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[kColsPerThread];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < Skv && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete

    for (int c = 0; c < kBK; ++c) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) p[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[qi * os.s + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, int D, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal, int window,
                   float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, Sq, Skv, D, qs,
      ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, D); k, v: (B, Skv, KVH, D); dtype 0 f32, 1 bf16 (all
// four alike).  *_st: element strides of (batch, seq, head), D contiguous.
// window <= 0: no window.  D % 4 == 0, D <= 256 and H % KVH == 0 (the
// wrapper checks).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KVH, int Sq, int Skv,
                        int D, const long long* q_st, const long long* k_st,
                        const long long* v_st, const long long* o_st,
                        int causal, int window, float scale, void* stream) {
  if (D > kMaxD || D % 4 != 0 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_st[0], q_st[1], q_st[2]};
  const Strides ks{k_st[0], k_st[1], k_st[2]};
  const Strides vs{v_st[0], v_st[1], v_st[2]};
  const Strides os{o_st[0], o_st[1], o_st[2]};
  cudaError_t e;
  if (dtype == kF32) {
    e = launch<float>(q, k, v, o, B, H, KVH, Sq, Skv, D, qs, ks, vs, os,
                      causal, window, scale, s);
  } else if (dtype == kBF16) {
    e = launch<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Skv, D, qs, ks, vs,
                              os, causal, window, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
