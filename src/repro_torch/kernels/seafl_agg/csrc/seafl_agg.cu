// Fused SEAFL aggregation kernels for Hopper (sm_90a), plain C interface.
//
// The server's aggregation is two passes over the (K, P) update buffer:
//
//   sim_partials  — Eq. (5) partials per buffered row k:
//                   [d_k . g, |d_k|^2, |g|^2, 0] with d_k = w_k - g formed in
//                   registers and never stored (from_params = 1), or d_k = w_k
//                   for an explicit delta buffer (from_params = 0).
//                   Replaces src/repro/kernels/seafl_agg/kernel.py
//                   _sim_from_params_kernel (from_params = 1) and _sim_kernel
//                   (from_params = 0).
//   weighted_agg  — Eq. (7) + (8): out = keep * g + theta * (p^T W), with
//                   keep = 1 - theta on one device.  Replaces
//                   src/repro/kernels/seafl_agg/kernel.py _agg_kernel.  On a
//                   buffer whose rows shard over 'pod', each pod mixes its
//                   own rows and the partial outputs are summed across pods:
//                   the keep term then enters on the first pod only, and
//                   keep = 0 elsewhere, where g is not read.
//
// Both are bound by HBM bandwidth: each buffer element is read once and takes
// 2-5 flops, far below the card's ~20 flops per byte (f32, no tensor cores).
// So the design reads every input byte exactly once, with coalesced loads
// (consecutive threads on consecutive elements of a row), and keeps all
// accumulation in f32 registers.  Rows may be f32 or bf16; g may be f32 or
// bf16.  P need not be a multiple of anything: the grid-stride loops mask the
// ragged tail, so no padded copy of the buffer is ever made.
//
// The TPU kernels accumulate across a sequential grid into one output block.
// Blocks on the GPU run in no order, so sim_partials reduces in two stages:
// stage 1 writes one (K, 3) partial per block to a workspace, stage 2 sums
// the workspace in a fixed order.  There are no float atomics, so repeated
// runs on one card are bit-identical.  weighted_agg needs no cross-block
// reduction: each output element is summed over k in the fixed order 0..K-1,
// with the K weights staged in shared memory.
//
// Every entry returns cudaGetLastError() after its launches; the Python
// wrapper raises if it is not cudaSuccess.  Nothing here allocates or
// synchronises: the wrapper passes outputs, workspace and PyTorch's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // buffer rows one stage-1 block reduces (grid.y)

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
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Stage 1, for a block of exactly R rows starting at row k0: sums over the
// elements i = bx*kThreads + t + j*gridDim.x*kThreads, reduced over the
// block in a fixed order, written to ws[bx, k0 + r, 0..2] =
// (d . g, |d|^2, |g|^2).  R is a compile-time constant so the R row loads
// of an element are unconditional and all in flight before the first FMA.
template <int R, typename TW, typename TG, bool kFromParams>
__device__ __forceinline__ void stage1_rows(
    const TW* __restrict__ w, const TG* __restrict__ g, int K, int64_t P,
    int k0, float (*red)[2 * kRows + 1], float* __restrict__ ws) {
  float dot[R], dsq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dot[r] = 0.f;
    dsq[r] = 0.f;
  }
  float gsq = 0.f;
  const TW* wb = w + static_cast<int64_t>(k0) * P;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < P; i += stride) {
    float wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wv[r] = to_f32(wb[static_cast<int64_t>(r) * P + i]);
    }
    const float gi = to_f32(g[i]);
    gsq += gi * gi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = kFromParams ? wv[r] - gi : wv[r];
      dot[r] += d * gi;
      dsq[r] += d * d;
    }
  }

  // block reduction in a fixed order: warp shuffles, then warps in order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float a = warp_sum(dot[r]);
    const float b = warp_sum(dsq[r]);
    if (lane == 0) {
      red[warp][2 * r] = a;
      red[warp][2 * r + 1] = b;
    }
  }
  const float c = warp_sum(gsq);
  if (lane == 0) red[warp][2 * R] = c;
  __syncthreads();
  const int j = threadIdx.x;
  if (j < 2 * R + 1) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][j];
    float* out = ws + (static_cast<int64_t>(blockIdx.x) * K + k0) * 3;
    if (j == 2 * R) {
      for (int r = 0; r < R; ++r) out[r * 3 + 2] = s;
    } else {
      out[(j >> 1) * 3 + (j & 1)] = s;
    }
  }
}

// Picks R = nrows (1..kRows) once per block; every thread of a block takes
// the same branch.
template <int R, typename TW, typename TG, bool kFromParams>
__device__ __forceinline__ void stage1_dispatch(
    int nrows, const TW* __restrict__ w, const TG* __restrict__ g, int K,
    int64_t P, int k0, float (*red)[2 * kRows + 1], float* __restrict__ ws) {
  if constexpr (R == 1) {
    stage1_rows<1, TW, TG, kFromParams>(w, g, K, P, k0, red, ws);
  } else {
    if (nrows == R) {
      stage1_rows<R, TW, TG, kFromParams>(w, g, K, P, k0, red, ws);
    } else {
      stage1_dispatch<R - 1, TW, TG, kFromParams>(nrows, w, g, K, P, k0, red,
                                                  ws);
    }
  }
}

// Stage 1.  Block (bx, by) covers rows [by*kRows, min(K, by*kRows + kRows)).
template <typename TW, typename TG, bool kFromParams>
__global__ void __launch_bounds__(kThreads)
    sim_partials_stage1(const TW* __restrict__ w, const TG* __restrict__ g,
                        int K, int64_t P, float* __restrict__ ws) {
  __shared__ float red[kWarps][2 * kRows + 1];
  const int k0 = blockIdx.y * kRows;
  stage1_dispatch<kRows, TW, TG, kFromParams>(min(kRows, K - k0), w, g, K, P,
                                              k0, red, ws);
}

// Stage 2.  Block k sums ws[:, k, 0..2] over the stage-1 blocks in a fixed
// order and writes out[k] = [dot, dsq, gsq, 0].
__global__ void __launch_bounds__(kThreads)
    sim_partials_stage2(const float* __restrict__ ws, int nblocks, int K,
                        float* __restrict__ out) {
  const int k = blockIdx.x;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
    const float* src = ws + (static_cast<int64_t>(b) * K + k) * 3;
    acc0 += src[0];
    acc1 += src[1];
    acc2 += src[2];
  }
  __shared__ float red[kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  acc2 = warp_sum(acc2);
  if (lane == 0) {
    red[warp][0] = acc0;
    red[warp][1] = acc1;
    red[warp][2] = acc2;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][threadIdx.x];
    out[static_cast<int64_t>(k) * 4 + threadIdx.x] = s;
  } else if (threadIdx.x == 3) {
    out[static_cast<int64_t>(k) * 4 + 3] = 0.f;
  }
}

// out[i] = keep * g[i] + theta * sum_k p[k] * w[k, i], k in order; g is
// read only where keep != 0.  K may be 0 (a pod that holds no committed row).
template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    weighted_agg(const float* __restrict__ p, const TW* __restrict__ w,
                 const TG* __restrict__ g, int K, int64_t P, float theta,
                 float keep, TG* __restrict__ out) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < K; k += kThreads) sp[k] = p[k];
  __syncthreads();
  const bool read_g = keep != 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < P; i += stride) {
    float acc = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float a0 = to_f32(w[static_cast<int64_t>(k) * P + i]);
      const float a1 = to_f32(w[static_cast<int64_t>(k + 1) * P + i]);
      const float a2 = to_f32(w[static_cast<int64_t>(k + 2) * P + i]);
      const float a3 = to_f32(w[static_cast<int64_t>(k + 3) * P + i]);
      acc += sp[k] * a0;
      acc += sp[k + 1] * a1;
      acc += sp[k + 2] * a2;
      acc += sp[k + 3] * a3;
    }
    for (; k < K; ++k) acc += sp[k] * to_f32(w[static_cast<int64_t>(k) * P + i]);
    out[i] = from_f32<TG>(read_g ? keep * to_f32(g[i]) + theta * acc
                                 : theta * acc);
  }
}

template <typename TW, typename TG>
cudaError_t launch_sim(const void* w, const void* g, int K, int64_t P,
                       bool from_params, float* ws, int nblocks,
                       cudaStream_t s) {
  const dim3 grid(nblocks, (K + kRows - 1) / kRows);
  if (from_params) {
    sim_partials_stage1<TW, TG, true><<<grid, kThreads, 0, s>>>(
        static_cast<const TW*>(w), static_cast<const TG*>(g), K, P, ws);
  } else {
    sim_partials_stage1<TW, TG, false><<<grid, kThreads, 0, s>>>(
        static_cast<const TW*>(w), static_cast<const TG*>(g), K, P, ws);
  }
  return cudaGetLastError();
}

template <typename TW, typename TG>
cudaError_t launch_agg(const float* p, const void* w, const void* g, int K,
                       int64_t P, float theta, float keep, void* out,
                       int nblocks, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        weighted_agg<TW, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  weighted_agg<TW, TG><<<nblocks, kThreads, smem, s>>>(
      p, static_cast<const TW*>(w), static_cast<const TG*>(g), K, P, theta,
      keep, static_cast<TG*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w: (K, P) row-major, dtype w_dtype; g: (P,), dtype g_dtype;
// ws: (nblocks, K, 3) f32 workspace; out: (K, 4) f32.
int seafl_sim_partials(const void* w, int w_dtype, const void* g, int g_dtype,
                       int K, long long P, int from_params, void* ws,
                       int nblocks, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const bool fp = from_params != 0;
  cudaError_t e;
  if (w_dtype == kF32 && g_dtype == kF32) {
    e = launch_sim<float, float>(w, g, K, P, fp, wsf, nblocks, s);
  } else if (w_dtype == kBF16 && g_dtype == kF32) {
    e = launch_sim<__nv_bfloat16, float>(w, g, K, P, fp, wsf, nblocks, s);
  } else if (w_dtype == kF32 && g_dtype == kBF16) {
    e = launch_sim<float, __nv_bfloat16>(w, g, K, P, fp, wsf, nblocks, s);
  } else if (w_dtype == kBF16 && g_dtype == kBF16) {
    e = launch_sim<__nv_bfloat16, __nv_bfloat16>(w, g, K, P, fp, wsf, nblocks,
                                                 s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  sim_partials_stage2<<<K, kThreads, 0, s>>>(wsf, nblocks, K,
                                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// p: (K,) f32 weights; w: (K, P) row-major; g and out: (P,) in g_dtype;
// keep: the factor of g (1 - theta on one device, 0 where g is left out).
int seafl_weighted_agg(const void* p, const void* w, int w_dtype,
                       const void* g, int g_dtype, int K, long long P,
                       float theta, float keep, void* out, int nblocks,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  cudaError_t e;
  if (w_dtype == kF32 && g_dtype == kF32) {
    e = launch_agg<float, float>(pf, w, g, K, P, theta, keep, out,
                                     nblocks, s);
  } else if (w_dtype == kBF16 && g_dtype == kF32) {
    e = launch_agg<__nv_bfloat16, float>(pf, w, g, K, P, theta, keep, out,
                                         nblocks, s);
  } else if (w_dtype == kF32 && g_dtype == kBF16) {
    e = launch_agg<float, __nv_bfloat16>(pf, w, g, K, P, theta, keep, out,
                                         nblocks, s);
  } else if (w_dtype == kBF16 && g_dtype == kBF16) {
    e = launch_agg<__nv_bfloat16, __nv_bfloat16>(pf, w, g, K, P, theta, keep,
                                                 out, nblocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
