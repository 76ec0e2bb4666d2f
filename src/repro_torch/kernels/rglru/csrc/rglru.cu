// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
//   h_t = exp(log_a_t) * h_{t-1} + b_t   per (batch, channel), from h0,
//
// returning every h_t (B, S, C) in f32 and the last state h_last (B, C).
// Replaces src/repro/kernels/rglru/kernel.py _rglru_kernel (the JAX model
// path is models/blocks.py rg_lru_scan).  The kernel takes log(a), as
// RecurrentGemma's gates produce it, and exponentiates in registers, so the
// decays never exist in device memory.
//
// Bound: bytes.  Each step of a channel reads log_a_t and b_t once and
// writes h_t once, with an exp and an FMA between them, far below the
// card's flops per byte.  Design: one thread per (batch,
// channel) keeps the carry in a register and walks S in order, so the
// recurrence is sequential and exact in f32 (no associative re-bracketing).
// Consecutive threads own consecutive channels, so every load and store of
// a time step is coalesced.  The dependent FMA chain is short (4 cycles a
// step); to keep HBM busy each thread issues the loads of kUnroll steps
// before it consumes them.  Blocks are small (64 threads) so the B*C
// channels of the main path (4 * 2560) spread over all 132 SMs.
//
// The TPU kernel tiles time into blocks walked by the sequential grid with
// the carry in VMEM scratch; here the whole of S is one loop in one thread.
// Ragged S and C need no padding: the loop ends at S, threads past C exit.
//
// Every entry returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not cudaSuccess.  Nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

enum Dtype : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long row = static_cast<long long>(blockIdx.y);
  const long long base = row * S * C + c;
  float carry = h0 != nullptr ? h0[row * C + c] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(t + u) * C;
      av[u] = to_f32(log_a[i]);
      bv[u] = to_f32(b[i]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = expf(av[u]) * carry + bv[u];
      h[base + static_cast<long long>(t + u) * C] = carry;
    }
  }
  for (; t < S; ++t) {
    const long long i = base + static_cast<long long>(t) * C;
    carry = expf(to_f32(log_a[i])) * carry + to_f32(b[i]);
    h[i] = carry;
  }
  h_last[row * C + c] = carry;
}

template <typename T>
cudaError_t launch(const void* log_a, const void* b, const float* h0,
                   float* h, float* h_last, int B, int S, int C,
                   cudaStream_t s) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(b), h0, h, h_last,
      S, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// log_a, b: (B, S, C) contiguous, dtype (0 f32, 1 bf16); h0: (B, C) f32 or
// null (zeros); h: (B, S, C) f32; h_last: (B, C) f32.
int rglru_scan(const void* log_a, const void* b, int dtype, const void* h0,
               void* h, void* h_last, int B, int S, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  float* hl = static_cast<float*>(h_last);
  cudaError_t e;
  if (dtype == kF32) {
    e = launch<float>(log_a, b, h0f, hf, hl, B, S, C, s);
  } else if (dtype == kBF16) {
    e = launch<__nv_bfloat16>(log_a, b, h0f, hf, hl, B, S, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
