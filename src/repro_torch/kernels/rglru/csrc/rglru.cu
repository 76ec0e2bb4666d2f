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
// card's flops per byte.  The arithmetic is one thread per (batch, channel)
// chain, the carry in a register, S walked in order: sequential, exact in
// f32 and the same from run to run.  What the design is about is keeping
// enough bytes in flight to fill HBM with only B * C threads (10,240 at the
// main path's shape, 4 x 2560):
//   * a block is one warp of 32 channels, so the chains spread over the
//     SMs in small pieces (320 blocks at the main path's shape, up to three
//     an SM);
//   * log_a and b reach the warp through a ring of kStages tiles of kSteps
//     time steps x 32 channels in shared memory, filled by asynchronous
//     copies: while a tile is consumed the next ones are in flight (48 KB a
//     block in f32), and the thread spends no registers on them.  The ring
//     (64 KB in f32) leaves room for three blocks an SM, so all 320 blocks
//     of the main path are resident at once; a larger ring sends some to a
//     second wave (chip_smoke.py --probe times other ring shapes);
//   * the tiles come by TMA (one 2-D box per tile and input, issued by lane
//     0, completion on an mbarrier) where TMA can read the rows: C * elem a
//     multiple of 16 bytes and 16-byte aligned bases.  Otherwise
//     (route kCpAsync) every lane copies its own column with 4-byte
//     cp.async; a bf16 element is fetched as the aligned 4-byte word that
//     holds it.  The wrapper chooses the route on the host
//     (kernel.py:route) before the launch; neither falls back to the other;
//   * each lane reads its column from shared memory (32 lanes, 32 banks)
//     and writes h_t straight to device memory, 128 coalesced bytes a warp
//     a step.
// The TPU kernel tiles time into blocks walked by the sequential grid with
// the carry in VMEM scratch; here the whole of S is one loop in one thread.
// Ragged S and C need no padding: TMA fills out-of-range rows and columns
// with zeros, the cp.async route copies nothing there, and lanes past C
// store nothing.
//
// Every entry returns cudaGetLastError() after its launch (or the error of
// building the tensor maps); the Python wrapper raises if it is not
// cudaSuccess.  Nothing here allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kChans = 32;   // channels of a block: one warp, a chain a lane
constexpr int kSteps = 64;   // time steps of a tile
constexpr int kStages = 4;   // tiles in the ring

enum Dtype : int { kF32 = 0, kBF16 = 1 };
enum Route : int { kTma = 0, kCpAsync = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// shared memory of a block: the ring, [stage][log_a, b][kSteps][kChans]
// slots of E, 128-byte aligned, then (TMA route) one mbarrier a stage
template <typename E>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * 2 * kSteps * kChans * static_cast<int>(sizeof(E));
}
template <typename E>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<E>() + kStages * 8 + 128;
}

__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
}

// One tile of the scan: `steps` steps of this lane's chain from its column
// of the stage (stride kChans), h_t to hp[u * C].
template <typename Load>
__device__ __forceinline__ void scan_tile(float& carry, Load load, int steps,
                                          float* __restrict__ hp, int C) {
  if (steps == kSteps) {
#pragma unroll 16
    for (int u = 0; u < kSteps; ++u) {
      float a, bv;
      load(u, a, bv);
      carry = expf(a) * carry + bv;
      hp[static_cast<long long>(u) * C] = carry;
    }
  } else {
    for (int u = 0; u < steps; ++u) {
      float a, bv;
      load(u, a, bv);
      carry = expf(a) * carry + bv;
      hp[static_cast<long long>(u) * C] = carry;
    }
  }
}

// Route kTma: log_a and b as 3-D tensor maps (C, S, B), boxes of kChans x
// kSteps x 1; lane 0 refills a stage once the warp has consumed it.
template <typename T>
__global__ void __launch_bounds__(kChans)
rglru_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ h_last, int S, int C) {
  constexpr int kTile = kSteps * kChans;  // elements of one tile
  uint8_t* smem = aligned_smem();
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes<T>());
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kChans, c = c0 + lane;
  const int row = blockIdx.y;
  const int n_tiles = (S + kSteps - 1) / kSteps;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto load = [&](int j) {
    const int s = j % kStages;
    T* dst = ring + 2 * s * kTile;
    mbar_expect_tx(full + s, 2 * kTile * static_cast<int>(sizeof(T)));
    tma_load(dst, &tm_a, full + s, c0, j * kSteps, row);
    tma_load(dst + kTile, &tm_b, full + s, c0, j * kSteps, row);
  };
  if (lane == 0)
    for (int j = 0; j < min(kStages, n_tiles); ++j) load(j);
  __syncwarp();

  float carry = (h0 != nullptr && c < C) ? h0[static_cast<long long>(row) * C
                                              + c]
                                         : 0.f;
  float* hp = h + static_cast<long long>(row) * S * C + c;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(full + s, (i / kStages) & 1);
    const T* ta = ring + 2 * s * kTile + lane;
    const T* tb = ta + kTile;
    if (c < C)
      scan_tile(
          carry,
          [&](int u, float& a, float& bv) {
            a = to_f32(ta[u * kChans]);
            bv = to_f32(tb[u * kChans]);
          },
          min(kSteps, S - i * kSteps), hp, C);
    hp += static_cast<long long>(kSteps) * C;
    __syncwarp();  // every lane is done with stage s
    if (lane == 0 && i + kStages < n_tiles) load(i + kStages);
  }
  if (c < C) h_last[static_cast<long long>(row) * C + c] = carry;
}

// Route kCpAsync: every lane copies its own column of each tile, 4 bytes
// an element: an f32 as it is, a bf16 as the 4-byte aligned word that
// holds it (`odd`: the element is its upper half).  Only the two words at
// the very ends of a bf16 tensor can reach past it: the last is read in
// part (2 bytes, zeros above), the first (an odd base) with a plain load.
template <typename T>
__device__ __forceinline__ void copy_elem(uint32_t* dst, const T* src,
                                          long long i, long long n, bool in) {
  if constexpr (sizeof(T) == 4) {
    cp_async<4>(dst, in ? src + i : src, in ? 4 : 0);
  } else {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(src + i);
    const uintptr_t word = addr & ~uintptr_t(3);
    const bool odd = (addr & 2) != 0;
    if (in && odd && i == 0) {
      *dst = static_cast<uint32_t>(
                 *reinterpret_cast<const unsigned short*>(src)) << 16;
    } else {
      const uintptr_t base = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(3);
      cp_async<4>(dst, reinterpret_cast<const void*>(in ? word : base),
                  !in ? 0 : (!odd && i == n - 1) ? 2 : 4);
    }
  }
}

template <typename T>
__device__ __forceinline__ float from_word(uint32_t w, bool odd) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    return __uint_as_float((odd ? w >> 16 : w & 0xFFFFu) << 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(kChans)
rglru_cp_async_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ h_last, int B, int S, int C) {
  constexpr int kTile = kSteps * kChans;
  uint32_t* ring = reinterpret_cast<uint32_t*>(aligned_smem());
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kChans + lane;
  const int row = blockIdx.y;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const long long n = static_cast<long long>(B) * S * C;
  const long long base = static_cast<long long>(row) * S * C + c;

  auto load = [&](int j) {  // one commit group a tile, empty past the end
    if (j < n_tiles) {
      uint32_t* da = ring + 2 * (j % kStages) * kTile + lane;
      for (int u = 0; u < kSteps; ++u) {
        const int t = j * kSteps + u;
        const bool in = c < C && t < S;
        const long long i = base + static_cast<long long>(t) * C;
        copy_elem(da + u * kChans, log_a, i, n, in);
        copy_elem(da + kTile + u * kChans, b, i, n, in);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) load(j);

  float carry = (h0 != nullptr && c < C) ? h0[static_cast<long long>(row) * C
                                              + c]
                                         : 0.f;
  float* hp = h + base;
  // parity of the bf16 element (row, t, c) in its word, for t = i kSteps
  const uintptr_t half_a = reinterpret_cast<uintptr_t>(log_a) >> 1;
  const uintptr_t half_b = reinterpret_cast<uintptr_t>(b) >> 1;
  for (int i = 0; i < n_tiles; ++i) {
    load(i + kStages - 1);  // into the stage consumed last iteration
    cp_async_wait_group<kStages - 1>();  // this lane's copies of tile i
    const uint32_t* wa = ring + 2 * (i % kStages) * kTile + lane;
    const uint32_t* wb = wa + kTile;
    const long long i0 = base + static_cast<long long>(i) * kSteps * C;
    if (c < C)
      scan_tile(
          carry,
          [&](int u, float& a, float& bv) {
            const long long e = i0 + static_cast<long long>(u) * C;
            a = from_word<T>(wa[u * kChans], ((half_a + e) & 1) != 0);
            bv = from_word<T>(wb[u * kChans], ((half_b + e) & 1) != 0);
          },
          min(kSteps, S - i * kSteps), hp, C);
    hp += static_cast<long long>(kSteps) * C;
  }
  cp_async_wait();
  if (c < C) h_last[static_cast<long long>(row) * C + c] = carry;
}

// A (B, S, C) tensor as a 3-D map with dims (C, S, B), boxes of kChans
// channels x kSteps steps, no swizzle, zeros out of bounds.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int C) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(C) * sizeof(T),
      static_cast<cuuint64_t>(S) * C * sizeof(T)};
  const cuuint32_t box[3] = {kChans, kSteps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 4
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* log_a, const void* b, const float* h0,
                   float* h, float* h_last, int B, int S, int C, int route,
                   cudaStream_t s) {
  const dim3 grid((C + kChans - 1) / kChans, B);
  cudaError_t e;
  if (route == kTma) {
    CUtensorMap ta, tb;
    if (!make_map<T>(&ta, log_a, B, S, C) || !make_map<T>(&tb, b, B, S, C))
      return cudaErrorInvalidValue;
    const int smem = smem_bytes<T>();
    e = cudaFuncSetAttribute(rglru_tma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    rglru_tma_kernel<T><<<grid, kChans, smem, s>>>(ta, tb, h0, h, h_last, S,
                                                   C);
  } else {
    const int smem = smem_bytes<uint32_t>();
    e = cudaFuncSetAttribute(rglru_cp_async_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    rglru_cp_async_kernel<T><<<grid, kChans, smem, s>>>(
        static_cast<const T*>(log_a), static_cast<const T*>(b), h0, h, h_last,
        B, S, C);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// log_a, b: (B, S, C) contiguous, dtype (0 f32, 1 bf16); h0: (B, C) f32 or
// null (zeros); h: (B, S, C) f32; h_last: (B, C) f32.  route: 0 TMA (S >= 1,
// C * elem a multiple of 16 bytes, log_a and b 16-byte aligned; the wrapper
// checks), 1 cp.async (any shape).
int rglru_scan(const void* log_a, const void* b, int dtype, const void* h0,
               void* h, void* h_last, int B, int S, int C, int route,
               void* stream) {
  if (B < 0 || C < 0 || S < 0 || (route != kTma && route != kCpAsync))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || C == 0) return static_cast<int>(cudaSuccess);  // no chains
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  float* hl = static_cast<float*>(h_last);
  cudaError_t e;
  if (dtype == kF32) {
    e = launch<float>(log_a, b, h0f, hf, hl, B, S, C, route, s);
  } else if (dtype == kBF16) {
    e = launch<__nv_bfloat16>(log_a, b, h0f, hf, hl, B, S, C, route, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
