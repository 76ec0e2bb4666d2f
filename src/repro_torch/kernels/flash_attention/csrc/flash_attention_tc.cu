// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 in and
// out, head dims D in {64, 128, 256}; plain C interface.
//
//   o[b, q, h] = softmax_k(q[b, q, h] . k[b, k, h/G] / sqrt(D)) v[b, k, h/G]
//
// over the keys k with k <= q (causal, top-left aligned), k > q - window
// (sliding window), k < Skv; a row with no such key gives 0.  GQA: query
// head h reads kv head h / (H / KVH).  The same function as
// flash_attention_mma.cu (the mma.sync instance, which keeps every other
// dtype and D); replaces src/repro/kernels/flash_attention/kernel.py
// _flash_kernel for bf16 with these D.
//
// Bound: at the main path's shape (recurrentgemma-2b prefill, q (4, 4096,
// 10, 256), window 2048) the band needs 2.6e11 flop against 185 MB moved, so
// it is bound by the bf16 tensor-core rate.  Design:
//   * one block of two warpgroups (256 threads) per (q-tile of 128 rows,
//     head, batch), q-tiles launched last-first (grid z reversed), since
//     the tiles past the window see the most keys;
//   * thread 0 issues TMA loads (Q once; K and V tiles of 64 keys into a
//     two-stage ring, one tile ahead, each tile D / 64 boxes of 64 columns
//     with the 128-byte swizzle), completion on mbarriers.  No producer
//     warp: 8 warps are 2 on each of the SM's four register partitions, so
//     a thread may hold 255 registers, which D = 256 needs (O alone is
//     128).  A producer warpgroup with `setmaxnreg` (384 threads) or a
//     producer warp (288) left ptxas at 168 registers and spilled;
//   * warpgroups 0 and 1 own 64 query rows each: S = Q K^T by `wgmma`
//     m64n64k16 with both operands in shared memory (K-major), online
//     softmax in f32 with exp2 and log2(e) folded into the scale, the mask
//     only on tiles at the edge of the causal/window band, then O += P V by
//     `wgmma` with P from registers and V from shared memory (MN-major, the
//     transpose flag), D / 64 instructions of n = 64 per k-step;
//   * P goes to the tensor cores as two bf16 parts, P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), O += P_hi V + P_lo V, so its error is ~2^-18
//     of sum p|v| (one bf16 P, at 2^-9, would fail the one-bf16-step
//     tolerance where o is near 0); Q K^T is exact up to summation order;
//   * kv-tiles outside the band are never loaded; tiles inside the block's
//     band but outside one warpgroup's rows are skipped by it.
// The ragged edges of Sq and Skv are the TMA's zero fill, masked like the
// band.  The model's (B, S, H, D) layout is read through its strides (the
// wrapper checks that they suit TMA: 16-byte multiples, 16-byte aligned).
//
// The entry returns cudaGetLastError() after its launch (or the error of
// building the tensor maps); the Python wrapper raises if it is not 0.
// Nothing here allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kBQ = 128;       // query rows of a block
constexpr int kBK = 64;        // keys of a kv-tile
constexpr int kStages = 2;     // K/V ring
constexpr int kThreads = 256;  // two warpgroups of 64 query rows each
constexpr int kRowBytes = 128; // one swizzled panel row: 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {  // byte offsets in shared memory, 1024-aligned tiles
  static constexpr int kQBytes = kBQ * D * 2;   // D/64 panels of kBQ rows
  static constexpr int kKVBytes = kBK * D * 2;  // D/64 panels of kBK rows
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 64 + 1024;  // barriers, alignment
};

struct Strides {  // element strides of (batch, seq, head); dim D is contiguous
  long long b, s, h;
};

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes across wgmma
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define ACC32_OPS(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A B, A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A B, A (64 x 16 bf16) in registers, B in shared
// memory MN-major (transpose flag)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int H, int KVH, int Sq,
                int Skv, Strides os, int causal, int window,
                float scale_log2) {
  using L = Layout<D>;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::kK;
  uint8_t* Vs = smem + L::kV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;         // [kStages]
  uint64_t* v_full = bars + 3;         // [kStages]
  uint64_t* kv_empty = bars + 5;       // [kStages], one arrival per warp

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kBQ;
  const int kvh = h / (H / KVH);
  // keys any row of this block can see
  const int q_last = min(Sq, q0 + kBQ) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  if (causal) kv_hi = min(Skv, q_last + 1);
  const int t_lo = kv_lo / kBK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 also issues the TMA loads: Q and the first kStages tiles now,
  // each later tile one tile ahead (in the loop below)
  auto load_kv = [&](int j) {
    const int s = j % kStages, k0 = (t_lo + j) * kBK;
    uint8_t* kd = Ks + s * L::kKVBytes;
    uint8_t* vd = Vs + s * L::kKVBytes;
    mbar_expect_tx(k_full + s, L::kKVBytes);
    for (int p = 0; p < kPanels; ++p)
      tma_load(kd + p * kBK * kRowBytes, &tm_k, k_full + s, 64 * p, kvh, k0,
               b);
    mbar_expect_tx(v_full + s, L::kKVBytes);
    for (int p = 0; p < kPanels; ++p)
      tma_load(vd + p * kBK * kRowBytes, &tm_v, v_full + s, 64 * p, kvh, k0,
               b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, L::kQBytes);
    for (int p = 0; p < kPanels; ++p)
      tma_load(Qs + p * kBQ * kRowBytes, &tm_q, q_full, 64 * p, h, q0, b);
    for (int j = 0; j < min(kStages, n_tiles); ++j) load_kv(j);
  }
  __syncwarp();

  const int cw = threadIdx.x / 128;  // warpgroup: query rows 64 cw ..
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row_lo = q0 + 64 * cw, row_hi = row_lo + 63;
  const int r0 = row_lo + 16 * warp + lane / 4;  // and r0 + 8
  const int cq = 2 * (lane % 4);

  float acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t q_base0 = smem_u32(Qs) + cw * 64 * kRowBytes;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    // thread 0 loads tile i + 1 into the stage tile i - 1 held, once both
    // warpgroups have released it
    if (threadIdx.x == 0 && i >= 1 && i + 1 < n_tiles) {
      const int j = i + 1;
      mbar_wait(kv_empty + j % kStages, ((j / kStages) - 1) & 1);
      load_kv(j);
    }
    __syncwarp();
    const int s = i % kStages, par = (i / kStages) & 1;
    const int k0 = (t_lo + i) * kBK;
    // does the tile meet the band of this warpgroup's rows at all?
    const bool any = k0 < Skv && (!causal || k0 <= row_hi) &&
                     (window <= 0 || k0 + kBK - 1 > row_lo - window);
    mbar_wait(k_full + s, par);
    if (any) {
      // S = Q K^T.  q_base is made opaque each tile, so the compiler
      // builds Q's D / 16 descriptors where they are used instead of
      // keeping them live across the loop.
      uint32_t q_base;
      asm volatile("mov.b32 %0, %1;" : "=r"(q_base) : "r"(q_base0));
      float sc[32];
      const uint32_t k_base = smem_u32(Ks + s * L::kKVBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss(sc,
                 desc_sw128(q_base + (ks / 4) * kBQ * kRowBytes + off, 16,
                            1024),
                 desc_sw128(k_base + (ks / 4) * kBK * kRowBytes + off, 16,
                            1024),
                 ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // mask (edge tiles only), online softmax in log2 units
      const bool edge = (causal && k0 + kBK - 1 > row_lo) ||
                        (window > 0 && k0 <= row_hi - window) ||
                        k0 + kBK > Skv;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + cq + (e & 1);
            const int row = r0 + (e >> 1) * 8;
            const bool ok = key < Skv && (!causal || key <= row) &&
                            (window <= 0 || key > row - window);
            v = ok ? v : kNegInf;
          }
          sc[4 * j + e] = v;
          if (e < 2)
            mx0 = fmaxf(mx0, v);
          else
            mx1 = fmaxf(mx1, v);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t phi[16], plo[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4], r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sc[4 * j + e];
          const float mm = e < 2 ? m0 : m1;
          p[e] = (edge && v == kNegInf) ? 0.f : exp2f(v - mm);
          r[e] = p[e] - __bfloat162float(__float2bfloat16_rn(p[e]));
        }
        ps0 += p[0] + p[1];
        ps1 += p[2] + p[3];
        // accumulator (row, key) -> A fragment of k-step j / 2
        const int reg = 4 * (j / 2) + 2 * (j % 2);
        phi[reg] = pack_bf16(p[0], p[1]);
        phi[reg + 1] = pack_bf16(p[2], p[3]);
        plo[reg] = pack_bf16(r[0], r[1]);
        plo[reg + 1] = pack_bf16(r[2], r[3]);
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[p][4 * j] *= alpha0;
          acc[p][4 * j + 1] *= alpha0;
          acc[p][4 * j + 2] *= alpha1;
          acc[p][4 * j + 3] *= alpha1;
        }

      // O += P_hi V + P_lo V
      mbar_wait(v_full + s, par);
      const uint32_t v_base = smem_u32(Vs + s * L::kKVBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          const uint64_t db =
              desc_sw128(v_base + p * kBK * kRowBytes + kk * 16 * kRowBytes,
                         kBK * kRowBytes, 1024);
          wgmma_rs(acc[p], plo + 4 * kk, db);
          wgmma_rs(acc[p], phi + 4 * kk, db);
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
      fence_regs(phi);
      fence_regs(plo);
    } else {
      mbar_wait(v_full + s, par);  // the stage is released once filled
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty + s);
  }

  // epilogue: O / l in bf16, straight from the registers
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + cq;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os.s + col) =
            __floats2bfloat162_rn(acc[p][4 * j] * inv0,
                                  acc[p][4 * j + 1] * inv0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * os.s + col) =
            __floats2bfloat162_rn(acc[p][4 * j + 2] * inv1,
                                  acc[p][4 * j + 3] * inv1);
    }
}

// ------------------------------------------------------------------ host
// A (B, S, heads, D) bf16 tensor as a 4-D map with dims (D, heads, S, B),
// boxes of 64 columns x `rows` positions of one head, 128-byte swizzle,
// zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, Strides st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal, int window,
                   float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, D, qs, kBQ) ||
      !make_map(&tk, k, B, Skv, KVH, D, ks, kBK) ||
      !make_map(&tv, v, B, Skv, KVH, D, vs, kBK))
    return cudaErrorInvalidValue;
  const int smem = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_tc_kernel<D><<<grid, kThreads, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KVH, Sq, Skv, os, causal,
      window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, D); k, v: (B, Skv, KVH, D); all bf16.  *_st: element
// strides of (batch, seq, head), D contiguous, each a multiple of 8
// elements (16 bytes) and every pointer 16-byte aligned (the wrapper
// checks).  window <= 0: no window.  D in {64, 128, 256}, H % KVH == 0.
int flash_attention_fwd_tc(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KVH, int Sq, int Skv,
                           int D, const long long* q_st,
                           const long long* k_st, const long long* v_st,
                           const long long* o_st, int causal, int window,
                           float scale, void* stream) {
  if (KVH < 1 || H % KVH != 0 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_st[0], q_st[1], q_st[2]};
  const Strides ks{k_st[0], k_st[1], k_st[2]};
  const Strides vs{v_st[0], v_st[1], v_st[2]};
  const Strides os{o_st[0], o_st[1], o_st[2]};
  cudaError_t e;
  switch (D) {
    case 64:
      e = launch<64>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os, causal,
                     window, scale, s);
      break;
    case 128:
      e = launch<128>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os, causal,
                      window, scale, s);
      break;
    case 256:
      e = launch<256>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os, causal,
                      window, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
