// Flash-attention forward on Hopper's tensor cores with mma.sync (sm_90a),
// f32 accurate; plain C interface.
//
//   o[b, q, h] = softmax_k(q[b, q, h] . k[b, k, h/G] / sqrt(D)) v[b, k, h/G]
//
// over the keys k with k <= q (causal, top-left aligned), k > q - window
// (sliding window), k < Skv; a row with no such key gives 0.  GQA: query
// head h reads kv head h / (H / KVH), and K/V are never repeated.  Inputs
// f32 or bf16, o in q's dtype, any head dim 4 <= D <= 256 of q and k and
// any 4 <= Dv <= D of v (MLA's smoke configs: D = 24, Dv = 16), each a
// multiple of 4.  The instance for everything flash_attention_tc.cu does
// not take (that one: bf16 with (D, Dv) in {(64, 64), (128, 128),
// (256, 256), (192, 128)}); replaces
// src/repro/kernels/flash_attention/kernel.py _flash_kernel for those.
//
// Layout: q is (B, Sq, H, D), k (B, Skv, KVH, D), v (B, Skv, KVH, Dv) and o
// (B, Sq, H, Dv), the model's own layout, read through element strides (the
// last dim contiguous), so there is no transpose and no pad copy: the
// ragged edges of Sq and Skv are masked in the kernel, and D and Dv are
// padded with zeros in shared memory to 8 kNT (32, 64, 128 or 256, from D;
// kNT, the mma's 8-column tiles, is a template argument, so every loop over
// D is unrolled with no guard).  V's columns from Dv on are zeroed once and
// never loaded, so O stays 0 there, and o gets only Dv columns.
//
// Bound: at the f32 slice shape (recurrentgemma-2b prefill in f32, q (4,
// 4096, 10, 256), window 2048) the band needs 2.6e11 flop against 369 MB
// moved, so it is bound by operations, at the rate of f32-accurate products
// on the TF32 tensor cores (3xTF32, 495 / 3 TFLOP/s by the data sheet).
// mma.sync issues TF32 at about two thirds of that rate, and every warp
// reads the K and V tiles and its Q rows from shared memory each tile, so
// those two, not the data sheet, are this design's floor.  Design:
//   * one block of 8 warps per (q-tile of 128 rows, head, batch), q-tiles
//     launched last-first (the tiles past the window see the most keys);
//     each warp owns 16 query rows.  Two warps on each of the SM's four
//     schedulers hide each other's latencies; 4 warps (64 rows) a block are
//     slower (chip_smoke.py --probe times both);
//   * kv-tiles of 32 keys wholly outside the block's causal/window band are
//     never loaded, and a warp skips the tiles outside its own rows' band;
//   * Q is loaded once; K and V have one buffer each, filled by cp.async
//     (16-, 8- or 4-byte copies, the widest the strides allow; zeros past
//     Skv and Sq) as separate groups: K of tile i + 1 loads while tile i's
//     softmax and P V run, V of tile i + 1 while its Q K^T runs.  At D =
//     256 in f32 that is 195 KB of shared memory, one block an SM.  Row
//     pitches make each fragment load hit 32 banks;
//   * S = Q K^T and O += P V by mma.sync m16n8k8 in 3xTF32
//     (../../csrc/tf32_mma.cuh): a_lo b_hi + a_hi b_lo + a_hi b_hi, the
//     small terms first, split by truncation (two instructions, no
//     conversion).  A bf16 input is exact in TF32, so bf16 Q K^T is one
//     product and bf16 P V two (P_lo V + P_hi V);
//   * the online softmax (m, l) and O stay in f32 registers (O is 128
//     registers a thread at D = 256); exp2 with log2(e) folded into the
//     scale; the mask only on tiles at the edge of the band;
//   * P goes from the S accumulator to A fragments with no shuffle: the
//     accumulator holds keys 2t and 2t+1 of each 8, and the k-slots t and
//     t + 4 of P V's fragment are given exactly those keys (the sum over
//     keys does not care about their order), so V's B fragment reads rows
//     2t and 2t + 1.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises if it is not cudaSuccess.  Nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;            // a warp owns 16 query rows
constexpr int kBQ = 16 * kWarps;     // query rows of a block
constexpr int kBK = 32;              // keys of a kv-tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum Dtype : int { kF32 = 0, kBF16 = 1 };

struct Strides {  // element strides of (batch, seq, head); dim D is contiguous
  long long b, s, h;
};

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

// Row pitch in elements of a [row][8 kNT] tile: 16-byte rows whose 32-bit
// words run 4 mod 8 apart, so a fragment load (8 rows x 4 columns, or 4
// rows two apart x 8 columns) hits 32 distinct banks.
template <typename T, int kNT>
__host__ __device__ constexpr int pitch() {
  return sizeof(T) == 4 ? 8 * kNT + 4 : (8 * kNT + 15) / 16 * 16 + 8;
}

// shared memory: Q (kBQ rows), then one K tile and one V tile
template <typename T, int kNT>
__host__ __device__ constexpr int smem_bytes() {
  return static_cast<int>(sizeof(T)) * (kBQ + 2 * kBK) *
         pitch<T, kNT>();
}

// Starts copying rows [0, n_rows) x cols [0, D) of a strided matrix into
// shared memory (pitch p), zeros for rows >= valid: cp.async of `bytes`
// (16, 8 or 4) a copy, or (bf16 with 2-byte alignment only) plain loads.
// Whole kW-wide rows in 16-byte copies (the main path) take a loop whose
// divisions are by constants: a division by a runtime count for every copy
// shows in the kernel's time (chip_smoke.py --probe times both).
template <int kW, typename T>
__device__ __forceinline__ void load_rows(T* __restrict__ dst, int p,
                                          const T* __restrict__ src,
                                          long long rs, int n_rows, int valid,
                                          int D, int bytes) {
  if (bytes == 16 && D == kW) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = kW / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < n_rows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      const bool in = r < valid;
      cp_async<16>(dst + r * p + c, in ? src + r * rs + c : src, in ? 16 : 0);
    }
    return;
  }
  const int vec = bytes / static_cast<int>(sizeof(T));
  const int per_row = D / vec;
  for (int i = threadIdx.x; i < n_rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    const bool in = r < valid;
    const T* s = in ? src + r * rs + c : src;
    T* d = dst + r * p + c;
    switch (bytes) {
      case 16: cp_async<16>(d, s, in ? 16 : 0); break;
      case 8: cp_async<8>(d, s, in ? 8 : 0); break;
      case 4: cp_async<4>(d, s, in ? 4 : 0); break;
      default: *d = in ? *s : from_f32<T>(0.f); break;
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x as TF32 hi (+ lo): 3xTF32 parts of an f32; a bf16 is exact in TF32
template <typename T>
__device__ __forceinline__ void split(T x, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(T) == 4) {
    split_tf32_trunc(x, hi, lo);
  } else {
    hi = __float_as_uint(to_f32(x));
    lo = 0u;
  }
}

// kNT: 8-column tiles of the padded head dim, 8 kNT >= D (4, 8, 16 or 32)
template <typename T, int kNT>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KVH,
                 int Sq, int Skv, int D, int Dv, Strides qs, Strides ks,
                 Strides vs,
                 Strides os, int causal, int window, float scale_log2,
                 int copy_bytes) {
  constexpr bool kF32In = sizeof(T) == 4;
  constexpr int kW = 8 * kNT;  // D padded with zeros
  constexpr int p = pitch<T, kNT>();
  extern __shared__ uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // kBQ x p
  T* Ks = Qs + kBQ * p;                    // kBK x p
  T* Vs = Ks + kBK * p;                    // kBK x p

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kBQ;
  const int kvh = h / (H / KVH);
  const T* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // keys any row of this block can see
  const int q_last = min(Sq, q0 + kBQ) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  if (causal) kv_hi = min(Skv, q_last + 1);
  const int t_lo = kv_lo / kBK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK - t_lo : 0;

  // the pad columns of every tile are zeros for good: [D, kW) of the Q
  // and K rows (one run of rows), [Dv, kW) of the V rows
  if (kW > D)
    for (int i = threadIdx.x; i < (kBQ + kBK) * (kW - D); i += kThreads)
      Qs[(i / (kW - D)) * p + D + i % (kW - D)] = from_f32<T>(0.f);
  if (kW > Dv)
    for (int i = threadIdx.x; i < kBK * (kW - Dv); i += kThreads)
      Vs[(i / (kW - Dv)) * p + Dv + i % (kW - Dv)] = from_f32<T>(0.f);
  // K and V tiles are separate cp.async groups, one each (empty past the
  // last tile), issued in the order K0 (with Q), V0, K1, V1, ...
  auto load_k = [&](int j) {
    if (j < n_tiles) {
      const int k0 = (t_lo + j) * kBK;
      load_rows<kW>(Ks, p, kb + k0 * ks.s, ks.s, kBK, Skv - k0, D,
                    copy_bytes);
    }
    cp_async_commit();
  };
  auto load_v = [&](int j) {
    if (j < n_tiles) {
      const int k0 = (t_lo + j) * kBK;
      load_rows<kW>(Vs, p, vb + k0 * vs.s, vs.s, kBK, Skv - k0, Dv,
                    copy_bytes);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_rows<kW>(Qs, p, qb, qs.s, kBQ, Sq - q0, D, copy_bytes);
  load_k(0);
  load_v(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 16 * warp, row_hi = row_lo + 15;
  const int r0 = row_lo + g;  // and r0 + 8
  const T* qw = Qs + 16 * warp * p;

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_lo + i) * kBK;
    // does the tile meet the band of this warp's rows at all?
    const bool any = row_lo < Sq && (!causal || k0 <= row_hi) &&
                     (window <= 0 || k0 + kBK - 1 > row_lo - window);
    cp_async_wait_group<1>();  // K tile i (and Q), this thread
    __syncthreads();           // ... and every thread
    // S = Q K^T, 16 x kBK: sc[j] holds keys 8j + 2t, 8j + 2t + 1 of rows
    // g (e = 0, 1) and g + 8 (e = 2, 3)
    float sc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if (any) {
#pragma unroll
      for (int ks8 = 0; ks8 < kNT; ++ks8) {
        const int d = 8 * ks8 + t;
        uint32_t ah[4], al[4];
        split(qw[g * p + d], ah[0], al[0]);
        split(qw[(g + 8) * p + d], ah[1], al[1]);
        split(qw[g * p + d + 4], ah[2], al[2]);
        split(qw[(g + 8) * p + d + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const T* kr = Ks + (8 * j + g) * p + d;
          uint32_t bh0, bl0, bh1, bl1;
          split(kr[0], bh0, bl0);
          split(kr[4], bh1, bl1);
          if constexpr (kF32In) {
            mma_tf32(sc[j], al, bh0, bh1);  // small terms first
            mma_tf32(sc[j], ah, bl0, bl1);
          }
          mma_tf32(sc[j], ah, bh0, bh1);
        }
      }
    }
    __syncthreads();  // K tile i is consumed
    load_k(i + 1);

    if (any) {
      // mask (edge tiles only), online softmax in log2 units
      const bool edge = (causal && k0 + kBK - 1 > row_lo) ||
                        (window > 0 && k0 <= row_hi - window) ||
                        k0 + kBK > Skv;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + (e >> 1) * 8;
            const bool ok = key < Skv && (!causal || key <= row) &&
                            (window <= 0 || key > row - window);
            s = ok ? s : kNegInf;
          }
          sc[j][e] = s;
          if (e < 2)
            mx0 = fmaxf(mx0, s);
          else
            mx1 = fmaxf(mx1, s);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[j][e];
          const float p_ = (edge && s == kNegInf)
                               ? 0.f
                               : exp2f(s - (e < 2 ? m0 : m1));
          sc[j][e] = p_;
          if (e < 2)
            ps0 += p_;
          else
            ps1 += p_;
        }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
    }

    cp_async_wait_group<1>();  // V tile i, this thread
    __syncthreads();           // ... and every thread
    if (any) {
      // O += P V.  k-step j takes the keys of sc[j]: slot t is key
      // 8j + 2t, slot t + 4 key 8j + 2t + 1.
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32_trunc(sc[j][0], ph[0], pl[0]);  // (g, slot t)
        split_tf32_trunc(sc[j][2], ph[1], pl[1]);  // (g + 8, slot t)
        split_tf32_trunc(sc[j][1], ph[2], pl[2]);  // (g, slot t + 4)
        split_tf32_trunc(sc[j][3], ph[3], pl[3]);  // (g + 8, slot t + 4)
        const T* v0 = Vs + (8 * j + 2 * t) * p + g;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0[8 * n], bh0, bl0);
          split(v0[p + 8 * n], bh1, bl1);
          mma_tf32(acc[n], pl, bh0, bh1);  // small terms first
          if constexpr (kF32In) mma_tf32(acc[n], ph, bl0, bl1);
          mma_tf32(acc[n], ph, bh0, bh1);
        }
      }
    }
    __syncthreads();  // V tile i is consumed
    load_v(i + 1);
  }
  cp_async_wait();

  // epilogue: O / l, straight from the registers
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * t;
    if (col < Dv) {
      if (r0 < Sq) {
        ob[r0 * os.s + col] = from_f32<T>(acc[n][0] * inv0);
        ob[r0 * os.s + col + 1] = from_f32<T>(acc[n][1] * inv0);
      }
      if (r0 + 8 < Sq) {
        ob[(r0 + 8) * os.s + col] = from_f32<T>(acc[n][2] * inv1);
        ob[(r0 + 8) * os.s + col + 1] = from_f32<T>(acc[n][3] * inv1);
      }
    }
  }
}

// the widest cp.async (16, 8 or 4 bytes) that every row, stride and base
// allows; 2 (plain loads) when a bf16 tensor allows none
int copy_bytes(int es, int D, int Dv, const void* const* ptrs,
               const Strides* sts) {
  for (int w = 16; w >= 4; w /= 2) {
    bool ok = (D * es) % w == 0 && (Dv * es) % w == 0;
    for (int i = 0; i < 3; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % w == 0 &&
           (sts[i].b * es) % w == 0 && (sts[i].s * es) % w == 0 &&
           (sts[i].h * es) % w == 0;
    if (ok) return w;
  }
  return es;
}

template <typename T, int kNT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, int D, int Dv,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, cudaStream_t s) {
  constexpr int smem = smem_bytes<T, kNT>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<T, kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const void* ptrs[3] = {q, k, v};
  const Strides sts[3] = {qs, ks, vs};
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_mma_kernel<T, kNT><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, Sq, Skv, D, Dv,
      qs, ks, vs, os, causal, window, scale * kLog2e,
      copy_bytes(static_cast<int>(sizeof(T)), D, Dv, ptrs, sts));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KVH, int Sq, int Skv, int D, int Dv,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, int window, float scale, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 4>(q, k, v, o, B, H, KVH, Sq, Skv, D, Dv, qs, ks, vs,
                        os, causal, window, scale, s);
  if (D <= 64)
    return launch<T, 8>(q, k, v, o, B, H, KVH, Sq, Skv, D, Dv, qs, ks, vs,
                        os, causal, window, scale, s);
  if (D <= 128)
    return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Skv, D, Dv, qs, ks, vs,
                         os, causal, window, scale, s);
  return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Skv, D, Dv, qs, ks, vs,
                       os, causal, window, scale, s);
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D); k: (B, Skv, KVH, D); v: (B, Skv, KVH, Dv); o: (B, Sq,
// H, Dv); dtype 0 f32, 1 bf16 (all four alike).  *_st: element strides of
// (batch, seq, head), the head dim contiguous.  window <= 0: no window.
// D % 4 == 0, D <= 256, Dv % 4 == 0, Dv <= D and H % KVH == 0 (the wrapper
// checks).
int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                            void* o, int dtype, int B, int H, int KVH, int Sq,
                            int Skv, int D, int Dv, const long long* q_st,
                            const long long* k_st, const long long* v_st,
                            const long long* o_st, int causal, int window,
                            float scale, void* stream) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || Dv < 4 || Dv > D || Dv % 4 != 0 ||
      KVH < 1 || H % KVH != 0 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_st[0], q_st[1], q_st[2]};
  const Strides ks{k_st[0], k_st[1], k_st[2]};
  const Strides vs{v_st[0], v_st[1], v_st[2]};
  const Strides os{o_st[0], o_st[1], o_st[2]};
  cudaError_t e;
  if (dtype == kF32) {
    e = launch_d<float>(q, k, v, o, B, H, KVH, Sq, Skv, D, Dv, qs, ks, vs,
                        os, causal, window, scale, s);
  } else if (dtype == kBF16) {
    e = launch_d<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Skv, D, Dv, qs,
                                ks, vs, os, causal, window, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
