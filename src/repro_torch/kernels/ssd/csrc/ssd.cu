// Mamba-2 SSD (state-space dual) chunked forward for Hopper (sm_90a), plain
// C interface.
//
// Per (batch b, head h), over chunks of Q time steps, with the state S
// (hd x ds, f32) carried from chunk to chunk:
//
//   cum_q   = sum_{t<=q} dt_t a_h                       (within the chunk)
//   W[q,k]  = (C_q . B_k) exp(cum_q - cum_k) dt_k        for k <= q, else 0
//   y_q     = sum_k W[q,k] x_k + exp(cum_q) C_q S_prev^T
//   S      <- exp(cum_Q) S + sum_k x_k (x) (B_k dt_k exp(cum_Q - cum_k))
//
// which is the SSM  S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t
// from the initial state h0 (zeros when none is given), returning y and the
// final state.  B and C are shared by all heads (n_groups = 1).
// Replaces src/repro/kernels/ssd/kernel.py _ssd_kernel, which starts from a
// zero state; with h0 this computes models/blocks.py ssd_chunked, the JAX
// model path, in the same chunk decomposition.
//
// Four kernels, launched in order on one stream, follow the model function's
// chunk-parallel form (repro_torch/models/blocks.py _ssd_chunked_plain):
//   K1 ssd_chunk_cb     grid (2, chunk, b)     G = C B^T (Q x Q), once for
//                                              all heads, half the rows each
//   K2 ssd_chunk_state  grid (chunk, head, b)  S_c = (x * dt exp(cum_Q -
//                                              cum))^T B, and exp(cum_Q)
//   K3 ssd_state_pass   grid (slice, head, b)  S_prev_c in place of S_c, in
//                                              chunk order, from h0; the
//                                              final state
//   K4 ssd_chunk_scan   grid (chunk, head, b)  y = exp(cum) C S_prev^T +
//                                              (G * exp(seg) * dt) x
// The wrapper allocates the scratch (G, the chunk states, the decays) with
// torch.empty; nothing here allocates.
//
// Layout: x (B, NH, S, hd), dt (B, NH, S), B/C (B, S, ds) and y (B, NH, S,
// hd) are read and written through element strides (last dim contiguous),
// so the model's (B, S, NH, hd) tensors need no transpose.  A chunk is
// padded in shared memory to 128 steps and ds to 128 with zeros (a padded
// step has dt = 0: decay 1, no contribution), so nothing is padded in
// memory.  The mask is applied before exp, as in the JAX model.
//
// Products: mma.sync m16n8k8 on the TF32 tensor cores in 3xTF32, a = a_hi +
// a_lo with both parts rounded to TF32, d += a_lo b_hi + a_hi b_lo + a_hi
// b_hi, which keeps the error near f32's (plain TF32, ~2^-11 relative,
// breaks the 1e-4 tolerance in every SSD parity case of chip_smoke.py, as
// `chip_smoke.py --ssd-precision` shows on the card).  Each warp owns a
// 16-row strip of its block's output and reads its fragments from shared
// memory whose row pitch makes the 32 lanes of a fragment load hit 32 banks
// (pitch % 32 == 4 where the fragment walks rows, 8 where it walks
// columns).
//
// Bound: at the main path's shape (mamba2-1.3b prefill, Q = 128, hd = 64,
// ds = 128, 4 x 4096 steps, 64 heads) the function needs 4.3e10 flop (the
// causal pairs k <= q of W X and C B^T only), which at the 165 TFLOP/s of
// f32-accurate (3xTF32) tensor-core products is 0.26 ms, against 566 MB of
// inputs and outputs (0.17 ms).  This design also
// moves the chunk states (268 MB) through device memory three times, and
// reads x twice: that traffic is its own gap to the bound.  K1, K2 and K4
// keep under 108 KB of shared memory a block at hd <= 64, so two blocks
// share an SM; the grids hold 8192 blocks.
//
// The entry returns the first CUDA error of its four launches; the Python
// wrapper raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kQ = 128;        // steps of a chunk, padded
constexpr int kS = 128;        // ds, padded
constexpr int kLd = kS + 4;    // pitch of a [row][k] operand (== kQ + 4)

struct Strides3 {  // element strides of (batch, head, seq); last dim contiguous
  long long b, h, s;
};

struct Strides2 {  // element strides of (batch, seq); last dim contiguous
  long long b, s;
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A[m0:m0+16, 0:K] B[0:K, n0+8j : n0+8j+8] in 3xTF32, A and B in
// shared memory.  A(m, k) is A[k * lda + m] if kAT else A[m * lda + k];
// B(k, n) is B[n * ldb + k] if kBT else B[k * ldb + n].  Fragments follow
// the PTX ISA's m16n8k8 .tf32 layout: with g = lane / 4, t = lane % 4,
// a = {A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4)}, b = {B(t, g), B(t+4, g)},
// and the accumulator {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
template <int NT, bool kAT, bool kBT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb,
                                         int m0, int n0, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto a_at = [&](int m, int k) {
    return kAT ? A[k * lda + m] : A[m * lda + k];
  };
  auto b_at = [&](int k, int n) {
    return kBT ? B[n * ldb + k] : B[k * ldb + n];
  };
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a_at(m0 + g, k + t), ah[0], al[0]);
    split_tf32(a_at(m0 + g + 8, k + t), ah[1], al[1]);
    split_tf32(a_at(m0 + g, k + t + 4), ah[2], al[2]);
    split_tf32(a_at(m0 + g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b_at(k + t, n), bh0, bl0);
      split_tf32(b_at(k + t + 4, n), bh1, bl1);
      mma_tf32(acc[j], al, bh0, bh1);  // small terms first
      mma_tf32(acc[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros when !in (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts loading rows [0, kRows) x cols [0, kCols) of a row-major global
// matrix into shared memory with pitch ld (a multiple of 4), zeros where
// row >= rows or col >= cols: every 16-byte copy of the tile in flight at
// once (cp.async) where the layout allows it (cols, row stride and address
// multiples of 4 floats), else plain loads.  The caller then runs
// cp_async_wait() and __syncthreads().
template <int kRows, int kCols>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          long long row_stride, int rows,
                                          int cols) {
  if (cols % 4 == 0 && row_stride % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kCols / 4; i += kThreads) {
      const int r = i / (kCols / 4), c = 4 * (i % (kCols / 4));
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ld + c, in ? src + r * row_stride + c : src, in);
    }
    return;
  }
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    dst[r * ld + c] = (r < rows && c < cols) ? src[r * row_stride + c] : 0.f;
  }
}

// dt of the chunk (zeros past len) into dtv, and cum_q = a sum_{t<=q} dt_t
// into cum: warp 0 scans, 4 steps a lane.  The block syncs after.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtb,
                                             long long dt_stride, int len,
                                             float ah, float* dtv,
                                             float* cum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float v[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 4 * lane + i;
    const float d = q < len ? dtb[q * dt_stride] : 0.f;
    dtv[q] = d;
    run += d * ah;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float excl = incl - run;
#pragma unroll
  for (int i = 0; i < 4; ++i) cum[4 * lane + i] = excl + v[i];
}

// ---------------------------------------------------------------- K1
// G[b, c] = C_c B_c^T (kQ x kQ), rows 64 * blockIdx.x .. + 64.
constexpr size_t kCbSmem = sizeof(float) * (64 + kQ) * kLd;

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
             float* __restrict__ G, int S, int ds, int Q, int nc,
             Strides2 bs, Strides2 cs) {
  extern __shared__ float smem[];
  float* Cs = smem;            // 64 x kLd
  float* Bs = Cs + 64 * kLd;   // kQ x kLd
  const int half = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, len = min(Q, S - c0), r0 = 64 * half;
  load_tile<64, kS>(Cs, kLd, Cm + b * cs.b + (c0 + r0) * cs.s, cs.s,
                    len - r0, ds);
  load_tile<kQ, kS>(Bs, kLd, Bm + b * bs.b + c0 * bs.s, bs.s, len, ds);
  cp_async_wait();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  float acc[8][4];
  zero(acc);
  warp_mma<8, false, true>(acc, Cs, kLd, Bs, kLd, m0, n0, kS);
  float* Gb = G + (static_cast<long long>(b) * nc + c) * kQ * kQ;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const int row = r0 + m0 + g;
    Gb[row * kQ + col] = acc[j][0];
    Gb[row * kQ + col + 1] = acc[j][1];
    Gb[(row + 8) * kQ + col] = acc[j][2];
    Gb[(row + 8) * kQ + col + 1] = acc[j][3];
  }
}

// ---------------------------------------------------------------- K2
// states[b, c, h] = sum_q x_q (x) B_q dt_q exp(cum_Q - cum_q)  (hd x ds);
// decay[b, c, h] = exp(cum_Q).  kHD: hd rounded up to 64 or 128.
template <int kHD>
constexpr size_t state_smem() {
  return sizeof(float) * (kQ * (kHD + 8) + kQ * (kS + 8) + 2 * kQ);
}

template <int kHD>
__global__ void __launch_bounds__(kThreads, kHD <= 64 ? 2 : 1)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ decay,
                int NH, int S, int hd, int ds, int Q, int nc, Strides3 xs,
                Strides3 dts, Strides2 bs) {
  constexpr int ldx = kHD + 8, ldb = kS + 8;
  extern __shared__ float smem[];
  float* Xs = smem;             // kQ x ldx: x_q * w_q
  float* Bs = Xs + kQ * ldx;    // kQ x ldb
  float* cum = Bs + kQ * ldb;   // kQ
  float* w = cum + kQ;          // kQ: dt, then dt exp(cum_Q - cum)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, len = min(Q, S - c0);
  load_tile<kQ, kHD>(Xs, ldx, x + b * xs.b + h * xs.h + c0 * xs.s, xs.s, len,
                     hd);
  load_tile<kQ, kS>(Bs, ldb, Bm + b * bs.b + c0 * bs.s, bs.s, len, ds);
  chunk_cumsum(dt + b * dts.b + h * dts.h + c0 * dts.s, dts.s, len, a[h], w,
               cum);
  cp_async_wait();
  __syncthreads();
  const float cum_last = cum[kQ - 1];
  if (threadIdx.x < kQ) w[threadIdx.x] *= expf(cum_last - cum[threadIdx.x]);
  if (threadIdx.x == 0)
    decay[(static_cast<long long>(b) * nc + c) * NH + h] = expf(cum_last);
  __syncthreads();
  for (int i = threadIdx.x; i < kQ * kHD; i += kThreads) {  // x_q * w_q
    const int q = i / kHD;
    Xs[q * ldx + i % kHD] *= w[q];
  }
  __syncthreads();
  // warp tile: 16 rows of hd x (kS / col_groups) columns of ds
  constexpr int kRowGroups = kHD / 16, kColGroups = 8 / kRowGroups;
  constexpr int NT = kS / kColGroups / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = 16 * (warp % kRowGroups);
  const int n0 = (warp / kRowGroups) * (kS / kColGroups);
  float acc[NT][4];
  zero(acc);
  warp_mma<NT, true, false>(acc, Xs, ldx, Bs, ldb, m0, n0, kQ);
  float* out = states + ((static_cast<long long>(b) * nc + c) * NH + h) *
                            static_cast<long long>(hd) * ds;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int s = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = m0 + g + (e >> 1) * 8, se = s + (e & 1);
      if (d < hd && se < ds) out[d * ds + se] = acc[j][e];
    }
  }
}

// ---------------------------------------------------------------- K3
// In chunk order: S_prev_c replaces S_c in states, S <- decay_c S + S_c,
// from h0 (or zeros); the final S into final_state.  Each thread owns 4
// elements of one (b, h) state.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               const float* __restrict__ h0, float* __restrict__ final_state,
               int NH, int nc, int n) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (static_cast<long long>(b) * NH + h) * n;
  int e[4];
  float s[4], nxt[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = blockIdx.x * 4 * kThreads + j * kThreads + threadIdx.x;
    s[j] = (h0 != nullptr && e[j] < n) ? h0[bh + e[j]] : 0.f;
  }
  auto slot = [&](int c) {
    return states + ((static_cast<long long>(b) * nc + c) * NH + h) *
                        static_cast<long long>(n);
  };
#pragma unroll
  for (int j = 0; j < 4; ++j) nxt[j] = e[j] < n ? slot(0)[e[j]] : 0.f;
  for (int c = 0; c < nc; ++c) {
    float cur[4];
    float* sc = slot(c);
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
    if (c + 1 < nc) {  // next chunk's loads before this chunk's stores
      const float* sn = slot(c + 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) nxt[j] = e[j] < n ? sn[e[j]] : 0.f;
    }
    const float dec = decay[(static_cast<long long>(b) * nc + c) * NH + h];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e[j] < n) sc[e[j]] = s[j];
      s[j] = dec * s[j] + cur[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e[j] < n) final_state[bh + e[j]] = s[j];
}

// ---------------------------------------------------------------- K4
// y_q = exp(cum_q) C_q S_prev^T + sum_{k<=q} G[q,k] exp(cum_q - cum_k) dt_k
// x_k.  Two phases share the shared memory: C and S_prev, then W and x.
template <int kHD>
__host__ __device__ constexpr int scan_bufb() {
  return kHD * kLd > kQ * (kHD + 8) ? kHD * kLd : kQ * (kHD + 8);
}
template <int kHD>
constexpr size_t scan_smem() {
  return sizeof(float) * (kQ * kLd + scan_bufb<kHD>() + 2 * kQ);
}

template <int kHD>
__global__ void __launch_bounds__(kThreads, kHD <= 64 ? 2 : 1)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ Cm,
               const float* __restrict__ G, const float* __restrict__ states,
               float* __restrict__ y, int NH, int S, int hd, int ds, int Q,
               int nc, Strides3 xs, Strides3 dts, Strides2 cs, Strides3 ys) {
  constexpr int ldx = kHD + 8;
  constexpr int NT = kHD / 8;
  extern __shared__ float smem[];
  float* bufA = smem;                       // kQ x kLd: C, then W
  float* bufB = bufA + kQ * kLd;            // S_prev (kHD x kLd), then x
  float* cum = bufB + scan_bufb<kHD>();     // kQ
  float* dtv = cum + kQ;                    // kQ
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, len = min(Q, S - c0);
  const long long slot = (static_cast<long long>(b) * nc + c) * NH + h;
  load_tile<kQ, kS>(bufA, kLd, Cm + b * cs.b + c0 * cs.s, cs.s, len, ds);
  load_tile<kHD, kS>(bufB, kLd, states + slot * hd * ds, ds, hd, ds);
  chunk_cumsum(dt + b * dts.b + h * dts.h + c0 * dts.s, dts.s, len, a[h],
               dtv, cum);
  cp_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;
  float acc[NT][4];
  zero(acc);
  warp_mma<NT, false, true>(acc, bufA, kLd, bufB, kLd, m0, 0, kS);
  const float e0 = expf(cum[m0 + g]), e1 = expf(cum[m0 + g + 8]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= e0;
    acc[j][1] *= e0;
    acc[j][2] *= e1;
    acc[j][3] *= e1;
  }
  __syncthreads();  // C and S_prev are consumed

  load_tile<kQ, kQ>(bufA, kLd,
                    G + (static_cast<long long>(b) * nc + c) * kQ * kQ, kQ,
                    kQ, kQ);
  load_tile<kQ, kHD>(bufB, ldx, x + b * xs.b + h * xs.h + c0 * xs.s, xs.s,
                     len, hd);
  cp_async_wait();
  __syncthreads();
  for (int i = threadIdx.x; i < kQ * kQ / 4; i += kThreads) {  // G -> W
    const int q = i / (kQ / 4), k = 4 * (i % (kQ / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k <= q) {
      // mask before exp: cum_q - cum_k > 0 for k > q
      const float4 g = *reinterpret_cast<const float4*>(bufA + q * kLd + k);
      const float cq = cum[q];
      v.x = g.x * expf(cq - cum[k]) * dtv[k];
      v.y = k + 1 <= q ? g.y * expf(cq - cum[k + 1]) * dtv[k + 1] : 0.f;
      v.z = k + 2 <= q ? g.z * expf(cq - cum[k + 2]) * dtv[k + 2] : 0.f;
      v.w = k + 3 <= q ? g.w * expf(cq - cum[k + 3]) * dtv[k + 3] : 0.f;
    }
    *reinterpret_cast<float4*>(bufA + q * kLd + k) = v;
  }
  __syncthreads();
  // W is lower triangular: rows m0 .. m0+15 need keys k < m0 + 16
  warp_mma<NT, false, false>(acc, bufA, kLd, bufB, ldx, m0, 0, m0 + 16);

  float* yb = y + b * ys.b + h * ys.h + c0 * ys.s;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = m0 + g + (e >> 1) * 8, d = 8 * j + 2 * t + (e & 1);
      if (q < len && d < hd) yb[q * ys.s + d] = acc[j][e];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kHD>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* Bm, const float* Cm, const float* h0,
                   float* y, float* state, float* G, float* states,
                   float* decay, int B, int NH, int S, int hd, int ds, int Q,
                   Strides3 xs, Strides3 dts, Strides2 bs, Strides2 cs,
                   Strides3 ys, cudaStream_t st) {
  const int nc = (S + Q - 1) / Q;
  cudaError_t e;
  if ((e = allow_smem(ssd_chunk_cb, kCbSmem)) != cudaSuccess) return e;
  ssd_chunk_cb<<<dim3(2, nc, B), kThreads, kCbSmem, st>>>(Bm, Cm, G, S, ds,
                                                          Q, nc, bs, cs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = allow_smem(ssd_chunk_state<kHD>, state_smem<kHD>())) !=
      cudaSuccess)
    return e;
  ssd_chunk_state<kHD><<<dim3(nc, NH, B), kThreads, state_smem<kHD>(), st>>>(
      x, dt, a, Bm, states, decay, NH, S, hd, ds, Q, nc, xs, dts, bs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int n = hd * ds;
  const int slices = (n + 4 * kThreads - 1) / (4 * kThreads);
  ssd_state_pass<<<dim3(slices, NH, B), kThreads, 0, st>>>(states, decay, h0,
                                                           state, NH, nc, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = allow_smem(ssd_chunk_scan<kHD>, scan_smem<kHD>())) != cudaSuccess)
    return e;
  ssd_chunk_scan<kHD><<<dim3(nc, NH, B), kThreads, scan_smem<kHD>(), st>>>(
      x, dt, a, Cm, G, states, y, NH, S, hd, ds, Q, nc, xs, dts, cs, ys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, NH, S, hd), strides x_st (b, h, s); dt: (B, NH, S), dt_st (b, h,
// s); a: (NH,); Bm, Cm: (B, S, ds), strides (b, s); h0: (B, NH, hd, ds)
// contiguous or null (zeros); y: (B, NH, S, hd), strides y_st (b, h, s);
// state: (B, NH, hd, ds) contiguous.  Scratch, contiguous: G (B, nc, 128,
// 128), states (B, nc, NH, hd, ds), decay (B, nc, NH), nc = ceil(S / Q).
// All f32.  Q <= 128, ds <= 128, hd <= 128 (the wrapper checks).
int ssd_fwd(const void* x, const void* dt, const void* a, const void* Bm,
            const void* Cm, const void* h0, void* y, void* state, void* G,
            void* states, void* decay, int B, int NH, int S, int hd, int ds,
            int Q, const long long* x_st, const long long* dt_st,
            const long long* b_st, const long long* c_st,
            const long long* y_st, void* stream) {
  if (Q < 1 || Q > kQ || ds < 1 || ds > kS || hd < 1 || hd > 128 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides3 xs{x_st[0], x_st[1], x_st[2]};
  const Strides3 dts{dt_st[0], dt_st[1], dt_st[2]};
  const Strides2 bs{b_st[0], b_st[1]};
  const Strides2 cs{c_st[0], c_st[1]};
  const Strides3 ys{y_st[0], y_st[1], y_st[2]};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t e;
  if (hd <= 64) {
    e = launch<64>(f(x), f(dt), f(a), f(Bm), f(Cm), f(h0), w(y), w(state),
                   w(G), w(states), w(decay), B, NH, S, hd, ds, Q, xs, dts,
                   bs, cs, ys, s);
  } else {
    e = launch<128>(f(x), f(dt), f(a), f(Bm), f(Cm), f(h0), w(y), w(state),
                    w(G), w(states), w(decay), B, NH, S, hd, ds, Q, xs, dts,
                    bs, cs, ys, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
