// Mamba-2 SSD (state-space dual) chunked forward for Hopper (sm_90a), plain
// C interface.
//
// Per (batch b, head h), over chunks of Q time steps in order, with the
// running state S (hd x ds, f32) carried from chunk to chunk:
//
//   cum_q   = sum_{t<=q} dt_t a_h                       (within the chunk)
//   W[q,k]  = (C_q . B_k) exp(cum_q - cum_k) dt_k        for k <= q, else 0
//   y_q     = sum_k W[q,k] x_k + exp(cum_q) C_q S^T
//   S      <- exp(cum_Q) S + sum_k x_k (x) (B_k dt_k exp(cum_Q - cum_k))
//
// which is the SSM  S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t
// from the initial state h0 (zeros when none is given), returning y and the
// final state.  B and C are shared by all heads (n_groups = 1).
// Replaces src/repro/kernels/ssd/kernel.py _ssd_kernel, which starts from a
// zero state; with h0 this computes models/blocks.py ssd_chunked, the JAX
// model path, in the same chunk decomposition.
//
// Layout: x (B, NH, S, hd), dt (B, NH, S), B/C (B, S, ds) and y (B, NH, S,
// hd) are read and written through element strides (last dim contiguous),
// so the model's (B, S, NH, hd) tensors need no transpose; a ragged last
// chunk is loaded as zeros (dt = 0: decay 1, no contribution), so nothing is
// padded in memory.  Everything is f32: the mask is applied before exp, as
// in the JAX model.
//
// Bound: at the main path's shape (mamba2-1.3b prefill, Q = 128, hd = 64,
// ds = 128) the three chunk products cost ~1.05e7 flops per (b, h, chunk)
// against ~70 KB of new input, so the kernel is bound by operations, at the
// 67 TFLOP/s f32 rate (TF32 would break the 1e-4 tolerance).  Design: one
// block of 256 threads per (head, batch) walks the chunks, holding the
// chunk's C, B, x and the state in shared memory (198 KB at the main
// shape).  Each product is a register-tiled loop: a thread owns rows
// ty + 16 i and columns tx + 16 j of its output, so a shared-memory value
// feeds several FMAs, and rows read across lanes are padded by 4 floats so
// 16 rows fall in distinct banks.  C's buffer is reused for W once C S^T
// and C B^T are done, and B is scaled in place into the state-update
// weights.  Later work: C B^T is the same for every head and is recomputed
// per head here; tensor cores (3xTF32 or bf16 splits) are not used.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises if it is not cudaSuccess.  Nothing here allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kQT = 8;         // rows of Q per thread: Q <= 128
constexpr int kST = 8;         // columns of ds per thread: ds <= 128
constexpr int kMaxQ = 16 * kQT;
constexpr int kMaxS = 16 * kST;

struct Strides3 {  // element strides of (batch, head, seq); last dim contiguous
  long long b, h, s;
};

struct Strides2 {  // element strides of (batch, seq); last dim contiguous
  long long b, s;
};

// C's buffer, later W (Q x Q), rounded to 4 floats so B stays 16-byte aligned
__host__ __device__ __forceinline__ int cw_floats(int Q, int ldc) {
  return (Q * (ldc > Q ? ldc : Q) + 3) & ~3;
}

size_t smem_floats(int Q, int hd, int ds) {
  const int ldc = ds + 4;
  return static_cast<size_t>(hd) * ldc     // state
         + cw_floats(Q, ldc)               // C / W
         + static_cast<size_t>(Q) * ldc    // B, later B * dt * decay
         + static_cast<size_t>(Q) * hd     // x
         + 2 * static_cast<size_t>(Q);     // cum, dt
}

// kHT: columns of hd per thread (hd <= 16 * kHT)
template <int kHT>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ state, int NH,
               int S, int hd, int ds, int Q, Strides3 xs, Strides3 dts,
               Strides2 bs, Strides2 cs, Strides3 ys) {
  extern __shared__ float smem[];
  const int ldc = ds + 4;
  const int ldw = Q;
  float* Ss = smem;                                  // hd x ldc
  float* Cs = Ss + hd * ldc;                         // Q x ldc, then W Q x ldw
  float* Bs = Cs + cw_floats(Q, ldc);                // Q x ldc
  float* Xs = Bs + Q * ldc;                          // Q x hd
  float* cum = Xs + Q * hd;                          // Q
  float* dtv = cum + Q;                              // Q

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float ah = a[h];

  const float* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const float* Bb = Bm + b * bs.b;
  const float* Cb = Cm + b * cs.b;
  float* yb = y + b * ys.b + h * ys.h;
  const long long st_off = (static_cast<long long>(b) * NH + h) * hd * ds;

  for (int i = tid; i < hd * ds; i += kThreads) {
    const int d = i / ds, s = i - d * ds;
    Ss[d * ldc + s] = h0 != nullptr ? h0[st_off + i] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int len = min(Q, S - c0);
    __syncthreads();  // the previous chunk is consumed, the state written
    for (int i = tid; i < Q * ds; i += kThreads) {
      const int q = i / ds, s = i - q * ds;
      const bool in = q < len;
      Cs[q * ldc + s] = in ? Cb[(c0 + q) * cs.s + s] : 0.f;
      Bs[q * ldc + s] = in ? Bb[(c0 + q) * bs.s + s] : 0.f;
    }
    for (int i = tid; i < Q * hd; i += kThreads) {
      const int q = i / hd, d = i - q * hd;
      Xs[q * hd + d] = q < len ? xb[(c0 + q) * xs.s + d] : 0.f;
    }
    for (int q = tid; q < Q; q += kThreads)
      dtv[q] = q < len ? dtb[(c0 + q) * dts.s] : 0.f;
    __syncthreads();
    if (tid == 0) {  // sequential, as the reference's cumsum
      float run = 0.f;
      for (int q = 0; q < Q; ++q) {
        run += dtv[q] * ah;
        cum[q] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    // (1) y_off[q, d] = exp(cum_q) * sum_s C[q, s] S[d, s]
    float acc_y[kQT][kHT];
#pragma unroll
    for (int i = 0; i < kQT; ++i)
#pragma unroll
      for (int j = 0; j < kHT; ++j) acc_y[i][j] = 0.f;
    for (int s = 0; s < ds; s += 4) {
      float4 cv[kQT], sv[kHT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
        cv[i] = *reinterpret_cast<const float4*>(
            &Cs[min(ty + 16 * i, Q - 1) * ldc + s]);
#pragma unroll
      for (int j = 0; j < kHT; ++j)
        sv[j] = *reinterpret_cast<const float4*>(
            &Ss[min(tx + 16 * j, hd - 1) * ldc + s]);
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kHT; ++j) {
          acc_y[i][j] += cv[i].x * sv[j].x;
          acc_y[i][j] += cv[i].y * sv[j].y;
          acc_y[i][j] += cv[i].z * sv[j].z;
          acc_y[i][j] += cv[i].w * sv[j].w;
        }
    }
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const float e = expf(cum[min(ty + 16 * i, Q - 1)]);
#pragma unroll
      for (int j = 0; j < kHT; ++j) acc_y[i][j] *= e;
    }

    // (2) W[q, k] = (C_q . B_k) exp(cum_q - cum_k) dt_k, k <= q
    float acc_w[kQT][kQT];
#pragma unroll
    for (int i = 0; i < kQT; ++i)
#pragma unroll
      for (int j = 0; j < kQT; ++j) acc_w[i][j] = 0.f;
    for (int s = 0; s < ds; s += 4) {
      float4 cv[kQT], bv[kQT];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
        cv[i] = *reinterpret_cast<const float4*>(
            &Cs[min(ty + 16 * i, Q - 1) * ldc + s]);
#pragma unroll
      for (int j = 0; j < kQT; ++j)
        bv[j] = *reinterpret_cast<const float4*>(
            &Bs[min(tx + 16 * j, Q - 1) * ldc + s]);
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          acc_w[i][j] += cv[i].x * bv[j].x;
          acc_w[i][j] += cv[i].y * bv[j].y;
          acc_w[i][j] += cv[i].z * bv[j].z;
          acc_w[i][j] += cv[i].w * bv[j].w;
        }
    }
    __syncthreads();  // every read of C and B is done
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const int q = ty + 16 * i;
      if (q >= Q) continue;
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const int k = tx + 16 * j;
        if (k >= Q) continue;
        // mask before exp: cum_q - cum_k > 0 for k > q
        Cs[q * ldw + k] =
            k <= q ? acc_w[i][j] * expf(cum[q] - cum[k]) * dtv[k] : 0.f;
      }
    }
    // B_k <- B_k dt_k exp(cum_Q - cum_k): the state update's weights
    for (int i = tid; i < Q * ds; i += kThreads) {
      const int k = i / ds, s = i - k * ds;
      Bs[k * ldc + s] *= dtv[k] * expf(cum_last - cum[k]);
    }
    __syncthreads();

    // (3) y[q, d] = y_off[q, d] + sum_{k<=q} W[q, k] x[k, d]
    for (int k = 0; k < Q; ++k) {
      float w[kQT], xv[kHT];
#pragma unroll
      for (int i = 0; i < kQT; ++i) w[i] = Cs[min(ty + 16 * i, Q - 1) * ldw + k];
#pragma unroll
      for (int j = 0; j < kHT; ++j) xv[j] = Xs[k * hd + min(tx + 16 * j, hd - 1)];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kHT; ++j) acc_y[i][j] += w[i] * xv[j];
    }
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const int q = ty + 16 * i;
      if (q >= len) continue;
#pragma unroll
      for (int j = 0; j < kHT; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) yb[(c0 + q) * ys.s + d] = acc_y[i][j];
      }
    }

    // (4) S[d, s] <- exp(cum_Q) S[d, s] + sum_k x[k, d] Bw[k, s]
    float acc_s[kHT][kST];
#pragma unroll
    for (int i = 0; i < kHT; ++i)
#pragma unroll
      for (int j = 0; j < kST; ++j) acc_s[i][j] = 0.f;
    for (int k = 0; k < Q; ++k) {
      float xv[kHT], bv[kST];
#pragma unroll
      for (int i = 0; i < kHT; ++i) xv[i] = Xs[k * hd + min(ty + 16 * i, hd - 1)];
#pragma unroll
      for (int j = 0; j < kST; ++j) bv[j] = Bs[k * ldc + min(tx + 16 * j, ds - 1)];
#pragma unroll
      for (int i = 0; i < kHT; ++i)
#pragma unroll
        for (int j = 0; j < kST; ++j) acc_s[i][j] += xv[i] * bv[j];
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kHT; ++i) {
      const int d = ty + 16 * i;
      if (d >= hd) continue;
#pragma unroll
      for (int j = 0; j < kST; ++j) {
        const int s = tx + 16 * j;
        if (s < ds) Ss[d * ldc + s] = decay * Ss[d * ldc + s] + acc_s[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * ds; i += kThreads) {
    const int d = i / ds, s = i - d * ds;
    state[st_off + i] = Ss[d * ldc + s];
  }
}

template <int kHT>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* Bm, const float* Cm, const float* h0, float* y,
                   float* state, int B, int NH, int S, int hd, int ds, int Q,
                   Strides3 xs, Strides3 dts, Strides2 bs, Strides2 cs,
                   Strides3 ys, cudaStream_t s) {
  const size_t smem = smem_floats(Q, hd, ds) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<kHT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(NH, B);
  ssd_fwd_kernel<kHT><<<grid, kThreads, smem, s>>>(
      x, dt, a, Bm, Cm, h0, y, state, NH, S, hd, ds, Q, xs, dts, bs, cs, ys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory this kernel needs for (Q, hd, ds), in bytes; the wrapper
// refuses shapes above the card's 227 KB.
long long ssd_smem_bytes(int Q, int hd, int ds) {
  return static_cast<long long>(smem_floats(Q, hd, ds) * sizeof(float));
}

// x: (B, NH, S, hd), strides x_st (b, h, s); dt: (B, NH, S), dt_st (b, h, s);
// a: (NH,); Bm, Cm: (B, S, ds), strides (b, s); h0: (B, NH, hd, ds)
// contiguous or null (zeros); y: (B, NH, S, hd), strides y_st (b, h, s);
// state: (B, NH, hd, ds) contiguous.  All f32.  Q <= 128, ds <= 128,
// ds % 4 == 0, hd <= 128 (the wrapper checks).
int ssd_fwd(const void* x, const void* dt, const void* a, const void* Bm,
            const void* Cm, const void* h0, void* y, void* state, int B,
            int NH, int S, int hd, int ds, int Q, const long long* x_st,
            const long long* dt_st, const long long* b_st,
            const long long* c_st, const long long* y_st, void* stream) {
  if (Q < 1 || Q > kMaxQ || ds > kMaxS || ds % 4 != 0 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides3 xs{x_st[0], x_st[1], x_st[2]};
  const Strides3 dts{dt_st[0], dt_st[1], dt_st[2]};
  const Strides2 bs{b_st[0], b_st[1]};
  const Strides2 cs{c_st[0], c_st[1]};
  const Strides3 ys{y_st[0], y_st[1], y_st[2]};
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaError_t e;
  if (hd <= 64) {
    e = launch<4>(xf, dtf, af, bf, cf, h0f, yf, sf, B, NH, S, hd, ds, Q, xs,
                  dts, bs, cs, ys, s);
  } else {
    e = launch<8>(xf, dtf, af, bf, cf, h0f, yf, sf, B, NH, S, hd, ds, Q, xs,
                  dts, bs, cs, ys, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
