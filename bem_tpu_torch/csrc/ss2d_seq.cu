// One direction of the SS2D selective scan over a channel-first sequence
// x (B, C, L), with the dt / B / C projections computed in-kernel:
//   xdbl = Wx . x                       (R + 2N rows: dt-rank | B | C)
//   dt   = softplus(Wdt . xdbl[:R] + bias)
//   h_n  = exp(max(dt * A_n, -10)) * h_n + dt * x * B_n     (fp32 state)
//   y    = sum_n C_n * h_n [+ D * x] [+ yin]
// walked from position 0 up (forward) or from L-1 down (reverse). The state
// carries across the whole flattened sequence (cross-row / cross-column
// carry of the cross2d scan). Two launches make a pair: the forward one
// writes y_f, the reverse one adds y_f and applies D_f + D_r.
//
// Replaces bem_tpu/ops/ss2d_seq.py::ss2d_seq_pair_g (Pallas body _dir_body,
// launched by _run_dir once per direction). Bound: the sequential
// recurrence (L steps, the latency of two dependent FMAs a step), not
// bytes. The Pallas grid walked L-blocks in order carrying h in scratch;
// here a block walks L in shared-memory tiles and carries h in registers,
// one thread per channel. A block owns kChanBlock channels of one image, so
// an image spreads over C / kChanBlock SMs; each block recomputes the
// tile's x projection (it needs every channel) to stay independent. Each
// tile is prepared in parallel by all threads (projection, softplus, exp,
// the B term), so the sequential part is only h = a*h + b and y += C*h per
// step, with the next step's operands loaded ahead.
#include "common.cuh"

namespace bem {

constexpr float kLogDecayClamp = -10.f;
constexpr int kChanBlock = 16;
constexpr int kSeqThreads = 256;

inline size_t seq_smem_floats(int C, int TL, int R, int N) {
  const int P = R + 2 * N, TLp = TL + 1;
  // x tile (all C) + decay/input terms and y for the block's channels +
  // xdbl tile + Wx + the block's Wdt rows
  return (size_t)C * TLp + (size_t)kChanBlock * TLp * (1 + 2 * N) + (size_t)P * TL +
         (size_t)P * C + (size_t)kChanBlock * R;
}

template <typename T, int N>
__global__ void __launch_bounds__(kSeqThreads)
seq_dir_kernel(const T* __restrict__ x, const float* __restrict__ Wx,
               const float* __restrict__ Wdt, const float* __restrict__ bias,
               const float* __restrict__ A, const float* __restrict__ D,
               const T* __restrict__ yin, T* __restrict__ y, int C, int L, int R, int TL,
               int rev) {
  extern __shared__ float smem[];
  const int P = R + 2 * N, TLp = TL + 1;
  const int c0 = blockIdx.y * kChanBlock, nc = min(kChanBlock, C - c0);
  float* xs = smem;                      // (C, TLp)
  float* as = xs + C * TLp;              // (N, kChanBlock, TLp): exp(clamped log-decay)
  float* bs = as + N * kChanBlock * TLp; // (N, kChanBlock, TLp): dt * x * B
  float* ys = bs + N * kChanBlock * TLp; // (kChanBlock, TLp)
  float* xd = ys + kChanBlock * TLp;     // (P, TL)
  float* wxs = xd + P * TL;              // (P, C)
  float* wdts = wxs + P * C;             // (kChanBlock, R)
  const int tid = threadIdx.x, nth = blockDim.x;
  const long base = (long)blockIdx.x * C * L;
  const T* xb = x + base;
  T* yb = y + base;
  const T* yinb = yin != nullptr ? yin + base : nullptr;

  for (int i = tid; i < P * C; i += nth) wxs[i] = Wx[i];
  for (int i = tid; i < nc * R; i += nth) wdts[i] = Wdt[(long)c0 * R + i];

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;

  const int ntiles = (L + TL - 1) / TL;
  for (int it = 0; it < ntiles; ++it) {
    const int tile = rev ? ntiles - 1 - it : it;
    const long l0 = (long)tile * TL;
    const int nt = (int)min((long)TL, (long)L - l0);
    for (int i = tid; i < C * TL; i += nth) {
      const int c = i / TL, t = i - c * TL;
      xs[c * TLp + t] = t < nt ? IO<T>::load(xb, (long)c * L + l0 + t) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < P * TL; i += nth) {
      const int p = i / TL, t = i - p * TL;
      const float* wr = wxs + p * C;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = fmaf(wr[c], xs[c * TLp + t], s);
      xd[i] = s;
    }
    __syncthreads();
    for (int i = tid; i < nc * TL; i += nth) {
      const int cc = i / TL, t = i - cc * TL, c = c0 + cc;
      const float* wr = wdts + cc * R;
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = fmaf(wr[r], xd[r * TL + t], s);
      const float dt = softplus(s + bias[c]);
      const float xv = xs[c * TLp + t];
      const float du = dt * xv;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        as[(n * kChanBlock + cc) * TLp + t] = expf(fmaxf(dt * A[c * N + n], kLogDecayClamp));
        bs[(n * kChanBlock + cc) * TLp + t] = du * xd[(R + n) * TL + t];
      }
      ys[cc * TLp + t] = D != nullptr ? D[c] * xv : 0.f;
    }
    __syncthreads();
    if (tid < nc) {  // the sequential walk: one thread per channel
      const int cc = tid, step = rev ? -1 : 1;
      int t = rev ? nt - 1 : 0;
      float a[N], b[N], cv[N], yv = ys[cc * TLp + t];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        a[n] = as[(n * kChanBlock + cc) * TLp + t];
        b[n] = bs[(n * kChanBlock + cc) * TLp + t];
        cv[n] = xd[(R + N + n) * TL + t];
      }
      for (int k = 0; k < nt; ++k) {
        // load the next step's operands before this step's store
        const int tn = min(max(t + step, 0), nt - 1);
        float an[N], bn[N], cn[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          an[n] = as[(n * kChanBlock + cc) * TLp + tn];
          bn[n] = bs[(n * kChanBlock + cc) * TLp + tn];
          cn[n] = xd[(R + N + n) * TL + tn];
        }
        const float yn = ys[cc * TLp + tn];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(a[n], h[n], b[n]);
          yv = fmaf(cv[n], h[n], yv);
        }
        ys[cc * TLp + t] = yv;
        t += step;
        yv = yn;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          a[n] = an[n];
          b[n] = bn[n];
          cv[n] = cn[n];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nc * TL; i += nth) {
      const int cc = i / TL, t = i - cc * TL;
      if (t >= nt) continue;
      const long j = (long)(c0 + cc) * L + l0 + t;
      float v = ys[cc * TLp + t];
      if (yinb != nullptr) v += IO<T>::load(yinb, j);
      IO<T>::store(yb, j, v);
    }
    __syncthreads();
  }
}

template <typename T, int N>
int launch_seq_dir_n(const void* x, const float* Wx, const float* Wdt, const float* bias,
                     const float* A, const float* D, const void* yin, void* y, int B, int C,
                     int L, int R, int rev, cudaStream_t stream) {
  int TL = 256;
  while (TL > 32 && seq_smem_floats(C, TL, R, N) * sizeof(float) > kSmemBudget) TL /= 2;
  const size_t smem = seq_smem_floats(C, TL, R, N) * sizeof(float);
  cudaError_t e = allow_smem(seq_dir_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (C + kChanBlock - 1) / kChanBlock);
  seq_dir_kernel<T, N><<<grid, kSeqThreads, smem, stream>>>(
      static_cast<const T*>(x), Wx, Wdt, bias, A, D, static_cast<const T*>(yin),
      static_cast<T*>(y), C, L, R, TL, rev);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_seq_dir(const void* x, const float* Wx, const float* Wdt, const float* bias,
                   const float* A, const float* D, const void* yin, void* y, int B, int C,
                   int L, int R, int N, int rev, cudaStream_t stream) {
  switch (N) {
    case 1: return launch_seq_dir_n<T, 1>(x, Wx, Wdt, bias, A, D, yin, y, B, C, L, R, rev, stream);
    case 2: return launch_seq_dir_n<T, 2>(x, Wx, Wdt, bias, A, D, yin, y, B, C, L, R, rev, stream);
    case 4: return launch_seq_dir_n<T, 4>(x, Wx, Wdt, bias, A, D, yin, y, B, C, L, R, rev, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bem

extern "C" int bem_ss2d_seq_dir(const void* x, const float* Wx, const float* Wdt,
                                const float* bias, const float* A, const float* D,
                                const void* yin, void* y, int B, int C, int L, int R, int N,
                                int rev, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::launch_seq_dir<__nv_bfloat16>(x, Wx, Wdt, bias, A, D, yin, y, B, C, L, R, N,
                                              rev, s);
  return bem::launch_seq_dir<float>(x, Wx, Wdt, bias, A, D, yin, y, B, C, L, R, N, rev, s);
}
