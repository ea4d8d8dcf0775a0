// The SS2D column scans (cross2d directions 1 and 3) over the ROW-major
// channel-first stream x (B, C, H*W), with the dt / B / C projections
// computed in-kernel as in ss2d_seq.cu:
//   xdbl = Wx . x,  dt = softplus(Wdt . xdbl[:R] + bias)
//   w_n  = max(dt * A_n, -10),  a_n = exp(w_n),  b_n = dt * x * B_n
// The flattened column-major sequence carries its state from the end of one
// column into the next, so the pair runs as three kernel passes and two
// small scans (bem_tpu/ops/ss2d_seq.py::ss2d_col_pair_g):
//   col_sum  one top-down walk of every column computes, for BOTH
//            directions, the column's end state from 0 and its total
//            log-decay: forward (dir 1, top-down) h = a*h + b, ending at
//            the bottom; reverse (dir 3, bottom-up) its top end state as the
//            prefix-product sum acc += P*b, P *= a of the same walk;
//   (linear_scan over the W columns turns these into entry states;)
//   col_dir  one direction's full walk from the entry states, writing
//            y = sum_n C_n h_n [+ D x] [+ yin] in the stream dtype.
//
// Replaces bem_tpu/ops/ss2d_seq.py::_run_col_sum (Pallas body _col_sum_body)
// and ::_run_col_dir (body _col_body). Bound: bytes at the wide levels (one
// read of x, one write of y, the yin read) and otherwise the per-pixel
// projection arithmetic. The Pallas grid walked th-row slabs in order with
// the column state in scratch; here every (image, channel, column) is an
// independent recurrence of only H steps, so a block takes 32 columns of
// one image and a slice of its channels, one thread per (channel, column)
// holding the state in registers. Each tile of rows is staged in shared
// memory with all C channels (the projection needs them); the block
// computes the tile's projection rows in parallel, then every thread walks
// the tile's rows for its (channel, column). Loads and stores run along
// the columns, so they are coalesced. A block of a channel slice
// recomputes the projection for its own use, which keeps blocks independent.
#include "common.cuh"

namespace bem {

constexpr float kColClamp = -10.f;
constexpr int kColTW = 32;         // columns per block: threadIdx.x
constexpr int kColMaxChan = 32;    // channels per block at most: threadIdx.y
constexpr size_t kColSmem = 110 * 1024;  // two blocks fit on an SM

// channels per block: C split into ceil(C / 32) near-equal slices
inline int col_chan_block(int C) {
  const int nct = (C + kColMaxChan - 1) / kColMaxChan;
  return (C + nct - 1) / nct;
}

// floats of shared memory: x tile (C, TH*TW), projection rows
// (ndir*Q, TH*TW), Wx rows (ndir*Q, C), the block's Wdt rows (ndir, CB, R)
inline size_t col_smem_floats(int C, int TH, int ndir, int Q, int CB, int R) {
  return (size_t)C * TH * kColTW + (size_t)ndir * Q * TH * kColTW + (size_t)ndir * Q * C +
         (size_t)ndir * CB * R;
}

inline int col_rows(int C, int ndir, int Q, int CB, int R) {
  int TH = 8;
  while (TH > 1 && col_smem_floats(C, TH, ndir, Q, CB, R) * sizeof(float) > kColSmem) TH /= 2;
  return TH;
}

// Stage rows [h0, h0+nt) x columns [w0, w0+32) of every channel of one
// image, then the ndir*Q projection rows xd[q][pix] = Wx_q . x[:, pix].
template <typename T>
__device__ __forceinline__ void col_stage(const T* __restrict__ xb, float* xs, float* xd,
                                          const float* wx, int C, int H, int W, int h0,
                                          int nt, int w0, int TH, int nq, long L) {
  const int tid = threadIdx.y * kColTW + threadIdx.x;
  const int nth = kColTW * blockDim.y;
  const int tile = TH * kColTW;
  for (int i = tid; i < C * tile; i += nth) {
    const int c = i / tile, pix = i - c * tile;
    const int t = pix / kColTW, w = w0 + pix - t * kColTW;
    xs[i] = (t < nt && w < W) ? IO<T>::load(xb, (long)c * L + (long)(h0 + t) * W + w) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < nq * tile; i += nth) {
    const int q = i / tile, pix = i - q * tile;
    const float* wr = wx + q * C;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(wr[c], xs[c * tile + pix], s);
    xd[i] = s;
  }
  __syncthreads();
}

template <typename T, int N>
__global__ void __launch_bounds__(kColTW * kColMaxChan)
col_sum_kernel(const T* __restrict__ x, const float* __restrict__ Wxf,
               const float* __restrict__ Wdtf, const float* __restrict__ biasf,
               const float* __restrict__ Af, const float* __restrict__ Wxr,
               const float* __restrict__ Wdtr, const float* __restrict__ biasr,
               const float* __restrict__ Ar, float* __restrict__ sendf,
               float* __restrict__ stotf, float* __restrict__ sendr,
               float* __restrict__ stotr, int C, int H, int W, int R, int CB, int TH) {
  extern __shared__ float smem[];
  const int Q = R + N;  // dt-rank and B rows: the summary needs no C rows
  const int tile = TH * kColTW;
  float* xs = smem;              // (C, tile)
  float* xd = xs + C * tile;     // (2*Q, tile): forward rows, then reverse rows
  float* wx = xd + 2 * Q * tile; // (2*Q, C)
  float* wdt = wx + 2 * Q * C;   // (2, CB, R)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kColTW + tx, nth = kColTW * blockDim.y;
  const int w0 = blockIdx.x * kColTW, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int w = w0 + tx, c = c0 + ty;
  const bool active = w < W && c < C;
  const long L = (long)H * W;
  const T* xb = x + (long)b * C * L;

  for (int i = tid; i < 2 * Q * C; i += nth) {
    const int dir = i / (Q * C), j = i - dir * Q * C;
    wx[i] = (dir ? Wxr : Wxf)[j];
  }
  for (int i = tid; i < 2 * CB * R; i += nth) {
    const int dir = i / (CB * R), j = i - dir * CB * R;
    const int ch = c0 + j / R;
    wdt[i] = ch < C ? (dir ? Wdtr : Wdtf)[(long)c0 * R + j] : 0.f;
  }
  float bf = 0.f, br = 0.f, af[N], ar[N];
  float hf[N], swf[N], pr[N], acc[N], swr[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    af[n] = active ? Af[c * N + n] : 0.f;
    ar[n] = active ? Ar[c * N + n] : 0.f;
    hf[n] = 0.f;
    swf[n] = 0.f;
    pr[n] = 1.f;
    acc[n] = 0.f;
    swr[n] = 0.f;
  }
  if (active) {
    bf = biasf[c];
    br = biasr[c];
  }
  const float* wdf = wdt + ty * R;
  const float* wdr = wdt + (CB + ty) * R;

  for (int h0 = 0; h0 < H; h0 += TH) {
    const int nt = min(TH, H - h0);
    __syncthreads();  // the previous tile's readers are done
    col_stage<T>(xb, xs, xd, wx, C, H, W, h0, nt, w0, TH, 2 * Q, L);
    if (!active) continue;
    for (int t = 0; t < nt; ++t) {
      const int pix = t * kColTW + tx;
      const float xv = xs[c * tile + pix];
      float sf = 0.f, sr = 0.f;
      for (int r = 0; r < R; ++r) {
        sf = fmaf(wdf[r], xd[r * tile + pix], sf);
        sr = fmaf(wdr[r], xd[(Q + r) * tile + pix], sr);
      }
      const float dtf = softplus(sf + bf), dtr = softplus(sr + br);
      const float duf = dtf * xv, dur = dtr * xv;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float wf = fmaxf(dtf * af[n], kColClamp);
        hf[n] = fmaf(expf(wf), hf[n], duf * xd[(R + n) * tile + pix]);
        swf[n] += wf;
        const float wr = fmaxf(dtr * ar[n], kColClamp);
        acc[n] = fmaf(pr[n], dur * xd[(Q + R + n) * tile + pix], acc[n]);
        pr[n] *= expf(wr);
        swr[n] += wr;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const long j = ((long)b * C + c) * N * W + (long)n * W + w;
    sendf[j] = hf[n];
    stotf[j] = swf[n];
    sendr[j] = acc[n];
    stotr[j] = swr[n];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kColTW * kColMaxChan)
col_dir_kernel(const T* __restrict__ x, const float* __restrict__ Wx,
               const float* __restrict__ Wdt, const float* __restrict__ bias,
               const float* __restrict__ A, const float* __restrict__ D,
               const float* __restrict__ sinit, const T* __restrict__ yin,
               T* __restrict__ y, int C, int H, int W, int R, int CB, int TH, int rev) {
  extern __shared__ float smem[];
  const int P = R + 2 * N;
  const int tile = TH * kColTW;
  float* xs = smem;            // (C, tile)
  float* xd = xs + C * tile;   // (P, tile)
  float* wx = xd + P * tile;   // (P, C)
  float* wdt = wx + P * C;     // (CB, R)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kColTW + tx, nth = kColTW * blockDim.y;
  const int w0 = blockIdx.x * kColTW, c0 = blockIdx.y * CB, b = blockIdx.z;
  const int w = w0 + tx, c = c0 + ty;
  const bool active = w < W && c < C;
  const long L = (long)H * W;
  const long ib = (long)b * C * L;
  const T* xb = x + ib;
  const T* yinb = yin != nullptr ? yin + ib : nullptr;
  T* yb = y + ib;

  for (int i = tid; i < P * C; i += nth) wx[i] = Wx[i];
  for (int i = tid; i < CB * R; i += nth) wdt[i] = c0 + i / R < C ? Wdt[(long)c0 * R + i] : 0.f;
  float bc = 0.f, dc = 0.f, an[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = active ? A[c * N + n] : 0.f;
    h[n] = active ? sinit[((long)b * C + c) * N * W + (long)n * W + w] : 0.f;
  }
  if (active) {
    bc = bias[c];
    dc = D != nullptr ? D[c] : 0.f;
  }
  const float* wd = wdt + ty * R;

  const int ntiles = (H + TH - 1) / TH;
  for (int it = 0; it < ntiles; ++it) {
    const int h0 = (rev ? ntiles - 1 - it : it) * TH;
    const int nt = min(TH, H - h0);
    __syncthreads();
    col_stage<T>(xb, xs, xd, wx, C, H, W, h0, nt, w0, TH, P, L);
    if (!active) continue;
    for (int k = 0; k < nt; ++k) {
      const int t = rev ? nt - 1 - k : k;
      const int pix = t * kColTW + tx;
      const float xv = xs[c * tile + pix];
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = fmaf(wd[r], xd[r * tile + pix], s);
      const float dt = softplus(s + bc), du = dt * xv;
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float wv = fmaxf(dt * an[n], kColClamp);
        h[n] = fmaf(expf(wv), h[n], du * xd[(R + n) * tile + pix]);
        yv = fmaf(xd[(R + N + n) * tile + pix], h[n], yv);
      }
      if (D != nullptr) yv = fmaf(dc, xv, yv);
      const long j = (long)c * L + (long)(h0 + t) * W + w;
      if (yinb != nullptr) yv += IO<T>::load(yinb, j);
      IO<T>::store(yb, j, yv);
    }
  }
}

template <typename T, int N>
int launch_col_sum_n(const void* x, const float* const* wf, const float* const* wr,
                     float* const* out, int B, int C, int H, int W, int R,
                     cudaStream_t stream) {
  const int CB = col_chan_block(C), Q = R + N;
  const int TH = col_rows(C, 2, Q, CB, R);
  const size_t smem = col_smem_floats(C, TH, 2, Q, CB, R) * sizeof(float);
  cudaError_t e = allow_smem(col_sum_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kColTW - 1) / kColTW, (C + CB - 1) / CB, B);
  col_sum_kernel<T, N><<<grid, dim3(kColTW, CB), smem, stream>>>(
      static_cast<const T*>(x), wf[0], wf[1], wf[2], wf[3], wr[0], wr[1], wr[2], wr[3],
      out[0], out[1], out[2], out[3], C, H, W, R, CB, TH);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_col_dir_n(const void* x, const float* Wx, const float* Wdt, const float* bias,
                     const float* A, const float* D, const float* sinit, const void* yin,
                     void* y, int B, int C, int H, int W, int R, int rev,
                     cudaStream_t stream) {
  const int CB = col_chan_block(C), P = R + 2 * N;
  const int TH = col_rows(C, 1, P, CB, R);
  const size_t smem = col_smem_floats(C, TH, 1, P, CB, R) * sizeof(float);
  cudaError_t e = allow_smem(col_dir_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kColTW - 1) / kColTW, (C + CB - 1) / CB, B);
  col_dir_kernel<T, N><<<grid, dim3(kColTW, CB), smem, stream>>>(
      static_cast<const T*>(x), Wx, Wdt, bias, A, D, sinit, static_cast<const T*>(yin),
      static_cast<T*>(y), C, H, W, R, CB, TH, rev);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_col_sum(const void* x, const float* const* wf, const float* const* wr,
                   float* const* out, int B, int C, int H, int W, int R, int N,
                   cudaStream_t s) {
  switch (N) {
    case 1: return launch_col_sum_n<T, 1>(x, wf, wr, out, B, C, H, W, R, s);
    case 2: return launch_col_sum_n<T, 2>(x, wf, wr, out, B, C, H, W, R, s);
    case 4: return launch_col_sum_n<T, 4>(x, wf, wr, out, B, C, H, W, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_col_dir(const void* x, const float* Wx, const float* Wdt, const float* bias,
                   const float* A, const float* D, const float* sinit, const void* yin,
                   void* y, int B, int C, int H, int W, int R, int N, int rev,
                   cudaStream_t s) {
  switch (N) {
    case 1: return launch_col_dir_n<T, 1>(x, Wx, Wdt, bias, A, D, sinit, yin, y, B, C, H, W, R, rev, s);
    case 2: return launch_col_dir_n<T, 2>(x, Wx, Wdt, bias, A, D, sinit, yin, y, B, C, H, W, R, rev, s);
    case 4: return launch_col_dir_n<T, 4>(x, Wx, Wdt, bias, A, D, sinit, yin, y, B, C, H, W, R, rev, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bem

// Both directions' column summaries. send_* / stot_* (B, C, N*W) fp32,
// index [b][c][n*W + w].
extern "C" int bem_ss2d_col_sum(const void* x, const float* Wxf, const float* Wdtf,
                                const float* biasf, const float* Af, const float* Wxr,
                                const float* Wdtr, const float* biasr, const float* Ar,
                                float* sendf, float* stotf, float* sendr, float* stotr,
                                int B, int C, int H, int W, int R, int N, int bf16,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* wf[4] = {Wxf, Wdtf, biasf, Af};
  const float* wr[4] = {Wxr, Wdtr, biasr, Ar};
  float* out[4] = {sendf, stotf, sendr, stotr};
  if (bf16) return bem::launch_col_sum<__nv_bfloat16>(x, wf, wr, out, B, C, H, W, R, N, s);
  return bem::launch_col_sum<float>(x, wf, wr, out, B, C, H, W, R, N, s);
}

// One column direction from the entry states sinit (B, C, N*W); D and yin
// may be null. rev = 1 walks bottom-up (direction 3).
extern "C" int bem_ss2d_col_dir(const void* x, const float* Wx, const float* Wdt,
                                const float* bias, const float* A, const float* D,
                                const float* sinit, const void* yin, void* y, int B, int C,
                                int H, int W, int R, int N, int rev, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::launch_col_dir<__nv_bfloat16>(x, Wx, Wdt, bias, A, D, sinit, yin, y, B, C, H,
                                              W, R, N, rev, s);
  return bem::launch_col_dir<float>(x, Wx, Wdt, bias, A, D, sinit, yin, y, B, C, H, W, R, N,
                                    rev, s);
}
