// The SS2D column scans (cross2d directions 1 and 3) over the ROW-major
// channel-first stream x (B, C, H*W), with the dt / B / C projections
// computed in-kernel as in ss2d_seq.cu:
//   xdbl = Wx . x,  dt = softplus(Wdt . xdbl[:R] + bias)
//   w_n  = max(dt * A_n, -10),  a_n = exp(w_n),  b_n = dt * x * B_n
// Direction 1 walks the flattened column-major sequence top-down, column by
// column, carrying its state from the bottom of column w into the top of
// column w+1; direction 3 walks the same sequence backwards. The pair
// returns round(y_r + round(y_f + (D_f + D_r) x + y0)) in the stream dtype,
// the rounding points of bem_tpu/ops/ss2d_seq.py::ss2d_col_pair_g (D2 =
// D.at[d_f].add(D[d_r]) at :569; its first pass stores y_f + D2 x + y0,
// the second adds y_r to that stored value, :577-580).
//
// Replaces bem_tpu/ops/ss2d_seq.py::_run_col_sum (Pallas body
// _col_sum_body) and ::_run_col_dir (body _col_body, launched once per
// direction). The Pallas grid walked th-row slabs in order with the column
// state in scratch. Here each column is cut into chunks of T rows and the
// pair runs as a chunked, parallel-in-H scan, the pattern of ss2d_seq.cu:
//   col_sum_kernel   (row 5) one block per (16 columns, chunk(s), image)
//                    with ALL C channels: it stages a chunk's x tile once
//                    and computes both directions' dt-rank and B rows once
//                    per pixel; each thread takes ceil(C / 32) channels of
//                    one column (at most 512 threads: two blocks an SM)
//                    and walks the chunk's rows top-down,
//                    computing for BOTH directions the chunk's decay
//                    exp(sum of clamped log-decays) and its end state from
//                    0: forward, the state at the chunk's bottom row;
//                    reverse (bottom-up), its state at the chunk's top row,
//                    evaluated in the same top-down walk as the prefix sum
//                    acc += P b, P *= a. Where chunks are short (C160), a
//                    block takes col_sum_cpb consecutive chunks of its
//                    columns, staging the weights once, and restarts the
//                    summary at each. The lanes of a warp are channels of
//                    one column, so the summaries' stores are coalesced.
//   linear_scan      (scan.cu, launched by ops/ss2d_seq.py) over the
//                    column-major sequence of chunks, index w * nch + k,
//                    forward for direction 1 and reverse for 3: it joins the
//                    cross-column carry and the cross-chunk carry, giving
//                    every chunk's inclusive state.
//   col_full_kernel  (row 6) one block per (16 columns, chunk, image) with
//                    ALL C channels: it stages the chunk's x tile once (in
//                    the stream dtype) and both directions' projection rows
//                    once, so no channel slice recomputes them; each thread
//                    takes ceil(C / 64) channels of one column and walks
//                    direction 1 top-down from its entry state (the
//                    inclusive state of chunk j - 1), keeping
//                    round(y_f + Dsum x + y0) in shared memory in the
//                    stream dtype (the rounding point itself), then
//                    direction 3 bottom-up from chunk j + 1's state, and
//                    stores round(y_r + that) once.
// Bound: bytes (one read of x in each pass, the y0 read, the y write; the
// chunk summaries add 10 floats per chunk and (column, channel, state)).
// What holds the passes above it is the per-pixel arithmetic: the
// projection (2 P C FMAs a pixel, once) and, per channel and direction,
// dt's softplus and N exps.
//
// The chunk length T is kColChunk = 32, halved (col_chunk) while the full
// pass's shared memory exceeds kColSmem; bem_ss2d_col_chunk gives it to
// the caller, which sizes the summaries by it and passes it to both passes.
#include "common.cuh"

namespace bem {

constexpr float kColClamp = -10.f;
constexpr size_t kColSmem = 110 * 1024;  // two blocks fit on an SM
constexpr int kColChunk = 32;      // rows per chunk, before halving
constexpr int kFullTW = 16;        // both passes: columns per block
constexpr int kFullMaxTY = 64;     // col_full: threads per column at most
constexpr int kSumMaxTY = 32;      // col_sum: threads per column at most
constexpr int kSumRows = 8;        // col_sum: rows a block takes at least, in whole chunks

// threads per column, each taking ceil(C / cap) channels
inline int threads_y(int C, int cap) {
  const int per = (C + cap - 1) / cap;
  return (C + per - 1) / per;
}

// the Wdt rows' stride in shared memory: odd, so the two channels of a
// warp read distinct banks
__host__ __device__ inline int full_rstride(int R) { return R | 1; }

// bytes of col_full's shared memory at T rows: the x tile and the stored
// first rounding point, each (C, T*TW + TW) in the stream dtype (the pad
// puts a warp's two channels on distinct banks), both directions'
// projection rows (2P, T*TW), their Wx rows (2P, C) and Wdt rows (2, C, Rs)
inline size_t full_smem_bytes(int C, int T, int R, int N, size_t es) {
  const size_t P = R + 2 * N;
  return 2 * (size_t)C * (T + 1) * kFullTW * es +
         sizeof(float) * (2 * P * T * kFullTW + 2 * P * C + (size_t)2 * C * full_rstride(R));
}

inline int col_chunk(int C, int R, int N, size_t es) {
  int T = kColChunk;
  while (T > 1 && full_smem_bytes(C, T, R, N, es) > kColSmem) T /= 2;
  return T;
}

// col_sum's x tile row stride in stream-dtype elements: T*TW and a pad
// that makes it odd in 32-bit words, so the channels of a warp (one
// column) read distinct banks
inline __host__ __device__ int sum_xstride(int TT, size_t es) {
  return es == 2 ? TT + 2 : TT + 1;
}

// bytes of col_sum's shared memory at T rows: both directions' dt-rank and
// B rows (2Q, T*TW), their Wx rows (2Q, C) and Wdt rows (2, C, Rs) fp32,
// the x tile (C, sum_xstride) in the stream dtype; at most col_full's
inline size_t sum_smem_bytes(int C, int T, int R, int N, size_t es) {
  const size_t Q = R + N, TT = (size_t)T * kFullTW;
  return sizeof(float) * (2 * Q * TT + 2 * Q * C + (size_t)2 * C * full_rstride(R)) +
         (size_t)C * sum_xstride((int)TT, es) * es;
}

// chunks of TC rows a col_sum block takes: kSumRows rows' worth, halved
// while the grid would hold fewer than two blocks an SM
inline int col_sum_cpb(int TC, int nch, int W, int B) {
  int cpb = TC < kSumRows ? kSumRows / TC : 1;
  const long tiles = (long)((W + kFullTW - 1) / kFullTW) * B;
  while (cpb > 1 && tiles * ((nch + cpb - 1) / cpb) < 2L * kCardSMs) cpb /= 2;
  return cpb;
}

struct ColDir {
  const float *Wx, *Wdt, *bias, *A;
};

// Summaries per chunk of TC rows, (B, W*nch, C*N) fp32 at
// [b][w*nch + k][c*N + n]: af / ar the chunk's decay, bf / br its end
// state from 0 (forward: at the chunk's bottom row; reverse: at its top).
// One block per (16 columns, cpb consecutive chunks, image), all channels.
template <typename T, int N>
__global__ void __launch_bounds__(kFullTW * kSumMaxTY, 2)
col_sum_kernel(const T* __restrict__ x, ColDir f, ColDir r, float* __restrict__ af,
               float* __restrict__ bf, float* __restrict__ ar, float* __restrict__ br, int C,
               int H, int W, int R, int TC, int nch, int cpb) {
  extern __shared__ float smem[];
  const int Q = R + N, Rs = full_rstride(R);  // dt-rank and B rows: no C rows needed
  const int TT = TC * kFullTW, XS = sum_xstride(TT, sizeof(T));
  float* xd = smem;                // (2Q, TT): forward rows, then reverse rows
  float* wx = xd + 2 * Q * TT;     // (2Q, C)
  float* wdt = wx + 2 * Q * C;     // (2, C, Rs)
  T* xs = reinterpret_cast<T*>(wdt + 2 * C * Rs);  // (C, XS) in the stream dtype
  const int tid = threadIdx.x, nth = blockDim.x, TY = nth / kFullTW;
  const int col = tid / TY, slot = tid - col * TY;  // a warp's lanes: channels of one column
  const int w0 = blockIdx.x * kFullTW, b = blockIdx.z, w = w0 + col;
  const long L = (long)H * W, CN = (long)C * N;
  const T* xb = x + (long)b * C * L;

  for (int i = tid; i < 2 * Q * C; i += nth) {
    const int dir = i / (Q * C), j = i - dir * Q * C;
    wx[i] = (dir ? r.Wx : f.Wx)[j];
  }
  for (int i = tid; i < 2 * C * R; i += nth) {
    const int dir = i / (C * R), j = i - dir * C * R, c = j / R;
    wdt[(dir * C + c) * Rs + j - c * R] = (dir ? r.Wdt : f.Wdt)[j];
  }
  for (int kk = 0; kk < cpb; ++kk) {
    const int k = blockIdx.y * cpb + kk;
    if (k >= nch) break;  // the same for the whole block
    const int h0 = k * TC, nt = min(TC, H - h0);
    __syncthreads();  // the weights are staged; the previous chunk's readers are done
    for (int i = tid; i < C * TT; i += nth) {
      const int c = i / TT, pix = i - c * TT;
      const int t = pix / kFullTW, ww = w0 + pix - t * kFullTW;
      xs[c * XS + pix] = (t < nt && ww < W) ? xb[(long)c * L + (long)(h0 + t) * W + ww]
                                             : IO<T>::to(0.f);
    }
    __syncthreads();
    for (int i = tid; i < 2 * Q * TT; i += nth) {
      const int q = i / TT, pix = i - q * TT;
      const float* wr = wx + q * C;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = fmaf(wr[c], IO<T>::from(xs[c * XS + pix]), s);
      xd[i] = s;
    }
    __syncthreads();
    if (w >= W) continue;
    for (int c = slot; c < C; c += TY) {
      const float* wdf = wdt + c * Rs;
      const float* wdr = wdt + (C + c) * Rs;
      const float bfv = f.bias[c], brv = r.bias[c];
      float afn[N], arn[N], hf[N], swf[N], pr[N], acc[N], swr[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        afn[n] = f.A[c * N + n];
        arn[n] = r.A[c * N + n];
        hf[n] = swf[n] = acc[n] = swr[n] = 0.f;
        pr[n] = 1.f;
      }
      for (int t = 0; t < nt; ++t) {
        const int pix = t * kFullTW + col;
        const float xv = IO<T>::from(xs[c * XS + pix]);
        float sf = 0.f, sr = 0.f;
        for (int q = 0; q < R; ++q) {
          sf = fmaf(wdf[q], xd[q * TT + pix], sf);
          sr = fmaf(wdr[q], xd[(Q + q) * TT + pix], sr);
        }
        const float dtf = softplus(sf + bfv), dtr = softplus(sr + brv);
        const float duf = dtf * xv, dur = dtr * xv;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float wf = fmaxf(dtf * afn[n], kColClamp);
          hf[n] = fmaf(expf(wf), hf[n], duf * xd[(R + n) * TT + pix]);
          swf[n] += wf;
          const float wr = fmaxf(dtr * arn[n], kColClamp);
          acc[n] = fmaf(pr[n], dur * xd[(Q + R + n) * TT + pix], acc[n]);
          pr[n] *= expf(wr);
          swr[n] += wr;
        }
      }
      const long o = (((long)b * W + w) * nch + k) * CN + (long)c * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        af[o + n] = expf(swf[n]);
        bf[o + n] = hf[n];
        ar[o + n] = expf(swr[n]);
        br[o + n] = acc[n];
      }
    }
  }
}

// One chunk of TC rows x 16 columns of one image, both directions, all
// channels (see the header); hf / hr the carry's inclusive chunk states in
// the summaries' layout, y0 may be null.
template <typename T, int N>
__global__ void __launch_bounds__(kFullTW * kFullMaxTY)
col_full_kernel(const T* __restrict__ x, ColDir f, ColDir r, const float* __restrict__ Dsum,
                const float* __restrict__ hf, const float* __restrict__ hr,
                const T* __restrict__ y0, T* __restrict__ y, int C, int H, int W, int R,
                int TC, int nch) {
  extern __shared__ float smem[];
  const int P = R + 2 * N, Rs = full_rstride(R);
  const int TT = TC * kFullTW, XS = TT + kFullTW;
  float* xd = smem;                    // (2P, TT): forward rows, then reverse rows
  float* wx = xd + 2 * P * TT;         // (2P, C)
  float* wdt = wx + 2 * P * C;         // (2, C, Rs)
  T* xs = reinterpret_cast<T*>(wdt + 2 * C * Rs);  // (C, XS) in the stream dtype
  T* ys = xs + C * XS;  // (C, XS): round(y_f + Dsum x + y0), the stream dtype
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kFullTW + tx, nth = kFullTW * blockDim.y;
  const int w0 = blockIdx.x * kFullTW, k = blockIdx.y, b = blockIdx.z;
  const int h0 = k * TC, nt = min(TC, H - h0);
  const long L = (long)H * W;
  const T* xb = x + (long)b * C * L;

  for (int i = tid; i < 2 * P * C; i += nth) {
    const int dir = i / (P * C), j = i - dir * P * C;
    wx[i] = (dir ? r.Wx : f.Wx)[j];
  }
  for (int i = tid; i < 2 * C * R; i += nth) {
    const int dir = i / (C * R), j = i - dir * C * R, c = j / R;
    wdt[(dir * C + c) * Rs + j - c * R] = (dir ? r.Wdt : f.Wdt)[j];
  }
  for (int i = tid; i < C * TT; i += nth) {
    const int c = i / TT, pix = i - c * TT;
    const int t = pix / kFullTW, w = w0 + pix - t * kFullTW;
    xs[c * XS + pix] = (t < nt && w < W) ? xb[(long)c * L + (long)(h0 + t) * W + w]
                                         : IO<T>::to(0.f);
  }
  __syncthreads();
  for (int i = tid; i < 2 * P * TT; i += nth) {
    const int q = i / TT, pix = i - q * TT;
    const float* wr = wx + q * C;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(wr[c], IO<T>::from(xs[c * XS + pix]), s);
    xd[i] = s;
  }
  __syncthreads();

  const int w = w0 + tx;
  if (w >= W) return;
  const long CN = (long)C * N, j = (long)w * nch + k, seq = (long)W * nch;
  const float* hfb = hf + (long)b * seq * CN;
  const float* hrb = hr + (long)b * seq * CN;
  for (int c = ty; c < C; c += blockDim.y) {
    const T* xc = xs + c * XS;
    T* yc = ys + c * XS;
    const long yb = ((long)b * C + c) * L + (long)h0 * W + w;
    float h[N], an[N];
    // direction 1, top-down from the inclusive state of chunk j - 1
    {
      const float* wd = wdt + c * Rs;
      const float bias = f.bias[c], ds = Dsum[c];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        an[n] = f.A[c * N + n];
        h[n] = j > 0 ? hfb[(j - 1) * CN + c * N + n] : 0.f;
      }
      for (int t = 0; t < nt; ++t) {
        const int pix = t * kFullTW + tx;
        const float xv = IO<T>::from(xc[pix]);
        float s = bias;
        for (int q = 0; q < R; ++q) s = fmaf(wd[q], xd[q * TT + pix], s);
        const float dt = softplus(s), du = dt * xv;
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float wv = fmaxf(dt * an[n], kColClamp);
          h[n] = fmaf(expf(wv), h[n], du * xd[(R + n) * TT + pix]);
          yv = fmaf(xd[(R + N + n) * TT + pix], h[n], yv);
        }
        yv = fmaf(ds, xv, yv);
        if (y0 != nullptr) yv += IO<T>::load(y0, yb + (long)t * W);
        yc[pix] = IO<T>::to(yv);  // the first rounding point
      }
    }
    // direction 3, bottom-up from the inclusive state of chunk j + 1
    {
      const float* xq = xd + P * TT;
      const float* wd = wdt + (C + c) * Rs;
      const float bias = r.bias[c];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        an[n] = r.A[c * N + n];
        h[n] = j + 1 < seq ? hrb[(j + 1) * CN + c * N + n] : 0.f;
      }
      for (int t = nt - 1; t >= 0; --t) {
        const int pix = t * kFullTW + tx;
        const float xv = IO<T>::from(xc[pix]);
        float s = bias;
        for (int q = 0; q < R; ++q) s = fmaf(wd[q], xq[q * TT + pix], s);
        const float dt = softplus(s), du = dt * xv;
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float wv = fmaxf(dt * an[n], kColClamp);
          h[n] = fmaf(expf(wv), h[n], du * xq[(R + n) * TT + pix]);
          yv = fmaf(xq[(R + N + n) * TT + pix], h[n], yv);
        }
        IO<T>::store(y, yb + (long)t * W, yv + IO<T>::from(yc[pix]));
      }
    }
  }
}

template <typename T, int N>
int launch_col_sum_n(const void* x, ColDir f, ColDir r, float* const* out, int B, int C,
                     int H, int W, int R, int TC, cudaStream_t stream) {
  const size_t smem = sum_smem_bytes(C, TC, R, N, sizeof(T));
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(col_sum_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nch = (H + TC - 1) / TC, cpb = col_sum_cpb(TC, nch, W, B);
  dim3 grid((W + kFullTW - 1) / kFullTW, (nch + cpb - 1) / cpb, B);
  col_sum_kernel<T, N><<<grid, kFullTW * threads_y(C, kSumMaxTY), smem, stream>>>(
      static_cast<const T*>(x), f, r, out[0], out[1], out[2], out[3], C, H, W, R, TC, nch, cpb);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_col_full_n(const void* x, ColDir f, ColDir r, const float* Dsum, const float* hf,
                      const float* hr, const void* y0, void* y, int B, int C, int H, int W,
                      int R, int TC, cudaStream_t stream) {
  const size_t smem = full_smem_bytes(C, TC, R, N, sizeof(T));
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(col_full_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nch = (H + TC - 1) / TC;
  dim3 grid((W + kFullTW - 1) / kFullTW, nch, B);
  col_full_kernel<T, N><<<grid, dim3(kFullTW, threads_y(C, kFullMaxTY)), smem, stream>>>(
      static_cast<const T*>(x), f, r, Dsum, hf, hr, static_cast<const T*>(y0),
      static_cast<T*>(y), C, H, W, R, TC, nch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_col_sum(const void* x, ColDir f, ColDir r, float* const* out, int B, int C, int H,
                   int W, int R, int N, int TC, cudaStream_t s) {
  switch (N) {
    case 1: return launch_col_sum_n<T, 1>(x, f, r, out, B, C, H, W, R, TC, s);
    case 2: return launch_col_sum_n<T, 2>(x, f, r, out, B, C, H, W, R, TC, s);
    case 4: return launch_col_sum_n<T, 4>(x, f, r, out, B, C, H, W, R, TC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_col_full(const void* x, ColDir f, ColDir r, const float* Dsum, const float* hf,
                    const float* hr, const void* y0, void* y, int B, int C, int H, int W, int R,
                    int N, int TC, cudaStream_t s) {
  switch (N) {
    case 1: return launch_col_full_n<T, 1>(x, f, r, Dsum, hf, hr, y0, y, B, C, H, W, R, TC, s);
    case 2: return launch_col_full_n<T, 2>(x, f, r, Dsum, hf, hr, y0, y, B, C, H, W, R, TC, s);
    case 4: return launch_col_full_n<T, 4>(x, f, r, Dsum, hf, hr, y0, y, B, C, H, W, R, TC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bem

// Rows per chunk of both passes at C channels, R dt-rank rows, N states
// and the stream dtype; the caller sizes the chunk summaries by it.
extern "C" int bem_ss2d_col_chunk(int C, int R, int N, int bf16) {
  return bem::col_chunk(C, R, N, bf16 ? 2 : 4);
}

// Pass 1: both directions' chunk summaries, each (B, W*nch, C*N) fp32 with
// nch = ceil(H / TC): the chunk's decay and its end state from 0.
extern "C" int bem_ss2d_col_sum(const void* x, const float* Wxf, const float* Wdtf,
                                const float* biasf, const float* Af, const float* Wxr,
                                const float* Wdtr, const float* biasr, const float* Ar,
                                float* af, float* bf, float* ar, float* br, int B, int C,
                                int H, int W, int R, int N, int TC, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bem::ColDir f{Wxf, Wdtf, biasf, Af}, r{Wxr, Wdtr, biasr, Ar};
  float* out[4] = {af, bf, ar, br};
  if (TC < 1) return (int)cudaErrorInvalidValue;
  if (bf16) return bem::launch_col_sum<__nv_bfloat16>(x, f, r, out, B, C, H, W, R, N, TC, s);
  return bem::launch_col_sum<float>(x, f, r, out, B, C, H, W, R, N, TC, s);
}

// Pass 3: both directions from the carry's inclusive chunk states hf / hr
// (the summaries' layout), y = round(y_r + round(y_f + Dsum x + y0)); y0
// may be null.
extern "C" int bem_ss2d_col_full(const void* x, const float* Wxf, const float* Wdtf,
                                 const float* biasf, const float* Af, const float* Wxr,
                                 const float* Wdtr, const float* biasr, const float* Ar,
                                 const float* Dsum, const float* hf, const float* hr,
                                 const void* y0, void* y, int B, int C, int H, int W, int R,
                                 int N, int TC, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bem::ColDir f{Wxf, Wdtf, biasf, Af}, r{Wxr, Wdtr, biasr, Ar};
  if (TC < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return bem::launch_col_full<__nv_bfloat16>(x, f, r, Dsum, hf, hr, y0, y, B, C, H, W, R, N,
                                               TC, s);
  return bem::launch_col_full<float>(x, f, r, Dsum, hf, hr, y0, y, B, C, H, W, R, N, TC, s);
}
