// Both directions of the SS2D selective scan over ONE channel-first
// sequence x (B, C, L), with the dt / B / C projections computed in-kernel:
//   xdbl = Wx . x                       (R + 2N rows: dt-rank | B | C)
//   dt   = softplus(Wdt . xdbl[:R] + bias)
//   w_n  = max(dt * A_n, -10),  h_n = exp(w_n) * h_n + dt * x * B_n   (fp32)
//   y_d  = sum_n C_n * h_n
// The forward direction walks from position 0 up, the reverse one from L-1
// down; the state carries across the whole flattened sequence. The pair
// returns round(y_f) + y_r + (D_f + D_r) * x in the stream dtype (y_f is
// rounded to the stream dtype before it is added, as the Pallas pair's
// y_f round trip does).
//
// Replaces bem_tpu/ops/ss2d_seq.py::ss2d_seq_pair_g (Pallas body _dir_body
// :54, launched by _run_dir :148 once per direction). The Pallas kernel
// scans each L-block in parallel (log-decay prefix sums on segment
// matrices) and carries only the block's end state from block to block.
//
// Bound: bytes. The passes read x twice (summary and full pass) and write
// y once; the chunk summaries and entry states, (B, L/T, C*N) fp32, add a
// fraction of that (at T = 32 and bf16 x, 4N/T of x's bytes per array).
// What holds the kernel above that bound is the per-position arithmetic
// done by 2C walkers of a block: the projection rows, dt's softplus and N
// exps a position and direction, computed in both passes.
//
// Design: the sequence is cut into chunks of T positions (T = kSeqChunk =
// 32, the fastest of 32 / 64 / 128 / 256 on an H100, halved by seq_chunk
// where a wide C would overflow shared memory) and walked as a chunked,
// parallel-in-L scan, as scan.cu and ss2d_col.cu do:
//   1. seq_sum_kernel: one block per (image, chunk) stages the chunk's x
//      tile with all C channels in shared memory (coalesced along L),
//      computes the projection rows once for both directions, and one
//      walker per (direction, channel) walks the chunk from h = 0. It
//      writes, per (image, chunk, channel, state), the chunk's decay
//      exp(sum of clamped log-decays) -- summed in log space, so a
//      product of factors near e^-10 goes to 0 through one exp, with no
//      chain of denormals -- and its end state from 0 (reverse: the state
//      at the chunk's lowest position, walked back to front).
//   2. The carry, a launch of its own (not fused into pass 3 by a
//      decoupled look-back): ops/ss2d_seq.py runs linear_scan (scan.cu)
//      over the chunk summaries, (B, nchunks, C*N) fp32, forward for d_f
//      and reverse for d_r, giving each chunk's inclusive state.
//   3. seq_full_kernel: one block per (image, chunk) stages the tile
//      again; each walker starts from its neighbour chunk's inclusive
//      state (forward: chunk k-1, reverse: chunk k+1, 0 at the ends) and
//      re-walks its chunk. Both directions run in the same block, into two
//      shared-memory y tiles, which the block merges and stores coalesced.
// The parallelism is B * nchunks * 2C walkers instead of B * C, each
// reading its operands from shared memory; the sequential part of a
// walker is one FMA a step and state; the rest of a step (dt's softplus,
// the decay's exp, the input and readout terms) does not depend on it.
#include "common.cuh"

namespace bem {

constexpr float kLogDecayClamp = -10.f;
constexpr int kSeqMaxThreads = 512;
constexpr int kSeqChunk = 32;  // positions per chunk

// threads of a block: one walker per (direction, channel), at least 128
// for the staging loops, at most kSeqMaxThreads (walkers then loop)
inline int seq_threads(int C) {
  const int w = (2 * C + 31) / 32 * 32;
  return w < 128 ? 128 : (w > kSeqMaxThreads ? kSeqMaxThreads : w);
}

// the Wdt rows' stride in shared memory: odd, so walkers of consecutive
// channels read distinct banks
__host__ __device__ inline int seq_rstride(int R) { return R | 1; }

// floats of shared memory: x tile (C, T+1), projection rows (2Q, T), Wx
// rows of both directions (2Q, C), their Wdt rows (2, C, Rs); the full
// pass (Q = P) adds the two y tiles (2, C, T+1)
inline size_t seq_smem_floats(int C, int TL, int R, int Q, bool full) {
  const size_t TLp = TL + 1;
  return (size_t)C * TLp * (full ? 3 : 1) + (size_t)2 * Q * TL + (size_t)2 * Q * C +
         (size_t)2 * C * seq_rstride(R);
}

// positions per chunk at C channels: kSeqChunk, halved while the full
// pass's shared memory exceeds the budget
inline int seq_chunk(int C, int R, int N) {
  int TL = kSeqChunk;
  while (TL > 16 && seq_smem_floats(C, TL, R, R + 2 * N, true) * sizeof(float) > kSmemBudget)
    TL /= 2;
  return TL;
}

struct SeqDir {
  const float *Wx, *Wdt, *bias, *A;
};

// Stage the chunk [l0, l0 + nt) of every channel, the weights' first Q
// rows of both directions, and the projection rows xd[d*Q + q][t].
template <typename T>
__device__ __forceinline__ void seq_stage(const T* __restrict__ xb, const SeqDir& f,
                                          const SeqDir& r, float* xs, float* xd, float* wx,
                                          float* wdt, int C, long L, int R, int Q, int TL,
                                          long l0, int nt) {
  const int tid = threadIdx.x, nth = blockDim.x, TLp = TL + 1, Rs = seq_rstride(R);
  for (int i = tid; i < 2 * Q * C; i += nth) {
    const int d = i / (Q * C), j = i - d * Q * C;
    wx[i] = (d ? r.Wx : f.Wx)[j];
  }
  for (int i = tid; i < 2 * C * R; i += nth) {
    const int d = i / (C * R), j = i - d * C * R, c = j / R;
    wdt[(d * C + c) * Rs + j - c * R] = (d ? r.Wdt : f.Wdt)[j];
  }
  for (int i = tid; i < C * TL; i += nth) {
    const int c = i / TL, t = i - c * TL;
    xs[c * TLp + t] = t < nt ? IO<T>::load(xb, (long)c * L + l0 + t) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < 2 * Q * TL; i += nth) {
    const int q = i / TL, t = i - q * TL;
    const float* wr = wx + q * C;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(wr[c], xs[c * TLp + t], s);
    xd[i] = s;
  }
  __syncthreads();
}

// dt at position t of one walker: softplus(Wdt_c . xdbl[:R] + bias_c).
__device__ __forceinline__ float seq_dt(const float* wdr, const float* xdq, int R, int TL,
                                        int t, float bias) {
  float s = 0.f;
  for (int k = 0; k < R; ++k) s = fmaf(wdr[k], xdq[k * TL + t], s);
  return softplus(s + bias);
}

template <typename T, int N>
__global__ void __launch_bounds__(kSeqMaxThreads)
seq_sum_kernel(const T* __restrict__ x, SeqDir f, SeqDir r, float* __restrict__ af,
               float* __restrict__ bf, float* __restrict__ ar, float* __restrict__ br, int C,
               int L, int R, int TL, int nch) {
  extern __shared__ float smem[];
  const int Q = R + N, TLp = TL + 1, Rs = seq_rstride(R);  // no C rows needed
  float* xs = smem;               // (C, TLp)
  float* xd = xs + C * TLp;       // (2Q, TL): forward rows, then reverse rows
  float* wx = xd + 2 * Q * TL;    // (2Q, C)
  float* wdt = wx + 2 * Q * C;    // (2, C, Rs)
  const int k = blockIdx.x, b = blockIdx.y;
  const long l0 = (long)k * TL;
  const int nt = (int)min((long)TL, (long)L - l0);
  seq_stage<T>(x + (long)b * C * L, f, r, xs, xd, wx, wdt, C, L, R, Q, TL, l0, nt);

  for (int wi = threadIdx.x; wi < 2 * C; wi += blockDim.x) {
    const int d = wi / C, c = wi - d * C;
    const SeqDir g = d ? r : f;
    const float* xdq = xd + d * Q * TL;
    const float* wdr = wdt + (d * C + c) * Rs;
    const float bias = g.bias[c];
    float an[N], h[N], sw[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      an[n] = g.A[c * N + n];
      h[n] = 0.f;
      sw[n] = 0.f;
    }
    for (int s = 0; s < nt; ++s) {
      const int t = d ? nt - 1 - s : s;
      const float dt = seq_dt(wdr, xdq, R, TL, t, bias);
      const float du = dt * xs[c * TLp + t];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float w = fmaxf(dt * an[n], kLogDecayClamp);
        h[n] = fmaf(expf(w), h[n], du * xdq[(R + n) * TL + t]);
        sw[n] += w;
      }
    }
    float* ao = d ? ar : af;
    float* bo = d ? br : bf;
    const long j = (((long)b * nch + k) * C + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ao[j + n] = expf(sw[n]);
      bo[j + n] = h[n];
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kSeqMaxThreads)
seq_full_kernel(const T* __restrict__ x, SeqDir f, SeqDir r, const float* __restrict__ Dsum,
                const float* __restrict__ hf, const float* __restrict__ hr,
                T* __restrict__ y, int C, int L, int R, int TL, int nch) {
  extern __shared__ float smem[];
  const int P = R + 2 * N, TLp = TL + 1, Rs = seq_rstride(R);
  float* xs = smem;               // (C, TLp)
  float* yf = xs + C * TLp;       // (C, TLp): the forward direction's y
  float* yr = yf + C * TLp;       // (C, TLp): the reverse one's, with D x
  float* xd = yr + C * TLp;       // (2P, TL)
  float* wx = xd + 2 * P * TL;    // (2P, C)
  float* wdt = wx + 2 * P * C;    // (2, C, Rs)
  const int k = blockIdx.x, b = blockIdx.y;
  const long l0 = (long)k * TL;
  const int nt = (int)min((long)TL, (long)L - l0);
  const long base = (long)b * C * L;
  seq_stage<T>(x + base, f, r, xs, xd, wx, wdt, C, L, R, P, TL, l0, nt);

  for (int wi = threadIdx.x; wi < 2 * C; wi += blockDim.x) {
    const int d = wi / C, c = wi - d * C;
    const SeqDir g = d ? r : f;
    const float* xdq = xd + d * P * TL;
    const float* wdr = wdt + (d * C + c) * Rs;
    const float bias = g.bias[c];
    // the entry state: the inclusive state of the chunk walked just before
    const int kin = d ? k + 1 : k - 1;
    const bool has_in = kin >= 0 && kin < nch;
    const float* hin = (d ? hr : hf) + (((long)b * nch + kin) * C + c) * N;
    float an[N], h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      an[n] = g.A[c * N + n];
      h[n] = has_in ? hin[n] : 0.f;
    }
    const float dc = d ? Dsum[c] : 0.f;
    float* yo = (d ? yr : yf) + c * TLp;
    for (int s = 0; s < nt; ++s) {
      const int t = d ? nt - 1 - s : s;
      const float xv = xs[c * TLp + t];
      const float dt = seq_dt(wdr, xdq, R, TL, t, bias);
      const float du = dt * xv;
      float yv = dc * xv;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float w = fmaxf(dt * an[n], kLogDecayClamp);
        h[n] = fmaf(expf(w), h[n], du * xdq[(R + n) * TL + t]);
        yv = fmaf(xdq[(R + N + n) * TL + t], h[n], yv);
      }
      yo[t] = yv;
    }
  }
  __syncthreads();
  T* yb = y + base;
  for (int i = threadIdx.x; i < C * TL; i += blockDim.x) {
    const int c = i / TL, t = i - c * TL;
    if (t >= nt) continue;
    // y_f in the stream dtype, then the fp32 sum, rounded once more
    const float vf = IO<T>::round(yf[c * TLp + t]);
    IO<T>::store(yb, (long)c * L + l0 + t, vf + yr[c * TLp + t]);
  }
}

template <typename K>
inline cudaError_t seq_prepare(K kernel, size_t smem) {
  if (smem > kSmemBudget) return cudaErrorInvalidValue;
  return allow_smem(kernel, smem);
}

template <typename T, int N>
int launch_seq_sum_n(const void* x, SeqDir f, SeqDir r, float* af, float* bf, float* ar,
                     float* br, int B, int C, int L, int R, cudaStream_t stream) {
  const int TL = seq_chunk(C, R, N);
  const size_t smem = seq_smem_floats(C, TL, R, R + N, false) * sizeof(float);
  cudaError_t e = seq_prepare(seq_sum_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nch = (L + TL - 1) / TL;
  seq_sum_kernel<T, N><<<dim3(nch, B), seq_threads(C), smem, stream>>>(
      static_cast<const T*>(x), f, r, af, bf, ar, br, C, L, R, TL, nch);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_seq_full_n(const void* x, SeqDir f, SeqDir r, const float* Dsum, const float* hf,
                      const float* hr, void* y, int B, int C, int L, int R,
                      cudaStream_t stream) {
  const int TL = seq_chunk(C, R, N);
  const size_t smem = seq_smem_floats(C, TL, R, R + 2 * N, true) * sizeof(float);
  cudaError_t e = seq_prepare(seq_full_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nch = (L + TL - 1) / TL;
  seq_full_kernel<T, N><<<dim3(nch, B), seq_threads(C), smem, stream>>>(
      static_cast<const T*>(x), f, r, Dsum, hf, hr, static_cast<T*>(y), C, L, R, TL, nch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_seq_sum(const void* x, SeqDir f, SeqDir r, float* af, float* bf, float* ar,
                   float* br, int B, int C, int L, int R, int N, cudaStream_t s) {
  switch (N) {
    case 1: return launch_seq_sum_n<T, 1>(x, f, r, af, bf, ar, br, B, C, L, R, s);
    case 2: return launch_seq_sum_n<T, 2>(x, f, r, af, bf, ar, br, B, C, L, R, s);
    case 4: return launch_seq_sum_n<T, 4>(x, f, r, af, bf, ar, br, B, C, L, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_seq_full(const void* x, SeqDir f, SeqDir r, const float* Dsum, const float* hf,
                    const float* hr, void* y, int B, int C, int L, int R, int N,
                    cudaStream_t s) {
  switch (N) {
    case 1: return launch_seq_full_n<T, 1>(x, f, r, Dsum, hf, hr, y, B, C, L, R, s);
    case 2: return launch_seq_full_n<T, 2>(x, f, r, Dsum, hf, hr, y, B, C, L, R, s);
    case 4: return launch_seq_full_n<T, 4>(x, f, r, Dsum, hf, hr, y, B, C, L, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bem

// Positions per chunk of both passes at C channels, R dt-rank rows and N
// states; the caller sizes the chunk summaries by it.
extern "C" int bem_ss2d_seq_chunk(int C, int R, int N) { return bem::seq_chunk(C, R, N); }

// Pass 1: both directions' chunk summaries, each (B, nch, C*N) fp32 with
// nch = ceil(L / bem_ss2d_seq_chunk(C, R, N)): the chunk's decay
// a = exp(sum w) and its end state b from 0 (reverse: the state at the
// chunk's first position).
extern "C" int bem_ss2d_seq_sum(const void* x, const float* Wxf, const float* Wdtf,
                                const float* biasf, const float* Af, const float* Wxr,
                                const float* Wdtr, const float* biasr, const float* Ar,
                                float* af, float* bf, float* ar, float* br, int B, int C,
                                int L, int R, int N, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bem::SeqDir f{Wxf, Wdtf, biasf, Af}, r{Wxr, Wdtr, biasr, Ar};
  if (bf16)
    return bem::launch_seq_sum<__nv_bfloat16>(x, f, r, af, bf, ar, br, B, C, L, R, N, s);
  return bem::launch_seq_sum<float>(x, f, r, af, bf, ar, br, B, C, L, R, N, s);
}

// Pass 3: both directions re-walked from the chunks' entry states (hf / hr:
// the inclusive states of the carry scans), y = round(y_f) + y_r + Dsum x.
extern "C" int bem_ss2d_seq_full(const void* x, const float* Wxf, const float* Wdtf,
                                 const float* biasf, const float* Af, const float* Wxr,
                                 const float* Wdtr, const float* biasr, const float* Ar,
                                 const float* Dsum, const float* hf, const float* hr, void* y,
                                 int B, int C, int L, int R, int N, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bem::SeqDir f{Wxf, Wdtf, biasf, Af}, r{Wxr, Wdtr, biasr, Ar};
  if (bf16)
    return bem::launch_seq_full<__nv_bfloat16>(x, f, r, Dsum, hf, hr, y, B, C, L, R, N, s);
  return bem::launch_seq_full<float>(x, f, r, Dsum, hf, hr, y, B, C, L, R, N, s);
}
