// The 4-direction SS2D core over xs2 (B, 2, C, L): per stream s (row-major,
// column-major), direction k = s walks forward and k = s + 2 backward over
// the same sequence:
//   xdbl = Wx[k] . x                    (P = R + 2N rows: dt-rank | B | C)
//   dt   = softplus(Wdt[k] . xdbl[:R] + bias[k])
//   h_n  = exp(dt * A_n) * h_n + dt * x * B_n     (clamped: max(dt*A_n, -10))
//   y    = sum_n C_n h_n + D[k] x,   y2[:, s] = cast(cast(y_s) + cast(y_{s+2}))
// and its backward (lambda_t = g_t C_t + a_next lambda_next, opposite to
// each scan; ss2d_fused_bwd.py:15-21 lists every gradient).
//
// Replaces bem_tpu/ops/ss2d_fused.py::ss2d_dir_fused (Pallas body _fwd_body),
// bem_tpu/ops/ss2d_fused_g.py::ss2d_dir_fused_g (_fwd_body, the clamped
// form: the `clamp` flag here) and bem_tpu/ops/ss2d_fused_bwd.py::run_bwd
// (_bwd_body).
//
// Bound: the forward's exp per (position, channel, state) on the special
// function units and the projections' FMAs; the walk itself is a sequential
// recurrence whose latency only enough walkers in flight can hide. The TPU
// kernel projected, scanned (a blocked doubling scan with one-hot MXU
// matmuls) and read out per L-block in one body, carrying the state across
// an ordered grid. Here:
//  - the projections (xdbl, and in the backward dxdbl, dx, dWx, dWdt) run
//    on a batched, strided fp32 GEMM kernel (64x64 tiles through shared
//    memory), once per (image, stream, direction) instead of once per
//    channel block;
//  - the walk puts one thread on each (image, stream, channel) of one
//    direction, its N states in registers, and walks the sequence in
//    kCk-long chunks staged through shared memory (x, the chunk's
//    projection rows); the forward direction's launch writes the rounded
//    y_f, the reverse one adds its rounded y_r, so the merge needs no
//    buffer and no atomics;
//  - the forward can write the state entering every chunk (fp32
//    checkpoints, one per kCk positions). The backward's lambda recurrence,
//    lambda_t = g_t C_t + a_{t+1} lambda_{t+1} per (channel, state), runs
//    against the scan order as a chunked reverse scan, parallel along L
//    (the pattern of ss2d_seq.cu), with the checkpoints giving h in every
//    chunk at once:
//      bwd_sum_kernel   per chunk, (channel, state) and both directions, mu
//                       = a lambda at the chunk's first position, walked
//                       back from mu = 0 at its end, and the chunk's decay
//                       exp(sum of dt A) summed in log space. Carrying mu
//                       instead of lambda puts the factor that carries
//                       lambda into chunk k (a at chunk k+1's first
//                       position, one past chunk k's end) into chunk k+1's
//                       own summary, so each decay covers its chunk's own
//                       positions. No -10 clamp: the backward
//                       differentiates the unclamped function, also after a
//                       clamped forward.
//      linear_scan      (scan.cu, launched by ops/ss2d_fused.py) in reverse
//                       over the chunks of (B*2*2, nck, C*N): each chunk's
//                       mu, inclusive.
//      bwd_full_kernel  one block per (chunk, channel block, image and
//                       stream), one launch per direction, every chunk
//                       independent: h from the chunk's checkpoint, lambda
//                       from the next chunk's mu, every gradient term.
//    A thread takes one (channel, state): its state's h and decay over a
//    kSub-long sub-chunk sit in registers (recomputed from the sub-chunk's
//    entering state), dt is computed once per (channel, position) by the
//    whole block into shared memory, the sums over states (d/d dt, dx) by
//    a transposing butterfly across the channel's lanes after each
//    sub-chunk, the sums over channels (dB, dC) by shuffles within the
//    warp and an ordered pass over the block's warps. The sums over L (dA,
//    dbias, dD) are per-chunk partials; every cross-block sum (channel
//    blocks, chunks, images) is a separate, ordered pass, so the results
//    do not change from run to run (no atomics).
//    Occupancy (d_state 16, VMamba-T): 16 channels x 16 states = 256
//    threads a block; shared memory 33.4 KB at R = 6 and 41.7 KB at R = 48
//    (bwd_smem_floats); registers (build/nvcc_ss2d_fused.log) then set the
//    blocks per SM (PERF.md has the count).
#include "common.cuh"

namespace bem {

constexpr float kFusedClamp = -10.f;
constexpr int kCk = 32;          // scan positions per chunk and per checkpoint
constexpr int kFwdCB = 64;       // channels (one thread each) per forward block
constexpr int kBwdThreads = 256;  // threads of a backward block, one per (channel, state)
constexpr int kSub = 16;         // positions per backward sub-chunk (h in registers)
constexpr int kNSub = kCk / kSub;

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return round_bf16(v); }

// ---------------------------------------------------------------------------
// batched fp32 GEMM: C[z] (= or +=) A[z] (M x K) . B[z] (K x N), any strides

struct Operand {
  long rs, cs;      // element (r, c) at r * rs + c * cs
  long b0, b1, b2;  // batch z = (i0 * n1 + i1) * n2 + i2 adds i0 b0 + i1 b1 + i2 b2
};

struct GemmShape {
  int M, N, K, n1, n2, accumulate;
};

constexpr int kGM = 64, kGN = 64, kGK = 16, kGThreads = 256;

__device__ __forceinline__ long batch_off(const Operand& o, int z, int n1, int n2) {
  const int i2 = z % n2, i1 = (z / n2) % n1, i0 = z / (n1 * n2);
  return i0 * o.b0 + i1 * o.b1 + i2 * o.b2;
}

template <typename TB>
__global__ void __launch_bounds__(kGThreads)
gemm_kernel(const float* __restrict__ A, Operand oa, const TB* __restrict__ Bm, Operand ob,
            float* __restrict__ Cm, Operand oc, GemmShape sh) {
  __shared__ float As[kGK][kGM + 4];
  __shared__ float Bs[kGK][kGN + 4];
  const int z = blockIdx.z;
  const float* a = A + batch_off(oa, z, sh.n1, sh.n2);
  const TB* b = Bm + batch_off(ob, z, sh.n1, sh.n2);
  float* c = Cm + batch_off(oc, z, sh.n1, sh.n2);
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < sh.K; k0 += kGK) {
    // neighbouring threads load along whichever operand axis is contiguous
    for (int i = tid; i < kGM * kGK; i += kGThreads) {
      int mm, kk;
      if (oa.cs == 1) {
        mm = i / kGK;
        kk = i % kGK;
      } else {
        kk = i / kGM;
        mm = i % kGM;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < sh.M && gk < sh.K) ? a[gm * oa.rs + gk * oa.cs] : 0.f;
    }
    for (int i = tid; i < kGK * kGN; i += kGThreads) {
      int kk, nn;
      if (ob.cs == 1) {
        kk = i / kGN;
        nn = i % kGN;
      } else {
        nn = i / kGK;
        kk = i % kGK;
      }
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < sh.K && gn < sh.N) ? IO<TB>::load(b, gk * ob.rs + gn * ob.cs) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][tm + 16 * i];
        bv[i] = Bs[kk][tn + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + tm + 16 * i, gn = n0 + tn + 16 * j;
      if (gm < sh.M && gn < sh.N) {
        const long e = gm * oc.rs + gn * oc.cs;
        c[e] = sh.accumulate ? c[e] + acc[i][j] : acc[i][j];
      }
    }
}

template <typename TB>
int gemm(const float* A, Operand oa, const TB* Bm, Operand ob, float* Cm, Operand oc,
         GemmShape sh, int Z, cudaStream_t st) {
  dim3 grid((sh.N + kGN - 1) / kGN, (sh.M + kGM - 1) / kGM, Z);
  gemm_kernel<TB><<<grid, kGThreads, 0, st>>>(A, oa, Bm, ob, Cm, oc, sh);
  return (int)cudaGetLastError();
}

// out[q * out_q + r] = sum_{z < Z} in[q * in_q + z * zs + r], in z order
__global__ void sum_kernel(const float* __restrict__ in, float* __restrict__ out, int Z, long zs,
                           long nq, long in_q, long out_q, long nr) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= nq * nr) return;
  const long q = i / nr, r = i - q * nr;
  const float* p = in + q * in_q + r;
  float s = 0.f;
  for (int z = 0; z < Z; ++z) s += p[z * zs];
  out[q * out_q + r] = s;
}

int sum_over(const float* in, float* out, int Z, long zs, long nq, long in_q, long out_q, long nr,
             cudaStream_t st) {
  const long n = nq * nr;
  sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(in, out, Z, zs, nq, in_q, out_q, nr);
  return (int)cudaGetLastError();
}

// the projection xdbl[b, s, dir] (P x L) = Wx[s + 2 dir] (P x C) . x[b, s] (C x L)
template <typename T>
int project(const T* x, const float* Wx, float* xdbl, int B, int C, int L, int P,
            cudaStream_t st) {
  return gemm<T>(Wx, Operand{C, 1, 0, (long)P * C, 2L * P * C}, x,
                 Operand{L, 1, 2L * C * L, (long)C * L, 0}, xdbl,
                 Operand{L, 1, 4L * P * L, 2L * P * L, (long)P * L},
                 GemmShape{P, L, C, 2, 2, 0}, B * 4, st);
}

// scan index i of direction dir sits at position i (forward) or L-1-i
__device__ __forceinline__ long seq_pos(int dir, int L, int i) {
  return dir ? (long)L - 1 - i : (long)i;
}

// ---------------------------------------------------------------------------
// forward walk: one direction, one thread per (image, stream, channel)

inline size_t fwd_smem_floats(int R, int N) {
  return (size_t)kFwdCB * (kCk + 1) + (size_t)(R + 2 * N) * kCk + (size_t)kFwdCB * (R + 1);
}

template <typename T, int N>
__global__ void __launch_bounds__(kFwdCB)
fwd_walk_kernel(const T* __restrict__ x, const float* __restrict__ xdbl,
                const float* __restrict__ Wdt, const float* __restrict__ bias,
                const float* __restrict__ A, const float* __restrict__ D, T* __restrict__ y,
                float* __restrict__ ck, int C, int L, int R, int dir, int clamp) {
  extern __shared__ float smem[];
  const int P = R + 2 * N, TLp = kCk + 1;
  const int bs = blockIdx.y, s = bs & 1, k = s + 2 * dir;
  const int c0 = blockIdx.x * kFwdCB, nc = min(kFwdCB, C - c0);
  const int tid = threadIdx.x, c = c0 + tid;
  const bool valid = tid < nc;
  float* xs = smem;               // (kFwdCB, TLp): x, then y
  float* xd = xs + kFwdCB * TLp;  // (P, kCk): the chunk's projection rows
  float* wdt = xd + P * kCk;      // (kFwdCB, R + 1)
  const T* xb = x + (long)bs * C * L;
  T* yb = y + (long)bs * C * L;
  const float* xdb = xdbl + ((long)bs * 2 + dir) * P * L;
  for (int i = tid; i < kFwdCB * R; i += kFwdCB) {
    const int cc = i / R, r = i - cc * R;
    wdt[cc * (R + 1) + r] = cc < nc ? Wdt[((long)k * C + c0 + cc) * R + r] : 0.f;
  }
  float An[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    An[n] = valid ? A[((long)k * C + c) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float bk = valid ? bias[k * C + c] : 0.f, dk = valid ? D[k * C + c] : 0.f;
  const int nck = (L + kCk - 1) / kCk;
  for (int ci = 0; ci < nck; ++ci) {
    const int i0 = ci * kCk, nt = min(kCk, L - i0);
    if (ck != nullptr && valid) {
      float* cp = ck + ((((long)bs * 2 + dir) * nck + ci) * C + c) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) cp[n] = h[n];
    }
    for (int i = tid; i < kFwdCB * kCk; i += kFwdCB) {
      const int cc = i / kCk, j = i - cc * kCk;
      xs[cc * TLp + j] = (cc < nc && j < nt)
                             ? IO<T>::load(xb, (long)(c0 + cc) * L + seq_pos(dir, L, i0 + j))
                             : 0.f;
    }
    for (int i = tid; i < P * kCk; i += kFwdCB) {
      const int p = i / kCk, j = i - p * kCk;
      xd[i] = j < nt ? xdb[(long)p * L + seq_pos(dir, L, i0 + j)] : 0.f;
    }
    __syncthreads();
    if (valid) {
      const float* wr = wdt + tid * (R + 1);
      for (int j = 0; j < nt; ++j) {
        const float xv = xs[tid * TLp + j];
        float dtr = bk;
        for (int r = 0; r < R; ++r) dtr = fmaf(wr[r], xd[r * kCk + j], dtr);
        const float dt = softplus(dtr), du = dt * xv;
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float w = dt * An[n];
          if (clamp) w = fmaxf(w, kFusedClamp);
          h[n] = fmaf(expf(w), h[n], du * xd[(R + n) * kCk + j]);
          yv = fmaf(xd[(R + N + n) * kCk + j], h[n], yv);
        }
        xs[tid * TLp + j] = fmaf(dk, xv, yv);
      }
    }
    __syncthreads();
    for (int i = tid; i < nc * kCk; i += kFwdCB) {
      const int cc = i / kCk, j = i - cc * kCk;
      if (j >= nt) continue;
      const long e = (long)(c0 + cc) * L + seq_pos(dir, L, i0 + j);
      float v = xs[cc * TLp + j];
      // the reverse launch adds its rounded y_r to the forward's rounded y_f
      if (dir) v = IO<T>::load(yb, e) + round_to<T>(v);
      IO<T>::store(yb, e, v);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward: a chunked reverse scan, parallel along L (see the header)

// threads of a backward block: one per (channel, state), at most
// kBwdThreads; channels per block at most 64
__host__ __device__ constexpr int bwd_cb(int N) {
  return kBwdThreads / N < 64 ? kBwdThreads / N : 64;
}

// floats of shared memory: x (full pass), g, dt tiles (CB, kCk + 1) and the
// full pass's dt pre-activation and dx tiles; the chunk's projection rows
// (P, kCk + 1); the block's Wdt rows (CB, R + 1); the full pass's per-warp
// channel sums of dB | dC over a sub-chunk (warps, 2, N, kSub + 1). The
// odd row strides put a warp's N states (rows of xd and red) on distinct
// banks.
inline size_t bwd_smem_floats(int R, int N, bool full) {
  const size_t CB = bwd_cb(N), warps = (CB * N + 31) / 32;
  return (full ? 5 : 2) * CB * (kCk + 1) + (size_t)(R + 2 * N) * (kCk + 1) + CB * (R + 1) +
         (full ? warps * 2 * N * (kSub + 1) : 0);
}

// Lanes in groups of G (a power of 2 <= K): lane l of a group ends with the
// group's sums of v[(l % G) * (K / G) + i] in v[i], i < K / G (a transposing
// butterfly: K - K / G shuffles instead of K log2 G). Each stage is a
// template of its own, so every index is a constant and v stays in
// registers.
template <int K, int G>
__device__ __forceinline__ void group_transpose_sum(float (&v)[K], int lane) {
  if constexpr (G > 1) {
    constexpr int half = K / 2;
    const bool upper = lane & (G / 2);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, G / 2);
    }
    group_transpose_sum<half, G / 2>(reinterpret_cast<float(&)[half]>(v), lane);
  }
}

// the sum over the warp's lanes of the same state (lane % N)
template <int N>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int off = N; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct BwdTile {
  int bs, dir, k, ci, nck, c0, nc, i0, nt;
};

// Stage one chunk (kCk positions of scan order from i0) of one (image,
// stream, direction) and channel block: g (and x) tiles, the projection
// rows, the Wdt rows; then dt (and its pre-activation) of every (channel,
// position), each once, by all threads.
template <int N>
__device__ __forceinline__ void bwd_stage(const BwdTile& tl, const float* __restrict__ x,
                                          const float* __restrict__ g,
                                          const float* __restrict__ xdbl,
                                          const float* __restrict__ Wdt,
                                          const float* __restrict__ bias, float* xs, float* gs,
                                          float* dts, float* drs, float* xd, float* wdt, int C,
                                          int L, int R) {
  constexpr int CB = bwd_cb(N), NT = CB * N, TLp = kCk + 1;
  const int tid = threadIdx.x, P = R + 2 * N;
  for (int i = tid; i < CB * R; i += NT) {
    const int cc = i / R, r = i - cc * R;
    wdt[cc * (R + 1) + r] = cc < tl.nc ? Wdt[((long)tl.k * C + tl.c0 + cc) * R + r] : 0.f;
  }
  const long base = (long)tl.bs * C * L;
  for (int i = tid; i < CB * kCk; i += NT) {
    const int cc = i / kCk, j = i - cc * kCk;
    const bool ok = cc < tl.nc && j < tl.nt;
    const long e = base + (long)(tl.c0 + cc) * L + seq_pos(tl.dir, L, tl.i0 + j);
    gs[cc * TLp + j] = ok ? g[e] : 0.f;
    if (xs != nullptr) xs[cc * TLp + j] = ok ? x[e] : 0.f;
  }
  const float* xdb = xdbl + ((long)tl.bs * 2 + tl.dir) * P * L;
  for (int i = tid; i < P * kCk; i += NT) {
    const int p = i / kCk, j = i - p * kCk;
    xd[p * TLp + j] = j < tl.nt ? xdb[(long)p * L + seq_pos(tl.dir, L, tl.i0 + j)] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < CB * kCk; i += NT) {
    const int cc = i / kCk, j = i - cc * kCk;
    const float* wr = wdt + cc * (R + 1);
    float dtr = cc < tl.nc ? bias[tl.k * C + tl.c0 + cc] : 0.f;
    for (int r = 0; r < R; ++r) dtr = fmaf(wr[r], xd[r * TLp + j], dtr);
    dts[cc * TLp + j] = softplus(dtr);
    if (drs != nullptr) drs[cc * TLp + j] = dtr;
  }
  __syncthreads();
}

__device__ __forceinline__ BwdTile bwd_tile(int bs, int dir, int C, int L, int CB) {
  BwdTile t;
  t.bs = bs;
  t.dir = dir;
  t.k = (bs & 1) + 2 * dir;
  t.ci = blockIdx.x;
  t.nck = gridDim.x;
  t.c0 = blockIdx.y * CB;
  t.nc = min(CB, C - t.c0);
  t.i0 = t.ci * kCk;
  t.nt = min(kCk, L - t.i0);
  return t;
}

// Summary pass, both directions (blockIdx.z = bs * 2 + dir): per chunk and
// (channel, state), walked back from mu = 0 at its end, mu = a_{i0}
// lambda_{i0} and the chunk's decay exp(sum of dt A) over its own positions.
// Layout (B*2*2, nck, C*N): the carry's rows.
template <int N>
__global__ void __launch_bounds__(bwd_cb(N) * N)
bwd_sum_kernel(const float* __restrict__ g, const float* __restrict__ xdbl,
               const float* __restrict__ Wdt, const float* __restrict__ bias,
               const float* __restrict__ A, float* __restrict__ aprod, float* __restrict__ msum,
               int C, int L, int R) {
  constexpr int CB = bwd_cb(N), TLp = kCk + 1;
  extern __shared__ float smem[];
  const int P = R + 2 * N, z = blockIdx.z;
  const BwdTile tl = bwd_tile(z >> 1, z & 1, C, L, CB);
  float* gs = smem;
  float* dts = gs + CB * TLp;
  float* xd = dts + CB * TLp;
  float* wdt = xd + P * TLp;
  bwd_stage<N>(tl, nullptr, g, xdbl, Wdt, bias, nullptr, gs, dts, nullptr, xd, wdt, C, L, R);
  const int tc = threadIdx.x / N, tn = threadIdx.x % N, c = tl.c0 + tc;
  if (tc >= tl.nc) return;
  const float An = A[((long)tl.k * C + c) * N + tn];
  float m = 0.f, sw = 0.f;
  for (int j = tl.nt - 1; j >= 0; --j) {
    const float w = dts[tc * TLp + j] * An;
    m = expf(w) * fmaf(gs[tc * TLp + j], xd[(R + N + tn) * TLp + j], m);
    sw += w;
  }
  const long o = ((long)z * tl.nck + tl.ci) * C * N + (long)c * N + tn;
  aprod[o] = expf(sw);
  msum[o] = m;
}

// Full pass of one direction: every chunk from its checkpoint (h) and from
// mu of the chunk after it (the carry's inclusive state, 0 for the last).
template <int N>
__global__ void __launch_bounds__(bwd_cb(N) * N)
bwd_full_kernel(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ xdbl, const float* __restrict__ Wdt,
                const float* __restrict__ bias, const float* __restrict__ A,
                const float* __restrict__ D, const float* __restrict__ ck,
                const float* __restrict__ carry, float* __restrict__ dx,
                float* __restrict__ ddtr, float* __restrict__ bcpart, float* __restrict__ vpart,
                int B, int C, int L, int R, int dir) {
  constexpr int CB = bwd_cb(N), NT = CB * N, TLp = kCk + 1, NW = (NT + 31) / 32;
  extern __shared__ float smem[];
  const int P = R + 2 * N, nblk = gridDim.y;
  const BwdTile tl = bwd_tile(blockIdx.z, dir, C, L, CB);
  const int bs = tl.bs, b = bs >> 1, blk = blockIdx.y;
  float* xs = smem;                // x
  float* gs = xs + CB * TLp;       // g
  float* dts = gs + CB * TLp;      // dt, then (per sub-chunk walked) d loss / d dt
  float* drs = dts + CB * TLp;     // dt pre-activation, then d loss / d pre-activation
  float* dxs = drs + CB * TLp;     // the scan's part of dx
  float* xd = dxs + CB * TLp;      // (P, TLp)
  float* wdt = xd + P * TLp;       // (CB, R + 1)
  float* red = wdt + CB * (R + 1);  // (NW, 2, N, kSub + 1)
  bwd_stage<N>(tl, x, g, xdbl, Wdt, bias, xs, gs, dts, drs, xd, wdt, C, L, R);
  const int tid = threadIdx.x, tc = tid / N, tn = tid % N, lane = tid & 31, warp = tid >> 5;
  const int c = tl.c0 + tc;
  const bool valid = tc < tl.nc;
  const long row = (long)bs * 2 + dir;
  const float An = valid ? A[((long)tl.k * C + c) * N + tn] : 0.f;
  const float h_in = valid ? ck[((row * tl.nck + tl.ci) * C + c) * N + tn] : 0.f;
  float m = valid && tl.ci + 1 < tl.nck ? carry[((row * tl.nck + tl.ci + 1) * C + c) * N + tn]
                                        : 0.f;
  const float* xr = xs + tc * TLp;
  const float* gr = gs + tc * TLp;
  float* dtr = dts + tc * TLp;
  const float* Bn = xd + (R + tn) * TLp;
  const float* Cn = xd + (R + N + tn) * TLp;
  // positions past L hold x = g = 0 and projection rows 0: they add nothing
  // and leave mu = 0 (they lie only in the last chunk)
  float h_sub1 = h_in;  // the state entering the second sub-chunk
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float dt = dtr[j];
    h_sub1 = fmaf(expf(dt * An), h_sub1, dt * xr[j] * Bn[j]);
  }
  float dA = 0.f;
  for (int sub = kNSub - 1; sub >= 0; --sub) {
    const int jb = sub * kSub;
    float hs[kSub], aa[kSub], pd[kSub], px[kSub];
    const float h0 = sub ? h_sub1 : h_in;
    float h = h0;
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) {
      const float dt = dtr[jb + jj];
      aa[jj] = expf(dt * An);
      hs[jj] = h = fmaf(aa[jj], h, dt * xr[jb + jj] * Bn[jb + jj]);
    }
#pragma unroll
    for (int jj = kSub - 1; jj >= 0; --jj) {
      const int j = jb + jj;
      const float gv = gr[j], xv = xr[j], dt = dtr[j], bn = Bn[j];
      const float lam = fmaf(gv, Cn[j], m);
      const float a = aa[jj];
      const float daa = lam * (jj ? hs[jj - 1] : h0) * a;
      pd[jj] = fmaf(daa, An, lam * xv * bn);  // d loss / d dt, this state's part
      px[jj] = lam * dt * bn;                 // dx, this state's part
      dA = fmaf(daa, dt, dA);
      const float vb = channel_sum<N>(lam * dt * xv);  // dB_n: lambda du over channels
      const float vc = channel_sum<N>(gv * hs[jj]);     // dC_n: g h over channels
      if (lane < N) {
        red[((warp * 2) * N + tn) * (kSub + 1) + jj] = vb;
        red[((warp * 2 + 1) * N + tn) * (kSub + 1) + jj] = vc;
      }
      m = a * lam;
    }
    // the sums over states; the warp's shuffles order this after its reads of dt
    group_transpose_sum<kSub, N>(pd, lane);
    group_transpose_sum<kSub, N>(px, lane);
#pragma unroll
    for (int i = 0; i < kSub / N; ++i) {
      const int j = jb + tn * (kSub / N) + i;
      dtr[j] = pd[i];
      dxs[tc * TLp + j] = px[i];
    }
    __syncthreads();
    for (int e = tid; e < 2 * N * kSub; e += NT) {
      const int jj = e % kSub, qn = e / kSub;  // qn = kind * N + n
      if (jb + jj >= tl.nt) continue;
      float sum = 0.f;
      for (int w = 0; w < NW; ++w) sum += red[(w * 2 * N + qn) * (kSub + 1) + jj];
      bcpart[((bs * (long)nblk + blk) * 2 * N + qn) * L + seq_pos(dir, L, tl.i0 + jb + jj)] = sum;
    }
    __syncthreads();
  }
  const long base = (long)bs * C * L;
  float* ddb = ddtr + row * C * L;
  for (int i = tid; i < tl.nc * kCk; i += NT) {
    const int cc = i / kCk, j = i - cc * kCk;
    if (j >= tl.nt) continue;
    const float dd = dts[cc * TLp + j] / (1.f + expf(-drs[cc * TLp + j]));  // * sigmoid
    const float dxv = fmaf(D[tl.k * C + tl.c0 + cc], gs[cc * TLp + j], dxs[cc * TLp + j]);
    const long e = (long)(tl.c0 + cc) * L + seq_pos(dir, L, tl.i0 + j);
    drs[cc * TLp + j] = dd;
    ddb[e] = dd;
    // the reverse direction's launch adds to the forward's dx
    dx[base + e] = dir ? dx[base + e] + dxv : dxv;
  }
  __syncthreads();
  if (!valid) return;
  // per-chunk partial sums over positions: dA | dbias | dD at
  // vpart[k][b][ci][c][N + 2]
  float* vp = vpart + (((long)tl.k * B + b) * tl.nck + tl.ci) * C * (N + 2) + (long)c * (N + 2);
  vp[tn] = dA;
  if (tn == 0) {
    float db = 0.f, dd = 0.f;
    for (int j = 0; j < tl.nt; ++j) {
      db += drs[tc * TLp + j];
      dd = fmaf(gr[j], xr[j], dd);
    }
    vp[N] = db;
    vp[N + 1] = dd;
  }
}

// ---------------------------------------------------------------------------
// entry points

template <typename T, int N>
int fwd_n(const T* x, const float* Wx, const float* Wdt, const float* bias, const float* A,
          const float* D, float* xdbl, T* y, float* ck, int B, int C, int L, int R, int clamp,
          cudaStream_t st) {
  const int P = R + 2 * N;
  int e = project<T>(x, Wx, xdbl, B, C, L, P, st);
  if (e) return e;
  const size_t smem = fwd_smem_floats(R, N) * sizeof(float);
  cudaError_t ce = allow_smem(fwd_walk_kernel<T, N>, smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((C + kFwdCB - 1) / kFwdCB, B * 2);
  for (int dir = 0; dir < 2; ++dir) {
    fwd_walk_kernel<T, N><<<grid, kFwdCB, smem, st>>>(x, xdbl, Wdt, bias, A, D, y, ck, C, L, R,
                                                     dir, clamp);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

template <typename T>
int fwd_t(const void* x, const float* Wx, const float* Wdt, const float* bias, const float* A,
          const float* D, float* xdbl, void* y, float* ck, int B, int C, int L, int R, int N,
          int clamp, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (N) {
    case 1: return fwd_n<T, 1>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 2: return fwd_n<T, 2>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 4: return fwd_n<T, 4>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 8: return fwd_n<T, 8>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 16: return fwd_n<T, 16>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int N>
int bwd_sum_n(const float* x, const float* g, const float* Wx, const float* Wdt,
              const float* bias, const float* A, float* xdbl, float* aprod, float* msum, int B,
              int C, int L, int R, cudaStream_t st) {
  int e = project<float>(x, Wx, xdbl, B, C, L, R + 2 * N, st);
  if (e) return e;
  const size_t smem = bwd_smem_floats(R, N, false) * sizeof(float);
  cudaError_t ce = allow_smem(bwd_sum_kernel<N>, smem);
  if (ce != cudaSuccess) return (int)ce;
  constexpr int CB = bwd_cb(N);
  dim3 grid((L + kCk - 1) / kCk, (C + CB - 1) / CB, B * 4);
  bwd_sum_kernel<N><<<grid, CB * N, smem, st>>>(g, xdbl, Wdt, bias, A, aprod, msum, C, L, R);
  return (int)cudaGetLastError();
}

template <int N>
int bwd_n(const float* x, const float* g, const float* Wx, const float* Wdt, const float* bias,
          const float* A, const float* D, const float* ck, const float* carry, const float* xdbl,
          float* ddtr, float* bcpart, float* dxdbl, float* wpart, float* wpart2, float* vpart,
          float* vtmp, float* dx, float* dWx, float* dWdt, float* v, int B, int C, int L, int R,
          cudaStream_t st) {
  constexpr int CB = bwd_cb(N);
  const int P = R + 2 * N, nblk = (C + CB - 1) / CB, nck = (L + kCk - 1) / kCk;
  const long PL = (long)P * L, CL = (long)C * L, PC = (long)P * C, CR = (long)C * R;
  int e;
  const size_t smem = bwd_smem_floats(R, N, true) * sizeof(float);
  cudaError_t ce = allow_smem(bwd_full_kernel<N>, smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid(nck, nblk, B * 2);
  for (int dir = 0; dir < 2; ++dir) {
    bwd_full_kernel<N><<<grid, CB * N, smem, st>>>(x, g, xdbl, Wdt, bias, A, D, ck, carry, dx,
                                                   ddtr, bcpart, vpart, B, C, L, R, dir);
    if ((e = (int)cudaGetLastError())) return e;
    // dB | dC rows of dxdbl[b, s, dir]: the channel blocks' partial sums
    if ((e = sum_over(bcpart, dxdbl + dir * PL + R * L, nblk, 2L * N * L, 2L * B,
                      (long)nblk * 2 * N * L, 2 * PL, 2L * N * L, st)))
      return e;
  }
  // dt-rank rows of dxdbl[b, s, dir] (R x L) = Wdt[k]^T (R x C) . ddtr[b, s, dir] (C x L)
  if ((e = gemm<float>(Wdt, Operand{1, R, 0, CR, 2 * CR}, ddtr, Operand{L, 1, 4 * CL, 2 * CL, CL},
                       dxdbl, Operand{L, 1, 4 * PL, 2 * PL, PL}, GemmShape{R, L, C, 2, 2, 0},
                       B * 4, st)))
    return e;
  // dx[b, s] += Wx[k]^T (C x P) . dxdbl[b, s, dir] (P x L), one direction at a time
  for (int dir = 0; dir < 2; ++dir)
    if ((e = gemm<float>(Wx + dir * 2 * PC, Operand{1, C, 0, PC, 0}, dxdbl + dir * PL,
                         Operand{L, 1, 4 * PL, 2 * PL, 0}, dx, Operand{L, 1, 2 * CL, CL, 0},
                         GemmShape{C, L, P, 2, 1, 1}, B * 2, st)))
      return e;
  // per image: dWx[k] (P x C) = dxdbl (P x L) . x^T (L x C), dWdt[k] (C x R) =
  // ddtr (C x L) . xdbl[:R]^T (L x R), stored at k = 2 dir + s; then summed over images
  if ((e = gemm<float>(dxdbl, Operand{L, 1, 4 * PL, 2 * PL, PL}, x, Operand{1, L, 2 * CL, CL, 0},
                       wpart, Operand{C, 1, 4 * PC, PC, 2 * PC}, GemmShape{P, C, L, 2, 2, 0},
                       B * 4, st)))
    return e;
  if ((e = gemm<float>(ddtr, Operand{L, 1, 4 * CL, 2 * CL, CL}, xdbl,
                       Operand{1, L, 4 * PL, 2 * PL, PL}, wpart2, Operand{R, 1, 4 * CR, CR, 2 * CR},
                       GemmShape{C, R, L, 2, 2, 0}, B * 4, st)))
    return e;
  if ((e = sum_over(wpart, dWx, B, 4 * PC, 1, 0, 0, 4 * PC, st))) return e;
  if ((e = sum_over(wpart2, dWdt, B, 4 * CR, 1, 0, 0, 4 * CR, st))) return e;
  // dA | dbias | dD: the chunks' partial sums, then the images', each in order
  const long nv = (long)C * (N + 2);
  if ((e = sum_over(vpart, vtmp, nck, nv, 4L * B, nck * nv, nv, nv, st))) return e;
  return sum_over(vtmp, v, B, nv, 4, B * nv, nv, nv, st);
}

}  // namespace bem

extern "C" int bem_ss2d_fused_fwd(const void* x, const float* Wx, const float* Wdt,
                                  const float* bias, const float* A, const float* D, float* xdbl,
                                  void* y, float* ck, int B, int C, int L, int R, int N,
                                  int clamp, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::fwd_t<__nv_bfloat16>(x, Wx, Wdt, bias, A, D, xdbl, y, ck, B, C, L, R, N, clamp,
                                     s);
  return bem::fwd_t<float>(x, Wx, Wdt, bias, A, D, xdbl, y, ck, B, C, L, R, N, clamp, s);
}

// Channels per block of the backward passes at N states; the caller sizes
// the per-block dB | dC partial sums by it.
extern "C" int bem_ss2d_fused_bwd_cb(int N) { return N >= 1 ? bem::bwd_cb(N) : 0; }

#define BEM_BY_N(CALL)                                         \
  switch (N) {                                                 \
    case 1: return CALL(1);                                    \
    case 2: return CALL(2);                                    \
    case 4: return CALL(4);                                    \
    case 8: return CALL(8);                                    \
    case 16: return CALL(16);                                  \
    default: return (int)cudaErrorInvalidValue;                \
  }

// Backward pass 1: the projection xdbl (B, 2, 2, P, L) and both directions'
// chunk summaries, aprod / msum (B*2*2, nck, C*N) with nck = ceil(L / 32):
// each chunk's decay and mu from 0 (the carry's a and b, in reverse).
extern "C" int bem_ss2d_fused_bwd_sum(const float* x, const float* g, const float* Wx,
                                      const float* Wdt, const float* bias, const float* A,
                                      float* xdbl, float* aprod, float* msum, int B, int C,
                                      int L, int R, int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define BEM_SUM(NN) bem::bwd_sum_n<NN>(x, g, Wx, Wdt, bias, A, xdbl, aprod, msum, B, C, L, R, s)
  BEM_BY_N(BEM_SUM)
#undef BEM_SUM
}

// Backward pass 3 and the gradients: carry (B*2*2, nck, C*N), the reverse
// linear_scan of pass 1's summaries; xdbl from pass 1. Outputs dx
// (B, 2, C, L), dWx (4, P, C), dWdt (4, C, R), v (4, C, N + 2) = dA | dbias
// | dD; the rest is scratch.
extern "C" int bem_ss2d_fused_bwd(const float* x, const float* g, const float* Wx,
                                  const float* Wdt, const float* bias, const float* A,
                                  const float* D, const float* ck, const float* carry,
                                  const float* xdbl, float* ddtr, float* bcpart, float* dxdbl,
                                  float* wpart, float* wpart2, float* vpart, float* vtmp,
                                  float* dx, float* dWx, float* dWdt, float* v, int B, int C,
                                  int L, int R, int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define BEM_BWD(NN)                                                                          \
  bem::bwd_n<NN>(x, g, Wx, Wdt, bias, A, D, ck, carry, xdbl, ddtr, bcpart, dxdbl, wpart,      \
                 wpart2, vpart, vtmp, dx, dWx, dWdt, v, B, C, L, R, s)
  BEM_BY_N(BEM_BWD)
#undef BEM_BWD
}
#undef BEM_BY_N
