// Fused selective scan over precomputed dt, B, C (channel-first, L minor).
//
// Replaces bem_tpu/ops/scan_fused.py::selective_scan_fused (its Pallas
// kernel from _make_kernel :60, pallas_call at scan_fused.py:120): the SS2D
// core of the scan-pattern forward types v051d / v052d. u, dt, y are
// (M, C, L) and B, C (M, N, L) in the stream dtype (fp32 or bf16), with
// M = batch * K directions; A is (K*C, N), D and the dt bias (K*C,), fp32,
// indexed by k = m mod K (never broadcast over the batch in memory). Per
// (m, c), from h = 0:
//   dt  = softplus(dt + bias)          (optional)
//   h_n = exp(dt * A_n) * h_n + (dt * u) * B_n
//   y   = sum_n C_n h_n  (n = 0 .. N-1)  + D * u,   rounded once to y's dtype
// There is NO -10 clamp on dt*A here, unlike the SS2D scan pairs.
//
// Bound: a sequential recurrence per (m, c, n), whose latency only enough
// walkers in flight can hide (the card's bound counts an exp, a multiply
// and the two FMAs per element and state at the fp32 rate; bytes bound it
// at the path's shapes). The Pallas kernel scanned 4096-position blocks by
// doubling and carried h between blocks in VMEM. Here the scan is chunked
// and parallel along L, the pattern of the fused core's forward
// (ss2d_fused.cu; the rule and constants in common.cuh): super-chunks of
// S positions, S a multiple of kCk = 32 (super_chunk: the fewest whose
// full-pass threads, M * C * fwd_groups(N), fill the card, each at least
// two chunks long):
//   scan_sum_kernel   where L > S: per (m, super-chunk) and (channel,
//                     state), the decay 2^(sum of dt A_n log2 e) and the
//                     end state from h = 0, in the (M, nsc, C*N) layout;
//   linear_scan       (scan.cu, launched by ops/scan_fused.py) forward over
//                     the super-chunks: the state leaving each;
//   scan_full_kernel  every super-chunk at once from the state entering it
//                     (0 for the first), writing y.
// At batch 128 (v052d throughput) M * C * 4 threads already fill the card:
// S >= L, no summary pass and no carry. Both passes stage kCk positions of
// u and dt for the block's 64 channels (coalesced along L) and the B (and
// C) rows once for all of them, with dt = softplus(dt + bias) computed once
// per (channel, position) into shared memory; a channel's N states sit on
// fwd_groups(N) adjacent lanes, kFwdStates each in registers, y summed over
// them by shuffles; a decay is one ex2.approx.ftz of dt A_n log2 e (no
// clamp; results below 2^-126 flush to 0), instead of expf's eight
// instructions; y = sum + D u is rounded once and stored coalesced. Rows
// padded by one word: a warp's channels and a group's states read distinct
// banks.
#include "common.cuh"

namespace bem {

constexpr int kSfCB = 64;  // channels per block

struct SfTile {
  int m, k, c0, nc, j, i0, i1;  // super-chunk j covers positions [i0, i1)
};

__device__ __forceinline__ SfTile sf_tile(int K, int C, int L, int S) {
  SfTile t;
  t.m = blockIdx.z;
  t.k = t.m % K;
  t.c0 = blockIdx.y * kSfCB;
  t.nc = min(kSfCB, C - t.c0);
  t.j = blockIdx.x;
  t.i0 = t.j * S;
  t.i1 = min(L, t.i0 + S);
  return t;
}

// Stage the nt positions from l0: u and dt = [softplus](dt + bias) of the
// block's channels (kSfCB, kCk + 1), the N rows of B and (cs non-null) of C
// (N, kCk + 1); zero past nt and past the block's channels.
template <typename T>
__device__ __forceinline__ void sf_stage(const SfTile& tl, const T* __restrict__ u,
                                         const T* __restrict__ dt, const T* __restrict__ Bm,
                                         const T* __restrict__ Cm, const float* __restrict__ bias,
                                         float* us, float* dts, float* bs, float* cs, int C,
                                         int N, int L, int l0, int nt, int softplus_on) {
  constexpr int TLp = kCk + 1;
  const long row0 = ((long)tl.m * C + tl.c0) * L + l0;
  for (int i = threadIdx.x; i < kSfCB * kCk; i += blockDim.x) {
    const int cc = i / kCk, j = i - cc * kCk;
    float uv = 0.f, dv = 0.f;
    if (cc < tl.nc && j < nt) {
      const long e = row0 + (long)cc * L + j;
      uv = IO<T>::load(u, e);
      dv = IO<T>::load(dt, e);
      if (bias != nullptr) dv += bias[tl.k * C + tl.c0 + cc];
      if (softplus_on) dv = softplus(dv);
    }
    us[cc * TLp + j] = uv;
    dts[cc * TLp + j] = dv;
  }
  const long bc0 = (long)tl.m * N * L + l0;
  for (int i = threadIdx.x; i < N * kCk; i += blockDim.x) {
    const int n = i / kCk, j = i - n * kCk;
    const long e = bc0 + (long)n * L + j;
    bs[n * TLp + j] = j < nt ? IO<T>::load(Bm, e) : 0.f;
    if (cs != nullptr) cs[n * TLp + j] = j < nt ? IO<T>::load(Cm, e) : 0.f;
  }
  __syncthreads();
}

// Summary pass: per super-chunk and (channel, state), the decay 2^(sum of
// w), w = dt A_n log2 e, and the end state from h = 0; (M, nsc, C*N).
template <typename T, int N>
__global__ void __launch_bounds__(kSfCB * fwd_groups(N))
scan_sum_kernel(const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const float* __restrict__ bias,
                float* __restrict__ aprod, float* __restrict__ hend, int K, int C, int L, int S,
                int softplus_on) {
  constexpr int G = fwd_groups(N), NG = N / G, TLp = kCk + 1;
  __shared__ float us[kSfCB * TLp], dts[kSfCB * TLp], bs[N * TLp];
  const SfTile tl = sf_tile(K, C, L, S);
  const int tid = threadIdx.x, tc = tid / G, n0 = (tid % G) * NG, c = tl.c0 + tc;
  const bool valid = tc < tl.nc;
  float An[NG], h[NG], sw[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    An[i] = valid ? A[((long)tl.k * C + c) * N + n0 + i] * kLog2e : 0.f;
    h[i] = sw[i] = 0.f;
  }
  const float* Bn = bs + n0 * TLp;
  for (int l0 = tl.i0; l0 < tl.i1; l0 += kCk) {
    const int nt = min(kCk, tl.i1 - l0);
    sf_stage<T>(tl, u, dt, Bm, nullptr, bias, us, dts, bs, nullptr, C, N, L, l0, nt,
                softplus_on);
    for (int j = 0; j < nt; ++j) {
      const float d = dts[tc * TLp + j], du = d * us[tc * TLp + j];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float w = d * An[i];
        h[i] = fmaf(exp2_ftz(w), h[i], du * Bn[i * TLp + j]);
        sw[i] += w;
      }
    }
    __syncthreads();  // the chunk's readers are done before the next is staged
  }
  if (!valid) return;
  const long o = (((long)tl.m * gridDim.x + tl.j) * C + c) * N + n0;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    aprod[o + i] = exp2_ftz(sw[i]);
    hend[o + i] = h[i];
  }
}

// Full pass: every super-chunk from the state entering it (carry: the
// forward linear_scan of the summaries, inclusive; null where there is one
// super-chunk); y in the stream dtype.
template <typename T, int N>
__global__ void __launch_bounds__(kSfCB * fwd_groups(N))
scan_full_kernel(const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
                 const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
                 const float* __restrict__ bias, const float* __restrict__ carry,
                 T* __restrict__ y, int K, int C, int L, int S, int softplus_on) {
  constexpr int G = fwd_groups(N), NG = N / G, TLp = kCk + 1;
  __shared__ float us[kSfCB * TLp], dts[kSfCB * TLp], ys[kSfCB * TLp], bs[N * TLp],
      cs[N * TLp];
  const SfTile tl = sf_tile(K, C, L, S);
  const int tid = threadIdx.x, nth = blockDim.x, tc = tid / G, g = tid % G, n0 = g * NG;
  const int c = tl.c0 + tc;
  const bool valid = tc < tl.nc;
  float An[NG], h[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    An[i] = valid ? A[((long)tl.k * C + c) * N + n0 + i] * kLog2e : 0.f;
    h[i] = valid && tl.j > 0
               ? carry[(((long)tl.m * gridDim.x + tl.j - 1) * C + c) * N + n0 + i]
               : 0.f;
  }
  const float dk = valid && D != nullptr ? D[tl.k * C + c] : 0.f;
  const float* Bn = bs + n0 * TLp;
  const float* Cn = cs + n0 * TLp;
  T* yb = y + ((long)tl.m * C + tl.c0) * L;
  for (int l0 = tl.i0; l0 < tl.i1; l0 += kCk) {
    const int nt = min(kCk, tl.i1 - l0);
    sf_stage<T>(tl, u, dt, Bm, Cm, bias, us, dts, bs, cs, C, N, L, l0, nt, softplus_on);
    // every lane walks (past the block's channels on zeros: h stays 0), so
    // the shuffles take whole warps
    for (int j = 0; j < nt; ++j) {
      const float xv = us[tc * TLp + j], d = dts[tc * TLp + j], du = d * xv;
      float yv = 0.f;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        h[i] = fmaf(exp2_ftz(d * An[i]), h[i], du * Bn[i * TLp + j]);
        yv = fmaf(Cn[i * TLp + j], h[i], yv);
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (g == 0) ys[tc * TLp + j] = fmaf(dk, xv, yv);
    }
    __syncthreads();
    // the next chunk's staging writes no y: its barrier orders this pass's
    // reads of ys before the next walk's writes
    for (int i = tid; i < tl.nc * kCk; i += nth) {
      const int cc = i / kCk, j = i - cc * kCk;
      if (j < nt) IO<T>::store(yb, (long)cc * L + l0 + j, ys[cc * TLp + j]);
    }
  }
}

template <typename T, int N>
int scan_sum_n(const void* u, const void* dt, const float* A, const void* Bm, const float* bias,
               float* aprod, float* hend, int M, int K, int C, int L, int S, int softplus_on,
               cudaStream_t s) {
  dim3 grid((L + S - 1) / S, (C + kSfCB - 1) / kSfCB, M);
  scan_sum_kernel<T, N><<<grid, kSfCB * fwd_groups(N), 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm), bias,
      aprod, hend, K, C, L, S, softplus_on);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int scan_full_n(const void* u, const void* dt, const float* A, const void* Bm, const void* Cm,
                const float* D, const float* bias, const float* carry, void* y, int M, int K,
                int C, int L, int S, int softplus_on, cudaStream_t s) {
  dim3 grid((L + S - 1) / S, (C + kSfCB - 1) / kSfCB, M);
  scan_full_kernel<T, N><<<grid, kSfCB * fwd_groups(N), 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, bias, carry, static_cast<T*>(y), K, C, L, S, softplus_on);
  return (int)cudaGetLastError();
}

}  // namespace bem

#define BEM_SF_BY_N(CALL)                             \
  switch (N) {                                        \
    case 1: return CALL(1);                           \
    case 2: return CALL(2);                           \
    case 4: return CALL(4);                           \
    case 8: return CALL(8);                           \
    case 16: return CALL(16);                         \
    default: return (int)cudaErrorInvalidValue;       \
  }

static bool sf_args_ok(int M, int K, int C, int L, int S) {
  return M > 0 && K > 0 && M % K == 0 && C > 0 && L > 0 && S >= bem::kCk && S % bem::kCk == 0;
}

// Positions per super-chunk of the chunked scan for M = batch * K
// sequences of C channels, N states and length L (super_chunk over the
// full pass's M * C * fwd_groups(N) threads); the caller sizes the
// summaries by it.
extern "C" int bem_selective_scan_chunk(int M, int C, int N, int L) {
  return M > 0 && C > 0 && N > 0 && L > 0
             ? bem::super_chunk((long)M * C * bem::fwd_groups(N), L)
             : 0;
}

// Pass 1: aprod / hend (M, nsc, C*N), nsc = ceil(L / S): each super-chunk's
// decay and end state from 0 (the carry's a and b). bias may be null.
extern "C" int bem_selective_scan_sum(const void* u, const void* dt, const float* A,
                                      const void* Bm, const float* bias, float* aprod,
                                      float* hend, int M, int K, int C, int L, int N, int S,
                                      int softplus_on, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!sf_args_ok(M, K, C, L, S)) return (int)cudaErrorInvalidValue;
#define BEM_SF_SUM(NN)                                                                     \
  (is_bf16 ? bem::scan_sum_n<__nv_bfloat16, NN>(u, dt, A, Bm, bias, aprod, hend, M, K, C, L, \
                                                S, softplus_on, s)                          \
           : bem::scan_sum_n<float, NN>(u, dt, A, Bm, bias, aprod, hend, M, K, C, L, S,      \
                                        softplus_on, s))
  BEM_SF_BY_N(BEM_SF_SUM)
#undef BEM_SF_SUM
}

// Pass 3: y from carry (M, nsc, C*N), the forward linear_scan of pass 1's
// summaries (null where L <= S). D and bias may be null (no skip term / no
// dt bias).
extern "C" int bem_selective_scan_fused(const void* u, const void* dt, const float* A,
                                        const void* Bm, const void* Cm, const float* D,
                                        const float* bias, const float* carry, void* y, int M,
                                        int K, int C, int L, int N, int S, int softplus_on,
                                        int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!sf_args_ok(M, K, C, L, S) || (L > S && carry == nullptr))
    return (int)cudaErrorInvalidValue;
#define BEM_SF_FULL(NN)                                                                     \
  (is_bf16 ? bem::scan_full_n<__nv_bfloat16, NN>(u, dt, A, Bm, Cm, D, bias, carry, y, M, K, \
                                                 C, L, S, softplus_on, s)                   \
           : bem::scan_full_n<float, NN>(u, dt, A, Bm, Cm, D, bias, carry, y, M, K, C, L, S, \
                                         softplus_on, s))
  BEM_SF_BY_N(BEM_SF_FULL)
#undef BEM_SF_FULL
}
#undef BEM_SF_BY_N
