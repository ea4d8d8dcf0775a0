// Fused selective scan over precomputed dt, B, C (channel-first, L minor).
//
// Replaces bem_tpu/ops/scan_fused.py::selective_scan_fused (its Pallas
// kernel from _make_kernel, pallas_call at scan_fused.py:120): the SS2D
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
// Bound: operations at the path's shapes (per element and state an exp, a
// multiply for dt*A, the input product and two FMAs against 2-4 bytes of
// traffic per element and state shared by N states). The Pallas kernel
// scanned 4096-position blocks by doubling and carried h between blocks in
// VMEM; here one thread walks one (m, c) row sequentially with its N states
// in registers, which is the same function up to the fp32 order of sums.
// L is minor, so a thread walking L alone would read addresses L apart:
// instead each block (kCh channels of one m) stages a kChunk-long piece of
// u and dt through shared memory with coalesced loads, and the B / C piece
// once for all its channels (they are shared by every channel of an m);
// the walkers read shared memory (rows padded by one word: no bank
// conflicts), write y in place of u, and the block stores y coalesced.
// At batch 2 the card is nearly empty (VMamba-T S0: 8 * 3 blocks of 64
// walkers); a chunked-L form of the walk is later work.
#include "common.cuh"

namespace bem {

constexpr int kSfCh = 64;     // channels (walkers) per block
constexpr int kSfChunk = 32;  // positions staged per round

template <typename T, int N>
__global__ void __launch_bounds__(kSfCh)
selective_scan_fused_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                            const float* __restrict__ A, const T* __restrict__ Bm,
                            const T* __restrict__ Cm, const float* __restrict__ D,
                            const float* __restrict__ bias, T* __restrict__ y, int K, int C,
                            int L, int softplus_on) {
  __shared__ float s_u[kSfCh][kSfChunk + 1];
  __shared__ float s_dt[kSfCh][kSfChunk + 1];
  __shared__ float s_b[N][kSfChunk];
  __shared__ float s_c[N][kSfChunk];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kSfCh;
  const long m = blockIdx.y;
  const int k = (int)(m % K);
  const int nch = min(kSfCh, C - c0);
  const int c = c0 + tid;
  const bool walker = tid < nch;
  const long kc = (long)k * C + c;  // row of A, D and bias
  float a_n[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a_n[n] = walker ? A[kc * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float d_c = (walker && D != nullptr) ? D[kc] : 0.f;
  const float b_c = (walker && bias != nullptr) ? bias[kc] : 0.f;
  const long row0 = (m * C + c0) * (long)L;  // first row of this block's tile
  const long bc0 = m * N * (long)L;
  for (int l0 = 0; l0 < L; l0 += kSfChunk) {
    const int len = min(kSfChunk, L - l0);
    for (int i = tid; i < nch * kSfChunk; i += kSfCh) {
      const int r = i / kSfChunk, l = i % kSfChunk;
      if (l < len) {
        const long g = row0 + (long)r * L + l0 + l;
        s_u[r][l] = IO<T>::load(u, g);
        s_dt[r][l] = IO<T>::load(dt, g);
      }
    }
    for (int i = tid; i < N * kSfChunk; i += kSfCh) {
      const int n = i / kSfChunk, l = i % kSfChunk;
      if (l < len) {
        const long g = bc0 + (long)n * L + l0 + l;
        s_b[n][l] = IO<T>::load(Bm, g);
        s_c[n][l] = IO<T>::load(Cm, g);
      }
    }
    __syncthreads();
    if (walker) {
      for (int l = 0; l < len; ++l) {
        const float uu = s_u[tid][l];
        float d = s_dt[tid][l] + b_c;
        if (softplus_on) d = softplus(d);
        const float du = d * uu;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(expf(d * a_n[n]), h[n], du * s_b[n][l]);
          acc = fmaf(s_c[n][l], h[n], acc);
        }
        s_u[tid][l] = fmaf(d_c, uu, acc);
      }
    }
    __syncthreads();
    for (int i = tid; i < nch * kSfChunk; i += kSfCh) {
      const int r = i / kSfChunk, l = i % kSfChunk;
      if (l < len) IO<T>::store(y, row0 + (long)r * L + l0 + l, s_u[r][l]);
    }
    __syncthreads();
  }
}

template <typename T, int N>
cudaError_t launch_scan_fused(const void* u, const void* dt, const float* A, const void* Bm,
                              const void* Cm, const float* D, const float* bias, void* y,
                              int M, int K, int C, int L, int softplus_on, cudaStream_t s) {
  dim3 grid((C + kSfCh - 1) / kSfCh, M);
  selective_scan_fused_kernel<T, N><<<grid, kSfCh, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, bias, static_cast<T*>(y), K, C, L, softplus_on);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scan_fused(int N, const void* u, const void* dt, const float* A,
                                const void* Bm, const void* Cm, const float* D,
                                const float* bias, void* y, int M, int K, int C, int L,
                                int softplus_on, cudaStream_t s) {
  switch (N) {
    case 1: return launch_scan_fused<T, 1>(u, dt, A, Bm, Cm, D, bias, y, M, K, C, L, softplus_on, s);
    case 2: return launch_scan_fused<T, 2>(u, dt, A, Bm, Cm, D, bias, y, M, K, C, L, softplus_on, s);
    case 4: return launch_scan_fused<T, 4>(u, dt, A, Bm, Cm, D, bias, y, M, K, C, L, softplus_on, s);
    case 8: return launch_scan_fused<T, 8>(u, dt, A, Bm, Cm, D, bias, y, M, K, C, L, softplus_on, s);
    case 16: return launch_scan_fused<T, 16>(u, dt, A, Bm, Cm, D, bias, y, M, K, C, L, softplus_on, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bem

// D and bias may be null (no skip term / no dt bias).
extern "C" int bem_selective_scan_fused(const void* u, const void* dt, const float* A,
                                        const void* Bm, const void* Cm, const float* D,
                                        const float* bias, void* y, int M, int K, int C,
                                        int L, int N, int softplus_on, int is_bf16,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || M % K != 0 || C <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)bem::dispatch_scan_fused<__nv_bfloat16>(N, u, dt, A, Bm, Cm, D, bias, y, M, K,
                                                       C, L, softplus_on, s);
  return (int)bem::dispatch_scan_fused<float>(N, u, dt, A, Bm, Cm, D, bias, y, M, K, C, L,
                                              softplus_on, s);
}
