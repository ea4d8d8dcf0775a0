// First-order linear recurrence along L of channels-last (M, L, D) fp32:
//   forward  h_t = a_t * h_{t-1} + b_t   (h_{-1} = 0)
//   reverse  h_t = a_t * h_{t+1} + b_t   (h_L = 0)
//
// Replaces bem_tpu/ops/scan.py::linear_scan on its Pallas backend
// (_linear_scan_pallas, body _scan_kernel): the SS2D column pair's
// cross-column carry and, forward and reverse, the backward recompute of
// the scan pairs (the VJP of a scan is the opposite-direction scan).
// Bound: bytes (a and b read, h written: 12 bytes per element against 2
// flops). One thread per (m, d) walking L would leave the card nearly
// empty at the backward's (8, 16384, 40), so the sequence is cut into
// chunks and scanned in three launches, each with M * nchunks * D threads
// in flight except the small middle one:
//   1. per chunk, from h = 0: the chunk's end state and the product of
//      its a (the chunk's summary);
//   2. per (m, d), a walk over the chunk summaries staged in shared
//      memory: the state entering each chunk;
//   3. per chunk, the scan again from its entering state, writing h.
// Reverse walks chunks and positions back to front (no flipped copies).
// Consecutive threads take consecutive d, so every load is coalesced.
#include "common.cuh"

namespace bem {

constexpr int kScanThreads = 256;
constexpr int kCarryRows = 8;    // threadIdx.y of the carry pass
constexpr int kCarryTile = 128;  // chunk summaries staged per round

__global__ void __launch_bounds__(kScanThreads)
scan_chunk_pass(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ carry, float* __restrict__ aprod,
                float* __restrict__ hend, float* __restrict__ h, int M, int L, int D,
                int chunk, int nch, int rev) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * nch * D) return;
  const int d = (int)(i % D);
  const long r = i / D;
  const int c = (int)(r % nch);
  const long m = r / nch;
  const long l0 = (long)c * chunk;
  const int n = (int)min((long)chunk, (long)L - l0);
  const long base = (m * L + l0) * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float hv = carry != nullptr ? carry[i] : 0.f;
  float p = 1.f;
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const long t = (long)(rev ? n - 1 - k : k) * D;
    const float av = ap[t];
    hv = fmaf(av, hv, bp[t]);
    if (h != nullptr) {
      h[base + t] = hv;
    } else {
      p *= av;
    }
  }
  if (h == nullptr) {
    aprod[i] = p;
    hend[i] = hv;
  }
}

// One block per (m, 32 channels): stage kCarryTile chunk summaries in shared
// memory, let one row of threads walk them in order, write the entering
// states back. carry may alias hend (each entry is read before it is written).
__global__ void __launch_bounds__(32 * kCarryRows)
scan_carry_pass(const float* __restrict__ aprod, const float* hend, float* carry, int D,
                int nch, int rev) {
  __shared__ float sa[kCarryTile][33];
  __shared__ float sb[kCarryTile][33];
  const int dx = threadIdx.x, ty = threadIdx.y;
  const int d = blockIdx.x * 32 + dx;
  const long m = blockIdx.y;
  float hv = 0.f;
  for (int base = 0; base < nch; base += kCarryTile) {
    const int cnt = min(kCarryTile, nch - base);
    for (int k = ty; k < cnt; k += kCarryRows) {
      const int c = rev ? nch - 1 - (base + k) : base + k;
      const long j = (m * nch + c) * D + d;
      sa[k][dx] = d < D ? aprod[j] : 1.f;
      sb[k][dx] = d < D ? hend[j] : 0.f;
    }
    __syncthreads();
    if (ty == 0) {
      for (int k = 0; k < cnt; ++k) {
        const float hin = hv;
        hv = fmaf(sa[k][dx], hv, sb[k][dx]);
        sb[k][dx] = hin;
      }
    }
    __syncthreads();
    for (int k = ty; k < cnt; k += kCarryRows) {
      const int c = rev ? nch - 1 - (base + k) : base + k;
      if (d < D) carry[(m * nch + c) * D + d] = sb[k][dx];
    }
    __syncthreads();
  }
}

}  // namespace bem

// aprod and hend are caller-allocated scratch of M * ceil(L / chunk) * D
// floats; the entering states overwrite hend.
extern "C" int bem_linear_scan(const float* a, const float* b, float* h, float* aprod,
                               float* hend, int M, int L, int D, int chunk, int rev,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || L <= 0 || D <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int nch = (L + chunk - 1) / chunk;
  const long n = (long)M * nch * D;
  const unsigned blocks = (unsigned)((n + bem::kScanThreads - 1) / bem::kScanThreads);
  bem::scan_chunk_pass<<<blocks, bem::kScanThreads, 0, s>>>(a, b, nullptr, aprod, hend,
                                                            nullptr, M, L, D, chunk, nch, rev);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 cgrid((D + 31) / 32, M);
  bem::scan_carry_pass<<<cgrid, dim3(32, bem::kCarryRows), 0, s>>>(aprod, hend, hend, D,
                                                                   nch, rev);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bem::scan_chunk_pass<<<blocks, bem::kScanThreads, 0, s>>>(a, b, hend, nullptr, nullptr, h,
                                                            M, L, D, chunk, nch, rev);
  return (int)cudaGetLastError();
}
