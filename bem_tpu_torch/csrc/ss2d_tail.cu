// SS2D tail, channel-first (B, C, L) -> (B, C_out, L):
//   y   = y_row [+ y_colT]                      (fp32)
//   yn  = LN_C(y) * scale + bias                (centred two-pass variance, eps 1e-5)
//   out = Wout^T . yn [+ bout] [+ res]          (yn rounded to bf16 on the bf16 stream)
//
// Replaces bem_tpu/ops/ss2d_tail.py::ss2d_tail_cf (Pallas body _tail_body).
// Bound: bytes (two C-wide reads, one C_out-wide write, one optional
// residual read per pixel) and, at C = 160, the C*C_out out_proj FMAs.
// Design: one block per kTailL positions of one image; the merged tile and
// Wout sit in shared memory, one thread per position takes the LN
// statistics, then all threads compute the projection with the tile's
// positions along the warp so every global access is coalesced.
#include "common.cuh"

namespace bem {

constexpr int kTailL = 128;
constexpr int kTailThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const T* __restrict__ yr, const T* __restrict__ yc, const float* __restrict__ sc,
            const float* __restrict__ bi, const float* __restrict__ Wout,
            const float* __restrict__ bout, const T* __restrict__ res, T* __restrict__ out,
            int C, int Cout, int L, int bf16) {
  extern __shared__ float smem[];
  float* ys = smem;               // (C, kTailL)
  float* ws = ys + C * kTailL;    // (C, Cout)
  const int b = blockIdx.y;
  const long l0 = (long)blockIdx.x * kTailL;
  const int nt = (int)min((long)kTailL, (long)L - l0);
  const long ib = (long)b * C * L, ob = (long)b * Cout * L;

  for (int i = threadIdx.x; i < C * Cout; i += blockDim.x) ws[i] = Wout[i];
  for (int i = threadIdx.x; i < C * kTailL; i += blockDim.x) {
    const int c = i / kTailL, t = i - c * kTailL;
    float v = 0.f;
    if (t < nt) {
      const long j = ib + (long)c * L + l0 + t;
      v = IO<T>::load(yr, j);
      if (yc != nullptr) v += IO<T>::load(yc, j);
    }
    ys[i] = v;
  }
  __syncthreads();
  const float invc = 1.f / (float)C;
  for (int t = threadIdx.x; t < kTailL; t += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += ys[c * kTailL + t];
    const float m = s * invc;
    float v = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = ys[c * kTailL + t] - m;
      v = fmaf(d, d, v);
    }
    const float inv = rsqrtf(v * invc + 1e-5f);
    for (int c = 0; c < C; ++c) {
      const float yn = (ys[c * kTailL + t] - m) * inv * sc[c] + bi[c];
      ys[c * kTailL + t] = bf16 ? round_bf16(yn) : yn;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Cout * kTailL; i += blockDim.x) {
    const int co = i / kTailL, t = i - co * kTailL;
    if (t >= nt) continue;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(ws[c * Cout + co], ys[c * kTailL + t], s);
    if (bout != nullptr) s += bout[co];
    const long j = ob + (long)co * L + l0 + t;
    if (res != nullptr) s += IO<T>::load(res, j);
    IO<T>::store(out, j, s);
  }
}

template <typename T>
int launch_tail(const void* yr, const void* yc, const float* sc, const float* bi,
                const float* Wout, const float* bout, const void* res, void* out, int B, int C,
                int Cout, int L, int bf16, cudaStream_t stream) {
  const size_t smem = ((size_t)C * kTailL + (size_t)C * Cout) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(tail_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kTailL - 1) / kTailL, B);
  tail_kernel<T><<<grid, kTailThreads, smem, stream>>>(
      static_cast<const T*>(yr), static_cast<const T*>(yc), sc, bi, Wout, bout,
      static_cast<const T*>(res), static_cast<T*>(out), C, Cout, L, bf16);
  return (int)cudaGetLastError();
}

}  // namespace bem

extern "C" int bem_ss2d_tail(const void* yr, const void* yc, const float* sc, const float* bi,
                             const float* Wout, const float* bout, const void* res, void* out,
                             int B, int C, int Cout, int L, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::launch_tail<__nv_bfloat16>(yr, yc, sc, bi, Wout, bout, res, out, B, C, Cout, L,
                                           1, s);
  return bem::launch_tail<float>(yr, yc, sc, bi, Wout, bout, res, out, B, C, Cout, L, 0, s);
}

extern "C" const char* bem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
