// Fused gated-dconv MLP block branch, channel-first (B, C, H*W):
//   out = [x +] W2 . (GELU_erf(h1) * h2) + b2,  [h1; h2] = dw3x3(W1 . LN(x) + b1) + bdw
// The 2h-wide hidden activation never leaves the SM.
//
// Replaces bem_tpu/ops/gdmlp_fused.py::gdmlp_fused_cf (Pallas body _body).
// Bound: the two 1x1 projections (2h*C + C*h FMAs per pixel, fp32 on the
// CUDA cores; 2h = 8C on the flagship path). Design: one block per TH x 32
// pixel tile; the haloed, LN'd input tile sits in shared memory; the hidden
// width is walked in chunks of kGate gate channels (plus their kGate value
// channels), each chunk projected over the halo, convolved, gated and
// folded into a per-pixel C_out accumulator in shared memory, so shared
// memory stays bounded at every width (320 / 640 / 1280 hidden).
// Numerics follow the interpret-mode Pallas kernel: on the bf16 stream the
// LN output and the gate are rounded to bf16 before their projections.
#include "conv_tile.cuh"

namespace bem {

constexpr int kGate = 16;           // gate channels per chunk
constexpr int kHid = 2 * kGate;     // hidden rows per chunk: [gate | value]

inline size_t gdmlp_smem_floats(const Tile& g, int C, int Cout) {
  // xs + w1 chunk + hidden chunk + bias chunk + gate tile + w2 chunk + acc
  return (size_t)C * g.NP + (size_t)C * kHid + (size_t)kHid * g.NP + kHid +
         (size_t)kGate * g.TQ + (size_t)Cout * kGate + (size_t)Cout * g.TQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gdmlp_kernel(const T* __restrict__ x, const float* __restrict__ lns,
             const float* __restrict__ lnb, const float* __restrict__ W1,
             const float* __restrict__ b1, const float* __restrict__ dw,
             const float* __restrict__ bdw, const float* __restrict__ W2,
             const float* __restrict__ b2, T* __restrict__ out, int C, int h, int Cout, int H,
             int W, int TH, int residual, int bf16) {
  extern __shared__ float smem[];
  const Tile g(TH);
  float* xs = smem;
  float* w1s = xs + C * g.NP;
  float* hid = w1s + C * kHid;
  float* bk = hid + kHid * g.NP;
  float* gs = bk + kHid;
  float* w2s = gs + kGate * g.TQ;
  float* acc = w2s + Cout * kGate;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * kTileW;
  const long L = (long)H * W;
  const T* xb = x + (long)b * C * L;

  load_tile_ln(xb, lns, lnb, xs, g, C, H, W, r0, c0, bf16 != 0 && lns != nullptr);
  for (int i = threadIdx.x; i < Cout * g.TQ; i += blockDim.x) acc[i] = 0.f;

  for (int j0 = 0; j0 < h; j0 += kGate) {
    const int nj = min(kGate, h - j0);
    // hidden row k < kGate is gate channel j0+k, row kGate+k its value channel
    for (int i = threadIdx.x; i < C * kHid; i += blockDim.x) {
      const int c = i / kHid, k = i - c * kHid;
      const int kk = k < kGate ? k : k - kGate;
      const int ch = (k < kGate ? 0 : h) + j0 + kk;
      w1s[i] = kk < nj ? W1[(long)ch * C + c] : 0.f;
    }
    for (int k = threadIdx.x; k < kHid; k += blockDim.x) {
      const int kk = k < kGate ? k : k - kGate;
      const int ch = (k < kGate ? 0 : h) + j0 + kk;
      bk[k] = (kk < nj && b1 != nullptr) ? b1[ch] : 0.f;
    }
    for (int i = threadIdx.x; i < Cout * kGate; i += blockDim.x) {
      const int co = i / kGate, k = i - co * kGate;
      w2s[i] = k < nj ? W2[(long)co * h + j0 + k] : 0.f;
    }
    __syncthreads();
    project_tile<kHid>(xs, w1s, bk, hid, g, C, H, W, r0, c0);
    __syncthreads();
    for (int i = threadIdx.x; i < kGate * g.TQ; i += blockDim.x) {
      const int k = i / g.TQ, q = i - k * g.TQ;
      float gv = 0.f;
      if (k < nj) {
        const int ty = q / kTileW, tx = q - ty * kTileW;
        const int ja = j0 + k, jb = h + j0 + k;
        float a = dw3x3(hid + k * g.NP, dw + ja * 9, g.WW, ty, tx);
        float v = dw3x3(hid + (kGate + k) * g.NP, dw + jb * 9, g.WW, ty, tx);
        if (bdw != nullptr) {
          a += bdw[ja];
          v += bdw[jb];
        }
        gv = 0.5f * a * (1.f + erff(a * 0.70710678118654752f)) * v;
        if (bf16) gv = round_bf16(gv);
      }
      gs[i] = gv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Cout * g.TQ; i += blockDim.x) {
      const int co = i / g.TQ, q = i - co * g.TQ;
      const float* wr = w2s + co * kGate;
      float s = acc[i];
#pragma unroll
      for (int k = 0; k < kGate; ++k) s = fmaf(wr[k], gs[k * g.TQ + q], s);
      acc[i] = s;
    }
    __syncthreads();
  }

  T* ob = out + (long)b * Cout * L;
  for (int i = threadIdx.x; i < Cout * g.TQ; i += blockDim.x) {
    const int co = i / g.TQ, q = i - co * g.TQ;
    const int ty = q / kTileW, tx = q - ty * kTileW;
    const int gy = r0 + ty, gx = c0 + tx;
    if (gy >= H || gx >= W) continue;
    const long pos = (long)gy * W + gx;
    float s = acc[i];
    if (b2 != nullptr) s += b2[co];
    if (residual) s += IO<T>::load(xb, (long)co * L + pos);
    IO<T>::store(ob, (long)co * L + pos, s);
  }
}

template <typename T>
int launch_gdmlp(const void* x, const float* lns, const float* lnb, const float* W1,
                 const float* b1, const float* dw, const float* bdw, const float* W2,
                 const float* b2, void* out, int B, int C, int h, int Cout, int H, int W,
                 int residual, int bf16, cudaStream_t stream) {
  const int TH =
      pick_tile_rows([&](const Tile& g) { return gdmlp_smem_floats(g, C, Cout); });
  const size_t smem = gdmlp_smem_floats(Tile(TH), C, Cout) * sizeof(float);
  cudaError_t e = allow_smem(gdmlp_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  gdmlp_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), lns, lnb, W1, b1, dw, bdw, W2, b2, static_cast<T*>(out), C, h,
      Cout, H, W, TH, residual, bf16);
  return (int)cudaGetLastError();
}

}  // namespace bem

extern "C" int bem_gdmlp_fused(const void* x, const float* lns, const float* lnb,
                               const float* W1, const float* b1, const float* dw,
                               const float* bdw, const float* W2, const float* b2, void* out,
                               int B, int C, int h, int Cout, int H, int W, int residual,
                               int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::launch_gdmlp<__nv_bfloat16>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C,
                                            h, Cout, H, W, residual, 1, s);
  return bem::launch_gdmlp<float>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C, h, Cout, H,
                                  W, residual, 0, s);
}
