// SS2D stem: [per-pixel LN over C ->] 1x1 in_proj (+b1) -> depthwise 3x3 with
// zero padding (+bdw) -> SiLU, channel-first (B, C, H*W) -> (B, Dh, H*W).
//
// Replaces bem_tpu/ops/gdmlp_fused.py::stem_fused_cf (Pallas body _stem_body).
// Bound: the in_proj FMAs (Dh*C per pixel, fp32 on the CUDA cores) and the
// read of x / write of the Dh-wide output. Design: one block per TH x 32
// pixel tile; the haloed input tile and its LN live in shared memory, the
// projection runs over hidden-channel chunks of kChunk so the Dh-wide hidden
// tile never leaves the SM, and the halo's projection is recomputed instead
// of exchanged (the Pallas kernel does the same with its halo rows).
#include "conv_tile.cuh"

namespace bem {

constexpr int kChunk = 32;

inline size_t stem_smem_floats(const Tile& g, int C) {
  // xs (C*NP) + w1 chunk (C*kChunk) + hidden chunk (kChunk*NP) + bias (kChunk)
  return (size_t)C * g.NP + (size_t)C * kChunk + (size_t)kChunk * g.NP + kChunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const float* __restrict__ lns,
            const float* __restrict__ lnb, const float* __restrict__ W1,
            const float* __restrict__ b1, const float* __restrict__ dw,
            const float* __restrict__ bdw, T* __restrict__ out, int C, int Dh, int H,
            int W, int TH) {
  extern __shared__ float smem[];
  const Tile g(TH);
  float* xs = smem;
  float* w1s = xs + C * g.NP;
  float* hid = w1s + C * kChunk;
  float* bk = hid + kChunk * g.NP;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * kTileW;
  const long L = (long)H * W;

  load_tile_ln(x + (long)b * C * L, lns, lnb, xs, g, C, H, W, r0, c0, false);

  T* ob = out + (long)b * Dh * L;
  for (int j0 = 0; j0 < Dh; j0 += kChunk) {
    const int nj = min(kChunk, Dh - j0);
    for (int i = threadIdx.x; i < C * kChunk; i += blockDim.x) {
      const int c = i / kChunk, k = i - c * kChunk;
      w1s[i] = k < nj ? W1[(long)(j0 + k) * C + c] : 0.f;
    }
    for (int k = threadIdx.x; k < kChunk; k += blockDim.x)
      bk[k] = (k < nj && b1 != nullptr) ? b1[j0 + k] : 0.f;
    __syncthreads();
    project_tile<kChunk>(xs, w1s, bk, hid, g, C, H, W, r0, c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nj * g.TQ; i += blockDim.x) {
      const int k = i / g.TQ, q = i - k * g.TQ;
      const int ty = q / kTileW, tx = q - ty * kTileW;
      const int gy = r0 + ty, gx = c0 + tx;
      if (gy >= H || gx >= W) continue;
      const int j = j0 + k;
      float s = dw3x3(hid + k * g.NP, dw + j * 9, g.WW, ty, tx);
      if (bdw != nullptr) s += bdw[j];
      IO<T>::store(ob, (long)j * L + (long)gy * W + gx, s * (1.f / (1.f + expf(-s))));
    }
    __syncthreads();
  }
}

template <typename T>
int launch_stem(const void* x, const float* lns, const float* lnb, const float* W1,
                const float* b1, const float* dw, const float* bdw, void* out, int B, int C,
                int Dh, int H, int W, cudaStream_t stream) {
  const int TH = pick_tile_rows([&](const Tile& g) { return stem_smem_floats(g, C); });
  const size_t smem = stem_smem_floats(Tile(TH), C) * sizeof(float);
  cudaError_t e = allow_smem(stem_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), lns, lnb, W1, b1, dw, bdw, static_cast<T*>(out), C, Dh, H, W,
      TH);
  return (int)cudaGetLastError();
}

}  // namespace bem

extern "C" int bem_stem_fused(const void* x, const float* lns, const float* lnb,
                              const float* W1, const float* b1, const float* dw,
                              const float* bdw, void* out, int B, int C, int Dh, int H, int W,
                              int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::launch_stem<__nv_bfloat16>(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W,
                                           s);
  return bem::launch_stem<float>(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W, s);
}
