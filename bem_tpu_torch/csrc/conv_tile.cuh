// Row-tile geometry and the two stages shared by the stem and gdMlp kernels:
// loading a haloed tile with a per-pixel LayerNorm, and the 1x1 projection
// of that tile onto a chunk of hidden channels.
//
// A block owns TH image rows x kTileW columns of one image. It loads the tile
// with a one-pixel halo on every side ((TH+2) x (kTileW+2) pixels, all C
// channels) into shared memory, so the depthwise 3x3 over the projected
// hidden channels needs no neighbour exchange: the halo's projection is
// recomputed, as the Pallas kernels recompute their halo rows.
#pragma once

#include "common.cuh"

namespace bem {

constexpr int kTileW = 32;
constexpr int kThreads = 256;

struct Tile {
  int TH, HH, WW, NP, TQ;
  __host__ __device__ Tile(int th)
      : TH(th), HH(th + 2), WW(kTileW + 2), NP((th + 2) * (kTileW + 2)), TQ(th * kTileW) {}
};

// xs[c * NP + p] = x at halo pixel p (0 outside the image), then LN'd in
// place when lns != nullptr (fp32 stats, centred variance, eps 1e-5); the LN
// output is rounded to bf16 when round_ln is set.
template <typename T>
__device__ void load_tile_ln(const T* __restrict__ xb, const float* __restrict__ lns,
                             const float* __restrict__ lnb, float* xs, const Tile& g,
                             int C, int H, int W, int r0, int c0, bool round_ln) {
  const long L = (long)H * W;
  for (int i = threadIdx.x; i < C * g.NP; i += blockDim.x) {
    const int c = i / g.NP, p = i - c * g.NP;
    const int hy = p / g.WW, hx = p - hy * g.WW;
    const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = IO<T>::load(xb, c * L + (long)gy * W + gx);
    xs[i] = v;
  }
  __syncthreads();
  if (lns == nullptr) return;
  const float invc = 1.f / (float)C;
  for (int p = threadIdx.x; p < g.NP; p += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += xs[c * g.NP + p];
    const float m = s * invc;
    float v = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = xs[c * g.NP + p] - m;
      v = fmaf(d, d, v);
    }
    const float inv = rsqrtf(v * invc + 1e-5f);
    for (int c = 0; c < C; ++c) {
      float y = (xs[c * g.NP + p] - m) * inv * lns[c] + lnb[c];
      xs[c * g.NP + p] = round_ln ? round_bf16(y) : y;
    }
  }
  __syncthreads();
}

// hid[k * NP + p] = W1[ch(k)] . xs[:, p] + b1[ch(k)] for the NK <= KMAX hidden
// channels ch(0..NK-1) of this chunk; 0 at halo pixels outside the image (the
// depthwise conv's zero padding). w1s holds the chunk's weights as [c][k].
template <int KMAX>
__device__ void project_tile(const float* xs, const float* w1s, const float* bias_k,
                             float* hid, const Tile& g, int C, int H, int W, int r0,
                             int c0) {
  for (int p = threadIdx.x; p < g.NP; p += blockDim.x) {
    const int hy = p / g.WW, hx = p - hy * g.WW;
    const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
    const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float xv = xs[c * g.NP + p];
      const float* wr = w1s + c * KMAX;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[k] = fmaf(wr[k], xv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) hid[k * g.NP + p] = valid ? acc[k] + bias_k[k] : 0.f;
  }
}

// The pixel-major bf16 form of load_tile_ln, for the tensor-core products:
// xs[p * S + c] = x at halo pixel p, LN'd when lns != nullptr (the same fp32
// stats as load_tile_ln), rounded to bf16; 0 at pixels outside the image,
// at pixels NP..NPp-1 and at channels C..Kp-1 (the products' zero padding).
// One thread per pixel; its channel loads are coalesced across the warp.
template <typename T>
__device__ void load_tile_ln_pm(const T* __restrict__ xb, const float* __restrict__ lns,
                                const float* __restrict__ lnb, __nv_bfloat16* xs,
                                const Tile& g, int C, int Kp, int S, int NPp, int H, int W,
                                int r0, int c0) {
  const long L = (long)H * W;
  const float invc = 1.f / (float)C;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int p = threadIdx.x; p < NPp; p += blockDim.x) {
    __nv_bfloat16* row = xs + (long)p * S;
    const int hy = p / g.WW, hx = p - hy * g.WW;
    const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
    int c0z = 0;
    if (p < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const T* xp = xb + (long)gy * W + gx;
      if (lns == nullptr) {
        for (int c = 0; c < C; ++c) row[c] = __float2bfloat16_rn(IO<T>::load(xp, c * L));
      } else {
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += IO<T>::load(xp, c * L);
        const float m = s * invc;
        float v = 0.f;
        for (int c = 0; c < C; ++c) {
          const float d = IO<T>::load(xp, c * L) - m;
          v = fmaf(d, d, v);
        }
        const float inv = rsqrtf(v * invc + 1e-5f);
        for (int c = 0; c < C; ++c)
          row[c] = __float2bfloat16_rn((IO<T>::load(xp, c * L) - m) * inv * lns[c] + lnb[c]);
      }
      c0z = C;
    }
    for (int c = c0z; c < Kp; ++c) row[c] = zero;
  }
}

// The fp32 stream's tile for the tensor-core forms: y = x at halo pixel p,
// LN'd when lns != nullptr (fp32 stats over the fp32 x, the variance from
// sums shifted by the pixel's first channel, eps 1e-5); 0 at pixels
// outside the image, at pixels NP..NPp-1 and at channels C..Kp-1 (Kp
// even). SPLIT (bf16 products): hi = bf16(y) at xh[p * S + c] and
// lo = bf16(y - hi) at xl[p * S + c]; else (tf32 products) fp32 y at
// xh[p * S + c]. One warp per 8 pixels, four lanes a pixel (lane 4 g + t
// takes pixel g and the channel pairs t, t + 4, ...): each load
// instruction reads 8 neighbouring pixels of 4 channels, and the bf16
// pairs' stores are conflict-free at S / 2 = 4 mod 8 words. ``nthreads``
// threads take part.
template <bool SPLIT>
__device__ inline void stage_tile_f32(const float* __restrict__ xb, const float* __restrict__ lns,
                                      const float* __restrict__ lnb, void* xh, void* xl,
                                      const Tile& g, int C, int Kp, int S, int NPp, int H, int W,
                                      int r0, int c0, int nthreads) {
  const long L = (long)H * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float invc = 1.f / (float)C;
  for (int pg = warp; pg < NPp / 8; pg += nthreads / 32) {
    const int p = pg * 8 + gq;
    const int hy = p / g.WW, hx = p - hy * g.WW;
    const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
    const bool in = p < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* xp = xb + (in ? (long)gy * W + gx : 0L);
    float m = 0.f, inv = 1.f;
    if (lns != nullptr) {
      const float xr = in ? xp[0] : 0.f;
      float s1 = 0.f, s2 = 0.f;
      if (in)
        for (int c = tq; c < C; c += 4) {
          const float d = xp[c * L] - xr;
          s1 += d;
          s2 = fmaf(d, d, s2);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float ms = s1 * invc;
      m = xr + ms;
      inv = rsqrtf(fmaxf(s2 * invc - ms * ms, 0.f) + 1e-5f);
    }
    for (int w = tq; w < Kp / 2; w += 4) {
      const int c = 2 * w;
      float y0 = 0.f, y1 = 0.f;
      if (in) {
        if (c < C) y0 = lns != nullptr ? (xp[c * L] - m) * inv * lns[c] + lnb[c] : xp[c * L];
        if (c + 1 < C)
          y1 = lns != nullptr ? (xp[(c + 1) * L] - m) * inv * lns[c + 1] + lnb[c + 1]
                              : xp[(c + 1) * L];
      }
      if (SPLIT) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(y0, y1);
        const float2 hf = __bfloat1622float2(hi);
        reinterpret_cast<__nv_bfloat162*>(xh)[(long)p * S / 2 + w] = hi;
        reinterpret_cast<__nv_bfloat162*>(xl)[(long)p * S / 2 + w] =
            __floats2bfloat162_rn(y0 - hf.x, y1 - hf.y);
      } else {
        reinterpret_cast<float2*>(xh)[(long)p * S / 2 + w] = make_float2(y0, y1);
      }
    }
  }
}

// depthwise 3x3 of one hidden row at interior pixel (ty, tx), taps [dy][dx]
__device__ __forceinline__ float dw3x3(const float* hrow, const float* taps, int ww, int ty,
                                       int tx) {
  float s = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) s = fmaf(taps[dy * 3 + dx], hrow[(ty + dy) * ww + tx + dx], s);
  return s;
}

// The depthwise 3x3 (taps [dy][dx] at tp[0..8]) + bj of one hidden
// channel down one tile column of TH rows: hr is the column's first halo
// entry in an fp32 hidden row (halo rows kTileW + 2 apart); the window's
// TH + 2 rows x 3 taps sit in registers, dw3x3's order (rows, then
// columns). out[ty] for the TH rows.
template <int TH>
__device__ __forceinline__ void conv_column(const float* hr, const float* tp, float bj,
                                            float* out) {
  float t[9], win[TH + 2][3];
#pragma unroll
  for (int e = 0; e < 9; ++e) t[e] = tp[e];
#pragma unroll
  for (int r = 0; r < TH + 2; ++r)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) win[r][dx] = hr[r * (kTileW + 2) + dx];
#pragma unroll
  for (int ty = 0; ty < TH; ++ty) {
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) s = fmaf(t[dy * 3 + dx], win[ty + dy][dx], s);
    out[ty] = s + bj;
  }
}

// Largest tile height in {8, 4, 2, 1} whose shared memory fits the budget.
template <typename F>
inline int pick_tile_rows(F smem_floats) {
  for (int th = 8; th > 1; th /= 2)
    if (smem_floats(Tile(th)) * sizeof(float) <= kSmemBudget) return th;
  return 1;
}

}  // namespace bem
