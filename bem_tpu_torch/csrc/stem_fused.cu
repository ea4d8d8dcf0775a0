// SS2D stem: [per-pixel LN over C ->] 1x1 in_proj (+b1) -> depthwise 3x3 with
// zero padding (+bdw) -> SiLU, channel-first (B, C, H*W) -> (B, Dh, H*W).
//
// Replaces bem_tpu/ops/gdmlp_fused.py::stem_fused_cf (Pallas body _stem_body
// :446, pallas_call :603). The three forms below, picked by the entry
// point bem_stem_fused, take one TH x 32 pixel tile a
// block, load it with a one-pixel halo ((TH+2) x 34 pixels, all C channels)
// into shared memory, and walk the hidden width in chunks, each projected
// over the whole halo (the halo's projection is recomputed instead of
// exchanged, as the Pallas kernel recomputes its halo rows), convolved and
// stored; the Dh-wide hidden map never leaves the SM.
//
// stem_tc_kernel, the bf16 stream (C, Dh <= 256): the projection on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate). Its rounding
// points are the mirror image of the gdMlp's. Interpret mode pre-rounds W1
// to bf16 (gdmlp_fused.py:549-553, and so does the wrapper) and keeps the LN
// output in fp32 (dot_mode "interp_bf16" is reset to "f32" there, so
// _win_ln does not round it): W1 is one exact bf16 operand, and the LN'd
// tile is staged as hi = bf16(y) and lo = bf16(y - hi), each product run
// twice, hi and lo, into the same fp32 accumulators (y to about 2^-17
// relative). Without the LN the tile is x itself, bf16 already: one
// product. (The TPU kernel rounds the LN output to bf16 and runs one
// product: ROADMAP section 3 lists that difference.) A block of 512
// threads stages the tile pixel-major, K = C padded to 16 with zeros:
// neighbouring threads take neighbouring pixels, 8 channels each
// (coalesced loads, one 16-byte shared store); then, with the LN, one
// warp per 8 pixels, four lanes a pixel (the fragment pattern: no bank
// conflicts), takes the LN statistics by shuffles and writes hi and lo in
// place. The hidden width is walked in chunks of 16 MT rows (M), every halo
// pixel (N = 8-pixel tiles, one warp each), K = Kp, into an fp32 chunk
// (0 at halo pixels outside the image: the depthwise conv's zero padding,
// not b1); then one thread per (hidden channel, tile column) loads the
// column's TH + 2 halo rows x 3 taps into registers, convolves, applies
// SiLU (__expf, __fdividef: the output is rounded to bf16) and stores each
// output row coalesced along the image row. The tile height TH and MT come
// from the shared-memory budget (stem_tc_plan): the largest TH, then the
// largest MT, that leave two blocks (32 warps) an SM, or one where nothing
// fits two. Bound: the instructions per value of the staging, the LN and
// the depthwise conv on the CUDA cores (the tensor-core products are a
// small share even at C = 160, where the two-row tile's halo doubles
// them); smoke.py's bound counts the bytes (read x, write the output).
//
// stem_tc32_kernel, the fp32 stream (the eval CLI, the LOLv1 train steps;
// C, Dh <= 256): the projection on the tensor cores at fp32 accuracy. Both
// operands are fp32 here: the LN output (x itself without the LN) and W1,
// which the wrapper does not pre-round on this stream. The tile is staged
// in fp32 from the fp32 x, with the LN statistics taken in fp32
// (stage_tile_f32), and the W1 chunk in fp32; each fragment is split as
// it is loaded into tf32 big and small and each product runs three
// times, small.big + big.small + big.big, into one fp32 accumulator
// (3xTF32, mma.sync m16n8k8 tf32: about 2^-22 of sum |w| |y|). A bf16
// split of the same three products (about 2^-16, the gdMlp's form) is
// not enough here: the stem's output feeds the scan's dt directly, and
// with it the LOLv1 IE train step's gradients on the card missed the CPU
// run's by 6.6e-3 of a leaf's largest entry (chip_smoke's tolerance:
// 1e-3). Tiles of 8 or 4 rows
// (halo at most 1.6x the output pixels) come first in stem_tc32_plan,
// then two blocks an SM, then the largest chunk; the depthwise 3x3 and
// SiLU (expf, exact division) run as in the bf16 form, with fp32 stores.
// Where the pixel grid gives fewer blocks than the card has SMs (the eval
// CG's B = 1 levels), chunks of 16 hidden channels are dealt across
// blocks (blockIdx.z = image x split); no reduction follows, each block
// writes its own channels. Bound: bytes at the IE's shapes (read x, write
// the output), with the staging, the LN, the fragment splits and the
// depthwise conv on the CUDA cores the instructions per value that hold
// it above that.
//
// stem_kernel, C or Dh above 256 (either stream): the projection as fp32
// FMAs on the CUDA cores, one thread per halo pixel and kChunk hidden
// channels, the weights read from shared memory.
#include "conv_tile.cuh"
#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core form (bf16 stream)

constexpr size_t kStemTwoBlocks = 113 * 1024;  // shared memory that leaves two blocks an SM
constexpr size_t kStemOneBlock = 227 * 1024;   // the most a block may take
constexpr int kStemMaxMT = 3;                  // m-tiles of 16 hidden rows a chunk, at most
constexpr int kStemThreads = 512;              // threads of a block: 32 warps an SM at two blocks

// byte offsets of the shared-memory regions; every region 16-byte aligned
struct StemTcLayout {
  int Kp, S1, NPp, Sh, MC;
  size_t xh, xl, w1, hid, bk, ln, total;
  __host__ __device__ StemTcLayout(int C, int MT, int TH, bool split) {
    const Tile g(TH);
    Kp = (C + 15) / 16 * 16;
    S1 = Kp + 8;  // bf16 stride of a pixel / W1 row: conflict-free fragment loads
    NPp = (g.NP + 7) / 8 * 8;
    // fp32 stride of a hidden row, 8 mod 16: a warp's float2 stores of
    // its accumulators (8 rows x 4 pixel pairs) take two wavefronts
    Sh = NPp % 16 ? NPp : NPp + 8;
    MC = 16 * MT;
    xh = 0;                                      // bf16 (NPp, S1): the tile (LN'd: its hi)
    xl = xh + (size_t)NPp * S1 * 2;              // bf16 (NPp, S1): the LN'd tile's lo
    w1 = xl + (split ? (size_t)NPp * S1 * 2 : 0);  // bf16 (MC, S1): the W1 chunk
    hid = w1 + (size_t)MC * S1 * 2;              // fp32 (MC, Sh): the hidden chunk
    bk = hid + (size_t)MC * Sh * 4;              // fp32 (MC,): its b1
    ln = bk + (size_t)MC * 4;                    // fp32 (Kp / 2, 4): LN scale, shift pairs
    total = ln + (split ? (size_t)Kp * 8 : 0);
  }
};

struct StemTcPlan {
  int TH, MT;
  size_t smem;
};

// The largest tile height, then the largest chunk, whose shared memory
// leaves two blocks an SM; where none does, the same within one block's
// limit. TH = 0 where nothing fits.
inline StemTcPlan stem_tc_plan(int C, int Dh, bool split) {
  const int mtmax = (Dh + 15) / 16 < kStemMaxMT ? (Dh + 15) / 16 : kStemMaxMT;
  const size_t budgets[2] = {kStemTwoBlocks, kStemOneBlock};
  for (size_t budget : budgets)
    for (int th = 8; th >= 1; th /= 2)
      for (int mt = mtmax; mt >= 1; --mt) {
        const size_t s = StemTcLayout(C, mt, th, split).total;
        if (s <= budget) return {th, mt, s};
      }
  return {0, 0, 0};
}

// The depthwise 3x3 (taps [dy][dx] at tp, + bj), SiLU and the bf16 store of
// one hidden channel down one tile column of TH rows: hr is the column's
// first halo entry in the fp32 hidden chunk (rows kTileW + 2 apart), oc
// the channel's output at the column's image column. The window's TH + 2
// rows x 3 taps sit in registers.
template <int TH>
__device__ __forceinline__ void dw_column(const float* hr, const float* __restrict__ tp, float bj,
                                          bf16_t* oc, int r0, int H, int W) {
  float t[9], win[TH + 2][3];
#pragma unroll
  for (int e = 0; e < 9; ++e) t[e] = tp[e];
#pragma unroll
  for (int r = 0; r < TH + 2; ++r)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) win[r][dx] = hr[r * (kTileW + 2) + dx];
#pragma unroll
  for (int ty = 0; ty < TH; ++ty) {
    float s = 0.f;  // dw3x3's order: rows, then columns
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) s = fmaf(t[dy * 3 + dx], win[ty + dy][dx], s);
    s += bj;
    if (r0 + ty < H) oc[(long)(r0 + ty) * W] = __float2bfloat16_rn(__fdividef(s, 1.f + __expf(-s)));
  }
}

template <int MT, bool SPLIT>
__global__ void __launch_bounds__(kStemThreads, 2)
stem_tc_kernel(const bf16_t* __restrict__ x, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ W1,
               const float* __restrict__ b1, const float* __restrict__ dw,
               const float* __restrict__ bdw, bf16_t* __restrict__ out, int C, int Dh, int H,
               int W, int TH) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g(TH);
  const StemTcLayout lay(C, MT, TH, SPLIT);
  bf16_t* xh = reinterpret_cast<bf16_t*>(smem_raw + lay.xh);
  bf16_t* xl = reinterpret_cast<bf16_t*>(smem_raw + lay.xl);
  bf16_t* w1s = reinterpret_cast<bf16_t*>(smem_raw + lay.w1);
  float* hid = reinterpret_cast<float*>(smem_raw + lay.hid);
  float* bk = reinterpret_cast<float*>(smem_raw + lay.bk);
  float4* lnw = reinterpret_cast<float4*>(smem_raw + lay.ln);
  const int Kp = lay.Kp, S1 = lay.S1, NPp = lay.NPp, Sh = lay.Sh, KW = Kp / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * kTileW;
  const long L = (long)H * W;
  const bf16_t* xb = x + (long)b * C * L;
  const bf16_t zero = __float2bfloat16_rn(0.f);

  // the haloed tile, pixel-major: word w of pixel p's row holds channels 2w
  // and 2w + 1 (0 outside the image, past NP and past C). An item is 8
  // channels of one pixel, stored as one 16-byte word (a quarter-warp's
  // rows on distinct banks); neighbouring threads take neighbouring
  // pixels, so each channel's loads are coalesced.
  for (int i = tid; i < (Kp / 8) * NPp; i += kStemThreads) {
    const int q = i / NPp, p = i - q * NPp, cq = 8 * q;
    const int hy = p / g.WW, hx = p - hy * g.WW;
    const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
    bf16_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = zero;
    if (p < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const bf16_t* xp = xb + cq * L + (long)gy * W + gx;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (cq + e < C) v[e] = xp[e * L];
    }
    *reinterpret_cast<uint4*>(xh + (long)p * S1 + cq) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
  if (SPLIT)  // the LN's scale and shift of channels 2w, 2w + 1 (0 past C)
    for (int w = tid; w < KW; w += kStemThreads) {
      const int c = 2 * w;
      lnw[w] = make_float4(c < C ? lns[c] : 0.f, c + 1 < C ? lns[c + 1] : 0.f,
                           c < C ? lnb[c] : 0.f, c + 1 < C ? lnb[c + 1] : 0.f);
    }
  __syncthreads();

  if (SPLIT) {
    // LN over C per pixel, four lanes a pixel (fp32 stats; the variance
    // from sums shifted by the pixel's first channel, which centres them
    // to within a few of its deviations; eps 1e-5): the output y as
    // hi = bf16(y) in place and lo = bf16(y - hi); 0 at pixels outside the
    // image and at channels past C (scale and shift 0 there)
    const float invc = 1.f / (float)C;
    for (int pg = warp; pg < NPp / 8; pg += kStemThreads / 32) {
      const int p = pg * 8 + gq;
      const int hy = p / g.WW, hx = p - hy * g.WW;
      const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
      const bool in = p < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      __nv_bfloat162* hrow = reinterpret_cast<__nv_bfloat162*>(xh + (long)p * S1);
      __nv_bfloat162* lrow = reinterpret_cast<__nv_bfloat162*>(xl + (long)p * S1);
      const float xr = __low2float(hrow[0]);
      float s1 = 0.f, s2 = 0.f;
      for (int w = tq; w < KW; w += 4) {
        const float2 v = __bfloat1622float2(hrow[w]);
        const float d0 = 2 * w < C ? v.x - xr : 0.f, d1 = 2 * w + 1 < C ? v.y - xr : 0.f;
        s1 += d0 + d1;
        s2 = fmaf(d0, d0, fmaf(d1, d1, s2));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float ms = s1 * invc, m = xr + ms;
      const float inv = rsqrtf(fmaxf(s2 * invc - ms * ms, 0.f) + 1e-5f);
      for (int w = tq; w < KW; w += 4) {
        const float2 v = __bfloat1622float2(hrow[w]);
        const float4 ab = lnw[w];
        const float y0 = in ? (v.x - m) * inv * ab.x + ab.z : 0.f;
        const float y1 = in ? (v.y - m) * inv * ab.y + ab.w : 0.f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(y0, y1);
        const float2 hf = __bfloat1622float2(hi);
        hrow[w] = hi;
        lrow[w] = __floats2bfloat162_rn(y0 - hf.x, y1 - hf.y);
      }
    }
  }

  for (int j0 = 0; j0 < Dh; j0 += 16 * MT) {
    const int nj = min(16 * MT, Dh - j0);
    __syncthreads();  // the tile is staged; the previous chunk's readers are done
    // the chunk's W1 rows, exact in bf16 (the wrapper rounded them), and b1
    for (int i = tid; i < 16 * MT * KW; i += kStemThreads) {
      const int k = i / KW, w = i - k * KW, c = 2 * w;
      const float* wr = W1 + (long)(j0 + k) * C;
      const float a0 = (k < nj && c < C) ? wr[c] : 0.f;
      const float a1 = (k < nj && c + 1 < C) ? wr[c + 1] : 0.f;
      reinterpret_cast<__nv_bfloat162*>(w1s + k * S1)[w] = __floats2bfloat162_rn(a0, a1);
    }
    for (int k = tid; k < 16 * MT; k += kStemThreads)
      bk[k] = (k < nj && b1 != nullptr) ? b1[j0 + k] : 0.f;
    __syncthreads();

    // hid = W1 chunk . tile over every halo pixel: M = 16 MT, N = NPp, K = Kp
    for (int nt = warp; nt < NPp / 8; nt += kStemThreads / 32) {
      float d[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[m][e] = 0.f;
      const bf16_t* bh = xh + (nt * 8 + gq) * S1 + 2 * tq;
      const bf16_t* bl = xl + (nt * 8 + gq) * S1 + 2 * tq;
      for (int k0 = 0; k0 < Kp; k0 += 16) {
        const uint32_t h0 = ld32(bh + k0), h1 = ld32(bh + k0 + 8);
        uint32_t l0 = 0, l1 = 0;
        if (SPLIT) {
          l0 = ld32(bl + k0);
          l1 = ld32(bl + k0 + 8);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          load_a(a, w1s, S1, 16 * m, k0, gq, tq);
          mma16816(d[m], a, h0, h1);
          if (SPLIT) mma16816(d[m], a, l0, l1);
        }
      }
      // pixels p and p + 1 of rows 16 m + gq (+ 8): + b1 inside the image, 0 outside
      const int p = nt * 8 + 2 * tq;
      bool in[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hy = (p + e) / g.WW, hx = p + e - hy * g.WW;
        const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
        in[e] = p + e < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * m + gq + 8 * half;
          const float bv = bk[row];
          *reinterpret_cast<float2*>(hid + row * Sh + p) =
              make_float2(in[0] ? d[m][2 * half] + bv : 0.f, in[1] ? d[m][2 * half + 1] + bv : 0.f);
        }
    }
    __syncthreads();

    // depthwise 3x3 (+bdw), SiLU: a thread per (hidden channel, tile column)
    // down the tile's rows
    for (int i = tid; i < nj * kTileW; i += kStemThreads) {
      const int k = i / kTileW, tx = i - k * kTileW, gx = c0 + tx;
      if (gx >= W) continue;
      const int j = j0 + k;
      const float* hr = hid + k * Sh + tx;
      bf16_t* oc = out + ((long)b * Dh + j) * L + gx;
      const float bj = bdw != nullptr ? bdw[j] : 0.f;
      switch (TH) {
        case 8: dw_column<8>(hr, dw + j * 9, bj, oc, r0, H, W); break;
        case 4: dw_column<4>(hr, dw + j * 9, bj, oc, r0, H, W); break;
        case 2: dw_column<2>(hr, dw + j * 9, bj, oc, r0, H, W); break;
        default: dw_column<1>(hr, dw + j * 9, bj, oc, r0, H, W); break;
      }
    }
  }
}

template <int MT, bool SPLIT>
int launch_stem_tc_mt(const StemTcPlan& pl, const void* x, const float* lns, const float* lnb,
                      const float* W1, const float* b1, const float* dw, const float* bdw,
                      void* out, int B, int C, int Dh, int H, int W, cudaStream_t stream) {
  cudaError_t e = allow_smem(stem_tc_kernel<MT, SPLIT>, pl.smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTileW - 1) / kTileW, (H + pl.TH - 1) / pl.TH, B);
  stem_tc_kernel<MT, SPLIT><<<grid, kStemThreads, pl.smem, stream>>>(
      static_cast<const bf16_t*>(x), lns, lnb, W1, b1, dw, bdw, static_cast<bf16_t*>(out), C,
      Dh, H, W, pl.TH);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int launch_stem_tc_split(const void* x, const float* lns, const float* lnb, const float* W1,
                         const float* b1, const float* dw, const float* bdw, void* out, int B,
                         int C, int Dh, int H, int W, cudaStream_t s) {
  const StemTcPlan pl = stem_tc_plan(C, Dh, SPLIT);
#define BEM_STEM_TC(MT) \
  launch_stem_tc_mt<MT, SPLIT>(pl, x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W, s)
  switch (pl.MT) {
    case 1: return BEM_STEM_TC(1);
    case 2: return BEM_STEM_TC(2);
    case 3: return BEM_STEM_TC(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BEM_STEM_TC
}

// ---------------------------------------------------------------------------
// the tensor-core form of the fp32 stream

// byte offsets of the fp32 form's shared-memory regions; every region
// 16-byte aligned
struct StemTc32Layout {
  int Kp, S1, NPp, Sh, MC;
  size_t xs, w1, hid, bk, total;
  __host__ __device__ StemTc32Layout(int C, int MT, int TH) {
    const Tile g(TH);
    Kp = (C + 7) / 8 * 8;  // the k-steps of 8
    S1 = Kp + 4;           // fp32 stride of a pixel / W1 row, 4 mod 8: conflict-free fragments
    NPp = (g.NP + 7) / 8 * 8;
    Sh = NPp % 16 ? NPp : NPp + 8;
    MC = 16 * MT;
    xs = 0;                                // fp32 (NPp, S1): the tile
    w1 = xs + (size_t)NPp * S1 * 4;        // fp32 (MC, S1): the W1 chunk
    hid = w1 + (size_t)MC * S1 * 4;        // fp32 (MC, Sh): the hidden chunk
    bk = hid + (size_t)MC * Sh * 4;        // fp32 (MC,): its b1
    total = bk + (size_t)MC * 4;
  }
};

struct StemTc32Plan {
  int TH, MT, nsplit;  // TH = 0: nothing fits
  size_t smem;
};

// Tiles whose halo is at most 1.6x their pixels (TH 8, then 4) before the
// rest, two blocks an SM before one, the largest chunk that fits; where
// the pixel grid gives fewer blocks than the card has SMs, chunks of 16
// hidden channels, split across blocks.
inline StemTc32Plan stem_tc32_plan(int B, int C, int Dh, int H, int W) {
  const int mtmax = (Dh + 15) / 16 < kStemMaxMT ? (Dh + 15) / 16 : kStemMaxMT;
  const int ths[2][2] = {{8, 4}, {2, 1}};
  const size_t budgets[2] = {kStemTwoBlocks, kStemOneBlock};
  StemTc32Plan pl{0, 0, 1, 0};
  for (int set = 0; set < 2 && pl.TH == 0; ++set)
    for (size_t budget : budgets)
      for (int th : ths[set])
        for (int mt = mtmax; mt >= 1 && pl.TH == 0; --mt) {
          const size_t sm = StemTc32Layout(C, mt, th).total;
          if (sm <= budget) pl = StemTc32Plan{th, mt, 1, sm};
        }
  if (pl.TH == 0) return pl;
  const long blocks = (long)((W + kTileW - 1) / kTileW) * ((H + pl.TH - 1) / pl.TH) * B;
  if (blocks < kCardSMs) {
    const long nch = (Dh + 15) / 16, want = (kCardSMs + blocks - 1) / blocks;
    pl.MT = 1;
    pl.smem = StemTc32Layout(C, 1, pl.TH).total;
    pl.nsplit = (int)(want < nch ? want : nch);
  }
  return pl;
}

// The depthwise 3x3 (+bj), SiLU and the fp32 store of one hidden channel
// down one tile column (conv_column's window), oc the channel's output at
// the column's image column.
template <int TH>
__device__ __forceinline__ void silu_column(const float* hr, const float* __restrict__ tp,
                                            float bj, float* oc, int r0, int H, int W) {
  float v[TH];
  conv_column<TH>(hr, tp, bj, v);
#pragma unroll
  for (int ty = 0; ty < TH; ++ty)
    if (r0 + ty < H) oc[(long)(r0 + ty) * W] = v[ty] / (1.f + expf(-v[ty]));
}

template <int MT>
__global__ void __launch_bounds__(kStemThreads, 2)
stem_tc32_kernel(const float* __restrict__ x, const float* __restrict__ lns,
                 const float* __restrict__ lnb, const float* __restrict__ W1,
                 const float* __restrict__ b1, const float* __restrict__ dw,
                 const float* __restrict__ bdw, float* __restrict__ out, int C, int Dh, int H,
                 int W, int TH, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int MC = 16 * MT;
  const Tile g(TH);
  const StemTc32Layout lay(C, MT, TH);
  const int Kp = lay.Kp, S1 = lay.S1, NPp = lay.NPp, Sh = lay.Sh;
  float* xs = reinterpret_cast<float*>(smem_raw + lay.xs);
  float* w1s = reinterpret_cast<float*>(smem_raw + lay.w1);
  float* hid = reinterpret_cast<float*>(smem_raw + lay.hid);
  float* bk = reinterpret_cast<float*>(smem_raw + lay.bk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tq = lane & 3, gq = lane >> 2;
  const int split = blockIdx.z % nsplit, b = blockIdx.z / nsplit;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * kTileW;
  const long L = (long)H * W;

  stage_tile_f32<false>(x + (long)b * C * L, lns, lnb, xs, nullptr, g, C, Kp, S1, NPp, H, W, r0,
                        c0, kStemThreads);

  for (int j0 = split * MC; j0 < Dh; j0 += nsplit * MC) {
    const int nj = min(MC, Dh - j0);
    __syncthreads();  // the tile is staged; the previous chunk's readers are done
    // the chunk's W1 rows (0 past nj and C) and b1
    for (int i = tid; i < MC * Kp; i += kStemThreads) {
      const int k = i / Kp, c = i - k * Kp;
      w1s[k * S1 + c] = (k < nj && c < C) ? W1[(long)(j0 + k) * C + c] : 0.f;
    }
    for (int k = tid; k < MC; k += kStemThreads)
      bk[k] = (k < nj && b1 != nullptr) ? b1[j0 + k] : 0.f;
    __syncthreads();

    // hid = W1 chunk . tile over every halo pixel: M = MC, N = NPp, K = Kp,
    // in k-steps of 8, three tf32 products each
    for (int nt = warp; nt < NPp / 8; nt += kStemThreads / 32) {
      float d[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[m][e] = 0.f;
      for (int k0 = 0; k0 < Kp; k0 += 8) {
        uint32_t bb[2], bs[2];
        load_b_tf32(bb, bs, xs, S1, nt * 8, k0, gq, tq);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t ab[4], as[4];
          load_a_tf32(ab, as, w1s, S1, 16 * m, k0, gq, tq);
          mma3_tf32(d[m], ab, as, bb, bs);
        }
      }
      // pixels p and p + 1 of rows 16 m + gq (+ 8): + b1 inside the image, 0 outside
      const int p = nt * 8 + 2 * tq;
      bool in[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hy = (p + e) / g.WW, hx = p + e - hy * g.WW;
        const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
        in[e] = p + e < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * m + gq + 8 * half;
          const float bv = bk[row];
          *reinterpret_cast<float2*>(hid + row * Sh + p) =
              make_float2(in[0] ? d[m][2 * half] + bv : 0.f, in[1] ? d[m][2 * half + 1] + bv : 0.f);
        }
    }
    __syncthreads();

    // depthwise 3x3 (+bdw), SiLU, fp32 stores: a thread per (hidden
    // channel, tile column) down the tile's rows
    for (int i = tid; i < nj * kTileW; i += kStemThreads) {
      const int k = i / kTileW, tx = i - k * kTileW, gx = c0 + tx;
      if (gx >= W) continue;
      const int j = j0 + k;
      const float* hr = hid + k * Sh + tx;
      float* oc = out + ((long)b * Dh + j) * L + gx;
      const float bj = bdw != nullptr ? bdw[j] : 0.f;
      switch (TH) {
        case 8: silu_column<8>(hr, dw + j * 9, bj, oc, r0, H, W); break;
        case 4: silu_column<4>(hr, dw + j * 9, bj, oc, r0, H, W); break;
        case 2: silu_column<2>(hr, dw + j * 9, bj, oc, r0, H, W); break;
        default: silu_column<1>(hr, dw + j * 9, bj, oc, r0, H, W); break;
      }
    }
  }
}

template <int MT>
int launch_stem_tc32_mt(const StemTc32Plan& pl, const void* x, const float* lns,
                        const float* lnb, const float* W1, const float* b1, const float* dw,
                        const float* bdw, void* out, int B, int C, int Dh, int H, int W,
                        cudaStream_t stream) {
  cudaError_t e = allow_smem(stem_tc32_kernel<MT>, pl.smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTileW - 1) / kTileW, (H + pl.TH - 1) / pl.TH, B * pl.nsplit);
  stem_tc32_kernel<MT><<<grid, kStemThreads, pl.smem, stream>>>(
      static_cast<const float*>(x), lns, lnb, W1, b1, dw, bdw, static_cast<float*>(out), C, Dh,
      H, W, pl.TH, pl.nsplit);
  return (int)cudaGetLastError();
}

inline int launch_stem_tc32(const void* x, const float* lns, const float* lnb, const float* W1,
                            const float* b1, const float* dw, const float* bdw, void* out, int B,
                            int C, int Dh, int H, int W, cudaStream_t s) {
  const StemTc32Plan pl = stem_tc32_plan(B, C, Dh, H, W);
#define BEM_STEM_TC32(MT) \
  launch_stem_tc32_mt<MT>(pl, x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W, s)
  switch (pl.MT) {
    case 1: return BEM_STEM_TC32(1);
    case 2: return BEM_STEM_TC32(2);
    case 3: return BEM_STEM_TC32(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BEM_STEM_TC32
}

}  // namespace bem

// C and Dh <= 256 run the tensor-core forms (bf16: stem_tc_kernel; fp32:
// stem_tc32_kernel), wider nets the CUDA-core form.
extern "C" int bem_stem_fused(const void* x, const float* lns, const float* lnb,
                              const float* W1, const float* b1, const float* dw,
                              const float* bdw, void* out, int B, int C, int Dh, int H, int W,
                              int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (C <= bem::kTcMaxC && Dh <= bem::kTcMaxC) {
    if (!bf16)
      return bem::launch_stem_tc32(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W, s);
    if (lns != nullptr)
      return bem::launch_stem_tc_split<true>(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W,
                                             s);
    return bem::launch_stem_tc_split<false>(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W,
                                            s);
  }
  if (bf16)
    return bem::launch_stem<__nv_bfloat16>(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W,
                                           s);
  return bem::launch_stem<float>(x, lns, lnb, W1, b1, dw, bdw, out, B, C, Dh, H, W, s);
}

// The form bem_stem_fused runs: 0 the CUDA-core form, n >= 1 a tensor-core
// form with its hidden width split over n blocks a tile (1 on bf16), -1
// where no fp32 plan fits.
extern "C" int bem_stem_form(int B, int C, int Dh, int H, int W, int bf16) {
  if (C > bem::kTcMaxC || Dh > bem::kTcMaxC) return 0;
  if (bf16) return 1;
  const bem::StemTc32Plan pl = bem::stem_tc32_plan(B, C, Dh, H, W);
  return pl.TH ? pl.nsplit : -1;
}
