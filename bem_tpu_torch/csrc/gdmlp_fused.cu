// Fused gated-dconv MLP block branch, channel-first (B, C, H*W):
//   out = [x +] W2 . (GELU_erf(h1) * h2) + b2,  [h1; h2] = dw3x3(W1 . LN(x) + b1) + bdw
// The 2h-wide hidden activation never leaves the SM.
//
// Replaces bem_tpu/ops/gdmlp_fused.py::gdmlp_fused_cf (Pallas body _body
// :223, pallas_call :431). Two forms, one function:
//
// gdmlp_tc_kernel, the bf16 stream (C, Cout <= 256): both 1x1 projections
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate). On
// this stream both products' activations are bf16-exact already: the LN
// output is rounded to bf16 before W1 and the gate before W2, as in the
// Pallas kernel. The weights stay fp32 as interpret mode keeps them
// (gdmlp_fused.py:369-372, wdt = fp32 off the TPU), which the port's tests
// pin: the staging loops split each weight chunk into hi = bf16(W) and
// lo = bf16(W - hi) as they copy it to shared memory, and every product
// runs twice, hi and lo, into the same fp32 accumulators, which keeps W to
// about 2^-17 relative. (The TPU kernel itself rounds the
// weights to bf16, wdt = bf16 on TPU at :370, and so does bem_tpu's oracle
// _gdmlp_ref with mx(W1) / mx(W2); the backward follows that oracle.)
// One block of 8 warps per (2*NT) x 32 pixel tile: the haloed tile sits in
// shared memory pixel-major as bf16 (K = C padded to 16 with zeros); the
// hidden width is walked in chunks of 16 gate + 16 value channels, each
// projected over the halo on the tensor cores into an fp32 hidden chunk
// (0 at halo pixels outside the image: the depthwise conv's zero padding,
// not b1), convolved, gated (exact erf), rounded to bf16 into shared memory
// and multiplied by the W2 chunk (Cout padded to 16) into accumulators
// that stay in registers across chunks. Bound: operations, but no
// longer the products: the depthwise 3x3 and the exact-erf GELU on the
// CUDA cores (9 FMAs and shared-memory reads per hidden value and pixel) and two
// blocks an SM (128 registers, 107 KB of shared memory at C = 40) are what
// hold it above smoke.py's bound, which counts the products at the tensor
// cores' rate and the rest at the fp32 rate.
//
// gdmlp_kernel, the fp32 stream (IE training) and C or Cout above 256:
// both projections as fp32 FMAs on the CUDA cores, out of shared memory,
// the accumulator in shared memory, in the same tiling and chunking.
#include "conv_tile.cuh"
#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core form (bf16 stream)

constexpr int kGs = kGate + 8;  // bf16 stride of a gate / W2 row (+8: no bank conflicts)

// pixel n-tiles of 8 a warp accumulates in the W2 product: MT m-tiles of 16
// output channels x NT n-tiles x 4 fp32 stay in registers; the tile is
// 2*NT rows of 32 pixels (8 warps x NT x 8 pixels)
__host__ __device__ constexpr int tc_nt(int MT) { return MT <= 3 ? 4 : (MT <= 8 ? 2 : 1); }

// byte offsets of the shared-memory regions; every region 16-byte aligned
struct TcLayout {
  int Kp, S1, NPp, Coutp, TQ;
  size_t xs, w1, hid, bk, gs, w2, total;
  __host__ __device__ TcLayout(int C, int Coutp_, int TH) {
    const Tile g(TH);
    Kp = (C + 15) / 16 * 16;
    S1 = Kp + 8;  // bf16 stride of a pixel / W1 row: conflict-free fragment loads
    NPp = (g.NP + 7) / 8 * 8;
    Coutp = Coutp_;
    TQ = g.TQ;
    xs = 0;                                          // bf16 (NPp, S1): the LN'd tile
    w1 = xs + (size_t)NPp * S1 * 2;                  // bf16 (2, kHid, S1): W1 chunk hi, lo
    hid = w1 + (size_t)2 * kHid * S1 * 2;            // fp32 (kHid, NPp): hidden chunk
    bk = hid + (size_t)kHid * NPp * 4;               // fp32 (kHid,): its b1
    gs = bk + (size_t)kHid * 4;                      // bf16 (TQ, kGs): the gate chunk
    w2 = gs + (size_t)TQ * kGs * 2;                  // bf16 (2, Coutp, kGs): W2 chunk hi, lo
    const size_t end = w2 + (size_t)2 * Coutp * kGs * 2;
    const size_t epi = (size_t)Coutp * TQ * 4;       // fp32 (Coutp, TQ): the output tile
    total = end > epi ? end : epi;
  }
};

template <int MT>
__global__ void __launch_bounds__(kThreads)
gdmlp_tc_kernel(const bf16_t* __restrict__ x, const float* __restrict__ lns,
                const float* __restrict__ lnb, const float* __restrict__ W1,
                const float* __restrict__ b1, const float* __restrict__ dw,
                const float* __restrict__ bdw, const float* __restrict__ W2,
                const float* __restrict__ b2, bf16_t* __restrict__ out, int C, int h, int Cout,
                int H, int W, int residual) {
  constexpr int NT = tc_nt(MT), TH = 2 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g(TH);
  const TcLayout lay(C, 16 * MT, TH);
  bf16_t* xs = reinterpret_cast<bf16_t*>(smem_raw + lay.xs);
  bf16_t* w1s = reinterpret_cast<bf16_t*>(smem_raw + lay.w1);
  float* hid = reinterpret_cast<float*>(smem_raw + lay.hid);
  float* bk = reinterpret_cast<float*>(smem_raw + lay.bk);
  bf16_t* gs = reinterpret_cast<bf16_t*>(smem_raw + lay.gs);
  bf16_t* w2s = reinterpret_cast<bf16_t*>(smem_raw + lay.w2);
  const int Kp = lay.Kp, S1 = lay.S1, NPp = lay.NPp, Coutp = lay.Coutp, TQ = lay.TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * kTileW;
  const long L = (long)H * W;
  const bf16_t* xb = x + (long)b * C * L;

  load_tile_ln_pm(xb, lns, lnb, xs, g, C, Kp, S1, NPp, H, W, r0, c0);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int j0 = 0; j0 < h; j0 += kGate) {
    const int nj = min(kGate, h - j0);
    __syncthreads();  // the tile is staged; the previous chunk's readers are done
    // hidden row k < kGate is gate channel j0+k, row kGate+k its value
    // channel; each weight is stored as hi, then lo a kHid-row block later
    for (int i = tid; i < kHid * Kp; i += kThreads) {
      const int k = i / Kp, c = i - k * Kp, kk = k & (kGate - 1);
      const int ch = (k < kGate ? 0 : h) + j0 + kk;
      split_store(w1s + k * S1 + c, kHid * S1, (kk < nj && c < C) ? W1[(long)ch * C + c] : 0.f);
    }
    for (int k = tid; k < kHid; k += kThreads) {
      const int kk = k & (kGate - 1);
      const int ch = (k < kGate ? 0 : h) + j0 + kk;
      bk[k] = (kk < nj && b1 != nullptr) ? b1[ch] : 0.f;
    }
    for (int i = tid; i < Coutp * kGate; i += kThreads) {
      const int co = i / kGate, k = i - co * kGate;
      split_store(w2s + co * kGs + k, Coutp * kGs,
                  (co < Cout && k < nj) ? W2[(long)co * h + j0 + k] : 0.f);
    }
    __syncthreads();

    // hid = W1 chunk . tile over every halo pixel: M = 32 rows, N = NPp, K = Kp
    for (int nt = warp; nt < NPp / 8; nt += kThreads / 32) {
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16_t* brow = xs + (nt * 8 + gq) * S1 + 2 * tq;
      for (int k0 = 0; k0 < Kp; k0 += 16) {
        const uint32_t bb0 = ld32(brow + k0), bb1 = ld32(brow + k0 + 8);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            uint32_t a[4];
            load_a(a, w1s + part * kHid * S1, S1, 16 * m, k0, gq, tq);
            mma16816(d[m], a, bb0, bb1);
          }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = nt * 8 + 2 * tq + (e & 1);
        if (p >= g.NP) continue;
        const int hy = p / g.WW, hx = p - hy * g.WW;
        const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
        const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = 16 * m + gq + (e >= 2 ? 8 : 0);
          hid[row * NPp + p] = valid ? d[m][e] + bk[row] : 0.f;
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < kGate * TQ; i += kThreads) {
      const int k = i / TQ, q = i - k * TQ;
      float gv = 0.f;
      if (k < nj) {
        const int ty = q / kTileW, tx = q - ty * kTileW;
        const int ja = j0 + k, jb = h + j0 + k;
        float a = dw3x3(hid + k * NPp, dw + ja * 9, g.WW, ty, tx);
        float v = dw3x3(hid + (kGate + k) * NPp, dw + jb * 9, g.WW, ty, tx);
        if (bdw != nullptr) {
          a += bdw[ja];
          v += bdw[jb];
        }
        gv = 0.5f * a * (1.f + erff(a * 0.70710678118654752f)) * v;
      }
      gs[q * kGs + k] = __float2bfloat16_rn(gv);  // the gate, rounded to bf16
    }
    __syncthreads();

    // acc += W2 chunk . gate: M = Coutp, N = this warp's NT pixel tiles, K = 16
    uint32_t bq[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16_t* p = gs + ((warp * NT + n) * 8 + gq) * kGs + 2 * tq;
      bq[n][0] = ld32(p);
      bq[n][1] = ld32(p + 8);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        uint32_t a[4];
        load_a(a, w2s + part * Coutp * kGs, kGs, 16 * m, 0, gq, tq);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma16816(acc[m][n], a, bq[n][0], bq[n][1]);
      }
  }
  __syncthreads();

  // the output tile through shared memory, for stores coalesced along rows
  float* os = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int co = 16 * m + gq, q = (warp * NT + n) * 8 + 2 * tq;
      os[co * TQ + q] = acc[m][n][0];
      os[co * TQ + q + 1] = acc[m][n][1];
      os[(co + 8) * TQ + q] = acc[m][n][2];
      os[(co + 8) * TQ + q + 1] = acc[m][n][3];
    }
  __syncthreads();
  bf16_t* ob = out + (long)b * Cout * L;
  for (int i = tid; i < Cout * TQ; i += kThreads) {
    const int co = i / TQ, q = i - co * TQ;
    const int ty = q / kTileW, tx = q - ty * kTileW;
    const int gy = r0 + ty, gx = c0 + tx;
    if (gy >= H || gx >= W) continue;
    const long pos = (long)gy * W + gx;
    float s = os[i];
    if (b2 != nullptr) s += b2[co];
    if (residual) s += __bfloat162float(xb[(long)co * L + pos]);
    ob[(long)co * L + pos] = __float2bfloat16_rn(s);
  }
}

template <int MT>
int launch_gdmlp_tc_mt(const void* x, const float* lns, const float* lnb, const float* W1,
                       const float* b1, const float* dw, const float* bdw, const float* W2,
                       const float* b2, void* out, int B, int C, int h, int Cout, int H, int W,
                       int residual, cudaStream_t stream) {
  constexpr int TH = 2 * tc_nt(MT);
  const size_t smem = TcLayout(C, 16 * MT, TH).total;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(gdmlp_tc_kernel<MT>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  gdmlp_tc_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16_t*>(x), lns, lnb, W1, b1, dw, bdw, W2, b2,
      static_cast<bf16_t*>(out), C, h, Cout, H, W, residual);
  return (int)cudaGetLastError();
}

// the tensor-core form: m-tiles of 16 output channels, rounded up to an
// instantiated count
inline int launch_gdmlp_tc(const void* x, const float* lns, const float* lnb, const float* W1,
                           const float* b1, const float* dw, const float* bdw, const float* W2,
                           const float* b2, void* out, int B, int C, int h, int Cout, int H,
                           int W, int residual, cudaStream_t s) {
#define BEM_TC(MT)                                                                          \
  return launch_gdmlp_tc_mt<MT>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C, h, Cout, H, \
                                W, residual, s)
  const int mt = (Cout + 15) / 16;
  if (mt <= 1) BEM_TC(1);
  if (mt <= 2) BEM_TC(2);
  if (mt <= 3) BEM_TC(3);
  if (mt <= 5) BEM_TC(5);
  if (mt <= 8) BEM_TC(8);
  if (mt <= 10) BEM_TC(10);
  BEM_TC(16);
#undef BEM_TC
}

}  // namespace bem

// bf16 with C and Cout <= 256 runs the tensor-core form, the rest the
// CUDA-core form.
extern "C" int bem_gdmlp_fused(const void* x, const float* lns, const float* lnb,
                               const float* W1, const float* b1, const float* dw,
                               const float* bdw, const float* W2, const float* b2, void* out,
                               int B, int C, int h, int Cout, int H, int W, int residual,
                               int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && C <= bem::kTcMaxC && Cout <= bem::kTcMaxC)
    return bem::launch_gdmlp_tc(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C, h, Cout, H, W,
                                residual, s);
  if (bf16)
    return bem::launch_gdmlp<__nv_bfloat16>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C,
                                            h, Cout, H, W, residual, 1, s);
  return bem::launch_gdmlp<float>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C, h, Cout, H,
                                  W, residual, 0, s);
}
