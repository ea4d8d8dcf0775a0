// Fused gated-dconv MLP block branch, channel-first (B, C, H*W):
//   out = [x +] W2 . (GELU_erf(h1) * h2) + b2,  [h1; h2] = dw3x3(W1 . LN(x) + b1) + bdw
// The 2h-wide hidden activation never leaves the SM.
//
// Replaces bem_tpu/ops/gdmlp_fused.py::gdmlp_fused_cf (Pallas body _body
// :223, pallas_call :431). Three forms, one function, picked by the entry
// point bem_gdmlp_fused:
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
// gdmlp_tc32_kernel, the fp32 stream (the eval CLI, the LOLv1 train steps;
// C, Cout <= 256): the same two projections on the tensor cores at fp32
// accuracy. On this stream every operand is fp32: the LN output, W1, the
// gate (not rounded) and W2. Each is split into hi = bf16(v) and
// lo = bf16(v - hi): the tile and the gate as they are staged, the
// weights once a call by gdmlp_tc32_image_kernel, which writes each
// chunk's W1, b1, taps, bdw and W2 to a workspace as the shared memory
// holds them, so that a block stages a chunk by cp.async (the next
// chunk's W1, b1 and taps while this chunk's gate and W2 product run)
// and never waits on global loads of its own weights or splits them
// again. Each product runs three times
// into one fp32 accumulator, hi.hi + lo.hi + hi.lo (mma3; lo.lo and the
// splits' rests are about 2^-16 of sum |w| |v|, well inside the fp32 card
// tolerance of 2e-4): three times the tensor-core work of one bf16
// product, about 330 TFLOP/s of fp32-accurate products on this card.
// Blocks of 16 warps (512 threads) take 4 x 32 pixel tiles, a (4 + 2) x
// 34 halo (1.59 x the W1 product of the output pixels; 2 x 32 only where
// the shared memory needs it, C above about 200), and the W2
// accumulators stay in registers: each warp owns one 8-pixel n-tile and
// all Cout / 16 m-tiles (40 registers at Cout = 160). Two blocks share
// an SM where a warp holds at most 3 m-tiles (64 registers; 100 KB of
// shared memory at C = 40), so one block's CUDA-core phase overlaps the
// other's products; wider levels take one block an SM (the hi + lo tile
// alone is 140 KB at C = 160). Per chunk of 16 gate + 16 value
// channels: the W1 product over the halo (a warp per one n-tile, two
// with one block an SM, both m-tiles, ldmatrix fragments), the
// depthwise 3x3 (+bdw) and the exact-erf GELU on the CUDA cores, one
// thread per (gate channel, tile column) down the tile's rows with the
// window in registers, the fp32 gate split into hi + lo, and the W2
// product. Where the pixel grid gives fewer blocks than the card has SMs
// (the eval CG's B = 1 levels: 2 blocks at 7x10), the hidden chunks are
// split across blocks (blockIdx.z = image x split); each split writes its
// partial W2 output to a workspace the wrapper allocates, and
// gdmlp_split_sum_kernel adds the partials in split order, then b2 and
// the residual: no atomics, the same bits every run. Bound: operations. smoke.py counts the
// products at a third of the bf16 tensor-core peak and the depthwise conv
// and GELU at the fp32 rate; what holds the kernel above that is the
// per-chunk sequence of phases behind __syncthreads (the tensor-core W1
// product, the CUDA-core depthwise conv and GELU, the W2 product) with
// one block an SM at C = 80 and 160, the halo recompute, and the depthwise
// conv's shared-memory reads ((TH + 2) x 3 a column per TH outputs).
//
// gdmlp_kernel, C or Cout above 256 (either stream): both projections as
// fp32 FMAs on the CUDA cores, out of shared memory, the accumulator in
// shared memory, in the same tiling and chunking.
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

// ---------------------------------------------------------------------------
// the tensor-core form of the fp32 stream

constexpr int kTc32Threads = 512;  // 16 warps
constexpr int kTc32Warps = kTc32Threads / 32;
static_assert(kTc32Threads == kGate * kTileW, "the gate phase takes a thread per (channel, column)");
constexpr size_t kBlockSmem = 227 * 1024;  // the most a block may take

// byte offsets of the fp32 form's shared-memory regions; every region
// 16-byte aligned. w1 .. w2 is one chunk's image: the weights of 16 gate +
// 16 value channels as gdmlp_tc32_image_kernel writes them to global memory
// and the main kernel copies them (img bytes a chunk).
struct Tc32Layout {
  int Kp, S1, NPp, Sh, Coutp, TQ, TQp;
  size_t xh, xl, w1, bk, tap, w2, hid, gh, gl, total, img;
  __host__ __device__ Tc32Layout(int C, int Coutp_, int TH) {
    const Tile g(TH);
    Kp = (C + 15) / 16 * 16;
    S1 = Kp + 8;  // bf16 stride of a pixel / W1 row: conflict-free fragment loads
    NPp = (g.NP + 7) / 8 * 8;
    Sh = NPp % 16 ? NPp : NPp + 8;  // fp32 stride of a hidden row, 8 mod 16
    Coutp = Coutp_;
    TQ = g.TQ;
    TQp = TQ + 8;                          // fp32 stride of an output row, 8 mod 16
    xh = 0;                                // bf16 (NPp, S1): the tile's hi
    xl = xh + (size_t)NPp * S1 * 2;        // bf16 (NPp, S1): its lo
    w1 = xl + (size_t)NPp * S1 * 2;        // bf16 (2, kHid, S1): W1 chunk hi, lo
    bk = w1 + (size_t)2 * kHid * S1 * 2;   // fp32 (kHid,): its b1
    tap = bk + (size_t)kHid * 4;           // fp32 (kHid, 12): its taps, then bdw
    w2 = tap + (size_t)kHid * 12 * 4;      // bf16 (2, Coutp, kGs): W2 chunk hi, lo
    hid = w2 + (size_t)2 * Coutp * kGs * 2;  // fp32 (kHid, Sh): the hidden chunk
    gh = hid + (size_t)kHid * Sh * 4;      // bf16 (TQ, kGs): the gate's hi
    gl = gh + (size_t)TQ * kGs * 2;        // bf16 (TQ, kGs): its lo
    const size_t end = gl + (size_t)TQ * kGs * 2;
    const size_t epi = (size_t)Coutp * TQp * 4;  // fp32 (Coutp, TQp): the output tile
    total = end > epi ? end : epi;
    img = hid - w1;
  }
};

struct Tc32Plan {
  int TH, MT, nsplit, per;  // TH = 0: nothing fits
  size_t smem, img;         // img: the chunk images' bytes, all chunks
};

// Tile height 4 (halo 1.59x), else 2, whichever fits one block's shared
// memory; where the pixel grid gives fewer blocks than the card has SMs,
// the hidden width's nch chunks split into nsplit runs of ``per``. The
// workspace holds the chunk images, then (nsplit > 1) the partial outputs.
inline Tc32Plan gdmlp_tc32_plan(int B, int C, int h, int Cout, int H, int W) {
  const int nch = (h + kGate - 1) / kGate;
  Tc32Plan pl{0, (Cout + 15) / 16, 1, nch, 0, 0};
  for (int th = 4; th >= 2 && pl.TH == 0; th /= 2) {
    const Tc32Layout lay(C, 16 * pl.MT, th);
    if (lay.total <= kBlockSmem) pl = Tc32Plan{th, pl.MT, 1, nch, lay.total, nch * lay.img};
  }
  if (pl.TH == 0) return pl;
  const long blocks = (long)((W + kTileW - 1) / kTileW) * ((H + pl.TH - 1) / pl.TH) * B;
  if (blocks < kCardSMs) {
    const long want = (kCardSMs + blocks - 1) / blocks;
    pl.per = (int)((nch + want - 1) / want);
    pl.nsplit = (nch + pl.per - 1) / pl.per;
  }
  return pl;
}

// The gate of one gate channel down one tile column: the depthwise 3x3
// (+bdw) of its gate and value hidden rows, GELU_erf(a) * v, split into
// bf16 hi and lo at the column's first gate entries (rows kTileW * kGs
// apart); 0 where ``live`` is not set.
template <int TH>
__device__ __forceinline__ void gate_column(const float* ha, const float* hv, const float* ta,
                                            const float* tv, bf16_t* gh, bf16_t* gl, bool live) {
  float a[TH], v[TH];
  conv_column<TH>(hv, tv, tv[9], v);
  conv_column<TH>(ha, ta, ta[9], a);
#pragma unroll
  for (int ty = 0; ty < TH; ++ty) {
    const float gv = live ? 0.5f * a[ty] * (1.f + erff(a[ty] * 0.70710678118654752f)) * v[ty]
                          : 0.f;
    const bf16_t hi = __float2bfloat16_rn(gv);
    gh[ty * kTileW * kGs] = hi;
    gl[ty * kTileW * kGs] = __float2bfloat16_rn(gv - __bfloat162float(hi));
  }
}

// One chunk's weights (blockIdx.x) as the main kernel's shared memory
// holds them, written once a call to the workspace ``img``: hidden row
// k < kGate is gate channel j0+k, row kGate+k its value channel; W1 and
// W2 split into bf16 hi, then lo a block later; b1; per hidden row its 9
// taps and bdw; 0 in every pad.
__global__ void gdmlp_tc32_image_kernel(const float* __restrict__ W1,
                                        const float* __restrict__ b1,
                                        const float* __restrict__ dw,
                                        const float* __restrict__ bdw,
                                        const float* __restrict__ W2, unsigned char* img, int C,
                                        int h, int Cout, int TH) {
  const Tc32Layout lay(C, (Cout + 15) / 16 * 16, TH);
  const int S1 = lay.S1, Coutp = lay.Coutp, j0 = blockIdx.x * kGate, nj = min(kGate, h - j0);
  unsigned char* im = img + blockIdx.x * lay.img;  // offsets from the shared-memory w1
  bf16_t* w1h = reinterpret_cast<bf16_t*>(im);
  float* bk = reinterpret_cast<float*>(im + (lay.bk - lay.w1));
  float* tap = reinterpret_cast<float*>(im + (lay.tap - lay.w1));
  bf16_t* w2h = reinterpret_cast<bf16_t*>(im + (lay.w2 - lay.w1));
  for (int i = threadIdx.x; i < kHid * S1; i += blockDim.x) {
    const int k = i / S1, c = i - k * S1, kk = k & (kGate - 1);
    const int ch = (k < kGate ? 0 : h) + j0 + kk;
    split_store(w1h + i, kHid * S1, (kk < nj && c < C) ? W1[(long)ch * C + c] : 0.f);
  }
  for (int k = threadIdx.x; k < kHid; k += blockDim.x) {
    const int kk = k & (kGate - 1), ch = (k < kGate ? 0 : h) + j0 + kk;
    const bool live = kk < nj;
    for (int e = 0; e < 9; ++e) tap[k * 12 + e] = live ? dw[ch * 9 + e] : 0.f;
    tap[k * 12 + 9] = live && bdw != nullptr ? bdw[ch] : 0.f;
    tap[k * 12 + 10] = tap[k * 12 + 11] = 0.f;
    bk[k] = live && b1 != nullptr ? b1[ch] : 0.f;
  }
  for (int i = threadIdx.x; i < Coutp * kGs; i += blockDim.x) {
    const int co = i / kGs, k = i - co * kGs;
    split_store(w2h + i, Coutp * kGs, (co < Cout && k < nj) ? W2[(long)co * h + j0 + k] : 0.f);
  }
}

// bytes lo .. hi of a chunk image from global src to shared dst by
// cp.async, 16 bytes a thread at a time; the group committed
__device__ __forceinline__ void copy_image(unsigned char* dst, const unsigned char* src, size_t lo,
                                           size_t hi) {
  for (size_t i = lo + 16 * threadIdx.x; i < hi; i += 16 * blockDim.x)
    cp_async16(dst + i, src + i, true);
  cp_async_commit();
}

// Blocks an SM the fp32 form is compiled for: two where each warp holds at
// most 3 m-tiles (64 registers; the C = 40 level's 100 KB of shared memory
// leaves room for two), else one (128 registers).
__host__ __device__ constexpr int tc32_blocks(int MTW) { return MTW <= 3 ? 2 : 1; }

template <int MTW>
__global__ void __launch_bounds__(kTc32Threads, tc32_blocks(MTW))
gdmlp_tc32_kernel(const float* __restrict__ x, const float* __restrict__ lns,
                  const float* __restrict__ lnb, const unsigned char* __restrict__ img,
                  const float* __restrict__ b2, float* __restrict__ out, float* __restrict__ ws,
                  int C, int h, int Cout, int H, int W, int TH, int residual, int nsplit,
                  int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g(TH);
  const int MT = (Cout + 15) / 16;
  const Tc32Layout lay(C, 16 * MT, TH);
  const int Kp = lay.Kp, S1 = lay.S1, NPp = lay.NPp, Sh = lay.Sh, Coutp = lay.Coutp;
  const int TQ = lay.TQ, TQp = lay.TQp;
  bf16_t* xh = reinterpret_cast<bf16_t*>(smem_raw + lay.xh);
  bf16_t* xl = reinterpret_cast<bf16_t*>(smem_raw + lay.xl);
  bf16_t* w1h = reinterpret_cast<bf16_t*>(smem_raw + lay.w1);
  bf16_t* w1l = w1h + kHid * S1;
  float* hid = reinterpret_cast<float*>(smem_raw + lay.hid);
  float* bk = reinterpret_cast<float*>(smem_raw + lay.bk);
  float* tap = reinterpret_cast<float*>(smem_raw + lay.tap);
  bf16_t* gh = reinterpret_cast<bf16_t*>(smem_raw + lay.gh);
  bf16_t* gl = reinterpret_cast<bf16_t*>(smem_raw + lay.gl);
  bf16_t* w2h = reinterpret_cast<bf16_t*>(smem_raw + lay.w2);
  bf16_t* w2l = w2h + Coutp * kGs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int split = blockIdx.z % nsplit, b = blockIdx.z / nsplit;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * kTileW;
  const long L = (long)H * W;
  const float* xb = x + (long)b * C * L;
  const int nch = (h + kGate - 1) / kGate, cbeg = split * per, cend = min(nch, cbeg + per);
  // the chunk images: w1, bk and tap one chunk ahead (issued while the
  // previous chunk's gate and W2 product run), w2 at the chunk's start
  unsigned char* im = smem_raw + lay.w1;
  const size_t i_tap = lay.tap - lay.w1, i_w2 = lay.w2 - lay.w1;
  copy_image(im, img + cbeg * lay.img, 0, i_w2);

  stage_tile_f32<true>(xb, lns, lnb, xh, xl, g, C, Kp, S1, NPp, H, W, r0, c0, kTc32Threads);

  // the W2 product's warps: WN along the tile's TQ / 8 pixel n-tiles (one
  // each), 16 / WN groups of MTW m-tiles
  const int WN = min(kTc32Warps, TQ / 8);
  const int nw = warp % WN, m0 = (warp / WN) * MTW;
  float acc[MTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int ci = cbeg; ci < cend; ++ci) {
    const int nj = min(kGate, h - ci * kGate);
    __syncthreads();  // the previous chunk's W2 product is done with w2
    copy_image(im, img + ci * lay.img, i_w2, lay.img);
    cp_async_wait_all();
    __syncthreads();

    // hid = W1 chunk . tile over every halo pixel (M = 32, N = NPp, K = Kp),
    // three products each: a warp takes NI 8-pixel n-tiles (one where two
    // blocks share the SM's registers), both m-tiles
    constexpr int NI = tc32_blocks(MTW) == 2 ? 1 : 2;
    const int NT1 = NPp / 8;
    for (int np = warp; NI * np < NT1; np += kTc32Warps) {
      const int nt0 = NI * np;
      const bool two = NI == 2 && nt0 + 1 < NT1;
      float d[2][NI][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NI; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[m][n][e] = 0.f;
      for (int k0 = 0; k0 < Kp; k0 += 16) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          ldsm_a(ah[m], w1h, S1, 16 * m, k0, lane);
          ldsm_a(al[m], w1l, S1, 16 * m, k0, lane);
        }
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          if (n == 1 && !two) break;
          uint32_t bh0, bh1, bl0, bl1;
          ldsm_b(bh0, bh1, xh, S1, (nt0 + n) * 8, k0, lane);
          ldsm_b(bl0, bl1, xl, S1, (nt0 + n) * 8, k0, lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma3(d[m][n], ah[m], al[m], bh0, bh1, bl0, bl1);
        }
      }
      // pixels p and p + 1 of rows 16 m + gq (+ 8): + b1 inside the image, 0 outside
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        if (n == 1 && !two) break;
        const int p = (nt0 + n) * 8 + 2 * tq;
        bool in[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int hy = (p + e) / g.WW, hx = p + e - hy * g.WW;
          const int gy = r0 - 1 + hy, gx = c0 - 1 + hx;
          in[e] = p + e < g.NP && gy >= 0 && gy < H && gx >= 0 && gx < W;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * m + gq + 8 * half;
            const float bv = bk[row];
            *reinterpret_cast<float2*>(hid + row * Sh + p) =
                make_float2(in[0] ? d[m][n][2 * half] + bv : 0.f,
                            in[1] ? d[m][n][2 * half + 1] + bv : 0.f);
          }
      }
    }
    __syncthreads();
    if (ci + 1 < cend) copy_image(im, img + (ci + 1) * lay.img, 0, i_tap);

    // the depthwise 3x3, GELU and gate: a thread per (gate channel, tile
    // column), a warp 4 channels x 8 columns (its hidden reads and its
    // gate stores on distinct banks)
    {
      const int k = 4 * (warp & 3) + (lane & 3), tx = 8 * (warp >> 2) + (lane >> 2);
      const float* ha = hid + k * Sh + tx;
      const float* hv = hid + (kGate + k) * Sh + tx;
      const float* ta = tap + k * 12;
      const float* tv = tap + (kGate + k) * 12;
      bf16_t* ghc = gh + tx * kGs + k;
      bf16_t* glc = gl + tx * kGs + k;
      if (TH == 4)
        gate_column<4>(ha, hv, ta, tv, ghc, glc, k < nj);
      else
        gate_column<2>(ha, hv, ta, tv, ghc, glc, k < nj);
    }
    __syncthreads();
    if (ci + 1 < cend) copy_image(im, img + (ci + 1) * lay.img, i_tap, i_w2);

    // acc += W2 chunk . gate: M = this warp's m-tiles, N = its n-tile, K = 16
    uint32_t bh0, bh1, bl0, bl1;
    ldsm_b(bh0, bh1, gh, kGs, nw * 8, 0, lane);
    ldsm_b(bl0, bl1, gl, kGs, nw * 8, 0, lane);
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int m = m0 + i;
      if (m < MT) {
        uint32_t ah[4], al[4];
        ldsm_a(ah, w2h, kGs, 16 * m, 0, lane);
        ldsm_a(al, w2l, kGs, 16 * m, 0, lane);
        mma3(acc[i], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
  __syncthreads();

  // the output tile through shared memory, for stores coalesced along rows
  float* os = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int m = m0 + i;
    if (m < MT) {
      const int co = 16 * m + gq, q = nw * 8 + 2 * tq;
      *reinterpret_cast<float2*>(os + co * TQp + q) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(os + (co + 8) * TQp + q) = make_float2(acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  // one split: + b2 and the residual into out; several: this split's
  // partial into the workspace (split, B, Cout, L)
  float* dst = nsplit > 1 ? ws + ((long)split * (gridDim.z / nsplit) + b) * Cout * L
                          : out + (long)b * Cout * L;
  for (int i = tid; i < Cout * TQ; i += kTc32Threads) {
    const int co = i / TQ, q = i - co * TQ;
    const int ty = q / kTileW, tx = q - ty * kTileW;
    const int gy = r0 + ty, gx = c0 + tx;
    if (gy >= H || gx >= W) continue;
    const long pos = (long)gy * W + gx;
    float s = os[co * TQp + q];
    if (nsplit == 1) {
      if (b2 != nullptr) s += b2[co];
      if (residual) s += xb[(long)co * L + pos];
    }
    dst[(long)co * L + pos] = s;
  }
}

// out = the nsplit partials (n values each) added in split order, + b2 and
// the residual
__global__ void gdmlp_split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ x,
                                       const float* __restrict__ b2, float* __restrict__ out,
                                       long n, int Cout, long L, int nsplit, int residual) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += ws[sp * n + i];
  if (b2 != nullptr) s += b2[(i / L) % Cout];
  if (residual) s += x[i];
  out[i] = s;
}

template <int MTW>
int launch_gdmlp_tc32_mt(const Tc32Plan& pl, const void* x, const float* lns, const float* lnb,
                         const float* W1, const float* b1, const float* dw, const float* bdw,
                         const float* W2, const float* b2, void* out, void* ws, int B, int C,
                         int h, int Cout, int H, int W, int residual, cudaStream_t stream) {
  cudaError_t e = allow_smem(gdmlp_tc32_kernel<MTW>, pl.smem);
  if (e != cudaSuccess) return (int)e;
  unsigned char* img = static_cast<unsigned char*>(ws);
  float* part = reinterpret_cast<float*>(img + pl.img);
  gdmlp_tc32_image_kernel<<<(h + kGate - 1) / kGate, 256, 0, stream>>>(W1, b1, dw, bdw, W2, img,
                                                                       C, h, Cout, pl.TH);
  dim3 grid((W + kTileW - 1) / kTileW, (H + pl.TH - 1) / pl.TH, B * pl.nsplit);
  gdmlp_tc32_kernel<MTW><<<grid, kTc32Threads, pl.smem, stream>>>(
      static_cast<const float*>(x), lns, lnb, img, b2, static_cast<float*>(out), part, C, h,
      Cout, H, W, pl.TH, residual, pl.nsplit, pl.per);
  e = cudaGetLastError();
  if (e != cudaSuccess || pl.nsplit == 1) return (int)e;
  const long n = (long)B * Cout * H * W;
  gdmlp_split_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, static_cast<const float*>(x), b2, static_cast<float*>(out), n, Cout, (long)H * W,
      pl.nsplit, residual);
  return (int)cudaGetLastError();
}

// the fp32 form: each warp's m-tiles (Cout / 16 at tile height 4, half of
// them at 2), rounded up to an instantiated count; an error where nothing
// fits or a split plan has no workspace
inline int launch_gdmlp_tc32(const void* x, const float* lns, const float* lnb, const float* W1,
                             const float* b1, const float* dw, const float* bdw, const float* W2,
                             const float* b2, void* out, void* ws, int B, int C, int h, int Cout,
                             int H, int W, int residual, cudaStream_t s) {
  const Tc32Plan pl = gdmlp_tc32_plan(B, C, h, Cout, H, W);
  if (pl.TH == 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  const int mtw = pl.TH == 4 ? pl.MT : (pl.MT + 1) / 2;
#define BEM_TC32(MTW)                                                                         \
  return launch_gdmlp_tc32_mt<MTW>(pl, x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, ws, B, C, h, \
                                   Cout, H, W, residual, s)
  if (mtw <= 1) BEM_TC32(1);
  if (mtw <= 2) BEM_TC32(2);
  if (mtw <= 3) BEM_TC32(3);
  if (mtw <= 5) BEM_TC32(5);
  if (mtw <= 8) BEM_TC32(8);
  if (mtw <= 10) BEM_TC32(10);
  BEM_TC32(16);
#undef BEM_TC32
}

}  // namespace bem

// C and Cout <= 256 run the tensor-core forms (bf16: gdmlp_tc_kernel; fp32:
// gdmlp_tc32_image_kernel, then gdmlp_tc32_kernel, then where the hidden
// width splits gdmlp_split_sum_kernel, with a workspace of bem_gdmlp_ws
// bytes), wider nets the CUDA-core form.
extern "C" int bem_gdmlp_fused(const void* x, const float* lns, const float* lnb,
                               const float* W1, const float* b1, const float* dw,
                               const float* bdw, const float* W2, const float* b2, void* out,
                               void* ws, int B, int C, int h, int Cout, int H, int W,
                               int residual, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (C <= bem::kTcMaxC && Cout <= bem::kTcMaxC) {
    if (bf16)
      return bem::launch_gdmlp_tc(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C, h, Cout, H,
                                  W, residual, s);
    return bem::launch_gdmlp_tc32(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, ws, B, C, h, Cout,
                                  H, W, residual, s);
  }
  if (bf16)
    return bem::launch_gdmlp<__nv_bfloat16>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C,
                                            h, Cout, H, W, residual, 1, s);
  return bem::launch_gdmlp<float>(x, lns, lnb, W1, b1, dw, bdw, W2, b2, out, B, C, h, Cout, H,
                                  W, residual, 0, s);
}

// The form bem_gdmlp_fused runs: 0 the CUDA-core form, n >= 1 a
// tensor-core form, n > 1 the fp32 one with its hidden width split n ways,
// -1 where no fp32 plan fits.
extern "C" int bem_gdmlp_form(int B, int C, int h, int Cout, int H, int W, int bf16) {
  if (C > bem::kTcMaxC || Cout > bem::kTcMaxC) return 0;
  if (bf16) return 1;
  const bem::Tc32Plan pl = bem::gdmlp_tc32_plan(B, C, h, Cout, H, W);
  return pl.TH ? pl.nsplit : -1;
}

// The workspace bem_gdmlp_fused needs, in bytes: the fp32 tensor-core
// form's chunk images and, where its hidden width splits, the partial
// outputs (nsplit x (B, Cout, H*W) fp32); 0 for the other forms.
extern "C" long bem_gdmlp_ws(int B, int C, int h, int Cout, int H, int W, int bf16) {
  if (bf16 || C > bem::kTcMaxC || Cout > bem::kTcMaxC) return 0;
  const bem::Tc32Plan pl = bem::gdmlp_tc32_plan(B, C, h, Cout, H, W);
  if (pl.TH == 0) return 0;
  return (long)pl.img + (pl.nsplit > 1 ? 4L * pl.nsplit * B * Cout * H * W : 0L);
}
