// SS2D tail, channel-first (B, C, L) -> (B, C_out, L):
//   y   = y_row [+ y_colT]                      (fp32)
//   yn  = LN_C(y) * scale + bias                (centred two-pass variance, eps 1e-5)
//   out = Wout^T . yn [+ bout] [+ res]          (yn rounded to bf16 on the bf16 stream)
//
// Replaces bem_tpu/ops/ss2d_tail.py::ss2d_tail_cf (Pallas body _tail_body).
// Bound: bytes (one or two C-wide reads, one C_out-wide write, one optional
// residual read per pixel); the C * C_out products are a small share on
// the tensor cores. Both forms below are persistent: a grid of as many
// blocks as fit the card walks the (image, TL-position) tiles, so Wout is
// staged once a block. Tiles move with 16-byte accesses along L (any L: a
// scalar path where L or a pointer is off the vector width). LP = 2 *
// threads / TL lanes a pair of neighbouring positions take the LN
// statistics (lane k sums channels k, k + LP, ... in that order, the lanes
// combined by xor shuffles: the mean, then the centred variance); the
// tiles' row strides put those reads on distinct banks.
//
// tail_tc_kernel, the bf16 stream (C, C_out <= 256): the projection on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate, fragments by
// ldmatrix). Its operands are the exact ones of the bf16 stream: the LN
// output rounded to bf16 (written position-major, K = C zero-padded to
// 16) and Wout rounded to bf16 by the wrapper (staged once as the A
// operand, Wout^T with C_out zero-padded to 16), so no hi + lo split is
// needed. A tile's raw bf16 rows (y_row [, y_colT], res) arrive by
// cp.async, with two stages the next tile's while the block works on
// this one; warps take (8 positions, kTailMG x 16 output channels) tiles
// and write out = acc + bout + res, rounded once, over the residual's
// staged rows, which the last pass stores. The tile (TL = 64 or 32), the
// stages and the block size (256 threads, or 512 where one block is all
// that fits an SM) come from the shared-memory budget (tail_tc_plan).
//
// tail_kernel, the fp32 stream and wider nets: the projection as fp32 FMAs
// on the CUDA cores, register-tiled: a thread computes 4 output channels x
// 4 positions from one float4 of Wout and one of the LN output per
// channel (8 values read for 16 FMAs), and stores its rows (+ bout, + res)
// as float4 on the fp32 stream.
#include <cstdint>

#include "mma_bf16.cuh"

namespace bem {

constexpr int kTailThreads = 256;
constexpr int kTailMG = 2;                       // m-tiles a warp of the tensor-core form holds
constexpr size_t kTailTwoBlocks = 113 * 1024;    // shared memory that leaves two blocks an SM
constexpr size_t kTailMaxSmem = 227 * 1024;      // the most a block may take

// byte offsets of the CUDA-core form's shared memory, 16-byte aligned
struct TailLayout {
  int TLp, Cq;
  size_t w, vec, total;
  __host__ __device__ TailLayout(int C, int Cout, int TL) {
    TLp = TL + 4;                               // fp32 stride of a tile row
    Cq = (Cout + 3) / 4 * 4;                    // fp32 stride of a Wout row
    w = (size_t)C * TLp * 4;                    // fp32 (C, TLp), the tile, at 0
    vec = w + (size_t)C * Cq * 4;               // fp32 (C, Cq), Wout
    total = vec + (size_t)(2 * C + Cq) * 4;     // scale, shift, bout
  }
};

// byte offsets of the tensor-core form's shared memory, 16-byte aligned
struct TailTcLayout {
  int TLs, Kp, Cop, S, nin;
  size_t stage, yn, w, vec, total;
  __host__ __device__ TailTcLayout(int C, int Cout, int TL, bool merged, int stages) {
    TLs = TL + 8;                   // bf16 stride of a staged row
    Kp = (C + 15) / 16 * 16;        // K of the mma, zero-padded
    Cop = (Cout + 15) / 16 * 16;    // M of the mma, zero-padded
    S = Kp + 8;                     // bf16 stride of a position of yn / a row of Wout^T
    nin = merged ? 1 : 2;
    // a stage: the tile's y_row [, y_colT] rows, then C_out rows of the
    // residual (later the output)
    stage = (size_t)(nin * C + Cout) * TLs * 2;
    yn = stage * stages;                        // bf16 (TL, S), the LN output
    w = yn + (size_t)TL * S * 2;                // bf16 (Cop, S), Wout^T
    vec = w + (size_t)Cop * S * 2;              // fp32 scale, shift (Kp), bout (Cop)
    total = vec + (size_t)(2 * Kp + Cop) * 4;
  }
};

// 16-byte accesses: N values of the stream dtype, as fp32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<bf16_t> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16_t* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// y = yr (+ yc) of positions l0 .. l0 + TL - 1 (0 past L) into ys (C, TLp)
template <typename T, int TL>
__device__ __forceinline__ void load_tile(const T* __restrict__ yr, const T* __restrict__ yc,
                                          float* ys, int C, int L, int TLp, long l0, bool vec) {
  constexpr int V = Vec16<T>::N, G = TL / V;
  if (vec) {
    for (int i = threadIdx.x; i < C * G; i += kTailThreads) {
      const int c = i / G, q = i - c * G;
      const long l = l0 + q * V;
      float v[V], w[V];
      if (l < L) {
        Vec16<T>::load(yr + (long)c * L + l, v);
        if (yc != nullptr) {
          Vec16<T>::load(yc + (long)c * L + l, w);
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] += w[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
      }
      float* dst = ys + c * TLp + q * V;
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < C * TL; i += kTailThreads) {
      const int c = i / TL, t = i - c * TL;
      const long j = (long)c * L + l0 + t;
      float v = 0.f;
      if (l0 + t < L) {
        v = IO<T>::load(yr, j);
        if (yc != nullptr) v += IO<T>::load(yc, j);
      }
      ys[c * TLp + t] = v;
    }
  }
}

// LN over C at positions p = 2 (tid / LP) and p + 1 of the tile (NTH
// threads), get(c, p) returning both (float2): put(c, p, yn_p, yn_p+1) for
// every channel c < C (see the header for the lane order)
template <int TL, int NTH, typename G, typename F>
__device__ __forceinline__ void tile_ln(G get, const float* sc, const float* bi, int C, F put) {
  constexpr int LP = 2 * NTH / TL;
  const int p = 2 * (threadIdx.x / LP), k = threadIdx.x % LP;
  const float invc = 1.f / (float)C;
  float s0 = 0.f, s1 = 0.f;
  for (int c = k; c < C; c += LP) {
    const float2 y = get(c, p);
    s0 += y.x;
    s1 += y.y;
  }
#pragma unroll
  for (int off = 1; off < LP; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  const float m0 = s0 * invc, m1 = s1 * invc;
  float v0 = 0.f, v1 = 0.f;
  for (int c = k; c < C; c += LP) {
    const float2 y = get(c, p);
    const float d0 = y.x - m0, d1 = y.y - m1;
    v0 = fmaf(d0, d0, v0);
    v1 = fmaf(d1, d1, v1);
  }
#pragma unroll
  for (int off = 1; off < LP; off <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, off);
    v1 += __shfl_xor_sync(0xffffffffu, v1, off);
  }
  const float i0 = rsqrtf(v0 * invc + 1e-5f), i1 = rsqrtf(v1 * invc + 1e-5f);
  for (int c = k; c < C; c += LP) {
    const float2 y = get(c, p);
    put(c, p, (y.x - m0) * i0 * sc[c] + bi[c], (y.y - m1) * i1 * sc[c] + bi[c]);
  }
}

// out = Wout^T (Cop x Kp, ws) . yn^T (Kp x TL, yn position-major) + bout
// (+ the residual staged in os), rounded to bf16 in place over os (rows
// of stride TLs, C_out of them)
template <int TL, int NTH>
__device__ __forceinline__ void tc_project(const bf16_t* ws, const bf16_t* yn, const float* bos,
                                           bf16_t* os, bool has_res, int Cout,
                                           const TailTcLayout& lay) {
  constexpr int NT = TL / 8;
  const int S = lay.S, Cop = lay.Cop;
  const int mgroups = (Cop / 16 + kTailMG - 1) / kTailMG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  for (int pr = warp; pr < NT * mgroups; pr += NTH / 32) {
    const int nt = pr % NT, m0 = (pr / NT) * kTailMG;
    float d[kTailMG][4];
#pragma unroll
    for (int m = 0; m < kTailMG; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[m][e] = 0.f;
    for (int k0 = 0; k0 < lay.Kp; k0 += 16) {
      uint32_t b0, b1;
      ldsm_b(b0, b1, yn, S, nt * 8, k0, lane);
#pragma unroll
      for (int m = 0; m < kTailMG; ++m)
        if (16 * (m0 + m) < Cop) {
          uint32_t a[4];
          ldsm_a(a, ws, S, 16 * (m0 + m), k0, lane);
          mma16816(d[m], a, b0, b1);
        }
    }
    const int p = nt * 8 + 2 * tq;
#pragma unroll
    for (int m = 0; m < kTailMG; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * (m0 + m) + gq + 8 * half;
        if (row >= Cout) continue;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(os + row * lay.TLs + p);
        const float bv = bos[row];
        float2 v = make_float2(d[m][2 * half] + bv, d[m][2 * half + 1] + bv);
        if (has_res) {
          const float2 r = __bfloat1622float2(*o);
          v.x += r.x;
          v.y += r.y;
        }
        *o = __floats2bfloat162_rn(v.x, v.y);
      }
  }
}

// Stage positions l0 .. l0 + TL - 1 of ``rows`` rows of length L at src
// (row r at src + r * L) into dst (row stride TLs), 0 past L: by cp.async
// where vec, else by plain loads and stores.
template <int TL, int NTH>
__device__ __forceinline__ void tc_stage(const bf16_t* src, bf16_t* dst, int rows, int L, int l0,
                                         int TLs, bool vec) {
  if (vec) {
    constexpr int G = TL / 8;
    for (int i = threadIdx.x; i < rows * G; i += NTH) {
      const int r = i / G, q = i - r * G;
      const int l = l0 + 8 * q;
      const bf16_t* sp = src + (long)r * L;
      cp_async16(dst + r * TLs + 8 * q, l < L ? sp + l : sp, l < L);
    }
  } else {
    const bf16_t zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < rows * TL; i += NTH) {
      const int r = i / TL, t = i - r * TL;
      dst[r * TLs + t] = l0 + t < L ? src[(long)r * L + l0 + t] : zero;
    }
  }
}

// Store the C_out staged output rows of positions l0 .. (< L) to out
template <int TL, int NTH>
__device__ __forceinline__ void tc_store(const bf16_t* os, bf16_t* out, int Cout, int L, int l0,
                                         int TLs, bool vec) {
  if (vec) {
    constexpr int G = TL / 8;
    for (int i = threadIdx.x; i < Cout * G; i += NTH) {
      const int o = i / G, q = i - o * G;
      if (l0 + 8 * q < L)
        *reinterpret_cast<uint4*>(out + (long)o * L + l0 + 8 * q) =
            *reinterpret_cast<const uint4*>(os + o * TLs + 8 * q);
    }
  } else {
    for (int i = threadIdx.x; i < Cout * TL; i += NTH) {
      const int o = i / TL, t = i - o * TL;
      if (l0 + t < L) out[(long)o * L + l0 + t] = os[o * TLs + t];
    }
  }
}

// NS: stages, 2 (the next tile in flight while this one runs) or 1
template <int TL, int NS, int NTH>
__global__ void __launch_bounds__(NTH, 2048 / NTH / 2)
tail_tc_kernel(const bf16_t* __restrict__ yr, const bf16_t* __restrict__ yc,
               const float* __restrict__ sc, const float* __restrict__ bi,
               const float* __restrict__ Wout, const float* __restrict__ bout,
               const bf16_t* __restrict__ res, bf16_t* __restrict__ out, int B, int C,
               int Cout, int L, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TailTcLayout lay(C, Cout, TL, yc == nullptr, NS);
  bf16_t* yn = reinterpret_cast<bf16_t*>(smem_raw + lay.yn);
  bf16_t* ws = reinterpret_cast<bf16_t*>(smem_raw + lay.w);
  float* scs = reinterpret_cast<float*>(smem_raw + lay.vec);
  float* bis = scs + lay.Kp;
  float* bos = bis + lay.Kp;
  const int tid = threadIdx.x, S = lay.S, KW = lay.Kp / 2, TLs = lay.TLs;
  const int tiles = (L + TL - 1) / TL, ntile = B * tiles, step = gridDim.x;
  auto stage = [&](int s) { return reinterpret_cast<bf16_t*>(smem_raw + s * lay.stage); };
  auto outs = [&](int s) { return stage(s) + lay.nin * C * TLs; };  // res, then out
  // one committed group a tile: its y_row [, y_colT] and residual rows
  auto issue = [&](int tile, int s) {
    if (tile < ntile) {
      const int b = tile / tiles, l0 = (tile - b * tiles) * TL;
      const long ci = (long)b * C * L;
      tc_stage<TL, NTH>(yr + ci, stage(s), C, L, l0, TLs, vec);
      if (yc != nullptr) tc_stage<TL, NTH>(yc + ci, stage(s) + C * TLs, C, L, l0, TLs, vec);
      if (res != nullptr) tc_stage<TL, NTH>(res + (long)b * Cout * L, outs(s), Cout, L, l0, TLs, vec);
    }
    cp_async_commit();
  };
  if (NS == 2) issue(blockIdx.x, 0);  // in flight while Wout is staged

  // once a block: Wout^T as bf16 rows (exact: the wrapper rounded Wout),
  // 0 past C and C_out; the LN's scale and shift; bout; yn's K padding
  for (int i = tid; i < lay.Cop * KW; i += NTH) {
    const int o = i / KW, c = 2 * (i - o * KW);
    const float a0 = o < Cout && c < C ? Wout[(long)c * Cout + o] : 0.f;
    const float a1 = o < Cout && c + 1 < C ? Wout[(long)(c + 1) * Cout + o] : 0.f;
    reinterpret_cast<__nv_bfloat162*>(ws + o * S)[c / 2] = __floats2bfloat162_rn(a0, a1);
  }
  for (int i = tid; i < TL * (lay.Kp - C); i += NTH) {
    const int p = i / (lay.Kp - C);
    yn[p * S + C + (i - p * (lay.Kp - C))] = __float2bfloat16_rn(0.f);
  }
  for (int c = tid; c < lay.Kp; c += NTH) {
    scs[c] = c < C ? sc[c] : 0.f;
    bis[c] = c < C ? bi[c] : 0.f;
  }
  for (int o = tid; o < lay.Cop; o += NTH)
    bos[o] = o < Cout && bout != nullptr ? bout[o] : 0.f;

  int s = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += step) {
    if (NS == 1) {
      __syncthreads();  // the previous tile's last readers are done
      issue(tile, 0);
    }
    cp_async_wait_all();  // this tile's group
    __syncthreads();      // ... for every thread; the previous tile's readers are done
    // two stages: the next tile, into the stage the previous tile has left
    if (NS == 2) issue(tile + step, s ^ 1);
    const bf16_t* st = stage(s);
    bf16_t* os = outs(s);
    if (yc == nullptr)
      tile_ln<TL, NTH>([&](int c, int p) {
                    return __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(st + c * TLs + p));
                  },
                  scs, bis, C, [&](int c, int p, float y0, float y1) {
                    yn[p * S + c] = __float2bfloat16_rn(y0);
                    yn[(p + 1) * S + c] = __float2bfloat16_rn(y1);
                  });
    else
      tile_ln<TL, NTH>([&](int c, int p) {
                    const float2 u = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(st + c * TLs + p));
                    const float2 v = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(st + (C + c) * TLs + p));
                    return make_float2(u.x + v.x, u.y + v.y);
                  },
                  scs, bis, C, [&](int c, int p, float y0, float y1) {
                    yn[p * S + c] = __float2bfloat16_rn(y0);
                    yn[(p + 1) * S + c] = __float2bfloat16_rn(y1);
                  });
    __syncthreads();
    tc_project<TL, NTH>(ws, yn, bos, os, res != nullptr, Cout, lay);
    __syncthreads();
    const int b = tile / tiles;
    tc_store<TL, NTH>(os, out + (long)b * Cout * L, Cout, L, (tile - b * tiles) * TL, TLs, vec);
    s ^= NS - 1;
  }
}

template <typename T, int TL>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const T* __restrict__ yr, const T* __restrict__ yc, const float* __restrict__ sc,
            const float* __restrict__ bi, const float* __restrict__ Wout,
            const float* __restrict__ bout, const T* __restrict__ res, T* __restrict__ out,
            int B, int C, int Cout, int L, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TailLayout lay(C, Cout, TL);
  float* ys = reinterpret_cast<float*>(smem_raw);
  float* wf = reinterpret_cast<float*>(smem_raw + lay.w);
  float* scs = reinterpret_cast<float*>(smem_raw + lay.vec);
  float* bis = scs + C;
  float* bos = bis + C;
  const int tid = threadIdx.x, Cq = lay.Cq, TLp = lay.TLp;
  constexpr bool kBf16 = sizeof(T) == 2;

  for (int i = tid; i < C * Cq; i += kTailThreads) {
    const int c = i / Cq, o = i - c * Cq;
    wf[i] = o < Cout ? Wout[(long)c * Cout + o] : 0.f;
  }
  for (int c = tid; c < C; c += kTailThreads) {
    scs[c] = sc[c];
    bis[c] = bi[c];
  }
  for (int o = tid; o < Cq; o += kTailThreads) bos[o] = o < Cout && bout != nullptr ? bout[o] : 0.f;

  const int tiles = (L + TL - 1) / TL;
  constexpr int NQ = TL / 4;  // position quads of a tile
  for (long tile = blockIdx.x; tile < (long)B * tiles; tile += gridDim.x) {
    const long b = tile / tiles, l0 = (tile - b * tiles) * TL;
    __syncthreads();
    load_tile<T, TL>(yr + b * C * L, yc != nullptr ? yc + b * C * L : nullptr, ys, C, L, TLp, l0,
                     vec);
    __syncthreads();
    // the LN output in place (each thread rewrites only what it read)
    tile_ln<TL, kTailThreads>([&](int c, int p) {
                                return *reinterpret_cast<const float2*>(ys + c * TLp + p);
                              },
                scs, bis, C, [&](int c, int p, float y0, float y1) {
                  *reinterpret_cast<float2*>(ys + c * TLp + p) =
                      kBf16 ? make_float2(round_bf16(y0), round_bf16(y1)) : make_float2(y0, y1);
                });
    __syncthreads();
    const T* rb = res != nullptr ? res + b * Cout * L : nullptr;
    T* ob = out + b * Cout * L;
    for (int i = tid; i < (Cq / 4) * NQ; i += kTailThreads) {
      const int q = i % NQ, j = i / NQ;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
      const float* yp = ys + 4 * q;
      const float* wp = wf + 4 * j;
      for (int c = 0; c < C; ++c) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp + c * Cq);
        const float4 y4 = *reinterpret_cast<const float4*>(yp + c * TLp);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w}, yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(wv[r], yv[e], acc[r][e]);
      }
      const long l = l0 + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = 4 * j + r;
        if (o >= Cout || l >= L) continue;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[r][e] + bos[o];
        const long at = (long)o * L + l;
        if constexpr (!kBf16) {
          if (vec) {
            if (rb != nullptr) {
              float rv[4];
              Vec16<float>::load(rb + at, rv);
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] += rv[e];
            }
            Vec16<float>::store(ob + at, v);
            continue;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (l + e < L)
            IO<T>::store(ob, at + e, rb != nullptr ? v[e] + IO<T>::load(rb, at + e) : v[e]);
      }
    }
  }
}

struct TailTcPlan {
  int TL, stages, threads;
  size_t smem;
};

// The tensor-core form's tile, stages (the tiles in flight ahead: stages
// - 1) and block size: 256 threads at TL = 64, else 32, with two stages
// where that leaves two blocks an SM, else 512 threads (one block) at the
// first of those or one stage that fits (the best of the forms at the IE
// shapes, tools/sweep_scan_tail.py); TL = 64 only where the grid gives
// every SM a tile; TL = 0 where nothing fits.
inline TailTcPlan tail_tc_plan(int B, int C, int Cout, int L, bool merged) {
  const bool fill64 = (long)B * ((L + 63) / 64) >= kCardSMs;
  const int tls[2] = {fill64 ? 64 : 32, 32}, nths[2] = {256, 512};
  for (int threads : nths)
    for (int TL : tls)
      for (int st = 2; st >= (threads == 256 ? 2 : 1); --st) {
        const size_t smem = TailTcLayout(C, Cout, TL, merged, st).total;
        if (smem <= (threads == 256 ? kTailTwoBlocks : kTailMaxSmem)) return {TL, st, threads, smem};
      }
  return {0, 0, 0, 0};
}

// The CUDA-core form's tile: 64 positions where a block then leaves two an
// SM and every SM has a tile, else 32; 0 where nothing fits.
inline int tail_tile(int B, int C, int Cout, int L) {
  if (TailLayout(C, Cout, 64).total <= kTailTwoBlocks && (long)B * ((L + 63) / 64) >= kCardSMs)
    return 64;
  return TailLayout(C, Cout, 32).total <= kTailMaxSmem ? 32 : 0;
}

// the persistent grid: as many blocks as fit every SM at once, at most one a tile
template <typename K>
inline cudaError_t tail_grid(K kernel, int threads, size_t smem, long tiles, unsigned* grid) {
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
  const long g = (long)sms * per;
  *grid = (unsigned)(tiles < g ? tiles : g);
  return e;
}

template <int TL, int NS, int NTH>
int launch_tail_tc(const TailTcPlan& pl, const void* yr, const void* yc, const float* sc,
                   const float* bi, const float* Wout, const float* bout, const void* res,
                   void* out, int B, int C, int Cout, int L, int vec, cudaStream_t stream) {
  unsigned grid = 0;
  cudaError_t e =
      tail_grid(tail_tc_kernel<TL, NS, NTH>, NTH, pl.smem, (long)B * ((L + TL - 1) / TL), &grid);
  if (e != cudaSuccess) return (int)e;
  tail_tc_kernel<TL, NS, NTH><<<grid, NTH, pl.smem, stream>>>(
      static_cast<const bf16_t*>(yr), static_cast<const bf16_t*>(yc), sc, bi, Wout, bout,
      static_cast<const bf16_t*>(res), static_cast<bf16_t*>(out), B, C, Cout, L, vec);
  return (int)cudaGetLastError();
}

template <typename T, int TL>
int launch_tail(const void* yr, const void* yc, const float* sc, const float* bi,
                const float* Wout, const float* bout, const void* res, void* out, int B, int C,
                int Cout, int L, int vec, cudaStream_t stream) {
  const size_t smem = TailLayout(C, Cout, TL).total;
  unsigned grid = 0;
  cudaError_t e =
      tail_grid(tail_kernel<T, TL>, kTailThreads, smem, (long)B * ((L + TL - 1) / TL), &grid);
  if (e != cudaSuccess) return (int)e;
  tail_kernel<T, TL><<<grid, kTailThreads, smem, stream>>>(
      static_cast<const T*>(yr), static_cast<const T*>(yc), sc, bi, Wout, bout,
      static_cast<const T*>(res), static_cast<T*>(out), B, C, Cout, L, vec);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace bem

namespace bem {

inline int tail_vec(const void* yr, const void* yc, const void* res, const void* out, int L,
                    int bf16) {
  return L % (bf16 ? 8 : 4) == 0 && aligned16(yr) && aligned16(out) &&
         (yc == nullptr || aligned16(yc)) && (res == nullptr || aligned16(res));
}

inline int launch_tail_tc_plan(const TailTcPlan& pl, const void* yr, const void* yc,
                               const float* sc, const float* bi, const float* Wout,
                               const float* bout, const void* res, void* out, int B, int C,
                               int Cout, int L, cudaStream_t s) {
  const int vec = tail_vec(yr, yc, res, out, L, 1);
#define BEM_TAIL_TC(TILE, STAGES, THREADS)                                                  \
  if (pl.TL == TILE && pl.stages == STAGES && pl.threads == THREADS)                        \
    return launch_tail_tc<TILE, STAGES, THREADS>(pl, yr, yc, sc, bi, Wout, bout, res, out, B, \
                                                 C, Cout, L, vec, s);
  BEM_TAIL_TC(64, 2, 256) BEM_TAIL_TC(32, 2, 256) BEM_TAIL_TC(64, 2, 512)
  BEM_TAIL_TC(64, 1, 512) BEM_TAIL_TC(32, 2, 512) BEM_TAIL_TC(32, 1, 512)
#undef BEM_TAIL_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace bem

// bf16 with C and C_out <= 256 runs the tensor-core form (tail_tc_plan),
// the rest the CUDA-core form; 16-byte accesses where L is a multiple of
// the vector width and every stream pointer is 16-byte aligned.
extern "C" int bem_ss2d_tail(const void* yr, const void* yc, const float* sc, const float* bi,
                             const float* Wout, const float* bout, const void* res, void* out,
                             int B, int C, int Cout, int L, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0 || Cout <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (bf16 && C <= bem::kTcMaxC && Cout <= bem::kTcMaxC)
    return bem::launch_tail_tc_plan(bem::tail_tc_plan(B, C, Cout, L, yc == nullptr), yr, yc, sc,
                                    bi, Wout, bout, res, out, B, C, Cout, L, s);
  const int vec = bem::tail_vec(yr, yc, res, out, L, bf16);
  const int TL = bem::tail_tile(B, C, Cout, L);
  if (TL == 0) return (int)cudaErrorInvalidValue;
#define BEM_TAIL(T)                                                                             \
  (TL == 64 ? bem::launch_tail<T, 64>(yr, yc, sc, bi, Wout, bout, res, out, B, C, Cout, L, vec, s) \
            : bem::launch_tail<T, 32>(yr, yc, sc, bi, Wout, bout, res, out, B, C, Cout, L, vec, s))
  return bf16 ? BEM_TAIL(__nv_bfloat16) : BEM_TAIL(float);
#undef BEM_TAIL
}

// The tensor-core form (bf16 streams) at a given tile, stage count and block
// size, for tools/sweep_scan_tail.py; *picked (if not null) gets what
// bem_ss2d_tail would take, as TL * 100 + stages * 10 + threads / 256.
extern "C" int bem_ss2d_tail_tc_with(const void* yr, const void* yc, const float* sc,
                                     const float* bi, const float* Wout, const float* bout,
                                     const void* res, void* out, int B, int C, int Cout, int L,
                                     int TL, int stages, int threads, int* picked,
                                     void* stream) {
  const bem::TailTcPlan rule = bem::tail_tc_plan(B, C, Cout, L, yc == nullptr);
  if (picked != nullptr) *picked = rule.TL * 100 + rule.stages * 10 + rule.threads / 256;
  const size_t smem = bem::TailTcLayout(C, Cout, TL, yc == nullptr, stages).total;
  if (C > bem::kTcMaxC || Cout > bem::kTcMaxC || smem > bem::kTailMaxSmem)
    return (int)cudaErrorInvalidValue;
  return bem::launch_tail_tc_plan({TL, stages, threads, smem}, yr, yc, sc, bi, Wout, bout, res,
                                  out, B, C, Cout, L, static_cast<cudaStream_t>(stream));
}

extern "C" const char* bem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
