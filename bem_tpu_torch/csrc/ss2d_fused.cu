// The 4-direction SS2D core over xs2 (B, 2, C, L): per stream s (row-major,
// column-major), direction k = s walks forward and k = s + 2 backward over
// the same sequence:
//   xdbl = Wx[k] . x                    (P = R + 2N rows: dt-rank | B | C)
//   dt   = softplus(Wdt[k] . xdbl[:R] + bias[k])
//   h_n  = exp(dt * A_n) * h_n + dt * x * B_n     (clamped: max(dt*A_n, -10))
//   y    = sum_n C_n h_n + D[k] x,   y2[:, s] = cast(cast(y_s) + cast(y_{s+2}))
// and its backward (lambda_t = g_t C_t + a_next lambda_next, opposite to
// each scan; ss2d_fused_bwd.py:15-21 lists every gradient).
//
// Replaces bem_tpu/ops/ss2d_fused.py::ss2d_dir_fused (Pallas body _fwd_body),
// bem_tpu/ops/ss2d_fused_g.py::ss2d_dir_fused_g (_fwd_body, the clamped
// form: the `clamp` flag here) and bem_tpu/ops/ss2d_fused_bwd.py::run_bwd
// (_bwd_body).
//
// Bound: the forward's exp per (position, channel, state) on the special
// function units and the projections' FMAs; the walk itself is a sequential
// recurrence whose latency only enough walkers in flight can hide. The TPU
// kernel projected, scanned (a blocked doubling scan with one-hot MXU
// matmuls) and read out per L-block in one body, carrying the state across
// an ordered grid. Here:
//  - the projections (xdbl, and in the backward dxdbl, dx, dWx, dWdt) run
//    on a batched, strided fp32 GEMM kernel (64x64 tiles through shared
//    memory), once per (image, stream, direction) instead of once per
//    channel block;
//  - the walk puts one thread on each (image, stream, channel) of one
//    direction, its N states in registers, and walks the sequence in
//    kCk-long chunks staged through shared memory (x, the chunk's
//    projection rows); the forward direction's launch writes the rounded
//    y_f, the reverse one adds its rounded y_r, so the merge needs no
//    buffer and no atomics;
//  - the forward can write the state entering every chunk (fp32
//    checkpoints). The backward walk runs the chunks in reverse scan
//    order: it recomputes the chunk's states from its checkpoint, keeping
//    the state entering each kSub-long sub-chunk in shared memory, and for
//    each sub-chunk and state n recomputes h over kSub positions in
//    registers and runs lambda back over them. The per-position sums over
//    channels (dB, dC) are reduced in registers across the warp (a
//    transposing butterfly: 31 shuffles sum 32 values) and across the
//    block's two warps in shared memory; every cross-block sum (channel
//    blocks, images) is a separate, ordered pass, so the results do not
//    change from run to run.
#include "common.cuh"

namespace bem {

constexpr float kFusedClamp = -10.f;
constexpr int kCk = 32;          // scan positions per chunk and per checkpoint
constexpr int kFwdCB = 64;       // channels (one thread each) per forward block
constexpr int kBwdCB = 64;       // channels per backward block: two full warps
constexpr int kSub = 16;         // positions per backward sub-chunk (2 kSub = 32 lanes)
constexpr int kNSub = kCk / kSub;

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return round_bf16(v); }

// ---------------------------------------------------------------------------
// batched fp32 GEMM: C[z] (= or +=) A[z] (M x K) . B[z] (K x N), any strides

struct Operand {
  long rs, cs;      // element (r, c) at r * rs + c * cs
  long b0, b1, b2;  // batch z = (i0 * n1 + i1) * n2 + i2 adds i0 b0 + i1 b1 + i2 b2
};

struct GemmShape {
  int M, N, K, n1, n2, accumulate;
};

constexpr int kGM = 64, kGN = 64, kGK = 16, kGThreads = 256;

__device__ __forceinline__ long batch_off(const Operand& o, int z, int n1, int n2) {
  const int i2 = z % n2, i1 = (z / n2) % n1, i0 = z / (n1 * n2);
  return i0 * o.b0 + i1 * o.b1 + i2 * o.b2;
}

template <typename TB>
__global__ void __launch_bounds__(kGThreads)
gemm_kernel(const float* __restrict__ A, Operand oa, const TB* __restrict__ Bm, Operand ob,
            float* __restrict__ Cm, Operand oc, GemmShape sh) {
  __shared__ float As[kGK][kGM + 4];
  __shared__ float Bs[kGK][kGN + 4];
  const int z = blockIdx.z;
  const float* a = A + batch_off(oa, z, sh.n1, sh.n2);
  const TB* b = Bm + batch_off(ob, z, sh.n1, sh.n2);
  float* c = Cm + batch_off(oc, z, sh.n1, sh.n2);
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < sh.K; k0 += kGK) {
    // neighbouring threads load along whichever operand axis is contiguous
    for (int i = tid; i < kGM * kGK; i += kGThreads) {
      int mm, kk;
      if (oa.cs == 1) {
        mm = i / kGK;
        kk = i % kGK;
      } else {
        kk = i / kGM;
        mm = i % kGM;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < sh.M && gk < sh.K) ? a[gm * oa.rs + gk * oa.cs] : 0.f;
    }
    for (int i = tid; i < kGK * kGN; i += kGThreads) {
      int kk, nn;
      if (ob.cs == 1) {
        kk = i / kGN;
        nn = i % kGN;
      } else {
        nn = i / kGK;
        kk = i % kGK;
      }
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < sh.K && gn < sh.N) ? IO<TB>::load(b, gk * ob.rs + gn * ob.cs) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][tm + 16 * i];
        bv[i] = Bs[kk][tn + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + tm + 16 * i, gn = n0 + tn + 16 * j;
      if (gm < sh.M && gn < sh.N) {
        const long e = gm * oc.rs + gn * oc.cs;
        c[e] = sh.accumulate ? c[e] + acc[i][j] : acc[i][j];
      }
    }
}

template <typename TB>
int gemm(const float* A, Operand oa, const TB* Bm, Operand ob, float* Cm, Operand oc,
         GemmShape sh, int Z, cudaStream_t st) {
  dim3 grid((sh.N + kGN - 1) / kGN, (sh.M + kGM - 1) / kGM, Z);
  gemm_kernel<TB><<<grid, kGThreads, 0, st>>>(A, oa, Bm, ob, Cm, oc, sh);
  return (int)cudaGetLastError();
}

// out[q * out_q + r] = sum_{z < Z} in[q * in_q + z * zs + r], in z order
__global__ void sum_kernel(const float* __restrict__ in, float* __restrict__ out, int Z, long zs,
                           long nq, long in_q, long out_q, long nr) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= nq * nr) return;
  const long q = i / nr, r = i - q * nr;
  const float* p = in + q * in_q + r;
  float s = 0.f;
  for (int z = 0; z < Z; ++z) s += p[z * zs];
  out[q * out_q + r] = s;
}

int sum_over(const float* in, float* out, int Z, long zs, long nq, long in_q, long out_q, long nr,
             cudaStream_t st) {
  const long n = nq * nr;
  sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(in, out, Z, zs, nq, in_q, out_q, nr);
  return (int)cudaGetLastError();
}

// the projection xdbl[b, s, dir] (P x L) = Wx[s + 2 dir] (P x C) . x[b, s] (C x L)
template <typename T>
int project(const T* x, const float* Wx, float* xdbl, int B, int C, int L, int P,
            cudaStream_t st) {
  return gemm<T>(Wx, Operand{C, 1, 0, (long)P * C, 2L * P * C}, x,
                 Operand{L, 1, 2L * C * L, (long)C * L, 0}, xdbl,
                 Operand{L, 1, 4L * P * L, 2L * P * L, (long)P * L},
                 GemmShape{P, L, C, 2, 2, 0}, B * 4, st);
}

// scan index i of direction dir sits at position i (forward) or L-1-i
__device__ __forceinline__ long seq_pos(int dir, int L, int i) {
  return dir ? (long)L - 1 - i : (long)i;
}

// ---------------------------------------------------------------------------
// forward walk: one direction, one thread per (image, stream, channel)

inline size_t fwd_smem_floats(int R, int N) {
  return (size_t)kFwdCB * (kCk + 1) + (size_t)(R + 2 * N) * kCk + (size_t)kFwdCB * (R + 1);
}

template <typename T, int N>
__global__ void __launch_bounds__(kFwdCB)
fwd_walk_kernel(const T* __restrict__ x, const float* __restrict__ xdbl,
                const float* __restrict__ Wdt, const float* __restrict__ bias,
                const float* __restrict__ A, const float* __restrict__ D, T* __restrict__ y,
                float* __restrict__ ck, int C, int L, int R, int dir, int clamp) {
  extern __shared__ float smem[];
  const int P = R + 2 * N, TLp = kCk + 1;
  const int bs = blockIdx.y, s = bs & 1, k = s + 2 * dir;
  const int c0 = blockIdx.x * kFwdCB, nc = min(kFwdCB, C - c0);
  const int tid = threadIdx.x, c = c0 + tid;
  const bool valid = tid < nc;
  float* xs = smem;               // (kFwdCB, TLp): x, then y
  float* xd = xs + kFwdCB * TLp;  // (P, kCk): the chunk's projection rows
  float* wdt = xd + P * kCk;      // (kFwdCB, R + 1)
  const T* xb = x + (long)bs * C * L;
  T* yb = y + (long)bs * C * L;
  const float* xdb = xdbl + ((long)bs * 2 + dir) * P * L;
  for (int i = tid; i < kFwdCB * R; i += kFwdCB) {
    const int cc = i / R, r = i - cc * R;
    wdt[cc * (R + 1) + r] = cc < nc ? Wdt[((long)k * C + c0 + cc) * R + r] : 0.f;
  }
  float An[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    An[n] = valid ? A[((long)k * C + c) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float bk = valid ? bias[k * C + c] : 0.f, dk = valid ? D[k * C + c] : 0.f;
  const int nck = (L + kCk - 1) / kCk;
  for (int ci = 0; ci < nck; ++ci) {
    const int i0 = ci * kCk, nt = min(kCk, L - i0);
    if (ck != nullptr && valid) {
      float* cp = ck + ((((long)bs * 2 + dir) * nck + ci) * C + c) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) cp[n] = h[n];
    }
    for (int i = tid; i < kFwdCB * kCk; i += kFwdCB) {
      const int cc = i / kCk, j = i - cc * kCk;
      xs[cc * TLp + j] = (cc < nc && j < nt)
                             ? IO<T>::load(xb, (long)(c0 + cc) * L + seq_pos(dir, L, i0 + j))
                             : 0.f;
    }
    for (int i = tid; i < P * kCk; i += kFwdCB) {
      const int p = i / kCk, j = i - p * kCk;
      xd[i] = j < nt ? xdb[(long)p * L + seq_pos(dir, L, i0 + j)] : 0.f;
    }
    __syncthreads();
    if (valid) {
      const float* wr = wdt + tid * (R + 1);
      for (int j = 0; j < nt; ++j) {
        const float xv = xs[tid * TLp + j];
        float dtr = bk;
        for (int r = 0; r < R; ++r) dtr = fmaf(wr[r], xd[r * kCk + j], dtr);
        const float dt = softplus(dtr), du = dt * xv;
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float w = dt * An[n];
          if (clamp) w = fmaxf(w, kFusedClamp);
          h[n] = fmaf(expf(w), h[n], du * xd[(R + n) * kCk + j]);
          yv = fmaf(xd[(R + N + n) * kCk + j], h[n], yv);
        }
        xs[tid * TLp + j] = fmaf(dk, xv, yv);
      }
    }
    __syncthreads();
    for (int i = tid; i < nc * kCk; i += kFwdCB) {
      const int cc = i / kCk, j = i - cc * kCk;
      if (j >= nt) continue;
      const long e = (long)(c0 + cc) * L + seq_pos(dir, L, i0 + j);
      float v = xs[cc * TLp + j];
      // the reverse launch adds its rounded y_r to the forward's rounded y_f
      if (dir) v = IO<T>::load(yb, e) + round_to<T>(v);
      IO<T>::store(yb, e, v);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward walk: one direction, one thread per (image, stream, channel)

// lane l ends with the warp's sum of v[l] (a transposing butterfly)
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32], int lane) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
}

inline size_t bwd_smem_floats(int R, int N) {
  return 4 * (size_t)kBwdCB * (kCk + 1) + (size_t)(R + 2 * N) * kCk + (size_t)kBwdCB * (R + 1) +
         (size_t)(kNSub + 4) * N * kBwdCB + (size_t)(kBwdCB / 32) * N * 2 * kSub;
}

template <int N>
__global__ void __launch_bounds__(kBwdCB)
bwd_walk_kernel(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ xdbl, const float* __restrict__ Wdt,
                const float* __restrict__ bias, const float* __restrict__ A,
                const float* __restrict__ D, const float* __restrict__ ck,
                float* __restrict__ dx, float* __restrict__ ddtr, float* __restrict__ bcpart,
                float* __restrict__ vpart, int C, int L, int R, int dir) {
  extern __shared__ float smem[];
  const int P = R + 2 * N, TLp = kCk + 1, nblk = gridDim.x;
  const int bs = blockIdx.y, b = bs >> 1, s = bs & 1, k = s + 2 * dir;
  const int blk = blockIdx.x, c0 = blk * kBwdCB, nc = min(kBwdCB, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, c = c0 + tid;
  const bool valid = tid < nc;
  float* xs = smem;                     // (CB, TLp): x, then this direction's dx
  float* gs = xs + kBwdCB * TLp;        // g
  float* dts = gs + kBwdCB * TLp;       // dt
  float* drs = dts + kBwdCB * TLp;      // dt pre-activation, then ddtr
  float* xd = drs + kBwdCB * TLp;       // (P, kCk)
  float* wdt = xd + P * kCk;            // (CB, R + 1)
  float* hb = wdt + kBwdCB * (R + 1);   // (kNSub, N, CB): state entering each sub-chunk
  float* lamc = hb + kNSub * N * kBwdCB;  // (N, CB): lambda at the sub-chunk's end
  float* anc = lamc + N * kBwdCB;       // (N, CB): a of the next position in scan order
  float* Acs = anc + N * kBwdCB;        // (N, CB): A
  float* dAs = Acs + N * kBwdCB;        // (N, CB): dA
  float* red = dAs + N * kBwdCB;        // (2 warps, N, 2 kSub): warp sums of dB | dC
  for (int i = tid; i < kBwdCB * R; i += kBwdCB) {
    const int cc = i / R, r = i - cc * R;
    wdt[cc * (R + 1) + r] = cc < nc ? Wdt[((long)k * C + c0 + cc) * R + r] : 0.f;
  }
  for (int n = 0; n < N; ++n) {
    lamc[n * kBwdCB + tid] = 0.f;
    anc[n * kBwdCB + tid] = 0.f;
    Acs[n * kBwdCB + tid] = valid ? A[((long)k * C + c) * N + n] : 0.f;
    dAs[n * kBwdCB + tid] = 0.f;
  }
  const float bk = valid ? bias[k * C + c] : 0.f, dk = valid ? D[k * C + c] : 0.f;
  const float* xb = x + (long)bs * C * L;
  const float* gb = g + (long)bs * C * L;
  const float* xdb = xdbl + ((long)bs * 2 + dir) * P * L;
  float* dxb = dx + (long)bs * C * L;
  float* ddb = ddtr + ((long)bs * 2 + dir) * C * L;
  float dbias_acc = 0.f, dD_acc = 0.f;
  const int nck = (L + kCk - 1) / kCk;
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int i0 = ci * kCk, nt = min(kCk, L - i0);
    for (int i = tid; i < kBwdCB * kCk; i += kBwdCB) {
      const int cc = i / kCk, j = i - cc * kCk;
      const bool ok = cc < nc && j < nt;
      const long e = (long)(c0 + cc) * L + seq_pos(dir, L, i0 + j);
      xs[cc * TLp + j] = ok ? xb[e] : 0.f;
      gs[cc * TLp + j] = ok ? gb[e] : 0.f;
    }
    for (int i = tid; i < P * kCk; i += kBwdCB) {
      const int p = i / kCk, j = i - p * kCk;
      xd[i] = j < nt ? xdb[(long)p * L + seq_pos(dir, L, i0 + j)] : 0.f;
    }
    __syncthreads();
    {  // dt, and the chunk's states from its checkpoint, as the forward computed them
      const float* wr = wdt + tid * (R + 1);
      float h[N];
      const float* cp = ck + ((((long)bs * 2 + dir) * nck + ci) * C + c) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = valid ? cp[n] : 0.f;
      for (int j = 0; j < kCk; ++j) {
        float dtr = bk;
        for (int r = 0; r < R; ++r) dtr = fmaf(wr[r], xd[r * kCk + j], dtr);
        const float dt = softplus(dtr), du = dt * xs[tid * TLp + j];
        drs[tid * TLp + j] = dtr;
        dts[tid * TLp + j] = dt;
        if (j % kSub == 0) {
#pragma unroll
          for (int n = 0; n < N; ++n) hb[((j / kSub) * N + n) * kBwdCB + tid] = h[n];
        }
#pragma unroll
        for (int n = 0; n < N; ++n)
          h[n] = fmaf(expf(dt * Acs[n * kBwdCB + tid]), h[n], du * xd[(R + n) * kCk + j]);
      }
    }
    // positions past L hold x = g = 0 and projection rows 0, so they add
    // nothing and carry lambda = 0 into the chunk's last valid position
    for (int sub = kNSub - 1; sub >= 0; --sub) {
      const int jb = sub * kSub;
      float ddt[kSub], dxa[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) ddt[jj] = dxa[jj] = 0.f;
#pragma unroll 1
      for (int n = 0; n < N; ++n) {
        const float An = Acs[n * kBwdCB + tid];
        float hs[kSub + 1], aa[kSub], vals[2 * kSub];
        hs[0] = hb[(sub * N + n) * kBwdCB + tid];
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const int j = jb + jj;
          const float dt = dts[tid * TLp + j];
          aa[jj] = expf(dt * An);
          hs[jj + 1] = fmaf(aa[jj], hs[jj], dt * xs[tid * TLp + j] * xd[(R + n) * kCk + j]);
        }
        float lam = lamc[n * kBwdCB + tid], an = anc[n * kBwdCB + tid], dA_n = 0.f;
#pragma unroll
        for (int jj = kSub - 1; jj >= 0; --jj) {
          const int j = jb + jj;
          const float gv = gs[tid * TLp + j], xv = xs[tid * TLp + j], dt = dts[tid * TLp + j];
          const float Bn = xd[(R + n) * kCk + j], Cn = xd[(R + N + n) * kCk + j];
          lam = fmaf(an, lam, gv * Cn);
          an = aa[jj];
          const float daa = lam * hs[jj] * aa[jj];
          ddt[jj] = fmaf(daa, An, fmaf(lam * xv, Bn, ddt[jj]));
          dxa[jj] = fmaf(lam * dt, Bn, dxa[jj]);
          dA_n = fmaf(daa, dt, dA_n);
          vals[jj] = lam * (dt * xv);      // dB_n: sum over channels of lambda du
          vals[kSub + jj] = gv * hs[jj + 1];  // dC_n: sum over channels of g h
        }
        lamc[n * kBwdCB + tid] = lam;
        anc[n * kBwdCB + tid] = an;
        dAs[n * kBwdCB + tid] += dA_n;
        warp_transpose_sum(vals, lane);
        red[(warp * N + n) * 2 * kSub + lane] = vals[0];
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = jb + jj;
        const float dd = ddt[jj] / (1.f + expf(-drs[tid * TLp + j]));  // * sigmoid
        const float gv = gs[tid * TLp + j];
        dbias_acc += dd;
        dD_acc = fmaf(gv, xs[tid * TLp + j], dD_acc);
        drs[tid * TLp + j] = dd;
        xs[tid * TLp + j] = fmaf(dk, gv, dxa[jj]);
      }
      __syncthreads();
      for (int e = tid; e < N * 2 * kSub; e += kBwdCB) {
        const int n = e / (2 * kSub), q = e - n * 2 * kSub, kind = q / kSub, jj = q - kind * kSub;
        if (jb + jj >= nt) continue;
        float sum = 0.f;
        for (int w = 0; w < kBwdCB / 32; ++w) sum += red[(w * N + n) * 2 * kSub + q];
        bcpart[(((long)bs * nblk + blk) * 2 * N + kind * N + n) * L +
               seq_pos(dir, L, i0 + jb + jj)] = sum;
      }
      __syncthreads();
    }
    for (int i = tid; i < nc * kCk; i += kBwdCB) {
      const int cc = i / kCk, j = i - cc * kCk;
      if (j >= nt) continue;
      const long e = (long)(c0 + cc) * L + seq_pos(dir, L, i0 + j);
      ddb[e] = drs[cc * TLp + j];
      // the reverse direction's launch adds to the forward's dx
      dxb[e] = dir ? dxb[e] + xs[cc * TLp + j] : xs[cc * TLp + j];
    }
    __syncthreads();
  }
  if (valid) {
    float* vp = vpart + ((((long)b * 2 + dir) * 2 + s) * C + c) * (N + 2);
    for (int n = 0; n < N; ++n) vp[n] = dAs[n * kBwdCB + tid];
    vp[N] = dbias_acc;
    vp[N + 1] = dD_acc;
  }
}

// ---------------------------------------------------------------------------
// entry points

template <typename T, int N>
int fwd_n(const T* x, const float* Wx, const float* Wdt, const float* bias, const float* A,
          const float* D, float* xdbl, T* y, float* ck, int B, int C, int L, int R, int clamp,
          cudaStream_t st) {
  const int P = R + 2 * N;
  int e = project<T>(x, Wx, xdbl, B, C, L, P, st);
  if (e) return e;
  const size_t smem = fwd_smem_floats(R, N) * sizeof(float);
  cudaError_t ce = allow_smem(fwd_walk_kernel<T, N>, smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((C + kFwdCB - 1) / kFwdCB, B * 2);
  for (int dir = 0; dir < 2; ++dir) {
    fwd_walk_kernel<T, N><<<grid, kFwdCB, smem, st>>>(x, xdbl, Wdt, bias, A, D, y, ck, C, L, R,
                                                     dir, clamp);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

template <typename T>
int fwd_t(const void* x, const float* Wx, const float* Wdt, const float* bias, const float* A,
          const float* D, float* xdbl, void* y, float* ck, int B, int C, int L, int R, int N,
          int clamp, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (N) {
    case 1: return fwd_n<T, 1>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 2: return fwd_n<T, 2>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 4: return fwd_n<T, 4>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 8: return fwd_n<T, 8>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    case 16: return fwd_n<T, 16>(xt, Wx, Wdt, bias, A, D, xdbl, yt, ck, B, C, L, R, clamp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int N>
int bwd_n(const float* x, const float* g, const float* Wx, const float* Wdt, const float* bias,
          const float* A, const float* D, const float* ck, float* xdbl, float* ddtr,
          float* bcpart, float* dxdbl, float* wpart, float* wpart2, float* vpart, float* dx,
          float* dWx, float* dWdt, float* v, int B, int C, int L, int R, cudaStream_t st) {
  const int P = R + 2 * N, nblk = (C + kBwdCB - 1) / kBwdCB;
  const long PL = (long)P * L, CL = (long)C * L, PC = (long)P * C, CR = (long)C * R;
  int e = project<float>(x, Wx, xdbl, B, C, L, P, st);
  if (e) return e;
  const size_t smem = bwd_smem_floats(R, N) * sizeof(float);
  cudaError_t ce = allow_smem(bwd_walk_kernel<N>, smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid(nblk, B * 2);
  for (int dir = 0; dir < 2; ++dir) {
    bwd_walk_kernel<N><<<grid, kBwdCB, smem, st>>>(x, g, xdbl, Wdt, bias, A, D, ck, dx, ddtr,
                                                  bcpart, vpart, C, L, R, dir);
    if ((e = (int)cudaGetLastError())) return e;
    // dB | dC rows of dxdbl[b, s, dir]: the channel blocks' partial sums
    if ((e = sum_over(bcpart, dxdbl + dir * PL + R * L, nblk, 2L * N * L, 2L * B,
                      (long)nblk * 2 * N * L, 2 * PL, 2L * N * L, st)))
      return e;
  }
  // dt-rank rows of dxdbl[b, s, dir] (R x L) = Wdt[k]^T (R x C) . ddtr[b, s, dir] (C x L)
  if ((e = gemm<float>(Wdt, Operand{1, R, 0, CR, 2 * CR}, ddtr, Operand{L, 1, 4 * CL, 2 * CL, CL},
                       dxdbl, Operand{L, 1, 4 * PL, 2 * PL, PL}, GemmShape{R, L, C, 2, 2, 0},
                       B * 4, st)))
    return e;
  // dx[b, s] += Wx[k]^T (C x P) . dxdbl[b, s, dir] (P x L), one direction at a time
  for (int dir = 0; dir < 2; ++dir)
    if ((e = gemm<float>(Wx + dir * 2 * PC, Operand{1, C, 0, PC, 0}, dxdbl + dir * PL,
                         Operand{L, 1, 4 * PL, 2 * PL, 0}, dx, Operand{L, 1, 2 * CL, CL, 0},
                         GemmShape{C, L, P, 2, 1, 1}, B * 2, st)))
      return e;
  // per image: dWx[k] (P x C) = dxdbl (P x L) . x^T (L x C), dWdt[k] (C x R) =
  // ddtr (C x L) . xdbl[:R]^T (L x R), stored at k = 2 dir + s; then summed over images
  if ((e = gemm<float>(dxdbl, Operand{L, 1, 4 * PL, 2 * PL, PL}, x, Operand{1, L, 2 * CL, CL, 0},
                       wpart, Operand{C, 1, 4 * PC, PC, 2 * PC}, GemmShape{P, C, L, 2, 2, 0},
                       B * 4, st)))
    return e;
  if ((e = gemm<float>(ddtr, Operand{L, 1, 4 * CL, 2 * CL, CL}, xdbl,
                       Operand{1, L, 4 * PL, 2 * PL, PL}, wpart2, Operand{R, 1, 4 * CR, CR, 2 * CR},
                       GemmShape{C, R, L, 2, 2, 0}, B * 4, st)))
    return e;
  if ((e = sum_over(wpart, dWx, B, 4 * PC, 1, 0, 0, 4 * PC, st))) return e;
  if ((e = sum_over(wpart2, dWdt, B, 4 * CR, 1, 0, 0, 4 * CR, st))) return e;
  const long nv = 4L * C * (N + 2);
  return sum_over(vpart, v, B, nv, 1, 0, 0, nv, st);
}

}  // namespace bem

extern "C" int bem_ss2d_fused_fwd(const void* x, const float* Wx, const float* Wdt,
                                  const float* bias, const float* A, const float* D, float* xdbl,
                                  void* y, float* ck, int B, int C, int L, int R, int N,
                                  int clamp, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bem::fwd_t<__nv_bfloat16>(x, Wx, Wdt, bias, A, D, xdbl, y, ck, B, C, L, R, N, clamp,
                                     s);
  return bem::fwd_t<float>(x, Wx, Wdt, bias, A, D, xdbl, y, ck, B, C, L, R, N, clamp, s);
}

extern "C" int bem_ss2d_fused_bwd(const float* x, const float* g, const float* Wx,
                                  const float* Wdt, const float* bias, const float* A,
                                  const float* D, const float* ck, float* xdbl, float* ddtr,
                                  float* bcpart, float* dxdbl, float* wpart, float* wpart2,
                                  float* vpart, float* dx, float* dWx, float* dWdt, float* v,
                                  int B, int C, int L, int R, int N, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define BEM_BWD(NN)                                                                          \
  return bem::bwd_n<NN>(x, g, Wx, Wdt, bias, A, D, ck, xdbl, ddtr, bcpart, dxdbl, wpart,     \
                        wpart2, vpart, dx, dWx, dWdt, v, B, C, L, R, s)
  switch (N) {
    case 1: BEM_BWD(1);
    case 2: BEM_BWD(2);
    case 4: BEM_BWD(4);
    case 8: BEM_BWD(8);
    case 16: BEM_BWD(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BEM_BWD
}
