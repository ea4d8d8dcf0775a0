// First-order linear recurrence along L of channels-last (M, L, D) fp32:
//   forward  h_t = a_t * h_{t-1} + b_t   (h_{-1} = 0)
//   reverse  h_t = a_t * h_{t+1} + b_t   (h_L = 0)
//
// Replaces bem_tpu/ops/scan.py::linear_scan on its Pallas backend
// (_linear_scan_pallas, body _scan_kernel): the carries of the SS2D row and
// column pairs, of the fused core's forward and backward and of the
// selective scan, and, forward and reverse, the backward recompute of the
// scan pairs (the VJP of a scan is the opposite-direction scan).
// Bound: bytes (a and b read, h written: 12 bytes per element against 2
// flops). Every call is one launch, in one of two forms; the plan (which
// form, tile sizes) is made by the wrapper (ops/scan.py::scan_plan):
//
// scan_walk_kernel, short sequences or many of them: one thread per
// (m, d) walks L, forward or back (no flipped copies); consecutive threads
// take consecutive d, so every load is coalesced.
//
// scan_lookback_kernel, long sequences: a single pass over chunks of
// T = P * kScanSeg positions x DT channels, each a block of P threads per
// channel, each thread owning kScanSeg positions. The block loads the
// chunk's a and b once into shared memory (coalesced along the channels;
// 12 bytes an element, the bound) and keeps them there while it waits for
// its entering state. A block takes its chunk from an atomic ticket
// (chunk-major, so it waits only on blocks that started before it),
// reduces its chunk to the aggregate (A = prod a, B = the end state from
// 0), publishes it, then finds the state entering the chunk in a fixed
// order, so that the result has the same bits on every run: anchor chunks
// (every K-th, the last of each group of K) publish their inclusive state,
// and a chunk in group g starts from group g - 1's anchor state (0 for
// g = 0) and folds the aggregates of the chunks of its group before it, in
// order (the P threads of a channel fold consecutive ranges, the lead
// composes the ranges in order). Only the anchors form a chain (nch / K
// hops); no chunk's state depends on which of its predecessors happened to
// have finished. Flags are set with st.release.gpu after a __threadfence
// and polled with ld.acquire.gpu (one lane a flag), and carry the call's
// epoch (kept on the device, see ScanWs), so the cached workspace never
// needs clearing; the block with the last ticket resets the ticket counter.
#include <cstdint>

#include "common.cuh"

namespace bem {

constexpr int kScanThreads = 256;
constexpr int kScanSeg = 16;   // positions a thread of the look-back form holds (SCAN_SEG)
constexpr int kScanFold = 8;   // aggregates loaded at once by the fold

__global__ void __launch_bounds__(kScanThreads)
scan_walk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ h, int M, int L, int D, int rev) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * D) return;
  const long m = i / D;
  const long base = m * L * D + (i - m * D);
  const long step = rev ? -(long)D : (long)D;
  const long first = base + (rev ? (long)(L - 1) * D : 0);
  float hv = 0.f;
  int k = 0;
  for (; k + 8 <= L; k += 8) {
    float av[8], bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      av[e] = a[first + (k + e) * step];
      bv[e] = b[first + (k + e) * step];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hv = fmaf(av[e], hv, bv[e]);
      h[first + (k + e) * step] = hv;
    }
  }
  for (; k < L; ++k) {
    hv = fmaf(a[first + k * step], hv, b[first + k * step]);
    h[first + k * step] = hv;
  }
}

__device__ __forceinline__ void flag_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned flag_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void flag_wait(const unsigned* p, unsigned epoch) {
  while (flag_acquire(p) != epoch) __nanosleep(32);
}

// agg, pre, fagg, fpre, ctl: the workspace (ScanWs below).
__global__ void __launch_bounds__(kScanThreads, 6)
scan_lookback_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ h, float2* agg, float* pre, unsigned* fagg,
                     unsigned* fpre, unsigned* ctl, int M, int L, int D, int DT, int P,
                     int nch, int K, int rev) {
  __shared__ float2 s_ab[kScanThreads * kScanSeg];  // the chunk's (a, b), (position, channel)
  __shared__ float2 s_seg[kScanThreads];  // segment summaries, then their exclusive prefixes
  __shared__ float2 s_fold[kScanThreads];  // each thread's share of the fold
  __shared__ float s_in[kScanThreads];     // the state entering the chunk, per channel
  __shared__ unsigned s_ticket, s_epoch;
  const int tid = threadIdx.x;
  const int ndt = (D + DT - 1) / DT;
  const int ngrp = (nch + K - 1) / K;
  const unsigned total = (unsigned)M * (unsigned)nch * (unsigned)ndt;
  if (tid == 0) {
    const unsigned t = atomicAdd(&ctl[0], 1u);
    if (t == total - 1) atomicExch(&ctl[0], 0u);  // every ticket is taken: reset for the next call
    s_ticket = t;
    // the last call's epoch + 1: ctl[1] changes only when every block of
    // this call has finished (below)
    s_epoch = *reinterpret_cast<volatile unsigned*>(&ctl[1]) + 1u;
  }
  __syncthreads();
  const unsigned t = s_ticket, epoch = s_epoch;
  const int dt = (int)(t % ndt);
  const unsigned r = t / ndt;
  const int m = (int)(r % M), j = (int)(r / M);
  const int T = P * kScanSeg, nd = min(DT, D - dt * DT);
  const long qc = (long)j * T;                       // the chunk's first position, scan order
  const long mb = (long)m * L * D + (long)dt * DT;   // the tile's first channel at l = 0

  // the chunk's a and b, neighbouring threads on neighbouring channels
  // (a tile row is contiguous where DT = D), kScanFold loads in flight
  for (int u0 = 0; u0 < kScanSeg; u0 += kScanFold) {
    float2 v[kScanFold];
#pragma unroll
    for (int u = 0; u < kScanFold; ++u) {
      const int i = tid + (u0 + u) * kScanThreads, q = i / DT, dl = i - q * DT;
      const long l = rev ? L - 1 - (qc + q) : qc + q;
      const bool in = q < T && qc + q < L && dl < nd;
      v[u] = in ? make_float2(a[mb + l * D + dl], b[mb + l * D + dl]) : make_float2(1.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kScanFold; ++u) {
      const int i = tid + (u0 + u) * kScanThreads;
      if (i < T * DT) s_ab[i] = v[u];
    }
  }
  __syncthreads();

  // thread (dl, p) owns positions p * kScanSeg .. + kScanSeg - 1 of channel dl
  const int dl = tid % DT, p = tid / DT;
  const bool on = p < P && dl < nd;
  const float2* seg = s_ab + p * kScanSeg * DT + dl;
  if (on) {
    float sa = 1.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kScanSeg; ++k) {
      const float2 v = seg[k * DT];
      sb = fmaf(v.x, sb, v.y);
      sa *= v.x;
    }
    s_seg[tid] = make_float2(sa, sb);
  }
  __syncthreads();

  // one thread a channel composes the P segment summaries in order: the
  // chunk's aggregate, and each segment's exclusive prefix in place
  const bool lead = p == 0 && dl < nd;
  const bool anchor = j % K == K - 1 && j + 1 < nch;
  const long ia = ((long)m * nch + j) * D + dt * DT + dl;
  float ga = 1.f, gb = 0.f;
  if (lead) {
    for (int s = 0; s < P; ++s) {
      const float2 v = s_seg[s * DT + dl];
      s_seg[s * DT + dl] = make_float2(ga, gb);
      gb = fmaf(v.x, gb, v.y);
      ga *= v.x;
    }
    if (j + 1 < nch && !anchor) __stcg(&agg[ia], make_float2(ga, gb));
  }
  __syncthreads();
  if (tid == 0 && j + 1 < nch && !anchor) {
    __threadfence();
    flag_release(fagg + ((long)m * nch + j) * ndt + dt, epoch);
  }

  // the state entering the chunk: group g - 1's anchor state, then the
  // aggregates of chunks j0 .. j - 1 in order (lane i of warp 0 waits for
  // chunk j0 + i, lane 31 for the anchor). The P threads of a channel fold
  // consecutive ranges of ceil(n / P) of those aggregates (all loads of a
  // range in flight together), and the lead composes the P parts in order.
  const int g = j / K, j0 = g * K, n = j - j0;
  if (tid < 32) {
    if (tid < n) flag_wait(fagg + ((long)m * nch + j0 + tid) * ndt + dt, epoch);
    if (tid == 31 && g > 0) flag_wait(fpre + ((long)m * ngrp + g - 1) * ndt + dt, epoch);
  }
  __syncthreads();
  if (on) {
    const int rr = (n + P - 1) / P, i0 = j0 + p * rr, i1 = min(j, i0 + rr);
    const float2* ag = agg + ((long)m * nch) * D + dt * DT + dl;
    float fa = 1.f, fb = 0.f;
    for (int i = i0; i < i1; i += kScanFold) {
      float2 v[kScanFold];
#pragma unroll
      for (int e = 0; e < kScanFold; ++e)
        v[e] = i + e < i1 ? __ldcg(ag + (long)(i + e) * D) : make_float2(1.f, 0.f);
#pragma unroll
      for (int e = 0; e < kScanFold; ++e) {
        fb = fmaf(v[e].x, fb, v[e].y);
        fa *= v[e].x;
      }
    }
    s_fold[tid] = make_float2(fa, fb);
  }
  __syncthreads();
  if (lead) {
    float hv = g > 0 ? __ldcg(&pre[((long)m * ngrp + g - 1) * D + dt * DT + dl]) : 0.f;
    for (int s = 0; s < P; ++s) {
      const float2 v = s_fold[s * DT + dl];
      hv = fmaf(v.x, hv, v.y);
    }
    s_in[dl] = hv;
    if (anchor) __stcg(&pre[((long)m * ngrp + g) * D + dt * DT + dl], fmaf(ga, hv, gb));
  }
  __syncthreads();
  if (tid == 0) {
    if (anchor) {
      __threadfence();
      flag_release(fpre + ((long)m * ngrp + g) * ndt + dt, epoch);
    }
    // the last block to get here (every block has read the epoch and waited
    // on its flags) records the epoch for the next call
    if (atomicAdd(&ctl[2], 1u) == total - 1) {
      ctl[2] = 0u;
      ctl[1] = epoch;
    }
  }
  if (!on) return;

  // the segment from its entering state, writing h
  const float2 e = s_seg[tid];
  float hv = fmaf(e.x, s_in[dl], e.y);
  const long q0 = qc + (long)p * kScanSeg;
#pragma unroll
  for (int k = 0; k < kScanSeg; ++k) {
    if (q0 + k < L) {
      const float2 v = seg[k * DT];
      hv = fmaf(v.x, hv, v.y);
      h[mb + (rev ? L - 1 - (q0 + k) : q0 + k) * D + dl] = hv;
    }
  }
}

// The look-back form's workspace, two buffers cached by the wrapper and
// never cleared: data holds agg (M, nch, D) float2 then pre (M, ngrp, D)
// floats; flags holds ctl (words 0-2: the ticket, the last call's epoch,
// the count of finished blocks; 0, the epoch, 0 between calls), the
// aggregates' flags (M, nch, ndt) from word 4, then the anchors' (M, ngrp,
// ndt). Every call's epoch is one more than the last's and the flags
// buffer only ever holds epochs (or 0), so no flag another call left
// matches this call's: nothing is cleared, and a call needs no argument
// from the host that changes from call to call (a captured graph replays).
struct ScanWs {
  size_t pre, data, fpre, flags;  // pre's offset (floats), data's bytes; fpre's (words), flags'
  ScanWs(int M, int D, int DT, int nch, int K) {
    const size_t ndt = (D + DT - 1) / DT, ngrp = (nch + K - 1) / K;
    pre = (size_t)M * nch * D * 2;  // in floats
    data = (pre + (size_t)M * ngrp * D) * sizeof(float);
    fpre = 4 + (size_t)M * nch * ndt;
    flags = (fpre + (size_t)M * ngrp * ndt) * sizeof(unsigned);
  }
};

}  // namespace bem

// One launch. walk != 0: scan_walk_kernel (the other sizes ignored).
// Otherwise scan_lookback_kernel over chunks of P * kScanSeg positions and
// DT channels, anchors every K chunks, on the workspace (data and flags,
// bem_linear_scan_ws bytes each; flags zeroed once when allocated).
extern "C" int bem_linear_scan(const float* a, const float* b, float* h, float* data,
                               unsigned* flags, int M, int L, int D, int walk, int DT, int P,
                               int nch, int K, int rev, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || L <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (walk) {
    const long n = (long)M * D;
    bem::scan_walk_kernel<<<(unsigned)((n + bem::kScanThreads - 1) / bem::kScanThreads),
                            bem::kScanThreads, 0, s>>>(a, b, h, M, L, D, rev);
    return (int)cudaGetLastError();
  }
  if (DT <= 0 || P <= 0 || DT * P > bem::kScanThreads || K <= 0 || K > 32 ||
      (long)nch * P * bem::kScanSeg < L || (long)(nch - 1) * P * bem::kScanSeg >= L)
    return (int)cudaErrorInvalidValue;
  const bem::ScanWs lay(M, D, DT, nch, K);
  const long blocks = (long)M * nch * ((D + DT - 1) / DT);
  bem::scan_lookback_kernel<<<(unsigned)blocks, bem::kScanThreads, 0, s>>>(
      a, b, h, reinterpret_cast<float2*>(data), data + lay.pre, flags + 4, flags + lay.fpre,
      flags, M, L, D, DT, P, nch, K, rev);
  return (int)cudaGetLastError();
}

// bytes of the look-back workspace's data (flags = 0) or flags buffer
extern "C" long bem_linear_scan_ws(int M, int D, int DT, int nch, int K, int flags) {
  const bem::ScanWs lay(M, D, DT, nch, K);
  return (long)(flags ? lay.flags : lay.data);
}
