// Microbenchmarks of the scan's inner operations on fp32 (n_blocks, 40, lanes).
//
// Replace tools/microbench_vpu.py's two Pallas kernels: run (make_kernel,
// pallas_call at :56) and run2 (make_kernel2, pallas_call at :108). The
// rounds ARE the work being measured, so each kernel executes every round
// as written, never a closed form of them. Both start from a = x,
// b = 0.5 * x and write a + b.
//
// vpu_scan_step (run): npass rounds of the masked shift-scan step of the
// doubling scan. Round i, sh = 1 << (i % 5): a_sh is a rolled by sh along
// lanes with 1 where lane % 32 < sh, b_sh the same for b with 0; then
// b = a * b_sh + b and a = a * a_sh. Because sh <= 16 and the mask is per
// 32-lane segment, every 32-lane segment is independent, and the roll's
// wrap lanes are always the masked ones. So one thread owns one whole
// segment in registers (a[32], b[32]) and the roll is a register index
// known at compile time: the 5-round period sh = 1, 2, 4, 8, 16 is
// unrolled, a loop runs the whole periods, then the npass % 5 rounds left.
// Each round updates in place with j descending, so b[j - sh] and
// a[j - sh] are still the previous round's:
//     b[j] = fmaf(a[j], b[j - sh], b[j]);  a[j] = a[j] * a[j - sh].
// The masked lanes j < sh are left as they are: there the step would be
// fmaf(a, 0, b) and a * 1, which give b and a exactly for finite a (and
// b != -0; the tool's b is never -0), so the result has the bits of the
// one-element-per-thread shuffle form this replaced. No shuffles: at
// npass 10 the shuffle form spent ~1 ms on 7.3 G lane-shuffles alone. A
// block stages its tile of segments through shared memory with a padded
// row of 33 floats, read and written by coalesced float4s: thread t's
// row t * 33 + j lies in bank (t + j) % 32, free of conflicts, and so
// does a warp's float4 transfer (4 segments x 8 vectors cover the 32
// banks). A grid-stride loop walks the tiles.
//
// vpu_op_rounds (run2): 10 rounds of one mode: arith (b = a b + b; a = a a),
// exp (a = exp(-0.01 a); b = a b + b), softplus (a = softplus(0.01 a);
// b = a b + b) or roll (a = a rolled by 1 over the whole lanes-wide row,
// with wrap; b = a b + b). The elementwise modes run one thread per
// element; roll keeps a (block, channel) row in shared memory, two
// buffers alternating so that a round needs one barrier.
//
// Bound: bytes at npass 10 (4 bytes read and 4 written per element against
// about 2 operations a round), operations from about npass 40 on and for
// the softplus mode; the grid-stride loops keep every SM busy.
#include <cstdint>

#include "common.cuh"

namespace bem {

constexpr int kVpuThreads = 256;
constexpr int kRollPerThread = 16;  // elements of a row each thread holds (roll mode)

constexpr int kSegThreads = 128;  // segments a tile (one a thread)
constexpr int kSegStride = 33;    // a segment's padded row in shared memory

// One round of the step with a roll of SH, on one segment in registers.
template <int SH>
__device__ __forceinline__ void scan_round(float (&a)[32], float (&b)[32]) {
#pragma unroll
  for (int j = 31; j >= SH; --j) {
    b[j] = fmaf(a[j], b[j - SH], b[j]);
    a[j] = a[j] * a[j - SH];
  }
}

// x, out: nseg segments of 32 fp32 lanes, 16-byte aligned.
__global__ void __launch_bounds__(kSegThreads)
vpu_scan_step_kernel(const float* __restrict__ x, float* __restrict__ out, long nseg, int npass) {
  __shared__ float tile[kSegThreads * kSegStride];
  const int t = threadIdx.x;
  const int periods = npass / 5, rest = npass % 5;
  for (long seg0 = (long)blockIdx.x * kSegThreads; seg0 < nseg;
       seg0 += (long)gridDim.x * kSegThreads) {
    const int nt = (int)min((long)kSegThreads, nseg - seg0);
    // vector v of the tile: lanes 4 (v % 8) .. + 3 of its segment v / 8
    const float4* src = reinterpret_cast<const float4*>(x + seg0 * 32);
    for (int v = t; v < nt * 8; v += kSegThreads) {
      const float4 q = src[v];
      float* d = tile + (v >> 3) * kSegStride + (v & 7) * 4;
      d[0] = q.x;
      d[1] = q.y;
      d[2] = q.z;
      d[3] = q.w;
    }
    __syncthreads();
    if (t < nt) {
      float a[32], b[32];
      float* row = tile + t * kSegStride;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        a[j] = row[j];
        b[j] = a[j] * 0.5f;
      }
#pragma unroll 1
      for (int p = 0; p < periods; ++p) {
        scan_round<1>(a, b);
        scan_round<2>(a, b);
        scan_round<4>(a, b);
        scan_round<8>(a, b);
        scan_round<16>(a, b);
      }
      if (rest > 0) scan_round<1>(a, b);
      if (rest > 1) scan_round<2>(a, b);
      if (rest > 2) scan_round<4>(a, b);
      if (rest > 3) scan_round<8>(a, b);
#pragma unroll
      for (int j = 0; j < 32; ++j) row[j] = a[j] + b[j];
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(out + seg0 * 32);
    for (int v = t; v < nt * 8; v += kSegThreads) {
      const float* d = tile + (v >> 3) * kSegStride + (v & 7) * 4;
      dst[v] = make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();
  }
}

// mode: 0 arith, 1 exp, 2 softplus
template <int MODE>
__global__ void __launch_bounds__(kVpuThreads)
vpu_op_rounds_kernel(const float* __restrict__ x, float* __restrict__ out, long n) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float a = x[i];
    float b = a * 0.5f;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      if (MODE == 0) {
        b = fmaf(a, b, b);
        a = a * a;
      } else {
        a = MODE == 1 ? expf(a * -0.01f) : softplus(a * 0.01f);
        b = fmaf(a, b, b);
      }
    }
    out[i] = a + b;
  }
}

// One block per (block, channel) row of `lanes` = blockDim.x * kRollPerThread.
__global__ void vpu_roll_rounds_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       int lanes) {
  extern __shared__ float s_row[];  // two buffers of `lanes`
  const long base = (long)blockIdx.x * lanes;
  float a[kRollPerThread], b[kRollPerThread];
#pragma unroll
  for (int j = 0; j < kRollPerThread; ++j) {
    a[j] = x[base + threadIdx.x + j * blockDim.x];
    b[j] = a[j] * 0.5f;
  }
  for (int r = 0; r < 10; ++r) {
    float* buf = s_row + (r & 1) * lanes;
#pragma unroll
    for (int j = 0; j < kRollPerThread; ++j) buf[threadIdx.x + j * blockDim.x] = a[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRollPerThread; ++j) {
      const int l = threadIdx.x + j * blockDim.x;
      a[j] = buf[l == 0 ? lanes - 1 : l - 1];
      b[j] = fmaf(a[j], b[j], b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRollPerThread; ++j) {
    out[base + threadIdx.x + j * blockDim.x] = a[j] + b[j];
  }
}

inline unsigned grid_for(long n) {
  long blocks = (n + kVpuThreads - 1) / kVpuThreads;
  return (unsigned)(blocks < 132L * 64 ? blocks : 132L * 64);
}

}  // namespace bem

// x, out: rows * lanes fp32 (rows = n_blocks * 40); lanes a multiple of 32.
extern "C" int bem_vpu_scan_step(const float* x, float* out, long rows, int lanes, int npass,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || lanes <= 0 || lanes % 32 != 0 || npass < 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long nseg = rows * (lanes / 32);
  const long tiles = (nseg + bem::kSegThreads - 1) / bem::kSegThreads;
  const unsigned grid = (unsigned)(tiles < 132L * 16 ? tiles : 132L * 16);
  bem::vpu_scan_step_kernel<<<grid, bem::kSegThreads, 0, s>>>(x, out, nseg, npass);
  return (int)cudaGetLastError();
}

// mode: 0 arith, 1 exp, 2 softplus, 3 roll (lanes a multiple of 16 * 32,
// at most 16 * 1024, two rows of shared memory within the budget).
extern "C" int bem_vpu_op_rounds(const float* x, float* out, long rows, int lanes, int mode,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  const long n = rows * lanes;
  switch (mode) {
    case 0:
      bem::vpu_op_rounds_kernel<0><<<bem::grid_for(n), bem::kVpuThreads, 0, s>>>(x, out, n);
      break;
    case 1:
      bem::vpu_op_rounds_kernel<1><<<bem::grid_for(n), bem::kVpuThreads, 0, s>>>(x, out, n);
      break;
    case 2:
      bem::vpu_op_rounds_kernel<2><<<bem::grid_for(n), bem::kVpuThreads, 0, s>>>(x, out, n);
      break;
    case 3: {
      const int threads = lanes / bem::kRollPerThread;
      const size_t smem = 2 * (size_t)lanes * sizeof(float);
      if (lanes % (bem::kRollPerThread * 32) != 0 || threads > 1024 || smem > bem::kSmemBudget)
        return (int)cudaErrorInvalidValue;
      cudaError_t e = bem::allow_smem(bem::vpu_roll_rounds_kernel, smem);
      if (e != cudaSuccess) return (int)e;
      if (rows > 0x7fffffffL) return (int)cudaErrorInvalidValue;
      bem::vpu_roll_rounds_kernel<<<(unsigned)rows, threads, smem, s>>>(x, out, lanes);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
