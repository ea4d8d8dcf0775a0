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
// wrap lanes are always the masked ones: one warp per segment, with
// __shfl_up_sync(sh) (which leaves lanes < sh their own value, then
// masked), computes exactly the roll + mask. Rows are a multiple of 32
// lanes, so warp lanes and segment lanes coincide.
//
// vpu_op_rounds (run2): 10 rounds of one mode: arith (b = a b + b; a = a a),
// exp (a = exp(-0.01 a); b = a b + b), softplus (a = softplus(0.01 a);
// b = a b + b) or roll (a = a rolled by 1 over the whole lanes-wide row,
// with wrap; b = a b + b). The elementwise modes run one thread per
// element; roll keeps a (block, channel) row in shared memory, two
// buffers alternating so that a round needs one barrier.
//
// Bound: bytes at npass 10 (4 bytes read and 4 written per element against
// 5 operations a round), operations from about npass 40 on and for the
// softplus mode; the grid-stride loops keep every SM busy.
#include "common.cuh"

namespace bem {

constexpr int kVpuThreads = 256;
constexpr int kRollPerThread = 16;  // elements of a row each thread holds (roll mode)

__global__ void __launch_bounds__(kVpuThreads)
vpu_scan_step_kernel(const float* __restrict__ x, float* __restrict__ out, long n, int npass) {
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float a = x[i];
    float b = a * 0.5f;
    for (int r = 0; r < npass; ++r) {
      const int sh = 1 << (r % 5);
      float a_sh = __shfl_up_sync(0xffffffffu, a, sh);
      float b_sh = __shfl_up_sync(0xffffffffu, b, sh);
      if (lane < sh) {
        a_sh = 1.f;
        b_sh = 0.f;
      }
      b = fmaf(a, b_sh, b);
      a = a * a_sh;
    }
    out[i] = a + b;
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
  const long n = rows * lanes;
  bem::vpu_scan_step_kernel<<<bem::grid_for(n), bem::kVpuThreads, 0, s>>>(x, out, n, npass);
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
