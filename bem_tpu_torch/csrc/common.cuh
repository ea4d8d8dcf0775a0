// Shared helpers for the Hopper kernels of bem_tpu_torch.
//
// Every kernel reads and writes the stream tensor in its own dtype (fp32 or
// bf16) and does all arithmetic in fp32. Weights arrive as fp32, already
// rounded by the Python wrapper where the TPU kernel rounds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bem {

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
  static __device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
  // the value a store keeps
  static __device__ __forceinline__ float round(float v) { return v; }
  // a value held in the stream dtype (shared-memory tiles)
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ float to(float v) { return v; }
};

template <>
struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float from(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 to(float v) { return __float2bfloat16_rn(v); }
};

// round-to-nearest-even to bf16 and back: the value a bf16 cast keeps
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max(x, 0) + log1p(exp(-|x|)), the softplus form of the TPU kernels
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// 16 bytes global -> shared by cp.async (zeros where ``full`` is not set),
// then the group's commit and the wait for every committed group
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared-memory budget a block may plan for (the card allows 227 KB).
constexpr size_t kSmemBudget = 200 * 1024;

// Streaming multiprocessors of an H100 SXM: the grids' fill rules.
constexpr int kCardSMs = 132;

// ---------------------------------------------------------------------------
// The chunked forward scans of h_n = exp(dt A_n) h_n + dt x B_n (the fused
// core's forward in ss2d_fused.cu, the selective scan in scan_fused.cu):
// each sequence is cut into super-chunks of S positions, S a multiple of
// kCk; a summary pass writes each super-chunk's decay and end state from 0,
// a forward linear_scan carries the state across them, and a full pass
// walks every super-chunk at once from the state entering it, staging kCk
// positions at a time through shared memory.

constexpr int kCk = 32;             // scan positions per staged chunk
constexpr int kFwdStates = 4;       // states a thread of the passes holds
constexpr long kFwdFill = kCardSMs * 768L;  // threads a full-pass launch aims for
constexpr int kFwdMinChunks = 2;    // kCk-long chunks a super-chunk holds at least
constexpr float kLog2e = 1.4426950408889634f;

// threads per channel of the passes at N states, each holding
// min(N, kFwdStates) of them (adjacent lanes)
__host__ __device__ constexpr int fwd_groups(int N) {
  return N > kFwdStates ? N / kFwdStates : 1;
}

// Positions per super-chunk of a length-L sequence whose full pass runs
// ``per`` threads a super-chunk: the fewest super-chunks whose threads
// reach kFwdFill, each a whole number of kCk-long chunks and at least
// kFwdMinChunks of them. S >= L (one super-chunk: no summary pass) where
// one alone reaches it. (Measured for the fused core: at batch 2 the
// second exp pass of the summaries pays for itself; at batch 128 it never
// does.)
inline int super_chunk(long per, int L) {
  const int nck = (L + kCk - 1) / kCk;
  const long most = (nck + kFwdMinChunks - 1) / kFwdMinChunks;
  long m = (kFwdFill + per - 1) / per;
  if (m > most) m = most;
  return (int)((nck + m - 1) / m) * kCk;
}

// 2^v in one special-function instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float v) {
#ifdef __CUDA_ARCH__
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#else
  return exp2f(v);
#endif
}

}  // namespace bem
