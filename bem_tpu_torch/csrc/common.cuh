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

// Shared-memory budget a block may plan for (the card allows 227 KB).
constexpr size_t kSmemBudget = 200 * 1024;

// Streaming multiprocessors of an H100 SXM: the grids' fill rules.
constexpr int kCardSMs = 132;

}  // namespace bem
