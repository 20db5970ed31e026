// Shared helpers of the package's hand-written Hopper kernels.
//
// Every kernel is compiled with -fmad=false and never with fast math, and
// the float steps that must round as the JAX reference rounds spell out
// their intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn).
// Entry points are plain C; each returns cudaGetLastError() after its
// launches, which the Python wrapper turns into an exception.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace odc {

// int32 arithmetic that wraps modulo 2^32 like XLA's, without C++'s
// signed-overflow undefined behaviour
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t wneg(int32_t a) {
  return (int32_t)(0u - (uint32_t)a);
}
__device__ __forceinline__ int32_t wabs(int32_t a) {
  return a < 0 ? wneg(a) : a;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace odc
