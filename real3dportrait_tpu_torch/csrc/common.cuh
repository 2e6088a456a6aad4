// Shared helpers for the port's hand-written kernels.
//
// Every kernel file exposes a plain C entry point that takes raw device
// pointers plus the caller's CUDA stream, launches, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define R3DP_EXPORT extern "C" __attribute__((visibility("default")))

// Numerically stable softplus, log(1 + e^x) = max(x, 0) + log1p(e^-|x|),
// the form jax.nn.softplus evaluates.
__device__ __forceinline__ float r3dp_softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float r3dp_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

static inline unsigned int r3dp_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}
