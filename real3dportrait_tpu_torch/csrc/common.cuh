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

// Split TF32 ("3xTF32", K7a and K1): an fp32 operand x is split as
// hi = tf32(x), lo = tf32(x - hi) (x = hi + lo + ~2^-22 |x|), and each
// product as lo*hi + hi*lo + hi*hi on the tensor cores, small terms first.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a * b for a 16x8 (row) by 8x8 (col) TF32 tile pair, fp32 accumulate.
// Fragments (lane = 4 g + t): a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, col g), b1 (t + 4, g); c0, c1 (row g, cols
// 2t, 2t + 1), c2, c3 (row g + 8, the same cols). The tensor cores add
// into c with truncation, so a long chain of them errs one way.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in split TF32: a's fp32 fragment split here, b given as
// (hi0, hi1, lo0, lo1), split once beforehand.
__device__ __forceinline__ void mma_split_tf32(float (&c)[4], const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], float4 b) {
  mma_tf32(c, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(c, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(c, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

// hi and lo parts of an A fragment
__device__ __forceinline__ void split_tf32(const float (&a)[4], uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_rna(a[i]);
    al[i] = tf32_rna(a[i] - __uint_as_float(ah[i]));
  }
}

// *p += v, 4 floats at a 16 B aligned address: one vector atomic on sm_90
// with CUDA 12.1 or later, else four scalar ones
__device__ __forceinline__ void r3dp_atomic_add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}
