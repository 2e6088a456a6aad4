// K6 StyleGAN2 resample and epilogue: the two elementwise-shaped passes
// around every convolution of the SR heads' SynthesisBlocks, in fp32 and,
// for the blocks the reference runs in half precision, in bf16.
//
// K6a upfirdn2d replaces, in the JAX package, ops/upfirdn2d.py upfirdn2d
// (lines 59-97: a depthwise lax.conv_general_dilated with lhs_dilation for
// the zero insertion), as upsample2d (the skip image, x2) and
// conv2d_resample (the FIR after the up-convolution of block0/block1
// conv0) call it. Output pixel (oy, ox) of channel n is
//   gain * sum_{i,j} Z[oy*down + i - py0, ox*down + j - px0] * flip(f)[i, j]
// where Z is the input zero-inserted by `up` (Z[u] = x[u / up] when up
// divides u, else 0) and everything outside Z is 0; negative paddings crop.
// The flipped, gain-scaled taps come from the wrapper by value (FirTaps,
// in fp32, holding the values of the activation type's taps, inside the
// Upfirdn2dPlan that the wrapper caches per call shape).
//
// K6b bias_act replaces ops/bias_act.py bias_act (lines 37-57) together with
// the tail of models/stylegan2.py modulated_conv2d (lines 66-78: the
// demodulation multiply and the noise add): one pass of
//   y = clamp(gain * act(x * d[b,c] + noise[b,h,w] + bias[c]))
// over an NCHW tensor, each term optional, act in {linear, relu,
// lrelu(0.2)}. The noise is one [H,W] plane that every sample shares (the
// "const" noise, batch stride 0) or a plane per sample (the "random"
// noise, batch stride H x W; JAX's [B,H,W,1] draw). Every operation is
// rounded explicitly (no FMA contraction), in the order the plain version
// rounds, so the two agree bit for bit.
//
// Storage type T is float or __nv_bfloat16; the arithmetic is fp32 in both.
// In bf16, K6a rounds once, when it stores the fp32 sum of the taps (as a
// depthwise convolution with fp32 accumulation does); K6b rounds to bf16
// after each operation, where the plain version's separate bf16 PyTorch ops
// round, and rounds d, noise and bias to bf16 as it loads them (the plain
// version casts them first), so the wrapper passes their fp32 tensors
// as they come and launches nothing else.
//
// What bounds them on an H100: bytes. The largest tensors are the 512^2
// activations of block1 (128 channels, 134 MB in fp32, 67 MB in bf16). K6b
// reads and writes each element once (4 + 4 or 2 + 2 B for ~6 flops). XLA
// fused these into the neighbouring convolutions on the TPU; here the plain
// PyTorch form spends a separate pass on each of demodulate, noise, bias,
// activation, gain and clamp, and the FIR runs as a grouped cuDNN
// convolution on a materialised zero-inserted, padded copy. K6a never
// materialises the zero-inserted or padded image; it has three paths, each
// described at its kernel: the block FIR (up 1, down 1, a 4 x 4 filter of
// rank 1) stages its input tile in shared memory once and computes a
// register tile, so each input byte crosses DRAM about once and the sums
// are not held up by 16 loads per output; the skip image's x2 upsample is
// polyphase, 2 x 2
// outputs per thread from a 3 x 3 neighbourhood loaded once, where the
// time is the launch's; every other call is one thread per output. K6b is
// one pass of 16 B vectors (4 fp32 or 8 bf16 a thread, each loaded and
// stored once) over a 2-D grid of (column range, group of rows): a row
// (b, c) loads its d and bias once, a thread reads its noise vector once
// for up to 16 rows, and no index is divided per element. In bf16 the
// rounding after each term would make the pass instruction bound, so the
// leading terms run on bf16 pairs (Vec16 below).
#include <cuda_bf16.h>

#include "common.cuh"

// The taps of one call, passed by value (no device buffer, nothing to build
// per call): t is the flipped, gain-scaled fh x fw filter, row-major, fh and
// fw at most 8, in fp32 holding the values of the activation type's taps;
// where the filter has rank 1, u and v are its factors, t[i][j] = u[i] v[j].
// Read through __grid_constant__, so a run-time index reads the parameter
// space in place instead of a per-thread copy.
struct FirTaps {
  float t[64];
  float u[8];
  float v[8];
};

// Everything of one K6a call but its two pointers and the stream: the
// wrapper builds it once per filter, gain, type, input shape, up, down and
// padding and passes it by address, so a call converts four arguments.
struct Upfirdn2dPlan {
  FirTaps f;
  int sep, N, H, W, up, down, px0, py0, fh, fw, Ho, Wo;
};

namespace {

constexpr int kLinear = 0, kRelu = 1, kLrelu = 2;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the storage type T and back: the rounding of one T op.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the same rounding on the host (the clamp bound, rounded once per launch)
template <typename T>
inline float round_to_host(float v) {
  return v;
}
template <>
inline float round_to_host<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kMaxTap = 8;

__device__ __forceinline__ int floor_div2(int v) { return (v - (v & 1)) / 2; }

// The general path: one thread per output pixel of one (batch, channel)
// plane; blockIdx.z walks the planes, x/y tile the output. UP and DOWN are
// template parameters so that the zero-insertion tests and the index
// divisions compile to shifts; taps on an inserted zero or outside the image
// are predicated off. F > 0 fixes an F x F filter: the tap loops unroll and
// each row's and column's validity is computed once; F = 0 takes any filter
// up to 8 x 8 at run time. It serves the downsampling calls and the filters
// that are not 4 x 4 or, at up 1, not of rank 1; the main path's calls take
// the two kernels below.
template <typename T, int UP, int DOWN, int F>
__global__ void __launch_bounds__(256)
upfirdn2d_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps f, int N, int H,
                 int W, int px0, int py0, int fh_rt, int fw_rt, int Ho, int Wo,
                 T* __restrict__ y) {
  constexpr int kMax = F > 0 ? F : 1;
  const int fh = F > 0 ? F : fh_rt, fw = F > 0 ? F : fw_rt;
  int ox = blockIdx.x * blockDim.x + threadIdx.x;
  int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= Wo || oy >= Ho) return;
  int zh = H * UP, zw = W * UP;
  int uy0 = oy * DOWN - py0, ux0 = ox * DOWN - px0;
  int col[kMax];
  bool colok[kMax];
  if (F > 0) {
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      int ux = ux0 + j;
      colok[j] = ux >= 0 && ux < zw && (UP == 1 || ux % UP == 0);
      col[j] = ux / UP;
    }
  }
  for (int nc = blockIdx.z; nc < N; nc += gridDim.z) {
    const T* xp = x + (long long)nc * H * W;
    float acc = 0.0f;
    if (F > 0) {
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        int uy = uy0 + i;
        if (uy < 0 || uy >= zh || (UP > 1 && uy % UP != 0)) continue;
        const T* row = xp + (long long)(uy / UP) * W;
#pragma unroll
        for (int j = 0; j < kMax; ++j)
          if (colok[j]) acc += load_f(row + col[j]) * f.t[i * kMax + j];
      }
    } else {
      for (int i = 0; i < fh; ++i) {
        int uy = uy0 + i;
        if (uy < 0 || uy >= zh || (UP > 1 && uy % UP != 0)) continue;
        const T* row = xp + (long long)(uy / UP) * W;
        for (int j = 0; j < fw; ++j) {
          int ux = ux0 + j;
          if (ux < 0 || ux >= zw || (UP > 1 && ux % UP != 0)) continue;
          acc += load_f(row + ux / UP) * f.t[i * fw + j];
        }
      }
    }
    store_f(y + ((long long)nc * Ho + oy) * Wo + ox, acc);
  }
}

// Two neighbouring outputs of one row, as one 8 B (fp32) or 4 B (bf16)
// store where both exist and the pair is aligned, else one by one.
__device__ __forceinline__ void store_pair(float* p, float a, float b, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b, bool both,
                                           bool vec) {
  if (both && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (both) p[1] = __float2bfloat16_rn(b);
  }
}

// up = 2, down = 1, 4 x 4 (the skip image's upsample): polyphase. Output
// row oy reads zero-inserted rows u = oy - py0 + i, of which only the even
// ones hold input row u / 2, so each output phase uses 2 x 2 of the 16
// taps. One thread writes the 2 x 2 quad (2qy + dy, 2qx + dx) from the 3 x 3
// input neighbourhood at (floor((2qy - py0) / 2), floor((2qx - px0) / 2)),
// loaded once. EY = py0 & 1 and EX = px0 & 1 fix which taps each phase
// takes (tap row i = 2k - EY - dy for neighbourhood row k), so every tap
// index is a compile-time constant and no tap lands on an inserted zero.
template <typename T, int EY, int EX>
__global__ void __launch_bounds__(256)
upfirdn2d_up2_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps f, int N, int H,
                     int W, int px0, int py0, int Ho, int Wo, T* __restrict__ y) {
  int qx = blockIdx.x * blockDim.x + threadIdx.x;
  int qy = blockIdx.y * blockDim.y + threadIdx.y;
  int oy0 = 2 * qy, ox0 = 2 * qx;
  if (oy0 >= Ho || ox0 >= Wo) return;
  int ry = floor_div2(oy0 - py0), rx = floor_div2(ox0 - px0);
  bool rok[3], cok[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rok[k] = ry + k >= 0 && ry + k < H;
    cok[k] = rx + k >= 0 && rx + k < W;
  }
  bool row2 = oy0 + 1 < Ho, col2 = ox0 + 1 < Wo;
  bool vec = (Wo & 1) == 0;  // then every pair starts 8 B (4 B) aligned
  for (int nc = blockIdx.z; nc < N; nc += gridDim.z) {
    const T* xp = x + (long long)nc * H * W;
    float v[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        v[k][l] = rok[k] && cok[l] ? load_f(xp + (long long)(ry + k) * W + rx + l) : 0.0f;
    float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = 2 * k - EY - dy;
        if (i < 0 || i > 3) continue;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            const int j = 2 * l - EX - dx;
            if (j < 0 || j > 3) continue;
            acc[dy][dx] += v[k][l] * f.t[i * 4 + j];
          }
      }
    T* yp = y + ((long long)nc * Ho + oy0) * Wo + ox0;
    store_pair(yp, acc[0][0], acc[0][1], col2, vec);
    if (row2) store_pair(yp + Wo, acc[1][0], acc[1][1], col2, vec);
  }
}

// up = 1, down = 1, 4 x 4 (the FIR after block0's and block1's
// up-convolutions, 128-256 planes of 259^2-515^2): stage once, compute a
// register tile. A CTA of 256 threads owns a 32 x 128 output tile of one
// plane. It loads the 35 x 131 input tile (with the 3-pixel halo; zeros
// outside the image, negative padding crops) into shared memory once, as
// fp32: a warp loads one row at a time, each lane two neighbouring elements
// from an address aligned to the pair (8 B fp32, 4 B bf16; the rows of 259
// or 515 elements are not 16 B aligned, so wider loads would need a padded
// copy), so the loads coalesce; the halo's re-reads come from L2. Each warp
// then owns 4 output rows, each thread 4 neighbouring columns of them: it
// slides down the 7 input rows it needs, reading 8 columns of each as two
// 16 B shared loads, and keeps the 4 x 4 sums in registers. The filter has
// rank 1, as [1,3,3,1] has (the launcher sends any other to the general
// path): each input row is filtered horizontally with v (16 FMAs for 4
// columns) and added into the rows below with u, 11 FMAs per output instead
// of 16. The tile goes out as 16 B (fp32) or 8 B (bf16)
// stores, one warp writing 128 contiguous outputs. Why these sizes (H100,
// both types): the tile is latency-bound, not bound by its FMAs, so what
// counts is how many CTAs an SM holds; 32 rows need ~32-35 registers a
// thread and 18 KB of shared memory, 8 CTAs an SM, and were faster in bf16
// than 64-row tiles (64 registers) and loads batched over several rows
// (more registers), at about equal fp32 times (PERF.md, K6a findings).
constexpr int kTileW = 128, kTileH = 32, kRowsPerWarp = 4;
constexpr int kInW = kTileW + 3, kInH = kTileH + 3;
constexpr int kSmemW = kTileW + 4;  // 16 B aligned rows; column 131 is never used
constexpr int kPairIters = (kInW + 1 + 63) / 64;  // a warp's pair loads per input row

template <typename T>
__device__ __forceinline__ void store_quad(T* p, const float* v, int n, bool vec);
template <>
__device__ __forceinline__ void store_quad<float>(float* p, const float* v, int n, bool vec) {
  if (n == 4 && vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = v[c];
  }
}
template <>
__device__ __forceinline__ void store_quad<__nv_bfloat16>(__nv_bfloat16* p, const float* v,
                                                          int n, bool vec) {
  if (n == 4 && vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned int*>(&lo);
    packed.y = *reinterpret_cast<unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = packed;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = __float2bfloat16_rn(v[c]);
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

template <typename T>
__global__ void __launch_bounds__(256)
upfirdn2d_fir_tile_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps f, int N,
                          int H, int W, int px0, int py0, int Ho, int Wo,
                          T* __restrict__ y) {
  __shared__ __align__(16) float tile[kInH * kSmemW];
  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * kTileW, oy0 = blockIdx.y * kTileH;
  const int gx0 = ox0 - px0, gy0 = oy0 - py0;  // input of the tile's corner
  const int lane = tid & 31, warp = tid >> 5;
  const int cx = 4 * lane, ry = kRowsPerWarp * warp;  // this thread's outputs in the tile
  const bool vec = (Wo & 3) == 0;
  for (int nc = blockIdx.z; nc < N; nc += gridDim.z) {
    const T* xp = x + (long long)nc * H * W;
    if (nc != (int)blockIdx.z) __syncthreads();  // the tile's previous plane is read
    // a warp loads one input row at a time, each lane two neighbouring
    // elements at once from an address aligned to the pair (shift: the
    // parity of the row segment's first element in memory)
    for (int r = warp; r < kInH; r += 8) {
      const int gy = gy0 + r;
      float* trow = tile + r * kSmemW;
      if (gy < 0 || gy >= H) {
        for (int c = lane; c < kInW; c += 32) trow[c] = 0.0f;
        continue;
      }
      const T* grow = xp + (long long)gy * W;
      const int shift = (int)((reinterpret_cast<uintptr_t>(grow + gx0) / sizeof(T)) & 1);
#pragma unroll
      for (int k = 0; k < kPairIters; ++k) {
        const int c = 2 * (lane + 32 * k) - shift;  // tile column of the pair's first element
        if (c >= kInW) break;
        const int gx = gx0 + c;
        float2 v = make_float2(0.0f, 0.0f);
        if (gx >= 0 && gx + 1 < W) {
          v = load_pair(grow + gx);
        } else {
          if (gx >= 0 && gx < W) v.x = load_f(grow + gx);
          if (gx + 1 >= 0 && gx + 1 < W) v.y = load_f(grow + gx + 1);
        }
        if (c >= 0) trow[c] = v.x;
        if (c + 1 < kInW) trow[c + 1] = v.y;
      }
    }
    __syncthreads();
    float acc[kRowsPerWarp][4];
#pragma unroll
    for (int o = 0; o < kRowsPerWarp; ++o)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[o][c] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp + 3; ++r) {
      const float* src = tile + (ry + r) * kSmemW + cx;
      float4 a = *reinterpret_cast<const float4*>(src);
      float4 b = *reinterpret_cast<const float4*>(src + 4);
      float in[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
      float h[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        h[c] = in[c] * f.v[0] + in[c + 1] * f.v[1] + in[c + 2] * f.v[2] + in[c + 3] * f.v[3];
#pragma unroll
      for (int o = 0; o < kRowsPerWarp; ++o) {
        const int i = r - o;
        if (i < 0 || i > 3) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[o][c] += f.u[i] * h[c];
      }
    }
    const int ox = ox0 + cx, n = min(4, Wo - ox);
    if (n > 0) {
#pragma unroll
      for (int o = 0; o < kRowsPerWarp; ++o) {
        const int oy = oy0 + ry + o;
        if (oy < Ho) store_quad<T>(y + ((long long)nc * Ho + oy) * Wo + ox, acc[o], n, vec);
      }
    }
  }
}

template <typename T, int UP, int DOWN>
void launch_general(const T* x, const FirTaps& f, int N, int H, int W, int px0, int py0,
                    int fh, int fw, int Ho, int Wo, T* y, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((Wo + 31) / 32, (Ho + 7) / 8, N < 16 ? N : 16);
  if (fh == 4 && fw == 4)
    upfirdn2d_kernel<T, UP, DOWN, 4><<<grid, block, 0, stream>>>(x, f, N, H, W, px0, py0, fh,
                                                                  fw, Ho, Wo, y);
  else
    upfirdn2d_kernel<T, UP, DOWN, 0><<<grid, block, 0, stream>>>(x, f, N, H, W, px0, py0, fh,
                                                                  fw, Ho, Wo, y);
}

template <typename T, int EY, int EX>
void launch_up2(const T* x, const FirTaps& f, int N, int H, int W, int px0, int py0, int Ho,
                int Wo, T* y, cudaStream_t stream) {
  dim3 block(32, 8);
  int qw = (Wo + 1) / 2, qh = (Ho + 1) / 2;
  dim3 grid((qw + 31) / 32, (qh + 7) / 8, N < 65535 ? N : 65535);
  upfirdn2d_up2_kernel<T, EY, EX><<<grid, block, 0, stream>>>(x, f, N, H, W, px0, py0, Ho,
                                                              Wo, y);
}

template <typename T>
int upfirdn2d(const T* x, const FirTaps& f, int sep, int N, int H, int W, int up, int down,
              int px0, int py0, int fh, int fw, int Ho, int Wo, T* y, cudaStream_t stream) {
  if (fh < 1 || fw < 1 || fh > kMaxTap || fw > kMaxTap || (up != 1 && up != 2) ||
      (down != 1 && down != 2))
    return (int)cudaErrorInvalidValue;
  if (N < 1 || Ho < 1 || Wo < 1) return (int)cudaGetLastError();
  const bool f4 = fh == 4 && fw == 4;
  if (up == 1 && down == 1 && f4 && sep) {
    dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, N < 65535 ? N : 65535);
    upfirdn2d_fir_tile_kernel<T><<<grid, 256, 0, stream>>>(x, f, N, H, W, px0, py0, Ho, Wo, y);
  } else if (up == 2 && down == 1 && f4) {
    switch ((py0 & 1) * 2 + (px0 & 1)) {
      case 0: launch_up2<T, 0, 0>(x, f, N, H, W, px0, py0, Ho, Wo, y, stream); break;
      case 1: launch_up2<T, 0, 1>(x, f, N, H, W, px0, py0, Ho, Wo, y, stream); break;
      case 2: launch_up2<T, 1, 0>(x, f, N, H, W, px0, py0, Ho, Wo, y, stream); break;
      default: launch_up2<T, 1, 1>(x, f, N, H, W, px0, py0, Ho, Wo, y, stream); break;
    }
  } else if (up == 1 && down == 1) {
    launch_general<T, 1, 1>(x, f, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  } else if (up == 2 && down == 1) {
    launch_general<T, 2, 1>(x, f, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  } else if (up == 1) {
    launch_general<T, 1, 2>(x, f, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  } else {
    launch_general<T, 2, 2>(x, f, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  }
  return (int)cudaGetLastError();
}

// K6b. Every term rounds to T as the plain version's op of T does (no FMA
// contraction: __fmul_rn, __fadd_rn); d, noise, bias and the clamp bound
// are rounded to T as they are loaded, as the plain version casts them.
struct EpiTerms {
  float s, bias;  // this row's d[b,c] and bias[c], rounded to T
  int act;
  float gain, clamp;  // clamp rounded to T, < 0 for none
  bool scale, noise, has_bias;
};

// activation, gain and clamp of one element (a value of T): a clamp of a
// value of T to bounds of T needs no rounding
template <typename T>
__device__ __forceinline__ float act_tail(float v, const EpiTerms& e) {
  if (e.act == kRelu)
    v = v > 0.0f ? v : 0.0f;
  else if (e.act == kLrelu)
    v = v >= 0.0f ? v : round_to<T>(__fmul_rn(v, 0.2f));
  if (e.gain != 1.0f) v = round_to<T>(__fmul_rn(v, e.gain));
  if (e.clamp >= 0.0f) v = fminf(fmaxf(v, -e.clamp), e.clamp);
  return v;
}

template <typename T>
__device__ __forceinline__ float epilogue(float v, float noise, const EpiTerms& e) {
  if (e.scale) v = round_to<T>(__fmul_rn(v, e.s));
  if (e.noise) v = round_to<T>(__fadd_rn(v, noise));
  if (e.has_bias) v = round_to<T>(__fadd_rn(v, e.bias));
  return act_tail<T>(v, e);
}

template <typename T>
__device__ __forceinline__ EpiTerms row_terms(const float* scale, const float* noise,
                                              const float* bias, long long bc, int c, int act,
                                              float gain, float clamp) {
  EpiTerms e;
  e.scale = scale != nullptr;
  e.noise = noise != nullptr;
  e.has_bias = bias != nullptr;
  e.s = e.scale ? round_to<T>(__ldg(scale + bc)) : 1.0f;
  e.bias = e.has_bias ? round_to<T>(__ldg(bias + c)) : 0.0f;
  e.act = act;
  e.gain = gain;
  e.clamp = clamp >= 0.0f ? round_to<T>(clamp) : -1.0f;
  return e;
}

// 16 B of T: 4 fp32 or 8 bf16 elements (Raw), their noise values rounded
// to T (Noise), and the epilogue of all of them. In bf16 the three leading
// terms run on bf16 pairs: the product or sum of two bf16 values rounded
// once to bf16 equals the plain version's fp32 op rounded to bf16 (an fp32
// product of two bf16 values is exact; an fp32 sum that rounds lies far
// from a bf16 tie), at one instruction for two elements.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using Raw = float4;
  using Noise = float4;
  static __device__ __forceinline__ Noise noise(const float (&n)[4]) {
    return make_float4(n[0], n[1], n[2], n[3]);
  }
  static __device__ __forceinline__ Raw gather(const float* p) {
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  static __device__ __forceinline__ Raw apply(Raw v, const Noise& n, const EpiTerms& e) {
    v.x = epilogue<float>(v.x, n.x, e);
    v.y = epilogue<float>(v.y, n.y, e);
    v.z = epilogue<float>(v.z, n.z, e);
    v.w = epilogue<float>(v.w, n.w, e);
    return v;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  using Raw = uint4;
  struct Noise {
    __nv_bfloat162 h[4];
  };
  static __device__ __forceinline__ Noise noise(const float (&n)[8]) {
    Noise r;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.h[i] = __floats2bfloat162_rn(n[2 * i], n[2 * i + 1]);
    return r;
  }
  static __device__ __forceinline__ Raw gather(const __nv_bfloat16* p) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)  // element 2i in the low half
      w[i] = (uint32_t)__ldg(q + 2 * i) | ((uint32_t)__ldg(q + 2 * i + 1) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ Raw apply(Raw v, const Noise& n, const EpiTerms& e) {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const __nv_bfloat162 s2 = __float2bfloat162_rn(e.s), b2 = __float2bfloat162_rn(e.bias);
    const bool tail = e.act != kLinear || e.gain != 1.0f || e.clamp >= 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      if (e.scale) h = __hmul2(h, s2);
      if (e.noise) h = __hadd2(h, n.h[i]);
      if (e.has_bias) h = __hadd2(h, b2);
      if (tail) {
        float2 f = __bfloat1622float2(h);
        h = __floats2bfloat162_rn(act_tail<__nv_bfloat16>(f.x, e),
                                  act_tail<__nv_bfloat16>(f.y, e));
      }
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// V noise values from p: 16 B loads where p is aligned, else one at a time
template <int V>
__device__ __forceinline__ void load_noise(const float* p, float (&v)[V]) {
  if (aligned16(p)) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = a.x, v[i + 1] = a.y, v[i + 2] = a.z, v[i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldg(p + i);
  }
}

constexpr int kEpiThreads = 256;
constexpr int kEpiRows = 2;  // rows whose loads a thread has in flight together

// NCHW: rows = B x C rows of HW elements. blockIdx.y owns rows_per_cta
// consecutive rows, so d[b,c] and bias[c] are loaded once per row and
// nothing is divided per element; a thread owns one 16 B vector slot of
// every row and reads its noise vector once (a plane per sample: once per
// sample its rows cross, noise + (row / C) * nstride). kAligned: x, y and noise 16 B
// aligned and HW a multiple of the vector width, so every row is vectors
// alone (the main path). Otherwise each row starts where y is aligned:
// a scalar head before, a scalar tail after the last whole vector; x and
// noise are read as vectors where they are aligned at that start, else
// element by element.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kEpiThreads)
bias_act_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ noise, int nstride, const float* __restrict__ bias,
                     int rows, int C, int HW, int rows_per_cta, int act, float gain, float clamp,
                     T* __restrict__ y) {
  using Vec = Vec16<T>;
  using Raw = typename Vec::Raw;
  constexpr int V = 16 / (int)sizeof(T);
  const int r0 = blockIdx.y * rows_per_cta, r1 = min(rows, r0 + rows_per_cta);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // vector slot of a row
  float nf[V] = {};
  if (kAligned) {
    const int e = V * k;
    if (e >= HW) return;
    if (noise) load_noise<V>(noise + e, nf);
    typename Vec::Noise nz = Vec::noise(nf);
    int nb = 0;  // the sample whose noise nz holds
    for (int r = r0; r < r1; r += kEpiRows) {
      Raw v[kEpiRows];
#pragma unroll
      for (int u = 0; u < kEpiRows; ++u)
        if (r + u < r1) v[u] = __ldg(reinterpret_cast<const Raw*>(x + (long long)(r + u) * HW + e));
#pragma unroll
      for (int u = 0; u < kEpiRows; ++u) {
        if (r + u >= r1) break;
        if (noise && nstride && (r + u) / C != nb) {
          nb = (r + u) / C;
          load_noise<V>(noise + (long long)nb * nstride + e, nf);
          nz = Vec::noise(nf);
        }
        const EpiTerms t =
            row_terms<T>(scale, noise, bias, r + u, (r + u) % C, act, gain, clamp);
        *reinterpret_cast<Raw*>(y + (long long)(r + u) * HW + e) = Vec::apply(v[u], nz, t);
      }
    }
    return;
  }
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (long long)r * HW;
    T* yr = y + (long long)r * HW;
    const float* nr = noise ? noise + (long long)(r / C) * nstride : nullptr;
    const int h = min(HW, (int)((16 - (reinterpret_cast<uintptr_t>(yr) & 15)) & 15) /
                              (int)sizeof(T));
    const int n_vec = (HW - h) / V, tail = h + V * n_vec;
    const EpiTerms t = row_terms<T>(scale, noise, bias, r, r % C, act, gain, clamp);
    if (k < n_vec) {
      const int e = h + V * k;
      if (noise) load_noise<V>(nr + e, nf);
      const Raw v = aligned16(xr + e) ? __ldg(reinterpret_cast<const Raw*>(xr + e))
                                      : Vec::gather(xr + e);
      *reinterpret_cast<Raw*>(yr + e) = Vec::apply(v, Vec::noise(nf), t);
    }
    // the head [0, h) and the tail [tail, HW), one element a thread
    const int i = threadIdx.x < V ? threadIdx.x : tail + threadIdx.x - V;
    if (blockIdx.x == 0 && threadIdx.x < 2 * V && (threadIdx.x < V ? i < h : i < HW)) {
      const float nz = noise ? round_to<T>(__ldg(nr + i)) : 0.0f;
      store_f(yr + i, epilogue<T>(load_f(xr + i), nz, t));
    }
  }
}

// HW = 1 (the [N,C] affine layers): one thread an element, channel i % C.
template <typename T>
__global__ void __launch_bounds__(kEpiThreads)
bias_act_flat_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ noise, int nstride,
                     const float* __restrict__ bias, long long total, int C, int act,
                     float gain, float clamp, T* __restrict__ y) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const EpiTerms t = row_terms<T>(scale, noise, bias, i, (int)(i % C), act, gain, clamp);
  const float nz = noise ? round_to<T>(__ldg(noise + (i / C) * nstride)) : 0.0f;
  store_f(y + i, epilogue<T>(load_f(x + i), nz, t));
}

template <typename T>
int bias_act(const T* x, const float* scale, const float* noise, int nstride,
             const float* bias, long long total, int C, int HW, int act, float gain,
             float clamp, T* y, cudaStream_t stream) {
  if (act < kLinear || act > kLrelu || C < 1 || HW < 1 || total % HW ||
      (nstride != 0 && nstride != HW))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaGetLastError();
  if (HW == 1) {
    bias_act_flat_kernel<T><<<r3dp_blocks(total, kEpiThreads), kEpiThreads, 0, stream>>>(
        x, scale, noise, nstride, bias, total, C, act, gain, clamp, y);
    return (int)cudaGetLastError();
  }
  if (total / HW > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / (int)sizeof(T);
  const int rows = (int)(total / HW);
  const bool aligned = HW % V == 0 && aligned16(x) && aligned16(y) && (!noise || aligned16(noise));
  const unsigned gx = r3dp_blocks(HW / V + (aligned ? 0 : 1), kEpiThreads);
  // about 4096 CTAs (several waves, so that the last is a small share),
  // each over 4 to 16 rows of one column range
  long long per = ((long long)rows * gx + 4095) / 4096;
  per = per < 4 ? 4 : per > 16 ? 16 : per;
  if ((rows + per - 1) / per > 65535) per = (rows + 65534) / 65535;
  const dim3 grid(gx, (unsigned)((rows + per - 1) / per));
  if (aligned)
    bias_act_rows_kernel<T, true><<<grid, kEpiThreads, 0, stream>>>(
        x, scale, noise, nstride, bias, rows, C, HW, (int)per, act, gain, clamp, y);
  else
    bias_act_rows_kernel<T, false><<<grid, kEpiThreads, 0, stream>>>(
        x, scale, noise, nstride, bias, rows, C, HW, (int)per, act, gain, clamp, y);
  return (int)cudaGetLastError();
}


// K6b's gradient (bias_act_grad in ops/bias_act.py; no TPU kernel of its
// own: jax.grad differentiated the XLA epilogue). From the forward's output
// y and its gradient dy: dz = dy * (gain * act'(y)), 0 where |y| reached the
// clamp (rounded to T, as the forward rounds it); the activations keep y's
// sign, so y alone decides act'. dx = dz * d[b,c] (d rounded to T), rounded
// to T once; the sums in fp32: db[c] = sum dz, dscale[b,c] = sum_hw dz * x,
// dnoise[hw] = sum_bc dz (a plane per sample: dnoise[b,hw] = sum_c dz),
// each optional (NULL). Bound by bytes like the
// forward (dy, y and, for dscale, x read once, dx written once). Design,
// simple first: a CTA walks a strided range of one row (b, c) with scalar
// loads, so that d[b,c] is read once and each row's sums reduce by warp
// shuffles into one atomicAdd a warp; dnoise, off the training path (the
// task runs noise_mode "none"), adds element by element.
__device__ __forceinline__ float grad_slope(float yv, int act, float gain, float clamp) {
  const float one = (act == kLinear || yv > 0.0f) ? 1.0f : (act == kLrelu ? 0.2f : 0.0f);
  const float s = __fmul_rn(one, gain);
  return clamp >= 0.0f && !(fabsf(yv) < clamp) ? 0.0f : s;
}

constexpr int kGradThreads = 256, kGradCtasPerRow = 32;

template <typename T>
__global__ void __launch_bounds__(kGradThreads)
bias_act_grad_rows_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                          const T* __restrict__ x, const float* __restrict__ scale, int C,
                          int HW, int act, float gain, float clamp, T* __restrict__ dx,
                          float* __restrict__ dbias, float* __restrict__ dscale,
                          float* __restrict__ dnoise, int nstride) {
  const int row = blockIdx.y;
  const long long base = (long long)row * HW;
  if (dnoise) dnoise += (long long)(row / C) * nstride;
  const float s = scale ? round_to<T>(__ldg(scale + row)) : 1.0f;
  float sum_b = 0.0f, sum_s = 0.0f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < HW; i += gridDim.x * blockDim.x) {
    const float dz = __fmul_rn(load_f(dy + base + i),
                               grad_slope(load_f(y + base + i), act, gain, clamp));
    sum_b += dz;
    if (dscale) sum_s += dz * load_f(x + base + i);
    if (dnoise) atomicAdd(dnoise + i, dz);
    store_f(dx + base + i, scale ? __fmul_rn(dz, s) : dz);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum_b += __shfl_down_sync(0xffffffffu, sum_b, o);
    sum_s += __shfl_down_sync(0xffffffffu, sum_s, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (dbias) atomicAdd(dbias + row % C, sum_b);
    if (dscale) atomicAdd(dscale + row, sum_s);
  }
}

// HW = 1 (the [N,C] dense layers): a thread an element, channel i % C
template <typename T>
__global__ void __launch_bounds__(kGradThreads)
bias_act_grad_flat_kernel(const T* __restrict__ dy, const T* __restrict__ y, long long total,
                          int C, int act, float gain, float clamp, T* __restrict__ dx,
                          float* __restrict__ dbias) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float dz = __fmul_rn(load_f(dy + i), grad_slope(load_f(y + i), act, gain, clamp));
  if (dbias) atomicAdd(dbias + i % C, dz);
  store_f(dx + i, dz);
}

template <typename T>
int bias_act_grad(const T* dy, const T* y, const T* x, const float* scale, long long total,
                  int C, int HW, int act, float gain, float clamp, T* dx, float* dbias,
                  float* dscale, float* dnoise, int nstride, cudaStream_t stream) {
  if (act < kLinear || act > kLrelu || C < 1 || HW < 1 || total % HW ||
      (dscale && (!x || !scale)) || (HW == 1 && (scale || dnoise)) ||
      (nstride != 0 && nstride != HW))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaGetLastError();
  const float bound = clamp >= 0.0f ? round_to_host<T>(clamp) : -1.0f;
  if (HW == 1) {
    bias_act_grad_flat_kernel<T><<<r3dp_blocks(total, kGradThreads), kGradThreads, 0, stream>>>(
        dy, y, total, C, act, gain, bound, dx, dbias);
    return (int)cudaGetLastError();
  }
  const long long rows = total / HW;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  unsigned gx = r3dp_blocks(HW, kGradThreads);
  if (gx > kGradCtasPerRow) gx = kGradCtasPerRow;
  bias_act_grad_rows_kernel<T><<<dim3(gx, (unsigned)rows), kGradThreads, 0, stream>>>(
      dy, y, x, scale, C, HW, act, gain, bound, dx, dbias, dscale, dnoise, nstride);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N,H,W] (N = batch x channels); p the plan: the taps (fh, fw <= 8), sep
// non-zero where f.u, f.v factor them, up, down in {1, 2}, the pads and
// Ho = (H*up + py0 + py1 - fh) / down + 1 (likewise Wo), computed by the
// caller; y [N,Ho,Wo]. x and y fp32 or bf16.
R3DP_EXPORT int r3dp_upfirdn2d(const float* x, const Upfirdn2dPlan* p, float* y,
                               cudaStream_t stream) {
  return upfirdn2d(x, p->f, p->sep, p->N, p->H, p->W, p->up, p->down, p->px0, p->py0, p->fh,
                   p->fw, p->Ho, p->Wo, y, stream);
}

R3DP_EXPORT int r3dp_upfirdn2d_bf16(const __nv_bfloat16* x, const Upfirdn2dPlan* p,
                                    __nv_bfloat16* y, cudaStream_t stream) {
  return upfirdn2d(x, p->f, p->sep, p->N, p->H, p->W, p->up, p->down, p->px0, p->py0, p->fh,
                   p->fw, p->Ho, p->Wo, y, stream);
}

// x, y [B,C,HW] fp32 or bf16, total = B x C x HW; scale [B,C], noise
// [HW] (nstride 0) or [B,HW] (nstride HW), bias [C] fp32 (the kernel
// rounds them to x's type), each optional (NULL); act 0 linear, 1 relu, 2
// lrelu(0.2); gain; clamp < 0 for none.
R3DP_EXPORT int r3dp_bias_act(const float* x, const float* scale, const float* noise,
                              int nstride, const float* bias, long long total, int C, int HW,
                              int act, float gain, float clamp, float* y,
                              cudaStream_t stream) {
  return bias_act(x, scale, noise, nstride, bias, total, C, HW, act, gain, clamp, y, stream);
}

R3DP_EXPORT int r3dp_bias_act_bf16(const __nv_bfloat16* x, const float* scale,
                                   const float* noise, int nstride, const float* bias,
                                   long long total, int C, int HW, int act, float gain,
                                   float clamp, __nv_bfloat16* y, cudaStream_t stream) {
  return bias_act(x, scale, noise, nstride, bias, total, C, HW, act, gain, clamp, y, stream);
}

// dy, y (and x where dscale is wanted) [B,C,HW] fp32 or bf16, total = B x C
// x HW, HW = 1 for [N,C]; scale [B,C] fp32 (rounded to the type) or NULL;
// act, gain and clamp as the forward's (clamp < 0 for none). dx the
// type's; dbias [C], dscale [B,C], dnoise [HW] (nstride 0) or [B,HW]
// (nstride HW) fp32, zeroed by the caller, each NULL where not wanted.
R3DP_EXPORT int r3dp_bias_act_grad(const float* dy, const float* y, const float* x,
                                   const float* scale, long long total, int C, int HW,
                                   int act, float gain, float clamp, float* dx, float* dbias,
                                   float* dscale, float* dnoise, int nstride,
                                   cudaStream_t stream) {
  return bias_act_grad(dy, y, x, scale, total, C, HW, act, gain, clamp, dx, dbias, dscale,
                       dnoise, nstride, stream);
}

R3DP_EXPORT int r3dp_bias_act_grad_bf16(const __nv_bfloat16* dy, const __nv_bfloat16* y,
                                        const __nv_bfloat16* x, const float* scale,
                                        long long total, int C, int HW, int act, float gain,
                                        float clamp, __nv_bfloat16* dx, float* dbias,
                                        float* dscale, float* dnoise, int nstride,
                                        cudaStream_t stream) {
  return bias_act_grad(dy, y, x, scale, total, C, HW, act, gain, clamp, dx, dbias, dscale,
                       dnoise, nstride, stream);
}
