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
// The flipped, gain-scaled taps come from the wrapper (in fp32, holding the
// values of the activation type's taps).
//
// K6b bias_act replaces ops/bias_act.py bias_act (lines 37-57) together with
// the tail of models/stylegan2.py modulated_conv2d (lines 66-78: the
// demodulation multiply and the noise add): one pass of
//   y = clamp(gain * act(x * d[b,c] + noise[h,w] + bias[c]))
// over an NCHW tensor, each term optional, act in {linear, relu,
// lrelu(0.2)}. Every operation is rounded explicitly (no FMA contraction),
// in the order the plain version rounds, so the two agree bit for bit.
//
// Storage type T is float or __nv_bfloat16; the arithmetic is fp32 in both.
// In bf16, K6a rounds once, when it stores the fp32 sum of the taps (as a
// depthwise convolution with fp32 accumulation does); K6b rounds to bf16
// after each operation, where the plain version's separate bf16 PyTorch ops
// round (the wrapper hands it d, noise and bias already rounded to bf16,
// as the plain version casts them).
//
// What bounds them on an H100: bytes. The largest tensors are the 512^2
// activations of block1 (128 channels, 134 MB in fp32, 67 MB in bf16): K6b
// reads and writes each element once (4 + 4 or 2 + 2 B for ~6 flops), K6a
// reads each input element 16 times through L1 for 16 FMAs per output. XLA
// fused these into the neighbouring convolutions on the TPU; here the plain
// PyTorch form spends a separate pass on each of demodulate, noise, bias,
// activation, gain and clamp, and the FIR runs as a grouped cuDNN
// convolution on a materialised zero-inserted, padded copy. Design: K6a
// computes each output by index arithmetic over the taps, never
// materialising the zero-inserted or padded image (taps that land on an
// inserted zero are skipped; up and down are compile-time, so the
// zero-insertion tests are bit tests, not divisions); K6b is one thread per
// element, neighbouring threads on neighbouring addresses.
#include <cuda_bf16.h>

#include "common.cuh"

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

// One thread per output pixel of one (batch, channel) plane: blockIdx.z
// walks the planes, x/y tile the output. UP and DOWN are template
// parameters so that the zero-insertion tests and the index divisions
// compile to shifts; taps on an inserted zero or outside the image are
// predicated off. F > 0 fixes an F x F filter (the path's 4 x 4): the tap
// loops unroll, the taps sit in registers and each row's and column's
// validity is computed once; F = 0 takes any filter size at run time.
template <typename T, int UP, int DOWN, int F>
__global__ void __launch_bounds__(256)
upfirdn2d_kernel(const T* __restrict__ x, const float* __restrict__ taps, int N, int H,
                 int W, int px0, int py0, int fh_rt, int fw_rt, int Ho, int Wo,
                 T* __restrict__ y) {
  constexpr int kMax = F > 0 ? F : 1;
  const int fh = F > 0 ? F : fh_rt, fw = F > 0 ? F : fw_rt;
  int ox = blockIdx.x * blockDim.x + threadIdx.x;
  int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= Wo || oy >= Ho) return;
  int zh = H * UP, zw = W * UP;
  int uy0 = oy * DOWN - py0, ux0 = ox * DOWN - px0;
  float t[kMax * kMax];
  int col[kMax];
  bool colok[kMax];
  if (F > 0) {
#pragma unroll
    for (int k = 0; k < kMax * kMax; ++k) t[k] = __ldg(taps + k);
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
          if (colok[j]) acc += load_f(row + col[j]) * t[i * kMax + j];
      }
    } else {
      for (int i = 0; i < fh; ++i) {
        int uy = uy0 + i;
        if (uy < 0 || uy >= zh || (UP > 1 && uy % UP != 0)) continue;
        const T* row = xp + (long long)(uy / UP) * W;
        for (int j = 0; j < fw; ++j) {
          int ux = ux0 + j;
          if (ux < 0 || ux >= zw || (UP > 1 && ux % UP != 0)) continue;
          acc += load_f(row + ux / UP) * __ldg(taps + i * fw + j);
        }
      }
    }
    store_f(y + ((long long)nc * Ho + oy) * Wo + ox, acc);
  }
}

template <typename T, int UP, int DOWN>
int launch_upfirdn2d(const T* x, const float* taps, int N, int H, int W, int px0, int py0,
                     int fh, int fw, int Ho, int Wo, T* y, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((Wo + 31) / 32, (Ho + 7) / 8, N < 16 ? N : 16);
  if (fh == 4 && fw == 4)
    upfirdn2d_kernel<T, UP, DOWN, 4><<<grid, block, 0, stream>>>(x, taps, N, H, W, px0,
                                                                  py0, fh, fw, Ho, Wo, y);
  else
    upfirdn2d_kernel<T, UP, DOWN, 0><<<grid, block, 0, stream>>>(x, taps, N, H, W, px0,
                                                                  py0, fh, fw, Ho, Wo, y);
  return (int)cudaGetLastError();
}

template <typename T>
int upfirdn2d(const T* x, const float* taps, int N, int H, int W, int up, int down,
              int px0, int py0, int fh, int fw, int Ho, int Wo, T* y, cudaStream_t stream) {
  if (N < 1 || Ho < 1 || Wo < 1) return (int)cudaGetLastError();
  if (up == 1 && down == 1)
    return launch_upfirdn2d<T, 1, 1>(x, taps, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  if (up == 2 && down == 1)
    return launch_upfirdn2d<T, 2, 1>(x, taps, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  if (up == 1 && down == 2)
    return launch_upfirdn2d<T, 1, 2>(x, taps, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  if (up == 2 && down == 2)
    return launch_upfirdn2d<T, 2, 2>(x, taps, N, H, W, px0, py0, fh, fw, Ho, Wo, y, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
__global__ void __launch_bounds__(256)
bias_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ noise, const float* __restrict__ bias,
                long long total, int C, int HW, int act, float gain, float clamp,
                T* __restrict__ y) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long bc = i / HW;
  int hw = (int)(i - bc * HW);
  int c = (int)(bc % C);
  float v = load_f(x + i);
  if (scale) v = round_to<T>(__fmul_rn(v, scale[bc]));
  if (noise) v = round_to<T>(__fadd_rn(v, noise[hw]));
  if (bias) v = round_to<T>(__fadd_rn(v, bias[c]));
  if (act == kRelu)
    v = v > 0.0f ? v : 0.0f;
  else if (act == kLrelu)
    v = v >= 0.0f ? v : round_to<T>(__fmul_rn(v, 0.2f));
  if (gain != 1.0f) v = round_to<T>(__fmul_rn(v, gain));
  if (clamp >= 0.0f) v = round_to<T>(fminf(fmaxf(v, -clamp), clamp));
  store_f(y + i, v);
}

template <typename T>
int bias_act(const T* x, const float* scale, const float* noise, const float* bias,
             long long total, int C, int HW, int act, float gain, float clamp, T* y,
             cudaStream_t stream) {
  if (act < kLinear || act > kLrelu || C < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  if (total > 0)
    bias_act_kernel<T><<<r3dp_blocks(total, 256), 256, 0, stream>>>(
        x, scale, noise, bias, total, C, HW, act, gain, clamp, y);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N,H,W] (N = batch x channels); taps [fh,fw] fp32 = flip(f) * gain;
// y [N,Ho,Wo] with Ho = (H*up + py0 + py1 - fh) / down + 1 (likewise Wo),
// computed by the caller. up, down in {1, 2}. x and y fp32 or bf16.
R3DP_EXPORT int r3dp_upfirdn2d(const float* x, const float* taps, int N, int H, int W,
                               int up, int down, int px0, int py0, int fh, int fw, int Ho,
                               int Wo, float* y, cudaStream_t stream) {
  return upfirdn2d(x, taps, N, H, W, up, down, px0, py0, fh, fw, Ho, Wo, y, stream);
}

R3DP_EXPORT int r3dp_upfirdn2d_bf16(const __nv_bfloat16* x, const float* taps, int N, int H,
                                    int W, int up, int down, int px0, int py0, int fh,
                                    int fw, int Ho, int Wo, __nv_bfloat16* y,
                                    cudaStream_t stream) {
  return upfirdn2d(x, taps, N, H, W, up, down, px0, py0, fh, fw, Ho, Wo, y, stream);
}

// x, y [B,C,HW] fp32 or bf16; scale [B,C], noise [HW], bias [C] fp32, each
// optional (NULL); act 0 linear, 1 relu, 2 lrelu(0.2); gain; clamp < 0 for
// none.
R3DP_EXPORT int r3dp_bias_act(const float* x, const float* scale, const float* noise,
                              const float* bias, long long total, int C, int HW, int act,
                              float gain, float clamp, float* y, cudaStream_t stream) {
  return bias_act(x, scale, noise, bias, total, C, HW, act, gain, clamp, y, stream);
}

R3DP_EXPORT int r3dp_bias_act_bf16(const __nv_bfloat16* x, const float* scale,
                                   const float* noise, const float* bias, long long total,
                                   int C, int HW, int act, float gain, float clamp,
                                   __nv_bfloat16* y, cudaStream_t stream) {
  return bias_act(x, scale, noise, bias, total, C, HW, act, gain, clamp, y, stream);
}
