// K7 motion-field estimator convolutions: K7a conv3d and K7b mfe_tail.
//
// K7a conv3d replaces, in the JAX package, ops/conv3d.py conv3d_via_2d and
// its Conv3D module (lines 21-46, 77-105), which lower every 3D convolution
// of the torso model as kd batched 2D convolutions because XLA:TPU tiles
// NDHWC 3D convolutions poorly: the 3^3 convs of ConvBlock3D (the
// motion-field estimator's U-Net, the appearance extractor's ResBlock3D)
// and the 7^3 tgt_head_fuser (models/torso.py:112, 167-169, 424). Here: a
// stride-1 3D convolution with zero "same" padding, cubic kernel 3 or 7,
// fp32, bias fused, on NCDHW activations and [Co,Ci,k,k,k] weights.
//
// What bounds it on an H100: operations (the fuser is 108 GFLOP, the
// U-Net's ten 3^3 convs 60 GFLOP, counting the taps inside the volume),
// even at the deepest 3^3 convs, whose 4x4 planes carry 57 MB of weights
// for 4.8 GFLOP. Two bounds: as FFMAs on the CUDA cores, ops / 67 TFLOP/s
// (fuser 1.616 ms); on the tensor cores in split TF32, 3 x ops / 495
// TFLOP/s (fuser 0.656 ms), the one this kernel is held to.
//
// Design: an implicit GEMM on the tensor cores. M is a CTA's output voxels
// (TD depth slices x TH rows x TW columns, the whole width up to 64), N its
// output channels (32, or 64 on the 4x4 planes), K = Ci x k^3, walked in
// steps of (8 input channels, kd, KH rows of taps), KH = k where two CTAs'
// stages fit an SM's shared memory, else 1 (the 7^3 fuser, the 4x4
// planes); the taps of a step are unrolled inside it. No im2col is written:
// a step stages the 8 channels' input halo tile (TD x (TH+KH-1) x
// (TW+k-1)) and the matching weights in shared memory, and the A fragment
// of tap (kh, kw) is the halo tile read at a shifted address. Each of the
// 8 warps owns 32 voxels x 32 channels: 2 x 4 tiles of mma.sync m16n8k8
// TF32 (A: voxels x channels in, B: channels in x channels out).
//
// Split TF32 ("3xTF32"): every fp32 operand x is split as hi = tf32(x),
// lo = tf32(x - hi) (cvt.rna), and each product is lo*hi + hi*lo + hi*hi,
// accumulated in fp32 in that order, small terms first. hi*hi alone keeps
// 11 bits of each operand: its products err by up to 2^-11 relatively, and
// a sum of up to 89 x 343 = 30,527 of them errs near 1e-3 on O(1)
// outputs, where the port holds K7a to 1e-4-3e-4. The two cross terms
// restore all but lo*lo (~2^-22 relatively), for 3 tensor-core products
// per fp32 product: the 3x in the bound above. A landed stage is split once
// in shared memory (hi in place, lo beside it), not per fragment load: a
// halo value feeds up to k^2 taps of 1-2 warps, a weight every M warp.
// The tensor cores add into their accumulator with truncation, so each
// mma loses up to an ulp of the running sum, always the same way: ~12,000
// of them into one accumulator (the fuser) erred by 1.2e-3 on the card.
// So a row of taps sums into a fresh tile that the running sum takes by a
// rounded fp32 add, which leaves the error of fp32 FFMAs (3.8e-5 at the
// fuser, against 3.3e-5 for the FFMA kernel this one replaced).
//
// Staging: cp.async into a ring of kStages buffers, so that step s + 1
// loads while step s computes. A halo row's interior goes in 16 B pieces
// (where W is a multiple of 4 and x is 16 B aligned; else 4 B pieces) and
// its k/2 border columns on each side in 4 B pieces; the padding faces,
// ragged rows and ragged Ci and Co are zero-filled (src-size 0). A halo
// row starts OFF = (4 - k/2 % 4) % 4 floats into its shared row, so that
// the interior lands 16 B aligned. The weights, read [Co,Ci,k,k,k] from
// device memory, are transposed on the way to [tap][ci][co] (a warp reads
// 8 output channels x 4 consecutive (ci, tap) rows: 16 B runs).
//
// Shared-memory layout, chosen so that every fragment load of a warp hits
// 32 distinct banks: a lane (g = lane/4, t = lane%4) reads A at channel t
// (and t + 4) and voxel g (and g + 8), B at channel t (and t + 4) and
// output channel g. So the per-channel stride of the halo tile (CS) and of
// the weights (NS = BN + 8) are both 8 mod 32: the 4 channels land on bank
// groups 0, 8, 16, 24 and the 8 voxels (consecutive columns, or 2 rows of
// 4 columns with a row stride of 12 at the 4x4 planes) or channels fill
// each group. The weights' tap stride (TS = 8 NS + 8) is also 8 mod 32, so
// that the staging stores of 4 consecutive taps do not collide.
//
// The plan (ops/conv3d.py conv3d_plan) picks the tile. Where the tiles and
// output-channel blocks give fewer CTAs than SMs (the deep 4x4, 8x8 and
// 16x16 levels) the input channels are split over CTAs that write partial
// sums, and a second pass adds them and the bias in a fixed order (no
// atomics: the result does not depend on scheduling).
//
// K7b mfe_tail replaces models/torso.py lines 429-482 (the "fused" tail,
// with ops/conv3d.py folded_banded_kernel, lines 49-74, as its TPU form:
// the mask conv's depth folded into 128-lane output tiles, because a
// Co = K+1 = 5 conv wastes an MXU tile 25x). Here, per voxel: the mask
// conv's 7^3 logits (C -> K+1), the softmax over the K+1 candidates and the
// deformation sum_k mask_k * sparse_motion_k with the sparse motions
// computed from the keypoints; per pixel: both 7^2 occlusion heads on the
// C-major depth fold (channel c*D + d, C*D -> 1 each) and their sigmoid.
// Both heads read the same x halo tiles, so one pass computes both.
//
// What bounds it: fp32 operations (6.5 GFLOP at the standard preset's
// [1,32,16,64,64], 0.097 ms at 67 TFLOP/s); cuDNN pays for Co = 5 with
// mostly idle tiles, and split TF32 on mma.sync would pay 3 products on
// N = 8 tiles of which 5 are used, so it stays on FFMA. A FFMA kernel needs
// few other instructions per FFMA, loads that land before they are used,
// and enough warps to hide the shared-memory latency. Design:
// - A thread owns 8 output depths (D = 16; all of them at D = 2) of one
//   pixel: 40 logits and its depth group's two occlusion sums in
//   registers. Per tap it loads its pixel's 11 input depths (3 LDS.128:
//   the halo tile is transposed to depth-innermost as it lands, 20 floats a
//   pixel, so 8 neighbouring lanes hit 8 distinct bank quads), the tap's
//   35 mask weights (9 broadcast LDS.128, [tap][kd][k] padded to 36) and 16
//   occlusion weights (4 LDS.128), then does 250 mask and 16 occlusion
//   FFMAs: 16 loads for 266 FFMAs, where the design this replaced issued
//   83 scalar loads for 532.
// - A CTA (8 warps) owns a 4 x 32 pixel tile at every depth (the two depth
//   groups are whole warps apart, so each warp runs one unrolled tap body)
//   and a range of input channels (models/torso.py mfe_tail_plan). It
//   stages one channel at a time with cp.async into a two-stage ring, so
//   channel c + 1 lands while c computes; the halo's padding is
//   zero-filled. Two CTAs an SM (128 registers a thread, 2 x 87 KB of
//   shared memory): 16 warps, where the old design held 8.
// - The channel splits write partial sums that a second launch adds in
//   split order (no atomics: two launches are bit-equal) before the
//   biases, the softmax, the deformation and the sigmoids. A thread-block
//   cluster per pixel tile, adding the splits through distributed shared
//   memory in one launch, was built and measured: an H100 holds 30
//   clusters of 8 such CTAs at once, not the frame's 32 tiles, and the
//   second wave doubled the time (0.25 ms against 0.18).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps (K7a)
constexpr int kWarps = kThreads / 32;
constexpr int kWarpTile = 32;     // a K7a warp's output tile: 32 voxels x 32 channels
constexpr int kCiChunk = 8;       // input channels per step: the mma's k
constexpr int kStages = 2;        // depth of the cp.async ring
constexpr int kSmemMax = 232448;  // shared memory an H100 block can opt into

// ---------------------------------------------------------------------------
// K7a
// ---------------------------------------------------------------------------

// The shared-memory layout of one step's stage (in floats), shared by the
// launcher and the kernel. A step covers KH rows of taps (K, or 1).
struct K7Layout {
  int RS;  // halo row stride: OFF + TW + K - 1, rounded up to 4
  int HR;  // halo rows: TH + KH - 1
  int CS;  // one input channel's halo tile TD x HR x RS, rounded up to 8 mod 32
  int NS;  // one input channel's weight row: BN + 8
  int TS;  // one tap's weights: 8 NS + 8
  int in_floats, stage_floats;
};

__host__ __device__ constexpr int k7_halo_off(int K) { return (4 - (K / 2) % 4) % 4; }

static K7Layout k7_layout(int K, int KH, int BN, int TD, int TH, int TW) {
  K7Layout l;
  l.RS = (k7_halo_off(K) + TW + K - 1 + 3) & ~3;
  l.HR = TH + KH - 1;
  const int cs = TD * l.HR * l.RS;
  l.CS = cs + ((8 - cs % 32) + 32) % 32;
  l.NS = BN + 8;
  l.TS = kCiChunk * l.NS + 8;
  l.in_floats = kCiChunk * l.CS;
  l.stage_floats = l.in_floats + KH * K * l.TS;
  return l;
}

// n / d for 0 <= n < 2^22 by a float reciprocal and one correction each way
struct K7Div {
  int d;
  float r;
};

static K7Div k7_div(int d) { return K7Div{d, 1.0f / (float)d}; }

__device__ __forceinline__ int k7_quot(int n, K7Div v) {
  int q = __float2int_rz((float)n * v.r);
  q += (q + 1) * v.d <= n;
  q -= q * v.d > n;
  return q;
}

// Everything of one K7a call but its pointers, passed to the kernel by value.
struct K7Geom {
  K7Layout l;
  int Ci, Co, D, H, W;
  int TD, TH, TW, nd, nh, nw;
  int ci_per_split, vec, pieces;  // pieces: copies per halo row
  K7Div by_pieces, by_rows, by_depth;  // pieces, HR, TD
  long long split_stride;
};

// asynchronous copies to shared memory; an invalid source copies nothing
// and zero-fills the destination (src-size 0)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Issue the copies of one step (input channels ci0.., depth tap kd, tap
// rows kh0 .. kh0 + KH - 1) into a stage buffer: the halo tile
// [8][TD][HR][RS] and the weights [KH*K][8][NS] (tap stride TS).
template <int K, int KH, int BN>
__device__ __forceinline__ void k7_stage(float* buf, const float* __restrict__ xb,
                                         const float* __restrict__ wt, const K7Geom& g, int ci0,
                                         int ci_end, int kd, int kh0, int d0, int h0, int w0,
                                         int co0) {
  constexpr int P = K / 2, OFF = k7_halo_off(K), KK = K * K, TAPS = KH * K;
  const int tid = threadIdx.x;
  const long long HW = (long long)g.H * g.W, DHW = g.D * HW;
  const int n_vec = g.vec ? g.TW / 4 : 0;
  const int rows = kCiChunk * g.TD * g.l.HR;
  for (int e = tid; e < rows * g.pieces; e += kThreads) {
    const int r = k7_quot(e, g.by_pieces), piece = e - r * g.pieces;
    const int rz = k7_quot(r, g.by_rows), hy = r - rz * g.l.HR;
    const int ci = k7_quot(rz, g.by_depth), z = rz - ci * g.TD;
    const int gd = d0 + z + kd - P, gh = h0 + kh0 + hy - P;
    const bool row_ok = ci0 + ci < ci_end && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H;
    float* srow = buf + ci * g.l.CS + (z * g.l.HR + hy) * g.l.RS + OFF;  // halo column 0
    const long long grow = (ci0 + ci) * DHW + gd * HW + (long long)gh * g.W;
    if (piece < n_vec) {  // interior, 16 B: halo columns P + 4 piece ..
      const int gw = w0 + 4 * piece;
      const bool ok = row_ok && gw < g.W;
      cp_async16(srow + P + 4 * piece, ok ? xb + grow + gw : xb, ok);
    } else {  // 4 B: the borders (vec), or every column
      const int q = piece - n_vec;
      const int c = g.vec && q >= P ? g.TW + q : q;
      const int gw = w0 + c - P;
      const bool ok = row_ok && gw >= 0 && gw < g.W;
      cp_async4(srow + c, ok ? xb + grow + gw : xb, ok);
    }
  }
  // a warp reads 8 output channels x 4 consecutive (ci, tap) rows of the
  // [Co,Ci,K,K,K] weight; a thread keeps its output channel, and its rows
  // step by kThreads / BN
  constexpr int ITEMS = BN * kCiChunk * TAPS / kThreads, STRIDE = kThreads / BN;
  static_assert(ITEMS * kThreads == BN * kCiChunk * TAPS, "whole rows of copies");
  float* w_s = buf + g.l.in_floats;
  const int lane = tid % 32, warp = tid / 32;
  const int n = 8 * (warp % (BN / 8)) + lane % 8, r0 = 4 * (warp / (BN / 8)) + lane / 8;
  const bool n_ok = co0 + n < g.Co;
  const float* w_n = wt + ((long long)(co0 + n) * g.Ci + ci0) * (K * KK) + kd * KK + kh0 * K;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = r0 + STRIDE * i;
    const int ci = r / TAPS, t = r - ci * TAPS;
    const bool ok = n_ok && ci0 + ci < ci_end;
    cp_async4(w_s + t * g.l.TS + ci * g.l.NS + n, ok ? w_n + ci * (K * KK) + t : wt, ok);
  }
}

// Split a landed stage in place into its TF32 high parts, and its low parts
// into lo: x = hi + lo + (~2^-22 |x|).
__device__ __forceinline__ void k7_split_stage(float* buf, float* lo, int n_floats) {
  float4* b4 = reinterpret_cast<float4*>(buf);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int e = threadIdx.x; e < n_floats / 4; e += kThreads) {
    float4 v = b4[e], h;
    h.x = __uint_as_float(tf32_rna(v.x));
    h.y = __uint_as_float(tf32_rna(v.y));
    h.z = __uint_as_float(tf32_rna(v.z));
    h.w = __uint_as_float(tf32_rna(v.w));
    b4[e] = h;
    v.x = __uint_as_float(tf32_rna(v.x - h.x));
    v.y = __uint_as_float(tf32_rna(v.y - h.y));
    v.z = __uint_as_float(tf32_rna(v.z - h.z));
    v.w = __uint_as_float(tf32_rna(v.w - h.w));
    l4[e] = v;
  }
}

template <int K, int KH, int WN>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_kernel(const float* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ bias, float* __restrict__ out, const K7Geom g) {
  constexpr int BN = kWarpTile * WN, WM = kWarps / WN;
  constexpr int OFF = k7_halo_off(K), ROWS = K / KH;  // steps per (chunk, kd)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = g.l.stage_floats;
  float* lo = smem + kStages * stage_floats;  // the low parts of the step computing

  int t = blockIdx.x;
  const int tw_i = t % g.nw;
  t /= g.nw;
  const int th_i = t % g.nh;
  t /= g.nh;
  const int td_i = t % g.nd;
  const int b = t / g.nd;
  const int d0 = td_i * g.TD, h0 = th_i * g.TH, w0 = tw_i * g.TW;
  const int co0 = blockIdx.y * BN;
  const int ci_begin = blockIdx.z * g.ci_per_split;
  const int ci_end = min(g.Ci, ci_begin + g.ci_per_split);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % WM, wn = warp / WM;
  const int tile_vox = g.TD * g.TH * g.TW;
  // the halo offset of output voxel m (rows gid and gid + 8 of each m16
  // tile) at tap (0, 0); voxels past the tile read offset 0 and are not stored
  int voff[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = wm * kWarpTile + mt * 16 + gid + 8 * j;
      const int z = m / (g.TH * g.TW), y = (m / g.TW) % g.TH, xx = m % g.TW;
      voff[mt][j] = m < tile_vox ? (z * g.l.HR + y) * g.l.RS + xx + OFF : 0;
    }

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  const long long DHW = (long long)g.D * g.H * g.W;
  const float* xb = x + (long long)b * g.Ci * DHW;
  // step s: channel chunk s / (K ROWS), depth tap (s / ROWS) % K, tap rows
  // from (s % ROWS) KH
  const int n_steps = (ci_end - ci_begin + kCiChunk - 1) / kCiChunk * K * ROWS;
  auto stage = [&](int s) {
    k7_stage<K, KH, BN>(smem + s % kStages * stage_floats, xb, wt, g,
                        ci_begin + s / (K * ROWS) * kCiChunk, ci_end, s / ROWS % K,
                        s % ROWS * KH, d0, h0, w0, co0);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed
    __syncthreads();               // ... for every thread; step s - 1 is computed
    if (s + kStages - 1 < n_steps) stage(s + kStages - 1);  // into step s - 1's buffer
    cp_async_commit();
    float* hi = smem + s % kStages * stage_floats;
    k7_split_stage(hi, lo, stage_floats);
    __syncthreads();
    const int a_off = tig * g.l.CS, b_off = g.l.in_floats + tig * g.l.NS + wn * kWarpTile + gid;
    const int a_hi = 4 * g.l.CS, b_hi = 4 * g.l.NS;  // channels t + 4
#pragma unroll 1
    for (int kh = 0; kh < KH; ++kh) {
      // a fresh tile per row of taps: the tensor cores' accumulation
      // truncates (see the note at the top)
      float row[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) row[mt][nt][i] = 0.0f;
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const int at = a_off + kh * g.l.RS + kw;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int a = at + voff[mt][i % 2] + (i / 2) * a_hi;
            ah[mt][i] = __float_as_uint(hi[a]);
            al[mt][i] = __float_as_uint(lo[a]);
          }
        const int bt = b_off + (kh * K + kw) * g.l.TS;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t bh0 = __float_as_uint(hi[bt + nt * 8]);
          const uint32_t bh1 = __float_as_uint(hi[bt + nt * 8 + b_hi]);
          const uint32_t bl0 = __float_as_uint(lo[bt + nt * 8]);
          const uint32_t bl1 = __float_as_uint(lo[bt + nt * 8 + b_hi]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(row[mt][nt], al[mt], bh0, bh1);
            mma_tf32(row[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(row[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += row[mt][nt][i];
    }
  }
  cp_async_wait<0>();

  // accumulator (mt, nt) element 2j + i: voxel row gid + 8j, channel 2 tig + i
  float* ob = out + blockIdx.z * g.split_stride + (long long)b * g.Co * DHW;
  const bool add_bias = gridDim.z == 1 && bias != nullptr;
  const long long HW = (long long)g.H * g.W;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = wm * kWarpTile + mt * 16 + gid + 8 * j;
      const int z = m / (g.TH * g.TW), y = (m / g.TW) % g.TH, xx = m % g.TW;
      const int od = d0 + z, oh = h0 + y, ow = w0 + xx;
      if (m >= tile_vox || od >= g.D || oh >= g.H || ow >= g.W) continue;
      float* ov = ob + od * HW + (long long)oh * g.W + ow;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int co = co0 + wn * kWarpTile + nt * 8 + 2 * tig + i;
          if (co < g.Co)
            ov[co * DHW] = acc[mt][nt][2 * j + i] + (add_bias ? __ldg(bias + co) : 0.0f);
        }
    }
}

// out[n] = bias[co] + sum over the splits of partial[s][n], in split order
__global__ void __launch_bounds__(256)
conv3d_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                     long long total, long long DHW, int Co, int n_split,
                     float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= total) return;
  float s = 0.0f;
  for (int k = 0; k < n_split; ++k) s += __ldg(partial + k * total + n);
  if (bias != nullptr) s += __ldg(bias + (int)((n / DHW) % Co));
  out[n] = s;
}

template <int K, int KH, int WN>
int launch_conv3d(const float* x, const float* wt, const float* bias, float* out,
                  float* partial, int B, const K7Geom& g, int n_split, size_t smem,
                  cudaStream_t stream) {
  auto kernel = conv3d_kernel<K, KH, WN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * g.Co * g.D * g.H * g.W;
  if (total == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)(B * g.nd * g.nh * g.nw), (unsigned)((g.Co + 32 * WN - 1) / (32 * WN)),
            (unsigned)n_split);
  kernel<<<grid, kThreads, smem, stream>>>(x, wt, bias, n_split == 1 ? out : partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  conv3d_reduce_kernel<<<r3dp_blocks(total, 256), 256, 0, stream>>>(
      partial, bias, total, (long long)g.D * g.H * g.W, g.Co, n_split, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7b
// ---------------------------------------------------------------------------

constexpr int kTailTW = 32;        // pixel tile columns: a warp's row
constexpr int kTailThreads = 256;  // 8 warps
constexpr int kTailCtasPerSm = 2;  // CTAs an SM holds (registers, shared memory)
constexpr int kTailK1 = 5;         // candidates, K + 1
constexpr int kTailWS = 36;        // a tap's mask weights [kd][k], 35 padded to 9 float4

// One depth instantiation's tile. A thread owns DT output depths of one
// pixel; the NDH depth groups of a pixel are TPG threads (whole warps)
// apart, so a warp's group is uniform.
template <int D>
struct TailShape {
  static constexpr int DT = D == 16 ? 8 : D;      // output depths a thread owns
  static constexpr int NDH = D / DT;              // depth groups
  static constexpr int TPG = kTailThreads / NDH;  // threads (pixels) of a depth group
  static constexpr int TH = TPG / kTailTW;        // tile rows
  static constexpr int HR = TH + 6, RS = kTailTW + 6;  // halo rows, columns
  // a halo pixel's D depths, padded to 4 mod 8 floats: the 8 lanes of an
  // LDS.128 wavefront (8 neighbouring pixels) hit 8 distinct bank quads
  static constexpr int PS = D == 16 ? 20 : 4;
  static constexpr int X_FLOATS = HR * RS * PS;   // [HR][RS][PS]
  static constexpr int WM_FLOATS = 49 * kTailWS;  // [tap][kd * 5 + k]
  static constexpr int WO_FLOATS = 49 * 2 * D;    // [tap][group][head][DT]
  static constexpr int STAGE = X_FLOATS + WM_FLOATS + WO_FLOATS;
  static constexpr int NCH = D * kTailK1 + 2 * NDH;  // a pixel's partial sums
  static_assert(D % DT == 0 && TPG % kTailTW == 0 && DT % 2 == 0 && NDH <= 2, "whole tiles");
};

// Issue the copies of input channel c into a stage buffer: the halo tile,
// transposed to depth-innermost ([row][column][depth]) on the way, the
// channel's mask weights by tap and its occlusion weights by tap; the
// padding rows and columns are zero-filled (src-size 0).
template <int D>
__device__ __forceinline__ void tail_stage(float* buf, const float* __restrict__ xc,
                                           const float* __restrict__ mask_w,
                                           const float* __restrict__ occ_w, int C, int c,
                                           int H, int W, int h0, int w0) {
  using T = TailShape<D>;
  const long long HW = (long long)H * W;
  for (int e = threadIdx.x; e < D * T::HR * T::RS; e += kTailThreads) {
    const int cx = e % T::RS, r = e / T::RS;  // neighbouring threads: neighbouring w
    const int hy = r % T::HR, dd = r / T::HR;
    const int gh = h0 + hy - 3, gw = w0 + cx - 3;
    const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
    cp_async4(buf + (hy * T::RS + cx) * T::PS + dd,
              ok ? xc + dd * HW + (long long)gh * W + gw : xc, ok);
  }
  float* wm = buf + T::X_FLOATS;
  for (int e = threadIdx.x; e < 49 * 7 * kTailK1; e += kTailThreads) {
    const int tap = e / (7 * kTailK1), r = e - tap * (7 * kTailK1);
    const int kd = r / kTailK1, k = r - kd * kTailK1;
    cp_async4(wm + tap * kTailWS + r, mask_w + (((long long)k * C + c) * 7 + kd) * 49 + tap,
              true);
  }
  float* wo = wm + T::WM_FLOATS;
  for (int e = threadIdx.x; e < 49 * 2 * D; e += kTailThreads) {
    const int tap = e / (2 * D), r = e - tap * (2 * D);
    const int g = r / (2 * T::DT), j = r / T::DT % 2, dl = r % T::DT;
    cp_async4(wo + e, occ_w + (((long long)j * C + c) * D + g * T::DT + dl) * 49 + tap, true);
  }
}

// element i of a float4 array, i known at compile time once unrolled (no
// address is taken: the array stays in registers)
template <int N>
__device__ __forceinline__ float f4(const float4 (&v)[N], int i) {
  const float4& q = v[i / 4];
  return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
}

// The 49 taps of one staged channel for a thread of depth group D0 / DT:
// per tap, its pixel's input depths (LDS.128), the tap's 35 mask weights
// (9 broadcast LDS.128) and its group's occlusion weights, then 16
// occlusion FFMAs (two chains a head, even and odd depths, so that no
// chain of 8 dependent FFMAs ends the tap) and 250 (D = 16) mask FFMAs.
template <int D, int D0>
__device__ __forceinline__ void tail_taps(const float* buf, int p_off,
                                          float (&acc)[TailShape<D>::DT][kTailK1],
                                          float (&occ)[2][2]) {
  using T = TailShape<D>;
  constexpr int DT = T::DT;
  constexpr int LO = (D0 - 3 > 0 ? D0 - 3 : 0) / 4 * 4;             // first depth loaded
  constexpr int HI = ((D0 + DT + 3 < D ? D0 + DT + 3 : D) + 3) / 4 * 4;  // past the last
  constexpr int NX = (HI - LO) / 4;
  static_assert(HI <= T::PS, "loads stay in a pixel's depths");
  const float* xs = buf + p_off + LO;
  const float* wm = buf + T::X_FLOATS;
  const float* wo = wm + T::WM_FLOATS + D0 / DT * 2 * DT;
#pragma unroll 1
  for (int kh = 0; kh < 7; ++kh) {
#pragma unroll 1
    for (int kw = 0; kw < 7; ++kw) {
      const int tap = kh * 7 + kw;
      float4 xv[NX], wv[kTailWS / 4], ov[DT / 2];
      const float4* xp = reinterpret_cast<const float4*>(xs + (kh * T::RS + kw) * T::PS);
#pragma unroll
      for (int i = 0; i < NX; ++i) xv[i] = xp[i];
      const float4* wp = reinterpret_cast<const float4*>(wm + tap * kTailWS);
#pragma unroll
      for (int i = 0; i < kTailWS / 4; ++i) wv[i] = wp[i];
      const float4* op = reinterpret_cast<const float4*>(wo + tap * 2 * D);
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) ov[i] = op[i];
#pragma unroll
      for (int dl = 0; dl < DT; ++dl) {
        occ[dl % 2][0] = fmaf(f4(xv, D0 + dl - LO), f4(ov, dl), occ[dl % 2][0]);
        occ[dl % 2][1] = fmaf(f4(xv, D0 + dl - LO), f4(ov, DT + dl), occ[dl % 2][1]);
      }
#pragma unroll
      for (int kd = 0; kd < 7; ++kd)
#pragma unroll
        for (int k = 0; k < kTailK1; ++k) {
          const float wk = f4(wv, kd * kTailK1 + k);
#pragma unroll
          for (int dl = 0; dl < DT; ++dl) {
            const int dd = D0 + dl + kd - 3;  // zero depth padding: taps outside add nothing
            if (dd >= 0 && dd < D) acc[dl][k] = fmaf(f4(xv, dd - LO), wk, acc[dl][k]);
          }
        }
    }
  }
}

// One CTA: a pixel tile (TH x 32) at every depth and the input channels
// [split c_per_split, ...); it writes the split's partial sums,
// partial[split][b][NCH][H][W].
template <int D>
__global__ void __launch_bounds__(kTailThreads, kTailCtasPerSm)
mfe_tail_kernel(const float* __restrict__ x, const float* __restrict__ mask_w,
                const float* __restrict__ occ_w, int C, int H, int W, int nh, int nw,
                int c_per_split, float* __restrict__ partial) {
  using T = TailShape<D>;
  constexpr int DT = T::DT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  int t = blockIdx.x;
  const int tw_i = t % nw;
  t /= nw;
  const int th_i = t % nh;
  const int b = t / nh;
  const int B = gridDim.x / (nh * nw);
  const int h0 = th_i * T::TH, w0 = tw_i * kTailTW;
  const int c_begin = blockIdx.y * c_per_split;
  const int n_c = min(C, c_begin + c_per_split) - c_begin;
  const int group = threadIdx.x / T::TPG;  // warp-uniform
  const int p = threadIdx.x % T::TPG;      // the thread's pixel in the tile
  const int p_off = (p / kTailTW * T::RS + p % kTailTW) * T::PS;
  const long long HW = (long long)H * W;

  float acc[DT][kTailK1], occ[2][2] = {};
#pragma unroll
  for (int dl = 0; dl < DT; ++dl)
#pragma unroll
    for (int k = 0; k < kTailK1; ++k) acc[dl][k] = 0.0f;

  // a two-stage cp.async ring over the split's channels: channel i + 1
  // lands while channel i computes
  const float* xb = x + ((long long)b * C + c_begin) * D * HW;
  if (n_c > 0) tail_stage<D>(smem, xb, mask_w, occ_w, C, c_begin, H, W, h0, w0);
  cp_async_commit();
  for (int i = 0; i < n_c; ++i) {
    if (i + 1 < n_c)
      tail_stage<D>(smem + (i + 1) % 2 * T::STAGE, xb + (i + 1) * D * HW, mask_w, occ_w, C,
                    c_begin + i + 1, H, W, h0, w0);
    cp_async_commit();
    cp_async_wait<1>();  // channel i has landed
    __syncthreads();
    const float* buf = smem + i % 2 * T::STAGE;
    if constexpr (T::NDH == 1) {
      tail_taps<D, 0>(buf, p_off, acc, occ);
    } else {
      if (group == 0)
        tail_taps<D, 0>(buf, p_off, acc, occ);
      else
        tail_taps<D, DT>(buf, p_off, acc, occ);
    }
    __syncthreads();  // before channel i + 2 lands in this buffer
  }
  cp_async_wait<0>();

  const int h = h0 + p / kTailTW, w = w0 + p % kTailTW;
  if (h >= H || w >= W) return;
  // neighbouring threads store neighbouring w
  float* o = partial + ((long long)blockIdx.y * B + b) * T::NCH * HW + (long long)h * W + w;
#pragma unroll
  for (int dl = 0; dl < DT; ++dl)
#pragma unroll
    for (int k = 0; k < kTailK1; ++k) o[((group * DT + dl) * kTailK1 + k) * HW] = acc[dl][k];
  o[(D * kTailK1 + 2 * group) * HW] = occ[0][0] + occ[1][0];
  o[(D * kTailK1 + 2 * group + 1) * HW] = occ[0][1] + occ[1][1];
}

// one thread per voxel: the splits' sums in split order (no atomics: two
// launches are bit-equal) + biases, softmax over the K+1 candidates,
// deformation = sum_k mask_k * motion_k (motion_0 the identity grid,
// motion_k = grid - kp_d[k-1] + kp_s[k-1]); the d = 0 threads also write
// both occlusion maps, adding the depth groups' sums. Where mask_out is not
// null the softmax is also written there, [B,K+1,D,H,W], for the backward
// (mfe_tail_backward's softmax adjoint: 5 floats a voxel, where recomputing
// the logits would take a second 7^3 conv)
template <int D>
__global__ void __launch_bounds__(256)
mfe_tail_epilogue_kernel(const float* __restrict__ partial, const float* __restrict__ mask_b,
                         const float* __restrict__ occ_b, const float* __restrict__ kp_s,
                         const float* __restrict__ kp_d, int B, int H, int W, int n_split,
                         float* __restrict__ deformation, float* __restrict__ occ1,
                         float* __restrict__ occ2, float* __restrict__ mask_out) {
  using T = TailShape<D>;
  const long long HW = (long long)H * W;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * D * HW) return;
  const int b = (int)(n / (D * HW));
  const long long r = n - (long long)b * D * HW;
  const int d = (int)(r / HW);
  const long long hw = r - (long long)d * HW;
  const int h = (int)(hw / W), w = (int)(hw - (long long)h * W);
  const long long split_stride = (long long)B * T::NCH * HW;
  const float* pb = partial + (long long)b * T::NCH * HW + hw;

  float logit[kTailK1] = {};
  const float* pq = pb + d * kTailK1 * HW;
  for (int q = 0; q < n_split; ++q, pq += split_stride)
#pragma unroll
    for (int k = 0; k < kTailK1; ++k) logit[k] += __ldg(pq + k * HW);
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kTailK1; ++k) {
    logit[k] += __ldg(mask_b + k);
    m = fmaxf(m, logit[k]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kTailK1; ++k) {
    logit[k] = expf(logit[k] - m);
    sum += logit[k];
  }
  const float gx = 2.0f * ((float)w / (float)(W - 1)) - 1.0f;
  const float gy = 2.0f * ((float)h / (float)(H - 1)) - 1.0f;
  const float gz = 2.0f * ((float)d / (float)(D - 1)) - 1.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
#pragma unroll
  for (int k = 0; k < kTailK1; ++k) {
    const float mk = logit[k] / sum;
    if (mask_out != nullptr) mask_out[((long long)(b * kTailK1 + k) * D + d) * HW + hw] = mk;
    float sx = gx, sy = gy, sz = gz;
    if (k > 0) {
      const float* pd = kp_d + ((long long)b * (kTailK1 - 1) + (k - 1)) * 3;
      const float* ps = kp_s + ((long long)b * (kTailK1 - 1) + (k - 1)) * 3;
      sx = (gx - pd[0]) + ps[0];
      sy = (gy - pd[1]) + ps[1];
      sz = (gz - pd[2]) + ps[2];
    }
    ox += sx * mk;
    oy += sy * mk;
    oz += sz * mk;
  }
  float* o = deformation + n * 3;
  o[0] = ox;
  o[1] = oy;
  o[2] = oz;
  if (d == 0) {
    float s0 = 0.0f, s1 = 0.0f;
    const float* po = pb + D * kTailK1 * HW;  // [group][head] planes
    for (int q = 0; q < n_split; ++q, po += split_stride) {
      s0 += __ldg(po);
      s1 += __ldg(po + HW);
      if constexpr (T::NDH == 2) {
        s0 += __ldg(po + 2 * HW);
        s1 += __ldg(po + 3 * HW);
      }
    }
    occ1[(long long)b * HW + hw] = r3dp_sigmoid(s0 + __ldg(occ_b));
    occ2[(long long)b * HW + hw] = r3dp_sigmoid(s1 + __ldg(occ_b + 1));
  }
}

template <int D>
int launch_mfe_tail(const float* x, const float* mask_w, const float* mask_b,
                    const float* occ_w, const float* occ_b, const float* kp_s,
                    const float* kp_d, int B, int C, int H, int W, int c_per_split,
                    int n_split, float* partial, float* deformation, float* occ1,
                    float* occ2, float* mask_out, cudaStream_t stream) {
  using T = TailShape<D>;
  const int nh = (H + T::TH - 1) / T::TH, nw = (W + kTailTW - 1) / kTailTW;
  if ((long long)c_per_split * (n_split - 1) >= C || (long long)c_per_split * n_split < C ||
      n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * T::STAGE;
  auto kernel = mfe_tail_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long voxels = (long long)B * D * H * W;
  if (voxels == 0) return (int)cudaGetLastError();
  kernel<<<dim3((unsigned)(B * nh * nw), (unsigned)n_split), kTailThreads, smem, stream>>>(
      x, mask_w, occ_w, C, H, W, nh, nw, c_per_split, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mfe_tail_epilogue_kernel<D><<<r3dp_blocks(voxels, 256), 256, 0, stream>>>(
      partial, mask_b, occ_b, kp_s, kp_d, B, H, W, n_split, deformation, occ1, occ2, mask_out);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K7a backward, the weight gradient (conv3d_weight_grad in ops/conv3d.py;
// the JAX package had jax.grad differentiate conv3d_via_2d): for each tap
// (kd, kh, kw) and each (co, ci),
//   dW[co][ci][kd][kh][kw] = sum over b and the voxels v of
//     dy[b][co][v] * x[b][ci][v + (kd, kh, kw) - k/2]   (zero outside),
// and db[co] = sum dy[b][co][v] over every voxel. The data gradient is K7a
// itself (ops/conv3d.py: the same conv on dy with the taps flipped and the
// channels swapped).
//
// What bounds it on an H100: operations, 2 Co Ci per voxel and tap inside
// the volume (the torso fuser's [4,89,16,64,64] -> 32 at k = 7: 0.43
// TFLOP); on the tensor cores in split TF32, 3 x ops / 495 TFLOP/s (the
// fuser 2.62 ms); on FFMA, ops / 67 TFLOP/s (6.46 ms).
//
// The design this replaces was a GEMM a tap on FFMA: a CTA of 64
// threads took one tap and a share of its voxels and read x and dy anew for
// every tap, two shared loads a product pair. The fuser took 44.6 ms a
// launch against cuDNN's 16.8 (torch.nn.grad.conv3d_weight), the torso
// step's 24 launches 101.1 ms against 76.6, K7b's mask conv 7.57 ms
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: an implicit GEMM on the tensor cores, mma.sync m16n8k8 in split
// TF32 (common.cuh), the voxels its reduction axis, the input channels on M
// (32 a CTA, two m16 tiles) and the output channels on N (32, four n8
// tiles; 8 where Co <= 8, so that K7b's mask conv pads 5 to 8, not to a
// 16-row tile). A CTA owns one row of taps (kd, kh) and all K of its kw
// taps: warp w computes tap kw = w % K. Its voxels are the rows (b, d, h)
// whose shifted row (d + kd - K/2, h + kh - K/2) lies inside the volume (no
// row of padding is computed), cut into segments of SW columns ("units");
// the CTA takes a share of them (blockIdx.x of n_split) and stages R units
// at a time ("a brick") with cp.async into a two-stage ring, so that the
// next brick lands while this one multiplies: dy [BN][DS] (voxel e = unit
// * SW + column) and the x rows [32][CS] with K/2 halo columns on each side
// (zero outside the volume), read from device memory once for all K taps.
// Tap kw reads the x rows shifted by kw through a per-voxel offset table
// (the same for every brick); voxels past the brick read zeros. The
// operands are split as they are loaded: hi = tf32(v) (cvt.rna's rounding,
// on the bits), lo = v - hi, whose low 13 bits the tensor cores ignore.
// At k = 3 two groups of K warps take alternate k-steps of a brick and
// add their sums through shared memory at the end. A brick's products sum
// into a fresh tile that the running sum takes by a rounded fp32 add (the
// tensor cores' accumulation truncates; see K7a's note above). The CTA's
// sums leave by one atomicAdd an entry into the zeroed gradient, or by a
// plain store where n_split = 1 (one CTA then owns each entry); the centre
// tap's warps of the first input-channel tile also sum dy for db. So x is
// read once per row of taps and output-channel tile, dy once per row of
// taps and input-channel tile, where the design before read both per tap.
constexpr int kWgM = 32;           // input channels of a CTA: two m16 tiles
constexpr int kWgMaxUnits = 128;   // units a brick at most
constexpr int kWgStages = 2;       // depth of the cp.async ring
constexpr int kWgSlots = kWgStages + 1;  // unit descriptors: one slot ahead of the ring

// Everything of one weight-gradient call but its pointers, by value.
struct WgGeom {
  int Ci, Co, D, H, W;
  int SW, nseg, R;      // columns a unit, units a row, units a brick
  int OFF, RS, CS, DS;  // x row offset and stride, x and dy channel strides
  int NK;               // k-steps (8 voxels) a brick
  int n_ci, vec;        // input-channel tiles; 16 B copies
  long long B;
  K7Div by_xp, by_yp, by_units;  // copies a unit's x row, a unit's dy row; R
};

// The shared-memory layout (floats), as ops/conv3d.py
// conv3d_weight_grad_layout computes it: the x rows of a unit start OFF
// floats in (so that the interior lands 16 B aligned), stride RS; a
// channel's R rows are followed by 8 zero floats, which the voxels past
// the brick read; the channel strides CS and DS are 4 mod 8, so that a
// warp's fragment loads (8 channels x 4 consecutive voxels) hit 32 banks.
static void wg_layout(WgGeom& g, int K, int BN, int VP, size_t* smem) {
  const int P = K / 2;
  g.OFF = k7_halo_off(K);
  g.RS = (g.OFF + g.SW + 2 * P + 3) & ~3;
  g.NK = (g.R * g.SW + 7) / 8;
  const int cs = g.R * g.RS + 8, ds = 8 * g.NK;
  g.CS = cs + (12 - cs % 8) % 8;
  g.DS = ds + 4;
  const size_t stage = (size_t)kWgM * g.CS + (size_t)BN * g.DS;
  const size_t reduce = (size_t)(VP - 1) * K * BN * 32;  // the groups' sums at the end
  const size_t ring = kWgStages * stage;
  *smem = sizeof(float) * (ring > reduce ? ring : reduce) + sizeof(int) * 8 * g.NK +
          (size_t)kWgSlots * g.R * (2 * sizeof(long long) + sizeof(int));
}

// hi = the TF32 rounding of v (to nearest, ties away from zero: cvt.rna's),
// lo = v - hi in fp32; the tensor cores read lo's top 19 bits
__device__ __forceinline__ void wg_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

template <int K, int BN, int VP>
__global__ void __launch_bounds__(32 * K * VP)
conv3d_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy, const WgGeom g,
                    float* __restrict__ dw, float* __restrict__ db) {
  constexpr int P = K / 2, NT = BN / 8, THREADS = 32 * K * VP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = kWgM * g.CS + BN * g.DS;
  const int area = max(kWgStages * stage_floats, (VP - 1) * K * BN * 32);
  int* xoff = reinterpret_cast<int*>(smem + area);
  long long* xrow = reinterpret_cast<long long*>(xoff + 8 * g.NK);  // [slots][R]: descriptors
  long long* yrow = xrow + kWgSlots * g.R;
  int* col0 = reinterpret_cast<int*>(yrow + kWgSlots * g.R);

  const int kd = blockIdx.y / K, kh = blockIdx.y % K;
  const int ci0 = (blockIdx.z % g.n_ci) * kWgM, co0 = (blockIdx.z / g.n_ci) * BN;
  const int d_lo = max(0, P - kd), Dv = min(g.D, g.D + P - kd) - d_lo;
  const int h_lo = max(0, P - kh), Hv = min(g.H, g.H + P - kh) - h_lo;
  if (Dv <= 0 || Hv <= 0) return;  // a row of taps past the volume (k = 7 over 2 depths)
  const long long units = g.B * Dv * Hv * g.nseg;
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  const int n_bricks = (int)((u_end - u_begin + g.R - 1) / g.R);
  const int tid = threadIdx.x;
  const long long HW = (long long)g.H * g.W, DHW = g.D * HW;

  // the zeros the copies never write: each channel's tail of the x rows and
  // the dy columns past the brick's voxels, in every stage; the offsets of
  // voxel e's x row at tap 0
  for (int s = 0; s < kWgStages; ++s) {
    float* st = smem + s * stage_floats;
    for (int e = tid; e < kWgM * 8; e += THREADS) st[(e / 8) * g.CS + g.R * g.RS + e % 8] = 0.0f;
    const int pad = g.DS - g.R * g.SW;
    for (int e = tid; e < BN * pad; e += THREADS)
      st[kWgM * g.CS + (e / pad) * g.DS + g.R * g.SW + e % pad] = 0.0f;
  }
  for (int e = tid; e < 8 * g.NK; e += THREADS) {
    const int i = e / g.SW;
    xoff[e] = e < g.R * g.SW ? i * g.RS + g.OFF + e - i * g.SW : g.R * g.RS;
  }
  // brick n's units into descriptor slot n % kWgSlots: the offsets of their x row
  // (input channel ci0) and dy row (output channel co0), and their first
  // column (past the row for a unit past the share: every copy zero-fills)
  auto describe = [&](int n) {
    const int slot = (n % kWgSlots) * g.R;
    for (int i = tid; i < g.R; i += THREADS) {
      const long long u = u_begin + (long long)n * g.R + i;
      long long xr = 0, yr = 0;
      int c0 = 1 << 30;
      if (u < u_end) {
        long long r = u / g.nseg;
        const int sg = (int)(u - r * g.nseg);
        const int h = h_lo + (int)(r % Hv);
        r /= Hv;
        const int d = d_lo + (int)(r % Dv);
        const long long b = r / Dv;
        xr = (b * g.Ci + ci0) * DHW + (d + kd - P) * HW + (long long)(h + kh - P) * g.W;
        yr = (b * g.Co + co0) * DHW + d * HW + (long long)h * g.W;
        c0 = sg * g.SW;
      }
      xrow[slot + i] = xr;
      yrow[slot + i] = yr;
      col0[slot + i] = c0;
    }
  };
  // issue brick n's copies into stage n % kWgStages: x [32][CS] (interior 16 B
  // pieces where vec, the halo and every column otherwise 4 B), dy [BN][DS]
  auto stage = [&](int n) {
    float* xs = smem + (n % kWgStages) * stage_floats;
    float* ys = xs + kWgM * g.CS;
    const int slot = (n % kWgSlots) * g.R;
    const int xp = g.vec ? g.SW / 4 + 2 * P : g.SW + 2 * P;
    const int yp = g.vec ? g.SW / 4 : g.SW;
    const int nx = kWgM * g.R * xp, total = nx + BN * g.R * yp;
    for (int e = tid; e < total; e += THREADS) {
      if (e < nx) {
        const int r = k7_quot(e, g.by_xp), q = e - r * xp;
        const int c = k7_quot(r, g.by_units), i = r - c * g.R;
        const int c0 = col0[slot + i];
        const bool row_ok = ci0 + c < g.Ci;
        const float* src = x + xrow[slot + i] + c * DHW;
        float* dst = xs + c * g.CS + i * g.RS + g.OFF;
        if (g.vec && q < g.SW / 4) {
          const int gc = c0 + 4 * q;
          const bool ok = row_ok && gc < g.W;
          cp_async16(dst + P + 4 * q, ok ? src + gc : x, ok);
        } else {
          const int q2 = g.vec ? q - g.SW / 4 : q;
          const int sc = g.vec && q2 >= P ? g.SW + q2 : q2;  // the tile row's column
          const int gc = c0 - P + sc;
          const bool ok = row_ok && gc >= 0 && gc < g.W;
          cp_async4(dst + sc, ok ? src + gc : x, ok);
        }
      } else {
        const int e2 = e - nx;
        const int r = k7_quot(e2, g.by_yp), q = e2 - r * yp;
        const int c = k7_quot(r, g.by_units), i = r - c * g.R;
        const int gc = col0[slot + i] + (g.vec ? 4 * q : q);
        const bool ok = co0 + c < g.Co && gc < g.W;
        const float* src = dy + yrow[slot + i] + c * DHW + gc;
        float* dst = ys + c * g.DS + i * g.SW + (g.vec ? 4 * q : q);
        if (g.vec)
          cp_async16(dst, ok ? src : dy, ok);
        else
          cp_async4(dst, ok ? src : dy, ok);
      }
    }
  };

  const int lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kw = warp % K, grp = warp / K;
  const bool do_bias = db != nullptr && kd == P && kh == P && kw == P && ci0 == 0;
  float acc[2][NT][4], bsum[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bsum[nt] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][nt][i] = acc[1][nt][i] = 0.0f;
  }
  for (int n = 0; n < kWgStages && n < n_bricks; ++n) describe(n);
  __syncthreads();  // zeros, offsets and the first descriptors are written
  for (int n = 0; n < kWgStages - 1; ++n) {
    if (n < n_bricks) stage(n);
    cp_async_commit();
  }
  for (int n = 0; n < n_bricks; ++n) {
    cp_async_wait<kWgStages - 2>();
    // brick n has landed; brick n - 1 is computed (its stage and descriptor
    // slot are free); the descriptors written last round are seen
    __syncthreads();
    if (n + kWgStages - 1 < n_bricks) stage(n + kWgStages - 1);
    cp_async_commit();
    if (n + kWgStages < n_bricks) describe(n + kWgStages);
    const float* xs = smem + (n % kWgStages) * stage_floats;
    const float* ys = xs + kWgM * g.CS;
    float part[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
#pragma unroll 1
    for (int s = grp; s < g.NK; s += VP) {
      // k = t and t + 4 of this step are voxels 8s + t and 8s + t + 4
      const int e0 = 8 * s + tig;
      const int o0 = xoff[e0] + kw, o1 = xoff[e0 + 4] + kw;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* yb = ys + (8 * nt + gid) * g.DS + e0;
        const float v0 = yb[0], v1 = yb[4];
        if (do_bias) bsum[nt] += v0 + v1;
        wg_split(v0, bh[nt][0], bl[nt][0]);
        wg_split(v1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* xa = xs + (16 * mt + gid) * g.CS;
        const float a[4] = {xa[o0], xa[8 * g.CS + o0], xa[o1], xa[8 * g.CS + o1]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wg_split(a[i], ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt][0], bh[nt][1]);
          mma_tf32(part[mt][nt], ah, bl[nt][0], bl[nt][1]);
          mma_tf32(part[mt][nt], ah, bh[nt][0], bh[nt][1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  cp_async_wait<0>();
  if (VP > 1) {  // the groups' sums into group 0's, through the stages' memory
    constexpr int PER = 2 * NT * 4;
    __syncthreads();
    float* red = smem + kw * PER * 32 + lane;
    if (grp > 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        red[((grp - 1) * K * PER + j) * 32] = acc[j / (NT * 4)][j / 4 % NT][j % 4];
    }
    __syncthreads();
    if (grp == 0) {
      for (int gp = 1; gp < VP; ++gp)
#pragma unroll
        for (int j = 0; j < PER; ++j)
          acc[j / (NT * 4)][j / 4 % NT][j % 4] += red[((gp - 1) * K * PER + j) * 32];
    }
  }
  if (do_bias) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v = bsum[nt];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0 && co0 + 8 * nt + gid < g.Co) atomicAdd(db + co0 + 8 * nt + gid, v);
    }
  }
  if (grp != 0) return;
  // accumulator (mt, nt) element i: input channel 16 mt + gid + 8 (i / 2),
  // output channel 8 nt + 2 tig + i % 2
  const int tap = (kd * K + kh) * K + kw;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = ci0 + 16 * mt + gid + 8 * (i / 2), co = co0 + 8 * nt + 2 * tig + i % 2;
        if (ci >= g.Ci || co >= g.Co) continue;
        float* p = dw + ((long long)co * g.Ci + ci) * (K * K * K) + tap;
        if (gridDim.x == 1)
          *p = acc[mt][nt][i];
        else
          atomicAdd(p, acc[mt][nt][i]);
      }
}

template <int K, int BN, int VP>
int launch_wgrad(const float* x, const float* dy, WgGeom g, int n_split, int n_co, float* dw,
                 float* db, cudaStream_t stream) {
  size_t smem = 0;
  wg_layout(g, K, BN, VP, &smem);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  g.by_xp = k7_div(g.vec ? g.SW / 4 + 2 * (K / 2) : g.SW + 2 * (K / 2));
  g.by_yp = k7_div(g.vec ? g.SW / 4 : g.SW);
  g.by_units = k7_div(g.R);
  auto kernel = conv3d_wgrad_kernel<K, BN, VP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)n_split, K * K, (unsigned)(g.n_ci * n_co)), 32 * K * VP, smem,
           stream>>>(x, dy, g, dw, db);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7b backward (mfe_tail_backward in models/torso.py; the JAX package had
// jax.grad differentiate the tail, models/torso.py:429-482). Four launches,
// one of them PR 18's weight-gradient kernel (conv3d_wgrad_kernel above,
// the mask conv's weights, launched by the wrapper):
// - mfe_tail_adjoint_kernel, one thread a voxel: the softmax adjoint of
//   the K+1 logits against the sparse motions, dl_k = m_k (g_k - sum_j m_j
//   g_j) with g_k = d deformation . motion_k (m the forward's softmax, kept
//   by its epilogue), into [B,K+1,D,H,W]; the d = 0 threads also take both
//   occlusion heads' sigmoid adjoints, dp = d occ * occ (1 - occ), into
//   [B,2,H,W]. The grid's last blocks pack both convolutions' weights for
//   the data gradient's B fragments (tail_pack_weight).
// - tail_dgrad_kernel: the tail's whole data gradient,
//     dx[b][c][v] = sum_k sum_tap w[k][c][tap] dl[k][v - tap + 3]
//                 + sum_head sum_tap occ_w[head][c*D + d][tap] dp[head][y, x - tap + 3]
//   (the heads on the C-major depth fold: element [b][c][d] of dx is fold
//   channel c*D + d), written once.
// - occ_wgrad_kernel: the heads' weight gradient, dW[head][cd][ty][tx] =
//   sum over b and the pixels of dp[head] x the fold channel cd shifted by
//   the tap, and the biases' sums.
//
// What bounds them on an H100: operations. The data gradient is 2 x 5 x 32
// x 343 products a voxel (15 GFLOP at the standard preset's
// [4,32,16,64,64], the taps inside the volume), 0.17 ms at split TF32 (3
// x ops / 495 TFLOP/s); the heads' 2 x 2 x 49 a fold element twice more
// (0.2 GFLOP each, ~0.01 ms); the bytes (x read once, dx written once,
// 2 x 33.5 MB) 0.02 ms. The design before this (PR 16) ran the mask
// conv's data gradient as a generic K7a launch, which steps over the input
// channels in chunks of 8, so 3 of every 8 products were on the padding of
// Ci = 5 (1.03 ms), sent dl through device memory to it, read and wrote dx
// again for the heads' data gradient (0.10 ms), and gave each fold channel
// one CTA walking every pixel for the heads' weight gradient, its lanes on
// different taps hitting the same banks (0.73 ms; NVIDIA H100 80GB HBM3,
// 700 W).
//
// Design of tail_dgrad_kernel: an implicit GEMM on the tensor cores in
// split TF32 (mma.sync m16n8k8, common.cuh), the voxels on M, the 32
// channels of a channel block on N, the (k, tap) pairs the reduction. A
// CTA owns 4 rows x 64 columns of one (b, d) plane (8 warps, a warp 32
// voxels of a row x 32 channels: two m16 by four n8 tiles). It steps over
// the depth taps whose plane lies inside the volume (no plane of padding
// is computed) and stages that plane of dl's 5 channels with its 3-pixel
// halo by cp.async into a two-stage ring, so that the next plane lands
// while this one multiplies. A plane's 5 x 49 (k, tap) pairs are packed
// into 31 k-steps of 8 (k-major, taps fastest; 3 zero slots), where a
// generic conv pads Ci = 5 to 8 for every tap; a per-lane offset table
// (one int2 a k-step and lane) addresses them in the staged tile (a padding
// slot, weight 0, reads the word of the last pair). Row and channel strides
// are 16 mod 32, so a fragment load of 8 voxels x 4 slots hits 32 banks.
// One more step stages dp's 2 channels of the pixel tile and runs the
// heads' 2 x 49 taps as 13 k-steps of the same accumulators, with that
// depth's fold-channel weights: the heads' data gradient is added before
// the single store of dx. The B fragments come from device
// memory packed in fragment order, split into TF32 hi and lo parts (16 B a
// lane a k-step and n8 tile, read through L1 by the CTA's 8 warps), the
// next k-step's loaded while this one multiplies. Each step's products sum
// into a fresh tile that the running sum takes by a rounded fp32 add (the
// tensor cores' accumulation truncates; K7a's note).
//
// Design of occ_wgrad_kernel (FFMA; through K7a's weight-gradient kernel
// on the fold as a depth-1 volume it took 0.51 ms, most of it idle tiles of
// N = 2): a CTA owns 32 fold channels (a lane each) and a share of the
// pixel units (4 rows x 64 columns of one b); warp w owns tap row ty = w,
// 14 sums (2 heads x 7 tx). A unit stages the 32 channels' 10 halo rows
// (channel stride odd: the lanes' loads hit 32 banks) and dp's 4 rows
// (read by all lanes at once: a broadcast) by cp.async; a thread slides
// along its row 8 pixels at a time, 14 x values and 16 dp values for 112
// FFMAs. The CTAs' sums are added into the zeroed gradient by atomicAdd.
constexpr int kTgTH = 4, kTgTW = 64;      // tail_dgrad_kernel: a CTA's rows, columns
constexpr int kTgRS = 80;                 // halo row stride (70 used), 16 mod 32
constexpr int kTgCS = 816;                // halo channel stride (800 used), 16 mod 32
constexpr int kTgStage = kTailK1 * kTgCS;
constexpr int kTgMaskKS = 31;             // k-steps of a depth tap: 5 x 49 pairs in 248 slots
constexpr int kTgOccKS = 13;              // k-steps of the heads: 2 x 49 in 104 slots
constexpr int kTgN = 32;                  // channels of a channel block
constexpr int kOwCd = 32, kOwRows = 4, kOwTW = 64;  // occ_wgrad_kernel's unit
constexpr int kOwRS = kOwTW + 6;
constexpr int kOwCS = (kOwRows + 6) * kOwRS + 1;    // odd
constexpr int kOwThreads = 7 * 32;
constexpr size_t kOwSmem = sizeof(float) * ((size_t)kOwCd * kOwCS + 2 * kOwRows * kOwTW);
constexpr int kOccMaxW = 256;

// float4s of packed weights a channel block: 7 depth taps of the mask conv,
// then D depths of the heads
__host__ __device__ constexpr long long tail_pack_size(int D) {
  return (7LL * kTgMaskKS + (long long)D * kTgOccKS) * 4 * 32;
}

// One packed B fragment entry e of channel block cb: lane (g, t) of n8 tile
// nt at k-step ks holds slots 8 ks + t and 8 ks + t + 4 of output channel c =
// 32 cb + 8 nt + g, as (hi, hi, lo, lo). The mask conv's slot s of depth tap
// j (plane d + j - 3) is pair (k = s / 49, tap = s % 49) with the taps
// flipped: w[k][c][6 - j][6 - ty][6 - tx]; the heads' slot s of depth d is
// (head = s / 49, tap): occ_w[head][c*D + d][6 - ty][6 - tx].
__device__ void tail_pack_weight(const float* __restrict__ mask_w,
                                 const float* __restrict__ occ_w, int C, int D, long long e,
                                 float4* __restrict__ packed) {
  const long long per_cb = tail_pack_size(D);
  const int cb = (int)(e / per_cb);
  const long long r = e - cb * per_cb;
  const int lane = (int)(r % 32), nt = (int)(r / 32 % 4);
  const int c = cb * kTgN + 8 * nt + lane / 4, t = lane % 4;
  const long long step = r / 128;  // (j, ks) of the mask conv, then (d, ks) of the heads
  float v[2];
  for (int h = 0; h < 2; ++h) {
    v[h] = 0.0f;
    if (step < 7 * kTgMaskKS) {
      const int j = (int)(step / kTgMaskKS), s = (int)(step % kTgMaskKS) * 8 + t + 4 * h;
      if (c < C && s < kTailK1 * 49) {
        const int k = s / 49, tap = s % 49;
        v[h] = __ldg(mask_w + (((long long)k * C + c) * 7 + 6 - j) * 49 + 48 - tap);
      }
    } else {
      const long long q = step - 7 * kTgMaskKS;
      const int d = (int)(q / kTgOccKS), s = (int)(q % kTgOccKS) * 8 + t + 4 * h;
      if (c < C && s < 2 * 49)
        v[h] = __ldg(occ_w + ((long long)(s / 49) * C * D + (long long)c * D + d) * 49 + 48 -
                     s % 49);
    }
  }
  const uint32_t h0 = tf32_rna(v[0]), h1 = tf32_rna(v[1]);
  const uint32_t l0 = tf32_rna(v[0] - __uint_as_float(h0)),
                 l1 = tf32_rna(v[1] - __uint_as_float(h1));
  packed[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                          __uint_as_float(l1));
}

// blocks [0, n_adj): a voxel a thread; the rest: a packed weight entry a thread
__global__ void __launch_bounds__(256)
mfe_tail_adjoint_kernel(const float* __restrict__ ddef, const float* __restrict__ docc1,
                        const float* __restrict__ docc2, const float* __restrict__ mask,
                        const float* __restrict__ occ1, const float* __restrict__ occ2,
                        const float* __restrict__ kp_s, const float* __restrict__ kp_d,
                        const float* __restrict__ mask_w, const float* __restrict__ occ_w,
                        int B, int C, int D, int H, int W, unsigned n_adj, long long n_pack,
                        float* __restrict__ dlogits, float* __restrict__ dpre,
                        float4* __restrict__ packed) {
  if (blockIdx.x >= n_adj) {
    const long long e = (long long)(blockIdx.x - n_adj) * blockDim.x + threadIdx.x;
    if (e < n_pack) tail_pack_weight(mask_w, occ_w, C, D, e, packed);
    return;
  }
  const long long HW = (long long)H * W;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * D * HW) return;
  const int b = (int)(n / (D * HW));
  const long long r = n - (long long)b * D * HW;
  const int d = (int)(r / HW);
  const long long hw = r - (long long)d * HW;
  const int h = (int)(hw / W), w = (int)(hw - (long long)h * W);
  const float gx = 2.0f * ((float)w / (float)(W - 1)) - 1.0f;
  const float gy = 2.0f * ((float)h / (float)(H - 1)) - 1.0f;
  const float gz = 2.0f * ((float)d / (float)(D - 1)) - 1.0f;
  const float dx = ddef[n * 3], dyv = ddef[n * 3 + 1], dz = ddef[n * 3 + 2];
  float m[kTailK1], g[kTailK1], s = 0.0f;
#pragma unroll
  for (int k = 0; k < kTailK1; ++k) {
    float sx = gx, sy = gy, sz = gz;
    if (k > 0) {
      const float* pd = kp_d + ((long long)b * (kTailK1 - 1) + (k - 1)) * 3;
      const float* ps = kp_s + ((long long)b * (kTailK1 - 1) + (k - 1)) * 3;
      sx = (gx - pd[0]) + ps[0];
      sy = (gy - pd[1]) + ps[1];
      sz = (gz - pd[2]) + ps[2];
    }
    m[k] = __ldg(mask + ((long long)(b * kTailK1 + k) * D + d) * HW + hw);
    g[k] = dx * sx + dyv * sy + dz * sz;
    s += m[k] * g[k];
  }
#pragma unroll
  for (int k = 0; k < kTailK1; ++k)
    dlogits[((long long)(b * kTailK1 + k) * D + d) * HW + hw] = m[k] * (g[k] - s);
  if (d == 0) {
    const long long i = (long long)b * HW + hw;
    const float o1 = __ldg(occ1 + i), o2 = __ldg(occ2 + i);
    dpre[(2LL * b) * HW + hw] = docc1 ? __ldg(docc1 + i) * o1 * (1.0f - o1) : 0.0f;
    dpre[(2LL * b + 1) * HW + hw] = docc2 ? __ldg(docc2 + i) * o2 * (1.0f - o2) : 0.0f;
  }
}

// grid (ceil(H / 4) x ceil(W / 64), D, B x channel blocks); dx [B,C,D,H,W]
__global__ void __launch_bounds__(256, 2)
tail_dgrad_kernel(const float* __restrict__ dl, const float* __restrict__ dp,
                  const float4* __restrict__ packed, int C, int D, int H, int W, int n_cb,
                  float* __restrict__ dx) {
  __shared__ __align__(16) float stage_s[2][kTgStage];
  __shared__ int2 tab_m[kTgMaskKS * 4], tab_o[kTgOccKS * 4];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ntw = (W + kTgTW - 1) / kTgTW;
  const int h0 = (blockIdx.x / ntw) * kTgTH, w0 = (blockIdx.x % ntw) * kTgTW;
  const int d = blockIdx.y, b = blockIdx.z / n_cb, cb = blockIdx.z % n_cb;
  const long long HW = (long long)H * W;
  const int j_lo = max(0, 3 - d), j_hi = min(6, D + 2 - d);
  const int n_mask = j_hi - j_lo + 1, n_steps = n_mask + 1;

  // the slots' offsets in a stage: k-major, taps fastest; a padding slot
  // (weight 0) reads the last pair's word, as a lane beside it does
  for (int e = tid; e < (kTgMaskKS + kTgOccKS) * 4; e += blockDim.x) {
    const bool occ = e >= kTgMaskKS * 4;
    const int q = occ ? e - kTgMaskKS * 4 : e;
    const int n_pairs = occ ? 2 * 49 : kTailK1 * 49;
    int off[2];
    for (int h = 0; h < 2; ++h) {
      const int s = min((q / 4) * 8 + q % 4 + 4 * h, n_pairs - 1);
      off[h] = (s / 49) * kTgCS + (s % 49 / 7) * kTgRS + s % 7;
    }
    (occ ? tab_o : tab_m)[q] = make_int2(off[0], off[1]);
  }
  // step n < n_mask: dl's 5 channels at plane d + j_lo + n - 3; step n_mask:
  // dp's 2 channels; each with its halo (10 rows x 70 columns), zero outside
  auto stage = [&](int n) {
    float* st = stage_s[n & 1];
    const bool occ = n == n_mask;
    const float* src = occ ? dp + 2LL * b * HW
                           : dl + ((long long)b * kTailK1 * D + d + j_lo + n - 3) * HW;
    const long long ch_stride = occ ? HW : D * HW;
    const int total = (occ ? 2 : kTailK1) * (kTgTH + 6) * (kTgTW + 6);
    for (int e = tid; e < total; e += blockDim.x) {
      const int ch = e / ((kTgTH + 6) * (kTgTW + 6));
      const int rem = e - ch * ((kTgTH + 6) * (kTgTW + 6));
      const int i = rem / (kTgTW + 6), jj = rem - i * (kTgTW + 6);
      const int gy = h0 - 3 + i, gx = w0 - 3 + jj;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(st + ch * kTgCS + i * kTgRS + jj,
                ok ? src + ch * ch_stride + (long long)gy * W + gx : src, ok);
    }
  };

  const int row = warp >> 1, col0 = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  const long long per_cb = tail_pack_size(D);
  stage(0);
  cp_async_commit();
  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait<0>();
    __syncthreads();  // step n landed; step n - 1's stage is free; the tables written
    if (n + 1 < n_steps) stage(n + 1);
    cp_async_commit();
    const bool occ = n == n_mask;
    const int nks = occ ? kTgOccKS : kTgMaskKS;
    const int2* tab = occ ? tab_o : tab_m;
    const float4* pw = packed + cb * per_cb +
                       (occ ? (7LL * kTgMaskKS + (long long)d * kTgOccKS)
                            : (long long)(j_lo + n) * kTgMaskKS) * 128 + lane;
    const float* ab = stage_s[n & 1] + row * kTgRS + col0 + gid;
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
    float4 bq[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bq[nt] = __ldg(pw + nt * 32);
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks) {
      float4 bn[4];
      const int kn = ks + 1 < nks ? ks + 1 : ks;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bn[nt] = __ldg(pw + (kn * 4 + nt) * 32);
      const int2 o = tab[ks * 4 + tig];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a_m = ab + 16 * mt;
        const float a[4] = {a_m[o.x], a_m[o.x + 8], a_m[o.y], a_m[o.y + 8]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wg_split(a[i], ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_split_tf32(part[mt][nt], ah, al, bq[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bq[nt] = bn[nt];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  // accumulator (mt, nt) element i: voxel column col0 + 16 mt + gid + 8 (i / 2),
  // channel 8 nt + 2 tig + i % 2
  const int h = h0 + row;
  if (h >= H) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = w0 + col0 + 16 * mt + gid + 8 * (i / 2);
        const int c = cb * kTgN + 8 * nt + 2 * tig + i % 2;
        if (w < W && c < C)
          dx[(((long long)b * C + c) * D + d) * HW + (long long)h * W + w] = acc[mt][nt][i];
      }
}

// grid (ceil(CD / 32), n_split); docc_w [2,CD,7,7] and docc_b [2] zeroed by
// the caller
__global__ void __launch_bounds__(kOwThreads)
occ_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dp, int B, int CD,
                 int H, int W, float* __restrict__ docc_w, float* __restrict__ docc_b) {
  extern __shared__ float4 ow_smem4[];
  float* s_x = reinterpret_cast<float*>(ow_smem4);
  float* s_dp = s_x + kOwCd * kOwCS;  // [head][row][column]
  const int tid = threadIdx.x, lane = tid % 32, ty = tid / 32;
  const int cd0 = blockIdx.x * kOwCd, cd = cd0 + lane;
  const int nrow = (H + kOwRows - 1) / kOwRows, ncol = (W + kOwTW - 1) / kOwTW;
  const long long units = (long long)B * nrow * ncol;
  const long long u0 = units * blockIdx.y / gridDim.y, u1 = units * (blockIdx.y + 1) / gridDim.y;
  const long long HW = (long long)H * W;
  const bool bias = blockIdx.x == 0 && ty == 0;
  float a0[7], a1[7], bs0 = 0.0f, bs1 = 0.0f;
#pragma unroll
  for (int tx = 0; tx < 7; ++tx) a0[tx] = a1[tx] = 0.0f;
  for (long long u = u0; u < u1; ++u) {
    const int b = (int)(u / (nrow * ncol));
    const int rc = (int)(u - (long long)b * nrow * ncol);
    const int y0 = rc / ncol * kOwRows, x0 = rc % ncol * kOwTW;
    __syncthreads();  // the last unit's reads are done
    for (int e = tid; e < kOwCd * (kOwRows + 6) * kOwRS; e += kOwThreads) {
      const int c = e / ((kOwRows + 6) * kOwRS), rem = e % ((kOwRows + 6) * kOwRS);
      const int i = rem / kOwRS, jj = rem % kOwRS;
      const int gy = y0 - 3 + i, gx = x0 - 3 + jj;
      const bool ok = cd0 + c < CD && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(s_x + c * kOwCS + rem,
                ok ? x + ((long long)b * CD + cd0 + c) * HW + (long long)gy * W + gx : x, ok);
    }
    for (int e = tid; e < 2 * kOwRows * kOwTW; e += kOwThreads) {
      const int head = e / (kOwRows * kOwTW), i = e / kOwTW % kOwRows, jj = e % kOwTW;
      const int gy = y0 + i, gx = x0 + jj;
      const bool ok = gy < H && gx < W;
      cp_async4(s_dp + e, ok ? dp + (2LL * b + head) * HW + (long long)gy * W + gx : dp, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < kOwRows; ++r) {
      const float* xr = s_x + lane * kOwCS + (r + ty) * kOwRS;
      const float* p0r = s_dp + r * kOwTW;
      const float* p1r = p0r + kOwRows * kOwTW;
#pragma unroll 1
      for (int c0 = 0; c0 < kOwTW; c0 += 8) {
        float xv[14], p0[8], p1[8];
#pragma unroll
        for (int j = 0; j < 14; ++j) xv[j] = xr[c0 + j];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p0[j] = p0r[c0 + j];
          p1[j] = p1r[c0 + j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int tx = 0; tx < 7; ++tx) {
            a0[tx] = fmaf(p0[j], xv[j + tx], a0[tx]);
            a1[tx] = fmaf(p1[j], xv[j + tx], a1[tx]);
          }
        if (bias) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bs0 += lane == j ? p0[j] : 0.0f;
            bs1 += lane == j ? p1[j] : 0.0f;
          }
        }
      }
    }
  }
  if (cd < CD) {
#pragma unroll
    for (int tx = 0; tx < 7; ++tx) {
      atomicAdd(docc_w + (long long)cd * 49 + ty * 7 + tx, a0[tx]);
      atomicAdd(docc_w + ((long long)CD + cd) * 49 + ty * 7 + tx, a1[tx]);
    }
  }
  if (bias) {
    for (int off = 16; off > 0; off >>= 1) {
      bs0 += __shfl_xor_sync(0xffffffffu, bs0, off);
      bs1 += __shfl_xor_sync(0xffffffffu, bs1, off);
    }
    if (lane == 0) {
      atomicAdd(docc_b, bs0);
      atomicAdd(docc_b + 1, bs1);
    }
  }
}

}  // namespace

// The tiles a caller plans its launches for (out[11]): K7a's threads per
// CTA, a warp's output tile (voxels and channels), input channels per step,
// stages of the copy ring and the shared memory a CTA may use; K7b's pixel
// tile rows at D = 16 and at D = 2, its columns, the CTAs an SM holds and
// the depth groups at D = 16 and at D = 2 (each writes its own occlusion
// sums into the partial tensor).
R3DP_EXPORT int r3dp_k7_tiles(int* out) {
  const int tiles[11] = {kThreads, kWarpTile, kCiChunk, kStages, kSmemMax,
                         TailShape<16>::TH, TailShape<2>::TH, kTailTW, kTailCtasPerSm,
                         TailShape<16>::NDH, TailShape<2>::NDH};
  for (int i = 0; i < 11; ++i) out[i] = tiles[i];
  return 0;
}

// x [B,Ci,D,H,W] fp32; wt [Co,Ci,K,K,K]; bias [Co] or null; out
// [B,Co,D,H,W]. The caller plans the launch for r3dp_k7_tiles: KH tap rows
// per step (K, or 1), BN output channels (32, or 64 at K = 3), TD x TH x TW
// voxels (TW a multiple of 4, at most 8192 / BN voxels), the split of the
// input channels (ci_per_split a multiple of the step's 8), and vec,
// whether W is a multiple of 4 and x 16 B aligned (the halo rows' interiors
// then copy in 16 B pieces); partial [n_split,B,Co,D,H,W] when n_split > 1,
// else unused.
R3DP_EXPORT int r3dp_conv3d(const float* x, const float* wt, const float* bias, float* out,
                            float* partial, int B, int Ci, int Co, int D, int H, int W, int K,
                            int KH, int BN, int TD, int TH, int TW, int ci_per_split,
                            int n_split, int vec, cudaStream_t stream) {
  if ((K != 3 && K != 7) || (KH != K && KH != 1) || (K == 7 && (KH != 1 || BN != 32)) ||
      (BN != 32 && BN != 64) || TD < 1 || TH < 1 || TW < 4 || TW % 4 ||
      TD * TH * TW > kWarps * kWarpTile * kWarpTile / BN || n_split < 1 || ci_per_split < 1 ||
      ci_per_split % kCiChunk)
    return (int)cudaErrorInvalidValue;
  K7Geom g;
  g.l = k7_layout(K, KH, BN, TD, TH, TW);
  const size_t smem = sizeof(float) * (size_t)(kStages + 1) * g.l.stage_floats;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  g.Ci = Ci, g.Co = Co, g.D = D, g.H = H, g.W = W;
  g.TD = TD, g.TH = TH, g.TW = TW;
  g.nd = (D + TD - 1) / TD, g.nh = (H + TH - 1) / TH, g.nw = (W + TW - 1) / TW;
  g.ci_per_split = ci_per_split, g.vec = vec;
  g.pieces = vec ? TW / 4 + 2 * (K / 2) : TW + 2 * (K / 2);
  g.by_pieces = k7_div(g.pieces), g.by_rows = k7_div(g.l.HR), g.by_depth = k7_div(TD);
  g.split_stride = (long long)B * Co * D * H * W;
  if (K == 7)
    return launch_conv3d<7, 1, 1>(x, wt, bias, out, partial, B, g, n_split, smem, stream);
  if (KH == 1)
    return BN == 64
               ? launch_conv3d<3, 1, 2>(x, wt, bias, out, partial, B, g, n_split, smem, stream)
               : launch_conv3d<3, 1, 1>(x, wt, bias, out, partial, B, g, n_split, smem, stream);
  return BN == 64
             ? launch_conv3d<3, 3, 2>(x, wt, bias, out, partial, B, g, n_split, smem, stream)
             : launch_conv3d<3, 3, 1>(x, wt, bias, out, partial, B, g, n_split, smem, stream);
}

// x [B,C,D,H,W] fp32; mask_w [K1,C,7,7,7], mask_b [K1]; occ_w [2,C*D,7,7]
// (occlusion_conv's and occlusion_conv2's weights), occ_b [2]; kp_s, kp_d
// [B,K1-1,3]; deformation [B,D,H,W,3]; occ1, occ2 [B,H,W]. D = 16 (standard
// and small presets) or 2 (tiny), K1 = 5. The caller splits the C input
// channels into n_split ranges of c_per_split (the last may be shorter,
// none empty) and gives the scratch partial [n_split,B,D*K1+2*G,H,W] for
// the G depth groups that r3dp_k7_tiles reports.
R3DP_EXPORT int r3dp_mfe_tail(const float* x, const float* mask_w, const float* mask_b,
                              const float* occ_w, const float* occ_b, const float* kp_s,
                              const float* kp_d, int B, int C, int D, int H, int W, int K1,
                              int c_per_split, int n_split, float* partial,
                              float* deformation, float* occ1, float* occ2, float* mask_out,
                              cudaStream_t stream) {
  if (K1 != kTailK1 || H < 2 || W < 2 || C < 1 || n_split < 1 || c_per_split < 1)
    return (int)cudaErrorInvalidValue;
  if (D == 16)
    return launch_mfe_tail<16>(x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d, B, C, H, W,
                               c_per_split, n_split, partial, deformation, occ1, occ2, mask_out,
                               stream);
  if (D == 2)
    return launch_mfe_tail<2>(x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d, B, C, H, W,
                              c_per_split, n_split, partial, deformation, occ1, occ2, mask_out,
                               stream);
  return (int)cudaErrorInvalidValue;
}


// K7a's weight gradient: x [B,Ci,D,H,W] and dy [B,Co,D,H,W] fp32; dw
// [Co,Ci,K,K,K] and db [Co] (or null) zeroed by the caller. The caller
// plans the launch (ops/conv3d.py conv3d_weight_grad_plan): units of SW
// columns (a multiple of 4 where vec; ceil(W / SW) units a row), R <= 128
// units a brick (its stages within the shared memory a CTA may use),
// n_split shares of each row of taps' units; vec: W and SW multiples of 4
// and x and dy 16 B aligned.
R3DP_EXPORT int r3dp_conv3d_weight_grad(const float* x, const float* dy, int B, int Ci, int Co,
                                        int D, int H, int W, int K, int SW, int R, int n_split,
                                        int vec, float* dw, float* db, cudaStream_t stream) {
  if ((K != 3 && K != 7) || B < 1 || Ci < 1 || Co < 1 || D < 1 || H < 1 || W < 1 || SW < 1 ||
      R < 1 || R > kWgMaxUnits || n_split < 1 || n_split > 65535 ||
      (vec && (W % 4 || SW % 4)) || (long long)B * D * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int BN = Co <= 8 ? 8 : 32;
  const long long tiles = (long long)((Ci + kWgM - 1) / kWgM) * ((Co + BN - 1) / BN);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  WgGeom g;
  g.Ci = Ci, g.Co = Co, g.D = D, g.H = H, g.W = W, g.B = B;
  g.SW = SW, g.nseg = (W + SW - 1) / SW, g.R = R;
  g.n_ci = (Ci + kWgM - 1) / kWgM, g.vec = vec;
  const int n_co = (Co + BN - 1) / BN;
  if (K == 7)
    return BN == 8 ? launch_wgrad<7, 8, 1>(x, dy, g, n_split, n_co, dw, db, stream)
                   : launch_wgrad<7, 32, 1>(x, dy, g, n_split, n_co, dw, db, stream);
  return BN == 8 ? launch_wgrad<3, 8, 2>(x, dy, g, n_split, n_co, dw, db, stream)
                 : launch_wgrad<3, 32, 2>(x, dy, g, n_split, n_co, dw, db, stream);
}

// K7b backward, before the mask conv's weight gradient: ddef [B,D,H,W,3];
// docc1, docc2 [B,H,W] or null (zero); mask [B,5,D,H,W] the forward's
// softmax; occ1, occ2 [B,H,W] the forward's occlusions; kp_s, kp_d [B,4,3];
// mask_w [5,C,7,7,7], occ_w [2,C*D,7,7] -> dlogits [B,5,D,H,W], dpre
// [B,2,H,W], and both weights packed for r3dp_mfe_tail_backward_data
// (4 x ceil(C / 32) x (7 x 31 + D x 13) x 128 floats,
// models/torso.py:mfe_tail_backward_layout). D, H, W >= 2.
R3DP_EXPORT int r3dp_mfe_tail_backward_adjoint(const float* ddef, const float* docc1,
                                               const float* docc2, const float* mask,
                                               const float* occ1, const float* occ2,
                                               const float* kp_s, const float* kp_d,
                                               const float* mask_w, const float* occ_w, int B,
                                               int C, int D, int H, int W, float* dlogits,
                                               float* dpre, float* packed,
                                               cudaStream_t stream) {
  if (D < 2 || H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const long long voxels = (long long)B * D * H * W;
  const long long n_pack = (long long)((C + kTgN - 1) / kTgN) * tail_pack_size(D);
  const long long n_adj = (voxels + 255) / 256, blocks = n_adj + (n_pack + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mfe_tail_adjoint_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      ddef, docc1, docc2, mask, occ1, occ2, kp_s, kp_d, mask_w, occ_w, B, C, D, H, W,
      (unsigned)n_adj, n_pack, dlogits, dpre, reinterpret_cast<float4*>(packed));
  return (int)cudaGetLastError();
}

// K7b backward, the data gradient: dlogits [B,5,D,H,W], dpre [B,2,H,W] and
// packed from r3dp_mfe_tail_backward_adjoint -> dx [B,C,D,H,W] (every
// element written): the mask conv's and both occlusion heads' data
// gradients. D, H, W >= 2.
R3DP_EXPORT int r3dp_mfe_tail_backward_data(const float* dlogits, const float* dpre,
                                            const float* packed, int B, int C, int D, int H,
                                            int W, float* dx, cudaStream_t stream) {
  if (D < 2 || H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int n_cb = (C + kTgN - 1) / kTgN;
  const long long tiles = (long long)((H + kTgTH - 1) / kTgTH) * ((W + kTgTW - 1) / kTgTW);
  if (tiles > 0x7fffffffLL || D > 65535 || (long long)B * n_cb > 65535)
    return (int)cudaErrorInvalidValue;
  tail_dgrad_kernel<<<dim3((unsigned)tiles, D, B * n_cb), 256, 0, stream>>>(
      dlogits, dpre, reinterpret_cast<const float4*>(packed), C, D, H, W, n_cb, dx);
  return (int)cudaGetLastError();
}

// K7b backward, the occlusion heads' weight gradient: x [B,C*D,H,W] (the
// C-major fold of the tail's input), dpre [B,2,H,W]; adds it into docc_w
// [2,C*D,7,7] and docc_b [2], zeroed by the caller. The pixel units (4 rows
// x 64 columns of one b) are shared among n_split CTAs of each 32 fold
// channels. W <= 256.
R3DP_EXPORT int r3dp_mfe_tail_backward_occ(const float* x, const float* dpre, int B, int CD,
                                           int H, int W, int n_split, float* docc_w,
                                           float* docc_b, cudaStream_t stream) {
  if (W < 1 || W > kOccMaxW || H < 1 || CD < 1 || B < 1 || n_split < 1 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(occ_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kOwSmem);
  if (err != cudaSuccess) return (int)err;
  occ_wgrad_kernel<<<dim3((CD + kOwCd - 1) / kOwCd, n_split), kOwThreads, kOwSmem, stream>>>(
      x, dpre, B, CD, H, W, docc_w, docc_b);
  return (int)cudaGetLastError();
}
