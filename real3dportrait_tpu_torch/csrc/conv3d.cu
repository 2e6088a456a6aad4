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
// What bounds it on an H100: the fp32 operations (the fuser is 108 GFLOP,
// the U-Net's ten 3^3 convs 60 GFLOP, counting the taps inside the volume,
// against 67 TFLOP/s on CUDA cores), even at the deepest 3^3 convs, whose
// 4x4 planes carry 57 MB of weights for 4.8 GFLOP. Design: each CTA owns
// TD depth slices x TH rows x TW columns of output voxels (the whole
// volume's width where it is at most 64, several depth slices where the
// planes are small) times 32 output channels. Per chunk of input channels
// and per depth tap it stages the input halo tile and the matching weights
// in shared memory (the weights transposed on the way, so that a tap's 32
// output channels are contiguous there); each of the 256 threads keeps 4
// neighbouring output columns x 8 channels in
// registers, loads a row of 4 + k - 1 inputs once per (channel, kh) and
// slides it over the kw taps: 32 FFMAs per weight-pair load. Where the
// tiles and output-channel blocks give fewer than two CTAs per SM (the
// deep 4x4 and 8x8 levels) the input channels are split over CTAs that
// write partial sums, and a second pass adds them and the bias in a fixed
// order (no atomics: the result does not depend on scheduling).
//
// K7b mfe_tail replaces models/torso.py lines 429-482 (the "fused" tail,
// with ops/conv3d.py folded_banded_kernel, lines 49-74, as its TPU form:
// the mask conv's depth folded into 128-lane output tiles, because a
// Co = K+1 = 5 conv wastes an MXU tile 25x). Here, per voxel: the mask
// conv's 7^3 logits (C -> K+1), the softmax over the K+1 candidates and the
// deformation sum_k mask_k * sparse_motion_k with the sparse motions
// computed from the keypoints; per pixel: both 7^2 occlusion heads on the
// C-major depth fold (channel c*D + d, C*D -> 1 each) and their sigmoid.
// Both heads read the same x halo tiles, so one pass computes both. What
// bounds it: fp32 operations (6.5 GFLOP at the standard preset's
// [1,32,16,64,64]); cuDNN pays for Co = 5 with mostly idle tiles. Design:
// a CTA owns an 8 x 32 pixel tile at every depth and a group of input
// channels; per channel it stages the 16 depth planes' halo tiles and the
// channel's weights, and each thread keeps all D x (K+1) mask logits and
// both occlusion sums of its pixel in registers: per tap it loads the
// pixel's D inputs and the tap's 7 (K+1) mask weights once and does
// ~500 FFMAs. The channel groups' partial logits are added by an epilogue
// pass (one thread per voxel) that also applies the biases, the softmax,
// the deformation sum and the sigmoids.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixelGroups = 64;  // 4-column groups of output voxels per CTA
constexpr int kCoBlock = 32;      // output channels per CTA: 4 groups of 8
constexpr int kCiChunk3 = 8, kCiChunk7 = 4;  // input channels staged at once, k = 3 and 7
// a staged weight row (one input channel and tap): the CTA's output
// channels, padded so that the transposing stores of a warp hit 32 banks
constexpr int kWRow = kCoBlock + 8;
static_assert(kThreads == kPixelGroups * kCoBlock / 8, "a thread owns 8 output channels");

// ---------------------------------------------------------------------------
// K7a
// ---------------------------------------------------------------------------

template <int K, int CI_CH>
__global__ void __launch_bounds__(kThreads)
conv3d_kernel(const float* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ bias, float* __restrict__ out, int Ci, int Co,
              int D, int H, int W, int TD, int TH, int G, int nd, int nh, int nw,
              int ci_per_split, long long split_stride) {
  constexpr int P = K / 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int TW = 4 * G;
  const int RS = (TW + K - 1 + 3) & ~3;  // halo row stride, 16 B aligned
  const int HR = TH + K - 1;             // halo rows
  const int in_plane = TD * HR * RS;     // one input channel's halo tile
  float* in_s = smem;                    // [CI_CH][TD][HR][RS]
  float* w_s = smem + CI_CH * in_plane;  // [CI_CH][K][K][kWRow]
  static_assert(CI_CH * K * K % 4 == 0, "the weight staging takes rows 4 at a time");

  int t = blockIdx.x;
  const int tw_i = t % nw;
  t /= nw;
  const int th_i = t % nh;
  t /= nh;
  const int td_i = t % nd;
  const int b = t / nd;
  const int d0 = td_i * TD, h0 = th_i * TH, w0 = tw_i * TW;
  const int co0 = blockIdx.y * kCoBlock;
  const int ci_begin = blockIdx.z * ci_per_split;
  const int ci_end = min(Ci, ci_begin + ci_per_split);

  const int tid = threadIdx.x;
  const int cg = tid / kPixelGroups;  // two warps per channel group: weight loads broadcast
  const int pgi = tid % kPixelGroups;
  const int pg = pgi % G;
  const int py = (pgi / G) % TH;
  const int pz = pgi / (G * TH);
  const bool active = pgi < TD * TH * G;

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.0f;

  const long long HW = (long long)H * W, DHW = (long long)D * HW;
  const float* xb = x + (long long)b * Ci * DHW;
  const int n_in = CI_CH * in_plane;
  const int n_w = CI_CH * K * K * kCoBlock;
  constexpr int kCoGroups = kCoBlock / 8;

  for (int ci0 = ci_begin; ci0 < ci_end; ci0 += CI_CH) {
    for (int kd = 0; kd < K; ++kd) {
      __syncthreads();  // the previous tap's compute is done with the tiles
      for (int e = tid; e < n_in; e += kThreads) {
        const int c = e % RS;
        int r = e / RS;
        const int hy = r % HR;
        r /= HR;
        const int z = r % TD;
        const int ci = ci0 + r / TD;
        const int gd = d0 + z + kd - P, gh = h0 + hy - P, gw = w0 + c - P;
        float v = 0.0f;
        if (ci < ci_end && c < TW + K - 1 && gd >= 0 && gd < D && gh >= 0 && gh < H &&
            gw >= 0 && gw < W)
          v = __ldg(xb + ci * DHW + gd * HW + (long long)gh * W + gw);
        in_s[e] = v;
      }
      // a warp reads 8 output channels x 4 consecutive rows (input channel,
      // kh, kw): 16 B runs of the [Co,Ci,K,K,K] weight
      for (int e = tid; e < n_w; e += kThreads) {
        const int lane = e % 32, q = e / 32;
        const int co = 8 * (q % kCoGroups) + lane % 8;
        const int r = 4 * (q / kCoGroups) + lane / 8;
        const int ci = ci0 + r / (K * K);
        float v = 0.0f;
        if (ci < ci_end && co0 + co < Co)
          v = __ldg(wt + (((long long)(co0 + co) * Ci + ci) * K + kd) * (K * K) + r % (K * K));
        w_s[r * kWRow + co] = v;
      }
      __syncthreads();
      if (!active) continue;
      constexpr int kCiUnroll = K == 3 ? CI_CH : 1;  // the 7^3 body is large already
#pragma unroll (kCiUnroll)
      for (int i = 0; i < CI_CH; ++i) {
        const float* in_i = in_s + ((i * TD + pz) * HR + py) * RS + 4 * pg;
        const float* w_i = w_s + i * K * K * kWRow + 8 * cg;
#pragma unroll
        for (int kh = 0; kh < K; ++kh) {
          float v[K + 3];
          const float2* row = reinterpret_cast<const float2*>(in_i + kh * RS);
#pragma unroll
          for (int j = 0; j < (K + 3) / 2; ++j) {
            const float2 q = row[j];
            v[2 * j] = q.x;
            v[2 * j + 1] = q.y;
          }
#pragma unroll
          for (int kw = 0; kw < K; ++kw) {
            const float4* wp = reinterpret_cast<const float4*>(w_i + (kh * K + kw) * kWRow);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[p][c] = fmaf(v[p + kw], wv[c], acc[p][c]);
          }
        }
      }
    }
  }

  const int od = d0 + pz, oh = h0 + py;
  if (!active || od >= D || oh >= H) return;
  float* ob = out + blockIdx.z * split_stride;
  const bool add_bias = gridDim.z == 1 && bias != nullptr;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = co0 + 8 * cg + c;
    if (co >= Co) continue;
    const float bv = add_bias ? __ldg(bias + co) : 0.0f;
    float* orow = ob + ((long long)b * Co + co) * DHW + od * HW + (long long)oh * W;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int ow = w0 + 4 * pg + p;
      if (ow < W) orow[ow] = acc[p][c] + bv;
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

template <int K, int CI_CH>
int launch_conv3d(const float* x, const float* wt, const float* bias, float* out,
                  float* partial, int B, int Ci, int Co, int D, int H, int W, int TD, int TH,
                  int G, int ci_per_split, int n_split, cudaStream_t stream) {
  const int nd = (D + TD - 1) / TD, nh = (H + TH - 1) / TH, nw = (W + 4 * G - 1) / (4 * G);
  const int RS = (4 * G + K - 1 + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)CI_CH * TD * (TH + K - 1) * RS +
                                       (size_t)CI_CH * K * K * kWRow);
  auto kernel = conv3d_kernel<K, CI_CH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * Co * D * H * W;
  dim3 grid((unsigned)(B * nd * nh * nw), (unsigned)((Co + kCoBlock - 1) / kCoBlock),
            (unsigned)n_split);
  if (total == 0) return (int)cudaGetLastError();
  if (n_split == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(x, wt, bias, out, Ci, Co, D, H, W, TD, TH, G,
                                             nd, nh, nw, ci_per_split, 0);
    return (int)cudaGetLastError();
  }
  kernel<<<grid, kThreads, smem, stream>>>(x, wt, bias, partial, Ci, Co, D, H, W, TD, TH, G,
                                           nd, nh, nw, ci_per_split, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv3d_reduce_kernel<<<r3dp_blocks(total, 256), 256, 0, stream>>>(
      partial, bias, total, (long long)D * H * W, Co, n_split, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7b
// ---------------------------------------------------------------------------

constexpr int kTailTH = 8, kTailTW = 32;  // pixel tile: one warp per row
constexpr int kTailHR = kTailTH + 6, kTailRS = kTailTW + 6;

template <int D, int K1>
__global__ void __launch_bounds__(kThreads, 1)
mfe_tail_kernel(const float* __restrict__ x, const float* __restrict__ mask_w,
                const float* __restrict__ occ_w, int C, int H, int W, int nh, int nw,
                int c_per_split, float* __restrict__ partial) {
  constexpr int NCH = D * K1 + 2;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [D][HR][RS]
  float* wm = xs + D * kTailHR * kTailRS;       // [49][7][K1]
  float* wo = wm + 49 * 7 * K1;                 // [2][D][49]

  int t = blockIdx.x;
  const int tw_i = t % nw;
  t /= nw;
  const int th_i = t % nh;
  const int b = t / nh;
  const int h0 = th_i * kTailTH, w0 = tw_i * kTailTW;
  const int c_begin = blockIdx.y * c_per_split;
  const int c_end = min(C, c_begin + c_per_split);
  const int tx = threadIdx.x % kTailTW, ty = threadIdx.x / kTailTW;
  const long long HW = (long long)H * W;
  const int B = gridDim.x / (nh * nw);

  float acc[D][K1];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int k = 0; k < K1; ++k) acc[d][k] = 0.0f;
  float occ0 = 0.0f, occ1 = 0.0f;

  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();
    const float* xc = x + ((long long)b * C + c) * D * HW;
    for (int e = threadIdx.x; e < D * kTailHR * kTailRS; e += kThreads) {
      const int cx = e % kTailRS;
      const int r = e / kTailRS;
      const int hy = r % kTailHR, dd = r / kTailHR;
      const int gh = h0 + hy - 3, gw = w0 + cx - 3;
      float v = 0.0f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = __ldg(xc + dd * HW + (long long)gh * W + gw);
      xs[e] = v;
    }
    for (int e = threadIdx.x; e < 49 * 7 * K1; e += kThreads) {
      const int k = e % K1;
      const int r = e / K1;
      const int kd = r % 7, tap = r / 7;
      wm[e] = __ldg(mask_w + (((long long)k * C + c) * 7 + kd) * 49 + tap);
    }
    for (int e = threadIdx.x; e < 2 * D * 49; e += kThreads) {
      const int tap = e % 49;
      const int r = e / 49;
      const int dd = r % D, j = r / D;
      wo[e] = __ldg(occ_w + (((long long)j * C + c) * D + dd) * 49 + tap);
    }
    __syncthreads();
#pragma unroll 1
    for (int kh = 0; kh < 7; ++kh) {
#pragma unroll 1
      for (int kw = 0; kw < 7; ++kw) {
        const int tap = kh * 7 + kw;
        float v[D];
#pragma unroll
        for (int dd = 0; dd < D; ++dd) v[dd] = xs[(dd * kTailHR + ty + kh) * kTailRS + tx + kw];
        float wmv[7][K1];
#pragma unroll
        for (int kd = 0; kd < 7; ++kd)
#pragma unroll
          for (int k = 0; k < K1; ++k) wmv[kd][k] = wm[(tap * 7 + kd) * K1 + k];
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int kd = 0; kd < 7; ++kd) {
            const int dd = d + kd - 3;  // zero depth padding: taps outside add nothing
            if (dd < 0 || dd >= D) continue;
#pragma unroll
            for (int k = 0; k < K1; ++k) acc[d][k] = fmaf(v[dd], wmv[kd][k], acc[d][k]);
          }
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          occ0 = fmaf(v[dd], wo[dd * 49 + tap], occ0);
          occ1 = fmaf(v[dd], wo[(D + dd) * 49 + tap], occ1);
        }
      }
    }
  }

  const int oh = h0 + ty, ow = w0 + tx;
  if (oh >= H || ow >= W) return;
  // partial [S, B, NCH, H, W]: neighbouring threads store neighbouring w
  float* p = partial + (((long long)blockIdx.y * B + b) * NCH) * HW + (long long)oh * W + ow;
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int k = 0; k < K1; ++k) p[(d * K1 + k) * HW] = acc[d][k];
  p[(D * K1) * HW] = occ0;
  p[(D * K1 + 1) * HW] = occ1;
}

// one thread per voxel: split sums + biases, softmax over the K+1
// candidates, deformation = sum_k mask_k * motion_k (motion_0 the identity
// grid, motion_k = grid - kp_d[k-1] + kp_s[k-1]); the d = 0 threads also
// write both occlusion maps
template <int D, int K1>
__global__ void __launch_bounds__(256)
mfe_tail_epilogue_kernel(const float* __restrict__ partial, const float* __restrict__ mask_b,
                         const float* __restrict__ occ_b, const float* __restrict__ kp_s,
                         const float* __restrict__ kp_d, int B, int H, int W, int n_split,
                         float* __restrict__ deformation, float* __restrict__ occ1,
                         float* __restrict__ occ2) {
  constexpr int NCH = D * K1 + 2;
  const long long HW = (long long)H * W;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * D * HW) return;
  const int b = (int)(n / (D * HW));
  const long long r = n - (long long)b * D * HW;
  const int d = (int)(r / HW);
  const long long hw = r - (long long)d * HW;
  const int h = (int)(hw / W), w = (int)(hw - (long long)h * W);
  const long long split_stride = (long long)B * NCH * HW;
  const float* pb = partial + (long long)b * NCH * HW + hw;

  float logit[K1];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < K1; ++k) {
    float s = 0.0f;
    for (int q = 0; q < n_split; ++q) s += __ldg(pb + q * split_stride + (d * K1 + k) * HW);
    logit[k] = s + __ldg(mask_b + k);
    m = fmaxf(m, logit[k]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < K1; ++k) {
    logit[k] = expf(logit[k] - m);
    sum += logit[k];
  }
  const float gx = 2.0f * ((float)w / (float)(W - 1)) - 1.0f;
  const float gy = 2.0f * ((float)h / (float)(H - 1)) - 1.0f;
  const float gz = 2.0f * ((float)d / (float)(D - 1)) - 1.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
#pragma unroll
  for (int k = 0; k < K1; ++k) {
    const float mk = logit[k] / sum;
    float sx = gx, sy = gy, sz = gz;
    if (k > 0) {
      const float* pd = kp_d + ((long long)b * (K1 - 1) + (k - 1)) * 3;
      const float* ps = kp_s + ((long long)b * (K1 - 1) + (k - 1)) * 3;
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
    for (int q = 0; q < n_split; ++q) {
      s0 += __ldg(pb + q * split_stride + (D * K1) * HW);
      s1 += __ldg(pb + q * split_stride + (D * K1 + 1) * HW);
    }
    occ1[(long long)b * HW + hw] = r3dp_sigmoid(s0 + __ldg(occ_b));
    occ2[(long long)b * HW + hw] = r3dp_sigmoid(s1 + __ldg(occ_b + 1));
  }
}

template <int D, int K1>
int launch_mfe_tail(const float* x, const float* mask_w, const float* mask_b,
                    const float* occ_w, const float* occ_b, const float* kp_s,
                    const float* kp_d, int B, int C, int H, int W, int c_per_split,
                    int n_split, float* partial, float* deformation, float* occ1,
                    float* occ2, cudaStream_t stream) {
  const int nh = (H + kTailTH - 1) / kTailTH, nw = (W + kTailTW - 1) / kTailTW;
  const size_t smem = sizeof(float) * ((size_t)D * kTailHR * kTailRS + 49 * 7 * K1 + 2 * D * 49);
  auto kernel = mfe_tail_kernel<D, K1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long voxels = (long long)B * D * H * W;
  if (voxels == 0) return (int)cudaGetLastError();
  kernel<<<dim3((unsigned)(B * nh * nw), (unsigned)n_split), kThreads, smem, stream>>>(
      x, mask_w, occ_w, C, H, W, nh, nw, c_per_split, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mfe_tail_epilogue_kernel<D, K1><<<r3dp_blocks(voxels, 256), 256, 0, stream>>>(
      partial, mask_b, occ_b, kp_s, kp_d, B, H, W, n_split, deformation, occ1, occ2);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiles a caller plans its launches for (out[6]): K7a's 4-column
// pixel groups per CTA, output channels per CTA and input-channel chunk
// for K = 3 and K = 7; K7b's pixel tile rows and columns.
R3DP_EXPORT int r3dp_k7_tiles(int* out) {
  const int tiles[6] = {kPixelGroups, kCoBlock, kCiChunk3, kCiChunk7, kTailTH, kTailTW};
  for (int i = 0; i < 6; ++i) out[i] = tiles[i];
  return 0;
}

// x [B,Ci,D,H,W] fp32; wt [Co,Ci,K,K,K]; bias [Co] or null; out
// [B,Co,D,H,W]. The tile (TD x TH x 4G voxels, TD * TH * G at most the
// pixel groups) and the split of the input channels (ci_per_split a
// multiple of the channel chunk) come from the caller, planned for
// r3dp_k7_tiles; partial [n_split,B,Co,D,H,W] when n_split > 1, else
// unused.
R3DP_EXPORT int r3dp_conv3d(const float* x, const float* wt, const float* bias, float* out,
                            float* partial, int B, int Ci, int Co, int D, int H, int W, int K,
                            int TD, int TH, int G, int ci_per_split, int n_split,
                            cudaStream_t stream) {
  const int chunk = K == 3 ? kCiChunk3 : kCiChunk7;
  if (TD * TH * G > kPixelGroups || TD < 1 || TH < 1 || G < 1 || n_split < 1 ||
      ci_per_split < 1 || ci_per_split % chunk)
    return (int)cudaErrorInvalidValue;
  if (K == 3)
    return launch_conv3d<3, kCiChunk3>(x, wt, bias, out, partial, B, Ci, Co, D, H, W, TD, TH,
                                       G, ci_per_split, n_split, stream);
  if (K == 7)
    return launch_conv3d<7, kCiChunk7>(x, wt, bias, out, partial, B, Ci, Co, D, H, W, TD, TH,
                                       G, ci_per_split, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

// x [B,C,D,H,W] fp32; mask_w [K1,C,7,7,7], mask_b [K1]; occ_w [2,C*D,7,7]
// (occlusion_conv's and occlusion_conv2's weights), occ_b [2]; kp_s, kp_d
// [B,K1-1,3]; partial [n_split,B,D*K1+2,H,W] scratch; deformation
// [B,D,H,W,3]; occ1, occ2 [B,H,W]. D = 16 (standard and small presets) or
// 2 (tiny), K1 = 5.
R3DP_EXPORT int r3dp_mfe_tail(const float* x, const float* mask_w, const float* mask_b,
                              const float* occ_w, const float* occ_b, const float* kp_s,
                              const float* kp_d, int B, int C, int D, int H, int W, int K1,
                              int c_per_split, int n_split, float* partial,
                              float* deformation, float* occ1, float* occ2,
                              cudaStream_t stream) {
  if (K1 != 5 || H < 2 || W < 2 || n_split < 1) return (int)cudaErrorInvalidValue;
  if (D == 16)
    return launch_mfe_tail<16, 5>(x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d, B, C, H, W,
                                  c_per_split, n_split, partial, deformation, occ1, occ2,
                                  stream);
  if (D == 2)
    return launch_mfe_tail<2, 5>(x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d, B, C, H, W,
                                 c_per_split, n_split, partial, deformation, occ1, occ2,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
