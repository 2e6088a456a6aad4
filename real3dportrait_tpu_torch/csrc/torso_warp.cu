// K5 torso warps: the two trilinear warps of the keypoint-driven torso model.
//
// K5a torso_deform_input replaces, in the JAX package, models/torso.py
// MotionFieldEstimator lines 378-390: kp2gaussian_3d for the source and
// driving keypoints, create_sparse_motions, create_deformed_source_image
// (ops/grid_sample.py pack_trigrid_cells + grid_sample_3d_prepacked, the
// TPU's packing of each 2x2x2 cell into one wide gather row, shared by the
// K+1 candidates) and the concat/transpose into the estimator's input.
// Per voxel g = (x_w, y_h, z_d) of the D x H x W grid (coordinates
// 2 i / (n - 1) - 1) and per candidate k = 0..K it writes the heatmap
// (0 for k = 0, else G(g - kp_d[k]) - G(g - kp_s[k]) with the separable
// gaussian exp(-d^2 / 0.02) per axis) and the C channels of the compressed
// volume sampled at g (k = 0) or g - kp_d[k] + kp_s[k], trilinear with
// align_corners=True and zero padding, to channel k * (1 + C) + j of an
// NCDHW output, the layout the estimator's first Conv3d reads.
//
// K5b torso_warp_volume replaces models/torso.py WarpGenerator lines 500-505
// (ops/grid_sample.py grid_sample_3d_packed, border padding) and the C-major
// depth fold: it samples the C-channel appearance volume at the dense
// deformation, border padding (the continuous coordinate is clamped to
// [0, n - 1] before the weights are computed, torch's clip_coordinates),
// and writes channel c * D + d of an NCHW [B, C*D, H, W] output, the input
// of the generator's first Conv2d.
//
// What bounds them on an H100: bytes. Both volumes are small (K5a reads a
// 1 MB channels-last [16,64,64,4] volume, K5b an 8 MB [16,64,64,32] one),
// so every corner row comes from L2 after its first touch; the outputs
// (6.5 MB and 8 MB) are written once. The TPU needed the cell packing
// because its gather unit is transaction-bound on 16-32 B rows; here a
// corner of the channels-last volume is one 16 B (C = 4) or 128 B (C = 32)
// contiguous row, read as float4 loads. Design: one thread per voxel,
// looping over the candidates (K5a) or carrying all C channels in registers
// (K5b); neighbouring threads take neighbouring w, so the strided NCDHW /
// NCHW stores of each channel are coalesced, and the transpose the JAX
// code runs as a separate pass costs nothing.
#include "common.cuh"

namespace {

// torch grid_sample unnormalisation with align_corners=True
__device__ __forceinline__ float unnorm_ac(float c, int n) {
  return (c + 1.0f) / 2.0f * (float)(n - 1);
}

// acc[0..C) += trilinear sample of a channels-last [D,H,W,C] volume at
// voxel coordinates (x, y, z); corners outside the volume weigh nothing.
template <int C>
__device__ __forceinline__ void trilinear_add(float* acc, const float* vol, int D,
                                              int H, int W, float x, float y, float z) {
  float x0 = floorf(x), y0 = floorf(y), z0 = floorf(z);
  float wx1 = x - x0, wy1 = y - y0, wz1 = z - z0;
  float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1, wz0 = 1.0f - wz1;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    float zi = z0 + (float)dz;
    if (zi < 0.0f || zi > (float)(D - 1)) continue;
    float wz = dz ? wz1 : wz0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      float yi = y0 + (float)dy;
      if (yi < 0.0f || yi > (float)(H - 1)) continue;
      float wy = dy ? wy1 : wy0;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        float xi = x0 + (float)dx;
        if (xi < 0.0f || xi > (float)(W - 1)) continue;
        float wgt = (dx ? wx1 : wx0) * wy * wz;
        const float4* row = reinterpret_cast<const float4*>(
            vol + (((long long)zi * H + (long long)yi) * W + (long long)xi) * C);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          float4 v = __ldg(row + q);
          acc[4 * q + 0] += v.x * wgt;
          acc[4 * q + 1] += v.y * wgt;
          acc[4 * q + 2] += v.z * wgt;
          acc[4 * q + 3] += v.w * wgt;
        }
      }
    }
  }
}

// separable keypoint gaussian, variance 0.01: exp(-0.5 d^2 / 0.01) per axis
__device__ __forceinline__ float gauss1(float g, float k) {
  float d = g - k;
  return expf(-0.5f * (d * d) / 0.01f);
}

template <int C>
__global__ void __launch_bounds__(256)
deform_input_kernel(const float* __restrict__ vol, const float* __restrict__ kp_s,
                    const float* __restrict__ kp_d, int B, int K, int D, int H, int W,
                    float* __restrict__ out) {
  long long vox = (long long)D * H * W;
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * vox) return;
  int b = (int)(n / vox);
  long long r = n - (long long)b * vox;
  int d = (int)(r / ((long long)H * W));
  int hw = (int)(r - (long long)d * H * W);
  int h = hw / W, w = hw - (hw / W) * W;
  float gx = 2.0f * ((float)w / (float)(W - 1)) - 1.0f;
  float gy = 2.0f * ((float)h / (float)(H - 1)) - 1.0f;
  float gz = 2.0f * ((float)d / (float)(D - 1)) - 1.0f;

  const float* vb = vol + (long long)b * vox * C;
  float* ob = out + (long long)b * (K + 1) * (1 + C) * vox + r;
  for (int k = 0; k <= K; ++k) {
    float sx = gx, sy = gy, sz = gz, heat = 0.0f;
    if (k > 0) {
      const float* pd = kp_d + ((long long)b * K + (k - 1)) * 3;
      const float* ps = kp_s + ((long long)b * K + (k - 1)) * 3;
      sx = (gx - pd[0]) + ps[0];
      sy = (gy - pd[1]) + ps[1];
      sz = (gz - pd[2]) + ps[2];
      float hd = gauss1(gz, pd[2]) * gauss1(gy, pd[1]) * gauss1(gx, pd[0]);
      float hs = gauss1(gz, ps[2]) * gauss1(gy, ps[1]) * gauss1(gx, ps[0]);
      heat = hd - hs;
    }
    float acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.0f;
    trilinear_add<C>(acc, vb, D, H, W, unnorm_ac(sx, W), unnorm_ac(sy, H),
                     unnorm_ac(sz, D));
    float* ok = ob + (long long)k * (1 + C) * vox;
    ok[0] = heat;
#pragma unroll
    for (int j = 0; j < C; ++j) ok[(long long)(1 + j) * vox] = acc[j];
  }
}

template <int C>
__global__ void __launch_bounds__(128)
warp_volume_kernel(const float* __restrict__ vol, const float* __restrict__ grid, int B,
                   int D, int H, int W, float* __restrict__ out) {
  long long vox = (long long)D * H * W;
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * vox) return;
  int b = (int)(n / vox);
  long long r = n - (long long)b * vox;
  int d = (int)(r / ((long long)H * W));
  long long hw = r - (long long)d * H * W;

  const float* g = grid + n * 3;
  // border padding: clamp the continuous coordinate, then weigh the corners
  float x = fminf(fmaxf(unnorm_ac(g[0], W), 0.0f), (float)(W - 1));
  float y = fminf(fmaxf(unnorm_ac(g[1], H), 0.0f), (float)(H - 1));
  float z = fminf(fmaxf(unnorm_ac(g[2], D), 0.0f), (float)(D - 1));
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  trilinear_add<C>(acc, vol + (long long)b * vox * C, D, H, W, x, y, z);

  // NCHW [B, C*D, H, W], channel c * D + d
  float* ob = out + (long long)b * C * vox + (long long)d * H * W + hw;
#pragma unroll
  for (int c = 0; c < C; ++c) ob[(long long)c * vox] = acc[c];
}

template <int C>
int launch_deform(const float* vol, const float* kp_s, const float* kp_d, int B, int K,
                  int D, int H, int W, float* out, cudaStream_t stream) {
  long long total = (long long)B * D * H * W;
  if (total > 0)
    deform_input_kernel<C><<<r3dp_blocks(total, 256), 256, 0, stream>>>(
        vol, kp_s, kp_d, B, K, D, H, W, out);
  return (int)cudaGetLastError();
}

template <int C>
int launch_warp(const float* vol, const float* grid, int B, int D, int H, int W,
                float* out, cudaStream_t stream) {
  long long total = (long long)B * D * H * W;
  if (total > 0)
    warp_volume_kernel<C><<<r3dp_blocks(total, 128), 128, 0, stream>>>(vol, grid, B, D,
                                                                       H, W, out);
  return (int)cudaGetLastError();
}

}  // namespace

// vol [B,D,H,W,4] fp32 channels-last (the estimator's compressed width);
// kp_s, kp_d [B,K,3]; out [B,(K+1)*5,D,H,W]. D, H, W >= 2.
R3DP_EXPORT int r3dp_torso_deform_input(const float* vol, const float* kp_s,
                                        const float* kp_d, int B, int K, int D, int H,
                                        int W, int C, float* out, cudaStream_t stream) {
  if (C != 4) return (int)cudaErrorInvalidValue;
  return launch_deform<4>(vol, kp_s, kp_d, B, K, D, H, W, out, stream);
}

// vol [B,D,H,W,C] fp32 channels-last, C = 32 (released preset) or 4 (tiny);
// grid [B,D,H,W,3] (x, y, z) in [-1,1]; out [B,C*D,H,W]. D, H, W >= 2.
R3DP_EXPORT int r3dp_torso_warp_volume(const float* vol, const float* grid, int B, int D,
                                       int H, int W, int C, float* out,
                                       cudaStream_t stream) {
  if (C == 32) return launch_warp<32>(vol, grid, B, D, H, W, out, stream);
  if (C == 4) return launch_warp<4>(vol, grid, B, D, H, W, out, stream);
  return (int)cudaErrorInvalidValue;
}
