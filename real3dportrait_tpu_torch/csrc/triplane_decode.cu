// K1 triplane_decode: fused tri-plane sample + plane mean + OSG decoder MLP.
//
// Replaces, in the JAX package: rendering/renderer.py make_packed_sampler
// (ops/grid_sample.py pack_xy_cells + grid_sample_2d_prepacked, the 2x2 cell
// packing that makes one wide gather row per corner on the TPU) and
// models/decoder.py OSGDecoder.__call__ (two equalised-LR dense layers).
//
// Per point: project xyz onto the three planes ((x,y), (x,z), (z,x)),
// bilinear lookup of C = 32 channels with align_corners=False and zero
// padding, mean over the planes, FC 32->64, softplus, FC 64->33;
// sigma = channel 0, rgb = sigmoid(channels 1..32) * 1.002 - 0.001.
//
// What bounds it on an H100: the gathers. Each point reads 3 planes x 4
// corners = 12 rows of 32 fp32 = 128 B, about 1.5 KB, against ~4.2k FMAs of
// MLP. The planes of one frame (3 x 256 x 256 x 32 fp32 = 25 MB) fit in the
// 50 MB L2, so the rows come from L2, not HBM, and the kernel is bound by
// L2 gather bandwidth. Design: one thread per point; the planes stay
// channels-last so each corner is one contiguous 128 B row read as eight
// float4 loads; the folded MLP weights (17 KB) sit in shared memory, where
// every lane of a warp reads the same address (a broadcast, no bank
// conflicts), and the 32-wide feature and 64-wide hidden vectors live in
// registers, so nothing between the sample and the decoder output touches
// device memory.
#include "common.cuh"

namespace {

constexpr int kC = 32;    // plane channels
constexpr int kHid = 64;  // decoder hidden width
constexpr int kOut = 33;  // 1 density + 32 feature channels

__device__ __forceinline__ void add_corner(float* feat, const float* plane,
                                           int H, int W, float xi, float yi,
                                           float wgt) {
  if (xi < 0.0f || xi > (float)(W - 1) || yi < 0.0f || yi > (float)(H - 1))
    return;
  const float4* row = reinterpret_cast<const float4*>(
      plane + ((long long)yi * W + (long long)xi) * kC);
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    float4 v = __ldg(row + q);
    feat[4 * q + 0] += v.x * wgt;
    feat[4 * q + 1] += v.y * wgt;
    feat[4 * q + 2] += v.z * wgt;
    feat[4 * q + 3] += v.w * wgt;
  }
}

__device__ __forceinline__ void sample_plane(float* feat, const float* plane,
                                             int H, int W, float u, float v) {
  // torch grid_sample unnormalisation with align_corners=False
  float x = ((u + 1.0f) * W - 1.0f) / 2.0f;
  float y = ((v + 1.0f) * H - 1.0f) / 2.0f;
  float x0 = floorf(x), y0 = floorf(y);
  float wx1 = x - x0, wy1 = y - y0;
  float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  add_corner(feat, plane, H, W, x0, y0, wx0 * wy0);
  add_corner(feat, plane, H, W, x0 + 1.0f, y0, wx1 * wy0);
  add_corner(feat, plane, H, W, x0, y0 + 1.0f, wx0 * wy1);
  add_corner(feat, plane, H, W, x0 + 1.0f, y0 + 1.0f, wx1 * wy1);
}

__global__ void __launch_bounds__(128)
triplane_decode_kernel(const float* __restrict__ planes, int B, int H, int W,
                       const float* __restrict__ coords, long long n_per_batch,
                       float coord_scale, const float* __restrict__ w0,
                       const float* __restrict__ b0, const float* __restrict__ w1,
                       const float* __restrict__ b1, float* __restrict__ rgb,
                       float* __restrict__ sigma) {
  __shared__ float s_w0[kHid * kC];
  __shared__ float s_b0[kHid];
  __shared__ float s_w1[kOut * kHid];
  __shared__ float s_b1[kOut];
  for (int i = threadIdx.x; i < kHid * kC; i += blockDim.x) s_w0[i] = w0[i];
  for (int i = threadIdx.x; i < kOut * kHid; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < kHid; i += blockDim.x) s_b0[i] = b0[i];
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) s_b1[i] = b1[i];
  __syncthreads();

  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * n_per_batch) return;
  long long b = n / n_per_batch;

  float px = coords[3 * n + 0] * coord_scale;
  float py = coords[3 * n + 1] * coord_scale;
  float pz = coords[3 * n + 2] * coord_scale;

  float feat[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) feat[c] = 0.0f;
  long long plane_elems = (long long)H * W * kC;
  const float* base = planes + b * 3 * plane_elems;
  sample_plane(feat, base, H, W, px, py);                    // plane 0: (x, y)
  sample_plane(feat, base + plane_elems, H, W, px, pz);      // plane 1: (x, z)
  sample_plane(feat, base + 2 * plane_elems, H, W, pz, px);  // plane 2: (z, x)
#pragma unroll
  for (int c = 0; c < kC; ++c) feat[c] = feat[c] / 3.0f;

  float hid[kHid];
#pragma unroll
  for (int j = 0; j < kHid; ++j) {
    float acc = s_b0[j];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc += feat[c] * s_w0[j * kC + c];
    hid[j] = r3dp_softplus(acc);
  }

  float* rgb_row = rgb + n * (kOut - 1);
#pragma unroll 1
  for (int o = 0; o < kOut; ++o) {
    float acc = s_b1[o];
#pragma unroll
    for (int j = 0; j < kHid; ++j) acc += hid[j] * s_w1[o * kHid + j];
    if (o == 0)
      sigma[n] = acc;
    else
      rgb_row[o - 1] = r3dp_sigmoid(acc) * (1.0f + 2.0f * 0.001f) - 0.001f;
  }
}

}  // namespace

// planes [B,3,H,W,32] fp32 contiguous; coords [B,n_per_batch,3];
// w0 [64,32], b0 [64], w1 [33,64], b1 [33] with the equalised-LR gains
// already folded in; rgb [B*n_per_batch,32], sigma [B*n_per_batch].
R3DP_EXPORT int r3dp_triplane_decode(const float* planes, int B, int H, int W,
                                     const float* coords, long long n_per_batch,
                                     float coord_scale, const float* w0,
                                     const float* b0, const float* w1,
                                     const float* b1, float* rgb, float* sigma,
                                     cudaStream_t stream) {
  const int threads = 128;
  long long total = (long long)B * n_per_batch;
  if (total > 0)
    triplane_decode_kernel<<<r3dp_blocks(total, threads), threads, 0, stream>>>(
        planes, B, H, W, coords, n_per_batch, coord_scale, w0, b0, w1, b1, rgb,
        sigma);
  return (int)cudaGetLastError();
}

R3DP_EXPORT const char* r3dp_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
