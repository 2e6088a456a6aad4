// K1 triplane_decode and K1-trigrid trigrid_decode: fused plane sample +
// plane mean + OSG decoder MLP, for tri-planes [B,3,H,W,32] and tri-grids
// [B,3,D,H,W,32].
//
// K1 replaces, in the JAX package: rendering/renderer.py make_packed_sampler
// (ops/grid_sample.py pack_xy_cells + grid_sample_2d_prepacked, the 2x2 cell
// packing that makes one wide gather row per corner on the TPU) and
// models/decoder.py OSGDecoder.__call__ (two equalised-LR dense layers).
// K1-trigrid replaces rendering/renderer.py sample_from_trigrids and the
// tri-grid branch of make_packed_sampler (ops/grid_sample.py
// grid_sample_3d_prepacked4: one packed 4C row per z corner) with the same
// decoder.
//
// Per point: project xyz onto the three planes ((x,y | z), (x,z | y),
// (z,x | y)); bilinear (tri-plane) or trilinear (tri-grid, the third
// coordinate indexing the depth axis D) lookup of C = 32 channels with
// align_corners=False and zero padding, each corner masked on its own;
// mean over the planes, FC 32->64, softplus, FC 64->33; sigma = channel 0,
// rgb = sigmoid(channels 1..32) * 1.002 - 0.001.
//
// What bounds them on an H100: the fp32 operations. Per point the MLP
// costs 2 x (32x64 + 64x33) + ~100 = ~8.4k operations and the corner
// lerps 3 x 4 x 32 x 2 (K1) or 3 x 8 x 32 x 2 (K1-trigrid), ~9.2k or
// ~10k in all: at 786k points 0.11-0.12 ms on the fp32 peak, against
// ~0.02 ms to read the planes once from HBM. The gathers come second:
// 3 planes x 4 or 8 corners of one 128 B row each, 1.5 or 3 KB per point
// of L2 traffic; a tri-plane set of one frame (3 x 256 x 256 x 32 fp32 =
// 25 MB) fits in the 50 MB L2, a depth-3 tri-grid (75.5 MB) does not, yet
// a tri-grid point costs only ~1.3x a tri-plane one on the card. Design:
// one thread per point; the planes stay channels-last so each corner is one
// contiguous 128 B row read as eight float4 loads; the folded MLP weights
// (17 KB) sit in shared memory, where every lane of a warp reads the same
// address (a broadcast, no bank conflicts), and the 32-wide feature and
// 64-wide hidden vectors live in registers, so nothing between the sample
// and the decoder output touches device memory. A tri-grid point visits
// only the depth slices its two z corners fall in, so the extra cost over
// K1 is the second slice's four rows.
#include "common.cuh"

namespace {

constexpr int kC = 32;    // plane channels
constexpr int kHid = 64;  // decoder hidden width
constexpr int kOut = 33;  // 1 density + 32 feature channels

struct DecoderSmem {
  float w0[kHid * kC];
  float b0[kHid];
  float w1[kOut * kHid];
  float b1[kOut];
};

__device__ __forceinline__ void load_decoder(DecoderSmem& s, const float* w0,
                                             const float* b0, const float* w1,
                                             const float* b1) {
  for (int i = threadIdx.x; i < kHid * kC; i += blockDim.x) s.w0[i] = w0[i];
  for (int i = threadIdx.x; i < kOut * kHid; i += blockDim.x) s.w1[i] = w1[i];
  for (int i = threadIdx.x; i < kHid; i += blockDim.x) s.b0[i] = b0[i];
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) s.b1[i] = b1[i];
  __syncthreads();
}

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

// Four corners of one [H,W,32] slice at the unnormalised (x, y), each
// weight scaled by wz (1 for a tri-plane, the z corner's weight for a
// tri-grid slice).
__device__ __forceinline__ void sample_slice(float* feat, const float* plane,
                                             int H, int W, float x, float y,
                                             float wz) {
  float x0 = floorf(x), y0 = floorf(y);
  float wx1 = x - x0, wy1 = y - y0;
  float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  add_corner(feat, plane, H, W, x0, y0, wx0 * wy0 * wz);
  add_corner(feat, plane, H, W, x0 + 1.0f, y0, wx1 * wy0 * wz);
  add_corner(feat, plane, H, W, x0, y0 + 1.0f, wx0 * wy1 * wz);
  add_corner(feat, plane, H, W, x0 + 1.0f, y0 + 1.0f, wx1 * wy1 * wz);
}

// torch grid_sample unnormalisation with align_corners=False
__device__ __forceinline__ float unnormalise(float u, int size) {
  return ((u + 1.0f) * size - 1.0f) / 2.0f;
}

// Bilinear lookup of one [H,W,32] plane at (u, v) in [-1, 1].
__device__ __forceinline__ void sample_plane(float* feat, const float* plane,
                                             int H, int W, float u, float v) {
  sample_slice(feat, plane, H, W, unnormalise(u, W), unnormalise(v, H), 1.0f);
}

// Trilinear lookup of one [D,H,W,32] grid at (u, v, t) in [-1, 1]: u
// indexes W, v H, t D; a z corner outside [0, D-1] adds nothing.
__device__ __forceinline__ void sample_grid(float* feat, const float* grid,
                                            int D, int H, int W, float u,
                                            float v, float t) {
  float x = unnormalise(u, W), y = unnormalise(v, H), z = unnormalise(t, D);
  float z0 = floorf(z);
  float wz1 = z - z0, wz0 = 1.0f - wz1;
  long long slice = (long long)H * W * kC;
  if (z0 >= 0.0f && z0 <= (float)(D - 1))
    sample_slice(feat, grid + (long long)z0 * slice, H, W, x, y, wz0);
  if (z0 + 1.0f >= 0.0f && z0 + 1.0f <= (float)(D - 1))
    sample_slice(feat, grid + ((long long)z0 + 1) * slice, H, W, x, y, wz1);
}

// Plane mean, MLP and the two outputs of point n.
__device__ __forceinline__ void decode_point(float* feat, const DecoderSmem& s,
                                             long long n, float* rgb,
                                             float* sigma) {
#pragma unroll
  for (int c = 0; c < kC; ++c) feat[c] = feat[c] / 3.0f;

  float hid[kHid];
#pragma unroll
  for (int j = 0; j < kHid; ++j) {
    float acc = s.b0[j];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc += feat[c] * s.w0[j * kC + c];
    hid[j] = r3dp_softplus(acc);
  }

  float* rgb_row = rgb + n * (kOut - 1);
#pragma unroll 1
  for (int o = 0; o < kOut; ++o) {
    float acc = s.b1[o];
#pragma unroll
    for (int j = 0; j < kHid; ++j) acc += hid[j] * s.w1[o * kHid + j];
    if (o == 0)
      sigma[n] = acc;
    else
      rgb_row[o - 1] = r3dp_sigmoid(acc) * (1.0f + 2.0f * 0.001f) - 0.001f;
  }
}

// D = 0 marks tri-planes [B,3,H,W,32]; D >= 1 tri-grids [B,3,D,H,W,32].
__global__ void __launch_bounds__(128)
plane_decode_kernel(const float* __restrict__ planes, int B, int D, int H,
                    int W, const float* __restrict__ coords,
                    long long n_per_batch, float coord_scale,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    float* __restrict__ rgb, float* __restrict__ sigma) {
  __shared__ DecoderSmem s;
  load_decoder(s, w0, b0, w1, b1);

  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * n_per_batch) return;
  long long b = n / n_per_batch;

  float px = coords[3 * n + 0] * coord_scale;
  float py = coords[3 * n + 1] * coord_scale;
  float pz = coords[3 * n + 2] * coord_scale;

  float feat[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) feat[c] = 0.0f;
  long long plane_elems = (long long)(D > 0 ? D : 1) * H * W * kC;
  const float* base = planes + b * 3 * plane_elems;
  if (D == 0) {
    sample_plane(feat, base, H, W, px, py);                    // (x, y)
    sample_plane(feat, base + plane_elems, H, W, px, pz);      // (x, z)
    sample_plane(feat, base + 2 * plane_elems, H, W, pz, px);  // (z, x)
  } else {
    sample_grid(feat, base, D, H, W, px, py, pz);                    // (x, y | z)
    sample_grid(feat, base + plane_elems, D, H, W, px, pz, py);      // (x, z | y)
    sample_grid(feat, base + 2 * plane_elems, D, H, W, pz, px, py);  // (z, x | y)
  }
  decode_point(feat, s, n, rgb, sigma);
}

int launch(const float* planes, int B, int D, int H, int W, const float* coords,
           long long n_per_batch, float coord_scale, const float* w0,
           const float* b0, const float* w1, const float* b1, float* rgb,
           float* sigma, cudaStream_t stream) {
  const int threads = 128;
  long long total = (long long)B * n_per_batch;
  if (total > 0)
    plane_decode_kernel<<<r3dp_blocks(total, threads), threads, 0, stream>>>(
        planes, B, D, H, W, coords, n_per_batch, coord_scale, w0, b0, w1, b1,
        rgb, sigma);
  return (int)cudaGetLastError();
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
  return launch(planes, B, 0, H, W, coords, n_per_batch, coord_scale, w0, b0,
                w1, b1, rgb, sigma, stream);
}

// The same with tri-grids [B,3,D,H,W,32], D >= 1.
R3DP_EXPORT int r3dp_trigrid_decode(const float* planes, int B, int D, int H,
                                    int W, const float* coords,
                                    long long n_per_batch, float coord_scale,
                                    const float* w0, const float* b0,
                                    const float* w1, const float* b1,
                                    float* rgb, float* sigma,
                                    cudaStream_t stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  return launch(planes, B, D, H, W, coords, n_per_batch, coord_scale, w0, b0,
                w1, b1, rgb, sigma, stream);
}

R3DP_EXPORT const char* r3dp_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
