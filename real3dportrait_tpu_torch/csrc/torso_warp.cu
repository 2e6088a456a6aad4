// K5 torso warps: the two trilinear warps of the keypoint-driven torso model.
//
// K5a torso_deform_input replaces, in the JAX package, models/torso.py
// MotionFieldEstimator lines 378-390: kp2gaussian_3d for the source and
// driving keypoints, create_sparse_motions, create_deformed_source_image
// (ops/grid_sample.py pack_trigrid_cells + grid_sample_3d_prepacked, the
// TPU's packing of each 2x2x2 cell into one wide gather row, shared by the
// K+1 candidates) and the concat/transpose into the estimator's input.
// Per voxel g = (x_w, y_h, z_d) of the D x H x W grid and per candidate
// k = 0..K it writes the heatmap (0 for k = 0, else G(g - kp_d[k]) -
// G(g - kp_s[k]) with the separable gaussian exp(-0.5 d^2 / 0.01) per axis)
// and the C = 4 channels of the compressed volume sampled at g (k = 0) or
// g - kp_d[k] + kp_s[k], trilinear with align_corners=True and zero
// padding, to channel k * (1 + C) + j of an NCDHW output, the layout the
// estimator's first Conv3d reads.
//
// K5b torso_warp_volume replaces models/torso.py WarpGenerator lines 500-505
// (ops/grid_sample.py grid_sample_3d_packed, border padding) and the C-major
// depth fold: it samples the C-channel appearance volume at the dense
// deformation, border padding (the continuous coordinate is clamped to
// [0, n - 1] before the weights are computed, torch's clip_coordinates),
// and writes channel c * D + d of an NCHW [B, C*D, H, W] output, the input
// of the generator's first Conv2d.
//
// What bounds them on an H100: bytes. K5a reads a 1 MB channels-last
// [16,64,64,4] volume and writes 6.5 MB; K5b reads an 8 MB [16,64,64,32]
// volume and a 0.8 MB deformation and writes 8 MB. Every corner row comes
// from L2 or L1 after its first touch, so what the card has to keep up is
// the latency of those reads: enough of them in flight, each fetching whole
// lines, and stores of whole lines. At a deformation uniform over the
// volume each K5b voxel reads 8 corner lines of 128 B that no neighbour
// shares, 64 MB from L2 a launch: there L2's rate bounds it.
//
// K5b: a CTA owns a 32-voxel tile of one (b, d, h) row along w and all C
// channels. Each voxel's clamped coordinate, corner steps and 8 weights are
// computed once, by one thread, into shared memory. For C = 32, 8 lanes
// share a voxel and each reads its 16 B quarter of the voxel's 128 B
// corner row, so one warp-wide load fetches 4 voxels' rows as 4 whole
// lines; all 8 corners are loaded before the FMAs. The sums go through a
// padded shared tile [C][33] and leave as rows c*D + d of the NCHW fold,
// 16 B a lane where W is a multiple of 4. 256 threads at 32 registers, 8
// CTAs an SM: the 1024 CTAs of [1,16,64,64] run as one wave. For C = 4
// (the tiny preset) a lane is a voxel, one float4 a corner, and stores its
// 4 channels straight out, lanes along w.
//
// K5a: one thread per (voxel, candidate), lanes along w, two warps a
// candidate of a 64-voxel tile; a CTA holds min(K + 1, 8) candidates and
// `rows` rows h (models/torso.py torso_deform_plan), the ragged lanes past
// W computing the last voxel and storing nothing. The gaussians are
// separable: each lane computes the x factors of its voxel once for its
// rows, and the warp's table of z * y factors (uniform over a row) sits one
// entry a lane, (row, driving or source), read by shuffle: 4 exps a thread
// for all its rows, none a voxel, no shared memory and no barrier. A
// candidate's 1 + C stores are one 128 B line a warp each. The grid
// coordinates and gaussians are rounded as torch rounds them on the card
// (the division by the scalar n - 1 a multiply by fp32(1 / (n - 1)), `* 2`
// and `- 1` apart, the division by the variance a multiply by
// fp32(1 / 0.01) = 100, products gz gy gx, driving minus source), with no
// contraction into FMAs, so the kernel gives the plain version's values.
#include "common.cuh"

namespace {

constexpr int kDeformTile = 64;  // K5a: voxels along w of a CTA, two warps
constexpr int kWarpTile = 32;    // K5b: voxels along w of a CTA

// torch grid_sample unnormalisation with align_corners=True
__device__ __forceinline__ float unnorm_ac(float c, int n) {
  return (c + 1.0f) / 2.0f * (float)(n - 1);
}

// 2 * (i / (n - 1)) - 1 as torch evaluates it on the card; inv is
// fp32(1 / (n - 1))
__device__ __forceinline__ float grid_axis(int i, float inv) {
  return __fsub_rn(__fmul_rn(2.0f, __fmul_rn((float)i, inv)), 1.0f);
}

// kp2gaussian_3d's factor exp(-0.5 (a - kp)^2 / 0.01) with torch's roundings
__device__ __forceinline__ float gauss1(float a, float kp) {
  float t = __fsub_rn(a, kp);
  return expf(__fmul_rn(__fmul_rn(-0.5f, __fmul_rn(t, t)), 100.0f));
}

// one axis of a zero-padded trilinear sample: the two corners' indices,
// clamped into [0, n) (a corner outside weighs 0, so its clamped read adds
// nothing), and their weights as torch computes them, (f + 1) - x and x - f
struct Lerp {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Lerp lerp_zeros(float c, int n) {
  float x = unnorm_ac(c, n);
  float f = floorf(x), top = (float)(n - 1);
  Lerp l;
  l.w0 = (f >= 0.0f && f <= top) ? __fsub_rn(f + 1.0f, x) : 0.0f;
  l.w1 = (f + 1.0f >= 0.0f && f + 1.0f <= top) ? __fsub_rn(x, f) : 0.0f;
  l.i0 = (int)fminf(fmaxf(f, 0.0f), top);
  l.i1 = (int)fminf(fmaxf(f + 1.0f, 0.0f), top);
  return l;
}

// acc = sum over the corners, in torch's order (z, then y, then x, low
// corner first), of value * ((wx * wy) * wz), each term one FMA
__device__ __forceinline__ float4 lerp_corners(const float4 (&v)[8], const float (&w)[8]) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc.x = fmaf(v[i].x, w[i], acc.x);
    acc.y = fmaf(v[i].y, w[i], acc.y);
    acc.z = fmaf(v[i].z, w[i], acc.z);
    acc.w = fmaf(v[i].w, w[i], acc.w);
  }
  return acc;
}

__device__ __forceinline__ void corner_weights(float (&w)[8], float x0, float x1, float y0,
                                               float y1, float z0, float z1) {
  w[0] = __fmul_rn(__fmul_rn(x0, y0), z0);
  w[1] = __fmul_rn(__fmul_rn(x1, y0), z0);
  w[2] = __fmul_rn(__fmul_rn(x0, y1), z0);
  w[3] = __fmul_rn(__fmul_rn(x1, y1), z0);
  w[4] = __fmul_rn(__fmul_rn(x0, y0), z1);
  w[5] = __fmul_rn(__fmul_rn(x1, y0), z1);
  w[6] = __fmul_rn(__fmul_rn(x0, y1), z1);
  w[7] = __fmul_rn(__fmul_rn(x1, y1), z1);
}

// K5a. blockDim (kDeformTile, cand); grid (ceil(W / kDeformTile), ceil(H / rows),
// B * D); rows <= 16.
__global__ void __launch_bounds__(512)
deform_input_kernel(const float4* __restrict__ vol, const float* __restrict__ kp_s,
                    const float* __restrict__ kp_d, int K, int D, int H, int W, int rows,
                    float* __restrict__ out) {
  const int bd = blockIdx.z, b = bd / D, d = bd - b * D;
  const int h0 = blockIdx.y * rows, nrows = min(rows, H - h0);
  // lanes past W compute the last voxel's values (they take part in the
  // shuffles) and store nothing
  const int w = blockIdx.x * kDeformTile + threadIdx.x, wc = min(w, W - 1);
  const int lane = threadIdx.x & 31, hw = H * W;
  const float inv_h = __frcp_rn((float)(H - 1));
  const float gx = grid_axis(wc, __frcp_rn((float)(W - 1)));
  const float gz = grid_axis(d, __frcp_rn((float)(D - 1)));
  const float4* vb = vol + (long long)b * D * hw;
  const long long vox = (long long)D * hw;
  for (int k = threadIdx.y; k <= K; k += blockDim.y) {
    float kd[3] = {0.0f, 0.0f, 0.0f}, ks[3] = {0.0f, 0.0f, 0.0f};
    float hxd = 0.0f, hxs = 0.0f, gzy = 0.0f, sx = gx, sz = gz;
    if (k > 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        kd[a] = __ldg(kp_d + (b * K + k - 1) * 3 + a);
        ks[a] = __ldg(kp_s + (b * K + k - 1) * 3 + a);
      }
      // the table of the warp's rows: lane 2 r + s holds gz * gy of row
      // h0 + r for the driving (s = 0) or source (s = 1) keypoint
      const bool src = lane & 1;
      const float gy = grid_axis(min(h0 + (lane >> 1), H - 1), inv_h);
      gzy = __fmul_rn(gauss1(gz, src ? ks[2] : kd[2]), gauss1(gy, src ? ks[1] : kd[1]));
      hxd = gauss1(gx, kd[0]);
      hxs = gauss1(gx, ks[0]);
      sx = __fadd_rn(__fsub_rn(gx, kd[0]), ks[0]);
      sz = __fadd_rn(__fsub_rn(gz, kd[2]), ks[2]);
    }
    const Lerp lx = lerp_zeros(sx, W), lz = lerp_zeros(sz, D);
    const int z0 = lz.i0 * hw, z1 = lz.i1 * hw;
    float* ok = out + (long long)(b * (K + 1) + k) * 5 * vox + d * hw + w;
    for (int r = 0; r < nrows; ++r) {
      const int h = h0 + r;
      const float gy = grid_axis(h, inv_h);
      const Lerp ly = lerp_zeros(k > 0 ? __fadd_rn(__fsub_rn(gy, kd[1]), ks[1]) : gy, H);
      const int y0 = ly.i0 * W, y1 = ly.i1 * W;
      const float4 v[8] = {__ldg(vb + z0 + y0 + lx.i0), __ldg(vb + z0 + y0 + lx.i1),
                           __ldg(vb + z0 + y1 + lx.i0), __ldg(vb + z0 + y1 + lx.i1),
                           __ldg(vb + z1 + y0 + lx.i0), __ldg(vb + z1 + y0 + lx.i1),
                           __ldg(vb + z1 + y1 + lx.i0), __ldg(vb + z1 + y1 + lx.i1)};
      const float gzy_d = __shfl_sync(0xffffffffu, gzy, 2 * r);
      const float gzy_s = __shfl_sync(0xffffffffu, gzy, 2 * r + 1);
      const float heat = k > 0 ? __fsub_rn(__fmul_rn(gzy_d, hxd), __fmul_rn(gzy_s, hxs)) : 0.0f;
      float wgt[8];
      corner_weights(wgt, lx.w0, lx.w1, ly.w0, ly.w1, lz.w0, lz.w1);
      const float4 acc = lerp_corners(v, wgt);
      if (w < W) {
        float* o = ok + h * W;
        o[0] = heat;
        o[vox] = acc.x;
        o[2 * vox] = acc.y;
        o[3 * vox] = acc.z;
        o[4 * vox] = acc.w;
      }
    }
  }
}

// K5b's CTA: a tile of kWarpTile voxels, C / 4 lanes a voxel (one float4
// of channels each): C = 32, 256 threads; C = 4, one warp.
template <int C>
struct WarpTile {
  static constexpr int kLanes = C / 4;
  static constexpr int kThreads = kWarpTile * kLanes;
  static constexpr int kMinBlocks = 2048 / kThreads < 32 ? 2048 / kThreads : 32;
};

// K5b. grid (ceil(W / kWarpTile), H, B * D); 8 CTAs of 256 threads an SM
// for C = 32 (32 registers).
template <int C>
__global__ void __launch_bounds__(WarpTile<C>::kThreads, WarpTile<C>::kMinBlocks)
warp_volume_kernel(const float4* __restrict__ vol, const float* __restrict__ grid, int D,
                   int H, int W, float* __restrict__ out) {
  using T = WarpTile<C>;
  __shared__ float4 s_wgt[kWarpTile][2];
  __shared__ int4 s_step[kWarpTile];  // first corner, x, y and z steps, in float4s
  __shared__ float s_out[C == 32 ? C : 1][kWarpTile + 1];
  const int bd = blockIdx.z, b = bd / D, d = bd - b * D, h = blockIdx.y;
  const int w0 = blockIdx.x * kWarpTile, t = threadIdx.x;
  const int nvox = min(kWarpTile, W - w0);
  const long long hw = (long long)H * W, vox = D * hw;

  // each voxel's clamped coordinate, corner steps and weights, once
  if (t < kWarpTile) {
    float wgt[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int4 step = make_int4(0, 0, 0, 0);
    if (t < nvox) {
      const float* g = grid + ((bd * (long long)H + h) * W + w0 + t) * 3;
      // border padding: clamp the continuous coordinate, then weigh
      const float x = fminf(fmaxf(unnorm_ac(g[0], W), 0.0f), (float)(W - 1));
      const float y = fminf(fmaxf(unnorm_ac(g[1], H), 0.0f), (float)(H - 1));
      const float z = fminf(fmaxf(unnorm_ac(g[2], D), 0.0f), (float)(D - 1));
      const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
      const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
      // the upper corner past the last voxel weighs x - f = 0: read the
      // lower one again
      step = make_int4(((iz * H + iy) * W + ix) * T::kLanes, ix < W - 1 ? T::kLanes : 0,
                       iy < H - 1 ? W * T::kLanes : 0, iz < D - 1 ? H * W * T::kLanes : 0);
      corner_weights(wgt, __fsub_rn(fx + 1.0f, x), __fsub_rn(x, fx),
                     __fsub_rn(fy + 1.0f, y), __fsub_rn(y, fy), __fsub_rn(fz + 1.0f, z),
                     __fsub_rn(z, fz));
    }
    s_step[t] = step;
    s_wgt[t][0] = make_float4(wgt[0], wgt[1], wgt[2], wgt[3]);
    s_wgt[t][1] = make_float4(wgt[4], wgt[5], wgt[6], wgt[7]);
  }
  __syncthreads();

  const int q = t % T::kLanes, v = t / T::kLanes;
  const int4 s = s_step[v];
  const float4 wa = s_wgt[v][0], wb = s_wgt[v][1];
  const float4* p = vol + b * vox * T::kLanes + s.x + q;
  const float4 c[8] = {__ldg(p), __ldg(p + s.y), __ldg(p + s.z), __ldg(p + s.z + s.y),
                       __ldg(p + s.w), __ldg(p + s.w + s.y), __ldg(p + s.w + s.z),
                       __ldg(p + s.w + s.z + s.y)};
  const float wgt[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  const float4 acc = lerp_corners(c, wgt);
  float* ob = out + ((long long)b * C * D + d) * hw + (long long)h * W + w0;
  if constexpr (C == 4) {
    if (v < nvox) {
      ob[v] = acc.x;
      ob[vox + v] = acc.y;
      ob[2 * vox + v] = acc.z;
      ob[3 * vox + v] = acc.w;
    }
  } else {
    s_out[4 * q + 0][v] = acc.x;
    s_out[4 * q + 1][v] = acc.y;
    s_out[4 * q + 2][v] = acc.z;
    s_out[4 * q + 3][v] = acc.w;
    __syncthreads();
    // rows c * D + d of the fold: 16 B a lane where W keeps them aligned
    if ((W & 3) == 0) {
      const int ch = t / (kWarpTile / 4), x = (t % (kWarpTile / 4)) * 4;
      if (x < nvox)
        *reinterpret_cast<float4*>(ob + ch * vox + x) =
            make_float4(s_out[ch][x], s_out[ch][x + 1], s_out[ch][x + 2], s_out[ch][x + 3]);
    } else {
      for (int i = t; i < C * kWarpTile; i += T::kThreads) {
        const int ch = i / kWarpTile, x = i % kWarpTile;
        if (x < nvox) ob[ch * vox + x] = s_out[ch][x];
      }
    }
  }
}

template <int C>
int launch_warp(const float* vol, const float* grid, int B, int D, int H, int W, float* out,
                cudaStream_t stream) {
  dim3 blocks((W + kWarpTile - 1) / kWarpTile, H, B * D);
  warp_volume_kernel<C><<<blocks, WarpTile<C>::kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(vol), grid, D, H, W, out);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The trilinear adjoints of K5a and K5b (torso_deform_input_backward and
// torso_warp_volume_backward in models/torso.py; the JAX package had
// jax.grad differentiate its gathers). Each recomputes the forward's
// sampling coordinates and corner weights with the forward's roundings and
// scatters the output's gradient into the volume's with 16 B atomics, one
// warp instruction covering 512 contiguous bytes, 4 whole lines. Not a
// gather: a deformation has no inverse map to gather by (K5b), and K5a's
// gather (each destination finding its <= 3 sources an axis) ran slower,
// 0.0281 against 0.0199 ms at the torso step's call, every destination
// reading 8 sources x 4 planar channels through L1.
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W;
// inference/kernel_times.py --only k5ab,k5bb,k5bp):
// - K5b's, x [4,16,64,64,32] at the torso step: its bytes, 0.0319 ms (dout,
//   the volume and the deformation read once, the two gradients written
//   once), but in practice its 16.8 M atomics of 16 B (8 corners a voxel
//   and 4 channels) into the 33.5 MB gradient, which L2 holds. The first
//   design (a thread a voxel looping over its 8 channel quads: a warp
//   instruction touched 32 lines, 16 B of each) took 0.2760 ms a launch,
//   its atomics alone 0.2137, its corner reads with the deformation's
//   gradient alone 0.0898, and the zero fill of its output 0.0109. In this
//   kernel's layout the atomics alone take 0.0784 (the same run): with
//   the fill, 0.0893 of the kernel's 0.1236. At a deformation
//   of 0.05 N(0, 1) (1.6 voxels along w and h) no two voxels of a tile
//   share a corner row, so no on-chip sum can save an atomic; a shared box
//   of the tile's corners, flushed once (tried), was
//   slower at every deformation measured, and issuing the atomics before
//   the corner reads, or 5 CTAs an SM, changed nothing.
// - K5a's, the [4,16,64,64,4] volume and K + 1 = 5 candidates: its bytes,
//   0.0075 ms (dout's 4 sampled channels of each candidate read once, the
//   gradient written once); the first design paid 8 atomics a (voxel,
//   candidate), 0.0345 ms.
//
// K5b's adjoint, warp_volume_adjoint_kernel: the forward's CTA (a 32-voxel
// tile of one (b, d, h) row, C / 4 lanes a voxel, one float4 of channels
// each) and the forward's shared coordinates, corner steps and weights.
// dout's fold rows c * D + d of the tile come in coalesced along w and
// turn through a padded shared tile [C][33]. Each lane issues its 8 corner
// reads, then its 8 atomics: one warp instruction covers 4 voxels' whole
// 128 B rows. The deformation's gradient: each lane's 4-channel dot
// products with the corners, its partial sums reduced over the voxel's
// lanes by shuffle, one lane writing the voxel's three floats through
// shared memory, coalesced. Border padding: a corner past the last voxel
// reads the lower one again (the forward's step 0) and weighs 0, so it adds
// nothing; the gradient of a clamped coordinate is 0 (at the bound too),
// torch's rule.
//
// K5a's adjoint, deform_input_adjoint_kernel: a thread a (voxel,
// candidate), lanes along w, a warp one candidate of a 32-voxel row, a
// thread kAdjRows rows h. Each candidate's warp is a translation, so
// neighbouring voxels' corners coincide: a lane adds its left neighbour's
// upper-x terms (by shuffle) to its lower-x ones where that neighbour's
// upper x corner is its lower one, and a row's upper-y terms ride in
// registers to the next row's lower-y ones where the y corners coincide.
// Every term is added where the plain scatter adds it, only summed first:
// 1.9 atomics a (voxel, candidate) where 6.6 corner terms lie inside the
// volume (keypoints within 0.1 of each other; 1.1 for 3.7 at keypoints in
// +-0.8: the count of tests/test_torch_k5_backward.py's emulation at the
// torso step's shape), each warp-wide one 32 consecutive float4s. The
// corners and weights are lerp_zeros', a corner outside weighing 0 (a zero
// sum is not sent). 16 rows a thread ran faster than 8 and 4 (0.0199,
// 0.0210, 0.0235 ms).
constexpr int kAdjRows = 16;  // K5a's adjoint: rows h a thread carries its terms over

// K5a's adjoint. blockDim (32, cand), cand = min(K + 1, 8) candidates (a
// thread loops over the rest); grid (ceil(W / 32), ceil(H / kAdjRows), B * D).
__global__ void __launch_bounds__(256)
deform_input_adjoint_kernel(const float* __restrict__ dout, const float* __restrict__ kp_s,
                            const float* __restrict__ kp_d, int K, int D, int H, int W,
                            float4* __restrict__ dvol) {
  const unsigned all = 0xffffffffu;
  const int bd = blockIdx.z, b = bd / D, d = bd - b * D;
  const int h0 = blockIdx.y * kAdjRows, nrows = min(kAdjRows, H - h0);
  const int lane = threadIdx.x, w = blockIdx.x * 32 + lane, wc = min(w, W - 1);
  const int hw = H * W, vox = D * hw;
  const float inv_h = __frcp_rn((float)(H - 1));
  const float gx = grid_axis(wc, __frcp_rn((float)(W - 1)));
  const float gz = grid_axis(d, __frcp_rn((float)(D - 1)));
  float* vb = reinterpret_cast<float*>(dvol + (long long)b * vox);
  auto add = [&](int zi, int yi, int xi, float4 v) {
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
      r3dp_atomic_add4(vb + 4 * ((zi * H + yi) * W + xi), v);
  };
  for (int k = threadIdx.y; k <= K; k += blockDim.y) {
    float kd[3] = {0.0f, 0.0f, 0.0f}, ks[3] = {0.0f, 0.0f, 0.0f};
    if (k > 0)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        kd[a] = __ldg(kp_d + (b * K + k - 1) * 3 + a);
        ks[a] = __ldg(kp_s + (b * K + k - 1) * 3 + a);
      }
    Lerp lx = lerp_zeros(k > 0 ? __fadd_rn(__fsub_rn(gx, kd[0]), ks[0]) : gx, W);
    const Lerp lz = lerp_zeros(k > 0 ? __fadd_rn(__fsub_rn(gz, kd[2]), ks[2]) : gz, D);
    if (w >= W) lx.w0 = lx.w1 = 0.0f;
    // every lane shuffles (full mask), then the edge lanes drop the result
    const int left_i1 = __shfl_up_sync(all, lx.i1, 1);
    const bool take = lane > 0 && left_i1 == lx.i0;
    const int right_takes = __shfl_down_sync(all, (int)take, 1);
    const bool give = lane < 31 && right_takes;
    const int zs[2] = {lz.i0, lz.i1};
    const float* o = dout + ((long long)(b * (K + 1) + k) * 5 + 1) * vox + d * hw + wc;
    float4 carry[2][2];  // [z corner][x corner] of the last row's upper y corner
    int carry_y = -1;
    for (int r = 0; r < nrows; ++r) {
      const int h = h0 + r;
      const float gy = grid_axis(h, inv_h);
      const Lerp ly = lerp_zeros(k > 0 ? __fadd_rn(__fsub_rn(gy, kd[1]), ks[1]) : gy, H);
      const float* oh = o + h * W;
      const float4 go = make_float4(__ldg(oh), __ldg(oh + vox), __ldg(oh + 2 * vox),
                                    __ldg(oh + 3 * vox));
      float wgt[8];
      corner_weights(wgt, lx.w0, lx.w1, ly.w0, ly.w1, lz.w0, lz.w1);
      float4 t[2][2][2];  // [z][y][x]
#pragma unroll
      for (int i = 0; i < 8; ++i)
        t[i >> 2][(i >> 1) & 1][i & 1] =
            make_float4(go.x * wgt[i], go.y * wgt[i], go.z * wgt[i], go.w * wgt[i]);
      // the left neighbour's upper-x terms into this lane's lower-x ones
#pragma unroll
      for (int cz = 0; cz < 2; ++cz)
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const float4 u = t[cz][cy][1];
          const float4 left = make_float4(__shfl_up_sync(all, u.x, 1), __shfl_up_sync(all, u.y, 1),
                                          __shfl_up_sync(all, u.z, 1), __shfl_up_sync(all, u.w, 1));
          if (take) {
            float4& l = t[cz][cy][0];
            l.x += left.x, l.y += left.y, l.z += left.z, l.w += left.w;
          }
          if (give) t[cz][cy][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      // the last row's upper-y terms into this row's lower-y ones
      const bool join = carry_y == ly.i0;
#pragma unroll
      for (int cz = 0; cz < 2; ++cz)
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          if (carry_y >= 0) {
            if (join) {
              float4& l = t[cz][0][cx];
              const float4 c = carry[cz][cx];
              l.x += c.x, l.y += c.y, l.z += c.z, l.w += c.w;
            } else {
              add(zs[cz], carry_y, cx ? lx.i1 : lx.i0, carry[cz][cx]);
            }
          }
          add(zs[cz], ly.i0, cx ? lx.i1 : lx.i0, t[cz][0][cx]);
          carry[cz][cx] = t[cz][1][cx];
        }
      carry_y = ly.i1;
    }
#pragma unroll
    for (int cz = 0; cz < 2; ++cz)
#pragma unroll
      for (int cx = 0; cx < 2; ++cx)
        if (carry_y >= 0) add(zs[cz], carry_y, cx ? lx.i1 : lx.i0, carry[cz][cx]);
  }
}

// K5b's adjoint: the forward's CTA, at half the forward's CTAs an SM (4 of
// 256 threads for C = 32, 64 registers).
template <int C>
__global__ void __launch_bounds__(WarpTile<C>::kThreads, WarpTile<C>::kMinBlocks / 2)
warp_volume_adjoint_kernel(const float4* __restrict__ vol, const float* __restrict__ grid,
                           const float* __restrict__ dout, int D, int H, int W,
                           float4* __restrict__ dvol, float* __restrict__ dgrid) {
  using T = WarpTile<C>;
  __shared__ float4 s_wgt[kWarpTile][2];
  __shared__ int4 s_step[kWarpTile];
  // lx0, lx1, ly0, ly1 and lz0, lz1 and the three clamp multipliers
  __shared__ float4 s_lerp[kWarpTile][2];
  __shared__ float s_mult[kWarpTile][3];
  __shared__ float s_go[C][kWarpTile + 1];
  __shared__ float s_dg[kWarpTile * 3];
  const int bd = blockIdx.z, b = bd / D, d = bd - b * D, h = blockIdx.y;
  const int w0 = blockIdx.x * kWarpTile, t = threadIdx.x;
  const int nvox = min(kWarpTile, W - w0);
  const int hw = H * W, vox = D * hw;

  // the tile's rows c * D + d of dout, coalesced along w
  const float* ob = dout + ((long long)b * C * D + d) * hw + h * W + w0;
#pragma unroll
  for (int i = t; i < C * kWarpTile; i += T::kThreads) {
    const int ch = i / kWarpTile, x = i % kWarpTile;
    s_go[ch][x] = x < nvox ? __ldg(ob + ch * vox + x) : 0.0f;
  }
  // each voxel's clamped coordinate, corner steps, weights and clamp
  // multipliers, once (the forward's arithmetic)
  if (t < kWarpTile) {
    float wgt[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float l[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, m[3] = {0.0f, 0.0f, 0.0f};
    int4 step = make_int4(0, 0, 0, 0);
    if (t < nvox) {
      const float* g = grid + ((long long)bd * hw + h * W + w0 + t) * 3;
      const float rx = unnorm_ac(g[0], W), ry = unnorm_ac(g[1], H), rz = unnorm_ac(g[2], D);
      m[0] = rx > 0.0f && rx < (float)(W - 1) ? 0.5f * (float)(W - 1) : 0.0f;
      m[1] = ry > 0.0f && ry < (float)(H - 1) ? 0.5f * (float)(H - 1) : 0.0f;
      m[2] = rz > 0.0f && rz < (float)(D - 1) ? 0.5f * (float)(D - 1) : 0.0f;
      const float x = fminf(fmaxf(rx, 0.0f), (float)(W - 1));
      const float y = fminf(fmaxf(ry, 0.0f), (float)(H - 1));
      const float z = fminf(fmaxf(rz, 0.0f), (float)(D - 1));
      const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
      const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
      step = make_int4(((iz * H + iy) * W + ix) * T::kLanes, ix < W - 1 ? T::kLanes : 0,
                       iy < H - 1 ? W * T::kLanes : 0, iz < D - 1 ? hw * T::kLanes : 0);
      l[0] = __fsub_rn(fx + 1.0f, x), l[1] = __fsub_rn(x, fx);
      l[2] = __fsub_rn(fy + 1.0f, y), l[3] = __fsub_rn(y, fy);
      l[4] = __fsub_rn(fz + 1.0f, z), l[5] = __fsub_rn(z, fz);
      corner_weights(wgt, l[0], l[1], l[2], l[3], l[4], l[5]);
    }
    s_step[t] = step;
    s_wgt[t][0] = make_float4(wgt[0], wgt[1], wgt[2], wgt[3]);
    s_wgt[t][1] = make_float4(wgt[4], wgt[5], wgt[6], wgt[7]);
    s_lerp[t][0] = make_float4(l[0], l[1], l[2], l[3]);
    s_lerp[t][1] = make_float4(l[4], l[5], 0.0f, 0.0f);
    s_mult[t][0] = m[0], s_mult[t][1] = m[1], s_mult[t][2] = m[2];
  }
  __syncthreads();

  const int q = t % T::kLanes, v = t / T::kLanes;
  const int4 s = s_step[v];
  const int off[8] = {0, s.y, s.z, s.z + s.y, s.w, s.w + s.y, s.w + s.z, s.w + s.z + s.y};
  const long long base = (long long)b * vox * T::kLanes + s.x + q;
  const float4 go = make_float4(s_go[4 * q][v], s_go[4 * q + 1][v], s_go[4 * q + 2][v],
                                s_go[4 * q + 3][v]);
  float4 c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = __ldg(vol + base + off[i]);
  {
    const float4 wa = s_wgt[v][0], wb = s_wgt[v][1];
    const float wgt[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (wgt[i] != 0.0f)
        r3dp_atomic_add4(reinterpret_cast<float*>(dvol + base + off[i]),
                         make_float4(go.x * wgt[i], go.y * wgt[i], go.z * wgt[i],
                                     go.w * wgt[i]));
  }
  // d out / d coordinate: sum over the corners of dot(go, corner) times the
  // other two axes' weights, signed by the corner's side
  const float4 la = s_lerp[v][0], lb = s_lerp[v][1];
  const float wx[2] = {la.x, la.y}, wy[2] = {la.z, la.w}, wz[2] = {lb.x, lb.y};
  float dw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cx = i & 1, cy = (i >> 1) & 1, cz = i >> 2;
    const float dot = go.x * c[i].x + go.y * c[i].y + go.z * c[i].z + go.w * c[i].w;
    dw[0] += (cx ? dot : -dot) * wy[cy] * wz[cz];
    dw[1] += (cy ? dot : -dot) * wx[cx] * wz[cz];
    dw[2] += (cz ? dot : -dot) * wx[cx] * wy[cy];
  }
#pragma unroll
  for (int lane = T::kLanes / 2; lane > 0; lane /= 2)
#pragma unroll
    for (int a = 0; a < 3; ++a) dw[a] += __shfl_xor_sync(0xffffffffu, dw[a], lane);
  if (q == 0)
#pragma unroll
    for (int a = 0; a < 3; ++a) s_dg[v * 3 + a] = dw[a] * s_mult[v][a];
  __syncthreads();
  float* gg = dgrid + ((long long)bd * hw + h * W + w0) * 3;
  for (int i = t; i < 3 * nvox; i += T::kThreads) gg[i] = s_dg[i];
}

template <int C>
int launch_warp_adjoint(const float* vol, const float* grid, const float* dout, int B, int D,
                        int H, int W, float* dvol, float* dgrid, cudaStream_t stream) {
  dim3 blocks((W + kWarpTile - 1) / kWarpTile, H, B * D);
  warp_volume_adjoint_kernel<C><<<blocks, WarpTile<C>::kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(vol), grid, dout, D, H, W,
      reinterpret_cast<float4*>(dvol), dgrid);
  return (int)cudaGetLastError();
}

}  // namespace

// vol [B,D,H,W,4] fp32 channels-last (the estimator's compressed width);
// kp_s, kp_d [B,K,3]; out [B,(K+1)*5,D,H,W]. D, H, W >= 2; B * D and
// ceil(H / rows) at most 65535, 1 <= rows <= 16 rows and 1 <= cand <=
// min(K + 1, 8) candidates a CTA (models/torso.py torso_deform_plan).
R3DP_EXPORT int r3dp_torso_deform_input(const float* vol, const float* kp_s,
                                        const float* kp_d, int B, int K, int D, int H,
                                        int W, int C, int rows, int cand, float* out,
                                        cudaStream_t stream) {
  if (C != 4 || rows < 1 || rows > 16 || cand < 1 || cand > 8 || cand > K + 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * D * H * W == 0) return (int)cudaGetLastError();
  dim3 blocks((W + kDeformTile - 1) / kDeformTile, (H + rows - 1) / rows, B * D);
  deform_input_kernel<<<blocks, dim3(kDeformTile, cand), 0, stream>>>(
      reinterpret_cast<const float4*>(vol), kp_s, kp_d, K, D, H, W, rows, out);
  return (int)cudaGetLastError();
}

// vol [B,D,H,W,C] fp32 channels-last, C = 32 (released preset) or 4 (tiny);
// grid [B,D,H,W,3] (x, y, z) in [-1,1]; out [B,C*D,H,W]. D, H, W >= 2;
// B * D and H at most 65535; D * H * W * C < 2^31.
R3DP_EXPORT int r3dp_torso_warp_volume(const float* vol, const float* grid, int B, int D,
                                       int H, int W, int C, float* out,
                                       cudaStream_t stream) {
  if ((long long)B * D * H * W == 0) return (int)cudaGetLastError();
  if (C == 32) return launch_warp<32>(vol, grid, B, D, H, W, out, stream);
  if (C == 4) return launch_warp<4>(vol, grid, B, D, H, W, out, stream);
  return (int)cudaErrorInvalidValue;
}

// K5a's adjoint: dout [B,(K+1)*5,D,H,W] (the forward's output gradient),
// kp_s, kp_d [B,K,3] -> dvol [B,D,H,W,4] (zeroed by the caller, 16 B
// aligned), by scatter-add. D, H, W >= 2; B * D at most 65535; D * H * W * 4
// < 2^31.
R3DP_EXPORT int r3dp_torso_deform_input_backward(const float* dout, const float* kp_s,
                                                 const float* kp_d, int B, int K, int D, int H,
                                                 int W, int C, float* dvol,
                                                 cudaStream_t stream) {
  if (C != 4 || K < 0 || D < 2 || H < 2 || W < 2 || (long long)B * D > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  dim3 blocks((W + 31) / 32, (H + kAdjRows - 1) / kAdjRows, B * D);
  deform_input_adjoint_kernel<<<blocks, dim3(32, min(K + 1, 8)), 0, stream>>>(
      dout, kp_s, kp_d, K, D, H, W, reinterpret_cast<float4*>(dvol));
  return (int)cudaGetLastError();
}

// K5b's adjoint: vol [B,D,H,W,C] and grid [B,D,H,W,3] (the forward's
// inputs), dout [B,C*D,H,W] -> dvol [B,D,H,W,C] (zeroed by the caller, 16 B
// aligned), by scatter-add, and dgrid [B,D,H,W,3]. C = 32 or 4; D, H, W >=
// 2; B * D and H at most 65535; D * H * W * C < 2^31.
R3DP_EXPORT int r3dp_torso_warp_volume_backward(const float* vol, const float* grid,
                                                const float* dout, int B, int D, int H, int W,
                                                int C, float* dvol, float* dgrid,
                                                cudaStream_t stream) {
  if ((C != 32 && C != 4) || D < 2 || H < 2 || W < 2 || (long long)B * D > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (C == 32) return launch_warp_adjoint<32>(vol, grid, dout, B, D, H, W, dvol, dgrid, stream);
  return launch_warp_adjoint<4>(vol, grid, dout, B, D, H, W, dvol, dgrid, stream);
}
