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
// What bounds them on an H100: bytes, once the MLP runs on the tensor
// cores. A point reads 3 planes x 4 (K1) or 8 (K1-trigrid) corner rows of
// 128 B and writes 132 B; the planes of a frame are 25 MB (tri-planes, in
// the 50 MB L2) or 75.5 MB (depth-3 tri-grids, not). The MLP is 8.3k
// operations a point: on the CUDA cores (67 TFLOP/s) it alone took longer
// than reading the planes once; in split TF32 on the tensor cores (3
// products per fp32 product at 495 TFLOP/s) it takes less.
//
// Design. The gathers go by warp: a warp owns a tile of 16 consecutive
// points (samples of one or two rays, spatial neighbours) and gathers 4 of
// them at a time, 8 lanes on a point, each lane a 16 B piece (4 channels)
// of every corner row, so that each 128 B row is one coalesced read. A
// lane computes its point's corner offsets, weights and masks once per
// plane and starts the plane's 4 or 8 loads together. The blended
// [16 x 32] features land in the warp's shared buffer as the A operand of
// the first product; both products run on mma.sync m16n8k8 TF32 with
// split-TF32 operands (common.cuh), [16 x 32] x [32 x 64], softplus in
// fp32 in registers, then [16 x 64] x [64 x 40] (33 outputs, N padded to
// 5 tiles). The first product's accumulators are the second one's A
// fragments as they lie: the hidden units are taken in the order the
// accumulator holds them (k = t is hidden 8j + 2t, k = t + 4 is 8j + 2t +
// 1), and the weights are packed in that order. The output columns are
// permuted so that rgb is columns 0..31 and sigma column 32; rgb goes
// through the warp buffer so that each point's 128 B row leaves as
// coalesced 16 B stores. The folded weights come packed by the wrapper in
// fragment order, already split into hi and lo parts
// (models/decoder.py packed_decoder_mlp, cached per set of weights), and a
// CTA of 8 warps stages them in shared memory once (37 KB) and then walks
// tiles until none is left. Each accumulator takes 12 (first product) or
// 24 (second) truncating mma: up to 24 ulps of its sum, the size of an
// fp32 dot product's rounding at K = 64.
#include "common.cuh"

namespace {

constexpr int kC = 32;     // plane channels
constexpr int kHid = 64;   // decoder hidden width
constexpr int kN2 = 40;    // 33 outputs padded to 5 n-tiles
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTile = 16;  // points of a warp tile: one m16 block
constexpr int kAS = 36;    // feature row stride: A fragment loads hit 32 banks
constexpr int kOS = 40;    // output row stride: float2 stores hit 32 banks
// packed weights, in floats: the two products' B fragments as float4
// (hi0, hi1, lo0, lo1) by [k-step][n-tile][lane], then b0 and b1 (permuted)
constexpr int kW0F4 = (kC / 8) * (kHid / 8) * 32;
constexpr int kW1F4 = (kHid / 8) * (kN2 / 8) * 32;
constexpr int kPacked = 4 * (kW0F4 + kW1F4) + kHid + kN2;
constexpr int kBuf = kTile * kOS;  // a warp's buffer, in floats
constexpr int kSmemBytes = (kPacked + kWarps * kBuf) * 4;
static_assert(kPacked % 4 == 0 && kTile * kAS <= kBuf, "shared-memory layout");

// torch grid_sample unnormalisation with align_corners=False
__device__ __forceinline__ float unnormalise(float u, int size) {
  return ((u + 1.0f) * size - 1.0f) / 2.0f;
}

// Adds one plane's lookup of the lane's 4 channels at (u, v) to f: kGrid,
// a [D,H,W,32] grid, trilinear, t indexing D; else an [H,W,32] plane,
// bilinear. ``plane`` points at the lane's channels of row 0. A corner
// outside the plane, or a z corner outside [0, D-1], adds nothing; the
// tests are on the floored coordinates in fp32 (a NaN is outside), the
// offsets in 32 bits (the wrapper keeps a plane under 2^31 floats).
template <bool kGrid>
__device__ __forceinline__ void gather_plane(float4& f, const float* __restrict__ plane, int D,
                                             int H, int W, float u, float v, float t) {
  constexpr int kZ = kGrid ? 2 : 1, kCorners = 4 * kZ;
  const float x = unnormalise(u, W), y = unnormalise(v, H);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx[2] = {1.0f - (x - x0), x - x0};
  const float wy[2] = {1.0f - (y - y0), y - y0};
  const bool xok[2] = {x0 >= 0.0f && x0 <= (float)(W - 1),
                       x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1)};
  const bool yok[2] = {y0 >= 0.0f && y0 <= (float)(H - 1),
                       y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1)};
  float wz[kZ], z0 = 0.0f;
  bool zok[kZ];
  if (kGrid) {
    const float z = unnormalise(t, D);
    z0 = floorf(z);
    wz[kZ - 1] = z - z0;
    wz[0] = 1.0f - (z - z0);
    zok[0] = z0 >= 0.0f && z0 <= (float)(D - 1);
    zok[kZ - 1] = z0 + 1.0f >= 0.0f && z0 + 1.0f <= (float)(D - 1);
  } else {
    wz[0] = 1.0f;
    zok[0] = true;
  }
  // row (x0, y0, z0) in floats; unsigned, so that the offsets of corners
  // outside (never read) wrap instead of overflowing
  const unsigned row_w = (unsigned)W * kC, slice = (unsigned)H * row_w;
  const unsigned base = (unsigned)(int)z0 * slice + (unsigned)(int)y0 * row_w +
                        (unsigned)(int)x0 * kC;
  // corners (x0,y0), (x1,y0), (x0,y1), (x1,y1) of slice z0, then of z0 + 1;
  // every load started before the first is used
  bool ok[kCorners];
  float4 val[kCorners];
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
    const int c = i % 4, k = i / 4;
    ok[i] = zok[k] && xok[c & 1] && yok[c >> 1];
    const unsigned off = base + (c & 1) * kC + (c >> 1) * row_w + k * slice;
    val[i] = ok[i] ? __ldg(reinterpret_cast<const float4*>(plane + off))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
    const int c = i % 4, k = i / 4;
    const float w = ok[i] ? wx[c & 1] * wy[c >> 1] * wz[k] : 0.0f;
    f.x += val[i].x * w;
    f.y += val[i].y * w;
    f.z += val[i].z * w;
    f.w += val[i].w * w;
  }
}

// softplus and sigmoid on the SFU's exp2 and log2 (ex2.approx, lg2.approx:
// ~2^-22 relative): within ~2e-7 absolute of the fp32 library functions,
// against the decoder's tolerance of 1e-4, at a fraction of their
// instructions
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float softplus_fast(float x) {
  const float e = exp2_approx(-fabsf(x) * 1.4426950408889634f);
  return fmaxf(x, 0.0f) + __log2f(1.0f + e) * 0.6931471805599453f;
}

__device__ __forceinline__ float rgb_of(float v) {
  const float s = __fdividef(1.0f, 1.0f + exp2_approx(-v * 1.4426950408889634f));
  return s * (1.0f + 2.0f * 0.001f) - 0.001f;
}

// kGrid: tri-grids [B,3,D,H,W,32]; else tri-planes [B,3,H,W,32] (D unused).
template <bool kGrid>
__global__ void __launch_bounds__(kThreads, 2)
plane_decode_kernel(const float* __restrict__ planes, int B, int D, int H, int W,
                    const float* __restrict__ coords, long long n_per_batch, float coord_scale,
                    const float4* __restrict__ packed, float* __restrict__ rgb,
                    float* __restrict__ sigma) {
  extern __shared__ float4 smem4[];
  for (int i = threadIdx.x; i < kPacked / 4; i += kThreads) smem4[i] = __ldg(packed + i);
  __syncthreads();
  const float4* w0f = smem4;
  const float4* w1f = smem4 + kW0F4;
  const float* b0 = reinterpret_cast<const float*>(smem4 + kW0F4 + kW1F4);
  const float* b1 = b0 + kHid;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int grp = lane / 8, q = lane % 8;    // gather: point of 4, channels 4q..4q+3
  float* buf = reinterpret_cast<float*>(smem4) + kPacked + warp * kBuf;
  const long long total = (long long)B * n_per_batch;
  const long long plane_elems = (long long)(kGrid ? D : 1) * H * W * kC;
  const long long n_tiles = (total + kTile - 1) / kTile;

  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < n_tiles;
       tile += (long long)gridDim.x * kWarps) {
    const long long n0 = tile * kTile;
#pragma unroll 1
    for (int r = 0; r < kTile / 4; ++r) {
      const int p = 4 * r + grp;
      const long long n = n0 + p;
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < total) {
        const float px = __ldg(coords + 3 * n + 0) * coord_scale;
        const float py = __ldg(coords + 3 * n + 1) * coord_scale;
        const float pz = __ldg(coords + 3 * n + 2) * coord_scale;
        const long long b = B == 1 ? 0 : n / n_per_batch;
        const float* base = planes + b * 3 * plane_elems + 4 * q;
        gather_plane<kGrid>(f, base, D, H, W, px, py, pz);                    // (x, y | z)
        gather_plane<kGrid>(f, base + plane_elems, D, H, W, px, pz, py);      // (x, z | y)
        gather_plane<kGrid>(f, base + 2 * plane_elems, D, H, W, pz, px, py);  // (z, x | y)
      }
      constexpr float kThird = 1.0f / 3.0f;  // the mean of the planes
      f.x *= kThird;
      f.y *= kThird;
      f.z *= kThird;
      f.w *= kThird;
      *reinterpret_cast<float4*>(buf + p * kAS + 4 * q) = f;
    }
    __syncwarp();

    // hidden = features [16 x 32] . w0^T [32 x 64]: k-steps s, n-tiles j
    float hid[kHid / 8][4];
#pragma unroll
    for (int j = 0; j < kHid / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) hid[j][i] = 0.0f;
#pragma unroll
    for (int s = 0; s < kC / 8; ++s) {
      const float* a_at = buf + gid * kAS + 8 * s + tig;
      const float a[4] = {a_at[0], a_at[8 * kAS], a_at[4], a_at[8 * kAS + 4]};
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
#pragma unroll
      for (int j = 0; j < kHid / 8; ++j) mma_split_tf32(hid[j], ah, al, w0f[(s * 8 + j) * 32 + lane]);
    }
    __syncwarp();  // the features are read: the buffer takes the outputs next
#pragma unroll
    for (int j = 0; j < kHid / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * j + 2 * tig);
      hid[j][0] = softplus_fast(hid[j][0] + bb.x);
      hid[j][1] = softplus_fast(hid[j][1] + bb.y);
      hid[j][2] = softplus_fast(hid[j][2] + bb.x);
      hid[j][3] = softplus_fast(hid[j][3] + bb.y);
    }

    // out = hidden [16 x 64] . w1^T [64 x 40]: the accumulator of n-tile j
    // is the A fragment of k-step j (k = t: hidden 8j + 2t, k = t + 4:
    // 8j + 2t + 1)
    float out[kN2 / 8][4];
#pragma unroll
    for (int m = 0; m < kN2 / 8; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) out[m][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kHid / 8; ++j) {
      const float a[4] = {hid[j][0], hid[j][2], hid[j][1], hid[j][3]};
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
#pragma unroll
      for (int m = 0; m < kN2 / 8; ++m)
        mma_split_tf32(out[m], ah, al, w1f[(j * (kN2 / 8) + m) * 32 + lane]);
    }

    // columns 0..31 rgb, through the buffer; column 32 sigma, stored here
#pragma unroll
    for (int m = 0; m < kC / 8; ++m) {
      const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * m + 2 * tig);
      *reinterpret_cast<float2*>(buf + gid * kOS + 8 * m + 2 * tig) =
          make_float2(rgb_of(out[m][0] + bb.x), rgb_of(out[m][1] + bb.y));
      *reinterpret_cast<float2*>(buf + (gid + 8) * kOS + 8 * m + 2 * tig) =
          make_float2(rgb_of(out[m][2] + bb.x), rgb_of(out[m][3] + bb.y));
    }
    if (tig == 0) {
      if (n0 + gid < total) sigma[n0 + gid] = out[kC / 8][0] + b1[kC];
      if (n0 + gid + 8 < total) sigma[n0 + gid + 8] = out[kC / 8][2] + b1[kC];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kTile * kC / 4 / 32; ++k) {
      const int i = lane + 32 * k, p = i / 8, c = i % 8;
      if (n0 + p < total)
        reinterpret_cast<float4*>(rgb)[(n0 + p) * (kC / 4) + c] =
            *reinterpret_cast<const float4*>(buf + p * kOS + 4 * c);
    }
    __syncwarp();  // the outputs are read before the next tile's features land
  }
}

template <bool kGrid>
int launch(const float* planes, int B, int D, int H, int W, const float* coords,
           long long n_per_batch, float coord_scale, const float* packed, float* rgb,
           float* sigma, cudaStream_t stream) {
  const long long total = (long long)B * n_per_batch;
  if (total <= 0) return (int)cudaGetLastError();
  auto kernel = plane_decode_kernel<kGrid>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // one wave of CTAs that walk the tiles: as many as fit the card at once
  static int ctas_per_sm = 0, sms = 0;
  if (ctas_per_sm == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel, kThreads,
                                                             kSmemBytes)) != cudaSuccess)
      return (int)err;
    if (ctas_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long n_tiles = (total + kTile - 1) / kTile;
  const long long want = (n_tiles + kWarps - 1) / kWarps;
  const long long fit = (long long)ctas_per_sm * sms;
  kernel<<<(unsigned int)(want < fit ? want : fit), kThreads, kSmemBytes, stream>>>(
      planes, B, D, H, W, coords, n_per_batch, coord_scale,
      reinterpret_cast<const float4*>(packed), rgb, sigma);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K1 and K1-trigrid backward (triplane_decode_backward and
// trigrid_decode_backward in models/decoder.py; the JAX package had
// jax.grad differentiate the XLA sampler and decoder). One template,
// kGrid as in the forward: tri-grids (8 trilinear corners a plane) or
// tri-planes (4 bilinear corners). From the gradients of rgb [N,32] and
// sigma [N] (either may be NULL: zero), it recomputes each point's samples
// of the three planes, their mean f, h = softplus(W0 f + b0) and the
// outputs in fp32 (CUDA cores, no split TF32), takes d rgb through
// sigmoid * 1.002 - 0.001, and returns
//   d planes: df / 3 scattered into each plane's corners (the forward's
//     zero-padding rule: a corner outside adds nothing), by atomicAdd;
//   d W1 = sum dout (x) h, d b1 = sum dout, d W0 = sum dh' (x) f,
//     d b0 = sum dh' (dh' = W1^T dout * sigmoid(W0 f + b0)),
// for the folded weights (the wrapper maps them through the equalised-LR
// gains). What bounds it: operations, ~12.5k fp32 FMAs a point (the
// forward's MLP again, its two transposes and the two outer products), and
// the atomics of the scatter, 3 x 8 (or 4) corners x 32 channels a point.
// Design, simple first: a CTA of 256 threads takes tiles of 64 points,
// four threads a point, each a quarter of every vector (8 channels of f,
// 16 hidden units, 8-9 outputs), the per-point vectors in shared memory
// with a row stride of 65 (so that the weight phase reads them without
// bank conflicts); the weight gradients accumulate in registers over the
// CTA's tiles, 17 entries a thread, and leave by one atomicAdd an entry a
// CTA.
constexpr int kBwThreads = 256, kBwP = 64, kBwS = kBwP + 1;
constexpr int kOut = kC + 1;                       // sigma + 32 rgb
constexpr int kBwW = kOut * kHid + kOut + kHid * kC + kHid;  // 4257 gradient entries
constexpr int kBwPer = (kBwW + kBwThreads - 1) / kBwThreads;
constexpr int kBwSmemFloats = kHid * kC + kOut * kHid + kHid + kOut +
                              (kC + kHid + kHid + kOut) * kBwS;
constexpr int kBwSmemBytes = kBwSmemFloats * 4;

struct Corners {
  unsigned off[8];
  float w[8];
  bool ok[8];
};

// the corners of (u, v, t) by the forward's rules: kGrid, the 8 corners in
// a [D,H,W,32] grid; else the 4 of (u, v) in an [H,W,32] plane (t unused)
template <bool kGrid>
__device__ __forceinline__ void grid_corners(Corners& c, int D, int H, int W, float u, float v,
                                             float t) {
  const float x = unnormalise(u, W), y = unnormalise(v, H);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx[2] = {1.0f - (x - x0), x - x0};
  const float wy[2] = {1.0f - (y - y0), y - y0};
  const bool xok[2] = {x0 >= 0.0f && x0 <= (float)(W - 1),
                       x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1)};
  const bool yok[2] = {y0 >= 0.0f && y0 <= (float)(H - 1),
                       y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1)};
  float z0 = 0.0f, wz[2] = {1.0f, 0.0f};
  bool zok[2] = {true, false};
  if (kGrid) {
    const float z = unnormalise(t, D);
    z0 = floorf(z);
    wz[0] = 1.0f - (z - z0);
    wz[1] = z - z0;
    zok[0] = z0 >= 0.0f && z0 <= (float)(D - 1);
    zok[1] = z0 + 1.0f >= 0.0f && z0 + 1.0f <= (float)(D - 1);
  }
  const unsigned row_w = (unsigned)W * kC, slice = (unsigned)H * row_w;
  const unsigned base = (unsigned)(int)z0 * slice + (unsigned)(int)y0 * row_w +
                        (unsigned)(int)x0 * kC;
#pragma unroll
  for (int i = 0; i < (kGrid ? 8 : 4); ++i) {
    const int cx = i & 1, cy = (i >> 1) & 1, cz = i >> 2;
    c.ok[i] = zok[cz] && xok[cx] && yok[cy];
    c.off[i] = base + cx * kC + cy * row_w + cz * slice;
    c.w[i] = c.ok[i] ? wx[cx] * wy[cy] * wz[cz] : 0.0f;
  }
}

template <bool kGrid>
__global__ void __launch_bounds__(kBwThreads)
plane_decode_backward_kernel(const float* __restrict__ planes, int B, int D, int H, int W,
                               const float* __restrict__ coords, long long n_per_batch,
                               float coord_scale, const float* __restrict__ w0,
                               const float* __restrict__ b0, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ drgb,
                               const float* __restrict__ dsigma, float* __restrict__ dplanes,
                               float* __restrict__ dw0, float* __restrict__ db0,
                               float* __restrict__ dw1, float* __restrict__ db1) {
  extern __shared__ float sm[];
  float* sW0 = sm;                   // [64][32]
  float* sW1 = sW0 + kHid * kC;      // [33][64], row 0 sigma
  float* sb0 = sW1 + kOut * kHid;    // [64]
  float* sb1 = sb0 + kHid;           // [33]
  float* sF = sb1 + kOut;            // [32][65] mean features
  float* sH = sF + kC * kBwS;        // [64][65] softplus(W0 f + b0)
  float* sG = sH + kHid * kBwS;      // [64][65] its slope, then dh'
  float* sO = sG + kHid * kBwS;      // [33][65] d of the outputs before activation
  for (int i = threadIdx.x; i < kHid * kC; i += kBwThreads) sW0[i] = __ldg(w0 + i);
  for (int i = threadIdx.x; i < kOut * kHid; i += kBwThreads) sW1[i] = __ldg(w1 + i);
  for (int i = threadIdx.x; i < kHid; i += kBwThreads) sb0[i] = __ldg(b0 + i);
  for (int i = threadIdx.x; i < kOut; i += kBwThreads) sb1[i] = __ldg(b1 + i);

  const int p = threadIdx.x % kBwP, q = threadIdx.x / kBwP;  // point of the tile, quarter
  const long long total = (long long)B * n_per_batch;
  constexpr int kCorners = kGrid ? 8 : 4;
  const long long plane_elems = (long long)(kGrid ? D : 1) * H * W * kC;
  const long long n_tiles = (total + kBwP - 1) / kBwP;
  float acc[kBwPer];
#pragma unroll
  for (int r = 0; r < kBwPer; ++r) acc[r] = 0.0f;
  // this thread's outputs: 9 for quarter 0 (sigma and rgb 0..7), else 8
  const int o_lo = q == 0 ? 0 : 8 * q + 1, o_hi = 8 * q + 9;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the weights are staged; the previous tile is read
    const long long n = tile * kBwP + p;
    const bool valid = n < total;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    const float* gbase = planes;
    long long b = 0;
    if (valid) {
      px = __ldg(coords + 3 * n + 0) * coord_scale;
      py = __ldg(coords + 3 * n + 1) * coord_scale;
      pz = __ldg(coords + 3 * n + 2) * coord_scale;
      b = B == 1 ? 0 : n / n_per_batch;
      gbase = planes + b * 3 * plane_elems + 8 * q;
    }
    // 1. channels 8q..8q+7 of the mean of the three samples
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    if (valid) {
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        const float u = k == 2 ? pz : px, v = k == 0 ? py : (k == 1 ? pz : px),
                    t = k == 0 ? pz : py;
        Corners c;
        grid_corners<kGrid>(c, D, H, W, u, v, t);
        const float* g = gbase + k * plane_elems;
#pragma unroll
        for (int i = 0; i < kCorners; ++i) {
          if (!c.ok[i]) continue;
          const float4 a = __ldg(reinterpret_cast<const float4*>(g + c.off[i]));
          const float4 e = __ldg(reinterpret_cast<const float4*>(g + c.off[i] + 4));
          f[0] += a.x * c.w[i], f[1] += a.y * c.w[i], f[2] += a.z * c.w[i], f[3] += a.w * c.w[i];
          f[4] += e.x * c.w[i], f[5] += e.y * c.w[i], f[6] += e.z * c.w[i], f[7] += e.w * c.w[i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sF[(8 * q + j) * kBwS + p] = f[j] / 3.0f;
    __syncthreads();
    // 2. hidden units 16q..16q+15
    for (int j = 16 * q; j < 16 * q + 16; ++j) {
      float a = sb0[j];
#pragma unroll 8
      for (int k = 0; k < kC; ++k) a += sW0[j * kC + k] * sF[k * kBwS + p];
      sH[j * kBwS + p] = r3dp_softplus(a);
      sG[j * kBwS + p] = r3dp_sigmoid(a);
    }
    __syncthreads();
    // 3. this quarter's outputs and their gradients before the activation
    for (int o = o_lo; o < o_hi; ++o) {
      float d = 0.0f;
      if (valid) {
        if (o == 0) {
          d = dsigma ? __ldg(dsigma + n) : 0.0f;
        } else if (drgb) {
          float a = sb1[o];
#pragma unroll 8
          for (int j = 0; j < kHid; ++j) a += sW1[o * kHid + j] * sH[j * kBwS + p];
          const float sg = r3dp_sigmoid(a);
          d = __ldg(drgb + n * kC + (o - 1)) * (1.0f + 2.0f * 0.001f) * (sg * (1.0f - sg));
        }
      }
      sO[o * kBwS + p] = d;
    }
    __syncthreads();
    // 4. dh' = (W1^T dout) * slope, for hidden units 16q..16q+15 (in place)
    for (int j = 16 * q; j < 16 * q + 16; ++j) {
      float a = 0.0f;
#pragma unroll 11
      for (int o = 0; o < kOut; ++o) a += sW1[o * kHid + j] * sO[o * kBwS + p];
      sG[j * kBwS + p] *= a;
    }
    __syncthreads();
    // 5. df = W0^T dh' for channels 8q..8q+7, scattered into the corners
    if (valid) {
      float df[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float a = 0.0f;
#pragma unroll 8
        for (int j = 0; j < kHid; ++j) a += sW0[j * kC + 8 * q + c] * sG[j * kBwS + p];
        df[c] = a / 3.0f;
      }
      float* dbase = dplanes + b * 3 * plane_elems + 8 * q;
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        const float u = k == 2 ? pz : px, v = k == 0 ? py : (k == 1 ? pz : px),
                    t = k == 0 ? pz : py;
        Corners c;
        grid_corners<kGrid>(c, D, H, W, u, v, t);
        float* g = dbase + k * plane_elems;
#pragma unroll
        for (int i = 0; i < kCorners; ++i) {
          if (!c.ok[i]) continue;
          const float w = c.w[i];
          r3dp_atomic_add4(g + c.off[i], make_float4(df[0] * w, df[1] * w, df[2] * w, df[3] * w));
          r3dp_atomic_add4(g + c.off[i] + 4, make_float4(df[4] * w, df[5] * w, df[6] * w, df[7] * w));
        }
      }
    }
    // 6. the weight gradients of this tile's points, into the registers
#pragma unroll
    for (int r = 0; r < kBwPer; ++r) {
      const int e = threadIdx.x + kBwThreads * r;
      const float* a = nullptr;
      const float* c = nullptr;
      if (e < kOut * kHid) {  // dW1[o][j] = sum dout[o] h[j]
        a = sO + (e / kHid) * kBwS, c = sH + (e % kHid) * kBwS;
      } else if (e < kOut * kHid + kOut) {  // db1[o]
        a = sO + (e - kOut * kHid) * kBwS;
      } else if (e < kOut * kHid + kOut + kHid * kC) {  // dW0[j][k] = sum dh'[j] f[k]
        const int i = e - kOut * kHid - kOut;
        a = sG + (i / kC) * kBwS, c = sF + (i % kC) * kBwS;
      } else if (e < kBwW) {  // db0[j]
        a = sG + (e - kOut * kHid - kOut - kHid * kC) * kBwS;
      }
      if (a == nullptr) continue;
      float sum = 0.0f;
      if (c != nullptr) {
#pragma unroll 8
        for (int i = 0; i < kBwP; ++i) sum += a[i] * c[i];
      } else {
#pragma unroll 8
        for (int i = 0; i < kBwP; ++i) sum += a[i];
      }
      acc[r] += sum;
    }
  }
#pragma unroll
  for (int r = 0; r < kBwPer; ++r) {
    const int e = threadIdx.x + kBwThreads * r;
    if (e < kOut * kHid) atomicAdd(dw1 + e, acc[r]);
    else if (e < kOut * kHid + kOut) atomicAdd(db1 + e - kOut * kHid, acc[r]);
    else if (e < kOut * kHid + kOut + kHid * kC) atomicAdd(dw0 + e - kOut * kHid - kOut, acc[r]);
    else if (e < kBwW) atomicAdd(db0 + e - kOut * kHid - kOut - kHid * kC, acc[r]);
  }
}

template <bool kGrid>
int launch_backward(const float* planes, int B, int D, int H, int W, const float* coords,
                    long long n_per_batch, float coord_scale, const float* w0, const float* b0,
                    const float* w1, const float* b1, const float* drgb, const float* dsigma,
                    float* dplanes, float* dw0, float* db0, float* dw1, float* db1,
                    cudaStream_t stream) {
  const long long total = (long long)B * n_per_batch;
  if (total <= 0) return (int)cudaGetLastError();
  auto kernel = plane_decode_backward_kernel<kGrid>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwSmemBytes);
  if (err != cudaSuccess) return (int)err;
  static int ctas_per_sm = 0, sms = 0;
  if (ctas_per_sm == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel, kBwThreads,
                                                             kBwSmemBytes)) != cudaSuccess)
      return (int)err;
    if (ctas_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long n_tiles = (total + kBwP - 1) / kBwP;
  const long long fit = (long long)ctas_per_sm * sms;
  kernel<<<(unsigned int)(n_tiles < fit ? n_tiles : fit), kBwThreads, kBwSmemBytes, stream>>>(
      planes, B, D, H, W, coords, n_per_batch, coord_scale, w0, b0, w1, b1, drgb, dsigma,
      dplanes, dw0, db0, dw1, db1);
  return (int)cudaGetLastError();
}

}  // namespace

// planes [B,3,H,W,32] fp32 contiguous, a plane under 2^31 floats; coords [B,n_per_batch,3]; packed
// the folded decoder (w0 [64,32], b0 [64], w1 [33,64], b1 [33]) in the
// kernel's fragment order, split into TF32 hi and lo parts, 16 B aligned
// (models/decoder.py pack_decoder_mlp); rgb [B*n_per_batch,32] and sigma
// [B*n_per_batch] 16 B aligned.
R3DP_EXPORT int r3dp_triplane_decode(const float* planes, int B, int H, int W,
                                     const float* coords, long long n_per_batch,
                                     float coord_scale, const float* packed, float* rgb,
                                     float* sigma, cudaStream_t stream) {
  if ((long long)H * W * kC >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return launch<false>(planes, B, 0, H, W, coords, n_per_batch, coord_scale, packed, rgb,
                       sigma, stream);
}

// The same with tri-grids [B,3,D,H,W,32], D >= 1.
R3DP_EXPORT int r3dp_trigrid_decode(const float* planes, int B, int D, int H, int W,
                                    const float* coords, long long n_per_batch,
                                    float coord_scale, const float* packed, float* rgb,
                                    float* sigma, cudaStream_t stream) {
  if (D < 1 || (long long)D * H * W * kC >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return launch<true>(planes, B, D, H, W, coords, n_per_batch, coord_scale, packed, rgb,
                      sigma, stream);
}

// K1-trigrid backward. planes, coords, n_per_batch and coord_scale as the
// forward's; w0 [64,32], b0 [64], w1 [33,64], b1 [33] the folded decoder,
// plain fp32 (row 0 of w1 and entry 0 of b1 sigma); drgb [N,32] and dsigma
// [N] (N = B * n_per_batch), either NULL for zero; dplanes like planes,
// 16 B aligned, and dw0, db0, dw1, db1 like the weights, all zeroed by the
// caller, take the gradients.
R3DP_EXPORT int r3dp_trigrid_decode_backward(const float* planes, int B, int D, int H, int W,
                                             const float* coords, long long n_per_batch,
                                             float coord_scale, const float* w0,
                                             const float* b0, const float* w1, const float* b1,
                                             const float* drgb, const float* dsigma,
                                             float* dplanes, float* dw0, float* db0,
                                             float* dw1, float* db1, cudaStream_t stream) {
  if (D < 1 || (long long)D * H * W * kC >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return launch_backward<true>(planes, B, D, H, W, coords, n_per_batch, coord_scale, w0, b0,
                               w1, b1, drgb, dsigma, dplanes, dw0, db0, dw1, db1, stream);
}

// K1 backward: the same for tri-planes [B,3,H,W,32].
R3DP_EXPORT int r3dp_triplane_decode_backward(const float* planes, int B, int H, int W,
                                              const float* coords, long long n_per_batch,
                                              float coord_scale, const float* w0,
                                              const float* b0, const float* w1,
                                              const float* b1, const float* drgb,
                                              const float* dsigma, float* dplanes, float* dw0,
                                              float* db0, float* dw1, float* db1,
                                              cudaStream_t stream) {
  if ((long long)H * W * kC >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return launch_backward<false>(planes, B, 1, H, W, coords, n_per_batch, coord_scale, w0, b0,
                                w1, b1, drgb, dsigma, dplanes, dw0, db0, dw1, db1, stream);
}

R3DP_EXPORT const char* r3dp_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
