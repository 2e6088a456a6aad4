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
// outputs, takes d rgb through sigmoid * 1.002 - 0.001, and returns
//   d planes: df / 3 scattered into each plane's corners (the forward's
//     zero-padding rule: a corner outside adds nothing), by atomics;
//   d W1 = sum dout (x) h, d b1 = sum dout, d W0 = sum dh' (x) f,
//     d b0 = sum dh' (dh' = W1^T dout * sigmoid(W0 f + b0)),
// for the folded weights (the wrapper maps them through the equalised-LR
// gains).
//
// What bounds it on an H100: the six products a point (the MLP's two
// recomputed, dh' = W1^T dout, df = W0^T dh', and the two weight
// gradients, 2 x 3 x (32 x 64 + 64 x 33) operations) at the split-TF32
// rate, and the planes read and their gradient written: 0.24 ms for one
// frame's 1.57 M points; on FFMA 0.66 ms.
//
// The design this replaces ran everything on FFMA: four threads a
// point, the per-point vectors in shared memory, five __syncthreads phases
// a tile of 64 points and a weight phase in which each thread walked 17
// gradient entries over the tile's points, two shared loads a product.
// It took 9.58 ms at one frame's 1.57 M uniform points on the tri-grids
// (NVIDIA H100 80GB HBM3, 700 W); copies of it with parts left out took
// 9.20 ms without the scatter's atomics, 7.27 without the weight phase and
// 4.41 without either: its shared-memory phases, not its atomics, held it.
//
// Design: the forward's warp tiles (above). A warp owns 16 consecutive
// points and gathers their features as the forward does (8 lanes a point,
// a 16 B piece of every corner row each), the corner loads of all three
// planes started together; the four products run on mma.sync m16n8k8 in
// split TF32, each
// accumulator the next product's A fragment as it lies: hidden = f W0^T,
// out = h W1p^T (as the forward), d hidden = dout W1p with the rows of W1p
// taken in the order out's accumulator holds them, then times the
// softplus' slope, and df = dh' W0 likewise. The weights arrive plain; each
// CTA packs the four products' B fragments into shared memory, split into
// hi and lo parts, at its start (72 KB). A warp then stages its tile's f,
// h, dout and dh' in its shared slot, and df / 3, which leaves by the
// scatter: 8 lanes a point, so that each corner row's 128 B leaves as one
// coalesced warp instruction of 16 B vector reductions (red.global.add.v4
// .f32). The weight gradients are products over the points too: the CTA's
// warps form two teams of 4, each with its own named barrier, so that one
// team gathers while the other multiplies; once a team's warps have staged
// a tile each (a round), each of them computes 12 of the 45 m16n8 tiles of
// d W1^T = [h | 1]^T dout (M = 64 hidden + the bias row, N = 33 outputs
// padded to 40) and d W0 = dh'^T [f | 1] (M = 64, N = 32 features + the
// bias column) over the round's 64 points, in split TF32, into a fresh
// tile that its running sums take by an fp32 add; the sums leave by one
// atomicAdd an entry a team at the end. One CTA an SM (8 warps, 211 KB of
// shared memory), one wave walking the rounds.
//
// On uniform points the memory system bounds it rather than the products:
// the scatter alone (the same 16 B reductions, nothing else) took 2.67 ms
// into the tri-grids' 75.5 MB gradient, which with the grids does not fit
// the 50 MB L2, and 1.26 ms into 25.2 MB (NVIDIA H100 80GB HBM3, 700 W).
// So on tri-grids the corner loads stream with L2 priority evict-first and
// the reductions keep theirs evict-last (4.09 against 4.22 ms at one
// frame's 1.57 M points); tri-planes and their gradient (50 MB) keep the
// default.
constexpr int kBwThreads = kThreads, kBwWarps = kWarps;
constexpr int kP3F4 = (kN2 / 8) * (kHid / 8) * 32;  // d hidden: [5 k-steps][8 n-tiles][lane]
constexpr int kP4F4 = (kHid / 8) * (kC / 8) * 32;   // df: [8 k-steps][4 n-tiles][lane]
constexpr int kBwPacked = 4 * (kW0F4 + kW1F4 + kP3F4 + kP4F4) + kHid + kN2;
// a warp's slot, row strides 8 mod 32 where the weight-gradient products
// read it (a point t, 8 consecutive columns g: 32 banks): f and its ones
// column [16][40], h and its ones column [16][88], dout [16][40], dh'
// [16][72], df / 3 [16][36]
constexpr int kSF = 40, kSH = 88, kSO = 40, kSD = 72, kSG = 36;
constexpr int kSlot = kTile * (kSF + kSH + kSO + kSD + kSG);
constexpr int kBwSmemBytes = (kBwPacked + kBwWarps * kSlot) * 4;
// the weight-gradient tiles: d W1^T 5 x 5 (hidden + bias row on M, outputs
// on N), then d W0 4 x 5 (hidden on M, features + bias column on N); a
// team of 4 warps shares its rounds and its warps split the tiles
constexpr int kWgTiles = 25 + 20, kTeam = 4, kTeams = kBwWarps / kTeam;
constexpr int kWgPer = (kWgTiles + kTeam - 1) / kTeam;

// the team's barrier (named barrier 1 + team, its 128 threads)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(kTeam * 32) : "memory");
}
static_assert(kBwPacked % 4 == 0 && kSlot % 4 == 0, "16 B aligned slots");

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

// L2 eviction priorities: the tri-grids and their gradient (151 MB a frame)
// do not fit the 50 MB L2, so the backward streams the grids' corner rows
// (evict first) and keeps the gradient's rows, which the reductions read
// and write, as long as it can (evict last)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float4 ldg_policy(const float* p, uint64_t policy) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// *p += v at a 16 B aligned address, no value returned
__device__ __forceinline__ void red_add4_policy(float* p, float4 v, uint64_t policy) {
  asm volatile("red.global.add.L2::cache_hint.v4.f32 [%0], {%1,%2,%3,%4}, %5;"
               ::"l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(policy)
               : "memory");
}

// A point's features: the three planes' lookups of the lane's 4 channels,
// every corner load of the three started before the first is used (the
// forward's gather_plane waits for each plane in turn); tri-grids' loads
// with ``policy``.
template <bool kGrid>
__device__ __forceinline__ float4 gather3(const float* __restrict__ base, long long plane_elems,
                                          int D, int H, int W, float px, float py, float pz,
                                          uint64_t policy) {
  constexpr int kCorners = kGrid ? 8 : 4;
  float4 val[3][kCorners];
  float wt[3][kCorners];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float u = k == 2 ? pz : px, v = k == 0 ? py : (k == 1 ? pz : px),
                t = k == 0 ? pz : py;
    Corners c;
    grid_corners<kGrid>(c, D, H, W, u, v, t);
#pragma unroll
    for (int i = 0; i < kCorners; ++i) {
      wt[k][i] = c.w[i];
      const float* row = base + k * plane_elems + c.off[i];
      val[k][i] = !c.ok[i] ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                  : kGrid  ? ldg_policy(row, policy)
                           : __ldg(reinterpret_cast<const float4*>(row));
    }
  }
  float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kCorners; ++i) {
      f.x += val[k][i].x * wt[k][i];
      f.y += val[k][i].y * wt[k][i];
      f.z += val[k][i].z * wt[k][i];
      f.w += val[k][i].w * wt[k][i];
    }
  return f;
}

// (hi0, hi1, lo0, lo1) of a B fragment
__device__ __forceinline__ float4 bw_frag(float b0, float b1) {
  const float h0 = __uint_as_float(tf32_rna(b0)), h1 = __uint_as_float(tf32_rna(b1));
  return make_float4(h0, h1, __uint_as_float(tf32_rna(b0 - h0)),
                     __uint_as_float(tf32_rna(b1 - h1)));
}

// c += a * b in split TF32, both fragments split here: a (a0..a3), b (b0, b1)
__device__ __forceinline__ void mma_split_both(float (&c)[4], const float (&a)[4], float b0,
                                               float b1) {
  uint32_t ah[4], al[4];
  split_tf32(a, ah, al);
  const uint32_t bh0 = tf32_rna(b0), bh1 = tf32_rna(b1);
  const uint32_t bl0 = tf32_rna(b0 - __uint_as_float(bh0));
  const uint32_t bl1 = tf32_rna(b1 - __uint_as_float(bh1));
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <bool kGrid>
__global__ void __launch_bounds__(kBwThreads, 1)
plane_decode_backward_kernel(const float* __restrict__ planes, int B, int D, int H, int W,
                             const float* __restrict__ coords, long long n_per_batch,
                             float coord_scale, const float* __restrict__ w0,
                             const float* __restrict__ b0, const float* __restrict__ w1,
                             const float* __restrict__ b1, const float* __restrict__ drgb,
                             const float* __restrict__ dsigma, float* __restrict__ dplanes,
                             float* __restrict__ dw0, float* __restrict__ db0,
                             float* __restrict__ dw1, float* __restrict__ db1) {
  extern __shared__ float4 smem4[];
  float4* p1 = smem4;         // hidden = f W0^T, the forward's first pack
  float4* p2 = p1 + kW0F4;    // out = h W1p^T, the forward's second
  float4* p3 = p2 + kW1F4;    // d hidden = dout W1p
  float4* p4 = p3 + kP3F4;    // df = dh' W0
  float* sb0 = reinterpret_cast<float*>(p4 + kP4F4);
  float* sb1 = sb0 + kHid;    // b1 permuted as W1p's rows
  const int tid = threadIdx.x;
  // W1p: rows 0..31 the rgb outputs 1..32, row 32 sigma (output 0), 33..39 zero
  auto w1p = [&](int r, int c) { return r < kC ? __ldg(w1 + (r + 1) * kHid + c)
                                               : r == kC ? __ldg(w1 + c) : 0.0f; };
  for (int i = tid; i < kW0F4; i += kBwThreads) {  // [s][j][lane] and [j][q][lane]
    const int l = i % 32, g = l / 4, t = l % 4, s = i / 256, j = i / 32 % 8;
    p1[i] = bw_frag(__ldg(w0 + (8 * j + g) * kC + 8 * s + t),
                    __ldg(w0 + (8 * j + g) * kC + 8 * s + t + 4));
    const int jj = i / 128, q = i / 32 % 4;
    p4[i] = bw_frag(__ldg(w0 + (8 * jj + 2 * t) * kC + 8 * q + g),
                    __ldg(w0 + (8 * jj + 2 * t + 1) * kC + 8 * q + g));
  }
  for (int i = tid; i < kW1F4; i += kBwThreads) {  // [j][m][lane] and [m][j][lane]
    const int l = i % 32, g = l / 4, t = l % 4, j = i / 160, m = i / 32 % 5;
    p2[i] = bw_frag(w1p(8 * m + g, 8 * j + 2 * t), w1p(8 * m + g, 8 * j + 2 * t + 1));
    const int mm = i / 256, jj = i / 32 % 8;
    p3[i] = bw_frag(w1p(8 * mm + 2 * t, 8 * jj + g), w1p(8 * mm + 2 * t + 1, 8 * jj + g));
  }
  for (int i = tid; i < kHid; i += kBwThreads) sb0[i] = __ldg(b0 + i);
  for (int i = tid; i < kN2; i += kBwThreads)
    sb1[i] = i < kC ? __ldg(b1 + i + 1) : i == kC ? __ldg(b1) : 0.0f;

  const int lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int grp = lane / 8, q = lane % 8;    // gather and scatter: point of 4, channels 4q..
  float* const slot0 = reinterpret_cast<float*>(smem4 + kBwPacked / 4);
  float* const sF = slot0 + warp * kSlot;
  float* const sH = sF + kTile * kSF;
  float* const sO = sH + kTile * kSH;
  float* const sD = sO + kTile * kSO;
  float* const sG = sD + kTile * kSD;
  // the ones columns (the bias gradients) and the zero columns past them
  for (int i = lane; i < kTile * 8; i += 32) sF[(i / 8) * kSF + kC + i % 8] = i % 8 ? 0.0f : 1.0f;
  for (int i = lane; i < kTile * 24; i += 32)
    sH[(i / 24) * kSH + kHid + i % 24] = i % 24 ? 0.0f : 1.0f;
  __syncthreads();

  const long long total = (long long)B * n_per_batch;
  const long long plane_elems = (long long)(kGrid ? D : 1) * H * W * kC;
  const long long n_tiles = (total + kTile - 1) / kTile;
  float wacc[kWgPer][4];
#pragma unroll
  for (int k = 0; k < kWgPer; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) wacc[k][i] = 0.0f;

  const int team = warp / kTeam, wit = warp % kTeam;
  const uint64_t stream_policy = kGrid ? l2_evict_first() : 0;
  const uint64_t keep_policy = kGrid ? l2_evict_last() : 0;
  const float* const team_slots = slot0 + team * kTeam * kSlot;
  for (long long round0 = ((long long)blockIdx.x * kTeams + team) * kTeam; round0 < n_tiles;
       round0 += (long long)gridDim.x * kBwWarps) {
    const long long tile = round0 + wit;
    const int n_slots = (int)min((long long)kTeam, n_tiles - round0);
    if (tile < n_tiles) {
      const long long n0 = tile * kTile;
      // f, into the slot
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
          f = gather3<kGrid>(planes + b * 3 * plane_elems + 4 * q, plane_elems, D, H, W, px, py,
                             pz, stream_policy);
        }
        constexpr float kThird = 1.0f / 3.0f;
        *reinterpret_cast<float4*>(sF + p * kSF + 4 * q) =
            make_float4(f.x * kThird, f.y * kThird, f.z * kThird, f.w * kThird);
      }
      __syncwarp();
      // hidden = f [16 x 32] . W0^T
      float hid[kHid / 8][4];
#pragma unroll
      for (int j = 0; j < kHid / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) hid[j][i] = 0.0f;
#pragma unroll
      for (int s = 0; s < kC / 8; ++s) {
        const float* a_at = sF + gid * kSF + 8 * s + tig;
        const float a[4] = {a_at[0], a_at[8 * kSF], a_at[4], a_at[8 * kSF + 4]};
        uint32_t ah[4], al[4];
        split_tf32(a, ah, al);
#pragma unroll
        for (int j = 0; j < kHid / 8; ++j) mma_split_tf32(hid[j], ah, al, p1[(s * 8 + j) * 32 + lane]);
      }
      // h = softplus, into the slot
#pragma unroll
      for (int j = 0; j < kHid / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(sb0 + 8 * j + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i) hid[j][i] = softplus_fast(hid[j][i] + (i % 2 ? bb.y : bb.x));
        *reinterpret_cast<float2*>(sH + gid * kSH + 8 * j + 2 * tig) = make_float2(hid[j][0], hid[j][1]);
        *reinterpret_cast<float2*>(sH + (gid + 8) * kSH + 8 * j + 2 * tig) =
            make_float2(hid[j][2], hid[j][3]);
      }
      // out = h [16 x 64] . W1p^T [64 x 40]
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
        for (int m = 0; m < kN2 / 8; ++m) mma_split_tf32(out[m], ah, al, p2[(j * 5 + m) * 32 + lane]);
      }
      // dout, in W1p's row order: columns 0..31 rgb (through sigmoid * 1.002
      // - 0.001), column 32 sigma, 33..39 zero; into the slot and kept in out
#pragma unroll
      for (int m = 0; m < kN2 / 8; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = gid + 8 * (i / 2), c = 8 * m + 2 * tig + i % 2;
          const long long n = n0 + row;
          float d = 0.0f;
          if (n < total) {
            if (c < kC && drgb != nullptr) {
              const float sg = __fdividef(
                  1.0f, 1.0f + exp2_approx(-(out[m][i] + sb1[c]) * 1.4426950408889634f));
              d = __ldg(drgb + n * kC + c) * (1.0f + 2.0f * 0.001f) * (sg * (1.0f - sg));
            } else if (c == kC && dsigma != nullptr) {
              d = __ldg(dsigma + n);
            }
          }
          out[m][i] = d;
        }
        *reinterpret_cast<float2*>(sO + gid * kSO + 8 * m + 2 * tig) = make_float2(out[m][0], out[m][1]);
        *reinterpret_cast<float2*>(sO + (gid + 8) * kSO + 8 * m + 2 * tig) =
            make_float2(out[m][2], out[m][3]);
      }
      // dh' = (dout [16 x 40] . W1p [40 x 64]) * slope, into the slot
      float dh[kHid / 8][4];
#pragma unroll
      for (int j = 0; j < kHid / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[j][i] = 0.0f;
#pragma unroll
      for (int m = 0; m < kN2 / 8; ++m) {
        const float a[4] = {out[m][0], out[m][2], out[m][1], out[m][3]};
        uint32_t ah[4], al[4];
        split_tf32(a, ah, al);
#pragma unroll
        for (int j = 0; j < kHid / 8; ++j) mma_split_tf32(dh[j], ah, al, p3[(m * 8 + j) * 32 + lane]);
      }
      // the slope sigmoid(W0 f + b0) = 1 - exp(-h), from h in the slot
#pragma unroll
      for (int j = 0; j < kHid / 8; ++j) {
        const float2 h0 = *reinterpret_cast<const float2*>(sH + gid * kSH + 8 * j + 2 * tig);
        const float2 h1 = *reinterpret_cast<const float2*>(sH + (gid + 8) * kSH + 8 * j + 2 * tig);
        const float hv[4] = {h0.x, h0.y, h1.x, h1.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[j][i] *= 1.0f - exp2_approx(-hv[i] * 1.4426950408889634f);
        *reinterpret_cast<float2*>(sD + gid * kSD + 8 * j + 2 * tig) = make_float2(dh[j][0], dh[j][1]);
        *reinterpret_cast<float2*>(sD + (gid + 8) * kSD + 8 * j + 2 * tig) =
            make_float2(dh[j][2], dh[j][3]);
      }
      // df / 3 = dh' [16 x 64] . W0 [64 x 32] / 3, into the slot
      float df[kC / 8][4];
#pragma unroll
      for (int k = 0; k < kC / 8; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) df[k][i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kHid / 8; ++j) {
        const float a[4] = {dh[j][0], dh[j][2], dh[j][1], dh[j][3]};
        uint32_t ah[4], al[4];
        split_tf32(a, ah, al);
#pragma unroll
        for (int k = 0; k < kC / 8; ++k) mma_split_tf32(df[k], ah, al, p4[(j * 4 + k) * 32 + lane]);
      }
      constexpr float kThird = 1.0f / 3.0f;
#pragma unroll
      for (int k = 0; k < kC / 8; ++k) {
        *reinterpret_cast<float2*>(sG + gid * kSG + 8 * k + 2 * tig) =
            make_float2(df[k][0] * kThird, df[k][1] * kThird);
        *reinterpret_cast<float2*>(sG + (gid + 8) * kSG + 8 * k + 2 * tig) =
            make_float2(df[k][2] * kThird, df[k][3] * kThird);
      }
      __syncwarp();
      // the scatter: 8 lanes a point, a 16 B piece of each corner row each
#pragma unroll 1
      for (int r = 0; r < kTile / 4; ++r) {
        const int p = 4 * r + grp;
        const long long n = n0 + p;
        if (n >= total) continue;
        const float4 g4 = *reinterpret_cast<const float4*>(sG + p * kSG + 4 * q);
        const float px = __ldg(coords + 3 * n + 0) * coord_scale;
        const float py = __ldg(coords + 3 * n + 1) * coord_scale;
        const float pz = __ldg(coords + 3 * n + 2) * coord_scale;
        const long long b = B == 1 ? 0 : n / n_per_batch;
        float* const dbase = dplanes + b * 3 * plane_elems + 4 * q;
#pragma unroll 1
        for (int k = 0; k < 3; ++k) {
          const float u = k == 2 ? pz : px, v = k == 0 ? py : (k == 1 ? pz : px),
                      t = k == 0 ? pz : py;
          Corners c;
          grid_corners<kGrid>(c, D, H, W, u, v, t);
          float* const g = dbase + k * plane_elems;
#pragma unroll
          for (int i = 0; i < (kGrid ? 8 : 4); ++i) {
            if (!c.ok[i]) continue;
            const float4 v = make_float4(g4.x * c.w[i], g4.y * c.w[i], g4.z * c.w[i],
                                         g4.w * c.w[i]);
            if (kGrid)
              red_add4_policy(g + c.off[i], v, keep_policy);
            else
              r3dp_atomic_add4(g + c.off[i], v);
          }
        }
      }
    }
    team_sync(team);  // the round's slots are staged
    // the weight gradients over the round's points: tile wit + 4 k of the 45
#pragma unroll
    for (int k = 0; k < kWgPer; ++k) {
      const int tt = wit + kTeam * k;
      if (tt >= kWgTiles) continue;
      const bool first = tt < 25;  // d W1^T: A = [h | 1]^T, B = dout; else d W0: dh'^T, [f | 1]
      const int mi = first ? tt / 5 : (tt - 25) / 5, ni = first ? tt % 5 : (tt - 25) % 5;
      const int a_off = first ? kTile * kSF + 16 * mi + gid : kTile * (kSF + kSH + kSO) + 16 * mi + gid;
      const int b_off = first ? kTile * (kSF + kSH) + 8 * ni + gid : 8 * ni + gid;
      const int as = first ? kSH : kSD, bs = first ? kSO : kSF;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
      for (int sl = 0; sl < n_slots; ++sl) {
        const float* slot = team_slots + sl * kSlot;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const float* ap = slot + a_off + (8 * ks + tig) * as;
          const float* bp = slot + b_off + (8 * ks + tig) * bs;
          const float a[4] = {ap[0], ap[8], ap[4 * as], ap[4 * as + 8]};
          mma_split_both(part, a, bp[0], bp[4 * bs]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) wacc[k][i] += part[i];
    }
    team_sync(team);  // the slots are read
  }
  // accumulator element i of tile (mi, ni): row 16 mi + gid + 8 (i / 2),
  // column 8 ni + 2 tig + i % 2
#pragma unroll
  for (int k = 0; k < kWgPer; ++k) {
    const int tt = wit + kTeam * k;
    if (tt >= kWgTiles) continue;
    const bool first = tt < 25;
    const int mi = first ? tt / 5 : (tt - 25) / 5, ni = first ? tt % 5 : (tt - 25) % 5;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * mi + gid + 8 * (i / 2), c = 8 * ni + 2 * tig + i % 2;
      if (first) {  // r: hidden (64: the bias row), c: W1p's row
        if (r > kHid || c > kC) continue;
        const int o = c < kC ? c + 1 : 0;
        atomicAdd(r < kHid ? dw1 + o * kHid + r : db1 + o, wacc[k][i]);
      } else {      // r: hidden, c: feature (32: the bias column)
        if (c > kC) continue;
        atomicAdd(c < kC ? dw0 + r * kC + c : db0 + r, wacc[k][i]);
      }
    }
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
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return (int)err;
  }
  // one CTA an SM (the shared memory allows no second), walking the rounds
  const long long rounds = ((total + kTile - 1) / kTile + kBwWarps - 1) / kBwWarps;
  kernel<<<(unsigned int)(rounds < sms ? rounds : sms), kBwThreads, kBwSmemBytes, stream>>>(
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
