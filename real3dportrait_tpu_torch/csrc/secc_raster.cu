// K4 secc_raster: forward z-buffer of the BFM mesh into an NCC (SECC) map,
// from camera-space vertices.
//
// Replaces, in the JAX package: geometry/rasterizer.py rasterize_grouped
// (with project_to_screen, _candidate_keys_lane_major and the static face
// buckets of split_faces_by_px_bound). On the TPU every face emits a fixed
// K x K patch of candidate keys (pixel, 15-bit quantised depth) that are
// sorted twice to find each pixel's winner, because scatters are slow there.
//
// Semantics kept: the camera u = (c + f x / z) s, v = (c - f y / z) s with
// s = size / 2c; screen-space affine barycentrics at pixel centres (pytorch3d
// perspective_correct=False), edge functions at px = x + 0.5, coverage
// b >= 0 inclusive, |area| > 1e-9, znear < depth < zfar, NCC interpolated
// with the winning face's barycentrics, a 0/1 coverage mask. The output map
// is the SECC map in [-1, 1], 2 * ncc - 1 (-1 where nothing covers the
// pixel), so that the SECC renderer's [0,1] -> [-1,1] map costs no pass of
// its own.
//
// One deliberate difference: the winner is the face of least EXACT depth,
// ties broken by the lower face id, through a 64-bit key
// (float bits of depth << 32 | face id; depth > znear >= 0, so the bits
// order as the depths). The JAX rasterizer takes the least depth quantised
// to 15 bits at 192^2 and breaks ties in no fixed order, so at pixels where
// two faces' depths agree to within that quantum the two can pick different
// faces. Coverage does not depend on the winner; the NCC there differs only
// by the NCC change across the shared edge.
//
// What bounds it on an H100: latency and issue, not bytes. One frame of the
// 70k-face mesh at 192^2 moves ~2.3 MB (vertices, faces, colours, the maps:
// 0.7 us at the HBM rate) but runs a chain of dependent loads per face
// (face, vertices) and ~366k box pixels, ~200k of them covered, each a
// 64-bit atomicMin into a 295 KB z-buffer that stays in L2. Design: two
// launches and nothing else. The z-test runs one thread per (frame, face):
// it projects the face's three vertices itself, then walks the face's
// clipped pixel box deciding coverage from the signs of the three edge
// functions (folded with the area's sign into the face's deltas), so the
// three IEEE divisions of the barycentrics run only at pixels that may be
// covered. The resolve runs one thread per
// pixel: it reads the pixel's key, writes EMPTY back (the wrapper keeps one
// z-buffer and fills it only when it allocates it), projects the winning
// face again and interpolates its colours, and a block stores its maps
// through shared memory as whole rows. Every operation that the plain
// PyTorch version also does is rounded as it does it (explicitly rounded
// intrinsics, no FMA contraction), so the two are bit-equal.
#include "common.cuh"

namespace {

constexpr int kRasterThreads = 256;
// up to kGroupFaces (frame, face) pairs a call, kGroup lanes share a face's
// pixel box, so that one frame's faces still fill the card
constexpr int kGroup = 2;
constexpr long long kGroupFaces = 1 << 18;
constexpr unsigned long long kEmpty = 0x7fffffffffffffffull;  // INT64_MAX

struct Camera {
  float focal, center, scale;  // scale = size / (2 center), rounded to fp32
};

// project_to_screen, one vertex: u = (c + f x / z) s, v = (c - f y / z) s
__device__ __forceinline__ void project(const float* __restrict__ v, const Camera& cam,
                                        float* u, float* w, float* z) {
  const float x = v[0], y = v[1];
  *z = v[2];
  *u = __fmul_rn(__fadd_rn(cam.center, __fdiv_rn(__fmul_rn(cam.focal, x), *z)), cam.scale);
  *w = __fmul_rn(__fsub_rn(cam.center, __fdiv_rn(__fmul_rn(cam.focal, y), *z)), cam.scale);
}

// edge(a, b, p) = (px - ax) * (by - ay) - (py - ay) * (bx - ax)
__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by,
                                         float px, float py) {
  return __fsub_rn(__fmul_rn(__fsub_rn(px, ax), __fsub_rn(by, ay)),
                   __fmul_rn(__fsub_rn(py, ay), __fsub_rn(bx, ax)));
}

struct Tri {
  float x0, y0, x1, y1, x2, y2, z0, z1, z2;
  float area;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ verts,
                                        const int* __restrict__ f, const Camera& cam) {
  Tri t;
  project(verts + 3 * f[0], cam, &t.x0, &t.y0, &t.z0);
  project(verts + 3 * f[1], cam, &t.x1, &t.y1, &t.z1);
  project(verts + 3 * f[2], cam, &t.x2, &t.y2, &t.z2);
  t.area = edge_fn(t.x0, t.y0, t.x1, t.y1, t.x2, t.y2);
  return t;
}

// Coverage from the signs: with s = sign(area), s * e is computed exactly
// as the edge function over the deltas times s (a negation commutes with
// rounding), and e / area = (s e) / |area| bit for bit. s e <= -2^-100
// |area| means e / area < 0 for certain: the quotient cannot underflow to
// -0, which passes b >= 0. An edge of +-0, a NaN, or a tiny one of the
// other sign is left to the division.
struct SignedEdges {
  float ax[3], ay[3], dy[3], dx[3];  // edge i: (px - ax) * dy - (py - ay) * dx
  float abs_area, neg_thr;

  __device__ __forceinline__ explicit SignedEdges(const Tri& t) {
    const float s = t.area > 0.0f ? 1.0f : -1.0f;
    const float x[3] = {t.x0, t.x1, t.x2}, y[3] = {t.y0, t.y1, t.y2};
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // edge i runs from vertex i + 1 to i + 2
      const int a = (i + 1) % 3, b = (i + 2) % 3;
      ax[i] = x[a];
      ay[i] = y[a];
      dy[i] = __fmul_rn(s, __fsub_rn(y[b], y[a]));
      dx[i] = __fmul_rn(s, __fsub_rn(x[b], x[a]));
    }
    abs_area = fabsf(t.area);
    neg_thr = -(abs_area * 0x1p-100f);
  }

  // s * edge i at (px, py)
  __device__ __forceinline__ float at(int i, float px, float py) const {
    return __fsub_rn(__fmul_rn(__fsub_rn(px, ax[i]), dy[i]),
                     __fmul_rn(__fsub_rn(py, ay[i]), dx[i]));
  }
};

// Block row y is frame y. G lanes a face: lane g takes the face's box
// pixels g, g + G, ... in row-major order (G = 1 where there are faces
// enough to fill the card).
template <int G>
__global__ void __launch_bounds__(kRasterThreads) secc_zbuffer_kernel(
    const float* __restrict__ verts, int N, const int* __restrict__ faces, int F,
    Camera cam, int size, float znear, float zfar, unsigned long long* __restrict__ zbuf) {
  const int frame = blockIdx.y;
  const int lane = blockIdx.x * kRasterThreads + threadIdx.x;
  const int face = lane / G;
  if (face >= F) return;
  const Tri t = load_tri(verts + (long long)frame * N * 3, faces + 3 * face, cam);
  if (!(fabsf(t.area) > 1e-9f)) return;
  const SignedEdges se(t);

  const int x_lo = max((int)floorf(fminf(t.x0, fminf(t.x1, t.x2))), 0);
  const int y_lo = max((int)floorf(fminf(t.y0, fminf(t.y1, t.y2))), 0);
  const int x_hi = min((int)floorf(fmaxf(t.x0, fmaxf(t.x1, t.x2))), size - 1);
  const int y_hi = min((int)floorf(fmaxf(t.y0, fmaxf(t.y1, t.y2))), size - 1);
  if (x_hi < x_lo || y_hi < y_lo) return;
  unsigned long long* fb = zbuf + (long long)frame * size * size;
  auto visit = [&](int x, int y) {
    const float px = (float)x + 0.5f, py = (float)y + 0.5f;
    const float e0 = se.at(0, px, py), e1 = se.at(1, px, py), e2 = se.at(2, px, py);
    if (e0 <= se.neg_thr || e1 <= se.neg_thr || e2 <= se.neg_thr) return;
    const float b0 = __fdiv_rn(e0, se.abs_area), b1 = __fdiv_rn(e1, se.abs_area),
                b2 = __fdiv_rn(e2, se.abs_area);
    if (!(b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f)) return;
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(b0, t.z0), __fmul_rn(b1, t.z1)),
                              __fmul_rn(b2, t.z2));
    if (!(d > znear && d < zfar)) return;
    atomicMin(fb + (long long)y * size + x,
              ((unsigned long long)__float_as_uint(d) << 32) | (unsigned int)face);
  };
  if constexpr (G == 1) {
    for (int y = y_lo; y <= y_hi; ++y)
      for (int x = x_lo; x <= x_hi; ++x) visit(x, y);
  } else {
    const int w = x_hi - x_lo + 1, n = w * (y_hi - y_lo + 1);
    for (int i = lane % G; i < n; i += G) visit(x_lo + i % w, y_lo + i / w);
  }
}

// Block row y is frame y, one thread a pixel.
__global__ void __launch_bounds__(kRasterThreads) secc_resolve_kernel(
    const float* __restrict__ verts, int N, const int* __restrict__ faces,
    const float* __restrict__ attr, Camera cam, int size, unsigned long long* __restrict__ zbuf, float* __restrict__ mask,
    float* __restrict__ image) {
  __shared__ float sh_img[3 * kRasterThreads];
  const int frame = blockIdx.y, hw = size * size;
  const int first = blockIdx.x * kRasterThreads, pix = first + threadIdx.x;
  const long long at = (long long)frame * hw + pix;
  float out[3] = {-1.0f, -1.0f, -1.0f};
  if (pix < hw) {
    const unsigned long long key = zbuf[at];
    float m = 0.0f;
    if (key != kEmpty) {
      zbuf[at] = kEmpty;  // clean for the next call
      const int* f = faces + 3 * (int)(key & 0xffffffffull);
      const Tri t = load_tri(verts + (long long)frame * N * 3, f, cam);
      const float px = (float)(pix % size) + 0.5f, py = (float)(pix / size) + 0.5f;
      const float b0 = __fdiv_rn(edge_fn(t.x1, t.y1, t.x2, t.y2, px, py), t.area);
      const float b1 = __fdiv_rn(edge_fn(t.x2, t.y2, t.x0, t.y0, px, py), t.area);
      const float b2 = __fdiv_rn(edge_fn(t.x0, t.y0, t.x1, t.y1, px, py), t.area);
      const float* a0 = attr + 3 * f[0];
      const float* a1 = attr + 3 * f[1];
      const float* a2 = attr + 3 * f[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = __fadd_rn(__fadd_rn(__fmul_rn(b0, a0[c]), __fmul_rn(b1, a1[c])),
                                  __fmul_rn(b2, a2[c]));
        out[c] = __fadd_rn(__fmul_rn(v, 2.0f), -1.0f);  // [0,1] -> [-1,1]
      }
      m = 1.0f;
    }
    mask[at] = m;
  }
  // the block's pixels' 3 floats each are contiguous in the image: store
  // them as coalesced rows through shared memory
#pragma unroll
  for (int c = 0; c < 3; ++c) sh_img[3 * threadIdx.x + c] = out[c];
  __syncthreads();
  const int n = 3 * min(kRasterThreads, hw - first);
  float* dst = image + 3 * ((long long)frame * hw + first);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k = i * kRasterThreads + threadIdx.x;
    if (k < n) dst[k] = sh_img[k];
  }
}

}  // namespace

// verts [T,N,3] camera space; faces [F,3] int32 in [0, N); attr [N,3];
// camera focal, center (pixel scale size / (2 center)); 0 <= znear; zbuf
// [T,size*size] holds EMPTY (INT64_MAX) on entry and on return; mask
// [T,size,size]; image [T,size,size,3] = 2 * ncc - 1 (-1 outside the mask).
R3DP_EXPORT int r3dp_secc_raster(const float* verts, int T, int N, const int* faces, int F,
                                 const float* attr, float focal, float center,
                                 float pixel_scale, int size, float znear, float zfar,
                                 unsigned long long* zbuf,
                                 float* mask, float* image, cudaStream_t stream) {
  if (T > 65535 || (long long)F * kGroup >= (1LL << 31) || (long long)size * size >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (T < 1 || size < 1) return (int)cudaGetLastError();
  const Camera cam{focal, center, pixel_scale};
  if (F > 0) {
    if ((long long)T * F > kGroupFaces)
      secc_zbuffer_kernel<1><<<dim3(r3dp_blocks(F, kRasterThreads), T), kRasterThreads, 0,
                               stream>>>(verts, N, faces, F, cam, size, znear, zfar, zbuf);
    else
      secc_zbuffer_kernel<kGroup><<<dim3(r3dp_blocks((long long)F * kGroup, kRasterThreads), T),
                                    kRasterThreads, 0, stream>>>(verts, N, faces, F, cam, size,
                                                                 znear, zfar, zbuf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  secc_resolve_kernel<<<dim3(r3dp_blocks((long long)size * size, kRasterThreads), T),
                        kRasterThreads, 0, stream>>>(verts, N, faces, attr, cam, size, zbuf,
                                                     mask, image);
  return (int)cudaGetLastError();
}
