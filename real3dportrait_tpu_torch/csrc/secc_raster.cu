// K4 secc_raster: forward z-buffer of the BFM mesh into an NCC (SECC) map.
//
// Replaces, in the JAX package: geometry/rasterizer.py rasterize_grouped
// with _candidate_keys_lane_major and the static face buckets of
// split_faces_by_px_bound. On the TPU every face emits a fixed K x K patch of
// candidate keys (pixel, 15-bit quantised depth) that are sorted twice to
// find each pixel's winner, because scatters are slow there.
//
// Semantics kept: screen-space affine barycentrics at pixel centres
// (pytorch3d perspective_correct=False), edge functions at px = x + 0.5,
// coverage b >= 0 inclusive, |area| > 1e-9, znear < depth < zfar, NCC
// interpolated with the winning face's barycentrics, a 0/1 coverage mask.
//
// One deliberate difference: the winner is the face of least EXACT depth,
// ties broken by the lower face id, through a 64-bit key
// (float bits of depth << 32 | face id). The JAX rasterizer takes the least
// depth quantised to 15 bits at 192^2 and breaks ties in no fixed order, so
// at pixels where two faces' depths agree to within that quantum the two
// can pick different faces. Coverage does not depend on the winner; the NCC
// there differs only by the NCC change across the shared edge.
//
// What bounds it on an H100: atomics. Pass 1 does one 64-bit atomicMin per
// covered (face, pixel) pair, ~3 per face at 192^2 (~200k per frame), into a
// 192^2 x 8 B = 295 KB z-buffer per frame that stays in L2. Design: pass 1
// runs one thread per (frame, face) and loops over the face's clipped pixel
// bounding box, so no candidate array and no sort exist; pass 2 runs one
// thread per pixel, decodes the winning face id and re-derives its
// barycentrics at the pixel centre. The arithmetic uses explicitly rounded
// operations (no FMA contraction) so that it is bit-equal to the plain
// PyTorch version, which does the same operations one tensor op at a time.
#include "common.cuh"

namespace {

// edge(a, b, p) = (px - ax) * (by - ay) - (py - ay) * (bx - ax)
__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by,
                                         float px, float py) {
  return __fsub_rn(__fmul_rn(__fsub_rn(px, ax), __fsub_rn(by, ay)),
                   __fmul_rn(__fsub_rn(py, ay), __fsub_rn(bx, ax)));
}

struct Tri {
  float x0, y0, x1, y1, x2, y2;
  float area;
};

__device__ __forceinline__ void barycentric(const Tri& t, float px, float py,
                                            float* b0, float* b1, float* b2) {
  *b0 = __fdiv_rn(edge_fn(t.x1, t.y1, t.x2, t.y2, px, py), t.area);
  *b1 = __fdiv_rn(edge_fn(t.x2, t.y2, t.x0, t.y0, px, py), t.area);
  *b2 = __fdiv_rn(edge_fn(t.x0, t.y0, t.x1, t.y1, px, py), t.area);
}

__device__ __forceinline__ Tri load_tri(const float* uv, const int* f) {
  Tri t;
  t.x0 = uv[2 * f[0]];
  t.y0 = uv[2 * f[0] + 1];
  t.x1 = uv[2 * f[1]];
  t.y1 = uv[2 * f[1] + 1];
  t.x2 = uv[2 * f[2]];
  t.y2 = uv[2 * f[2] + 1];
  t.area = edge_fn(t.x0, t.y0, t.x1, t.y1, t.x2, t.y2);
  return t;
}

__global__ void zbuffer_kernel(const float* __restrict__ uv,
                               const float* __restrict__ z, int T, int N,
                               const int* __restrict__ faces, int F, int size,
                               float znear, float zfar,
                               unsigned long long* __restrict__ zbuf) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)T * F) return;
  int frame = (int)(tid / F);
  int face = (int)(tid % F);
  const float* fuv = uv + (long long)frame * N * 2;
  const float* fz = z + (long long)frame * N;
  const int* f = faces + 3 * face;
  Tri t = load_tri(fuv, f);
  if (!(fabsf(t.area) > 1e-9f)) return;
  float z0 = fz[f[0]], z1 = fz[f[1]], z2 = fz[f[2]];

  int x_lo = max((int)floorf(fminf(t.x0, fminf(t.x1, t.x2))), 0);
  int y_lo = max((int)floorf(fminf(t.y0, fminf(t.y1, t.y2))), 0);
  int x_hi = min((int)floorf(fmaxf(t.x0, fmaxf(t.x1, t.x2))), size - 1);
  int y_hi = min((int)floorf(fmaxf(t.y0, fmaxf(t.y1, t.y2))), size - 1);
  unsigned long long* fb = zbuf + (long long)frame * size * size;
  for (int y = y_lo; y <= y_hi; ++y) {
    for (int x = x_lo; x <= x_hi; ++x) {
      float px = (float)x + 0.5f, py = (float)y + 0.5f;
      float b0, b1, b2;
      barycentric(t, px, py, &b0, &b1, &b2);
      if (!(b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f)) continue;
      float d = __fadd_rn(__fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1)),
                          __fmul_rn(b2, z2));
      if (!(d > znear && d < zfar)) continue;
      unsigned long long key =
          ((unsigned long long)__float_as_uint(d) << 32) | (unsigned int)face;
      atomicMin(fb + (long long)y * size + x, key);
    }
  }
}

__global__ void resolve_kernel(const float* __restrict__ uv, int T, int N,
                               const int* __restrict__ faces,
                               const float* __restrict__ attr, int size,
                               const unsigned long long* __restrict__ zbuf,
                               unsigned long long empty, float* __restrict__ mask,
                               float* __restrict__ image) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long hw = (long long)size * size;
  if (tid >= (long long)T * hw) return;
  int frame = (int)(tid / hw);
  int pix = (int)(tid % hw);
  unsigned long long key = zbuf[tid];
  float* out = image + 3 * tid;
  if (key == empty) {
    mask[tid] = 0.0f;
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  int face = (int)(key & 0xffffffffull);
  const int* f = faces + 3 * face;
  Tri t = load_tri(uv + (long long)frame * N * 2, f);
  float px = (float)(pix % size) + 0.5f, py = (float)(pix / size) + 0.5f;
  float b0, b1, b2;
  barycentric(t, px, py, &b0, &b1, &b2);
  const float* a0 = attr + 3 * f[0];
  const float* a1 = attr + 3 * f[1];
  const float* a2 = attr + 3 * f[2];
  for (int c = 0; c < 3; ++c)
    out[c] = __fadd_rn(__fadd_rn(__fmul_rn(b0, a0[c]), __fmul_rn(b1, a1[c])),
                       __fmul_rn(b2, a2[c]));
  mask[tid] = 1.0f;
}

}  // namespace

// uv [T,N,2] pixel coordinates, z [T,N] camera depth, faces [F,3] int32,
// attr [N,3]; zbuf [T,size*size] must hold `empty` (INT64_MAX) on entry;
// mask [T,size,size], image [T,size,size,3].
R3DP_EXPORT int r3dp_secc_raster(const float* uv, const float* z, int T, int N,
                                 const int* faces, int F, const float* attr,
                                 int size, float znear, float zfar,
                                 unsigned long long* zbuf, float* mask,
                                 float* image, cudaStream_t stream) {
  const int threads = 256;
  long long n_faces = (long long)T * F;
  long long n_pix = (long long)T * size * size;
  if (n_faces > 0)
    zbuffer_kernel<<<r3dp_blocks(n_faces, threads), threads, 0, stream>>>(
        uv, z, T, N, faces, F, size, znear, zfar, zbuf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_pix > 0)
    resolve_kernel<<<r3dp_blocks(n_pix, threads), threads, 0, stream>>>(
        uv, T, N, faces, attr, size, zbuf, 0x7fffffffffffffffull, mask, image);
  return (int)cudaGetLastError();
}
