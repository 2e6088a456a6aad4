// A probe, not a kernel of the port: the first design of K5b's adjoint (one
// thread a voxel looping over its C / 4 channel quads, one 16 B atomic a
// corner and quad; csrc/torso_warp.cu's warp_volume_adjoint_kernel
// replaced it) in three modes, so that inference/kernel_times.py --only
// k5bp can split its time:
//   mode 0, the whole kernel; mode 1, its atomics alone (no corner read, the
//   deformation's gradient from zero dots); mode 2, its corner reads and the
//   deformation's gradient alone (no atomic);
// and, mode 3, the atomics alone in warp_volume_adjoint_kernel's layout (a
// 32-voxel tile of a row, 8 lanes a voxel's 128 B rows, 4 lines a warp
// instruction), of the weights alone (no dout, no corner read, no
// deformation gradient): the floor that the atomics set for that kernel.
// Built by kernel_times.py with the port's nvcc flags into build/torch_kernels/.
#include "common.cuh"

namespace {

__device__ __forceinline__ float unnorm_ac(float c, int n) {
  return (c + 1.0f) / 2.0f * (float)(n - 1);
}

__global__ void __launch_bounds__(256)
adjoint_parts_kernel(const float* __restrict__ dout, const float4* __restrict__ vol,
                     const float* __restrict__ grid, int B, int C, int D, int H, int W,
                     float* __restrict__ dvol, float* __restrict__ dgrid, int mode) {
  const long long hw = (long long)H * W, vox = (long long)D * hw;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * vox) return;
  const long long sp = n % vox;
  const int b = (int)(n / vox);
  float wgt[8];
  int idx[8];
  const float* g = grid + (b * vox + sp) * 3;
  const float rx = unnorm_ac(__ldg(g), W), ry = unnorm_ac(__ldg(g + 1), H),
              rz = unnorm_ac(__ldg(g + 2), D);
  const float mx = rx > 0.0f && rx < (float)(W - 1) ? 0.5f * (float)(W - 1) : 0.0f;
  const float my = ry > 0.0f && ry < (float)(H - 1) ? 0.5f * (float)(H - 1) : 0.0f;
  const float mz = rz > 0.0f && rz < (float)(D - 1) ? 0.5f * (float)(D - 1) : 0.0f;
  const float x = fminf(fmaxf(rx, 0.0f), (float)(W - 1));
  const float y = fminf(fmaxf(ry, 0.0f), (float)(H - 1));
  const float z = fminf(fmaxf(rz, 0.0f), (float)(D - 1));
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
  const float lx0 = __fsub_rn(fx + 1.0f, x), lx1 = __fsub_rn(x, fx);
  const float ly0 = __fsub_rn(fy + 1.0f, y), ly1 = __fsub_rn(y, fy);
  const float lz0 = __fsub_rn(fz + 1.0f, z), lz1 = __fsub_rn(z, fz);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cx = ix + (i & 1), cy = iy + ((i >> 1) & 1), cz = iz + (i >> 2);
    idx[i] = cx < W && cy < H && cz < D ? (cz * H + cy) * W + cx : -1;
    wgt[i] = __fmul_rn(__fmul_rn(i & 1 ? lx1 : lx0, (i >> 1) & 1 ? ly1 : ly0),
                       i >> 2 ? lz1 : lz0);
  }
  float dwx = 0.0f, dwy = 0.0f, dwz = 0.0f;
  float* dv = dvol + (long long)b * vox * C;
  for (int q = 0; q < C / 4; ++q) {
    const float* o = dout + ((long long)b * C + 4 * q) * vox + sp;
    const float4 go = make_float4(__ldg(o), __ldg(o + vox), __ldg(o + 2 * vox),
                                  __ldg(o + 3 * vox));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (idx[i] < 0) continue;
      float dot = 0.0f;
      if (mode != 1) {
        const float4 v = __ldg(vol + ((long long)b * vox + idx[i]) * (C / 4) + q);
        dot = go.x * v.x + go.y * v.y + go.z * v.z + go.w * v.w;
      }
      const float wx = i & 1 ? lx1 : lx0, wy = (i >> 1) & 1 ? ly1 : ly0, wz = i >> 2 ? lz1 : lz0;
      const float sx = i & 1 ? 1.0f : -1.0f, sy = (i >> 1) & 1 ? 1.0f : -1.0f,
                  sz = i >> 2 ? 1.0f : -1.0f;
      dwx += dot * sx * wy * wz;
      dwy += dot * wx * sy * wz;
      dwz += dot * wx * wy * sz;
      if (mode != 2 && wgt[i] != 0.0f)
        r3dp_atomic_add4(dv + (long long)idx[i] * C + 4 * q,
                         make_float4(go.x * wgt[i], go.y * wgt[i], go.z * wgt[i],
                                     go.w * wgt[i]));
    }
  }
  float* gg = dgrid + (b * vox + sp) * 3;
  gg[0] = dwx * mx;
  gg[1] = dwy * my;
  gg[2] = dwz * mz;
}

// mode 3: grid (ceil(W / 32), H, B * D), 256 threads (C = 32)
__global__ void __launch_bounds__(256)
tile_atomics_kernel(const float* __restrict__ grid, int D, int H, int W,
                    float4* __restrict__ dvol) {
  __shared__ int4 s_step[32];
  __shared__ float s_wgt[32][8];
  const int bd = blockIdx.z, b = bd / D, h = blockIdx.y, w0 = blockIdx.x * 32;
  const int t = threadIdx.x;
  const int nvox = min(32, W - w0), hw = H * W;
  if (t < 32) {
    int4 step = make_int4(0, 0, 0, 0);
    float l[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (t < nvox) {
      const float* g = grid + ((long long)bd * hw + h * W + w0 + t) * 3;
      const float x = fminf(fmaxf(unnorm_ac(g[0], W), 0.0f), (float)(W - 1));
      const float y = fminf(fmaxf(unnorm_ac(g[1], H), 0.0f), (float)(H - 1));
      const float z = fminf(fmaxf(unnorm_ac(g[2], D), 0.0f), (float)(D - 1));
      const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
      const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
      step = make_int4(((iz * H + iy) * W + ix) * 8, ix < W - 1 ? 8 : 0, iy < H - 1 ? W * 8 : 0,
                       iz < D - 1 ? hw * 8 : 0);
      l[0] = fx + 1.0f - x, l[1] = x - fx, l[2] = fy + 1.0f - y, l[3] = y - fy;
      l[4] = fz + 1.0f - z, l[5] = z - fz;
    }
    s_step[t] = step;
    for (int i = 0; i < 8; ++i)
      s_wgt[t][i] = l[i & 1] * l[2 + ((i >> 1) & 1)] * l[4 + (i >> 2)];
  }
  __syncthreads();
  const int q = t % 8, v = t / 8;
  const int4 s = s_step[v];
  const int off[8] = {0, s.y, s.z, s.z + s.y, s.w, s.w + s.y, s.w + s.z, s.w + s.z + s.y};
  float* p = reinterpret_cast<float*>(dvol + (long long)b * D * hw * 8 + s.x + q);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float wg = s_wgt[v][i];
    if (wg != 0.0f) r3dp_atomic_add4(p + 4 * off[i], make_float4(wg, wg, wg, wg));
  }
}

}  // namespace

// vol [B,D,H,W,C], grid [B,D,H,W,3], dout [B,C*D,H,W] -> dvol (zeroed by the
// caller), dgrid; C a multiple of 4 (32 for mode 3); mode 0-3 as above.
R3DP_EXPORT int r3dp_k5b_adjoint_parts(const float* vol, const float* grid, const float* dout,
                                       int B, int D, int H, int W, int C, float* dvol,
                                       float* dgrid, int mode, cudaStream_t stream) {
  if (C % 4 || mode < 0 || mode > 3 || (mode == 3 && C != 32))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * D * H * W;
  if (n == 0) return (int)cudaGetLastError();
  if (mode == 3) {
    tile_atomics_kernel<<<dim3((W + 31) / 32, H, B * D), 256, 0, stream>>>(
        grid, D, H, W, reinterpret_cast<float4*>(dvol));
    return (int)cudaGetLastError();
  }
  adjoint_parts_kernel<<<r3dp_blocks(n, 256), 256, 0, stream>>>(
      dout, reinterpret_cast<const float4*>(vol), grid, B, C, D, H, W, dvol, dgrid, mode);
  return (int)cudaGetLastError();
}
