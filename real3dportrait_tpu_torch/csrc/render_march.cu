// K2 importance_sample and K3 merge_composite: the per-ray halves of the
// two-pass volume renderer.
//
// K2 replaces, in the JAX package: rendering/ray_marcher.py march_weights
// (the coarse call in render_rays, whose transmittance cumprod the TPU runs
// as a log-space matmul against a triangular ones matrix) and
// rendering/renderer.py _smooth_weights, _sample_pdf and sample_importance
// (a comparison-count searchsorted plus one [R, n, s+2] one-hot einsum for
// the index lookups).
//
// K3 replaces rendering/renderer.py _merge_sorted_samples and _march_merged
// (an [R, S, S] one-hot permutation matmul that merges the sorted coarse and
// fine samples, then a composite einsum).
//
// What bounds them on an H100: neither does enough arithmetic to matter
// (tens of flops per sample). K2 reads 2 x S_c floats and writes S_f floats
// per ray; K3 reads the fat colour tensors, (S_c + S_f) x 32 fp32 per ray
// (6-12 KB), which is almost all of its traffic. Both are latency-bound
// sequential scans along a short sample axis. Design: one warp per ray, and
// no one-hot matrix or permutation is materialised. K2: the march and cdf
// scans are short, so every lane runs them redundantly on values that the
// warp reads from the same addresses (one transaction per load), and each
// lane then takes its own fine samples for the inverse-CDF lookup. K3: one
// lane merges the two lists into shared memory (a two-pointer merge, robust
// to an unsorted ulp), the warp marches the merged samples with the
// transmittance as a warp product scan, and each lane composites one colour
// channel, so the colour rows are read as coalesced 128 B lines.
#include "common.cuh"

namespace {

constexpr int kMaxS = 128;  // longest per-ray sample list a kernel takes

// Volume-rendering weights of one ray (march_weights): midpoint density
// softplus(sigma - 1), alpha = 1 - exp(-sigma * delta), transmittance
// cumprod of (1 - alpha + 1e-10). Writes S-1 weights, returns their sum.
__device__ __forceinline__ float march(const float* d, const float* sg, int S,
                                       float* w) {
  float trans = 1.0f, total = 0.0f;
  for (int i = 0; i < S - 1; ++i) {
    float delta = d[i + 1] - d[i];
    float dens = r3dp_softplus((sg[i] + sg[i + 1]) / 2.0f - 1.0f);
    float alpha = 1.0f - expf(-(dens * delta));
    w[i] = alpha * trans;
    total += w[i];
    trans *= 1.0f - alpha + 1e-10f;
  }
  return total;
}

__global__ void importance_sample_kernel(const float* __restrict__ depths,
                                         const float* __restrict__ sigma,
                                         const float* __restrict__ u, int R,
                                         int S, int NF,
                                         float* __restrict__ fine) {
  long long ray = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (ray >= R) return;
  const float* d = depths + ray * S;
  const float* sg = sigma + ray * S;
  const float eps = 1e-5f;

  float w[kMaxS];
  march(d, sg, S, w);

  // _smooth_weights: max-pool(2, pad -inf) then avg-pool(2) then +0.01;
  // _sample_pdf uses the S-3 interior values k = 1 .. S-3.
  int s = S - 3;
  float pw[kMaxS];
  float total = 0.0f;
  for (int j = 0; j < s; ++j) {
    int k = j + 1;
    float m0 = fmaxf(w[k - 1], w[k]);
    float m1 = (k + 1 <= S - 2) ? fmaxf(w[k], w[k + 1]) : w[k];
    pw[j] = (m0 + m1) / 2.0f + 0.01f + eps;
    total += pw[j];
  }
  float cdf[kMaxS];
  cdf[0] = 0.0f;
  float acc = 0.0f;
  for (int j = 0; j < s; ++j) {
    acc += pw[j] / total;
    cdf[j + 1] = acc;
  }

  for (int j = lane; j < NF; j += 32) {
    float uu = u[ray * NF + j];
    // searchsorted(cdf, u, side='right') as a count of cdf <= u
    int inds = 0;
    for (int t = 0; t <= s; ++t) inds += (cdf[t] <= uu) ? 1 : 0;
    int below = max(inds - 1, 0);
    int above = min(below + 1, s);
    float cdf_b = cdf[below], cdf_a = cdf[above];
    float bins_b = (d[below] + d[below + 1]) / 2.0f;
    float bins_a = (d[above] + d[above + 1]) / 2.0f;
    float denom = cdf_a - cdf_b;
    if (denom < eps) denom = 1.0f;
    fine[ray * NF + j] = bins_b + (uu - cdf_b) / denom * (bins_a - bins_b);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kMergeWarps = 4;  // rays per block of merge_composite

__global__ void __launch_bounds__(32 * kMergeWarps) merge_composite_kernel(
    const float* __restrict__ d1, const float* __restrict__ c1,
    const float* __restrict__ s1, int S1, const float* __restrict__ d2,
    const float* __restrict__ c2, const float* __restrict__ s2, int S2, int R,
    int C, int white_back, float* __restrict__ rgb, float* __restrict__ depth,
    float* __restrict__ weights) {
  __shared__ float sh_d[kMergeWarps][kMaxS];
  __shared__ float sh_s[kMergeWarps][kMaxS];
  __shared__ float sh_w[kMergeWarps][kMaxS];
  __shared__ int sh_src[kMergeWarps][kMaxS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kMergeWarps + warp;
  if (ray >= R) return;
  const int S = S1 + S2;
  float* md = sh_d[warp];
  float* ms = sh_s[warp];
  float* w = sh_w[warp];
  int* src = sh_src[warp];

  // two-pointer merge of the sorted lists by one lane into shared memory; a
  // coarse sample goes before an equal fine one. src < S1 indexes set 1,
  // src >= S1 indexes set 2.
  if (lane == 0) {
    const float* rd1 = d1 + ray * S1;
    const float* rd2 = d2 + ray * S2;
    int i = 0, j = 0;
    for (int k = 0; k < S; ++k) {
      bool take1 = i < S1 && (j >= S2 || rd1[i] <= rd2[j]);
      if (take1) {
        md[k] = rd1[i];
        ms[k] = s1[ray * S1 + i];
        src[k] = i++;
      } else {
        md[k] = rd2[j];
        ms[k] = s2[ray * S2 + j];
        src[k] = S1 + j++;
      }
    }
  }
  __syncwarp();

  // march: lane k of each 32-interval chunk takes interval k; the
  // transmittance cumprod of (1 - alpha + 1e-10) is a warp product scan
  // carried across chunks
  float carry = 1.0f, total = 0.0f, dnum = 0.0f;
  for (int base = 0; base < S - 1; base += 32) {
    const int k = base + lane;
    const bool on = k < S - 1;
    float alpha = 0.0f, mid = 0.0f;
    if (on) {
      float delta = md[k + 1] - md[k];
      float dens = r3dp_softplus((ms[k] + ms[k + 1]) / 2.0f - 1.0f);
      alpha = 1.0f - expf(-(dens * delta));
      mid = (md[k] + md[k + 1]) / 2.0f;
    }
    float incl = on ? 1.0f - alpha + 1e-10f : 1.0f;
    for (int off = 1; off < 32; off <<= 1) {
      float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl *= o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 1.0f;
    float wk = alpha * (carry * excl);
    if (on) w[k] = wk;
    total += wk;
    dnum += wk * mid;
    carry *= __shfl_sync(0xffffffffu, incl, 31);
  }
  total = warp_sum(total);
  dnum = warp_sum(dnum);
  __syncwarp();

  // composite, one lane per channel (coalesced colour rows), with the
  // midpoint quadrature re-indexed onto samples:
  // w_c[k] = (w[k-1] + w[k]) / 2 with w[-1] = w[S-1] = 0
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
    for (int k = 0; k < S; ++k) {
      float wl = k > 0 ? w[k - 1] : 0.0f;
      float wr = k < S - 1 ? w[k] : 0.0f;
      int t = src[k];
      float col = t < S1 ? c1[(ray * S1 + t) * C + c]
                         : c2[(ray * S2 + (t - S1)) * C + c];
      acc += (wl + wr) / 2.0f * col;
    }
    if (white_back) acc = acc + 1.0f - total;
    rgb[ray * C + c] = acc * 2.0f - 1.0f;
  }
  for (int k = lane; k < S - 1; k += 32) weights[ray * (S - 1) + k] = w[k];
  // unclipped: nan_to_num and the clip to the batch's depth range are
  // reductions over all rays and run after the kernel
  if (lane == 0) depth[ray] = dnum / total;
}

}  // namespace

// depths, sigma [R,S] (S <= 128, sorted depths); u [R,NF] in [0,1];
// fine [R,NF].
R3DP_EXPORT int r3dp_importance_sample(const float* depths, const float* sigma,
                                       const float* u, int R, int S, int NF,
                                       float* fine, cudaStream_t stream) {
  const int threads = 128;
  if (R > 0)
    importance_sample_kernel<<<r3dp_blocks((long long)R * 32, threads), threads,
                               0, stream>>>(depths, sigma, u, R, S, NF, fine);
  return (int)cudaGetLastError();
}

// d1, s1 [R,S1]; c1 [R,S1,C]; d2, s2 [R,S2]; c2 [R,S2,C]; S1 + S2 <= 128.
// rgb [R,C] (already mapped to [-1,1]), depth [R] unclipped, weights [R,S-1].
R3DP_EXPORT int r3dp_merge_composite(const float* d1, const float* c1,
                                     const float* s1, int S1, const float* d2,
                                     const float* c2, const float* s2, int S2,
                                     int R, int C, int white_back, float* rgb,
                                     float* depth, float* weights,
                                     cudaStream_t stream) {
  if (R > 0)
    merge_composite_kernel<<<r3dp_blocks(R, kMergeWarps), 32 * kMergeWarps, 0,
                             stream>>>(d1, c1, s1, S1, d2, c2, s2, S2, R, C,
                                       white_back, rgb, depth, weights);
  return (int)cudaGetLastError();
}
