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
// per ray (u is one row for every ray on the deterministic path, read
// through a ray stride of 0), 1-2 us of HBM time for a frame: it is bound
// by latency, the chain of scans along a short sample axis. Design: a
// group of W lanes a ray (W = 16, two rays a warp, where the ray has at most
// 16 intervals; else W = 32), its S - 1 intervals spread over the lanes,
// ceil((S - 1) / W) a lane, every value in registers. Each lane computes
// its own deltas, midpoint densities and alphas; the transmittance is a
// product scan across the group (shuffles, carried from one slot of W
// intervals to the next), the max-pool / avg-pool smoothing reads its
// neighbours through shuffles, the pdf's total is a group reduction and the
// CDF a sum scan. The CDF and the bin midpoints go to the group's slice of
// shared memory, and each lane finds its fine samples' bins by a binary
// search of ceil(log2(s + 1)) fixed steps (the count of cdf <= u, which is
// searchsorted's side='right' on the non-decreasing CDF), then
// interpolates in the plain version's order of operations.
//
// K3 reads the fat colour tensors, (S_c + S_f) x 32 fp32 per ray (6-12 KB,
// ~100 MB a frame at 16+32): it is bound by those bytes, 0.03-0.07 ms at
// the HBM rate, and reaches it only with enough colour rows in flight. One
// warp per ray, 8 rays a block. Before anything else a lane issues its
// first 12 colour loads (16 B each: 8 lanes a 128 B row, 4 rows a warp
// instruction, the ray's c1 rows then its c2 rows, contiguous), so that
// they land while the warp merges and marches. The merge is parallel: the
// warp loads both lists coalesced, and each lane ranks its own samples
// against the other list by a binary search in shared memory (a coarse
// sample goes before an equal fine one, JAX's tie rule) and scatters depth
// and density to that rank. The march is a warp product scan of the
// transmittance. Each merged composite weight is then pulled back to its
// source sample (w_cat[t] = w_c[pos[t]], as _march_merged does), so the
// colours are summed in concatenation order straight from the registers,
// and a shuffle adds the row groups' sums. Other widths (C / 4 not a power
// of two up to 32) and misaligned colour views take a scalar path of the
// same order, one lane a channel.
#include "common.cuh"

namespace {

constexpr int kMaxS = 128;  // longest per-ray sample list a kernel takes

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSampleThreads = 128;  // threads a block of importance_sample

// K2: a group of W lanes a ray, kSlots intervals a lane (W * kSlots >= S - 1).
// Every shuffle runs on the whole warp (a group whose ray lies past R
// computes on ray 0's samples and stores nothing), so the full mask holds.
template <int W, int kSlots>
__global__ void __launch_bounds__(kSampleThreads) importance_sample_kernel(
    const float* __restrict__ depths, const float* __restrict__ sigma,
    const float* __restrict__ u, long long u_stride, int R, int S, int NF,
    float* __restrict__ fine) {
  constexpr int kGroups = kSampleThreads / W;
  __shared__ float sh_cdf[kGroups][W * kSlots];
  __shared__ float sh_mid[kGroups][W * kSlots];
  const int group = threadIdx.x / W, lane = threadIdx.x % W;
  const long long ray = (long long)blockIdx.x * kGroups + group;
  const bool live = ray < R;
  const float* d = depths + (live ? ray : 0) * S;
  const float* sg = sigma + (live ? ray : 0) * S;
  float* cdf = sh_cdf[group];
  float* mid = sh_mid[group];
  const int n_int = S - 1;  // intervals; interval k lies between samples k, k + 1
  const int s = S - 3;      // smoothed weights that enter the pdf: k = 1 .. s
  const float eps = 1e-5f;

  // march: lane l of slot q takes interval k = q * W + l; alpha, then the
  // transmittance cumprod of (1 - alpha + 1e-10) as a product scan
  float w[kSlots];
  float trans = 1.0f;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    w[q] = 0.0f;
    if (q * W >= n_int) continue;  // the same for every lane of the warp
    const int k = q * W + lane;
    const bool on = k < n_int;
    float alpha = 0.0f;
    if (on) {
      const float d0 = d[k], d1 = d[k + 1];
      const float dens = r3dp_softplus((sg[k] + sg[k + 1]) / 2.0f - 1.0f);
      alpha = 1.0f - expf(-(dens * (d1 - d0)));
      mid[k] = (d0 + d1) / 2.0f;
    }
    float incl = on ? 1.0f - alpha + 1e-10f : 1.0f;
#pragma unroll
    for (int off = 1; off < W; off <<= 1) {
      const float o = __shfl_up_sync(kFull, incl, off, W);
      if (lane >= off) incl *= o;
    }
    float excl = __shfl_up_sync(kFull, incl, 1, W);
    if (lane == 0) excl = 1.0f;
    w[q] = alpha * (trans * excl);
    trans *= __shfl_sync(kFull, incl, W - 1, W);
  }

  // _smooth_weights at k = 1 .. s: (max(w[k-1], w[k]) + max(w[k], w[k+1]))
  // / 2 + 0.01, then _sample_pdf's + eps; the neighbours through shuffles
  float pw[kSlots];
  float total = 0.0f;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    float prev = __shfl_up_sync(kFull, w[q], 1, W);
    float next = __shfl_down_sync(kFull, w[q], 1, W);
    if (q > 0) {
      const float o = __shfl_sync(kFull, w[q - 1], W - 1, W);
      if (lane == 0) prev = o;
    }
    if (q + 1 < kSlots) {
      const float o = __shfl_sync(kFull, w[q + 1], 0, W);
      if (lane == W - 1) next = o;
    }
    const int k = q * W + lane;
    pw[q] = (k >= 1 && k <= s)
                ? (fmaxf(prev, w[q]) + fmaxf(w[q], next)) / 2.0f + 0.01f + eps
                : 0.0f;
    total += pw[q];
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off, W);

  // cdf[k] = pdf[1] + ... + pdf[k] (cdf[0] = 0): a sum scan of each pdf
  // term, carried from slot to slot
  float carry = 0.0f;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (q * W > s) continue;
    const int k = q * W + lane;
    float v = (k >= 1 && k <= s) ? pw[q] / total : 0.0f;
#pragma unroll
    for (int off = 1; off < W; off <<= 1) {
      const float o = __shfl_up_sync(kFull, v, off, W);
      if (lane >= off) v += o;
    }
    v += carry;
    if (k <= s) cdf[k] = v;
    carry = __shfl_sync(kFull, v, W - 1, W);
  }
  __syncwarp();
  if (!live) return;

  // inverse CDF: below = max(#(cdf <= u) - 1, 0), above = min(below + 1, s)
  const int n_cdf = s + 1;
  const int top = 1 << (31 - __clz(n_cdf));
  const float* ur = u + ray * u_stride;
  for (int j = lane; j < NF; j += W) {
    const float uu = ur[j];
    int cnt = 0;
    for (int step = top; step > 0; step >>= 1) {
      const int k = cnt + step;
      if (k <= n_cdf && cdf[k - 1] <= uu) cnt = k;
    }
    const int below = max(cnt - 1, 0);
    const int above = min(below + 1, s);
    const float cdf_b = cdf[below], cdf_a = cdf[above];
    const float bins_b = mid[below], bins_a = mid[above];
    float denom = __fsub_rn(cdf_a, cdf_b);
    if (denom < eps) denom = 1.0f;
    fine[ray * NF + j] = __fadd_rn(bins_b, __fmul_rn(__fdiv_rn(__fsub_rn(uu, cdf_b), denom),
                                                     __fsub_rn(bins_a, bins_b)));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

constexpr int kMergeWarps = 8;   // rays per block of merge_composite, one a warp
constexpr int kMergeSlots = kMaxS / 32;  // a lane's samples of one ray
constexpr int kMergeBatch = 12;  // 16 B colour loads a lane has in flight

// The count of a[0..n) below x (kInclusive: at or below x) for a sorted a,
// n < 128, by a binary search of 7 fixed steps.
template <bool kInclusive>
__device__ __forceinline__ int count_below(const float* a, int n, float x) {
  int lo = 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1) {
    const int k = lo + step;
    if (k <= n && (kInclusive ? a[k - 1] <= x : a[k - 1] < x)) lo = k;
  }
  return lo;
}

// kVec: C / 4 a power of two up to 32 and both colour tensors 16 B aligned;
// a ray's colour rows are then read as float4s, C / 4 lanes a row and
// 128 / C rows a warp instruction, kMergeBatch loads a lane in flight.
// Otherwise one lane a channel, one row at a time. Both sum in
// concatenation order.
template <bool kVec>
__global__ void __launch_bounds__(32 * kMergeWarps, 2) merge_composite_kernel(
    const float* __restrict__ d1, const float* __restrict__ c1,
    const float* __restrict__ s1, int S1, const float* __restrict__ d2,
    const float* __restrict__ c2, const float* __restrict__ s2, int S2, int R,
    int C, int white_back, float* __restrict__ rgb, float* __restrict__ depth,
    float* __restrict__ weights) {
  __shared__ float sh_key[kMergeWarps][kMaxS];
  __shared__ float sh_d[kMergeWarps][kMaxS];
  __shared__ float sh_s[kMergeWarps][kMaxS];
  __shared__ float sh_w[kMergeWarps][kMaxS];
  __shared__ float sh_wc[kMergeWarps][kMaxS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kMergeWarps + warp;
  if (ray >= R) return;
  const int S = S1 + S2;
  float* key = sh_key[warp];
  float* md = sh_d[warp];
  float* ms = sh_s[warp];
  float* w = sh_w[warp];
  float* wcat = sh_wc[warp];

  // the ray's depths and densities (coalesced, lane t of each 32 takes
  // sample t of the concatenation), then the first batch of colour rows,
  // issued before the merge and the march that they wait on
  float dv[kMergeSlots], sv[kMergeSlots];
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    dv[q] = sv[q] = 0.0f;
    if (t < S) {
      dv[q] = t < S1 ? d1[ray * S1 + t] : d2[ray * S2 + (t - S1)];
      sv[q] = t < S1 ? s1[ray * S1 + t] : s2[ray * S2 + (t - S1)];
    }
  }
  const int C4 = C >> 2;
  const int rows = kVec ? 32 / C4 : 1;  // rows a warp instruction reads
  const int grp = kVec ? lane / C4 : 0, col = kVec ? lane % C4 : 0;
  const float4* r1 = reinterpret_cast<const float4*>(c1 + ray * S1 * C) + col;
  const float4* r2 = reinterpret_cast<const float4*>(c2 + ray * S2 * C) + col;
  float4 buf[kVec ? kMergeBatch : 1];
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      const int r = i * rows + grp;
      buf[i] = r < S ? __ldg(r < S1 ? r1 + r * C4 : r2 + (r - S1) * C4)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // the merge: sample t of the concatenation (set 1 then set 2) goes to
  // pos1 = i + #(d2 < d1[i]) or pos2 = j + #(d1 <= d2[j]), so a coarse
  // sample goes before an equal fine one. The counts are taken on each
  // list's running maximum (the lists themselves where sorted), so a list
  // out of order by an ulp still gives a permutation.
  int pos[kMergeSlots];
  float carry = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    if (q * 32 >= S) break;
    const int t = q * 32 + lane;
    const int seg = t < S1 ? 0 : S1;  // the first sample of t's list
    float m = dv[q];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, m, off);
      if (lane >= off && t - off >= seg) m = fmaxf(m, o);
    }
    if (q * 32 - 1 >= seg) m = fmaxf(m, carry);  // the previous chunk's, same list
    carry = __shfl_sync(0xffffffffu, m, 31);
    if (t < S) key[t] = m;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    if (t < S) {
      pos[q] = t < S1 ? t + count_below<false>(key + S1, S2, key[t])
                      : (t - S1) + count_below<true>(key, S1, key[t]);
      md[pos[q]] = dv[q];
      ms[pos[q]] = sv[q];
    }
  }
  __syncwarp();

  // march: lane k of each 32-interval chunk takes interval k; the
  // transmittance cumprod of (1 - alpha + 1e-10) is a warp product scan
  // carried across chunks
  float trans = 1.0f, total = 0.0f, dnum = 0.0f;
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
    float wk = alpha * (trans * excl);
    if (on) w[k] = wk;
    total += wk;
    dnum += wk * mid;
    trans *= __shfl_sync(0xffffffffu, incl, 31);
  }
  total = warp_sum(total);
  dnum = warp_sum(dnum);
  __syncwarp();

  // each sample's composite weight, pulled back to concatenation order:
  // the midpoint quadrature gives merged sample p (w[p-1] + w[p]) / 2 with
  // w[-1] = w[S-1] = 0
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    if (t < S) {
      const int p = pos[q];
      wcat[t] = ((p > 0 ? w[p - 1] : 0.0f) + (p < S - 1 ? w[p] : 0.0f)) / 2.0f;
    }
  }
  for (int k = lane; k < S - 1; k += 32) weights[ray * (S - 1) + k] = w[k];
  // unclipped: nan_to_num and the clip to the batch's depth range are
  // reductions over all rays and run after the kernel
  if (lane == 0) depth[ray] = dnum / total;
  __syncwarp();

  // composite the ray's colour block in concatenation order: c1's S1 rows,
  // then c2's S2 rows, contiguous in memory
  if constexpr (kVec) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = 0;;) {
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const int r = base + i * rows + grp;
        if (r < S) {
          const float wr = wcat[r];
          acc.x = fmaf(wr, buf[i].x, acc.x);
          acc.y = fmaf(wr, buf[i].y, acc.y);
          acc.z = fmaf(wr, buf[i].z, acc.z);
          acc.w = fmaf(wr, buf[i].w, acc.w);
        }
      }
      base += kMergeBatch * rows;
      if (base >= S) break;
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const int r = base + i * rows + grp;
        buf[i] = r < S ? __ldg(r < S1 ? r1 + r * C4 : r2 + (r - S1) * C4)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    // add the row groups' sums: lanes col, col + C4, ...
    for (int off = C4; off < 32; off <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
    }
    if (grp == 0) {
      if (white_back) {
        acc.x = acc.x + 1.0f - total;
        acc.y = acc.y + 1.0f - total;
        acc.z = acc.z + 1.0f - total;
        acc.w = acc.w + 1.0f - total;
      }
      reinterpret_cast<float4*>(rgb + ray * C)[col] =
          make_float4(acc.x * 2.0f - 1.0f, acc.y * 2.0f - 1.0f, acc.z * 2.0f - 1.0f,
                      acc.w * 2.0f - 1.0f);
    }
  } else {
    const float* b1 = c1 + ray * S1 * C;
    const float* b2 = c2 + ray * S2 * C;
    for (int c = lane; c < C; c += 32) {
      float acc = 0.0f;
#pragma unroll 8
      for (int r = 0; r < S; ++r)
        acc = fmaf(wcat[r], __ldg(r < S1 ? b1 + r * C + c : b2 + (r - S1) * C + c), acc);
      if (white_back) acc = acc + 1.0f - total;
      rgb[ray * C + c] = acc * 2.0f - 1.0f;
    }
  }
}


// K3 backward (merge_composite_backward in rendering/renderer.py; the JAX
// package had jax.grad differentiate _march_merged, renderer.py:367). Depths
// take no gradient (the coarse ones come from the camera, K2's are
// stopped). From the gradients of rgb [R,C], depth [R] and weights [R,S-1]
// (each may be NULL: zero) it recomputes the merge order and the march and
// returns the gradients of both lists' colours and densities:
//   d colour[t] = 2 g_rgb * wc[pos t];  e[t] = sum_c 2 g_rgb[c] colour[t][c];
//   d w[k] = g_w[k] + (e[k] + e[k+1]) / 2 (merged order)
//            + g_depth (mid[k] - depth) / sum w  - 2 sum_c g_rgb[c] (white_back);
//   d alpha[k] = T[k] (d w[k] - R[k]),  R[k] = d w[k+1] alpha[k+1]
//            + (1 - alpha[k+1] + 1e-10) R[k+1]  (the transmittance's adjoint,
//            a reverse recurrence with no division);
//   d sigma_mid[k] = d alpha[k] exp(-sigma_mid[k] delta[k]) delta[k], through
//   softplus' = sigmoid to half of each neighbour's density.
//
// What bounds it on an H100: bytes. Both colour lists are read once (for
// e) and their gradients written once: 2 x (S1 + S2) x C x 4 B a ray, 1.6
// GB at the training steps' [4,16384,48+48,32], 0.48 ms at 3.35 TB/s; the
// rest is a few hundred flops a sample. The first design (PR 15) took
// 1.52 ms there: it read the colours one 128 B row at a time, one lane a
// channel, each row waiting on a 5-shuffle warp sum, one load in flight a
// lane; and ran the reverse recurrence on lane 0 alone, 95 serial steps of
// expf, softplus and sigmoid while 31 lanes waited.
//
// Design: one warp a ray, 8 rays a block, as the forward. The colour rows
// are read as the forward reads them: float4s, C / 4 lanes a row and
// 128 / C rows a warp instruction; the lane's 2 g_rgb channels and its
// first kBackBatch colour loads are issued before the merge and the march,
// which they overlap. Each lane dots its float4 with its 2 g_rgb float4,
// and a row's C / 4 lanes add their parts by log2(C / 4) shuffles into
// e[t], written to the sample's merged position. The next batch of loads is
// issued before this batch's d colour rows are stored (float4 stores of
// wc[pos t] * 2 g_rgb), so loads and stores overlap. The reverse recurrence
// is a warp-parallel suffix scan of the affine maps r -> d w[k] alpha[k] +
// (1 - alpha[k] + 1e-10) r (lane k of a 32-interval chunk; R[k - 1] is the
// composite of lanes k.. applied to the R carried from the chunk after),
// the backward twin of the forward's product scan, run from the last chunk
// to the first; d alpha and d u are lane-parallel, and each sample's density
// gradient is read back in concatenation order and stored coalesced. Other
// colour widths (C / 4 not a power of two up to 32) and colour, gradient or
// output views not 16 B aligned take a scalar path of the same order, one
// lane a channel, four rows at a time.
constexpr int kBackBatch = 8;  // 16 B colour loads a lane has in flight (backward)

template <bool kVec>
__global__ void __launch_bounds__(32 * kMergeWarps, 2) merge_composite_backward_kernel(
    const float* __restrict__ d1, const float* __restrict__ c1,
    const float* __restrict__ s1, int S1, const float* __restrict__ d2,
    const float* __restrict__ c2, const float* __restrict__ s2, int S2, int R, int C,
    int white_back, const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
    const float* __restrict__ g_w, float* __restrict__ dc1, float* __restrict__ ds1,
    float* __restrict__ dc2, float* __restrict__ ds2) {
  __shared__ float sh_key[kMergeWarps][kMaxS];  // merge keys, then wc by concatenation
  __shared__ float sh_d[kMergeWarps][kMaxS];    // merged depths
  __shared__ float sh_s[kMergeWarps][kMaxS];    // merged densities
  __shared__ float sh_w[kMergeWarps][kMaxS];    // weights, then d u
  __shared__ float sh_e[kMergeWarps][kMaxS];    // e, merged order
  __shared__ int sh_pos[kMergeWarps][kMaxS];    // concatenation -> merged
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kMergeWarps + warp;
  if (ray >= R) return;
  const int S = S1 + S2;
  float* key = sh_key[warp];
  float* wcat = key;
  float* md = sh_d[warp];
  float* ms = sh_s[warp];
  float* w = sh_w[warp];
  float* du = w;
  float* e = sh_e[warp];
  int* posa = sh_pos[warp];
  const bool has_rgb = g_rgb != nullptr;

  // the ray's depths and densities, then the lane's channels of 2 g_rgb and
  // its first batch of colour rows, issued before the merge and the march
  float dv[kMergeSlots], sv[kMergeSlots];
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    dv[q] = sv[q] = 0.0f;
    if (t < S) {
      dv[q] = t < S1 ? d1[ray * S1 + t] : d2[ray * S2 + (t - S1)];
      sv[q] = t < S1 ? s1[ray * S1 + t] : s2[ray * S2 + (t - S1)];
    }
  }
  const int C4 = C >> 2;
  const int rows = kVec ? 32 / C4 : 1;  // rows a warp instruction reads
  const int grp = kVec ? lane / C4 : 0, col = kVec ? lane % C4 : 0;
  const float4* r1 = reinterpret_cast<const float4*>(c1 + ray * S1 * C) + col;
  const float4* r2 = reinterpret_cast<const float4*>(c2 + ray * S2 * C) + col;
  float4 g2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 buf[kVec ? kBackBatch : 1];
  if constexpr (kVec) {
    if (has_rgb) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g_rgb + ray * C) + col);
      g2 = make_float4(2.0f * gv.x, 2.0f * gv.y, 2.0f * gv.z, 2.0f * gv.w);
#pragma unroll
      for (int i = 0; i < kBackBatch; ++i) {
        const int r = i * rows + grp;
        buf[i] = r < S ? __ldg(r < S1 ? r1 + r * C4 : r2 + (r - S1) * C4)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }

  // the merge, as the forward's
  int pos[kMergeSlots];
  float carry = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    if (q * 32 >= S) break;
    const int t = q * 32 + lane;
    const int seg = t < S1 ? 0 : S1;
    float m = dv[q];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kFull, m, off);
      if (lane >= off && t - off >= seg) m = fmaxf(m, o);
    }
    if (q * 32 - 1 >= seg) m = fmaxf(m, carry);
    carry = __shfl_sync(kFull, m, 31);
    if (t < S) key[t] = m;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    pos[q] = 0;
    if (t < S) {
      pos[q] = t < S1 ? t + count_below<false>(key + S1, S2, key[t])
                      : (t - S1) + count_below<true>(key, S1, key[t]);
      posa[t] = pos[q];
      md[pos[q]] = dv[q];
      ms[pos[q]] = sv[q];
    }
  }
  __syncwarp();

  // the march, as the forward's, keeping each interval's transmittance in
  // the lane that owns it
  float tr[kMergeSlots];
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) tr[q] = 0.0f;
  float trans = 1.0f, total = 0.0f, dnum = 0.0f;
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    if (q * 32 >= S - 1) break;
    const int k = q * 32 + lane;
    const bool on = k < S - 1;
    float alpha = 0.0f, mid = 0.0f;
    if (on) {
      float delta = md[k + 1] - md[k];
      float dens = r3dp_softplus((ms[k] + ms[k + 1]) / 2.0f - 1.0f);
      alpha = 1.0f - expf(-(dens * delta));
      mid = (md[k] + md[k + 1]) / 2.0f;
    }
    float incl = on ? 1.0f - alpha + 1e-10f : 1.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= o;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    tr[q] = trans * excl;
    const float wk = alpha * tr[q];
    if (on) w[k] = wk;
    total += wk;
    dnum += wk * mid;
    trans *= __shfl_sync(kFull, incl, 31);
  }
  total = warp_sum(total);
  dnum = warp_sum(dnum);
  __syncwarp();
  // each sample's composite weight in concatenation order (the keys are
  // dead), as the forward's
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    if (t < S) {
      const int p = pos[q];
      wcat[t] = ((p > 0 ? w[p - 1] : 0.0f) + (p < S - 1 ? w[p] : 0.0f)) / 2.0f;
    }
  }
  if (!has_rgb)
    for (int p = lane; p < S; p += 32) e[p] = 0.0f;
  __syncwarp();

  // e and d colour, sum_c 2 g_rgb[c] for white_back
  float gsum;
  if constexpr (kVec) {
    float4* o1 = reinterpret_cast<float4*>(dc1 + ray * S1 * C) + col;
    float4* o2 = reinterpret_cast<float4*>(dc2 + ray * S2 * C) + col;
    gsum = (g2.x + g2.y) + (g2.z + g2.w);
    for (int off = C4 >> 1; off > 0; off >>= 1) gsum += __shfl_xor_sync(kFull, gsum, off);
    for (int base = 0;;) {
      if (has_rgb) {
#pragma unroll
        for (int i = 0; i < kBackBatch; ++i) {
          const int r = base + i * rows + grp;
          float p = g2.x * buf[i].x;
          p = fmaf(g2.y, buf[i].y, p);
          p = fmaf(g2.z, buf[i].z, p);
          p = fmaf(g2.w, buf[i].w, p);
          for (int off = C4 >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
          if (col == 0 && r < S) e[posa[r]] = p;
        }
      }
      const int next = base + kBackBatch * rows;
      if (has_rgb && next < S) {
#pragma unroll
        for (int i = 0; i < kBackBatch; ++i) {
          const int r = next + i * rows + grp;
          buf[i] = r < S ? __ldg(r < S1 ? r1 + r * C4 : r2 + (r - S1) * C4)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < kBackBatch; ++i) {
        const int r = base + i * rows + grp;
        if (r < S) {
          const float wr = wcat[r];
          const float4 v = make_float4(wr * g2.x, wr * g2.y, wr * g2.z, wr * g2.w);
          if (r < S1)
            o1[r * C4] = v;
          else
            o2[(r - S1) * C4] = v;
        }
      }
      if (next >= S) break;
      base = next;
    }
  } else {
    const float* b1 = c1 + ray * S1 * C;
    const float* b2 = c2 + ray * S2 * C;
    float* o1 = dc1 + ray * S1 * C;
    float* o2 = dc2 + ray * S2 * C;
    const float* gr = has_rgb ? g_rgb + ray * C : nullptr;
    gsum = 0.0f;
    for (int c = lane; c < C; c += 32) gsum += gr ? 2.0f * gr[c] : 0.0f;
    gsum = warp_sum(gsum);
    for (int t0 = 0; t0 < S; t0 += 4) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = lane; c < C; c += 32) {
        const float gc = gr ? 2.0f * gr[c] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + j;
          if (t < S) {
            const long long off = (t < S1 ? (long long)t : (long long)(t - S1)) * C + c;
            if (gr) part[j] = fmaf(gc, __ldg((t < S1 ? b1 : b2) + off), part[j]);
            (t < S1 ? o1 : o2)[off] = wcat[t] * gc;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = warp_sum(part[j]);
        if (gr && lane == 0 && t0 + j < S) e[posa[t0 + j]] = v;
      }
    }
  }
  __syncwarp();

  // d w, then the reverse recurrence as a suffix scan of affine maps, from
  // the last chunk of 32 intervals to the first; d alpha and d u per lane
  const float gd = g_depth ? g_depth[ray] : 0.0f;
  const float depth = dnum / total;
  float rcarry = 0.0f;  // R at the last interval of the chunk after this one
#pragma unroll
  for (int q = kMergeSlots - 1; q >= 0; --q) {
    if (q * 32 >= S - 1) continue;
    const int k = q * 32 + lane;
    const bool on = k < S - 1;
    float dw = 0.0f, alpha = 0.0f, ex = 1.0f, delta = 0.0f, u = 0.0f;
    if (on) {
      delta = md[k + 1] - md[k];
      u = (ms[k] + ms[k + 1]) / 2.0f - 1.0f;
      ex = expf(-(r3dp_softplus(u) * delta));
      alpha = 1.0f - ex;
      dw = g_w ? g_w[ray * (S - 1) + k] : 0.0f;
      dw += (e[k] + e[k + 1]) / 2.0f;
      if (gd != 0.0f) dw += gd * ((md[k] + md[k + 1]) / 2.0f - depth) / total;
      if (white_back) dw -= gsum;
    }
    // lane k's map, composed with those of lanes k + 1 .. 31
    float a = on ? 1.0f - alpha + 1e-10f : 1.0f;
    float b = on ? dw * alpha : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a2 = __shfl_down_sync(kFull, a, off);
      const float b2 = __shfl_down_sync(kFull, b, off);
      if (lane + off < 32) {
        b = fmaf(a, b2, b);
        a *= a2;
      }
    }
    const float rprev = fmaf(a, rcarry, b);  // R[k - 1]
    float rk = __shfl_down_sync(kFull, rprev, 1);
    if (lane == 31) rk = rcarry;             // R[k]
    rcarry = __shfl_sync(kFull, rprev, 0);
    if (on) du[k] = tr[q] * (dw - rk) * ex * delta * r3dp_sigmoid(u);
  }
  __syncwarp();
  // each sample's density gets half of its two intervals' d u, stored in
  // concatenation order
#pragma unroll
  for (int q = 0; q < kMergeSlots; ++q) {
    const int t = q * 32 + lane;
    if (t < S) {
      const int p = pos[q];
      const float dsig = ((p > 0 ? du[p - 1] : 0.0f) + (p < S - 1 ? du[p] : 0.0f)) / 2.0f;
      if (t < S1)
        ds1[ray * S1 + t] = dsig;
      else
        ds2[ray * S2 + (t - S1)] = dsig;
    }
  }
}

}  // namespace

// depths, sigma [R,S] (4 <= S <= 128, sorted depths); u: ray r's NF values
// in [0,1] at u + r * u_stride (u_stride 0: one row for every ray); fine
// [R,NF].
R3DP_EXPORT int r3dp_importance_sample(const float* depths, const float* sigma,
                                       const float* u, long long u_stride, int R, int S,
                                       int NF, float* fine, cudaStream_t stream) {
  if (S < 4 || S > kMaxS) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    if (S - 1 <= 16)
      importance_sample_kernel<16, 1><<<r3dp_blocks(R, kSampleThreads / 16), kSampleThreads, 0,
                                        stream>>>(depths, sigma, u, u_stride, R, S, NF, fine);
    else if (S - 1 <= 64)
      importance_sample_kernel<32, 2><<<r3dp_blocks(R, kSampleThreads / 32), kSampleThreads, 0,
                                        stream>>>(depths, sigma, u, u_stride, R, S, NF, fine);
    else
      importance_sample_kernel<32, 4><<<r3dp_blocks(R, kSampleThreads / 32), kSampleThreads, 0,
                                        stream>>>(depths, sigma, u, u_stride, R, S, NF, fine);
  }
  return (int)cudaGetLastError();
}

// d1, s1 [R,S1]; c1 [R,S1,C]; d2, s2 [R,S2]; c2 [R,S2,C]; each list sorted,
// S1 + S2 <= 128. rgb [R,C] (already mapped to [-1,1]), depth [R]
// unclipped, weights [R,S-1].
R3DP_EXPORT int r3dp_merge_composite(const float* d1, const float* c1,
                                     const float* s1, int S1, const float* d2,
                                     const float* c2, const float* s2, int S2,
                                     int R, int C, int white_back, float* rgb,
                                     float* depth, float* weights,
                                     cudaStream_t stream) {
  if (S1 < 0 || S2 < 0 || S1 + S2 > kMaxS || C < 1) return (int)cudaErrorInvalidValue;
  const int c4 = C / 4;
  const bool vec = C % 4 == 0 && c4 <= 32 && (c4 & (c4 - 1)) == 0 &&
                   (reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
                    reinterpret_cast<uintptr_t>(rgb)) % 16 == 0;
  if (R > 0) {
    if (vec)
      merge_composite_kernel<true><<<r3dp_blocks(R, kMergeWarps), 32 * kMergeWarps, 0,
                                     stream>>>(d1, c1, s1, S1, d2, c2, s2, S2, R, C,
                                               white_back, rgb, depth, weights);
    else
      merge_composite_kernel<false><<<r3dp_blocks(R, kMergeWarps), 32 * kMergeWarps, 0,
                                      stream>>>(d1, c1, s1, S1, d2, c2, s2, S2, R, C,
                                                white_back, rgb, depth, weights);
  }
  return (int)cudaGetLastError();
}

// K3 backward. d1, c1, s1, d2, c2, s2, R, C and white_back as the
// forward's; g_rgb [R,C], g_depth [R] (before the caller's clip) and g_w
// [R,S-1], each NULL for zero; dc1, ds1, dc2, ds2 shaped like c1, s1, c2,
// s2 take the gradients (every element written).
R3DP_EXPORT int r3dp_merge_composite_backward(const float* d1, const float* c1,
                                              const float* s1, int S1, const float* d2,
                                              const float* c2, const float* s2, int S2,
                                              int R, int C, int white_back,
                                              const float* g_rgb, const float* g_depth,
                                              const float* g_w, float* dc1, float* ds1,
                                              float* dc2, float* ds2, cudaStream_t stream) {
  if (S1 < 0 || S2 < 0 || S1 + S2 > kMaxS || S1 + S2 < 2 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int c4 = C / 4;
  const bool vec = C % 4 == 0 && c4 <= 32 && (c4 & (c4 - 1)) == 0 &&
                   (reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
                    reinterpret_cast<uintptr_t>(g_rgb) | reinterpret_cast<uintptr_t>(dc1) |
                    reinterpret_cast<uintptr_t>(dc2)) % 16 == 0;
  if (R > 0) {
    if (vec)
      merge_composite_backward_kernel<true><<<r3dp_blocks(R, kMergeWarps), 32 * kMergeWarps,
                                              0, stream>>>(d1, c1, s1, S1, d2, c2, s2, S2, R,
                                                           C, white_back, g_rgb, g_depth, g_w,
                                                           dc1, ds1, dc2, ds2);
    else
      merge_composite_backward_kernel<false><<<r3dp_blocks(R, kMergeWarps), 32 * kMergeWarps,
                                               0, stream>>>(d1, c1, s1, S1, d2, c2, s2, S2, R,
                                                            C, white_back, g_rgb, g_depth, g_w,
                                                            dc1, ds1, dc2, ds2);
  }
  return (int)cudaGetLastError();
}
