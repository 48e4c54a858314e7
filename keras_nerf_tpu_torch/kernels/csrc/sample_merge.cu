// sample_merge: inverse-CDF sampling along each ray, with an optional
// rank merge.
//
// Replaces: keras_nerf_tpu/kernels/ray_march.py:_sample_merge_prologue
// (:987-1099), the prologue of fused_train_chunk, in its three modes. Per
// ray it inverts the CDF of the bin weights (+1e-5) over the edge-padded
// midpoints of the sorted CDF source cp at the sorted draws u, then
//   s_m = 0: writes the drawn depths as they are (the occupancy render);
//   s_m > 0: rank-merges them with a sorted partner mp [rays, s_m], a
//            partner depth before an equal drawn one. The TPU's s_m = -1
//            (merge with cp itself, the fine pass) is this mode with
//            mp = cp: the same ranks, the same bits.
// The function is sample_merge_plain's (kernels/ray_march.py): the CDF is
// JAX's invert_cdf's, 0-prepended and inclusive, summed in sequence.
//
// Bound on the H100: bytes. Per ray it reads s_c weights, n draws and s_m
// partner depths (and s_c bins, or one row for every ray), and writes
// n or s_m + n depths: 8.4 MB at 4096 rays of the fine pass (64 + 128),
// about 2.5 us at 3.35 TB/s. Its work is some hundreds of instructions a
// ray, much of it two chains of dependent adds, so at one wave of warps it
// is held by the chains' latency and by instruction issue, behind the
// loads that every warp makes at once.
//
// Design: one warp a ray, several rays a block, no barrier between rays.
//   Loads: a ray's rows, coalesced across its warp, every load of a pass
//     in flight before its stores to shared memory.
//   Total and CDF: each prefix is the one before plus a bin's share, in
//     float32 in bin order, so the CDF never steps down (a tree-ordered
//     scan, or inclusive - pdf, can step down by an ulp on heavy-tailed
//     weights). Every lane sums the total; the divides run across the
//     lanes; then one lane adds the shares in order while the ray's other
//     lanes wait (no other ray does). Both chains read four bins a load.
//     No fused multiply-add: the __f*_rn intrinsics.
//   Brackets: with a non-decreasing CDF and sorted midpoints, the masked
//     max/min over the bins are cdf[k-1], cdf[k], mid[k-1], mid[k], with
//     k the count of CDF entries <= u, found by a binary search in shared
//     memory: no branch, two draws a lane interleaved.
//   Merge: a drawn depth's slot is its index plus the count of partner
//     depths <= it, a partner depth's its index plus the count of drawn
//     depths < it, each such a search. The first needs the partner sorted
//     (the precondition). The second is exact whenever the merge is a
//     permutation, as the plain version's scatter needs it to be: that
//     holds exactly when the first counts do not decrease along the draws,
//     and then "drawn depth < partner depth" is true on a prefix of the
//     draws (PERF.md). The drawn depths are sorted outright when adjacent
//     midpoints lie within a factor 2 of each other (Sterbenz), as on
//     every path of the package.
// Outputs are written straight to their slots. No atomics: two runs give
// the same bits. Shared memory per ray (sample_merge_plan in Python sizes
// it and refuses a ray that does not fit): the CDF and midpoints, s_c + 1
// floats each, and where it merges the partner and the drawn depths.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kQ = 2;   // draws (or partner depths) a lane takes a pass

// Floats of shared memory a ray's warp takes (sample_merge_plan's count):
// 3 of padding, so that the weights behind cdf[0] start 16-byte aligned;
// the CDF and the midpoints, s_c + 1 each; where it merges, the partner
// and the drawn depths; rounded up to keep the next ray's aligned.
__device__ __forceinline__ int ray_floats(int s_c, int n, int s_m) {
  return (3 + 2 * (s_c + 1) + (s_m > 0 ? s_m + n : 0) + 3) & ~3;
}

// k[q] = the entries of a[0, len) that are <= x[q] (kStrict: < x[q]),
// where that holds on a prefix of a: a binary search, kQ of them
// interleaved, with no branch (a step past the end reads the last entry:
// if it holds there, it holds on all).
template <bool kStrict>
__device__ __forceinline__ void count_below(const float* a, int len,
                                            const float (&x)[kQ],
                                            int (&k)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) k[q] = 0;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int p = min(k[q] + step, len);
      const float v = a[p - 1];
      k[q] = (kStrict ? v < x[q] : v <= x[q]) ? p : k[q];
    }
  }
}

__global__ void sample_merge_kernel(const float* __restrict__ cp,
                                    int cp_stride,
                                    const float* __restrict__ w,
                                    const float* __restrict__ u,
                                    const float* __restrict__ mp,
                                    float* __restrict__ out, int rays,
                                    int s_c, int n, int s_m) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rays) return;   // the whole warp: no barrier spans warps
  float* s_cdf = reinterpret_cast<float*>(smem4)
                 + (size_t)warp * ray_floats(s_c, n, s_m) + 3;  // [s_c + 1]
  float* s_w = s_cdf + 1;                // weights, then shares, then CDF
  float* s_mid = s_cdf + s_c + 1;        // [s_c + 1]
  float* s_mp = s_mid + s_c + 1;         // [s_m]
  float* s_fine = s_mp + s_m;            // [n]

  const float* cp_r = cp + (size_t)r * cp_stride;
  const float* w_r = w + (size_t)r * s_c;
  const float* u_r = u + (size_t)r * n;
  float* out_r = out + (size_t)r * (s_m + n);

  // The first pass's draws, loaded now: their latency hides behind the
  // chains.
  float x[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = lane + 32 * q;
    x[q] = j < n ? u_r[j] : 0.f;
  }
  // The weights and the midpoints 0.5 (cp[i] + cp[i + 1]), the last one
  // repeated up to s_c; every load of a pass in flight before its stores.
  for (int i0 = 0; i0 <= s_c; i0 += 32 * kQ) {
    float wv[kQ], c0[kQ], c1[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = i0 + lane + 32 * q, k = min(i, s_c - 2);
      wv[q] = i < s_c ? w_r[i] : 0.f;
      c0[q] = i <= s_c ? cp_r[k] : 0.f;
      c1[q] = i <= s_c ? cp_r[k + 1] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = i0 + lane + 32 * q;
      if (i < s_c) s_w[i] = __fadd_rn(wv[q], knt::kWeightEps);
      if (i <= s_c) s_mid[i] = __fmul_rn(0.5f, __fadd_rn(c0[q], c1[q]));
    }
  }
  for (int i0 = 0; i0 < s_m; i0 += 32 * kQ) {
    float m[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = i0 + lane + 32 * q;
      m[q] = i < s_m ? mp[(size_t)r * s_m + i] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = i0 + lane + 32 * q;
      if (i < s_m) s_mp[i] = m[q];
    }
  }
  __syncwarp();

  // The total, bin after bin, four bins a load.
  const int s4 = s_c & ~3;
  float total = 0.f;
#pragma unroll 4
  for (int i = 0; i < s4; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s_w + i);
    total = __fadd_rn(total, v.x);
    total = __fadd_rn(total, v.y);
    total = __fadd_rn(total, v.z);
    total = __fadd_rn(total, v.w);
  }
  for (int i = s4; i < s_c; ++i) total = __fadd_rn(total, s_w[i]);
  __syncwarp();   // every lane has read the weights before they turn shares
  for (int i = lane; i < s_c; i += 32) s_w[i] = __fdiv_rn(s_w[i], total);
  __syncwarp();
  // The CDF: each prefix the one before plus a share.
  if (lane == 0) {
    float acc = 0.f;
    s_cdf[0] = 0.f;
#pragma unroll 4
    for (int i = 0; i < s4; i += 4) {
      float4 v = *reinterpret_cast<const float4*>(s_w + i);
      v.x = acc = __fadd_rn(acc, v.x);
      v.y = acc = __fadd_rn(acc, v.y);
      v.z = acc = __fadd_rn(acc, v.z);
      v.w = acc = __fadd_rn(acc, v.w);
      *reinterpret_cast<float4*>(s_w + i) = v;
    }
    for (int i = s4; i < s_c; ++i) {
      acc = __fadd_rn(acc, s_w[i]);
      s_w[i] = acc;
    }
  }
  __syncwarp();

  for (int base = 0; base < n; base += 32 * kQ) {
    if (base > 0) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int j = base + lane + 32 * q;
        x[q] = j < n ? u_r[j] : 0.f;
      }
    }
    // k: the CDF entries <= u. cdf[0] = 0 is one of them unless u < 0
    // (or NaN), when no entry is.
    int k[kQ];
    count_below<false>(s_w, s_c, x, k);
#pragma unroll
    for (int q = 0; q < kQ; ++q) k[q] += x[q] >= 0.f;
    float f[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      // No entry <= u (only for u < 0): the masked max of nothing, -inf.
      const float cdf_below = k[q] > 0 ? s_cdf[k[q] - 1] : -CUDART_INF_F;
      const float bin_below = k[q] > 0 ? s_mid[k[q] - 1] : -CUDART_INF_F;
      // No entry > u: the last entries, the total and the last midpoint.
      const int a = min(k[q], s_c);
      const float cdf_above = s_cdf[a], bin_above = s_mid[a];
      float denom = __fsub_rn(cdf_above, cdf_below);
      if (denom < knt::kDenomMin) denom = 1.f;
      const float t = __fdiv_rn(__fsub_rn(x[q], cdf_below), denom);
      f[q] = __fadd_rn(bin_below,
                       __fmul_rn(t, __fsub_rn(bin_above, bin_below)));
    }
    if (s_m == 0) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int j = base + lane + 32 * q;
        if (j < n) out_r[j] = f[q];
      }
    } else {
      int c[kQ];
      count_below<false>(s_mp, s_m, f, c);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int j = base + lane + 32 * q;
        if (j < n) {
          s_fine[j] = f[q];
          out_r[j + c[q]] = f[q];
        }
      }
    }
  }
  if (s_m == 0) return;
  __syncwarp();
  for (int base = 0; base < s_m; base += 32 * kQ) {
    float m[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = base + lane + 32 * q;
      m[q] = i < s_m ? s_mp[i] : 0.f;
    }
    int d[kQ];
    count_below<true>(s_fine, n, m, d);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = base + lane + 32 * q;
      if (i < s_m) out_r[i + d[q]] = m[q];
    }
  }
}

}  // namespace

// cp: [rays, s_c] with row stride cp_stride (s_c, or 0: one row for every
// ray); w: [rays, s_c]; u: [rays, n] sorted draws; s_m: 0 (no merge) or the
// width of the sorted partner mp [rays, s_m] (ignored unless s_m > 0);
// out: [rays, s_m + n]. rays_per_block and smem_bytes: sample_merge_plan's.
KNT_EXPORT int knt_sample_merge(const float* cp, int cp_stride,
                                const float* w, const float* u,
                                const float* mp, float* out, int rays,
                                int s_c, int n, int s_m, int rays_per_block,
                                int smem_bytes, void* stream) {
  if (rays <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rays + rays_per_block - 1) / rays_per_block;
  sample_merge_kernel<<<blocks, 32 * rays_per_block, smem_bytes,
                        (cudaStream_t)stream>>>(cp, cp_stride, w, u, mp, out,
                                                rays, s_c, n, s_m);
  return (int)cudaGetLastError();
}
