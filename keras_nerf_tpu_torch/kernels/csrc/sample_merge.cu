// sample_merge: inverse-CDF sampling along each ray, with an optional
// rank merge.
//
// Replaces: keras_nerf_tpu/kernels/ray_march.py:_sample_merge_prologue
// (:987-1099), the prologue of fused_train_chunk, in its three modes. Per
// ray it inverts the CDF of the bin weights (+1e-5) over the midpoints of
// the CDF source cp at the sorted draws u, then
//   s_m = 0: writes the drawn depths as they are (the occupancy render);
//   s_m > 0: rank-merges them with a sorted partner mp [rays, s_m], a
//            partner depth before an equal drawn one. The TPU's s_m = -1
//            (merge with cp itself, the fine pass) is this mode with
//            mp = cp: the same ranks, the same bits.
//
// Bound on the H100: bytes. Per ray it reads 2 s_c floats of bins and
// weights, n draws and s_m partner depths, and writes n or s_m + n depths;
// the arithmetic is a few thousand compares per ray. At 4096 rays the fine
// pass (64 + 128) moves 8.4 MB, about 2.5 us at 3.35 TB/s; the occupancy
// render (64 probe bins, 64 draws, no merge) 4.2 MB, about 1.3 us.
//
// Design: one block of 128 threads per ray. The ray's bins, CDF, midpoints,
// draws and partner sit in shared memory. One thread forms the CDF with
// sequential float32 sums, the order the plain PyTorch version uses, so
// both give identical bits. Then each thread brackets its draws by masked
// max/min over all bins (the reference's reductions, exact for any input
// order) and each element finds its output slot by counting the other
// array. No sort, no binary search, no atomics, and no limit on the bins,
// draws or partner beyond shared memory. The sequential CDF and the
// per-ray block leave the kernel far above its byte bound; it is small
// beside the MLP.
#include "common.cuh"

namespace {

__global__ void sample_merge_kernel(const float* __restrict__ cp,
                                    const float* __restrict__ w,
                                    const float* __restrict__ u,
                                    const float* __restrict__ mp,
                                    float* __restrict__ out, int s_c, int n,
                                    int s_m) {
  extern __shared__ float smem[];
  float* s_cp = smem;           // [s_c] CDF source depths
  float* s_cdf = s_cp + s_c;    // [s_c] weights, then the exclusive CDF
  float* s_mid = s_cdf + s_c;   // [s_c] edge-padded midpoints
  float* s_fine = s_mid + s_c;  // [n] drawn depths
  float* s_mp = s_fine + n;     // [s_m] partner depths (s_m > 0)
  __shared__ float s_total;

  const int r = blockIdx.x;
  const float* cp_r = cp + (size_t)r * s_c;
  const float* w_r = w + (size_t)r * s_c;
  const float* u_r = u + (size_t)r * n;
  float* out_r = out + (size_t)r * (s_m + n);

  for (int i = threadIdx.x; i < s_c; i += blockDim.x) {
    s_cp[i] = cp_r[i];
    s_cdf[i] = __fadd_rn(w_r[i], knt::kWeightEps);
  }
  for (int i = threadIdx.x; i < s_m; i += blockDim.x) {
    s_mp[i] = mp[(size_t)r * s_m + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s_c - 1; i += blockDim.x) {
    s_mid[i] = __fmul_rn(0.5f, __fadd_rn(s_cp[i], s_cp[i + 1]));
  }
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < s_c; ++i) tot = __fadd_rn(tot, s_cdf[i]);
    float incl = 0.f;
    for (int i = 0; i < s_c; ++i) {
      const float pdf = __fdiv_rn(s_cdf[i], tot);
      incl = __fadd_rn(incl, pdf);
      s_cdf[i] = __fsub_rn(incl, pdf);
    }
    s_total = incl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = -knt::kBig;
    for (int i = 0; i < s_c - 1; ++i) m = fmaxf(m, s_mid[i]);
    s_mid[s_c - 1] = m;
  }
  __syncthreads();

  const float total = s_total;
  const float mid_last = s_mid[s_c - 1];
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float uj = u_r[j];
    float cdf_below = -knt::kBig, cdf_above = knt::kBig;
    float bin_below = -knt::kBig, bin_above = knt::kBig;
    for (int i = 0; i < s_c; ++i) {
      const float c = s_cdf[i], m = s_mid[i];
      if (c <= uj) {
        cdf_below = fmaxf(cdf_below, c);
        bin_below = fmaxf(bin_below, m);
      } else {
        cdf_above = fminf(cdf_above, c);
        bin_above = fminf(bin_above, m);
      }
    }
    if (cdf_above >= 0.5f * knt::kBig) cdf_above = total;
    if (bin_above >= 0.5f * knt::kBig) bin_above = mid_last;
    float denom = __fsub_rn(cdf_above, cdf_below);
    if (denom < knt::kDenomMin) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(uj, cdf_below), denom);
    const float f = __fadd_rn(bin_below,
                              __fmul_rn(t, __fsub_rn(bin_above, bin_below)));
    // No merge: the draws are sorted, so the depths are too.
    if (s_m == 0) {
      out_r[j] = f;
    } else {
      s_fine[j] = f;
    }
  }
  if (s_m == 0) return;   // the same for every thread of the block
  __syncthreads();

  for (int i = threadIdx.x; i < s_m; i += blockDim.x) {
    const float c = s_mp[i];
    int ahead = 0;
    for (int j = 0; j < n; ++j) ahead += (s_fine[j] < c);
    out_r[i + ahead] = c;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float f = s_fine[j];
    int ahead = 0;
    for (int i = 0; i < s_m; ++i) ahead += (s_mp[i] <= f);
    out_r[j + ahead] = f;
  }
}

}  // namespace

// cp, w: [rays, s_c]; u: [rays, n] sorted draws; s_m: 0 (no merge) or the
// width of the sorted partner mp [rays, s_m] (ignored unless s_m > 0);
// out: [rays, s_m + n].
KNT_EXPORT int knt_sample_merge(const float* cp, const float* w,
                                const float* u, const float* mp, float* out,
                                int rays, int s_c, int n, int s_m,
                                void* stream) {
  if (rays <= 0) return 0;
  const size_t smem = (size_t)(3 * s_c + n + s_m) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sample_merge_kernel<<<rays, 128, smem, (cudaStream_t)stream>>>(
      cp, w, u, mp, out, s_c, n, s_m);
  return (int)cudaGetLastError();
}
