// ray_march_quadrature: volume-rendering quadrature of one pass.
//
// Replaces: keras_nerf_tpu/kernels/ray_march.py:_quadrature_fwd (:1102),
// _depth_lane3 (:1150), the compact-weights block (:1328-1340) and the
// sigma_only epilogue (:1296-1314) of _train_chunk_kernel. With
// x_s = sigma_s * delta_s (delta_s = t_{s+1} - t_s, the last delta 1e-10):
// T_s = exp(-sum_{i<s} x_i), w_s = (1 - exp(-x_s)) T_s, image = sum w rgb
// (+ 1 - sum w on a white background, then clipped to [0, 1]),
// depth = sum w t, and optionally the weights themselves.
//
// Bound on the H100: bytes. Per sample it reads 16 B of (r, g, b, sigma)
// and 4 B of depth (8 B in sigma-only mode) and writes 4 B of weight when
// asked; a few flops each. A 4096 x 192 fine chunk moves about 16 MB,
// about 5 us at 3.35 TB/s.
//
// Design: one warp per ray walks the samples 32 at a time, so every load is
// coalesced (a float4 per lane for the colours). The exclusive sum of
// optical depth is a float32 warp scan with a running carry, exact where
// the TPU kernel used a two-piece bf16 triangular matmul. The sums of
// w rgb, w and w t are per-lane partials reduced by shuffles at the end.
#include "common.cuh"

namespace {

constexpr int kRaysPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kSigmaOnly>
__global__ void quadrature_kernel(const float* __restrict__ rgbs,
                                  const float* __restrict__ t,
                                  float* __restrict__ image,
                                  float* __restrict__ depth,
                                  float* __restrict__ weights, int rays, int S,
                                  int white_bg) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (r >= rays) return;
  const float* t_r = t + (size_t)r * S;
  float carry = 0.f;  // sum of x over the samples before this chunk
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    float x = 0.f, ts = 0.f, sigma = 0.f;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      ts = t_r[s];
      const float delta = (s < S - 1) ? __fsub_rn(t_r[s + 1], ts) : knt::kLastDelta;
      if (kSigmaOnly) {
        sigma = rgbs[(size_t)r * S + s];
      } else {
        c = reinterpret_cast<const float4*>(rgbs)[(size_t)r * S + s];
        sigma = c.w;
      }
      x = __fmul_rn(sigma, delta);
    }
    // Inclusive warp scan of x, then shifted by one lane for the exclusive sum.
    float incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    excl += carry;
    carry += __shfl_sync(0xffffffffu, incl, 31);
    if (s < S) {
      const float wgt = (1.f - expf(-x)) * expf(-excl);
      if (weights != nullptr) weights[(size_t)r * S + s] = wgt;
      acc_w += wgt;
      acc_d += wgt * ts;
      if (!kSigmaOnly) {
        acc_r += wgt * c.x;
        acc_g += wgt * c.y;
        acc_b += wgt * c.z;
      }
    }
  }
  acc_d = warp_sum(acc_d);
  if (kSigmaOnly) {
    if (lane == 0) depth[r] = acc_d;
    return;
  }
  acc_w = warp_sum(acc_w);
  acc_r = warp_sum(acc_r);
  acc_g = warp_sum(acc_g);
  acc_b = warp_sum(acc_b);
  if (lane == 0) {
    const float bg = white_bg ? 1.f - acc_w : 0.f;
    image[(size_t)r * 3 + 0] = fminf(fmaxf(acc_r + bg, 0.f), 1.f);
    image[(size_t)r * 3 + 1] = fminf(fmaxf(acc_g + bg, 0.f), 1.f);
    image[(size_t)r * 3 + 2] = fminf(fmaxf(acc_b + bg, 0.f), 1.f);
    depth[r] = acc_d;
  }
}

}  // namespace

// rgbs: [rays, S, 4] (r, g, b, sigma), or [rays, S] sigma when sigma_only;
// t: [rays, S] sorted depths; image: [rays, 3] (unused when sigma_only);
// depth: [rays]; weights: [rays, S] or null.
KNT_EXPORT int knt_ray_march_quadrature(const float* rgbs, const float* t,
                                        float* image, float* depth,
                                        float* weights, int rays, int S,
                                        int white_bg, int sigma_only,
                                        void* stream) {
  if (rays <= 0) return 0;
  const int blocks = (rays + kRaysPerBlock - 1) / kRaysPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sigma_only) {
    quadrature_kernel<true><<<blocks, 32 * kRaysPerBlock, 0, st>>>(
        rgbs, t, image, depth, weights, rays, S, white_bg);
  } else {
    quadrature_kernel<false><<<blocks, 32 * kRaysPerBlock, 0, st>>>(
        rgbs, t, image, depth, weights, rays, S, white_bg);
  }
  return (int)cudaGetLastError();
}
