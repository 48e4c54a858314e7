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
//
// with_grad mode (knt_ray_march_quadrature_grad): also replaces the MSE
// cotangent (:1345-1349) and _quadrature_bwd (:1158-1200). After the
// forward walk, d_pre = 2 (clip(image) - target) / (3 R) times the clip's
// subgradient (1 inside (0, 1), 0.5 at exactly 0 or 1, 0 outside, as XLA's
// autodiff takes it); d_w_s = rgb_s . d_pre (- sum d_pre on a white
// background). A second walk over the samples, last 32 first, recomputes
// x, T, e and w (the exclusive-sum carry in front of each 32-sample step
// is kept from the first walk in the register of lane step, so S <= 1024)
// and runs a reverse warp scan for sum_{j>s} w_j d_w_j: dL/dx_s =
// e_s T_s d_w_s - sum_{j>s} w_j d_w_j, with no division. Out per point,
// in bf16 as the TPU's backward consumes them: d_rgb = g rgb (1 - rgb)
// with g = w_s d_pre (16 columns, 0..2 used) and d_sigma = delta dL/dx
// [sigma > 0]. Bound: bytes (about 54 B per sample); the second walk
// re-reads the 20 B of the first, from L2.
#include <cuda_bf16.h>

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

// The clip's subgradient times the image cotangent (_quadrature_bwd
// :1171-1181).
__device__ __forceinline__ float clip_grad(float pre, float d) {
  if (pre > 0.f && pre < 1.f) return d;
  if (pre == 0.f || pre == 1.f) return __fmul_rn(0.5f, d);
  return 0.f;
}

__global__ void quadrature_grad_kernel(const float* __restrict__ rgbs,
                                       const float* __restrict__ t,
                                       const float* __restrict__ target,
                                       float* __restrict__ image,
                                       float* __restrict__ depth,
                                       float* __restrict__ weights,
                                       __nv_bfloat16* __restrict__ d_rgb,
                                       __nv_bfloat16* __restrict__ d_sigma,
                                       int rays, int S, int white_bg,
                                       float loss_scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (r >= rays) return;
  const float* t_r = t + (size_t)r * S;
  const float4* c_r = reinterpret_cast<const float4*>(rgbs) + (size_t)r * S;
  const int steps = (S + 31) / 32;

  // Walk 1: the forward, as quadrature_kernel. Lane k keeps the carry in
  // front of step k.
  float carry = 0.f, carry_at = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f;
  for (int k = 0; k < steps; ++k) {
    if (lane == k) carry_at = carry;
    const int s = k * 32 + lane;
    float x = 0.f, ts = 0.f;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      ts = t_r[s];
      const float delta = (s < S - 1) ? __fsub_rn(t_r[s + 1], ts) : knt::kLastDelta;
      c = c_r[s];
      x = __fmul_rn(c.w, delta);
    }
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
      acc_r += wgt * c.x;
      acc_g += wgt * c.y;
      acc_b += wgt * c.z;
    }
  }
  acc_d = warp_sum(acc_d);
  acc_w = warp_sum(acc_w);
  acc_r = warp_sum(acc_r);
  acc_g = warp_sum(acc_g);
  acc_b = warp_sum(acc_b);
  const float bg = white_bg ? 1.f - acc_w : 0.f;
  const float pre_r = acc_r + bg, pre_g = acc_g + bg, pre_b = acc_b + bg;
  const float img_r = fminf(fmaxf(pre_r, 0.f), 1.f);
  const float img_g = fminf(fmaxf(pre_g, 0.f), 1.f);
  const float img_b = fminf(fmaxf(pre_b, 0.f), 1.f);
  if (lane == 0) {
    image[(size_t)r * 3 + 0] = img_r;
    image[(size_t)r * 3 + 1] = img_g;
    image[(size_t)r * 3 + 2] = img_b;
    depth[r] = acc_d;
  }
  const float* tg = target + (size_t)r * 3;
  const float dp_r = clip_grad(pre_r, __fmul_rn(__fsub_rn(img_r, tg[0]), loss_scale));
  const float dp_g = clip_grad(pre_g, __fmul_rn(__fsub_rn(img_g, tg[1]), loss_scale));
  const float dp_b = clip_grad(pre_b, __fmul_rn(__fsub_rn(img_b, tg[2]), loss_scale));
  const float dp_sum = white_bg ? dp_r + dp_g + dp_b : 0.f;

  // Walk 2, last step first: the reverse scan of w_j d_w_j.
  float suffix_carry = 0.f;  // sum of w d_w over the steps already walked
  for (int k = steps - 1; k >= 0; --k) {
    const float carry_k = __shfl_sync(0xffffffffu, carry_at, k);
    const int s = k * 32 + lane;
    float x = 0.f, delta = 0.f;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      const float ts = t_r[s];
      delta = (s < S - 1) ? __fsub_rn(t_r[s + 1], ts) : knt::kLastDelta;
      c = c_r[s];
      x = __fmul_rn(c.w, delta);
    }
    float incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    excl += carry_k;
    const float e = expf(-x), tr = expf(-excl);
    const float wgt = (1.f - e) * tr;
    float d_w = 0.f, v = 0.f;
    if (s < S) {
      d_w = __fadd_rn(__fadd_rn(__fmul_rn(c.x, dp_r), __fmul_rn(c.y, dp_g)),
                      __fmul_rn(c.z, dp_b));
      d_w = __fsub_rn(d_w, dp_sum);
      v = __fmul_rn(wgt, d_w);
    }
    float suf = v;  // inclusive suffix sum within the step
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += y;
    }
    float later = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) later = 0.f;
    later += suffix_carry;
    suffix_carry += __shfl_sync(0xffffffffu, suf, 0);
    if (s < S) {
      const float d_x = __fsub_rn(__fmul_rn(__fmul_rn(e, tr), d_w), later);
      const float ds = c.w > 0.f ? __fmul_rn(d_x, delta) : 0.f;
      const size_t p = (size_t)r * S + s;
      d_sigma[p] = __float2bfloat16_rn(ds);
      const float gr = __fmul_rn(__fmul_rn(__fmul_rn(wgt, dp_r), c.x), __fsub_rn(1.f, c.x));
      const float gg = __fmul_rn(__fmul_rn(__fmul_rn(wgt, dp_g), c.y), __fsub_rn(1.f, c.y));
      const float gb = __fmul_rn(__fmul_rn(__fmul_rn(wgt, dp_b), c.z), __fsub_rn(1.f, c.z));
      __align__(16) __nv_bfloat162 row[8];
      row[0] = __floats2bfloat162_rn(gr, gg);
      row[1] = __floats2bfloat162_rn(gb, 0.f);
#pragma unroll
      for (int j = 2; j < 8; ++j) row[j] = __floats2bfloat162_rn(0.f, 0.f);
      uint4* dst = reinterpret_cast<uint4*>(d_rgb + p * 16);
      dst[0] = *reinterpret_cast<const uint4*>(&row[0]);
      dst[1] = *reinterpret_cast<const uint4*>(&row[4]);
    }
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

// The with_grad mode: as above (full, not sigma_only) plus target [rays, 3]
// and loss_scale = 2 / (3 R_chunk); writes d_rgb [rays * S, 16] and
// d_sigma [rays * S] bf16. S <= 1024.
KNT_EXPORT int knt_ray_march_quadrature_grad(const float* rgbs, const float* t,
                                             const float* target, float* image,
                                             float* depth, float* weights,
                                             __nv_bfloat16* d_rgb,
                                             __nv_bfloat16* d_sigma, int rays,
                                             int S, int white_bg, float loss_scale,
                                             void* stream) {
  if (rays <= 0) return 0;
  if (S < 1 || S > 32 * 32) return (int)cudaErrorInvalidValue;
  const int blocks = (rays + kRaysPerBlock - 1) / kRaysPerBlock;
  quadrature_grad_kernel<<<blocks, 32 * kRaysPerBlock, 0, (cudaStream_t)stream>>>(
      rgbs, t, target, image, depth, weights, d_rgb, d_sigma, rays, S, white_bg,
      loss_scale);
  return (int)cudaGetLastError();
}
