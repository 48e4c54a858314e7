// The in-kernel positional encoding that ray_march_mlp.cu (bf16 MLP) and
// ray_march_mlp_int8.cu (int8 MLP) share, so both encode bit for bit alike
// (ROADMAP C1): keras_nerf_tpu/kernels/ray_march.py:1259-1280, _sin_poly
// :875. Each point's argument is rep = base_r + t * slope_r (per-ray
// coefficients from ray_encoding_coeffs); cos lanes add pi/2, sin and cos
// lanes are range-reduced by 2 pi before a degree-9 polynomial, raw lanes
// keep rep, empty lanes are 0. With KNT_ABL_NOSIN (profile_ablate's build,
// never the package's) the sine lanes keep their shifted argument instead.
#pragma once

#include "common.cuh"

namespace knt {

constexpr int kEncLanes = 128;  // xyz block at lanes 0.., dir block at 64..

// Horner steps as fused multiply-adds: the form XLA compiles the TPU
// kernel's _sin_poly to on the CPU, so the reference tests compare like
// with like; the plain version emulates each FMA in float64.
__device__ __forceinline__ float sin_poly(float x) {
  const float x2 = __fmul_rn(x, x);
  float p = __fmaf_rn(0x1.22cac8p-19f, x2, -0x1.94d06cp-13f);
  p = __fmaf_rn(p, x2, 0x1.105a2cp-7f);
  p = __fmaf_rn(p, x2, -0x1.55426ap-3f);
  p = __fmaf_rn(p, x2, 0x1.fffdd2p-1f);
  return __fmul_rn(x, p);
}

// The float32 encoding of lane l of point p (ray p / S): base, slope [rays,
// 128], depths [rays * S], masks [3, 128] raw/sin/cos lane selectors.
__device__ __forceinline__ float encode_lane(const float* __restrict__ base,
                                             const float* __restrict__ slope,
                                             const float* __restrict__ depths,
                                             const float* __restrict__ masks,
                                             int p, int l, int S) {
  const int r = p / S;
  // rep = base + t * slope and the 2 pi reduction as single-rounding FMAs,
  // as XLA contracts them (see sin_poly).
  const float rep = __fmaf_rn(depths[p], slope[(size_t)r * kEncLanes + l],
                              base[(size_t)r * kEncLanes + l]);
  if (masks[l] != 0.f) return rep;
  if (masks[kEncLanes + l] != 0.f || masks[2 * kEncLanes + l] != 0.f) {
    const float shifted =
        masks[2 * kEncLanes + l] != 0.f ? __fadd_rn(rep, kHalfPi) : rep;
#if defined(KNT_ABL_NOSIN)
    return shifted;  // profile_ablate's nosin build: no reduction, no sine
#else
    const float turns = rintf(__fmul_rn(shifted, kInvTwoPi));
    return sin_poly(__fmaf_rn(-kTwoPi, turns, shifted));
#endif
  }
  return 0.f;
}

// The same encoding for a thread that keeps one lane: what lane l holds (0
// nothing, 1 rep itself, 2 its sine, 3 its cosine), read once, then the
// value at depth t from its ray's base and slope, the sine computed for
// every kind and selected, so that a warp whose lanes hold every kind (a
// thread a lane, as in ray_march_mlp_int8.cu) takes one path. The same
// operations as encode_lane, so the same bits.
__device__ __forceinline__ int lane_kind(const float* __restrict__ masks, int l) {
  if (masks[l] != 0.f) return 1;
  if (masks[2 * kEncLanes + l] != 0.f) return 3;
  return masks[kEncLanes + l] != 0.f ? 2 : 0;
}

__device__ __forceinline__ float encode_value(float t, float slope, float base, int kind) {
  const float rep = __fmaf_rn(t, slope, base);
  const float shifted = kind == 3 ? __fadd_rn(rep, kHalfPi) : rep;
#if defined(KNT_ABL_NOSIN)
  const float s = shifted;
#else
  const float turns = rintf(__fmul_rn(shifted, kInvTwoPi));
  const float s = sin_poly(__fmaf_rn(-kTwoPi, turns, shifted));
#endif
  return kind == 1 ? rep : kind == 0 ? 0.f : s;
}

}  // namespace knt
