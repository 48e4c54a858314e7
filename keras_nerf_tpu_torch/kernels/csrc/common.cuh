// Shared constants for the ray-march kernels.
//
// Every constant below is the float32 value the JAX reference computes with
// (a Python float rounded once to float32), written as a hex literal so the
// CUDA compiler and the plain PyTorch versions in kernels/ray_march.py use
// bit-identical values. Arithmetic that the plain versions do as separate
// multiply and add uses the __f*_rn intrinsics, which the compiler never
// contracts into a fused multiply-add.
#pragma once

#include <cuda_runtime.h>

#define KNT_EXPORT extern "C" __attribute__((visibility("default")))

namespace knt {

constexpr float kWeightEps = 0x1.4f8b58p-17f;      // 1e-5, weights + eps
constexpr float kDenomMin = 0x1.4f8b58p-17f;       // 1e-5, inverse-CDF clamp
constexpr float kLastDelta = 0x1.b7cdfep-34f;      // 1e-10, last interval
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kInvTwoPi = 0x1.45f306p-3f;

}  // namespace knt
