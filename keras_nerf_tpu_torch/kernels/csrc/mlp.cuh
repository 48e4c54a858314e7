// The MLP's packed weights and its kept activations, which the forward
// (ray_march_mlp.cu) and the dX chain (mlp_backward.cu) share, and the
// device table of a packed state that their streamed routes read.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace knt {

using bf16 = __nv_bfloat16;
constexpr int kMaxLayers = 16;

}  // namespace knt

// Device pointers of the pack_mlp_params arrays (kernel layout, row-major
// [fan_in, fan_out]); mirrored by a ctypes Structure in kernels/ray_march.py.
struct MlpWeights {
  const knt::bf16* trunk_w[knt::kMaxLayers];
  const knt::bf16* trunk_enc_w[knt::kMaxLayers];  // null where a layer skips the encoding
  const float* trunk_b[knt::kMaxLayers];
  const knt::bf16* w_sf;      // [u, u + 128], sigma in column u
  const knt::bf16* w_sf_enc;  // [128, u + 128] or null
  const float* b_sf;          // [u + 128]
  const knt::bf16* w_rf_top;  // [u, u / 2]
  const knt::bf16* w_rf_enc;  // [128, u / 2]
  const float* b_rf;          // [u / 2]
  const knt::bf16* w_rgb;     // [u / 2, 128], rgb in columns 0..2
  const float* b_rgb;         // [128]
  int n_layers;
  int units;
};

// The bf16 activations the train mode keeps for the backward, each a
// row-major [points, width] array: enc [P, 128], h[i] [P, u], features
// [P, u], rf [P, u / 2]. Mirrored in kernels/ray_march.py (_MlpStash).
struct MlpStash {
  knt::bf16* enc;
  knt::bf16* h[knt::kMaxLayers];
  knt::bf16* features;
  knt::bf16* rf;
};

// The head arrays of MlpWeights, in its order: the tail of a device table.
struct MlpHeads {
  const knt::bf16* w_sf;
  const knt::bf16* w_sf_enc;
  const float* b_sf;
  const knt::bf16* w_rf_top;
  const knt::bf16* w_rf_enc;
  const float* b_rf;
  const knt::bf16* w_rgb;
  const float* b_rgb;
};

namespace knt {

// Tensor maps of the device table: per layer trunk_w[i] and trunk_enc_w[i],
// then these five.
constexpr int kTableHeadMaps = 5;
enum TableHead { kMapSf, kMapSfEnc, kMapRfTop, kMapRfEnc, kMapRgb };

// A view of the device table of a packed state, any number of layers n,
// which the streamed kernels read (built once per packed state by
// kernels/ray_march.py: _mlp_table; its layout is mlp_table_layout): 2 n +
// 5 tensor maps of 128 bytes (trunk_w[i], trunk_enc_w[i] (all zero where
// null), then TableHead's, each array in [64 x 64] boxes of bf16 with the
// 128-byte swizzle), then the n trunk biases, the n trunk_enc_w pointers
// (null where a layer reads no encoding) and MlpHeads. The buffer is
// 64-byte aligned, as TMA needs a map in device memory to be.
struct MlpTable {
  const CUtensorMap* trunk;
  const CUtensorMap* trunk_enc;
  const CUtensorMap* heads;
  const float* const* trunk_b;
  const bf16* const* trunk_enc_w;
  const MlpHeads* w;
};

__device__ __forceinline__ MlpTable table_of(const void* base, int n) {
  MlpTable t;
  t.trunk = static_cast<const CUtensorMap*>(base);
  t.trunk_enc = t.trunk + n;
  t.heads = t.trunk_enc + n;
  t.trunk_b = reinterpret_cast<const float* const*>(t.heads + kTableHeadMaps);
  t.trunk_enc_w = reinterpret_cast<const bf16* const*>(t.trunk_b + n);
  t.w = reinterpret_cast<const MlpHeads*>(t.trunk_enc_w + n);
  return t;
}

}  // namespace knt
