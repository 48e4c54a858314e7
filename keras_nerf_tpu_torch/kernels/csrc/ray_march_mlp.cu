// ray_march_mlp: positional encoding and the radiance-field MLP per point.
//
// Replaces: the in-kernel encoding (keras_nerf_tpu/kernels/ray_march.py
// :1259-1280, _sin_poly :875; encode.cuh, which ray_march_mlp_int8.cu
// shares) and _forward_core (:369-426) of _train_chunk_kernel, in its full
// and sigma_only forms. The MLP multiplies bf16 operands with float32
// accumulation, adds the float32 bias, applies relu and rounds to bf16
// between layers, exactly the TPU kernel's precision policy, in the packed
// layout of pack_mlp_params
// (encoding blocks at lanes 0 and 64 of a 128-wide input, sigma in column
// `units` of the fused sigma/feature matrix).
//
// Bound on the H100: operations. 8 x 256 with the 63 + 27 wide encodings
// is 1.19 MFLOP per point (0.98 in sigma-only mode) against 16 B written;
// a 4096 x 192 fine chunk is 0.93 TFLOP, 0.94 ms at 989 TFLOP/s.
//
// Design (a first, plain tensor-core version): one block of 8 warps per
// tile of 64 points. The bf16 encoding tile and two bf16 activation tiles
// (ping-pong, one per layer) live in shared memory; the weights (1.3 MB at
// 8 x 256) stay in global memory and are read through L2/L1 as wmma
// fragments. Each warp owns a 64 x 32 output block per layer, so every
// weight element is read once per tile. Products run on the tensor cores
// with nvcuda::wmma 16x16x16 bf16 -> f32; the accumulators go through a
// per-warp float32 scratch for the bias/relu/bf16 epilogue. Not yet used:
// wgmma, TMA and staged weight tiles in shared memory (later work).
//
// Train mode (a non-null MlpStash, full mode only): the forward of
// fused_train_chunk(with_grad=True) (:1292-1294, keep_acts). As each bf16
// tile is finished in shared memory (the encoding, every trunk layer, the
// features, rf) the block also copies it, 16 bytes per thread, to the
// stash in device memory, where mlp_backward and mlp_weight_grad read it:
// 5,120 B written per point at 8 x 256 (1.5 ns at 3.35 TB/s), which makes
// this mode bound by bytes beside its 1.19 MFLOP per point (1.2 ns). The
// copies overlap the next layer's products, which read only shared memory.
//
// Input mode (knt_apply_mlp, the apply_mlp wrapper): the TPU's
// fused_apply_mlp / _mlp_fwd_kernel (:438-493), the same _forward_core over
// points encoded outside the kernel (encode_block128, [P, 128] bf16). The
// block reads its encoded tile from device memory, 16 bytes per thread,
// instead of building it from base + t * slope; the rest is the full mode,
// (r, g, b, sigma) out. With a stash it is fused_mlp_backward's recompute:
// the stash's enc block is the input itself, so only the trunk activations,
// the features and rf are written. Bound: operations, 1.19 MFLOP per point
// against 272 B read and written (0.08 ns at 3.35 TB/s); with a stash,
// bytes (4,864 B written per point, 1.5 ns).
#include "encode.cuh"
#include "mlp.cuh"

using namespace nvcuda;
using namespace knt;

namespace {

constexpr int kTile = 64;      // points per block
constexpr int kWarps = 8;
constexpr int kEncLd = kEncLanes + 8;  // padded row strides (bf16 elements)

// out[:, n0..n0+NF*16) = bf16(act(acc + bias)), through the warp's scratch.
template <int NF>
__device__ __forceinline__ void store_bf16(AccFrag (&acc)[4][NF], float* scratch,
                                           const float* bias, bool relu,
                                           bf16* out, int ldo, int n0, int lane) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::store_matrix_sync(scratch, acc[m][f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e >> 4, cc = e & 15, col = n0 + f * 16 + cc;
        float v = __fadd_rn(scratch[e], bias[col]);
        if (relu) v = fmaxf(v, 0.f);
        out[(m * 16 + rr) * ldo + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// Dense layer over the tile: out = act(A @ W (+ E @ W_enc) + bias), the
// output columns split over the warps in blocks of 32.
__device__ void dense_layer(const bf16* A, int lda, int K, const bf16* W,
                            const bf16* E, const bf16* W_enc, int N,
                            const float* bias, bool relu, bf16* out, int ldo,
                            float* scratch, int warp, int lane) {
  for (int n0 = warp * 32; n0 < N; n0 += kWarps * 32) {
    AccFrag acc[4][2];
    zero(acc);
    mma_rows(acc, A, lda, W, N, K, n0);
    if (W_enc != nullptr) mma_rows(acc, E, kEncLd, W_enc, N, kEncLanes, n0);
    store_bf16(acc, scratch, bias, relu, out, ldo, n0, lane);
  }
}

// One 16-column head block (sigma or rgb) over the tile into float32
// scratch rows: dst[p] for p in 0..63 gets column `col` of the block.
__device__ void head16(const bf16* A, int lda, int K, const bf16* W, int ldw,
                       const bf16* E, const bf16* W_enc, int n0,
                       float* scratch, float* dst, int ncols, int lane) {
  AccFrag acc[4][1];
  zero(acc);
  mma_rows(acc, A, lda, W, ldw, K, n0);
  if (W_enc != nullptr) mma_rows(acc, E, kEncLd, W_enc, ldw, kEncLanes, n0);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wmma::store_matrix_sync(scratch, acc[m][0], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * ncols; e += 32) {
      const int rr = e / ncols, cc = e % ncols;
      dst[(m * 16 + rr) * ncols + cc] = scratch[rr * 16 + cc];
    }
    __syncwarp();
  }
}

// kEncIn: the input mode, the encoded tile read from enc_in [P, 128].
template <bool kSigmaOnly, bool kEncIn>
__global__ void __launch_bounds__(kWarps * 32)
mlp_kernel(const MlpWeights w, const float* __restrict__ base,
           const float* __restrict__ slope, const float* __restrict__ depths,
           const float* __restrict__ masks, const bf16* __restrict__ enc_in,
           float* __restrict__ out, int P, int S, const MlpStash stash) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int u = w.units, half = u / 2, act_ld = u + 8;
  bf16* enc = reinterpret_cast<bf16*>(smem);
  bf16* act0 = enc + kTile * kEncLd;
  bf16* act1 = act0 + kTile * act_ld;
  float* scratch_all = reinterpret_cast<float*>(act1 + kTile * act_ld);
  float* sig = scratch_all + kWarps * 256;  // [64] sigma pre-activation
  float* rgb = sig + kTile;                 // [64 * 3] rgb pre-activation

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = scratch_all + warp * 256;
  const int p0 = blockIdx.x * kTile;
  const bool train = stash.features != nullptr;
  const int rows = min(kTile, P - p0);

  if (kEncIn) {
    // The encoded tile (zero past the last point), 16 bytes per thread.
    constexpr int kVecs = kEncLanes / 8;
    for (int v = threadIdx.x; v < kTile * kVecs; v += blockDim.x) {
      const int pl = v / kVecs, c = (v % kVecs) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (pl < rows)
        val = *reinterpret_cast<const uint4*>(enc_in + (size_t)(p0 + pl) * kEncLanes + c);
      *reinterpret_cast<uint4*>(enc + pl * kEncLd + c) = val;
    }
  } else {
    // Positional encoding of the tile's points (ray_march.py:1259-1280).
    for (int idx = threadIdx.x; idx < kTile * kEncLanes; idx += blockDim.x) {
      const int pl = idx / kEncLanes, l = idx % kEncLanes, p = p0 + pl;
      const float v = p < P ? encode_lane(base, slope, depths, masks, p, l, S) : 0.f;
      enc[pl * kEncLd + l] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();
  if (train && !kEncIn) copy_tile_out(stash.enc, p0, rows, kEncLanes, enc, kEncLd);

  // Trunk (_forward_core :387-400).
  const bf16* h = enc;
  int h_ld = kEncLd, h_k = kEncLanes;
  bf16* bufs[2] = {act0, act1};
  for (int i = 0; i < w.n_layers; ++i) {
    bf16* dst = bufs[i & 1];
    dense_layer(h, h_ld, h_k, w.trunk_w[i], enc, w.trunk_enc_w[i], u,
                w.trunk_b[i], true, dst, act_ld, scratch, warp, lane);
    __syncthreads();
    // The next layer only reads dst, so the copy needs no barrier of its own.
    if (train) copy_tile_out(stash.h[i], p0, rows, u, dst, act_ld);
    h = dst;
    h_ld = act_ld;
    h_k = u;
  }
  bf16* spare = (h == act0) ? act1 : act0;

  // Sigma: column u of the fused sigma/feature head (:404-418).
  if (warp == kWarps - 1) {
    head16(h, h_ld, u, w.w_sf, u + 128, enc, w.w_sf_enc, u, scratch, sig, 1, lane);
    __syncwarp();
    for (int pl = lane; pl < kTile; pl += 32) sig[pl] = fmaxf(__fadd_rn(sig[pl], w.b_sf[u]), 0.f);
  }
  if (kSigmaOnly) {
    __syncthreads();
    for (int pl = threadIdx.x; pl < kTile; pl += blockDim.x)
      if (p0 + pl < P) out[p0 + pl] = sig[pl];
    return;
  }

  // features = bf16(h @ w_sf[:, :u] (+ enc @ w_sf_enc[:, :u]) + b_sf), no relu.
  for (int n0 = warp * 32; n0 < u; n0 += kWarps * 32) {
    AccFrag acc[4][2];
    zero(acc);
    mma_rows(acc, h, h_ld, w.w_sf, u + 128, u, n0);
    if (w.w_sf_enc != nullptr) mma_rows(acc, enc, kEncLd, w.w_sf_enc, u + 128, kEncLanes, n0);
    store_bf16(acc, scratch, w.b_sf, false, spare, act_ld, n0, lane);
  }
  __syncthreads();
  if (train) copy_tile_out(stash.features, p0, rows, u, spare, act_ld);
  // rf = bf16(features @ w_rf_top + enc @ w_rf_enc + b_rf), no relu.
  bf16* rf = const_cast<bf16*>(h);
  dense_layer(spare, act_ld, u, w.w_rf_top, enc, w.w_rf_enc, half, w.b_rf,
              false, rf, act_ld, scratch, warp, lane);
  __syncthreads();
  if (train) copy_tile_out(stash.rf, p0, rows, half, rf, act_ld);
  // rgb = sigmoid(rf @ w_rgb + b_rgb), columns 0..2.
  if (warp == 0) {
    head16(rf, act_ld, half, w.w_rgb, 128, nullptr, nullptr, 0, scratch, rgb, 3, lane);
    __syncwarp();
    for (int pl = lane; pl < kTile; pl += 32) {
      const int p = p0 + pl;
      if (p >= P) continue;
      float4 o;
      o.x = 1.f / (1.f + expf(-__fadd_rn(rgb[pl * 3 + 0], w.b_rgb[0])));
      o.y = 1.f / (1.f + expf(-__fadd_rn(rgb[pl * 3 + 1], w.b_rgb[1])));
      o.z = 1.f / (1.f + expf(-__fadd_rn(rgb[pl * 3 + 2], w.b_rgb[2])));
      o.w = sig[pl];
      reinterpret_cast<float4*>(out)[p] = o;
    }
  }
}

size_t smem_bytes(int units) {
  return sizeof(bf16) * (size_t)kTile * (kEncLd + 2 * (units + 8)) +
         sizeof(float) * (kWarps * 256 + kTile * 4);
}

template <bool kSigmaOnly, bool kEncIn>
int launch(const MlpWeights* w, const float* base, const float* slope,
           const float* depths, const float* masks, const bf16* enc_in, float* out,
           int P, int S, const MlpStash& kept, cudaStream_t st) {
  const size_t smem = smem_bytes(w->units);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_kernel<kSigmaOnly, kEncIn>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (P + kTile - 1) / kTile;
  mlp_kernel<kSigmaOnly, kEncIn><<<blocks, kWarps * 32, smem, st>>>(
      *w, base, slope, depths, masks, enc_in, out, P, S, kept);
  return (int)cudaGetLastError();
}

bool weights_ok(const MlpWeights* w) {
  return w->n_layers >= 1 && w->n_layers <= kMaxLayers && w->units % 256 == 0;
}

}  // namespace

// base, slope: [rays, 128]; depths: [rays, S]; masks: [3, 128] raw/sin/cos
// lane selectors; out: [rays * S, 4] (r, g, b, sigma) or [rays * S] sigma;
// stash: null, or (full mode only) the arrays of the train mode.
KNT_EXPORT int knt_ray_march_mlp(const MlpWeights* w, const float* base,
                                 const float* slope, const float* depths,
                                 const float* masks, float* out, int rays,
                                 int S, int sigma_only, const MlpStash* stash,
                                 void* stream) {
  const long long points = (long long)rays * S;
  if (points <= 0) return 0;
  if (!weights_ok(w) || points > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (stash != nullptr && sigma_only) return (int)cudaErrorInvalidValue;
  const int P = (int)points;
  MlpStash kept = {};
  if (stash != nullptr) kept = *stash;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sigma_only)
    return launch<true, false>(w, base, slope, depths, masks, nullptr, out, P, S, kept, st);
  return launch<false, false>(w, base, slope, depths, masks, nullptr, out, P, S, kept, st);
}

// enc: [P, 128] bf16 encoded points; out: [P, 4] (r, g, b, sigma); stash:
// null, or the recompute's arrays, whose enc block is `enc` itself.
KNT_EXPORT int knt_apply_mlp(const MlpWeights* w, const bf16* enc, float* out,
                             int P, const MlpStash* stash, void* stream) {
  if (P <= 0) return 0;
  if (!weights_ok(w)) return (int)cudaErrorInvalidValue;
  if (stash != nullptr && stash->enc != enc) return (int)cudaErrorInvalidValue;
  MlpStash kept = {};
  if (stash != nullptr) kept = *stash;
  return launch<false, true>(w, nullptr, nullptr, nullptr, nullptr, enc, out, P, 1, kept,
                             (cudaStream_t)stream);
}
