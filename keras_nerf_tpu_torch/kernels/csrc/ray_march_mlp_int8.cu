// ray_march_mlp_int8: positional encoding and the W8A8 int8 MLP per point,
// the render tier's trunk and heads.
//
// Replaces: keras_nerf_tpu/kernels/quantize.py:248 forward_core_int8 (with
// _quant_act :238 and _doti8 :243), the trunk of _train_chunk_kernel in its
// quantized mode (keras_nerf_tpu/kernels/ray_march.py:1285-1290), full and
// sigma_only. The encoding is encode.cuh's, as in ray_march_mlp.cu, but the
// tile stays float32: each quantization site reads it and quantizes it with
// its own static scale (enc_r[0] for layer 0, enc_r[i] for a skip layer,
// enc_r_sf for the last skip, enc_r_rf for rgb_features). Every product is
// int8 x int8 with int32 accumulation, exact. The epilogue of each layer runs
// in forward_core_int8's order, each step rounded once (__fmul_rn /
// __fadd_rn, never contracted into an FMA, so the codes round where the plain
// version rounds them): float(acc) * u, + float(acc_enc) * u_enc, + b, relu
// (the trunk only; features and rgb_features are linear), then the next
// site's code rint(h * r) clipped to +-127. Sigma is relu'd and rgb
// sigmoid'ed as in ray_march_mlp.cu.
//
// Bound on the H100: operations. 8 x 256 with the 63 + 27 wide encodings is
// 1.19 MOP per point (0.98 in sigma-only mode) against 16 B written; at the
// dense int8 rate of 1,979 TOP/s a 4096 x 192 fine chunk is 0.47 ms.
//
// Design (a first, plain tensor-core version, as ray_march_mlp.cu): one
// block of 8 warps per tile of 64 points. The float32 encoding tile (32 KB),
// one int8 tile of quantized encoding and two int8 activation tiles
// (ping-pong) live in shared memory; the int8 weights (0.66 MB at 8 x 256)
// stay in global memory, transposed ([fan_out, fan_in]: column-major B
// fragments, faster than row-major ones on an H100), and are read through
// L2/L1 as wmma fragments. Each warp owns 64 x 16 output
// blocks, two blocks run on each SM. Products run on the tensor cores with
// nvcuda::wmma 16x16x16 s8 -> s32; the accumulators (and those of the
// encoding's skip product) go through a per-warp int32 scratch for the
// epilogue. Not yet used: wgmma, TMA, weights staged in shared memory.
#include <mma.h>

#include "encode.cuh"

using namespace nvcuda;
using namespace knt;

namespace {

constexpr int kMaxLayers = 16;
constexpr int kTile = 64;                // points per block
constexpr int kWarps = 8;
constexpr int kEncLd = kEncLanes + 4;    // float32 encoding row stride
constexpr int kQEncLd = kEncLanes + 16;  // int8 row strides: multiples of 16 B
constexpr int kScratch = 512;            // int32 per warp: two 16 x 16 blocks
// One 16-column fragment per warp and pass, and two blocks per SM: with two
// fragments the accumulators of a skip layer's two products take 128
// registers, the kernel 255 (and spills) and one block per SM; this way 128
// registers and two blocks, faster on an H100 at the orbit's chunks.
constexpr int kNF = 1;
constexpr int kMinBlocks = 2;

using i8 = signed char;
using IAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;
using IA = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using IB = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>;

}  // namespace

// Device pointers of the quantize_packed arrays: int8 weights transposed,
// row-major [fan_out, fan_in] (quantize_packed's [fan_in, fan_out] arrays,
// which the wrapper transposes), float32 per-column vectors (u:
// dequantization of the product, b: bias, r: requantization of the
// activation a layer makes; enc_r*: requantization of the encoding at each
// site). Mirrored by a ctypes Structure in kernels/ray_march.py
// (_MlpInt8Weights).
struct MlpInt8Weights {
  const i8* trunk_w[kMaxLayers];      // [u, 128 or u]
  const float* trunk_u[kMaxLayers];   // [u]
  const float* trunk_b[kMaxLayers];   // [u]
  const float* trunk_r[kMaxLayers];   // [u]: code of h_i for the next product
  const i8* trunk_enc_w[kMaxLayers];  // [u, 128], null unless a skip layer
  const float* trunk_enc_u[kMaxLayers];
  const float* enc_r[kMaxLayers];     // [128]: enc_r[0], and each skip layer's
  const i8* w_feat;                   // [u, u]
  const float* u_feat;
  const float* b_feat;
  const i8* w_sig;                    // [128, u], sigma in row 0
  const float* u_sig;
  const float* b_sig;
  const i8* w_feat_enc;               // [u, 128] or null (no last skip)
  const float* u_feat_enc;
  const i8* w_sig_enc;                // [128, 128] or null
  const float* u_sig_enc;
  const float* enc_r_sf;              // [128] or null
  const float* r_feat;                // [u]
  const i8* w_rf_top;                 // [u / 2, u]
  const float* u_rf_top;
  const i8* w_rf_enc;                 // [u / 2, 128]
  const float* u_rf_enc;
  const float* enc_r_rf;              // [128]
  const float* b_rf;                  // [u / 2]
  const float* r_rf;                  // [u / 2]
  const i8* w_rgb;                    // [128, u / 2], rgb in rows 0..2
  const float* u_rgb;
  const float* b_rgb;
  int n_layers;
  int units;
};

namespace {

// _quant_act: rint (ties to even, as jnp.round) of x * r, clipped to +-127.
__device__ __forceinline__ i8 quant(float x, float r) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(x, r)), -127.f), 127.f);
  return static_cast<i8>(__float2int_rn(q));
}

template <int NF>
__device__ __forceinline__ void zero_i(IAcc (&acc)[4][NF]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[m][f], 0);
}

// acc[m][f] += A[m*16.., 0..K) @ Wt[n0 + f*16.., 0..K)^T; A int8 in shared
// memory (all 64 rows of a point tile), Wt the int8 weight transposed,
// row-major [N, K] in global memory: B column-major, the only integer
// layout of mma.sync (a row-major B is gathered byte by byte).
template <int NF>
__device__ __forceinline__ void mma_i8(IAcc (&acc)[4][NF], const i8* A, int lda,
                                       const i8* Wt, int K, int n0) {
  IA a[4];
  IB b;
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::load_matrix_sync(a[m], A + m * 16 * lda + k0, lda);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::load_matrix_sync(b, Wt + (size_t)(n0 + f * 16) * K + k0, K);
#pragma unroll
      for (int m = 0; m < 4; ++m) wmma::mma_sync(acc[m][f], a[m], b, acc[m][f]);
    }
  }
}

// Dense int8 layer over the tile, output columns split over the warps in
// blocks of 16 kNF: out = quant(act(float(A @ W) u (+ float(E @ W_enc) u_enc)
// + b), r). W and W_enc come transposed, [N, K] and [N, 128]; E is the
// quantized encoding.
__device__ void dense_i8(const i8* A, int lda, int K, const i8* W, const float* u,
                         const i8* E, const i8* W_enc, const float* u_enc,
                         const float* b, const float* r, bool relu, int N, i8* out,
                         int ldo, int* scratch, int warp, int lane) {
  const bool enc = W_enc != nullptr;
  for (int n0 = warp * 16 * kNF; n0 < N; n0 += kWarps * 16 * kNF) {
    IAcc acc[4][kNF], acc_e[4][kNF];
    zero_i(acc);
    mma_i8(acc, A, lda, W, K, n0);
    if (enc) {
      zero_i(acc_e);
      mma_i8(acc_e, E, kQEncLd, W_enc, kEncLanes, n0);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        wmma::store_matrix_sync(scratch, acc[m][f], 16, wmma::mem_row_major);
        if (enc) wmma::store_matrix_sync(scratch + 256, acc_e[m][f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4, col = n0 + f * 16 + (e & 15);
          float v = __fmul_rn(static_cast<float>(scratch[e]), u[col]);
          if (enc) v = __fadd_rn(v, __fmul_rn(static_cast<float>(scratch[256 + e]), u_enc[col]));
          v = __fadd_rn(v, b[col]);
          if (relu) v = fmaxf(v, 0.f);
          out[(m * 16 + rr) * ldo + col] = quant(v, r[col]);
        }
        __syncwarp();
      }
    }
  }
}

// Head columns 0..ncols-1 (of the first 16-column block) over the tile:
// dst[p * 4 + c] = float(A @ W)[p, c] u[c] (+ float(E @ W_enc)[p, c]
// u_enc[c]) + b[c] for p in 0..63; W and W_enc come transposed, [128, K].
__device__ void head(const i8* A, int lda, int K, const i8* W, const i8* E,
                     const i8* W_enc, int ncols, const float* u, const float* u_enc,
                     const float* b, int* scratch, float* dst, int lane) {
  const bool enc = W_enc != nullptr;
  IAcc acc[4][1], acc_e[4][1];
  zero_i(acc);
  mma_i8(acc, A, lda, W, K, 0);
  if (enc) {
    zero_i(acc_e);
    mma_i8(acc_e, E, kQEncLd, W_enc, kEncLanes, 0);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wmma::store_matrix_sync(scratch, acc[m][0], 16, wmma::mem_row_major);
    if (enc) wmma::store_matrix_sync(scratch + 256, acc_e[m][0], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * ncols; e += 32) {
      const int rr = e / ncols, c = e % ncols;
      float v = __fmul_rn(static_cast<float>(scratch[rr * 16 + c]), u[c]);
      if (enc) v = __fadd_rn(v, __fmul_rn(static_cast<float>(scratch[256 + rr * 16 + c]), u_enc[c]));
      dst[(m * 16 + rr) * 4 + c] = __fadd_rn(v, b[c]);
    }
    __syncwarp();
  }
}

// The float32 encoding tile quantized with one site's scale into qenc.
__device__ void quant_enc(const float* encf, const float* r, i8* qenc) {
  for (int idx = threadIdx.x; idx < kTile * kEncLanes; idx += blockDim.x) {
    const int pl = idx / kEncLanes, l = idx % kEncLanes;
    qenc[pl * kQEncLd + l] = quant(encf[pl * kEncLd + l], r[l]);
  }
}

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
mlp_int8_kernel(const MlpInt8Weights w, const float* __restrict__ base,
                const float* __restrict__ slope, const float* __restrict__ depths,
                const float* __restrict__ masks, float* __restrict__ out, int P,
                int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int u = w.units, half = u / 2, act_ld = u + 16;
  int* scratch_all = reinterpret_cast<int*>(smem);
  float* encf = reinterpret_cast<float*>(scratch_all + kWarps * kScratch);
  i8* qenc = reinterpret_cast<i8*>(encf + kTile * kEncLd);
  i8* act0 = qenc + kTile * kQEncLd;
  i8* act1 = act0 + kTile * act_ld;
  float* pre = reinterpret_cast<float*>(act1 + kTile * act_ld);  // [64, 4]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* scratch = scratch_all + warp * kScratch;
  const int p0 = blockIdx.x * kTile;

  // Positional encoding of the tile's points, kept in float32.
  for (int idx = threadIdx.x; idx < kTile * kEncLanes; idx += blockDim.x) {
    const int pl = idx / kEncLanes, l = idx % kEncLanes, p = p0 + pl;
    encf[pl * kEncLd + l] = p < P ? encode_lane(base, slope, depths, masks, p, l, S) : 0.f;
  }
  __syncthreads();
  quant_enc(encf, w.enc_r[0], qenc);
  __syncthreads();

  // Trunk (forward_core_int8 :260-270).
  const i8* h = qenc;
  int h_ld = kQEncLd, h_k = kEncLanes;
  i8* bufs[2] = {act0, act1};
  for (int i = 0; i < w.n_layers; ++i) {
    const bool skip = i > 0 && w.trunk_enc_w[i] != nullptr;
    if (skip) {  // every read of qenc ended at the last layer's barrier
      quant_enc(encf, w.enc_r[i], qenc);
      __syncthreads();
    }
    i8* dst = bufs[i & 1];
    dense_i8(h, h_ld, h_k, w.trunk_w[i], w.trunk_u[i], qenc,
             skip ? w.trunk_enc_w[i] : nullptr, w.trunk_enc_u[i], w.trunk_b[i],
             w.trunk_r[i], true, u, dst, act_ld, scratch, warp, lane);
    __syncthreads();
    h = dst;
    h_ld = act_ld;
    h_k = u;
  }
  i8* spare = (h == act0) ? act1 : act0;

  // Sigma, and the features' encoding product after a last skip (:276-285).
  const bool last_enc = w.w_sig_enc != nullptr;
  if (last_enc) {
    quant_enc(encf, w.enc_r_sf, qenc);
    __syncthreads();
  }
  if (warp == kWarps - 1) {
    head(h, h_ld, u, w.w_sig, qenc, w.w_sig_enc, 1, w.u_sig, w.u_sig_enc, w.b_sig, scratch,
         pre + 3, lane);
    __syncwarp();
    for (int pl = lane; pl < kTile; pl += 32) pre[pl * 4 + 3] = fmaxf(pre[pl * 4 + 3], 0.f);
  }
  if (kSigmaOnly) {
    __syncthreads();
    for (int pl = threadIdx.x; pl < kTile; pl += blockDim.x)
      if (p0 + pl < P) out[p0 + pl] = pre[pl * 4 + 3];
    return;
  }

  // features (linear), coded with r_feat (:289-297).
  dense_i8(h, h_ld, u, w.w_feat, w.u_feat, qenc, w.w_feat_enc, w.u_feat_enc,
           w.b_feat, w.r_feat, false, u, spare, act_ld, scratch, warp, lane);
  __syncthreads();
  // rgb_features (linear) from the features' codes and the encoding coded
  // with enc_r_rf, coded with r_rf (:298-305), into the trunk's last buffer.
  quant_enc(encf, w.enc_r_rf, qenc);
  __syncthreads();
  i8* rf = const_cast<i8*>(h);
  dense_i8(spare, act_ld, u, w.w_rf_top, w.u_rf_top, qenc, w.w_rf_enc, w.u_rf_enc,
           w.b_rf, w.r_rf, false, half, rf, act_ld, scratch, warp, lane);
  __syncthreads();
  // rgb = sigmoid(float(rf @ w_rgb) u_rgb + b_rgb), columns 0..2 (:306-307).
  if (warp == 0) {
    head(rf, act_ld, half, w.w_rgb, nullptr, nullptr, 3, w.u_rgb, nullptr, w.b_rgb, scratch,
         pre, lane);
    __syncwarp();
    for (int pl = lane; pl < kTile; pl += 32) {
      const int p = p0 + pl;
      if (p >= P) continue;
      float4 o;
      o.x = 1.f / (1.f + expf(-pre[pl * 4 + 0]));
      o.y = 1.f / (1.f + expf(-pre[pl * 4 + 1]));
      o.z = 1.f / (1.f + expf(-pre[pl * 4 + 2]));
      o.w = pre[pl * 4 + 3];
      reinterpret_cast<float4*>(out)[p] = o;
    }
  }
}

size_t smem_bytes(int units) {
  return sizeof(int) * kWarps * kScratch + sizeof(float) * kTile * kEncLd +
         (size_t)kTile * (kQEncLd + 2 * (units + 16)) + sizeof(float) * kTile * 4;
}

template <bool kSigmaOnly>
int launch(const MlpInt8Weights* w, const float* base, const float* slope,
           const float* depths, const float* masks, float* out, int P, int S,
           cudaStream_t st) {
  const size_t smem = smem_bytes(w->units);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_int8_kernel<kSigmaOnly>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (P + kTile - 1) / kTile;
  mlp_int8_kernel<kSigmaOnly><<<blocks, kWarps * 32, smem, st>>>(*w, base, slope, depths,
                                                                  masks, out, P, S);
  return (int)cudaGetLastError();
}

bool weights_ok(const MlpInt8Weights* w) {
  return w->n_layers >= 1 && w->n_layers <= kMaxLayers && w->units % 256 == 0 &&
         w->enc_r[0] != nullptr && w->trunk_enc_w[0] == nullptr &&
         (w->w_sig_enc == nullptr) == (w->enc_r_sf == nullptr);
}

}  // namespace

// base, slope: [rays, 128]; depths: [rays, S]; masks: [3, 128] raw/sin/cos
// lane selectors; out: [rays * S, 4] (r, g, b, sigma) or [rays * S] sigma.
KNT_EXPORT int knt_ray_march_mlp_int8(const MlpInt8Weights* w, const float* base,
                                      const float* slope, const float* depths,
                                      const float* masks, float* out, int rays,
                                      int S, int sigma_only, void* stream) {
  const long long points = (long long)rays * S;
  if (points <= 0) return 0;
  if (!weights_ok(w) || points > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int P = (int)points;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sigma_only) return launch<true>(w, base, slope, depths, masks, out, P, S, st);
  return launch<false>(w, base, slope, depths, masks, out, P, S, st);
}
