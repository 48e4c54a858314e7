// mlp_backward: the dX chain of the MLP's backward, per tile of points.
//
// Replaces: the cotangent half of _backward_core
// (keras_nerf_tpu/kernels/ray_march.py:804-872) in the TPU's
// fused_train_chunk(with_grad=True): from the head cotangents that
// ray_march_quadrature's with_grad mode writes (d_rgb_pre in columns 0..2
// of a [P, 16] bf16 array, d_sigma_pre [P] bf16) it walks the heads and
// then the trunk in reverse:
//   d_rf       = bf16(d_rgb_pre @ w_rgb^T)
//   d_features = bf16(d_rf @ w_rf_top^T)
//   d_h        = [d_features | d_sigma_pre] @ w_sf[:, :u + 16]^T   (float32)
//   for each trunk layer i, last first:
//     d_pre_i = bf16(d_h [h_i > 0]);  d_h = d_pre_i @ W_i^T          (float32)
// and writes every bf16 cotangent (d_rf [P, u/2], d_sf [P, u + 16] =
// d_features | d_sigma | 0, d_pre_i [P, u]): the operands of the dW products
// that mlp_weight_grad computes, as the TPU's dW consumes them. The relu
// masks come from the trunk activations the forward kept (MlpStash). The
// encoding gets no cotangent: positions are data.
//
// Output-head mode (knt_mlp_backward_from_output): the head step of the
// TPU's fused_mlp_backward / _mlp_bwd_kernel (:562-579), which starts from
// the cotangent of the MLP's outputs rather than of the quadrature. It reads
// g [P, 4] bf16 (rgb 0..2, sigma 3; rounded before the kernel, :745-747)
// and y [P, 4] float32, the recompute's (sigmoid rgb, relu sigma), forms
//   d_rgb_pre   = bf16(g_rgb rgb (1 - rgb))    (float32 products, this order)
//   d_sigma_pre = bf16(g_sigma [sigma > 0])
// in the prologue, writes d_rgb_pre as [P, 16] for mlp_weight_grad and runs
// the same chain. 34 B more per point than the quadrature mode reads.
//
// Bound on the H100: bytes, as this kernel's inputs and outputs stand. Per
// point at 8 x 256 it reads 34 B of head cotangents and 4 KB of kept trunk
// activations and writes 4.9 KB of cotangents (2.7 ns at 3.35 TB/s) against
// 1,115,392 FLOP (1.1 ns at 989 TFLOP/s). The whole of T3 is bound by
// operations (3.49 MFLOP per point); the stash and the cotangents in device
// memory are the price of splitting it over kernels (PERF.md).
//
// Design (a first, plain tensor-core version, the forward kernel's): one
// block of 8 warps per 64 points. The cotangent tiles live in shared
// memory (d_sf, then two ping-pong d_pre tiles, one of them in d_sf's
// place once the heads are done: 96 KB, 2 blocks per SM); the weights stay
// in global memory and are read as column-major wmma B fragments, so W^T is
// never formed. Each warp owns 64 x 32 output blocks; each finished tile
// is copied to device memory 16 bytes per thread.
#include "mlp.cuh"

using namespace nvcuda;
using namespace knt;

// Device pointers of the cotangent arrays; mirrored in kernels/ray_march.py.
struct MlpCotangents {
  bf16* d_rf;                // [P, u / 2]
  bf16* d_sf;                // [P, u + 16]
  bf16* d_pre[kMaxLayers];   // [P, u] each
};

namespace {

constexpr int kTile = 64;
constexpr int kWarps = 8;
constexpr int kHead = 16;  // head cotangent columns

// out[:, n0..) = bf16(acc), or bf16(acc [h > 0]) with the relu mask read
// from the kept activation h (row-major [P, u]), through the warp's scratch.
template <int NF>
__device__ __forceinline__ void store_cot(AccFrag (&acc)[4][NF], float* scratch,
                                          const bf16* __restrict__ h, int p0,
                                          int P, int u, bf16* out, int ldo,
                                          int n0, int lane) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::store_matrix_sync(scratch, acc[m][f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e >> 4, cc = e & 15, row = m * 16 + rr, col = n0 + f * 16 + cc;
        float v = scratch[e];
        if (h != nullptr) {
          const int p = p0 + row;
          const bool live = p < P && __bfloat162float(h[(size_t)p * u + col]) > 0.f;
          v = live ? v : 0.f;
        }
        out[row * ldo + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// out = A @ W^T over the tile (K = depth of A), columns split over warps.
__device__ void dx_layer(const bf16* A, int lda, int K, const bf16* W, int ldw,
                         int N, const bf16* h, int p0, int P, int u, bf16* out,
                         int ldo, float* scratch, int warp, int lane) {
  for (int n0 = warp * 32; n0 < N; n0 += kWarps * 32) {
    AccFrag acc[4][2];
    zero(acc);
    mma_rows_t(acc, A, lda, W, ldw, K, n0);
    store_cot(acc, scratch, h, p0, P, u, out, ldo, n0, lane);
  }
}

// The head cotangents come from d_rgb [P, 16] and d_sigma [P] (quadrature
// mode), or, where g is not null, from g and y (output-head mode), which
// also writes d_rgb_out [P, 16].
__global__ void __launch_bounds__(kWarps * 32)
mlp_backward_kernel(const MlpWeights w, const bf16* __restrict__ d_rgb,
                    const bf16* __restrict__ d_sigma, const bf16* __restrict__ g,
                    const float* __restrict__ y, bf16* __restrict__ d_rgb_out,
                    const MlpStash st, const MlpCotangents ct, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int u = w.units, half = u / 2, n = w.n_layers;
  const int ld_sf = u + kHead + 8, ld_a = u + 8, ld_rf = half + 8, ld_rgb = kHead + 8;
  bf16* sf = reinterpret_cast<bf16*>(smem);  // d_sf tile, later d_pre buffer 1
  bf16* buf0 = sf + kTile * ld_sf;
  bf16* rf = buf0 + kTile * ld_a;
  bf16* rgb = rf + kTile * ld_rf;
  float* scratch_all = reinterpret_cast<float*>(rgb + kTile * ld_rgb);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = scratch_all + warp * 256;
  const int p0 = blockIdx.x * kTile;
  const int rows = min(kTile, P - p0);

  // The head cotangents of the tile (zero past the last point).
  const bool from_output = g != nullptr;
  if (from_output) {
    for (int v = threadIdx.x; v < kTile * kHead; v += blockDim.x) {
      const int r = v / kHead, c = v % kHead;
      float val = 0.f;
      if (r < rows && c < 3) {
        const size_t i = (size_t)(p0 + r) * 4 + c;
        const float yv = y[i];
        val = __fmul_rn(__fmul_rn(__bfloat162float(g[i]), yv), __fsub_rn(1.f, yv));
      }
      rgb[r * ld_rgb + c] = __float2bfloat16_rn(val);
    }
  } else {
    for (int v = threadIdx.x; v < kTile * 2; v += blockDim.x) {
      const int r = v >> 1, c = (v & 1) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) val = *reinterpret_cast<const uint4*>(d_rgb + (size_t)(p0 + r) * kHead + c);
      *reinterpret_cast<uint4*>(rgb + r * ld_rgb + c) = val;
    }
  }
  __syncthreads();
  if (from_output) copy_tile_out(d_rgb_out, p0, rows, kHead, rgb, ld_rgb);

  // d_rf = bf16(d_rgb_pre @ w_rgb^T): w_rgb is [u/2, 128], columns 16.. are
  // padding and never read.
  dx_layer(rgb, ld_rgb, kHead, w.w_rgb, 128, half, nullptr, p0, P, u, rf, ld_rf,
           scratch, warp, lane);
  __syncthreads();
  copy_tile_out(ct.d_rf, p0, rows, half, rf, ld_rf);

  // d_features = bf16(d_rf @ w_rf_top^T) into columns :u of the d_sf tile;
  // d_sigma_pre in column u, zeros after it.
  dx_layer(rf, ld_rf, half, w.w_rf_top, half, u, nullptr, p0, P, u, sf, ld_sf,
           scratch, warp, lane);
  for (int v = threadIdx.x; v < kTile * kHead; v += blockDim.x) {
    const int r = v / kHead, c = v % kHead;
    bf16 val = __float2bfloat16_rn(0.f);
    if (c == 0 && r < rows) {
      const size_t p = (size_t)(p0 + r);
      if (!from_output) val = d_sigma[p];
      else if (y[p * 4 + 3] > 0.f) val = g[p * 4 + 3];
    }
    sf[r * ld_sf + u + c] = val;
  }
  __syncthreads();
  copy_tile_out(ct.d_sf, p0, rows, u + kHead, sf, ld_sf);

  // d_h = d_sf @ w_sf[:, :u + 16]^T, masked by the last trunk activation.
  dx_layer(sf, ld_sf, u + kHead, w.w_sf, u + 128, u, st.h[n - 1], p0, P, u, buf0,
           ld_a, scratch, warp, lane);
  __syncthreads();
  copy_tile_out(ct.d_pre[n - 1], p0, rows, u, buf0, ld_a);

  // The trunk, last layer first: d_pre_{i-1} = bf16((d_pre_i @ W_i^T) [h_{i-1} > 0]).
  bf16* cur = buf0;
  bf16* nxt = sf;  // the d_sf tile is free once d_h was formed
  for (int i = n - 1; i >= 1; --i) {
    dx_layer(cur, ld_a, u, w.trunk_w[i], u, u, st.h[i - 1], p0, P, u, nxt, ld_a,
             scratch, warp, lane);
    __syncthreads();
    copy_tile_out(ct.d_pre[i - 1], p0, rows, u, nxt, ld_a);
    bf16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

size_t smem_bytes(int units) {
  return sizeof(bf16) * (size_t)kTile *
             ((units + kHead + 8) + (units + 8) + (units / 2 + 8) + (kHead + 8)) +
         sizeof(float) * kWarps * 256;
}

int launch(const MlpWeights* w, const bf16* d_rgb, const bf16* d_sigma, const bf16* g,
           const float* y, bf16* d_rgb_out, const MlpStash* st, const MlpCotangents* ct,
           int P, void* stream) {
  if (P <= 0) return 0;
  if (w->n_layers < 1 || w->n_layers > kMaxLayers || w->units % 256 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(w->units);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (P + kTile - 1) / kTile;
  mlp_backward_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      *w, d_rgb, d_sigma, g, y, d_rgb_out, *st, *ct, P);
  return (int)cudaGetLastError();
}

}  // namespace

// w: the packed weights; d_rgb [P, 16], d_sigma [P] bf16 from
// knt_ray_march_quadrature_grad; st: the train mode's kept activations;
// ct: the cotangent arrays to write.
KNT_EXPORT int knt_mlp_backward(const MlpWeights* w, const bf16* d_rgb,
                                const bf16* d_sigma, const MlpStash* st,
                                const MlpCotangents* ct, int P, void* stream) {
  return launch(w, d_rgb, d_sigma, nullptr, nullptr, nullptr, st, ct, P, stream);
}

// The output-head mode: g [P, 4] bf16 output cotangent, y [P, 4] float32
// outputs of the recompute (knt_apply_mlp with a stash); writes d_rgb_out
// [P, 16] besides ct.
KNT_EXPORT int knt_mlp_backward_from_output(const MlpWeights* w, const bf16* g,
                                            const float* y, bf16* d_rgb_out,
                                            const MlpStash* st, const MlpCotangents* ct,
                                            int P, void* stream) {
  if (g == nullptr || y == nullptr || d_rgb_out == nullptr) return (int)cudaErrorInvalidValue;
  return launch(w, nullptr, nullptr, g, y, d_rgb_out, st, ct, P, stream);
}
