// mlp_weight_grad: the weight and bias gradients of every packed array,
// summed over a chunk's points.
//
// Replaces: the dW / rowsum half of _backward_core
// (keras_nerf_tpu/kernels/ray_march.py:822-872) and _acc_out (:500), which
// the TPU kernel sums over a grid that runs in order. For each task
// (A [P, K], G [P, N], out [K, ldo], bias_out [ldo] or null):
//   out[:K, :N] += A^T G        bias_out[:N] += sum_p G[p, :]
// with bf16 operands and float32 sums. The tasks are the trunk layers
// (A = the encoding or the previous activation, G = d_pre_i; the encoding
// again for a post-skip layer's encoding rows), the sigma/feature head
// (A = h_{L-1} or the encoding, G = d_sf), the rgb-feature layer (A =
// features or the encoding, G = d_rf) and the rgb head (A = rf, G = d_rgb).
//
// Bound on the H100: bytes, as this kernel's inputs stand. Per point at
// 8 x 256 it reads 10 KB of bf16 operands (3.0 ns at 3.35 TB/s) against
// 1,186,816 FLOP (1.2 ns at 989 TFLOP/s); the sums are written once per
// chunk. The whole of T3 is bound by operations (see mlp_backward.cu).
//
// Design: on the H100 blocks run in parallel with no order, so the sum over
// points is a reduction across blocks. Each block owns a 64 x 64 output
// tile of one task and one of `slices` fixed ranges of the point axis; four
// warps run wmma 16x16x16 bf16 products (A^T as column-major fragments of
// the A tile) over 32-point steps staged in shared memory, and the warps of
// the first tile row also multiply a fragment of ones by G for the bias
// sums. Each block stores its float32 partial; a second kernel adds the
// slices in a fixed order into the accumulators. No atomics: two runs give
// the same bits. The blocks of one slice and task are adjacent, so the
// tiles that read the same rows of A and G run together and share them in
// L2.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kMaxTasks = 40;
constexpr int kBM = 64, kBN = 64, kBP = 32;  // output tile, point step
constexpr int kLd = kBM + 8;                 // shared tile row stride

}  // namespace

// One weight array; mirrored in kernels/ray_march.py (_WgTask). poff and
// bpoff index the float32 partial-sum buffer: slices x [K, N], then
// slices x [N] for the bias.
struct WgTask {
  const bf16* a;
  const bf16* g;
  float* out;
  float* bias_out;
  int k, n, ldo, poff, bpoff;
};

namespace {

struct WgTable {
  WgTask t[kMaxTasks];
  int block0[kMaxTasks + 1];  // first block of each task
  int n_tasks, P, chunk;
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using ATFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using OnesFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using GFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

__global__ void __launch_bounds__(128)
wg_gemm_kernel(const WgTable tab, float* __restrict__ partial) {
  __shared__ __align__(128) bf16 As[kBP * kLd];
  __shared__ __align__(128) bf16 Gs[kBP * kLd];
  __shared__ __align__(128) float scratch[4][256];

  const int b = blockIdx.x;
  int ti = 0;
  while (ti + 1 < tab.n_tasks && b >= tab.block0[ti + 1]) ++ti;
  const WgTask t = tab.t[ti];
  const int tiles_n = (t.n + kBN - 1) / kBN;
  const int tiles = ((t.k + kBM - 1) / kBM) * tiles_n;
  const int local = b - tab.block0[ti];
  const int slice = local / tiles, tile = local % tiles;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int p_begin = slice * tab.chunk;
  const int p_end = min(tab.P, p_begin + tab.chunk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bool bias = t.bias_out != nullptr && m0 == 0 && wm == 0;
  bool live_m[2], live_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live_m[i] = m0 + wm + i * 16 < t.k;
    live_n[i] = n0 + wn + i * 16 < t.n;
  }

  AccFrag acc[2][2], acc_b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::fill_fragment(acc_b[i], 0.f);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  OnesFrag ones;
  wmma::fill_fragment(ones, __float2bfloat16_rn(1.f));
  ATFrag a[2];
  GFrag g[2];

  for (int p0 = p_begin; p0 < p_end; p0 += kBP) {
    // Stage the step's [32, 64] tiles of A and G (zero past the edges).
    for (int v = threadIdx.x; v < kBP * kBM / 8; v += blockDim.x) {
      const int r = v / (kBM / 8), c = (v % (kBM / 8)) * 8, p = p0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vg = va;
      if (p < p_end) {
        if (m0 + c < t.k)
          va = *reinterpret_cast<const uint4*>(t.a + (size_t)p * t.k + m0 + c);
        if (n0 + c < t.n)
          vg = *reinterpret_cast<const uint4*>(t.g + (size_t)p * t.n + n0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * kLd + c) = va;
      *reinterpret_cast<uint4*>(Gs + r * kLd + c) = vg;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBP; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (live_m[i]) wmma::load_matrix_sync(a[i], As + kk * kLd + wm + i * 16, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!live_n[j]) continue;
        wmma::load_matrix_sync(g[j], Gs + kk * kLd + wn + j * 16, kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (live_m[i]) wmma::mma_sync(acc[i][j], a[i], g[j], acc[i][j]);
        if (bias) wmma::mma_sync(acc_b[j], ones, g[j], acc_b[j]);
      }
    }
    __syncthreads();
  }

  float* dst = partial + t.poff + (size_t)slice * t.k * t.n;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (live_m[i] && live_n[j])
        wmma::store_matrix_sync(dst + (size_t)(m0 + wm + i * 16) * t.n + n0 + wn + j * 16,
                                acc[i][j], t.n, wmma::mem_row_major);
  if (bias) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!live_n[j]) continue;
      // Every row of ones @ G is the column sum; keep row 0.
      wmma::store_matrix_sync(scratch[warp], acc_b[j], 16, wmma::mem_row_major);
      __syncwarp();
      if (lane < 16)
        partial[t.bpoff + (size_t)slice * t.n + n0 + wn + j * 16 + lane] = scratch[warp][lane];
      __syncwarp();
    }
  }
}

// Adds the slices' partial sums, in slice order, into the accumulators.
__global__ void wg_reduce_kernel(const WgTable tab, const float* __restrict__ partial,
                                 int slices) {
  const WgTask t = tab.t[blockIdx.y];
  const int kn = t.k * t.n;
  const int total = kn + (t.bias_out != nullptr ? t.n : 0);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < kn) {
      for (int sl = 0; sl < slices; ++sl) s += partial[t.poff + (size_t)sl * kn + e];
      t.out[(size_t)(e / t.n) * t.ldo + e % t.n] += s;
    } else {
      const int c = e - kn;
      for (int sl = 0; sl < slices; ++sl) s += partial[t.bpoff + (size_t)sl * t.n + c];
      t.bias_out[c] += s;
    }
  }
}

}  // namespace

// tasks: n_tasks weight arrays (K, N multiples of 16, A [P, K] and G [P, N]
// row-major bf16); partial: the float32 buffer the offsets index.
KNT_EXPORT int knt_mlp_weight_grad(const WgTask* tasks, int n_tasks, int P,
                                   int slices, float* partial, void* stream) {
  if (P <= 0 || n_tasks <= 0) return 0;
  if (n_tasks > kMaxTasks || slices < 1) return (int)cudaErrorInvalidValue;
  WgTable tab = {};
  tab.n_tasks = n_tasks;
  tab.P = P;
  const int per_slice = (P + slices - 1) / slices;
  tab.chunk = (per_slice + kBP - 1) / kBP * kBP;
  int blocks = 0;
  for (int i = 0; i < n_tasks; ++i) {
    const WgTask& t = tasks[i];
    if (t.k % 16 || t.n % 16 || t.n > t.ldo) return (int)cudaErrorInvalidValue;
    tab.t[i] = t;
    tab.block0[i] = blocks;
    blocks += ((t.k + kBM - 1) / kBM) * ((t.n + kBN - 1) / kBN) * slices;
  }
  tab.block0[n_tasks] = blocks;
  const cudaStream_t st = (cudaStream_t)stream;
  wg_gemm_kernel<<<blocks, 128, 0, st>>>(tab, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wg_reduce_kernel<<<dim3(64, n_tasks), 256, 0, st>>>(tab, partial, slices);
  return (int)cudaGetLastError();
}
