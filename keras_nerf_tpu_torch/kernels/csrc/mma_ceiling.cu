// mma_ceiling: a compute-only chain of [T, u] @ [u, u] bf16 products, the
// tensor-core ceiling of the wmma product loop (mlp.cuh) that the port's MLP
// kernels ran before they moved to wgmma.
//
// Replaces: the MXU-ceiling probe scripts/profile_mxu_ceiling.py:87 (kernel
// body :51-66), a measurement that lies on no path of the package. Each grid
// step g makes a [T, u] activation tile from an iota, h[i, :] =
// bf16(i * 1e-4 + seed[g * 8, 0]), then runs rep passes of the L = 8
// resident weights, h = bf16(h @ W_l) ("bare") or bf16(relu(h @ W_l + b_l))
// ("epi", the real kernels' epilogue), float32 accumulation, and writes
// out[g * 8 .. g * 8 + 8, 0..128) = h[:8, :128].
//
// Bound on the H100: operations, 2 T u^2 L rep FLOP per step against a few
// KB moved; 3.3 TFLOP at the probe's defaults, 3.3 ms at 989 TFLOP/s.
//
// Design: that loop as the first forward kernel ran it. Each block holds one
// 64-row tile of a step in shared memory (two bf16 tiles, ping-pong), reads
// the weights (1 MB at u = 256) through L2/L1 as wmma fragments (mlp.cuh's
// mma_rows), each of its 8 warps owning a 64 x 32 output block per layer,
// and applies the epilogue through a per-warp float32 scratch. The first
// tile of each step writes the step's output slice.
#include "mlp.cuh"

using namespace nvcuda;
using namespace knt;

namespace {

constexpr int kTile = 64;
constexpr int kWarps = 8;
constexpr int kLayers = 8;

}  // namespace

// The probe's L resident weights [u, u] bf16 and biases [u] float32;
// mirrored by a ctypes Structure in kernels/ceiling.py.
struct CeilingWeights {
  const bf16* w[kLayers];
  const float* b[kLayers];
};

namespace {

template <bool kEpi>
__global__ void __launch_bounds__(kWarps * 32)
ceiling_kernel(const CeilingWeights cw, const float* __restrict__ seed,
               float* __restrict__ out, int T, int u, int rep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = u + 8;
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + kTile * ld};
  float* scratch = reinterpret_cast<float*>(bufs[1] + kTile * ld) + (threadIdx.x >> 5) * 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = T / kTile, g = blockIdx.x / tiles, row0 = (blockIdx.x % tiles) * kTile;

  const float s = seed[(size_t)g * 8 * 128];
  for (int idx = threadIdx.x; idx < kTile * u; idx += blockDim.x) {
    const int pl = idx / u, c = idx % u;
    bufs[0][pl * ld + c] =
        __float2bfloat16_rn(__fadd_rn(__fmul_rn(static_cast<float>(row0 + pl), 1e-4f), s));
  }
  __syncthreads();

  int cur = 0;
  for (int r = 0; r < rep; ++r) {
    for (int l = 0; l < kLayers; ++l) {
      const bf16* h = bufs[cur];
      bf16* dst = bufs[cur ^ 1];
      for (int n0 = warp * 32; n0 < u; n0 += kWarps * 32) {
        AccFrag acc[4][2];
        zero(acc);
        mma_rows(acc, h, ld, cw.w[l], u, u, n0);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            wmma::store_matrix_sync(scratch, acc[m][f], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
              const int rr = e >> 4, col = n0 + f * 16 + (e & 15);
              float v = scratch[e];
              if (kEpi) v = fmaxf(__fadd_rn(v, cw.b[l][col]), 0.f);
              dst[(m * 16 + rr) * ld + col] = __float2bfloat16_rn(v);
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  if (row0 == 0)
    for (int idx = threadIdx.x; idx < 8 * 128; idx += blockDim.x)
      out[((size_t)g * 8 + idx / 128) * 128 + idx % 128] =
          __bfloat162float(bufs[cur][(idx / 128) * ld + idx % 128]);
}

template <bool kEpi>
int launch(const CeilingWeights* cw, const float* seed, float* out, int steps, int T,
           int u, int rep, cudaStream_t st) {
  const size_t smem = sizeof(bf16) * 2 * kTile * (u + 8) + sizeof(float) * kWarps * 256;
  const cudaError_t err = cudaFuncSetAttribute(
      ceiling_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ceiling_kernel<kEpi><<<steps * (T / kTile), kWarps * 32, smem, st>>>(*cw, seed, out, T,
                                                                       u, rep);
  return (int)cudaGetLastError();
}

}  // namespace

// weights: L = 8 arrays [u, u] bf16 and [u] float32; seed: [steps * 8, 128]
// float32; out: [steps * 8, 128] float32. T a multiple of 64, u of 128 and
// at most 512 (two tiles in shared memory); epi selects the bias + relu epilogue.
KNT_EXPORT int knt_mma_ceiling(const CeilingWeights* cw, const float* seed, float* out,
                               int steps, int T, int u, int rep, int epi, void* stream) {
  if (steps == 0) return 0;
  if (steps < 0 || rep < 0 || T <= 0 || T % kTile || u < 128 || u % 128 || u > 512 ||
      (long long)steps * (T / kTile) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (epi) return launch<true>(cw, seed, out, steps, T, u, rep, st);
  return launch<false>(cw, seed, out, steps, T, u, rep, st);
}
