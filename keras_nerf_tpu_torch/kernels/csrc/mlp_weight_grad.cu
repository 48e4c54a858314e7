// mlp_weight_grad: the weight and bias gradients of every packed array,
// summed over a chunk's points.
//
// Replaces: the dW / rowsum half of _backward_core
// (keras_nerf_tpu/kernels/ray_march.py:804-872) and _acc_out (:500), which
// the TPU kernel sums over a grid that runs in order. For each task
// (A [P, K], G [P, N], out [K, ldo], bias_out [ldo] or null):
//   out[:K, :N] += A^T G        bias_out[:N] += sum_p G[p, :]
// with bf16 operands and float32 sums. The tasks are the trunk layers
// (A = the encoding or the previous activation, G = d_pre_i; the encoding
// again for a post-skip layer's encoding rows), the sigma/feature head
// (A = h_{L-1} or the encoding, G = d_sf), the rgb-feature layer (A =
// features or the encoding, G = d_rf) and the rgb head (A = rf, G = d_rgb).
//
// Bound on the H100: bytes. Per point at 8 x 256 the operands are about
// 10 KB of bf16 (the stash and the cotangents, read once: 3.0 ns at
// 3.35 TB/s) against 1.19 MFLOP of products (1.2 ns at 989 TFLOP/s). Above
// the operands come the float32 partial sums of the point slices, written
// once and read once by the reduction.
//
// Design: every operand is read from device memory once and the products
// run on wgmma, fed by a ring of TMA loads.
// * A block owns 128 rows of one task's K (two consumer warpgroups of 64
//   rows, wgmma m64nNk16, N = 256, 128 or 64, float32 accumulators in
//   registers) and one N tile, over one slice of the points. N splits into
//   256-wide tiles, then one tile of 128 or 64; a 16-wide tail (d_sf's
//   column u and padding, d_rgb) takes a 64 tile whose columns past N are
//   TMA's zeros, which costs products but no bytes. The plan of tiles and
//   slices is made in Python (kernels/ray_march.py: weight_grad_plan).
// * Neither operand is transposed in memory. A stage is [64 points x 128
//   features] of A and [64 points x N] of G, both row-major slices of the
//   [P, width] arrays as they lie: A^T and G with their M / N dimension
//   contiguous, the MN-major operands that wgmma reads with its transpose
//   flags. TMA loads them in 64 x 64 boxes with the 128-byte swizzle, the
//   layout wgmma's descriptors name (gmma.cuh).
// * One producer thread keeps a ring of 4 stages (48 KB each, dynamic
//   shared memory) loading: full and empty mbarriers pace it. The consumers
//   wait on "full", start four k16 products per stage, commit, and release
//   the stage before once its group has retired, so one group of products
//   and up to three stages of loads are in flight behind the one in use.
// * Bias sums: in blocks whose rows start at 0, the first consumer
//   warpgroup adds G's columns in float32 from the stage in shared memory,
//   in point order, while its products run; G is read from device memory
//   once for both.
// * The sum over points is a reduction across blocks: each block stores
//   its slice's float32 partial, and a second kernel adds the slices in
//   slice order into the accumulators. No atomics: two runs give the same
//   bits. Slices start at multiples of 64 points and only the last ends at
//   P, whose ragged stage TMA fills with zeros.
// * Blocks of one slice are adjacent in launch order, the two row tiles of
//   one N tile side by side, so blocks that read the same rows of an
//   operand run together and share them in L2.
// * A launch takes at most kMaxTasks tasks and kMaxTiles tiles. A call with
//   more (a deep or wide model) is split by weight_grad_plan into launches
//   of consecutive tiles, each block's work and each task's partial offsets
//   as one launch would have them; a task's slices are added (its `reduce`
//   flag) by the launch that holds its last tile, after every launch that
//   wrote them, in the same order: the split changes no bit.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "gmma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kMaxTasks = 40;
constexpr int kMaxMaps = 2 * kMaxTasks;  // one tensor map per operand array
constexpr int kMaxTiles = 256;
constexpr int kStep = 64;                 // points per stage
constexpr int kTileK = 128;               // output rows per block
constexpr int kStages = 4;
constexpr int kBox = 64 * 64 * 2;         // one TMA box: 64 points x 64 cols
constexpr int kStageBytes = 2 * kBox + 4 * kBox;  // A 16 KB + G <= 32 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 128 + 32 * kConsumerWarps;

}  // namespace

// One weight array; mirrored in kernels/ray_march.py (_WgTask). poff and
// bpoff index the float32 partial-sum buffer: slices x [K, N], then
// slices x [N] for the bias. reduce: this launch adds the slices into out
// (and bias_out), 0 where a later launch of the call holds the task's last
// tiles.
struct WgTask {
  const bf16* a;
  const bf16* g;
  float* out;
  float* bias_out;
  int k, n, ldo, poff, bpoff, reduce;
};

// One block's output, per slice: rows m0 .. m0 + 127 and columns n0 ..
// n0 + nt - 1 (those below N) of task `task`; mirrored in
// kernels/ray_march.py (_WgTile).
struct WgTile {
  int task, m0, n0, nt;
};

namespace {

struct WgParams {
  CUtensorMap map[kMaxMaps];
  int a_map[kMaxTasks], g_map[kMaxTasks];
  int k[kMaxTasks], n[kMaxTasks], poff[kMaxTasks], bpoff[kMaxTasks];
  int bias[kMaxTasks];
  WgTile tile[kMaxTiles];
  int n_tiles, P, chunk;
};

struct WgReduceTable {
  WgTask t[kMaxTasks];
};

// The consumers of one block: warpgroup c (0 or 1) accumulates rows
// m0 + 64 c .. + 63 over the block's stages, then stores its partial.
template <int NT>
__device__ __forceinline__ void consume(const WgParams& prm, const WgTile& tl,
                                        uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int steps, int slice,
                                        float* __restrict__ partial) {
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int ti = tl.task;
  const int n = prm.n[ti];

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  // Bias columns 2t, 2t + 1 of the tile: 16-byte chunk `chunk` of a box
  // row, swizzled by the row.
  const bool bias = prm.bias[ti] && tl.m0 == 0 && c == 0 && 2 * t < NT;
  const int bcol = 2 * t;
  const int bbox = bcol / 64;
  const int bchunk = (bcol % 64) / 8, bin = (bcol % 8) * 2;
  float b0 = 0.f, b1 = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    gmma::mbar_wait(&full[s], (i / kStages) & 1);
    uint8_t* st = smem + s * kStageBytes;
    const uint64_t da = gmma::desc_sw128(st + c * kBox, kBox, 1024);
    const uint64_t db = gmma::desc_sw128(st + 2 * kBox, kBox, 1024);
    gmma::fence_operands(acc);
    gmma::fence();
#pragma unroll
    for (int k = 0; k < kStep / 16; ++k)
      gmma::mma_m64k16<NT, 1, 1>(acc, da + (k * 2048 >> 4),
                                 db + (k * 2048 >> 4));
    gmma::commit();
    gmma::fence_operands(acc);
    if (bias) {
      const uint8_t* box = st + (2 + bbox) * kBox;
#pragma unroll 8
      for (int r = 0; r < kStep; ++r) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            box + r * 128 + ((bchunk ^ (r & 7)) << 4) + bin);
        b0 += __low2float(v);
        b1 += __high2float(v);
      }
    }
    __syncwarp();
    gmma::wait<1>();
    gmma::fence_operands(acc);
    if (i > 0 && lane == 0) gmma::mbar_arrive(&empty[(i - 1) % kStages]);
  }
  gmma::wait<0>();
  gmma::fence_operands(acc);

  float* dst = partial + prm.poff[ti] + (size_t)slice * prm.k[ti] * n;
  const int row = tl.m0 + 64 * c + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = tl.n0 + 8 * j + 2 * (lane % 4);
    if (col < n) {
      *reinterpret_cast<float2*>(dst + (size_t)row * n + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * n + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (bias && tl.n0 + bcol < n)
    *reinterpret_cast<float2*>(partial + prm.bpoff[ti] + (size_t)slice * n +
                               tl.n0 + bcol) = make_float2(b0, b1);
}

__global__ void __launch_bounds__(kThreads, 1)
wg_gemm_kernel(const __grid_constant__ WgParams prm,
               float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  uint8_t* smem =
      smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);

  const int tile_i = blockIdx.x % prm.n_tiles;
  const int slice = blockIdx.x / prm.n_tiles;
  const WgTile tl = prm.tile[tile_i];
  const int p_begin = slice * prm.chunk;
  const int p_end = min(prm.P, p_begin + prm.chunk);
  const int steps = (p_end - p_begin + kStep - 1) / kStep;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gmma::mbar_init(&full[s], 1);
      gmma::mbar_init(&empty[s], kConsumerWarps);
    }
    gmma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring loading.
    if (threadIdx.x != 0) return;
    const CUtensorMap* ma = &prm.map[prm.a_map[tl.task]];
    const CUtensorMap* mg = &prm.map[prm.g_map[tl.task]];
    gmma::prefetch_tensormap(ma);
    gmma::prefetch_tensormap(mg);
    const int g_boxes = tl.nt / 64;
    const uint32_t tx = (2 + g_boxes) * kBox;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      gmma::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      gmma::mbar_arrive_expect_tx(&full[s], tx);
      uint8_t* st = smem + s * kStageBytes;
      const int p = p_begin + i * kStep;
      gmma::tma_load_2d(st, ma, &full[s], tl.m0, p);
      gmma::tma_load_2d(st + kBox, ma, &full[s], tl.m0 + 64, p);
      for (int b = 0; b < g_boxes; ++b)
        gmma::tma_load_2d(st + (2 + b) * kBox, mg, &full[s], tl.n0 + 64 * b,
                          p);
    }
    return;
  }
  if (tl.nt == 256)
    consume<256>(prm, tl, smem, full, empty, steps, slice, partial);
  else if (tl.nt == 128)
    consume<128>(prm, tl, smem, full, empty, steps, slice, partial);
  else
    consume<64>(prm, tl, smem, full, empty, steps, slice, partial);
}

// Adds the slices' partial sums, in slice order, into the accumulators.
__global__ void wg_reduce_kernel(const WgReduceTable tab,
                                 const float* __restrict__ partial,
                                 int slices) {
  const WgTask t = tab.t[blockIdx.y];
  if (!t.reduce) return;
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

// The operand arrays seen so far, one tensor map each.
struct MapSet {
  const bf16* base[kMaxMaps];
  int cols[kMaxMaps];
  int n = 0, err = 0;

  // The index of the map of (base, cols), encoded on first sight; -1 when
  // the set is full.
  int of(gmma::EncodeTiled fn, WgParams& prm, const bf16* b, int c,
         int rows) {
    for (int i = 0; i < n; ++i)
      if (base[i] == b && cols[i] == c) return i;
    if (n == kMaxMaps) return -1;
    base[n] = b;
    cols[n] = c;
    const int e = gmma::encode_map(fn, &prm.map[n], b, c, rows, 64);
    if (e != 0) err = e;
    return n++;
  }
};

}  // namespace

// tasks: n_tasks weight arrays (A [P, K] and G [P, N] row-major bf16, K a
// multiple of 128, N of 16); tiles: the blocks of one slice
// (weight_grad_plan); slices of `chunk` points (a multiple of 64) from 0;
// partial: the float32 buffer the task offsets index. Returns 0, a
// cudaError_t, or -CUresult when a tensor map cannot be encoded.
KNT_EXPORT int knt_mlp_weight_grad(const WgTask* tasks, int n_tasks,
                                   const WgTile* tiles, int n_tiles, int P,
                                   int slices, int chunk, float* partial,
                                   void* stream) {
  if (P <= 0 || n_tasks <= 0) return 0;
  if (n_tasks > kMaxTasks || n_tiles < 1 || n_tiles > kMaxTiles ||
      slices < 1 || chunk % kStep || (long long)chunk * slices < P ||
      (long long)chunk * (slices - 1) >= P)
    return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;

  WgParams prm;  // copied into the launch's parameters
  WgReduceTable red = {};
  MapSet maps;
  for (int i = 0; i < n_tasks; ++i) {
    const WgTask& t = tasks[i];
    if (t.k % kTileK || t.n % 16 || t.n > t.ldo)
      return (int)cudaErrorInvalidValue;
    red.t[i] = t;
    prm.k[i] = t.k;
    prm.n[i] = t.n;
    prm.poff[i] = t.poff;
    prm.bpoff[i] = t.bpoff;
    prm.bias[i] = t.bias_out != nullptr;
    const int am = maps.of(fn, prm, t.a, t.k, P);
    const int gm = maps.of(fn, prm, t.g, t.n, P);
    if (am < 0 || gm < 0) return (int)cudaErrorInvalidValue;
    prm.a_map[i] = am;
    prm.g_map[i] = gm;
  }
  if (maps.err != 0) return -maps.err;
  for (int i = 0; i < n_tiles; ++i) {
    const WgTile& tl = tiles[i];
    if (tl.task < 0 || tl.task >= n_tasks || tl.m0 % kTileK ||
        tl.m0 + kTileK > tasks[tl.task].k || tl.n0 % 64 || tl.n0 < 0 ||
        tl.n0 >= tasks[tl.task].n ||
        (tl.nt != 64 && tl.nt != 128 && tl.nt != 256))
      return (int)cudaErrorInvalidValue;
    prm.tile[i] = tl;
  }
  prm.n_tiles = n_tiles;
  prm.P = P;
  prm.chunk = chunk;

  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wg_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  wg_gemm_kernel<<<n_tiles * slices, kThreads, kSmemBytes, st>>>(prm, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wg_reduce_kernel<<<dim3(64, n_tasks), 256, 0, st>>>(red, partial, slices);
  return (int)cudaGetLastError();
}
