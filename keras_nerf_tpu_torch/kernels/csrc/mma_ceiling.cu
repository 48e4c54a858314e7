// mma_ceiling: a compute-only chain of [T, u] @ [u, u] bf16 products, the
// ceiling of the wgmma product loop (gmma.cuh) that the port's MLP kernels
// run: ray_march_mlp.cu's trunk without the encoding, the heads or a stash.
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
// KB moved; 3.3 TFLOP at the probe's defaults, 3.3 ms at 989 TFLOP/s. The
// weights come from L2: blocks x rep x L x u^2 x 2 bytes, 25.8 GB at the
// defaults, which profile_mma_ceiling sets beside the time.
//
// Design: the loop of ray_march_mlp.cu's trunk (its header), every product
// A[rows, K] . W[K, N] on wgmma with both operands in shared memory, the
// activation tile as a K-major A and W, row-major [K, N], as an MN-major B.
// * A block owns a tile of rows of one step: 128 at u = 128, 256 and 384,
//   where each of the two consumer warpgroups takes 64 rows and every
//   column; 64 at u = 512, where both take the 64 rows and each half of the
//   columns. A warpgroup holds at most 64 x 256 float32 accumulators
//   (m64n256k16, 128 registers a thread, of the 232 that setmaxnreg gives
//   the consumers from the producer warpgroup). u = 128 and 384, which no
//   MLP kernel takes, run m64n128k16: at 384 in three column passes of 128,
//   the finished passes held as packed bf16 in registers until the last
//   one writes the tile, as ray_march_mlp.cu's wide_pass does at 768.
//   Where T is an odd multiple of 64, the last tile's second half carries
//   the iota on past T through the same products (no branch around a
//   wgmma, which ptxas would serialize); none of its rows is written.
// * The activation tile (tile x u bf16, 64-column boxes in the 128-byte
//   swizzled K-major layout) is built by the consumers straight from the
//   iota, each 16-byte chunk at its swizzled place: nothing is read but the
//   seed. Once every product that reads a row has retired (wgmma wait 0,
//   then a named barrier: of the warpgroup alone where it owns its rows, of
//   both at u = 512), the epilogue converts (or adds the float32 bias,
//   applies relu and converts) in registers and writes over the rows, which
//   pass to wgmma behind fence.proxy.async and a second barrier.
// * Weights stream through a ring of 3 stages of [64 K x 256 N] (four 64 x
//   64 TMA boxes; two at u = 128 and in each pass at 384), full/empty
//   mbarriers, one producer thread, in the order the layers use them; at u
//   = 512 each K slab is two stages of 256 columns, of which each
//   warpgroup multiplies its own and releases the other at once. Consumers
//   release a stage once the product group after it has been issued. The
//   weights are the same for every block and stay resident in L2.
// * Shared memory: activation 32 / 64 / 96 / 64 KB (u = 128 / 256 / 384 /
//   512) + ring 96 KB + 1 KB of alignment, one block per SM.
// * No atomics and a fixed k order: two runs give identical bits. A ring
//   fault traps (gmma::mbar_wait) instead of holding the card.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "gmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLayers = 8;
constexpr int kStages = 3;
constexpr int kBox = 64 * 128;          // one TMA box: 64 K rows x 64 N columns, bf16
constexpr int kStageBytes = 4 * kBox;   // [64 K x 256 N]
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = 128 + kConsumers;
constexpr int kFullBar = 1;             // named barrier of the consumers

// Rows a block: 64 at u = 512, where the warpgroups split the columns; 128
// elsewhere, where they split the rows.
__host__ __device__ constexpr int tile_of(int units) { return units == 512 ? 64 : 128; }
// Columns of one product of a warpgroup (its wgmma N) and the passes of a
// layer: u = 384 takes three passes of 128.
__host__ __device__ constexpr int width_of(int units) { return units == 128 || units == 384 ? 128 : 256; }
__host__ __device__ constexpr int passes_of(int units) { return units == 384 ? 3 : 1; }
// Stages of 256 columns per K slab: two at u = 512, one elsewhere.
__host__ __device__ constexpr int parts_of(int units) { return units == 512 ? 2 : 1; }

}  // namespace

// The probe's L resident weights [u, u] bf16 and biases [u] float32;
// mirrored by a ctypes Structure in kernels/ceiling.py.
struct CeilingWeights {
  const bf16* w[kLayers];
  const float* b[kLayers];
};

namespace {

struct CeilingParams {
  CUtensorMap w[kLayers];
  const float* b[kLayers];
  const float* seed;
  float* out;
  int rep, tiles;  // tiles: blocks a grid step
};

struct Smem {
  uint8_t* act;
  uint8_t* ring;
  uint64_t* full;   // kStages
  uint64_t* empty;  // kStages
};

// Byte offset of element (r, c) of a [tile x cols] bf16 tile in 64-column
// boxes with the 128-byte swizzle (ray_march_mlp.cu: swz).
template <int kTile>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (kTile * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// The producer thread: every stage of every product, in the consumers'
// order.
template <int kUnits>
__device__ void produce(const CeilingParams& prm, const Smem& sm) {
  constexpr int kBoxes = width_of(kUnits) / 64;
  for (int l = 0; l < kLayers; ++l) gmma::prefetch_tensormap(&prm.w[l]);
  int g = 0;
  for (int r = 0; r < prm.rep; ++r) {
    for (int l = 0; l < kLayers; ++l) {
      for (int pass = 0; pass < passes_of(kUnits); ++pass) {
        for (int ks = 0; ks < kUnits / 64; ++ks) {
          for (int part = 0; part < parts_of(kUnits); ++part, ++g) {
            const int n0 = 256 * part + 128 * pass;
            const int s = g % kStages;
            gmma::mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
            gmma::mbar_arrive_expect_tx(&sm.full[s], kBoxes * kBox);
            for (int b = 0; b < kBoxes; ++b)
              gmma::tma_load_2d(sm.ring + s * kStageBytes + b * kBox, &prm.w[l], &sm.full[s],
                                n0 + 64 * b, 64 * ks);
          }
        }
      }
    }
  }
}

// One pass of a layer for consumer warpgroup wg: the products of every
// stage it owns into float32 accumulators, then the epilogue. A pass
// before the last keeps its bf16 results in `hold`; the last writes every
// pass's columns over the tile once the products that read it have
// retired.
template <int kUnits, bool kEpi, int kPass>
__device__ __forceinline__ void run_pass(const Smem& sm, const float* __restrict__ bias, int& g,
                                         uint32_t (&hold)[2][32]) {
  constexpr int kTile = tile_of(kUnits), NW = width_of(kUnits);
  constexpr bool kSplitCols = kTile == 64;
  constexpr bool kLast = kPass + 1 == passes_of(kUnits);
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, t = ct % 128, warp = t / 32, lane = t % 32;
  const int a_row = kSplitCols ? 0 : 64 * wg;
  const int col0 = kSplitCols ? 256 * wg : 128 * kPass;
  const int bar = kSplitCols ? kFullBar : 2 + wg;
  const int bar_threads = kSplitCols ? kConsumers : 128;

  float acc[NW / 2];
  int scale = 0;     // the pass's first product overwrites the accumulators
  int pending = -1;  // the stage of the last committed group
  for (int ks = 0; ks < kUnits / 64; ++ks) {
    for (int part = 0; part < parts_of(kUnits); ++part, ++g) {
      const int s = g % kStages;
      gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
      if (kSplitCols && part != wg) {
        if (lane == 0) gmma::mbar_arrive(&sm.empty[s]);
        continue;
      }
      const uint64_t da = gmma::desc_sw128_kmajor(sm.act + ks * kTile * 128 + a_row * 128);
      const uint64_t db = gmma::desc_sw128(sm.ring + s * kStageBytes, kBox, 1024);
      gmma::fence_operands(acc);
      gmma::fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gmma::mma_m64k16<NW, 0, 1>(acc, da + 2 * k, db + (k * 2048 >> 4), scale);
        scale = 1;
      }
      gmma::commit();
      gmma::fence_operands(acc);
      gmma::wait<1>();
      gmma::fence_operands(acc);
      if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);
      pending = s;
    }
  }
  gmma::wait<0>();
  gmma::fence_operands(acc);
  if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);

  const int r0 = a_row + 16 * warp + lane / 4;
  if constexpr (kLast) {
    // Every product that reads these rows has retired: overwrite them, the
    // earlier passes' columns first.
    gmma::bar_sync(bar, bar_threads);
#pragma unroll
    for (int q = 0; q < kPass; ++q)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              sm.act + swz<kTile>(r0 + 8 * h, 128 * q + 8 * j + 2 * (lane % 4))) =
              hold[q][2 * j + h];
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);
    float b0 = 0.f, b1 = 0.f;
    if (kEpi) b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (kEpi) {
        v0 = fmaxf(__fadd_rn(v0, b0), 0.f);
        v1 = fmaxf(__fadd_rn(v1, b1), 0.f);
      }
      const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
      if constexpr (kLast)
        *reinterpret_cast<__nv_bfloat162*>(sm.act + swz<kTile>(r0 + 8 * h, c)) = o;
      else
        hold[kPass][2 * j + h] = *reinterpret_cast<const uint32_t*>(&o);
    }
  }
  if constexpr (kLast) {
    gmma::fence_proxy_async();
    gmma::bar_sync(bar, bar_threads);
  }
}

template <int kUnits, bool kEpi>
__global__ void __launch_bounds__(kThreads, 1)
ceiling_kernel(const __grid_constant__ CeilingParams prm) {
  constexpr int kTile = tile_of(kUnits);
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.act = base;
  sm.ring = sm.act + 2 * kTile * kUnits;
  sm.full = reinterpret_cast<uint64_t*>(sm.ring + kStages * kStageBytes);
  sm.empty = sm.full + kStages;

  const int step = blockIdx.x / prm.tiles;
  const int row0 = (blockIdx.x % prm.tiles) * kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    gmma::fence_barrier_init();
  }
  __syncthreads();

  // The producer warpgroup gives its registers to the consumers: 128 x 40 +
  // 256 x 232 = 384 x 168, the budget of one block of 384 threads.
  if (threadIdx.x < 128) {
    gmma::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce<kUnits>(prm, sm);
    return;
  }
  gmma::setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128, wg = ct / 128;

  // The tile from the iota: row i of the step holds bf16(i * 1e-4 + seed)
  // in every column, 8 columns (one 16-byte chunk) per thread and step.
  const float sd = prm.seed[(size_t)step * 8 * 128];
  for (int v = ct; v < kTile * (kUnits / 8); v += kConsumers) {
    const int r = v / (kUnits / 8), c = (v % (kUnits / 8)) * 8;
    const bf16 x = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(static_cast<float>(row0 + r), 1e-4f), sd));
    const __nv_bfloat162 x2 = __halves2bfloat162(x, x);
    const uint32_t q = *reinterpret_cast<const uint32_t*>(&x2);
    *reinterpret_cast<uint4*>(sm.act + swz<kTile>(r, c)) = make_uint4(q, q, q, q);
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);

  uint32_t hold[2][32];
  int g = 0;
  for (int r = 0; r < prm.rep; ++r) {
    for (int l = 0; l < kLayers; ++l) {
      const float* bias = prm.b[l];
      run_pass<kUnits, kEpi, 0>(sm, bias, g, hold);
      if constexpr (passes_of(kUnits) == 3) {
        run_pass<kUnits, kEpi, 1>(sm, bias, g, hold);
        run_pass<kUnits, kEpi, 2>(sm, bias, g, hold);
      }
    }
  }
  // Rows 0..7 of the step, finished by warpgroup 0 behind its last barrier
  // (of both warpgroups at u = 512).
  if (row0 == 0 && wg == 0)
    for (int i = ct; i < 8 * 128; i += 128)
      prm.out[((size_t)step * 8 + i / 128) * 128 + i % 128] =
          __bfloat162float(*reinterpret_cast<const bf16*>(sm.act + swz<kTile>(i / 128, i % 128)));
}

// Dynamic shared memory: activation tile, ring, 2 kStages mbarriers and the
// 1024-byte alignment.
constexpr int smem_bytes(int units) {
  return 1024 + 2 * tile_of(units) * units + kStages * kStageBytes + 8 * 2 * kStages;
}
static_assert(smem_bytes(384) <= 232448 && smem_bytes(512) <= 232448,
              "mma_ceiling exceeds the H100's 227 KB of shared memory");

template <int kUnits, bool kEpi>
int launch_width(const CeilingParams& prm, int steps, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(ceiling_kernel<kUnits, kEpi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes(kUnits));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ceiling_kernel<kUnits, kEpi>
      <<<steps * prm.tiles, kThreads, smem_bytes(kUnits), stream>>>(prm);
  return (int)cudaGetLastError();
}

template <bool kEpi>
int launch_mode(const CeilingParams& prm, int u, int steps, cudaStream_t stream) {
  switch (u) {
    case 128: return launch_width<128, kEpi>(prm, steps, stream);
    case 256: return launch_width<256, kEpi>(prm, steps, stream);
    case 384: return launch_width<384, kEpi>(prm, steps, stream);
    default: return launch_width<512, kEpi>(prm, steps, stream);
  }
}

}  // namespace

// weights: L = 8 arrays [u, u] bf16 and [u] float32; seed: [steps * 8, 128]
// float32; out: [steps * 8, 128] float32. T a positive multiple of 64, u a
// multiple of 128 in [128, 512]; epi selects the bias + relu epilogue.
// Returns 0, a cudaError_t, or -CUresult when a tensor map cannot be encoded.
KNT_EXPORT int knt_mma_ceiling(const CeilingWeights* cw, const float* seed, float* out,
                               int steps, int T, int u, int rep, int epi, void* stream) {
  if (steps == 0) return 0;
  if (steps < 0 || rep < 0 || T <= 0 || T % 64 || u < 128 || u % 128 || u > 512)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile_of(u) - 1) / tile_of(u);
  if ((long long)steps * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CeilingParams prm{};  // copied into the launch's parameters
  for (int l = 0; l < kLayers; ++l) {
    const int err = gmma::encode_map(fn, &prm.w[l], cw->w[l], u, u, 64);
    if (err) return -err;
    prm.b[l] = cw->b[l];
  }
  prm.seed = seed;
  prm.out = out;
  prm.rep = rep;
  prm.tiles = tiles;
  const cudaStream_t st = (cudaStream_t)stream;
  return epi ? launch_mode<true>(prm, u, steps, st) : launch_mode<false>(prm, u, steps, st);
}
