// mlp_backward: the dX chain of the MLP's backward, per tile of points.
//
// Replaces: the cotangent half of _backward_core
// (keras_nerf_tpu/kernels/ray_march.py:804-872) in the TPU's
// fused_train_chunk(with_grad=True): from the head cotangents that
// ray_march_quadrature's with_grad mode writes (d_rgb_pre in columns 0..2
// of a [P, 16] bf16 array, d_sigma_pre [P] bf16) it walks the heads and
// then the trunk in reverse:
//   d_rf       = bf16(d_rgb_pre @ w_rgb[:, :16]^T)
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
// Bound on the H100: bytes. Per point at 8 x 256 it reads 34 B of head
// cotangents and 4 KB of kept trunk activations and writes 4.9 KB of
// cotangents (2.7 ns at 3.35 TB/s) against 1,115,392 FLOP (1.1 ns at 989
// TFLOP/s). The whole of T3 is bound by operations (3.49 MFLOP per point);
// the stash and the cotangents in device memory are the price of splitting
// it over kernels (PERF.md).
//
// Design: every product is A[points, K] . W^T, with the cotangent tile A
// and the weight W ([N = fan_in, K = fan_out] row-major, as packed) both
// K-major: the plain "TN" case of wgmma (transpose flags 0), with nothing
// transposed anywhere.
// * A block owns a tile of points: 128 at u = 256, where each of the two
//   consumer warpgroups takes 64 rows and every column; 64 at u = 512 and
//   768, where both take the 64 rows and each half of the columns. Either
//   way a warpgroup holds at most 64 x 256 float32 accumulators
//   (m64n256k16, 128 registers a thread, of the 232 that setmaxnreg gives
//   the consumers from the producer warpgroup; the d_rf layer m64n128k16).
//   At u = 768 a half is 384 columns: it is taken in passes of 128
//   (wide_pass), each finished pass held as packed bf16 in registers until
//   the last one writes the tile. The plan of tiles and shared memory is
//   mirrored in Python (kernels/ray_march.py: mlp_backward_plan), which
//   refuses other widths before any launch.
// * The chain stays on chip. The A tile (tile x u bf16, 64 KB) holds the
//   current cotangent in the 128-byte swizzled K-major layout: 64-column
//   boxes of [tile x 128 B]. Once a layer's products have retired (wgmma
//   wait 0, then a barrier over both consumer warpgroups), its bf16 output
//   is written over the tile in the same layout and becomes the next
//   layer's A. The first A is the [tile x 16] head cotangent in box 0,
//   written by the consumers in the prologue.
// * Weights stream through a ring of 3 stages of 32 KB: one TMA box of
//   [64 K x up to 256 rows of W] each, full/empty mbarriers, one producer
//   thread, in the order the layers use them (k-slab, then the 256-row
//   part of W at u = 512, which only the warpgroup owning those columns
//   multiplies; the other releases the stage at once). Consumers release a
//   stage once the product group after it has been issued, so one group of
//   products and the loads of up to two stages are in flight behind it.
//   The weights are the same for every block and stay resident in L2.
// * The sigma column of w_sf (K = u + 16, of which one column is not
//   zero) is not a product: d_sigma_pre[p] w_sf[c, u] is added in float32
//   in the d_h epilogue, before the mask. K stays a multiple of 64.
// * Masks from shared memory: the producer TMA-loads the block's h_{i-1}
//   tile (64 KB, the same swizzled layout, zeros past P) while layer i's
//   products run, once the previous epilogue has released the buffer; the
//   epilogue reads each accumulator's (row, column) pair from it. Nothing in
//   an epilogue reads device memory.
// * Shared memory: A 64 KB + mask 64 KB + ring 96 KB + d_sigma and the
//   sigma column of w_sf + 1 KB of alignment = 226.1 / 226.3 KB (u = 256 /
//   512), one block per SM; the 256-thread copy-out of each finished tile
//   is 16-byte stores from the swizzled tile, no row past P. At u = 768 A
//   and the mask take 96 KB each, and the ring two stages of [64 K x 128
//   rows of W] (16 KB): 232,240 of the 232,448 bytes. The masks stay bf16
//   tiles loaded by TMA, as at the other widths, rather than bits that a
//   kernel would have to make from the stash first.
// * No atomics and a fixed k order: two runs give identical bits. A ring
//   fault traps (gmma::mbar_wait) instead of holding the card.
#include <cuda.h>

#include "gmma.cuh"
#include "mlp.cuh"

using namespace knt;

// Device pointers of the cotangent arrays; mirrored in kernels/ray_march.py.
struct MlpCotangents {
  bf16* d_rf;                // [P, u / 2]
  bf16* d_sf;                // [P, u + 16]
  bf16* d_pre[kMaxLayers];   // [P, u] each
};

namespace {

constexpr int kHead = 16;                 // head cotangent columns
constexpr int kStages = 3;
constexpr int kBoxRows = 256;             // most rows of W in one stage
constexpr int kStageBytes = 128 * kBoxRows;
constexpr int kTileElems = 128 * 256;     // points x u of the A and mask tiles at u = 256, 512
// u = 768: the A and mask tiles of 64 x 768 (96 KB each) leave room for a
// ring of two stages of 128 rows of W.
constexpr int kWideStages = 2;
constexpr int kWideBoxRows = 128;
constexpr int kWideStageBytes = 128 * kWideBoxRows;
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = 128 + kConsumers;
constexpr int kFullBar = 1;               // named barrier of the consumers

struct BwdParams {
  CUtensorMap w_rgb, w_rf_top, w_sf;
  CUtensorMap trunk[kMaxLayers];  // trunk_w[i] for i >= 1
  CUtensorMap h[kMaxLayers];      // the stash's h[i], [P, u]
  const bf16* w_sf_ptr;
  const bf16* d_rgb;              // quadrature mode
  const bf16* d_sigma;
  const bf16* g;                  // output-head mode
  const float* y;
  bf16* d_rgb_out;
  MlpCotangents ct;
  int P, u, n;
};

// The plan at width u (mirrored by mlp_backward_plan): points per block,
// ring stages and rows of W per stage.
__host__ __device__ constexpr int tile_of(int u) { return u == 768 ? 64 : kTileElems / u; }
__host__ __device__ constexpr int stages_of(int u) { return u == 768 ? kWideStages : kStages; }
__host__ __device__ constexpr int box_rows_of(int u) { return u == 768 ? kWideBoxRows : kBoxRows; }

// Layer L of the chain: 0 the rgb head (K 16), 1 the rgb-feature layer
// (K u/2), 2 the sigma/feature head (K u), 3 + j the trunk layer n-1-j.
struct Layer {
  const CUtensorMap* map;
  int k, n, slabs, parts;
};

__device__ __forceinline__ Layer layer_of(const BwdParams& prm, int L) {
  const int u = prm.u;
  Layer l;
  l.map = L == 0 ? &prm.w_rgb : L == 1 ? &prm.w_rf_top : L == 2 ? &prm.w_sf
                                                               : &prm.trunk[prm.n + 2 - L];
  l.k = L == 0 ? kHead : L == 1 ? u / 2 : u;
  l.n = L == 0 ? u / 2 : u;
  l.slabs = (l.k + 63) / 64;
  l.parts = (l.n + kBoxRows - 1) / kBoxRows;
  return l;
}

// Byte offset of element (r, c) of a [tile x u] bf16 tile in 64-column
// boxes with the 128-byte swizzle.
template <int kTile>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (kTile * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

struct Smem {
  uint8_t* a;      // the cotangent tile
  uint8_t* mask;   // h_{i-1} of the tile
  uint8_t* ring;
  float* sig;      // d_sigma_pre of the tile's points
  bf16* wsig;      // w_sf[:, u]
  uint64_t* full;  // kStages
  uint64_t* empty; // kStages
  uint64_t* mask_full;
  uint64_t* mask_empty;
};

// The producer thread: every stage of every layer in order, and each masked
// layer's h tile once its ring has started, after the epilogue before it
// released the buffer.
template <int kUnits>
__device__ void produce(const BwdParams& prm, const Smem& sm, int p0, int layers) {
  constexpr int kTile = tile_of(kUnits), kS = stages_of(kUnits), kRows = box_rows_of(kUnits);
  constexpr bool kWide = kUnits == 768;
  int g = 0;
  for (int L = 0; L < layers; ++L) {
    const Layer l = layer_of(prm, L);
    gmma::prefetch_tensormap(l.map);
    const int box_rows = l.n < kRows ? l.n : kRows;
    // At u = 768 each warpgroup takes its half of the columns in passes of
    // 128 (the last of d_rf's 64): per K slab a stage for each.
    const int half = l.n / 2, passes = kWide ? (half + 127) / 128 : 1;
    const int units = kWide ? 2 : l.parts;
    const int total = passes * l.slabs * units;
    const int mask_after = (total < kS ? total : kS) - 1;
    int i = 0;
    for (int pass = 0; pass < passes; ++pass) {
      for (int ks = 0; ks < l.slabs; ++ks) {
        for (int part = 0; part < units; ++part, ++i, ++g) {
          const int s = g % kS;
          gmma::mbar_wait(&sm.empty[s], ((g / kS) & 1) ^ 1);
          gmma::mbar_arrive_expect_tx(&sm.full[s], 128 * box_rows);
          gmma::tma_load_2d(sm.ring + s * 128 * kRows, l.map, &sm.full[s], 64 * ks,
                            kWide ? part * half + 128 * pass : kRows * part);
          if (L >= 2 && i == mask_after) {
            const int e = L - 2;
            const CUtensorMap* hm = &prm.h[prm.n - 1 - e];
            gmma::mbar_wait(sm.mask_empty, (e & 1) ^ 1);
            gmma::mbar_arrive_expect_tx(sm.mask_full, 2 * kTile * kUnits);
            for (int b = 0; b < kUnits / 64; ++b)
              gmma::tma_load_2d(sm.mask + b * kTile * 128, hm, sm.mask_full, 64 * b, p0);
          }
        }
      }
    }
  }
}

// Rows [0, rows) x columns [0, cols) of the swizzled A tile to global rows
// p0.. of a row-major [P, ld] array, 16 bytes per thread and step.
template <int kTile>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, int ld, int p0,
                                           int rows, int cols, const uint8_t* a,
                                           int ct) {
  const int vec = cols / 8;
  for (int v = ct; v < rows * vec; v += kConsumers) {
    const int r = v / vec, c = (v % vec) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(p0 + r) * ld + c) =
        *reinterpret_cast<const uint4*>(a + swz<kTile>(r, c));
  }
}

// The finished tile of layer L to device memory.
template <int kTile>
__device__ __forceinline__ void store_layer(const BwdParams& prm, const Smem& sm, int L, int p0,
                                            int rows, int ct) {
  const int u = prm.u;
  if (L == 0) {
    store_tile<kTile>(prm.ct.d_rf, u / 2, p0, rows, u / 2, sm.a, ct);
  } else if (L == 1) {
    store_tile<kTile>(prm.ct.d_sf, u + kHead, p0, rows, u, sm.a, ct);
    for (int r = ct; r < rows; r += kConsumers) {
      uint4* dst = reinterpret_cast<uint4*>(prm.ct.d_sf + (size_t)(p0 + r) * (u + kHead) + u);
      const __nv_bfloat162 s0 = __floats2bfloat162_rn(sm.sig[r], 0.f);
      dst[0] = make_uint4(*reinterpret_cast<const uint32_t*>(&s0), 0u, 0u, 0u);
      dst[1] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    store_tile<kTile>(prm.ct.d_pre[prm.n + 1 - L], u, p0, rows, u, sm.a, ct);
  }
}

// One layer of the chain for consumer warpgroup wg: the products of every
// stage it owns into float32 accumulators, then, once both warpgroups'
// products have retired, the epilogue into the A tile and the copy-out.
template <int kTile, int NW>
__device__ __forceinline__ void run_layer(const BwdParams& prm, const Smem& sm, int L,
                                          int& g, int p0, int rows) {
  constexpr bool kSplitCols = kTile == 64;
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, t = ct % 128, warp = t / 32, lane = t % 32;
  const Layer l = layer_of(prm, L);
  const int ksteps = l.k < 64 ? l.k / 16 : 4;
  const int a_row = kSplitCols ? 0 : 64 * wg;
  const int col0 = kSplitCols ? wg * NW : 0;

  float acc[NW / 2];
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;

  int pending = -1;  // the stage of the last committed group
  for (int ks = 0; ks < l.slabs; ++ks) {
    for (int part = 0; part < l.parts; ++part, ++g) {
      const int s = g % kStages;
      gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
      const bool own = l.parts == 1 || part == wg;
      if (!own) {
        if (lane == 0) gmma::mbar_arrive(&sm.empty[s]);
        continue;
      }
      const int b_row = kSplitCols && l.parts == 1 ? wg * NW : 0;
      const uint64_t da = gmma::desc_sw128_kmajor(sm.a + ks * kTile * 128 + a_row * 128);
      const uint64_t db =
          gmma::desc_sw128_kmajor(sm.ring + s * kStageBytes + b_row * 128);
      gmma::fence_operands(acc);
      gmma::fence();
      for (int k = 0; k < ksteps; ++k)
        gmma::mma_m64k16<NW, 0, 0>(acc, da + 2 * k, db + 2 * k);
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

  // Both warpgroups' products have read A: overwrite it.
  gmma::bar_sync(kFullBar, kConsumers);
  const bool masked = L >= 2;
  if (masked) gmma::mbar_wait(sm.mask_full, (L - 2) & 1);
  const int r0 = a_row + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (L == 2) {
        const float sg = sm.sig[r];
        v0 = __fmaf_rn(sg, __bfloat162float(sm.wsig[c]), v0);
        v1 = __fmaf_rn(sg, __bfloat162float(sm.wsig[c + 1]), v1);
      }
      const int off = swz<kTile>(r, c);
      if (masked) {
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(sm.mask + off);
        if (!(__low2float(hv) > 0.f)) v0 = 0.f;
        if (!(__high2float(hv) > 0.f)) v1 = 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(sm.a + off) = __floats2bfloat162_rn(v0, v1);
    }
  }
  if (masked) {
    __syncwarp();
    if (lane == 0) gmma::mbar_arrive(sm.mask_empty);
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
  store_layer<kTile>(prm, sm, L, p0, rows, ct);
}

// u = 768: a warpgroup's half of a layer's columns (384; d_rf's 192) in
// passes of NW = 128 columns (the last of d_rf's 64), each into NW / 2
// float32 accumulators, so that a warpgroup never holds more than 128 (as
// at u = 512; the whole half would take 192). Pass kPass of warpgroup wg
// takes columns wg * half + 128 kPass, from the first NW rows of its
// 128-row stages. A pass before the last keeps its bf16 results packed in
// registers (hold), since the later passes' products still read the A
// tile; the last pass writes every pass's columns once both warpgroups'
// products have retired, then releases the mask.
template <int NW, int kPass, bool kLast>
__device__ __forceinline__ void wide_pass(const BwdParams& prm, const Smem& sm, int L,
                                          const Layer& l, int& g, uint32_t (&hold)[2][32],
                                          int p0, int rows) {
  constexpr int kTile = 64;
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, t = ct % 128, warp = t / 32, lane = t % 32;
  const int half = l.n / 2;
  const int ksteps = l.k < 64 ? l.k / 16 : 4;

  // With two stages a warpgroup owns every other one, always the same:
  // it releases its stage as soon as the product retires, for the stage
  // its next product needs is that one.
  float acc[NW / 2];
  int scale = 0;  // the pass's first product overwrites the accumulators
  for (int ks = 0; ks < l.slabs; ++ks) {
    for (int part = 0; part < 2; ++part, ++g) {
      const int s = g % kWideStages;
      gmma::mbar_wait(&sm.full[s], (g / kWideStages) & 1);
      if (part == wg) {
        const uint64_t da = gmma::desc_sw128_kmajor(sm.a + ks * kTile * 128);
        const uint64_t db = gmma::desc_sw128_kmajor(sm.ring + s * kWideStageBytes);
        gmma::fence_operands(acc);
        gmma::fence();
        for (int k = 0; k < ksteps; ++k) {
          gmma::mma_m64k16<NW, 0, 0>(acc, da + 2 * k, db + 2 * k, scale);
          scale = 1;
        }
        gmma::commit();
        gmma::fence_operands(acc);
        gmma::wait<0>();
        gmma::fence_operands(acc);
      }
      if (lane == 0) gmma::mbar_arrive(&sm.empty[s]);
    }
  }

  const bool masked = L >= 2;
  if (kPass == 0 && masked) gmma::mbar_wait(sm.mask_full, (L - 2) & 1);
  const int r0 = 16 * warp + lane / 4;
  if constexpr (kLast) {
    // Both warpgroups' products have read A: overwrite it, the earlier
    // passes' columns first.
    gmma::bar_sync(kFullBar, kConsumers);
#pragma unroll
    for (int q = 0; q < kPass; ++q)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              sm.a + swz<kTile>(r0 + 8 * h, wg * half + 128 * q + 8 * j + 2 * (lane % 4))) =
              hold[q][2 * j + h];
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = wg * half + 128 * kPass + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (L == 2) {
        const float sg = sm.sig[r];
        v0 = __fmaf_rn(sg, __bfloat162float(sm.wsig[c]), v0);
        v1 = __fmaf_rn(sg, __bfloat162float(sm.wsig[c + 1]), v1);
      }
      const int off = swz<kTile>(r, c);
      if (masked) {
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(sm.mask + off);
        if (!(__low2float(hv) > 0.f)) v0 = 0.f;
        if (!(__high2float(hv) > 0.f)) v1 = 0.f;
      }
      const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
      if constexpr (kLast)
        *reinterpret_cast<__nv_bfloat162*>(sm.a + off) = o;
      else
        hold[kPass][2 * j + h] = *reinterpret_cast<const uint32_t*>(&o);
    }
  }
  if constexpr (!kLast) return;
  if (masked) {
    __syncwarp();
    if (lane == 0) gmma::mbar_arrive(sm.mask_empty);
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
  store_layer<kTile>(prm, sm, L, p0, rows, ct);
}

// One layer of the chain at u = 768: every pass of each warpgroup's half.
__device__ __forceinline__ void run_layer_wide(const BwdParams& prm, const Smem& sm, int L,
                                               int& g, int p0, int rows) {
  const Layer l = layer_of(prm, L);
  uint32_t hold[2][32];
  if (L == 0) {
    wide_pass<128, 0, false>(prm, sm, L, l, g, hold, p0, rows);
    wide_pass<64, 1, true>(prm, sm, L, l, g, hold, p0, rows);
  } else {
    wide_pass<128, 0, false>(prm, sm, L, l, g, hold, p0, rows);
    wide_pass<128, 1, false>(prm, sm, L, l, g, hold, p0, rows);
    wide_pass<128, 2, true>(prm, sm, L, l, g, hold, p0, rows);
  }
}

// The head cotangents of the tile into A's first box (columns 0..15; zero
// past the last point), d_sigma_pre into sig, w_sf[:, u] into wsig; in the
// output-head mode also d_rgb_out. From g and y where g is not null.
template <int kTile>
__device__ __forceinline__ void prologue(const BwdParams& prm, const Smem& sm, int p0,
                                         int rows) {
  const int ct = threadIdx.x - 128;
  const int u = prm.u;
  for (int r = ct; r < kTile; r += kConsumers) {
    uint4 q[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    float sig = 0.f;
    if (r < rows) {
      const size_t p = (size_t)(p0 + r);
      if (prm.g == nullptr) {
        const uint4* src = reinterpret_cast<const uint4*>(prm.d_rgb + p * kHead);
        q[0] = src[0];
        q[1] = src[1];
        sig = __bfloat162float(prm.d_sigma[p]);
      } else {
        float e[3];
        for (int c = 0; c < 3; ++c) {
          const float yv = prm.y[p * 4 + c];
          e[c] = __fmul_rn(__fmul_rn(__bfloat162float(prm.g[p * 4 + c]), yv),
                           __fsub_rn(1.f, yv));
        }
        const __nv_bfloat162 e01 = __floats2bfloat162_rn(e[0], e[1]);
        const __nv_bfloat162 e2 = __floats2bfloat162_rn(e[2], 0.f);
        q[0].x = *reinterpret_cast<const uint32_t*>(&e01);
        q[0].y = *reinterpret_cast<const uint32_t*>(&e2);
        if (prm.y[p * 4 + 3] > 0.f) sig = __bfloat162float(prm.g[p * 4 + 3]);
        uint4* out = reinterpret_cast<uint4*>(prm.d_rgb_out + p * kHead);
        out[0] = q[0];
        out[1] = q[1];
      }
    }
    *reinterpret_cast<uint4*>(sm.a + swz<kTile>(r, 0)) = q[0];
    *reinterpret_cast<uint4*>(sm.a + swz<kTile>(r, 8)) = q[1];
    sm.sig[r] = sig;
  }
  for (int c = ct; c < u; c += kConsumers)
    sm.wsig[c] = prm.w_sf_ptr[(size_t)c * (u + 128) + u];
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads, 1)
mlp_backward_kernel(const __grid_constant__ BwdParams prm) {
  constexpr int kTile = tile_of(kUnits), kS = stages_of(kUnits);
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.a = base;
  sm.mask = sm.a + 2 * kTile * kUnits;
  sm.ring = sm.mask + 2 * kTile * kUnits;
  sm.sig = reinterpret_cast<float*>(sm.ring + kS * 128 * box_rows_of(kUnits));
  sm.wsig = reinterpret_cast<bf16*>(sm.sig + kTile);
  sm.full = reinterpret_cast<uint64_t*>(sm.wsig + kUnits);
  sm.empty = sm.full + kS;
  sm.mask_full = sm.empty + kS;
  sm.mask_empty = sm.mask_full + 1;

  const int p0 = blockIdx.x * kTile;
  const int rows = min(kTile, prm.P - p0);
  const int layers = prm.n + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    gmma::mbar_init(sm.mask_full, 1);
    gmma::mbar_init(sm.mask_empty, kConsumers / 32);
    gmma::fence_barrier_init();
  }
  __syncthreads();

  // The producer warpgroup gives its registers to the consumers: 128 x 40 +
  // 256 x 232 = 384 x 168, the budget of one block of 384 threads.
  if (threadIdx.x < 128) {
    gmma::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce<kUnits>(prm, sm, p0, layers);
    return;
  }
  gmma::setmaxnreg_inc<232>();
  prologue<kTile>(prm, sm, p0, rows);
  int g = 0;
  if constexpr (kUnits == 768) {
    for (int L = 0; L < layers; ++L) run_layer_wide(prm, sm, L, g, p0, rows);
  } else {
    run_layer<kTile, 128>(prm, sm, 0, g, p0, rows);
    for (int L = 1; L < layers; ++L) run_layer<kTile, 256>(prm, sm, L, g, p0, rows);
  }
}

// Dynamic shared memory of the kernel (mirrored by mlp_backward_plan): A
// and mask (tile x units bf16 each), the ring, sig [tile] float32, wsig
// [units] bf16, 2 stages + 2 mbarriers, and the 1024-byte alignment.
constexpr int smem_bytes(int tile, int units, int stages, int stage_bytes) {
  return 1024 + 2 * 2 * tile * units + stages * stage_bytes + 4 * tile + 2 * units +
         8 * (2 * stages + 2);
}
constexpr int smem_of(int u) { return smem_bytes(tile_of(u), u, stages_of(u), 128 * box_rows_of(u)); }
static_assert(smem_of(256) <= 232448 && smem_of(512) <= 232448 && smem_of(768) <= 232448,
              "mlp_backward exceeds the H100's 227 KB of shared memory");

template <int kUnits>
int launch_tile(BwdParams& prm, cudaStream_t stream) {
  constexpr int kTile = tile_of(kUnits);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_backward_kernel<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_of(kUnits));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int blocks = (prm.P + kTile - 1) / kTile;
  mlp_backward_kernel<kUnits><<<blocks, kThreads, smem_of(kUnits), stream>>>(prm);
  return (int)cudaGetLastError();
}

int launch(const MlpWeights* w, const bf16* d_rgb, const bf16* d_sigma, const bf16* g,
           const float* y, bf16* d_rgb_out, const MlpStash* st, const MlpCotangents* ct,
           int P, void* stream) {
  if (P <= 0) return 0;
  const int u = w->units, n = w->n_layers;
  if (n < 1 || n > kMaxLayers || (u != 256 && u != 512 && u != 768))
    return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const int tile = tile_of(u);
  const int rows = u < box_rows_of(u) ? u : box_rows_of(u);

  BwdParams prm;  // copied into the launch's parameters
  int err = gmma::encode_map(fn, &prm.w_rgb, w->w_rgb, 128, u / 2, u / 2 < rows ? u / 2 : rows);
  if (!err) err = gmma::encode_map(fn, &prm.w_rf_top, w->w_rf_top, u / 2, u, rows);
  if (!err) err = gmma::encode_map(fn, &prm.w_sf, w->w_sf, u + 128, u, rows);
  for (int i = 1; i < n && !err; ++i)
    err = gmma::encode_map(fn, &prm.trunk[i], w->trunk_w[i], u, u, rows);
  for (int i = 0; i < n && !err; ++i)
    err = gmma::encode_map(fn, &prm.h[i], st->h[i], u, P, tile);
  if (err) return -err;
  prm.w_sf_ptr = w->w_sf;
  prm.d_rgb = d_rgb;
  prm.d_sigma = d_sigma;
  prm.g = g;
  prm.y = y;
  prm.d_rgb_out = d_rgb_out;
  prm.ct = *ct;
  prm.P = P;
  prm.u = u;
  prm.n = n;
  const cudaStream_t s = (cudaStream_t)stream;
  if (u == 256) return launch_tile<256>(prm, s);
  return u == 512 ? launch_tile<512>(prm, s) : launch_tile<768>(prm, s);
}

// ---- the streamed route: any width (a multiple of 256), any depth ---------
//
// The kernel above keeps the cotangent and the mask tiles in shared memory
// and its tensor maps in fixed arrays of kMaxLayers; at u >= 1024 two such
// tiles of 64 points no longer fit beside a ring, and past 16 layers the
// arrays run out. mlp_backward_plan picks this route for those shapes (u =
// 256, 512 and 768 up to 16 layers keep the kernel above, unchanged):
// * Every layer's bf16 cotangent is written to device memory anyway (d_rf,
//   d_sf, d_pre[i]: mlp_weight_grad's operands), 128 columns (a pass) at a
//   time with stores from the accumulators. The next layer reads it back by
//   TMA, one [64 points x 64 K] slab a ring stage, beside the stage's [128
//   rows x 64 K] of W (K-major, as above). d_pre is one [n, P, u] array.
// * Plain stores read back by TMA: every storing thread runs
//   fence.proxy.async.global, then arrives on `ready`; the producer waits
//   on it before it loads the next layer's input (gmma.cuh).
// * The relu mask of each output column pair comes from the stash's h (one
//   [n, P, u] array) in the epilogue; the sigma column of w_sf from the
//   table's w_sf. The weights' maps are read from the packed state's device
//   table (mlp.cuh: MlpTable); the cotangents' maps are parameters.
// * The head cotangent tile ([64 x 16] bf16, made in the prologue as above)
//   stays in shared memory for the rgb layer. One consumer warpgroup takes
//   the 64 rows and every column, a pass at a time (m64n128k16); one
//   producer warp; two blocks share an SM.
// * Shared memory: ring 3 x 24 KB + the head tile 8 KB + d_sigma 256 B + 1
//   KB of alignment = 81.3 KB (mlp_backward_plan mirrors it).
// * No atomics and a fixed k order: two runs give identical bits.
namespace streamed {

constexpr int kTile = 64;                        // points per block
constexpr int kStages = 3;
constexpr int kABytes = kTile * 128;             // A: [64 points x 64 K] bf16, one box
constexpr int kStageBytes = kABytes + 2 * kABytes;  // + B: [128 rows x 64 K], two boxes
constexpr int kPass = 128;                       // output columns a pass
constexpr int kConsumers = 128;                  // one warpgroup
constexpr int kThreads = kConsumers + 32;        // and the producer warp
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kABytes + 4 * kTile +
                           8 * (2 * kStages + 1);

struct Params {
  CUtensorMap d_rf, d_sf, d_pre;  // the cotangents, read back as the next layer's input
  const void* table;              // MlpTable
  const bf16* d_rgb;              // quadrature mode
  const bf16* d_sigma;
  const bf16* g;                  // output-head mode
  const float* y;
  bf16* d_rgb_out;
  const bf16* h;                  // the stash's h, [n, P, u]
  bf16* d_rf_ptr;                 // [P, u / 2]
  bf16* d_sf_ptr;                 // [P, u + 16]
  bf16* d_pre_ptr;                // [n, P, u]
  int P, u, n;
};

struct SSmem {
  uint8_t* ring;
  uint8_t* head;     // the head cotangent tile, [64 x 16] in a [64 x 64] box
  float* sig;        // d_sigma_pre of the tile's points
  uint64_t* full;    // kStages
  uint64_t* empty;   // kStages
  uint64_t* ready;   // a layer's output is in device memory
};

// Layer L as layer_of above: 0 the rgb head (K 16), 1 the rgb-feature layer
// (K u/2), 2 the sigma/feature head (K u), 3 + j the trunk layer n-1-j.
__device__ __forceinline__ const CUtensorMap* map_of(const Params& prm, const MlpTable& t, int L) {
  return L == 0 ? &t.heads[kMapRgb] : L == 1 ? &t.heads[kMapRfTop]
       : L == 2 ? &t.heads[kMapSf] : &t.trunk[prm.n + 2 - L];
}
__device__ __forceinline__ int k_of(const Params& prm, int L) {
  return L == 0 ? kHead : L == 1 ? prm.u / 2 : prm.u;
}
__device__ __forceinline__ int n_of(const Params& prm, int L) { return L == 0 ? prm.u / 2 : prm.u; }

// The producer thread: every stage of every layer, each layer's input once
// the layer before has written it.
__device__ void produce(const Params& prm, const SSmem& sm, int p0) {
  const MlpTable t = table_of(prm.table, prm.n);
  int g = 0;
  for (int L = 0; L < prm.n + 2; ++L) {
    const CUtensorMap* map = map_of(prm, t, L);
    const int slabs = (k_of(prm, L) + 63) / 64;
    if (L > 0) gmma::mbar_wait(sm.ready, (L - 1) & 1);
    for (int pass = 0; pass < n_of(prm, L) / kPass; ++pass) {
      for (int ks = 0; ks < slabs; ++ks, ++g) {
        const int s = g % kStages;
        uint8_t* st = sm.ring + s * kStageBytes;
        gmma::mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
        gmma::mbar_arrive_expect_tx(&sm.full[s], 2 * kABytes + (L > 0 ? kABytes : 0));
        for (int b = 0; b < 2; ++b)
          gmma::tma_load_2d(st + kABytes + b * kABytes, map, &sm.full[s], 64 * ks,
                            kPass * pass + 64 * b);
        if (L == 1)
          gmma::tma_load_2d(st, &prm.d_rf, &sm.full[s], 64 * ks, p0);
        else if (L == 2)
          gmma::tma_load_2d(st, &prm.d_sf, &sm.full[s], 64 * ks, p0);
        else if (L > 2)
          gmma::tma_load_3d(st, &prm.d_pre, &sm.full[s], 64 * ks, p0, prm.n + 2 - L);
      }
    }
  }
}

// One layer: every pass's products, then its epilogue (d_sigma's term of
// the sigma column at L = 2, the relu mask from L = 2 on) stored as bf16
// from the registers.
__device__ __forceinline__ void run_layer(const Params& prm, const MlpTable& t, const SSmem& sm,
                                          int L, int& g, int p0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u = prm.u, k = k_of(prm, L), n_out = n_of(prm, L);
  const int slabs = (k + 63) / 64, ksteps = k < 64 ? k / 16 : 4;
  const int r0 = 16 * warp + lane / 4;
  const size_t plane = (size_t)prm.P * u;
  bf16* dst = L == 0 ? prm.d_rf_ptr : L == 1 ? prm.d_sf_ptr : prm.d_pre_ptr + (prm.n + 1 - L) * plane;
  const int ld = L == 0 ? u / 2 : L == 1 ? u + kHead : u;
  const bf16* mask = L >= 2 ? prm.h + (prm.n + 1 - L) * plane : nullptr;
  const bf16* wsig = t.w->w_sf + u;  // column u of w_sf, row stride u + 128
  for (int pass = 0; pass < n_out / kPass; ++pass) {
    float acc[kPass / 2];
    int scale = 0;     // the pass's first product overwrites the accumulators
    int pending = -1;  // the stage of the last committed group
    for (int ks = 0; ks < slabs; ++ks, ++g) {
      const int s = g % kStages;
      const uint8_t* st = sm.ring + s * kStageBytes;
      gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
      const uint64_t da = gmma::desc_sw128_kmajor(L == 0 ? sm.head : st);
      const uint64_t db = gmma::desc_sw128_kmajor(st + kABytes);
      gmma::fence_operands(acc);
      gmma::fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        gmma::mma_m64k16<kPass, 0, 0>(acc, da + 2 * kk, db + 2 * kk, scale);
        scale = 1;
      }
      gmma::commit();
      gmma::fence_operands(acc);
      gmma::wait<1>();
      gmma::fence_operands(acc);
      if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);
      pending = s;
    }
    gmma::wait<0>();
    gmma::fence_operands(acc);
    if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);

#pragma unroll
    for (int j = 0; j < kPass / 8; ++j) {
      const int c = kPass * pass + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= rows) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (L == 2) {
          const float sg = sm.sig[r];
          v0 = __fmaf_rn(sg, __bfloat162float(wsig[(size_t)c * (u + 128)]), v0);
          v1 = __fmaf_rn(sg, __bfloat162float(wsig[(size_t)(c + 1) * (u + 128)]), v1);
        }
        if (mask != nullptr) {
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(mask + (size_t)(p0 + r) * u + c);
          if (!(__low2float(hv) > 0.f)) v0 = 0.f;
          if (!(__high2float(hv) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(p0 + r) * ld + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if (L == 1) {
    // d_sf's column u: d_sigma_pre, then 15 zeros.
    for (int r = threadIdx.x; r < rows; r += kConsumers) {
      uint4* d = reinterpret_cast<uint4*>(prm.d_sf_ptr + (size_t)(p0 + r) * (u + kHead) + u);
      const __nv_bfloat162 s0 = __floats2bfloat162_rn(sm.sig[r], 0.f);
      d[0] = make_uint4(*reinterpret_cast<const uint32_t*>(&s0), 0u, 0u, 0u);
      d[1] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // The next layer reads this one's output by TMA.
  if (L < prm.n + 1) {
    gmma::fence_proxy_async_global();
    gmma::mbar_arrive(sm.ready);
  }
}

// The head cotangents into the head tile and sig, as prologue above; in
// the output-head mode also d_rgb_out.
__device__ __forceinline__ void prologue(const Params& prm, const SSmem& sm, int p0, int rows) {
  for (int r = threadIdx.x; r < kTile; r += kConsumers) {
    uint4 q[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    float sig = 0.f;
    if (r < rows) {
      const size_t p = (size_t)(p0 + r);
      if (prm.g == nullptr) {
        const uint4* src = reinterpret_cast<const uint4*>(prm.d_rgb + p * kHead);
        q[0] = src[0];
        q[1] = src[1];
        sig = __bfloat162float(prm.d_sigma[p]);
      } else {
        float e[3];
        for (int c = 0; c < 3; ++c) {
          const float yv = prm.y[p * 4 + c];
          e[c] = __fmul_rn(__fmul_rn(__bfloat162float(prm.g[p * 4 + c]), yv),
                           __fsub_rn(1.f, yv));
        }
        const __nv_bfloat162 e01 = __floats2bfloat162_rn(e[0], e[1]);
        const __nv_bfloat162 e2 = __floats2bfloat162_rn(e[2], 0.f);
        q[0].x = *reinterpret_cast<const uint32_t*>(&e01);
        q[0].y = *reinterpret_cast<const uint32_t*>(&e2);
        if (prm.y[p * 4 + 3] > 0.f) sig = __bfloat162float(prm.g[p * 4 + 3]);
        uint4* out = reinterpret_cast<uint4*>(prm.d_rgb_out + p * kHead);
        out[0] = q[0];
        out[1] = q[1];
      }
    }
    *reinterpret_cast<uint4*>(sm.head + swz<kTile>(r, 0)) = q[0];
    *reinterpret_cast<uint4*>(sm.head + swz<kTile>(r, 8)) = q[1];
    sm.sig[r] = sig;
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
}

__global__ void __launch_bounds__(kThreads, 2)
mlp_backward_streamed_kernel(const __grid_constant__ Params prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  SSmem sm;
  sm.ring = base;
  sm.head = sm.ring + kStages * kStageBytes;
  sm.sig = reinterpret_cast<float*>(sm.head + kABytes);
  sm.full = reinterpret_cast<uint64_t*>(sm.sig + kTile);
  sm.empty = sm.full + kStages;
  sm.ready = sm.empty + kStages;

  const int p0 = blockIdx.x * kTile;
  const int rows = min(kTile, prm.P - p0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    gmma::mbar_init(sm.ready, kConsumers);
    gmma::fence_barrier_init();
  }
  __syncthreads();
  // Warps 0-3 are the consumer warpgroup; warp 4 holds the producer.
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(prm, sm, p0);
    return;
  }
  prologue(prm, sm, p0, rows);
  const MlpTable t = table_of(prm.table, prm.n);
  int g = 0;
  for (int L = 0; L < prm.n + 2; ++L) run_layer(prm, t, sm, L, g, p0, rows);
}

// table: the packed state's device table (n layers of u units); h: the
// stash's h as one [n, P, u] array; d_rf, d_sf, d_pre: the cotangent arrays
// (d_pre one [n, P, u] array). Returns 0, a cudaError_t, or -CUresult.
int launch(const void* table, int n, int u, const bf16* d_rgb, const bf16* d_sigma,
           const bf16* g, const float* y, bf16* d_rgb_out, const bf16* h, bf16* d_rf,
           bf16* d_sf, bf16* d_pre, int P, void* stream) {
  if (P <= 0) return 0;
  if (n < 1 || u < 256 || u % 256 || table == nullptr) return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  Params prm{};  // copied into the launch's parameters
  int err = gmma::encode_map(fn, &prm.d_rf, d_rf, u / 2, P, 64);
  if (!err) err = gmma::encode_map(fn, &prm.d_sf, d_sf, u + kHead, P, 64);
  if (!err) err = gmma::encode_map_3d(fn, &prm.d_pre, d_pre, 2, u, P, n, 64, 64);
  if (err) return -err;
  prm.table = table;
  prm.d_rgb = d_rgb;
  prm.d_sigma = d_sigma;
  prm.g = g;
  prm.y = y;
  prm.d_rgb_out = d_rgb_out;
  prm.h = h;
  prm.d_rf_ptr = d_rf;
  prm.d_sf_ptr = d_sf;
  prm.d_pre_ptr = d_pre;
  prm.P = P;
  prm.u = u;
  prm.n = n;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_backward_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int blocks = (P + kTile - 1) / kTile;
  mlp_backward_streamed_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace streamed

}  // namespace

// w: the packed weights (u = 256, 512 or 768); d_rgb [P, 16], d_sigma [P] bf16
// from knt_ray_march_quadrature_grad; st: the train mode's kept
// activations; ct: the cotangent arrays to write. Returns 0, a cudaError_t,
// or -CUresult when a tensor map cannot be encoded.
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

// The streamed route (mlp_backward_plan's "streamed"), both modes: table,
// the packed state's device table of n layers of u units; the quadrature
// mode's d_rgb [P, 16] and d_sigma [P], or the output-head mode's g [P, 4],
// y [P, 4] and d_rgb_out [P, 16] (the others null); h: the stash's h as one
// [n, P, u] array; d_rf [P, u / 2], d_sf [P, u + 16] and d_pre [n, P, u]
// written. Returns 0, a cudaError_t, or -CUresult.
KNT_EXPORT int knt_mlp_backward_streamed(const void* table, int n, int u, const bf16* d_rgb,
                                         const bf16* d_sigma, const bf16* g, const float* y,
                                         bf16* d_rgb_out, const bf16* h, bf16* d_rf, bf16* d_sf,
                                         bf16* d_pre, int P, void* stream) {
  if ((g == nullptr) == (d_rgb == nullptr) || (g != nullptr && (y == nullptr || d_rgb_out == nullptr)) ||
      (g == nullptr && d_sigma == nullptr))
    return (int)cudaErrorInvalidValue;
  return streamed::launch(table, n, u, d_rgb, d_sigma, g, y, d_rgb_out, h, d_rf, d_sf, d_pre, P,
                          stream);
}
