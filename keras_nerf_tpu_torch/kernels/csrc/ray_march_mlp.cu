// ray_march_mlp: positional encoding and the radiance-field MLP per point.
//
// Replaces: the in-kernel encoding (keras_nerf_tpu/kernels/ray_march.py
// :1259-1280, _sin_poly :875; encode.cuh, which ray_march_mlp_int8.cu
// shares) and _forward_core (:369-426) of _train_chunk_kernel, in its full
// and sigma_only forms. The MLP multiplies bf16 operands with float32
// accumulation, adds the float32 bias, applies relu and rounds to bf16
// between layers, exactly the TPU kernel's precision policy, in the packed
// layout of pack_mlp_params (encoding blocks at lanes 0 and 64 of a
// 128-wide input, sigma in column `units` of the fused sigma/feature
// matrix).
//
// Train mode (a non-null MlpStash, full mode only): the forward of
// fused_train_chunk(with_grad=True) (:1292-1294, keep_acts). Each finished
// bf16 tile (the encoding, every trunk layer, the features, rf) is also
// copied to the stash in device memory, row-major [P, width] with no
// padding, where mlp_backward and mlp_weight_grad read it.
//
// Input mode (knt_apply_mlp, the apply_mlp wrapper): the TPU's
// fused_apply_mlp / _mlp_fwd_kernel (:438-493), the same _forward_core over
// points encoded outside the kernel (encode_block128, [P, 128] bf16), which
// TMA loads into the encoding tile (zeros past P). With a stash it is
// fused_mlp_backward's recompute: the stash's enc block is the input
// itself, so only the trunk activations, the features and rf are written.
//
// Bound on the H100: operations. 8 x 256 with the 63 + 27 wide encodings
// is 1.19 MFLOP per point (0.98 in sigma-only mode) against 16 B written
// (272 B read and written in the input mode); a 4096 x 192 fine chunk is
// 0.93 TFLOP, 0.94 ms at 989 TFLOP/s. The train mode writes 5,120 B per
// point (1.5 ns at 3.35 TB/s) beside its 1.2 ns of products, which makes
// it bound by bytes; the recompute 4,864 B.
//
// Design: every product is A[points, K] . W[K, N] on wgmma, both operands
// in shared memory: the activation tile as a K-major A (transpose flag 0,
// the descriptor of mlp_backward.cu) and W, packed row-major [fan_in,
// fan_out], as an MN-major B (transpose flag 1, the descriptor of
// mlp_weight_grad.cu). Nothing is transposed in memory.
// * A block owns a tile of points: 128 at u = 256, where each of the two
//   consumer warpgroups takes 64 rows and every column; 64 at u = 512 and
//   768, where both take the 64 rows and each half of the columns. A
//   warpgroup holds at most 64 x 256 float32 accumulators (m64n256k16, 128
//   registers a thread, of the 232 that setmaxnreg gives the consumers from
//   the producer warpgroup; the rf layer m64n128k16). At u = 768 a half is
//   384 columns, 192 registers: it is taken in passes of 128 columns
//   (wide_pass), each finished pass held as packed bf16 in registers until
//   the last one writes the tile, so a warpgroup holds at most 64 + 64. The
//   plan of tiles and shared memory is mirrored in Python
//   (kernels/ray_march.py: ray_march_mlp_plan), which refuses other widths
//   before any launch.
// * The encoding tile (tile x 128 bf16, two 64-column boxes in the
//   128-byte swizzled K-major layout) is built once per block, by the
//   consumers from encode_lane (each 16-byte chunk of 8 lanes stored at
//   its swizzled place) or by one TMA load in the input mode, and kept: the
//   first layer, every skip layer, w_sf_enc's features and w_rf_enc read
//   it as a second K run into the same accumulators.
// * The activation tile (tile x u bf16, 64 KB; 96 KB at u = 768; the same
//   layout) holds the current layer's input. Once every product that reads a row has
//   retired (wgmma wait 0, then a named barrier: of the warpgroup alone at
//   u = 256, where it owns its rows, of both at u = 512), the epilogue adds
//   the float32 bias, applies relu and rounds to bf16 in registers and
//   writes over the rows, which then pass to wgmma behind fence.proxy.async
//   and a second barrier, and, in the train mode, to the stash with 16-byte
//   stores (no row past P) before the next epilogue can overwrite them.
// * Weights stream through a ring of 3 stages of [64 K x 256 N]: four
//   64 x 64 TMA boxes each, full/empty mbarriers, one producer thread, in
//   the order the layers use them (K run, K slab, then the 256-column part
//   at u = 512, which only the warpgroup owning those columns multiplies;
//   the other releases the stage at once; at u = 768 a stage of 128 (or 64)
//   columns per pass, K slab and warpgroup). Consumers release a stage once
//   the product group after it has been issued. The weights are the same
//   for every block and stay resident in L2.
// * The heads that are not wide products are float32 dots in the
//   epilogues that make their input: sigma, column u of w_sf, from the last
//   trunk layer's bf16 values (plus the encoding's part from shared memory
//   where the last layer skips), and rgb, columns 0..2 of w_rgb, from rf's;
//   the quad's partial sums meet by warp shuffles and, at u = 512, the two
//   warpgroups' halves in a fixed order. Sigma-only mode stops after the
//   trunk.
// * Shared memory: activation 64 / 64 / 96 KB + encoding 32 / 16 / 16 KB +
//   ring 96 KB + the heads' float32 columns and partial sums 10 KB + 1 KB
//   of alignment = 203.1 / 187.1 / 219.1 KB (u = 256 / 512 / 768), one
//   block per SM.
// * No atomics and a fixed k order: two runs give identical bits. A ring
//   fault traps (gmma::mbar_wait) instead of holding the card.
#include <cuda.h>

#include "encode.cuh"
#include "gmma.cuh"
#include "mlp.cuh"

using namespace knt;

namespace {

constexpr int kStages = 3;
constexpr int kBox = 64 * 128;            // one TMA box: 64 K rows x 64 N columns, bf16
constexpr int kStageBytes = 4 * kBox;     // [64 K x 256 N]
constexpr int kTileElems = 128 * 256;     // points x u of the activation tile at u = 256, 512
constexpr int kMaxUnits = 768;
// float32 area: partial head sums [128][4], w_sf[:, u] [u], w_sf_enc[:, u]
// [128], w_rgb[:, 0..2] [u / 2][3].
constexpr int kFloats = 128 * 4 + kMaxUnits + kEncLanes + kMaxUnits / 2 * 3;
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = 128 + kConsumers;
constexpr int kFullBar = 1;               // named barrier of the consumers

enum Head { kNoHead, kSigmaHead, kRgbHead };

// Points per block: 128 at u = 256, 64 at u = 512 and 768.
__host__ __device__ constexpr int tile_of(int units) { return units == 768 ? 64 : kTileElems / units; }

struct FwdParams {
  CUtensorMap trunk[kMaxLayers];      // trunk_w[i]
  CUtensorMap trunk_enc[kMaxLayers];  // trunk_enc_w[i], where bit i of enc_layers is set
  CUtensorMap sf, sf_enc, rf_top, rf_enc;
  CUtensorMap enc_in;                 // input mode: [P, 128]
  MlpWeights w;
  const float* base;
  const float* slope;
  const float* depths;
  const float* masks;
  float* out;
  MlpStash stash;
  int P, S, u, n, products, enc_layers, sf_enc_on, train;
};

// Product L: trunk layer L (L < n), the features (n), rf (n + 1). Its K
// runs: W over the activation tile (the encoding for layer 0), then W over
// the encoding, where the product has one.
struct Layer {
  const CUtensorMap* map[2];
  int slabs[2];  // 64-row K slabs of each run (0: no run)
  bool enc0;     // the first run reads the encoding tile
  int n, parts;  // output columns, 256-column parts
  const float* bias;
};

__device__ __forceinline__ Layer layer_of(const FwdParams& prm, int L) {
  const int u = prm.u;
  Layer l;
  l.enc0 = L == 0;
  l.slabs[0] = L == 0 ? kEncLanes / 64 : u / 64;
  l.n = u;
  if (L < prm.n) {
    l.map[0] = &prm.trunk[L];
    l.map[1] = (prm.enc_layers >> L) & 1 ? &prm.trunk_enc[L] : nullptr;
    l.bias = prm.w.trunk_b[L];
  } else if (L == prm.n) {
    l.map[0] = &prm.sf;
    l.map[1] = prm.sf_enc_on ? &prm.sf_enc : nullptr;
    l.bias = prm.w.b_sf;
  } else {
    l.map[0] = &prm.rf_top;
    l.map[1] = &prm.rf_enc;
    l.bias = prm.w.b_rf;
    l.n = u / 2;
  }
  l.slabs[1] = l.map[1] != nullptr ? kEncLanes / 64 : 0;
  l.parts = (l.n + 255) / 256;
  return l;
}

// Byte offset of element (r, c) of a [tile x cols] bf16 tile in 64-column
// boxes with the 128-byte swizzle: the 16-byte chunk c / 8 of row r sits at
// chunk (c / 8) ^ (r % 8) of the row (mirrored by
// kernels/ray_march.py: swizzled_offset).
template <int kTile>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (kTile * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

struct Smem {
  uint8_t* act;      // the activation tile
  uint8_t* enc;      // the encoding tile
  uint8_t* ring;
  float* red;        // partial head sums: [row (+ 64 for warpgroup 1 at u = 512)][r, g, b, sigma]
  float* wsig;       // w_sf[:, u]
  float* wsig_enc;   // w_sf_enc[:, u]
  float* wrgb;       // w_rgb[:, 0..2]
  uint64_t* full;    // kStages
  uint64_t* empty;   // kStages
  uint64_t* enc_full;
};

// The producer thread: the input tile (input mode), then every stage of
// every product in the order the consumers use them.
template <int kUnits, bool kEncIn>
__device__ void produce(const FwdParams& prm, const Smem& sm, int p0) {
  constexpr int kTile = tile_of(kUnits);
  if (kEncIn) {
    gmma::prefetch_tensormap(&prm.enc_in);
    gmma::mbar_arrive_expect_tx(sm.enc_full, kTile * 2 * kEncLanes);
    for (int b = 0; b < kEncLanes / 64; ++b)
      gmma::tma_load_2d(sm.enc + b * kTile * 128, &prm.enc_in, sm.enc_full, 64 * b, p0);
  }
  int g = 0;
  for (int L = 0; L < prm.products; ++L) {
    const Layer l = layer_of(prm, L);
    // At u = 768 each warpgroup takes its half of the columns in passes of
    // 128 (the last of rgb_features' 64): per K slab a stage for each.
    const int half = l.n / 2, passes = kUnits == 768 ? (half + 127) / 128 : 1;
    for (int pass = 0; pass < passes; ++pass) {
      for (int run = 0; run < 2; ++run) {
        for (int ks = 0; ks < l.slabs[run]; ++ks) {
          for (int part = 0; part < (kUnits == 768 ? 2 : l.parts); ++part, ++g) {
            int n0 = 256 * part, boxes = (l.n < 256 ? l.n : 256) / 64;
            if (kUnits == 768) {
              n0 = part * half + 128 * pass;
              boxes = min(128, half - 128 * pass) / 64;
            }
            const int s = g % kStages;
            gmma::mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
            gmma::mbar_arrive_expect_tx(&sm.full[s], boxes * kBox);
            for (int b = 0; b < boxes; ++b)
              gmma::tma_load_2d(sm.ring + s * kStageBytes + b * kBox, l.map[run], &sm.full[s],
                                n0 + 64 * b, 64 * ks);
          }
        }
      }
    }
  }
}

// Rows [r0, r1) x columns [0, cols) of a swizzled tile to global rows p0..
// of a row-major [P, cols] array, 16 bytes per thread and step, thread t of
// `threads`.
template <int kTile>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, int p0, int r0, int r1,
                                           int cols, const uint8_t* tile, int t,
                                           int threads) {
  const int vec = cols / 8;
  for (int v = r0 * vec + t; v < r1 * vec; v += threads) {
    const int r = v / vec, c = (v % vec) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(p0 + r) * cols + c) =
        *reinterpret_cast<const uint4*>(tile + swz<kTile>(r, c));
  }
}

// One product for consumer warpgroup wg: the products of every stage it
// owns into float32 accumulators, then, once both warpgroups' products
// have retired, the epilogue into the activation tile (and the head's
// partial dots), and the copy to the stash.
template <int kTile, int NW, int kHead>
__device__ __forceinline__ void run_layer(const FwdParams& prm, const Smem& sm, int L,
                                          int& g, int p0, int rows) {
  constexpr bool kSplitCols = kTile == 64;
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, t = ct % 128, warp = t / 32, lane = t % 32;
  const Layer l = layer_of(prm, L);
  const int a_row = kSplitCols ? 0 : 64 * wg;
  const int col0 = kSplitCols ? wg * NW : 0;
  // At u = 512 a one-part product (rf) gives each warpgroup half the
  // stage's columns: NW / 64 boxes.
  const int b_off = kSplitCols && l.parts == 1 ? wg * (NW / 64) * kBox : 0;
  // At u = 256 each warpgroup reads and writes only its own 64 rows, so its
  // epilogue waits for its own products alone (barrier 2 + wg) and the two
  // drift apart by up to the ring's depth, one's epilogue under the other's
  // products; at u = 512 both read every row.
  const int bar = kSplitCols ? kFullBar : 2 + wg;
  const int bar_threads = kSplitCols ? kConsumers : 128;

  float acc[NW / 2];
  int scale = 0;  // the layer's first product overwrites the accumulators

  int pending = -1;  // the stage of the last committed group
  for (int run = 0; run < 2; ++run) {
    const uint8_t* a = run == 1 || l.enc0 ? sm.enc : sm.act;
    for (int ks = 0; ks < l.slabs[run]; ++ks) {
      for (int part = 0; part < l.parts; ++part, ++g) {
        const int s = g % kStages;
        gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
        if (l.parts > 1 && part != wg) {
          if (lane == 0) gmma::mbar_arrive(&sm.empty[s]);
          continue;
        }
        const uint64_t da = gmma::desc_sw128_kmajor(a + ks * kTile * 128 + a_row * 128);
        const uint64_t db = gmma::desc_sw128(sm.ring + s * kStageBytes + b_off, kBox, 1024);
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
  }
  gmma::wait<0>();
  gmma::fence_operands(acc);
  if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);

  // Every product that reads these rows of the activation tile has
  // retired: overwrite them.
  gmma::bar_sync(bar, bar_threads);
  const bool relu = L < prm.n;
  const int r0 = a_row + 16 * warp + lane / 4;
  float dot[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);
    const float b0 = l.bias[c], b1 = l.bias[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = __fadd_rn(acc[4 * j + 2 * h], b0);
      float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(sm.act + swz<kTile>(r0 + 8 * h, c)) = o;
      const float x0 = __low2float(o), x1 = __high2float(o);
      if (kHead == kSigmaHead) {
        dot[h][0] = __fmaf_rn(x0, sm.wsig[c], dot[h][0]);
        dot[h][0] = __fmaf_rn(x1, sm.wsig[c + 1], dot[h][0]);
      } else if (kHead == kRgbHead) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          dot[h][q] = __fmaf_rn(x0, sm.wrgb[3 * c + q], dot[h][q]);
          dot[h][q] = __fmaf_rn(x1, sm.wrgb[3 * c + 3 + q], dot[h][q]);
        }
      }
    }
  }
  if (kHead != kNoHead) {
    // The four threads of a quad hold one row's columns: add them up, then
    // lane 0 of the quad keeps the row's partial sum.
    constexpr int kQ = kHead == kSigmaHead ? 1 : 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float x = dot[h][q];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (lane % 4 == 0) {
          float* red = sm.red + 4 * ((kSplitCols ? 64 * wg : 0) + r0 + 8 * h);
          red[kHead == kSigmaHead ? 3 : q] = x;
        }
      }
    }
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(bar, bar_threads);

  if (prm.train) {
    bf16* dst = L < prm.n ? prm.stash.h[L] : L == prm.n ? prm.stash.features : prm.stash.rf;
    if (kSplitCols)
      store_tile<kTile>(dst, p0, 0, rows, l.n, sm.act, ct, kConsumers);
    else
      store_tile<kTile>(dst, p0, a_row, min(a_row + 64, rows), l.n, sm.act, t, 128);
  }
}

// u = 768: a warpgroup's half of a product's columns (384; rgb_features'
// 192) in passes of NW = 128 columns (the last of rgb_features' 64), each
// into NW / 2 float32 accumulators: a warpgroup never holds more than 128,
// as at u = 512 (the whole half at once would take 192, more than
// setmaxnreg's 232 leave room for). Pass kPass of warpgroup wg takes
// columns wg * half + 128 kPass. A pass before the last keeps its bf16
// results packed in registers (hold), since the later passes' products
// still read the activation tile; the last pass writes every pass's
// columns once both warpgroups' products have retired.
template <int NW, int kHead, int kPass, bool kLast>
__device__ __forceinline__ void wide_pass(const FwdParams& prm, const Smem& sm, int L,
                                          const Layer& l, int& g, uint32_t (&hold)[2][32],
                                          float (&dot)[2][3], int p0, int rows) {
  constexpr int kTile = 64;
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, t = ct % 128, warp = t / 32, lane = t % 32;
  const int half = l.n / 2;

  float acc[NW / 2];
  int scale = 0;     // the pass's first product overwrites the accumulators
  int pending = -1;  // the stage of the last committed group
  for (int run = 0; run < 2; ++run) {
    const uint8_t* a = run == 1 || l.enc0 ? sm.enc : sm.act;
    for (int ks = 0; ks < l.slabs[run]; ++ks) {
      for (int part = 0; part < 2; ++part, ++g) {
        const int s = g % kStages;
        gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
        if (part != wg) {
          if (lane == 0) gmma::mbar_arrive(&sm.empty[s]);
          continue;
        }
        const uint64_t da = gmma::desc_sw128_kmajor(a + ks * kTile * 128);
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
  }
  gmma::wait<0>();
  gmma::fence_operands(acc);
  if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);

  const int r0 = 16 * warp + lane / 4;
  if constexpr (kLast) {
    // Every product that reads the activation tile has retired: overwrite
    // it, the earlier passes' columns first.
    gmma::bar_sync(kFullBar, kConsumers);
#pragma unroll
    for (int q = 0; q < kPass; ++q)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              sm.act + swz<kTile>(r0 + 8 * h, wg * half + 128 * q + 8 * j + 2 * (lane % 4))) =
              hold[q][2 * j + h];
  }
  const bool relu = L < prm.n;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = wg * half + 128 * kPass + 8 * j + 2 * (lane % 4);
    const float b0 = l.bias[c], b1 = l.bias[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = __fadd_rn(acc[4 * j + 2 * h], b0);
      float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
      if constexpr (kLast)
        *reinterpret_cast<__nv_bfloat162*>(sm.act + swz<kTile>(r0 + 8 * h, c)) = o;
      else
        hold[kPass][2 * j + h] = *reinterpret_cast<const uint32_t*>(&o);
      const float x0 = __low2float(o), x1 = __high2float(o);
      if (kHead == kSigmaHead) {
        dot[h][0] = __fmaf_rn(x0, sm.wsig[c], dot[h][0]);
        dot[h][0] = __fmaf_rn(x1, sm.wsig[c + 1], dot[h][0]);
      } else if (kHead == kRgbHead) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          dot[h][q] = __fmaf_rn(x0, sm.wrgb[3 * c + q], dot[h][q]);
          dot[h][q] = __fmaf_rn(x1, sm.wrgb[3 * c + 3 + q], dot[h][q]);
        }
      }
    }
  }
  if constexpr (!kLast) return;
  if (kHead != kNoHead) {
    constexpr int kQ = kHead == kSigmaHead ? 1 : 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float x = dot[h][q];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (lane % 4 == 0) sm.red[4 * (64 * wg + r0 + 8 * h) + (kHead == kSigmaHead ? 3 : q)] = x;
      }
    }
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
  if (prm.train) {
    bf16* dst = L < prm.n ? prm.stash.h[L] : L == prm.n ? prm.stash.features : prm.stash.rf;
    store_tile<kTile>(dst, p0, 0, rows, l.n, sm.act, ct, kConsumers);
  }
}

// One product at u = 768: every pass of each warpgroup's half.
template <int kHead>
__device__ __forceinline__ void run_layer_wide(const FwdParams& prm, const Smem& sm, int L,
                                               int& g, int p0, int rows) {
  const Layer l = layer_of(prm, L);
  uint32_t hold[2][32];
  float dot[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  if constexpr (kHead == kRgbHead) {
    wide_pass<128, kHead, 0, false>(prm, sm, L, l, g, hold, dot, p0, rows);
    wide_pass<64, kHead, 1, true>(prm, sm, L, l, g, hold, dot, p0, rows);
  } else {
    wide_pass<128, kHead, 0, false>(prm, sm, L, l, g, hold, dot, p0, rows);
    wide_pass<128, kHead, 1, false>(prm, sm, L, l, g, hold, dot, p0, rows);
    wide_pass<128, kHead, 2, true>(prm, sm, L, l, g, hold, dot, p0, rows);
  }
}

// The consumers' prologue: the heads' columns into shared memory as float32,
// and in the ray-march modes the encoding tile (zero past the last point)
// and, in the train mode, its copy to the stash.
template <int kTile, bool kEncIn>
__device__ __forceinline__ void prologue(const FwdParams& prm, const Smem& sm, int p0,
                                         int rows) {
  const int ct = threadIdx.x - 128;
  const int u = prm.u, ld = u + kEncLanes;
  for (int c = ct; c < u; c += kConsumers)
    sm.wsig[c] = __bfloat162float(prm.w.w_sf[(size_t)c * ld + u]);
  if (prm.sf_enc_on)
    for (int c = ct; c < kEncLanes; c += kConsumers)
      sm.wsig_enc[c] = __bfloat162float(prm.w.w_sf_enc[(size_t)c * ld + u]);
  if (prm.products > prm.n)
    for (int i = ct; i < u / 2 * 3; i += kConsumers)
      sm.wrgb[i] = __bfloat162float(prm.w.w_rgb[(i / 3) * kEncLanes + i % 3]);
  if (!kEncIn) {
    // Positional encoding of the tile's points (ray_march.py:1259-1280),
    // 8 lanes (one 16-byte chunk) per thread and step.
    for (int v = ct; v < kTile * (kEncLanes / 8); v += kConsumers) {
      const int r = v / (kEncLanes / 8), c = (v % (kEncLanes / 8)) * 8;
      uint32_t q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x0 = 0.f, x1 = 0.f;
        if (r < rows) {
          x0 = encode_lane(prm.base, prm.slope, prm.depths, prm.masks, p0 + r, c + 2 * e, prm.S);
          x1 = encode_lane(prm.base, prm.slope, prm.depths, prm.masks, p0 + r, c + 2 * e + 1,
                           prm.S);
        }
        const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
        q[e] = *reinterpret_cast<const uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(sm.enc + swz<kTile>(r, c)) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
  if (kEncIn) {
    gmma::mbar_wait(sm.enc_full, 0);
  } else if (prm.train) {
    store_tile<kTile>(prm.stash.enc, p0, 0, rows, kEncLanes, sm.enc, ct, kConsumers);
  }
}

// The outputs of the tile's points: sigma = relu(h . w_sf[:, u] (+ enc .
// w_sf_enc[:, u]) + b_sf[u]); rgb = sigmoid(rf . w_rgb[:, 0..2] + b_rgb).
// At u = 256 each warpgroup writes its own rows.
template <int kTile>
__device__ __forceinline__ void write_out(const FwdParams& prm, const Smem& sm, int p0,
                                          int rows) {
  constexpr bool kSplitCols = kTile == 64;
  const int ct = threadIdx.x - 128;
  const bool sigma_only = prm.products == prm.n;
  const int r0 = kSplitCols ? 0 : 64 * (ct / 128), r1 = kSplitCols ? rows : min(r0 + 64, rows);
  const int step = kSplitCols ? kConsumers : 128;
  for (int r = r0 + (kSplitCols ? ct : ct % 128); r < r1; r += step) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = sm.red[4 * r + q];
      if (kSplitCols) v[q] = __fadd_rn(v[q], sm.red[4 * (64 + r) + q]);
    }
    if (prm.sf_enc_on) {
      float e = 0.f;
      for (int c = 0; c < kEncLanes; ++c) {
        const bf16 x = *reinterpret_cast<const bf16*>(sm.enc + swz<kTile>(r, c));
        e = __fmaf_rn(__bfloat162float(x), sm.wsig_enc[c], e);
      }
      v[3] = __fadd_rn(v[3], e);
    }
    const int p = p0 + r;
    const float sig = fmaxf(__fadd_rn(v[3], prm.w.b_sf[prm.u]), 0.f);
    if (sigma_only) {
      prm.out[p] = sig;
      continue;
    }
    float4 o;
    o.x = 1.f / (1.f + expf(-__fadd_rn(v[0], prm.w.b_rgb[0])));
    o.y = 1.f / (1.f + expf(-__fadd_rn(v[1], prm.w.b_rgb[1])));
    o.z = 1.f / (1.f + expf(-__fadd_rn(v[2], prm.w.b_rgb[2])));
    o.w = sig;
    reinterpret_cast<float4*>(prm.out)[p] = o;
  }
}

template <int kUnits, bool kEncIn>
__global__ void __launch_bounds__(kThreads, 1)
mlp_forward_kernel(const __grid_constant__ FwdParams prm) {
  constexpr int kTile = tile_of(kUnits);
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.act = base;
  sm.enc = sm.act + 2 * kTile * kUnits;
  sm.ring = sm.enc + kTile * 2 * kEncLanes;
  sm.red = reinterpret_cast<float*>(sm.ring + kStages * kStageBytes);
  sm.wsig = sm.red + 128 * 4;
  sm.wsig_enc = sm.wsig + kMaxUnits;
  sm.wrgb = sm.wsig_enc + kEncLanes;
  sm.full = reinterpret_cast<uint64_t*>(sm.red + kFloats);
  sm.empty = sm.full + kStages;
  sm.enc_full = sm.empty + kStages;

  const int p0 = blockIdx.x * kTile;
  const int rows = min(kTile, prm.P - p0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    gmma::mbar_init(sm.enc_full, 1);
    gmma::fence_barrier_init();
  }
  __syncthreads();

  // The producer warpgroup gives its registers to the consumers: 128 x 40 +
  // 256 x 232 = 384 x 168, the budget of one block of 384 threads.
  if (threadIdx.x < 128) {
    gmma::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce<kUnits, kEncIn>(prm, sm, p0);
    return;
  }
  gmma::setmaxnreg_inc<232>();
  prologue<kTile, kEncIn>(prm, sm, p0, rows);
  int g = 0;
  if constexpr (kUnits == 768) {
    for (int L = 0; L < prm.n - 1; ++L) run_layer_wide<kNoHead>(prm, sm, L, g, p0, rows);
    run_layer_wide<kSigmaHead>(prm, sm, prm.n - 1, g, p0, rows);
    if (prm.products > prm.n) {
      run_layer_wide<kNoHead>(prm, sm, prm.n, g, p0, rows);
      run_layer_wide<kRgbHead>(prm, sm, prm.n + 1, g, p0, rows);
    }
  } else {
    for (int L = 0; L < prm.n - 1; ++L) run_layer<kTile, 256, kNoHead>(prm, sm, L, g, p0, rows);
    run_layer<kTile, 256, kSigmaHead>(prm, sm, prm.n - 1, g, p0, rows);
    if (prm.products > prm.n) {
      run_layer<kTile, 256, kNoHead>(prm, sm, prm.n, g, p0, rows);
      run_layer<kTile, 128, kRgbHead>(prm, sm, prm.n + 1, g, p0, rows);
    }
  }
  write_out<kTile>(prm, sm, p0, rows);
}

// Dynamic shared memory of the kernel at tile `tile` and width `units`
// (mirrored by ray_march_mlp_plan): activation tile, encoding tile, ring,
// the float32 area, 2 kStages + 1 mbarriers and the 1024-byte alignment.
constexpr int smem_bytes(int tile, int units) {
  return 1024 + 2 * tile * units + tile * 2 * kEncLanes + kStages * kStageBytes + 4 * kFloats +
         8 * (2 * kStages + 1);
}
static_assert(smem_bytes(128, 256) <= 232448 && smem_bytes(64, 512) <= 232448 &&
                  smem_bytes(64, 768) <= 232448,
              "ray_march_mlp exceeds the H100's 227 KB of shared memory");

template <int kUnits, bool kEncIn>
int launch_tile(const FwdParams& prm, cudaStream_t stream) {
  constexpr int kTile = tile_of(kUnits), kSmem = smem_bytes(kTile, kUnits);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(mlp_forward_kernel<kUnits, kEncIn>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int blocks = (prm.P + kTile - 1) / kTile;
  mlp_forward_kernel<kUnits, kEncIn><<<blocks, kThreads, kSmem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <bool kEncIn>
int launch_width(const FwdParams& prm, cudaStream_t stream) {
  if (prm.u == 256) return launch_tile<256, kEncIn>(prm, stream);
  if (prm.u == 512) return launch_tile<512, kEncIn>(prm, stream);
  return launch_tile<768, kEncIn>(prm, stream);
}

// Returns 0, a cudaError_t, or -CUresult when a tensor map cannot be encoded.
int launch(const MlpWeights* w, const float* base, const float* slope, const float* depths,
           const float* masks, const bf16* enc_in, float* out, int P, int S, bool sigma_only,
           const MlpStash* stash, void* stream) {
  const int u = w->units, n = w->n_layers;
  if (n < 1 || n > kMaxLayers || (u != 256 && u != 512 && u != 768))
    return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const int tile = tile_of(u);

  FwdParams prm{};  // copied into the launch's parameters
  int err = 0;
  for (int i = 0; i < n && !err; ++i) {
    err = gmma::encode_map(fn, &prm.trunk[i], w->trunk_w[i], u, i == 0 ? kEncLanes : u, 64);
    if (!err && w->trunk_enc_w[i] != nullptr) {
      err = gmma::encode_map(fn, &prm.trunk_enc[i], w->trunk_enc_w[i], u, kEncLanes, 64);
      prm.enc_layers |= 1 << i;
    }
  }
  if (!err) err = gmma::encode_map(fn, &prm.sf, w->w_sf, u + kEncLanes, u, 64);
  if (!err && w->w_sf_enc != nullptr)
    err = gmma::encode_map(fn, &prm.sf_enc, w->w_sf_enc, u + kEncLanes, kEncLanes, 64);
  if (!err) err = gmma::encode_map(fn, &prm.rf_top, w->w_rf_top, u / 2, u, 64);
  if (!err) err = gmma::encode_map(fn, &prm.rf_enc, w->w_rf_enc, u / 2, kEncLanes, 64);
  if (!err && enc_in != nullptr)
    err = gmma::encode_map(fn, &prm.enc_in, enc_in, kEncLanes, P, tile);
  if (err) return -err;
  prm.w = *w;
  prm.base = base;
  prm.slope = slope;
  prm.depths = depths;
  prm.masks = masks;
  prm.out = out;
  if (stash != nullptr) prm.stash = *stash;
  prm.P = P;
  prm.S = S;
  prm.u = u;
  prm.n = n;
  prm.products = sigma_only ? n : n + 2;
  prm.sf_enc_on = w->w_sf_enc != nullptr;
  prm.train = stash != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  return enc_in != nullptr ? launch_width<true>(prm, s) : launch_width<false>(prm, s);
}

}  // namespace

// w: the packed weights (u = 256, 512 or 768); base, slope: [rays, 128]; depths:
// [rays, S]; masks: [3, 128] raw/sin/cos lane selectors; out: [rays * S, 4]
// (r, g, b, sigma) or [rays * S] sigma; stash: null, or (full mode only) the
// arrays of the train mode. Returns 0, a cudaError_t, or -CUresult when a
// tensor map cannot be encoded.
KNT_EXPORT int knt_ray_march_mlp(const MlpWeights* w, const float* base,
                                 const float* slope, const float* depths,
                                 const float* masks, float* out, int rays,
                                 int S, int sigma_only, const MlpStash* stash,
                                 void* stream) {
  const long long points = (long long)rays * S;
  if (points <= 0) return 0;
  if (points > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (stash != nullptr && sigma_only) return (int)cudaErrorInvalidValue;
  return launch(w, base, slope, depths, masks, nullptr, out, (int)points, S, sigma_only != 0,
                stash, stream);
}

// enc: [P, 128] bf16 encoded points (16-byte aligned); out: [P, 4] (r, g,
// b, sigma); stash: null, or the recompute's arrays, whose enc block is
// `enc` itself.
KNT_EXPORT int knt_apply_mlp(const MlpWeights* w, const bf16* enc, float* out,
                             int P, const MlpStash* stash, void* stream) {
  if (P <= 0) return 0;
  if (stash != nullptr && stash->enc != enc) return (int)cudaErrorInvalidValue;
  return launch(w, nullptr, nullptr, nullptr, nullptr, enc, out, P, 1, false, stash, stream);
}
