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
// * Ablation builds (profile_ablate, never the package's library): on the
//   resident route KNT_ABL_NOENC skips the encoding tile, KNT_ABL_NOEPI the
//   trunk epilogues' bias and relu, KNT_ABL_NOSTASH the train mode's stash
//   stores; KNT_ABL_NOSIN acts in encode.cuh. Each computes the wrong
//   function on purpose.
#include <cuda.h>

#include <cstring>

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
#if defined(KNT_ABL_NOEPI)
      // profile_ablate's noepi build: no bias, no relu (wrong math).
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
#else
      float v0 = __fadd_rn(acc[4 * j + 2 * h], b0);
      float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
#endif
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

#if !defined(KNT_ABL_NOSTASH)  // profile_ablate's nostash build
  if (prm.train) {
    bf16* dst = L < prm.n ? prm.stash.h[L] : L == prm.n ? prm.stash.features : prm.stash.rf;
    if (kSplitCols)
      store_tile<kTile>(dst, p0, 0, rows, l.n, sm.act, ct, kConsumers);
    else
      store_tile<kTile>(dst, p0, a_row, min(a_row + 64, rows), l.n, sm.act, t, 128);
  }
#endif
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
#if defined(KNT_ABL_NOEPI)
      // profile_ablate's noepi build: no bias, no relu (wrong math).
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
#else
      float v0 = __fadd_rn(acc[4 * j + 2 * h], b0);
      float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
#endif
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
#if !defined(KNT_ABL_NOSTASH)
  if (prm.train) {
    bf16* dst = L < prm.n ? prm.stash.h[L] : L == prm.n ? prm.stash.features : prm.stash.rf;
    store_tile<kTile>(dst, p0, 0, rows, l.n, sm.act, ct, kConsumers);
  }
#endif
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
#if !defined(KNT_ABL_NOENC)  // profile_ablate's noenc build: no encoding tile
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
#endif
  gmma::fence_proxy_async();
  gmma::bar_sync(kFullBar, kConsumers);
  if (kEncIn) {
    gmma::mbar_wait(sm.enc_full, 0);
  }
#if !defined(KNT_ABL_NOSTASH)
  else if (prm.train) {
    store_tile<kTile>(prm.stash.enc, p0, 0, rows, kEncLanes, sm.enc, ct, kConsumers);
  }
#endif
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

// ---- the persistent route: the no-grad ray-march modes at u = 256 --------
//
// The kernel above builds each 128-point tile's encoding before the tile's
// first product, then stops both consumer warpgroups at every layer (wgmma
// wait 0, a named barrier, the epilogue into the activation tile, a proxy
// fence, a second barrier) while the tensor cores idle; every block starts
// from nothing (barriers, ring, heads' columns). ray_march_mlp_plan takes
// this kernel instead where the call allows it (u = 256, at most kMaxLayers
// layers, no stash, the encoding built in the kernel: knt_ray_march_mlp's
// sigma-only and full modes); the same math, bit for bit, in another
// schedule:
// * Persistent: min(tiles, SMs) blocks of 384 threads, block b walking
//   tiles b, b + gridDim.x, ... The weights' order repeats every tile, so
//   the producer thread's ring (8 stages of [64 K x 128 N]) runs on across
//   tiles; barriers and the heads' float32 columns are set up once.
// * The activations stay in registers: each consumer warpgroup owns 64 rows
//   and every column, and a layer's bf16 outputs, packed from its m64nNk16
//   accumulators, are the A registers of the next product's k16 steps
//   (gmma.cuh: mma_rs_m64n128k16), 64 registers a thread. A product runs as two
//   halves of 128 columns, 64 accumulators each; the first half's outputs
//   wait packed (32 registers) until the second's products have read the
//   A registers: 160 at most, where a whole 256-column product beside its
//   A registers took 192 and ptxas spilled and serialized the products
//   (C7512). There is no activation tile, so no barrier or proxy fence
//   between layers. The encoding is read from shared memory (a K-major A),
//   as the first layer, the skip layers, the features' and rf's second K
//   runs and the sigma head's encoding part need it.
// * The encoding is built off the critical path: warps 1-3 of the producer
//   warpgroup build tile i + 1's into the second of two encoding tiles while
//   the consumers multiply tile i, from encode.cuh's lane_kind /
//   encode_value (each thread keeps one 16-byte chunk of lanes, its kinds
//   read once, its ray's base and slope as float4s, four lanes at a time
//   within the producer warpgroup's 40 registers), and hand it over by
//   mbarrier (enc_full; enc_empty back once both warpgroups have finished
//   the tile).
// * Epilogues under the other warpgroup's products: each warpgroup runs a
//   half's products, then that half's epilogue (bias, relu, bf16 into its A
//   registers, the sigma and rgb dots), and the two drift apart over the
//   ring (a warpgroup waits only for the producer, which waits for both to
//   release a stage eight back), so one's epilogue runs while the other
//   issues. Ordering them strictly in turns of four stages by mbarriers
//   was 6% slower on an H100 (a 4096 x 192 full-mode launch, 1.71 against
//   1.61 ms).
// * The heads' dots meet in each quad by shuffles and its first thread
//   writes its two rows' outputs (the sigma head's encoding part read from
//   shared memory), in write_out's order above.
// * Shared memory: ring 128 KB + two encoding tiles 64 KB + the heads'
//   float32 columns 3 KB + 20 mbarriers + 1 KB of alignment = 196.2 KB
//   (mirrored by ray_march_mlp_plan), one block an SM.
// * No atomics and the resident kernel's k order: the same bits.
namespace persistent {

constexpr int kTile = 128;                        // points a tile, 64 rows a warpgroup
constexpr int kUnits = 256;
constexpr int kHalf = 128;                        // output columns a product's half
constexpr int kStages = 8;                        // ring stages of [64 K x 128 N]
constexpr int kStageBytes = 2 * kBox;
constexpr int kEncBytes = kTile * 2 * kEncLanes;  // one encoding tile
constexpr int kEncoders = 96;                     // warps 1-3 of the producer warpgroup
// float32 area: w_sf[:, u] [u], w_sf_enc[:, u] [128], w_rgb[:, 0..2] [u / 2][3].
constexpr int kFloats = kUnits + kEncLanes + kUnits / 2 * 3;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kEncBytes + 4 * kFloats +
                           8 * (2 * kStages + 4);
static_assert(kSmemBytes <= 232448, "the persistent route exceeds the H100's 227 KB");

struct PSmem {
  uint8_t* ring;
  uint8_t* enc;        // two encoding tiles
  float* wsig;         // w_sf[:, u]
  float* wsig_enc;     // w_sf_enc[:, u]
  float* wrgb;         // w_rgb[:, 0..2]
  uint64_t* full;      // kStages
  uint64_t* empty;     // kStages
  uint64_t* enc_full;  // 2
  uint64_t* enc_empty; // 2
};

__device__ __forceinline__ int tiles_of(const FwdParams& prm) { return (prm.P + kTile - 1) / kTile; }

// The producer thread: every stage of every product of every tile the block
// walks, in the order the consumers use them (each half of a product's
// columns in turn, its K runs in order).
__device__ void produce(const FwdParams& prm, const PSmem& sm) {
  const int tiles = tiles_of(prm);
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int L = 0; L < prm.products; ++L) {
      const Layer l = layer_of(prm, L);
      for (int half = 0; half < l.n / kHalf; ++half) {
        for (int run = 0; run < 2; ++run) {
          for (int ks = 0; ks < l.slabs[run]; ++ks, ++g) {
            const int s = g % kStages;
            gmma::mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
            gmma::mbar_arrive_expect_tx(&sm.full[s], kStageBytes);
            for (int b = 0; b < 2; ++b)
              gmma::tma_load_2d(sm.ring + s * kStageBytes + b * kBox, l.map[run], &sm.full[s],
                                kHalf * half + 64 * b, 64 * ks);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Warps 1-3: the encoding of every tile the block walks (zero past the last
// point), tile k into encoding tile k % 2 once the consumers have finished
// tile k - 2. Thread e keeps lanes c .. c + 7, c = 8 (e % 16), of rows e / 16,
// e / 16 + 6, ...
__device__ void encode(const FwdParams& prm, const PSmem& sm) {
  const int e = threadIdx.x - 32;
  const int c = (e % 16) * 8;
  int kinds = 0;  // 2 bits a lane
  for (int i = 0; i < 8; ++i) kinds |= lane_kind(prm.masks, c + i) << (2 * i);
  const int tiles = tiles_of(prm);
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int b = k & 1;
    gmma::mbar_wait(&sm.enc_empty[b], ((k >> 1) & 1) ^ 1);
    uint8_t* enc = sm.enc + b * kEncBytes;
    const int p0 = tile * kTile, rows = min(kTile, prm.P - p0);
    for (int r = e / 16; r < kTile; r += kEncoders / 16) {
      const int p = p0 + r;
      const float t = r < rows ? __ldg(prm.depths + p) : 0.f;
      const size_t off = (size_t)(p / prm.S) * kEncLanes + c;
      // Four lanes at a time (8 bytes of the chunk), within 40 registers.
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        uint2 q = make_uint2(0u, 0u);
        if (r < rows) {
          const float4 bs = __ldg(reinterpret_cast<const float4*>(prm.base + off) + h);
          const float4 sl = __ldg(reinterpret_cast<const float4*>(prm.slope + off) + h);
          const int kd = kinds >> (8 * h);
          q.x = bf16x2(encode_value(t, sl.x, bs.x, kd & 3),
                       encode_value(t, sl.y, bs.y, (kd >> 2) & 3));
          q.y = bf16x2(encode_value(t, sl.z, bs.z, (kd >> 4) & 3),
                       encode_value(t, sl.w, bs.w, (kd >> 6) & 3));
        }
        *reinterpret_cast<uint2*>(enc + swz<kTile>(r, c) + 8 * h) = q;
      }
    }
    gmma::fence_proxy_async();
    gmma::mbar_arrive(&sm.enc_full[b]);
  }
}

// One ring stage of a product's half, in three steps: begin (the stage's
// data), the four k16 steps of the caller, end (commit; release the stage
// before once this one's group is the only one in flight). Ring: the next
// stage, the one to release, and the half's scale-d.
struct Ring {
  int g, pending, scale;
};

__device__ __forceinline__ uint64_t begin_stage(const PSmem& sm, Ring& is,
                                                float (&acc)[kHalf / 2]) {
  const int s = is.g % kStages;
  gmma::mbar_wait(&sm.full[s], (is.g / kStages) & 1);
  gmma::fence_operands(acc);
  gmma::fence();
  return gmma::desc_sw128(sm.ring + s * kStageBytes, kBox, 1024);
}

__device__ __forceinline__ void end_stage(const PSmem& sm, Ring& is, float (&acc)[kHalf / 2]) {
  gmma::commit();
  gmma::fence_operands(acc);
  gmma::wait<1>();
  gmma::fence_operands(acc);
  if (is.pending >= 0 && threadIdx.x % 32 == 0) gmma::mbar_arrive(&sm.empty[is.pending]);
  is.pending = is.g % kStages;
  ++is.g;
}

// Product L for consumer warpgroup wg over its 64 rows, kHalves halves of
// 128 columns in turn: each half's K runs from the A registers (every
// product after the first) and the encoding tile `enc` (its rows) into 64
// accumulators, then its epilogue (bias, relu on the trunk, bf16) and the
// head's dots, summed over each quad into head[h] (r, g, b, sigma). The
// first half's bf16 outputs wait in `held` while the second still reads
// `a`: 64 + 32 + 64 registers at most. A two-half product leaves its
// outputs in `a`, the next product's A registers; rf (one half) feeds the
// rgb head alone.
template <int kHalves, int kHead>
__device__ __forceinline__ void run_layer(const FwdParams& prm, const PSmem& sm, int L,
                                          const uint8_t* enc, uint32_t (&a)[64], Ring& is,
                                          float (&head)[2][4]) {
  const int lane = threadIdx.x % 32;
  const Layer l = layer_of(prm, L);
  const bool relu = L < prm.n;
  // The encoding's K runs: the first product's (one or two), or a second.
  const int enc_slabs = l.enc0 ? l.slabs[0] + l.slabs[1] : l.slabs[1];
  float dot[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  uint32_t held[32];
#pragma unroll
  for (int half = 0; half < kHalves; ++half) {
    float acc[kHalf / 2];
    is.pending = -1;
    is.scale = 0;  // the half's first step overwrites the accumulators
    if (!l.enc0) {
      gmma::fence_operands(a);
#pragma unroll
      for (int ks = 0; ks < kUnits / 64; ++ks) {
        const uint64_t db = begin_stage(sm, is, acc);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = 16 * ks + 4 * k;
          gmma::mma_rs_m64n128k16<1>(acc, a[r], a[r + 1], a[r + 2], a[r + 3],
                                     db + (k * 2048 >> 4), is.scale);
          is.scale = 1;
        }
        end_stage(sm, is, acc);
      }
    }
    for (int ks = 0; ks < enc_slabs; ++ks) {
      const uint64_t db = begin_stage(sm, is, acc);
      const uint64_t da = gmma::desc_sw128_kmajor(enc + (ks % (kEncLanes / 64)) * kTile * 128);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gmma::mma_m64k16<kHalf, 0, 1>(acc, da + 2 * k, db + (k * 2048 >> 4), is.scale);
        is.scale = 1;
      }
      end_stage(sm, is, acc);
    }
    gmma::wait<0>();
    gmma::fence_operands(acc);
    if (is.pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[is.pending]);

#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int c = kHalf * half + 8 * j + 2 * (lane % 4);
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
        const uint32_t bits = *reinterpret_cast<const uint32_t*>(&o);
        if (kHalves == 2 && half == 0) held[2 * j + h] = bits;
        if (kHalves == 2 && half == 1) a[32 + 2 * j + h] = bits;
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
  }
  if (kHalves == 2) {
#pragma unroll
    for (int r = 0; r < 32; ++r) a[r] = held[r];
    gmma::fence_operands(a);
  }
  if (kHead != kNoHead) {
    constexpr int kQ = kHead == kSigmaHead ? 1 : 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float x = dot[h][q];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        head[h][kHead == kSigmaHead ? 3 : q] = x;
      }
    }
  }
}

// The outputs of the quad's two rows, by its first thread, as write_out above.
__device__ __forceinline__ void write_rows(const FwdParams& prm, const PSmem& sm,
                                           const uint8_t* enc, int p0, int rows, int row0,
                                           const float (&head)[2][4]) {
  const bool sigma_only = prm.products == prm.n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= rows) continue;
    float v3 = head[h][3];
    if (prm.sf_enc_on) {
      float e = 0.f;
      for (int c = 0; c < kEncLanes; ++c) {
        const bf16 x = *reinterpret_cast<const bf16*>(enc + swz<kTile>(r, c));
        e = __fmaf_rn(__bfloat162float(x), sm.wsig_enc[c], e);
      }
      v3 = __fadd_rn(v3, e);
    }
    const int p = p0 + r;
    const float sig = fmaxf(__fadd_rn(v3, prm.w.b_sf[prm.u]), 0.f);
    if (sigma_only) {
      prm.out[p] = sig;
      continue;
    }
    float4 o;
    o.x = 1.f / (1.f + expf(-__fadd_rn(head[h][0], prm.w.b_rgb[0])));
    o.y = 1.f / (1.f + expf(-__fadd_rn(head[h][1], prm.w.b_rgb[1])));
    o.z = 1.f / (1.f + expf(-__fadd_rn(head[h][2], prm.w.b_rgb[2])));
    o.w = sig;
    reinterpret_cast<float4*>(prm.out)[p] = o;
  }
}

// Consumer warpgroup wg: its 64 rows of every tile the block walks.
__device__ void consume(const FwdParams& prm, const PSmem& sm) {
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
  const int tiles = tiles_of(prm);
  uint32_t a[64];  // the current product's input, bf16 pairs as wgmma A registers
  Ring is{0, -1, 0};
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int b = k & 1;
    const uint8_t* enc = sm.enc + b * kEncBytes;
    const uint8_t* own = enc + wg * 64 * 128;  // this warpgroup's rows of each 64-lane box
    gmma::mbar_wait(&sm.enc_full[b], (k >> 1) & 1);
    float head[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int L = 0; L < prm.n - 1; ++L) run_layer<2, kNoHead>(prm, sm, L, own, a, is, head);
    run_layer<2, kSigmaHead>(prm, sm, prm.n - 1, own, a, is, head);
    if (prm.products > prm.n) {
      run_layer<2, kNoHead>(prm, sm, prm.n, own, a, is, head);
      run_layer<1, kRgbHead>(prm, sm, prm.n + 1, own, a, is, head);
    }
    const int p0 = tile * kTile;
    if (lane % 4 == 0)
      write_rows(prm, sm, enc, p0, min(kTile, prm.P - p0), 64 * wg + 16 * warp + lane / 4, head);
    __syncwarp();
    if (lane == 0) gmma::mbar_arrive(&sm.enc_empty[b]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_forward_kernel(const __grid_constant__ FwdParams prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  PSmem sm;
  sm.ring = base;
  sm.enc = sm.ring + kStages * kStageBytes;
  sm.wsig = reinterpret_cast<float*>(sm.enc + 2 * kEncBytes);
  sm.wsig_enc = sm.wsig + kUnits;
  sm.wrgb = sm.wsig_enc + kEncLanes;
  sm.full = reinterpret_cast<uint64_t*>(sm.wsig + kFloats);
  sm.empty = sm.full + kStages;
  sm.enc_full = sm.empty + kStages;
  sm.enc_empty = sm.enc_full + 2;

  const int ld = kUnits + kEncLanes;
  for (int c = threadIdx.x; c < kUnits; c += kThreads)
    sm.wsig[c] = __bfloat162float(prm.w.w_sf[(size_t)c * ld + kUnits]);
  if (prm.sf_enc_on)
    for (int c = threadIdx.x; c < kEncLanes; c += kThreads)
      sm.wsig_enc[c] = __bfloat162float(prm.w.w_sf_enc[(size_t)c * ld + kUnits]);
  if (prm.products > prm.n)
    for (int i = threadIdx.x; i < kUnits / 2 * 3; i += kThreads)
      sm.wrgb[i] = __bfloat162float(prm.w.w_rgb[(i / 3) * kEncLanes + i % 3]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      gmma::mbar_init(&sm.enc_full[b], kEncoders);
      gmma::mbar_init(&sm.enc_empty[b], kConsumers / 32);
    }
    gmma::fence_barrier_init();
  }
  __syncthreads();

  // As above: 128 x 40 + 256 x 232 registers.
  if (threadIdx.x < 128) {
    gmma::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce(prm, sm);
    else if (threadIdx.x >= 32) encode(prm, sm);
    return;
  }
  gmma::setmaxnreg_inc<232>();
  consume(prm, sm);
}

// The grid: one block an SM, at most one a tile.
int launch(const FwdParams& prm, cudaStream_t stream) {
  if (prm.u != kUnits || prm.train || ((uintptr_t)prm.base | (uintptr_t)prm.slope) % 16)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (prm.P + kTile - 1) / kTile;
  mlp_forward_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmemBytes, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace persistent

// Returns 0, a cudaError_t, or -CUresult when a tensor map cannot be encoded.
// walk: the persistent route (no stash, no enc_in, u = 256).
int launch(const MlpWeights* w, const float* base, const float* slope, const float* depths,
           const float* masks, const bf16* enc_in, float* out, int P, int S, bool sigma_only,
           const MlpStash* stash, void* stream, bool walk = false) {
  const int u = w->units, n = w->n_layers;
  if (n < 1 || n > kMaxLayers || (u != 256 && u != 512 && u != 768))
    return (int)cudaErrorInvalidValue;
  if (walk && (enc_in != nullptr || stash != nullptr)) return (int)cudaErrorInvalidValue;
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
  if (walk) return persistent::launch(prm, s);
  return enc_in != nullptr ? launch_width<true>(prm, s) : launch_width<false>(prm, s);
}

// ---- the streamed route: any width (a multiple of 256), any depth ---------
//
// The kernel above keeps a layer's whole input in shared memory and its
// weights' tensor maps in fixed arrays of kMaxLayers in its parameters. At
// u >= 1024 a 64-point activation tile is >= 128 KB, and a second tile and
// the ring no longer fit beside it in 227 KB; past 16 layers the arrays run
// out. ray_march_mlp_plan picks this route for those shapes (u = 256, 512
// and 768 up to 16 layers keep the kernel above, unchanged):
// * Each product's output leaves the block as it is made, 128 columns (a
//   pass) at a time, with bf16 stores from the accumulators: to the stash in
//   the train mode (h[i] and the features, one [n + 1, P, u] array, then
//   rf), else to a ping-pong scratch of two [P, u] planes. The next product
//   reads its input back from there by TMA, one [64 points x 64 K] slab a
//   ring stage, beside the stage's [64 K x 128 N] of weights: shared memory
//   holds the ring, the encoding tile and the heads' sums at any u.
// * A tile written with plain stores and read back by TMA: every storing
//   thread runs fence.proxy.async.global, then arrives on the `ready`
//   mbarrier; the producer waits on it before it loads the next product's
//   input (gmma.cuh). The weights come first in every stage's order, so
//   nothing else waits.
// * The weights' tensor maps are read from the packed state's device table
//   (mlp.cuh: MlpTable), built once per packed state; the per-launch arrays'
//   maps (the activations, the input encoding) are parameters.
// * One consumer warpgroup owns the tile's 64 rows and every column, a pass
//   at a time (m64n128k16, 64 float32 accumulators a thread); one producer
//   warp. The heads' dots (sigma from w_sf's column u, rgb from w_rgb's
//   columns 0..2, read from device memory) are summed pass by pass in
//   registers, then over each quad. Two blocks share an SM, so one's
//   epilogue runs under the other's products.
// * Shared memory: ring 3 x 24 KB + the encoding tile 16 KB + partial head
//   sums 1 KB + 1 KB of alignment = 90.1 KB (ray_march_mlp_plan mirrors it).
// * No atomics and a fixed k order: two runs give identical bits.
namespace streamed {

constexpr int kTile = 64;                          // points per block
constexpr int kStages = 3;
constexpr int kABytes = kTile * 128;               // A: [64 points x 64 K] bf16, one box
constexpr int kStageBytes = kABytes + 2 * kBox;    // + B: [64 K x 128 N], two boxes
constexpr int kPass = 128;                         // output columns a pass
constexpr int kConsumers = 128;                    // one warpgroup
constexpr int kThreads = kConsumers + 32;          // and the producer warp
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kABytes + 4 * 4 * kTile +
                           8 * (2 * kStages + 2);

struct Params {
  CUtensorMap x;        // [planes, P, u] bf16: the stash's h and features, or the scratch
  CUtensorMap enc_in;   // input mode: [P, 128]
  const void* table;    // MlpTable
  const float* base;
  const float* slope;
  const float* depths;
  const float* masks;
  float* out;
  bf16* x_ptr;          // x's array
  bf16* enc_out;        // the train mode's stash enc (null in the input mode)
  bf16* rf_out;         // the train mode's stash rf, else null
  int P, S, u, n, products, train, enc_in_mode;
};

// Product L of the chain, as layer_of above: W over the activations (the
// encoding for layer 0), then W over the encoding where it has one.
struct SLayer {
  const CUtensorMap* map[2];
  int slabs[2];  // 64-row K slabs of each run (0: no run)
  bool enc0;
  int n;         // output columns
  const float* bias;
};

__device__ __forceinline__ SLayer layer_of(const Params& prm, const MlpTable& t, int L) {
  SLayer l;
  l.enc0 = L == 0;
  l.slabs[0] = L == 0 ? kEncLanes / 64 : prm.u / 64;
  l.n = prm.u;
  bool enc;
  if (L < prm.n) {
    l.map[0] = &t.trunk[L];
    l.map[1] = &t.trunk_enc[L];
    enc = L > 0 && t.trunk_enc_w[L] != nullptr;
    l.bias = t.trunk_b[L];
  } else if (L == prm.n) {
    l.map[0] = &t.heads[kMapSf];
    l.map[1] = &t.heads[kMapSfEnc];
    enc = t.w->w_sf_enc != nullptr;
    l.bias = t.w->b_sf;
  } else {
    l.map[0] = &t.heads[kMapRfTop];
    l.map[1] = &t.heads[kMapRfEnc];
    enc = true;
    l.bias = t.w->b_rf;
    l.n = prm.u / 2;
  }
  l.slabs[1] = enc ? kEncLanes / 64 : 0;
  return l;
}

// The plane of x that product L (<= n) writes.
__device__ __forceinline__ int plane_of(const Params& prm, int L) { return prm.train ? L : L & 1; }

struct SSmem {
  uint8_t* ring;
  uint8_t* enc;      // the encoding tile, [64 x 128] bf16
  float* red;        // partial head sums: [row][r, g, b, sigma]
  uint64_t* full;    // kStages
  uint64_t* empty;   // kStages
  uint64_t* enc_full;
  uint64_t* ready;   // a product's output is in device memory
};

// The producer thread: the input tile (input mode), then every stage of
// every product, each product's input once the product before has written
// it.
__device__ void produce(const Params& prm, const SSmem& sm, int p0) {
  const MlpTable t = table_of(prm.table, prm.n);
  if (prm.enc_in_mode) {
    gmma::mbar_arrive_expect_tx(sm.enc_full, 2 * kABytes);
    for (int b = 0; b < kEncLanes / 64; ++b)
      gmma::tma_load_2d(sm.enc + b * kABytes, &prm.enc_in, sm.enc_full, 64 * b, p0);
  }
  int g = 0;
  for (int L = 0; L < prm.products; ++L) {
    const SLayer l = layer_of(prm, t, L);
    if (L > 0) gmma::mbar_wait(sm.ready, (L - 1) & 1);
    const int plane = L > 0 ? plane_of(prm, L - 1) : 0;
    for (int pass = 0; pass < l.n / kPass; ++pass) {
      for (int run = 0; run < 2; ++run) {
        for (int ks = 0; ks < l.slabs[run]; ++ks, ++g) {
          const int s = g % kStages;
          uint8_t* st = sm.ring + s * kStageBytes;
          const bool a = run == 0 && !l.enc0;
          gmma::mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
          gmma::mbar_arrive_expect_tx(&sm.full[s], 2 * kBox + (a ? kABytes : 0));
          for (int b = 0; b < 2; ++b)
            gmma::tma_load_2d(st + kABytes + b * kBox, l.map[run], &sm.full[s],
                              kPass * pass + 64 * b, 64 * ks);
          if (a) gmma::tma_load_3d(st, &prm.x, &sm.full[s], 64 * ks, p0, plane);
        }
      }
    }
  }
}

// One product: every pass's products into float32 accumulators, the
// epilogue (bias, relu on the trunk, bf16) stored from the registers, the
// head's dots summed along.
template <int kHead>
__device__ __forceinline__ void run_layer(const Params& prm, const MlpTable& t, const SSmem& sm,
                                          int L, int& g, int p0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const SLayer l = layer_of(prm, t, L);
  const int r0 = 16 * warp + lane / 4;
  const bool relu = L < prm.n;
  bf16* dst = L <= prm.n ? prm.x_ptr + (size_t)plane_of(prm, L) * prm.P * prm.u : prm.rf_out;
  const size_t ld_sf = prm.u + kEncLanes;
  const bf16* wsig = t.w->w_sf + prm.u;  // column u of w_sf, row stride ld_sf
  const bf16* wrgb = t.w->w_rgb;
  float dot[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int pass = 0; pass < l.n / kPass; ++pass) {
    float acc[kPass / 2];
    int scale = 0;     // the pass's first product overwrites the accumulators
    int pending = -1;  // the stage of the last committed group
    for (int run = 0; run < 2; ++run) {
      for (int ks = 0; ks < l.slabs[run]; ++ks, ++g) {
        const int s = g % kStages;
        const uint8_t* st = sm.ring + s * kStageBytes;
        gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
        const uint8_t* a = run == 1 || l.enc0 ? sm.enc + ks * kABytes : st;
        const uint64_t da = gmma::desc_sw128_kmajor(a);
        const uint64_t db = gmma::desc_sw128(st + kABytes, kBox, 1024);
        gmma::fence_operands(acc);
        gmma::fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          gmma::mma_m64k16<kPass, 0, 1>(acc, da + 2 * k, db + (k * 2048 >> 4), scale);
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

#pragma unroll
    for (int j = 0; j < kPass / 8; ++j) {
      const int c = kPass * pass + 8 * j + 2 * (lane % 4);
      const float b0 = __ldg(l.bias + c), b1 = __ldg(l.bias + c + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fadd_rn(acc[4 * j + 2 * h], b0);
        float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        const int r = r0 + 8 * h;
        if (dst != nullptr && r < rows)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(p0 + r) * l.n + c) = o;
        const float x0 = __low2float(o), x1 = __high2float(o);
        if (kHead == kSigmaHead) {
          dot[h][0] = __fmaf_rn(x0, __bfloat162float(wsig[c * ld_sf]), dot[h][0]);
          dot[h][0] = __fmaf_rn(x1, __bfloat162float(wsig[(c + 1) * ld_sf]), dot[h][0]);
        } else if (kHead == kRgbHead) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            dot[h][q] = __fmaf_rn(x0, __bfloat162float(wrgb[c * kEncLanes + q]), dot[h][q]);
            dot[h][q] = __fmaf_rn(x1, __bfloat162float(wrgb[(c + 1) * kEncLanes + q]), dot[h][q]);
          }
        }
      }
    }
  }
  if (kHead != kNoHead) {
    constexpr int kQ = kHead == kSigmaHead ? 1 : 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float x = dot[h][q];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (lane % 4 == 0) sm.red[4 * (r0 + 8 * h) + (kHead == kSigmaHead ? 3 : q)] = x;
      }
    }
  }
  // The next product reads this one's output by TMA.
  if (L + 1 < prm.products) {
    gmma::fence_proxy_async_global();
    gmma::mbar_arrive(sm.ready);
  }
}

// The consumers' prologue: the encoding tile (built, or loaded in the input
// mode) and, in the train mode, its copy to the stash.
__device__ __forceinline__ void prologue(const Params& prm, const SSmem& sm, int p0, int rows) {
  const int ct = threadIdx.x;
  if (!prm.enc_in_mode) {
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
  if (prm.enc_in_mode) {
    gmma::mbar_wait(sm.enc_full, 0);
  } else if (prm.enc_out != nullptr) {
    store_tile<kTile>(prm.enc_out, p0, 0, rows, kEncLanes, sm.enc, ct, kConsumers);
  }
}

// The tile's outputs, as write_out above, from the quads' sums.
__device__ __forceinline__ void write_out(const Params& prm, const MlpTable& t, const SSmem& sm,
                                          int p0, int rows) {
  const MlpHeads* w = t.w;
  const bool sigma_only = prm.products == prm.n;
  const size_t ld_sf = prm.u + kEncLanes;
  for (int r = threadIdx.x; r < rows; r += kConsumers) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = sm.red[4 * r + q];
    if (w->w_sf_enc != nullptr) {
      float e = 0.f;
      for (int c = 0; c < kEncLanes; ++c) {
        const bf16 x = *reinterpret_cast<const bf16*>(sm.enc + swz<kTile>(r, c));
        e = __fmaf_rn(__bfloat162float(x), __bfloat162float(w->w_sf_enc[c * ld_sf + prm.u]), e);
      }
      v[3] = __fadd_rn(v[3], e);
    }
    const int p = p0 + r;
    const float sig = fmaxf(__fadd_rn(v[3], w->b_sf[prm.u]), 0.f);
    if (sigma_only) {
      prm.out[p] = sig;
      continue;
    }
    float4 o;
    o.x = 1.f / (1.f + expf(-__fadd_rn(v[0], w->b_rgb[0])));
    o.y = 1.f / (1.f + expf(-__fadd_rn(v[1], w->b_rgb[1])));
    o.z = 1.f / (1.f + expf(-__fadd_rn(v[2], w->b_rgb[2])));
    o.w = sig;
    reinterpret_cast<float4*>(prm.out)[p] = o;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
mlp_streamed_kernel(const __grid_constant__ Params prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  SSmem sm;
  sm.ring = base;
  sm.enc = sm.ring + kStages * kStageBytes;
  sm.red = reinterpret_cast<float*>(sm.enc + 2 * kABytes);
  sm.full = reinterpret_cast<uint64_t*>(sm.red + 4 * kTile);
  sm.empty = sm.full + kStages;
  sm.enc_full = sm.empty + kStages;
  sm.ready = sm.enc_full + 1;

  const int p0 = blockIdx.x * kTile;
  const int rows = min(kTile, prm.P - p0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], kConsumers / 32);
    }
    gmma::mbar_init(sm.enc_full, 1);
    gmma::mbar_init(sm.ready, kConsumers);
    gmma::fence_barrier_init();
  }
  __syncthreads();
  // Warps 0-3 are the consumer warpgroup (wgmma's warpgroups start at a
  // warp index that is a multiple of 4); warp 4 holds the producer.
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(prm, sm, p0);
    return;
  }
  prologue(prm, sm, p0, rows);
  const MlpTable t = table_of(prm.table, prm.n);
  int g = 0;
  for (int L = 0; L < prm.n - 1; ++L) run_layer<kNoHead>(prm, t, sm, L, g, p0, rows);
  run_layer<kSigmaHead>(prm, t, sm, prm.n - 1, g, p0, rows);
  if (prm.products > prm.n) {
    run_layer<kNoHead>(prm, t, sm, prm.n, g, p0, rows);
    run_layer<kRgbHead>(prm, t, sm, prm.n + 1, g, p0, rows);
  }
  gmma::bar_sync(kFullBar, kConsumers);
  write_out(prm, t, sm, p0, rows);
}

// table: the packed state's device table (n layers of u units); x: the
// output planes ([n + 1, P, u] of the stash in the train mode, else a [2,
// P, u] scratch); enc_in: the input mode's [P, 128] (else null, and base,
// slope, depths, masks give the points); enc_out, rf_out: the train mode's
// stash enc (null in the input mode) and rf. Returns 0, a cudaError_t, or
// -CUresult when a tensor map cannot be encoded.
int launch(const void* table, int n, int u, const float* base, const float* slope,
           const float* depths, const float* masks, const bf16* enc_in, float* out, int P, int S,
           bool sigma_only, bf16* x, bool train, bf16* enc_out, bf16* rf_out, void* stream) {
  if (n < 1 || u < 256 || u % 256 || (train && sigma_only) || table == nullptr || x == nullptr)
    return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  Params prm{};  // copied into the launch's parameters
  int err = gmma::encode_map_3d(fn, &prm.x, x, 2, u, P, train ? n + 1 : 2, 64, 64);
  if (!err && enc_in != nullptr) err = gmma::encode_map(fn, &prm.enc_in, enc_in, kEncLanes, P, 64);
  if (err) return -err;
  prm.table = table;
  prm.base = base;
  prm.slope = slope;
  prm.depths = depths;
  prm.masks = masks;
  prm.out = out;
  prm.x_ptr = x;
  prm.enc_out = enc_out;
  prm.rf_out = rf_out;
  prm.P = P;
  prm.S = S;
  prm.u = u;
  prm.n = n;
  prm.products = sigma_only ? n : n + 2;
  prm.train = train;
  prm.enc_in_mode = enc_in != nullptr;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int blocks = (P + kTile - 1) / kTile;
  mlp_streamed_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace streamed

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

// The persistent route (ray_march_mlp_plan's "persistent"): knt_ray_march_mlp's
// sigma-only and full modes at u = 256 (base and slope 16-byte aligned),
// the same bits.
KNT_EXPORT int knt_ray_march_mlp_persistent(const MlpWeights* w, const float* base,
                                            const float* slope, const float* depths,
                                            const float* masks, float* out, int rays, int S,
                                            int sigma_only, void* stream) {
  const long long points = (long long)rays * S;
  if (points <= 0) return 0;
  if (points > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch(w, base, slope, depths, masks, nullptr, out, (int)points, S, sigma_only != 0,
                nullptr, stream, true);
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

// The streamed route (ray_march_mlp_plan's "streamed"), both entry points'
// modes: table, the packed state's device table of n layers of u units;
// enc: the input mode's [P, 128] bf16 or null (then base, slope, depths,
// masks and S give the points, as knt_ray_march_mlp); x: the stash's h and
// features as one [n + 1, P, u] array when train, else a [2, P, u] scratch;
// enc_out: the stash's enc to write (null in the input mode); rf_out: the
// stash's rf when train. Returns 0, a cudaError_t, or -CUresult.
KNT_EXPORT int knt_mlp_streamed(const void* table, int n, int u, const float* base,
                                const float* slope, const float* depths, const float* masks,
                                const bf16* enc, float* out, int P, int S, int sigma_only,
                                bf16* x, int train, bf16* enc_out, bf16* rf_out, void* stream) {
  if (P <= 0) return 0;
  return streamed::launch(table, n, u, base, slope, depths, masks, enc, out, P, S,
                          sigma_only != 0, x, train != 0, enc_out, rf_out, stream);
}

// ---- the device tables of tensor maps ----------------------------------
//
// A kernel's fixed array of maps in its parameters holds a fixed number of
// layers; the streamed routes (here, mlp_backward.cu, ray_march_mlp_int8.cu)
// take any number, so the maps of a packed state's weights live in device
// memory instead. kernels/ray_march.py (_device_table) lays a table out,
// encodes its maps here into host memory once per packed state, appends
// the arrays' pointers and copies the whole to the card once: no launch
// encodes or copies it again.

// One map of a table: a row-major [rows, cols] array of elem_bytes-byte
// elements (2: bf16, 1: int8 codes) in boxes of 128 bytes x box_rows rows
// with the 128-byte swizzle (gmma.cuh: encode_map, encode_map_u8), read by
// tma_load_2d. Mirrored in kernels/ray_march.py (_MapSpec).
struct MapSpec {
  const void* base;  // null: the entry stays zero (an array the model lacks)
  int cols, rows, elem_bytes, box_rows;
};

// Encodes count maps into out (count x 128 bytes of host memory, any
// alignment). Returns 0, a cudaError_t, or -CUresult when a map cannot be
// encoded.
KNT_EXPORT int knt_encode_maps(const MapSpec* specs, int count, void* out) {
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  for (int i = 0; i < count; ++i) {
    CUtensorMap map;  // 64-byte aligned, as the encoder wants it
    std::memset(&map, 0, sizeof(map));
    const MapSpec& s = specs[i];
    if (s.base != nullptr) {
      if (s.elem_bytes != 1 && s.elem_bytes != 2) return (int)cudaErrorInvalidValue;
      const int e = s.elem_bytes == 2 ? gmma::encode_map(fn, &map, s.base, s.cols, s.rows, s.box_rows)
                                      : gmma::encode_map_u8(fn, &map, s.base, s.cols, s.rows, s.box_rows);
      if (e != 0) return -e;
    }
    std::memcpy(static_cast<char*>(out) + (size_t)i * sizeof(map), &map, sizeof(map));
  }
  return 0;
}
