// ray_march_mlp_int8: positional encoding and the W8A8 int8 MLP per point,
// the render tier's trunk and heads.
//
// Replaces: keras_nerf_tpu/kernels/quantize.py:248 forward_core_int8 (with
// _quant_act :238 and _doti8 :243), the trunk of _train_chunk_kernel in its
// quantized mode (keras_nerf_tpu/kernels/ray_march.py:1285-1290), full and
// sigma_only. It computes what forward_core_int8 computes, bit for bit: the
// float32 encoding of encode.cuh (as ray_march_mlp.cu), its int8 code at
// each quantization site (enc_r[0] for layer 0, enc_r[i] for a skip layer,
// enc_r_sf after a last skip, enc_r_rf for rgb_features), int8 x int8
// products with exact int32 sums, and each layer's float32 epilogue in
// forward_core_int8's order, each step rounded once (__fmul_rn / __fadd_rn,
// never contracted into an FMA): fl(fl(float(acc) u) + fl(float(acc_enc)
// u_enc)) + b, relu on the trunk only (features and rgb_features are
// linear), then the next product's code rint(h r) clipped to +-127. Sigma
// is relu'd and rgb sigmoid'ed as in ray_march_mlp.cu.
//
// Bound on the H100: operations. 8 x 256 with the 63 + 27 wide encodings is
// 1.19 MOP per point (0.98 in sigma-only mode) against 16 B written; at the
// dense int8 rate of 1,979 TOP/s a 4096 x 192 fine chunk is 0.47 ms.
//
// Design: every product is A[points, K] . W[K, N] on wgmma m64nNk32
// .s32.s8.s8 with both operands K-major in shared memory (wgmma takes no
// transpose flag for 8-bit types): the activation codes as A, and as B the
// [fan_out, fan_in] copy of W that kernels/quantize.py:
// transposed_int8_weights makes once per quantized state, streamed by TMA.
// * A block owns a tile of 64 points and has two warpgroups: a producer
//   (one thread issues the TMA loads) and one consumer warpgroup that runs
//   every product and epilogue. At u = 256 two blocks share an SM, so one
//   block's encoding and epilogues run under the other's products.
// * Activations are int8 codes, half the bytes of bf16: two ping-pong tiles
//   of [64 x u] in the 128-byte swizzled K-major layout (128-column boxes of
//   64 rows of 128 bytes). A layer reads one and writes the other, so its
//   output columns are taken in parts of 128 (64 at u = 1280), 64 (32)
//   int32 accumulators a thread, and no width depends on registers.
// * A layer that reads the encoding too (a skip layer, the features after a
//   last skip, rgb_features) has a second set of accumulators for that
//   product: its epilogue adds two dequantized sums, which one int32 sum
//   cannot give.
// * The float32 encoding tile (32 KB) is made once per block, by all 256
//   threads (a thread a lane, the lane's kind read once, the rows' depths
//   read at once), and kept; each quantization site codes it into one int8
//   tile (8 KB) before the first product that reads that site, once the
//   products that read the previous site have retired.
// * The epilogue is the kernel's largest cost, so it is lean: each part's
//   (u, b, r, u_enc) are read into shared memory while its products run
//   (from L2 in the epilogue they would stall it: beside two blocks' shared
//   memory the L1 is too small to keep them); the code is rounded by a
//   float32 add of 1.5 x 2^23 and read from the sum's low byte, with no
//   conversion instruction; a code pair's swizzled address is one XOR and
//   one add.
// * Weights stream through a ring of stages of [128 N rows x 128 K bytes]
//   (16 KB; [64 x 128] at u = 1280): full/empty mbarriers, one stage per
//   (part, K slab) in the order the consumers use them. The ring holds 2
//   stages at u = 256 (two blocks per SM), else as many as fit, at most 4.
//   The plan is mirrored in Python (kernels/ray_march.py:
//   ray_march_mlp_int8_plan), which refuses a width that does not fit
//   (above 1280) before any launch.
// * Heads: sigma (column 0 of w_sig) and rgb (columns 0..2 of w_rgb) are
//   int32 dots of the codes in the epilogue that makes them, exact in any
//   order, summed over the quad by shuffles; rgb_features' codes are never
//   stored. Sigma-only mode stops after the trunk.
// * No atomics and a fixed order: two runs give identical bits. A ring
//   fault traps (gmma::mbar_wait) instead of holding the card.
// * Ablation builds (profile_ablate, never the package's library): with
//   KNT_ABL_NOENC the encoding is not made, with KNT_ABL_NOEPI a code is
//   its accumulator's low bits; KNT_ABL_NOSIN acts in encode.cuh. Each
//   computes the wrong function on purpose.
#include <cuda.h>

#include "encode.cuh"
#include "gmma.cuh"

using namespace knt;

namespace {

constexpr int kMaxLayers = 16;
using i8 = signed char;

}  // namespace

// Device pointers of the quantize_packed arrays: int8 weights transposed,
// row-major [fan_out, fan_in] (transposed_int8_weights), float32 per-column
// vectors (u: dequantization of the product, b: bias, r: requantization of
// the activation a layer makes; enc_r*: requantization of the encoding at
// each site). Mirrored by a ctypes Structure in kernels/ray_march.py
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

constexpr int kTile = 64;                         // points per block
constexpr int kKBox = 128;                        // K bytes of a swizzled row, one TMA box
constexpr int kSlabBytes = kTile * kKBox;         // a 128-K slab of a [64 x K] code tile
constexpr int kEncBytes = kTile * kEncLanes * 4;  // the float32 encoding tile
constexpr int kMaxStages = 4;
constexpr int kThreads = 256;                     // producer + consumer warpgroups
constexpr int kSmemPerBlock = 232448;             // the H100's 227 KB a block
constexpr int kSmemPerSm = 233472;                // 228 KB an SM, 1 KB of it per block
constexpr int kBar = 1;                           // named barrier of the consumers

// The plan of shared memory, mirrored by ray_march_mlp_int8_plan. Output
// columns per part: 128 up to u = 1024, 64 above, where no 16 KB stage fits
// beside the tiles.
constexpr int part_of(int u) { return u <= 1024 ? 128 : 64; }
// Besides the ring: 1 KB of alignment, the two code tiles, the encoding's
// code tile and its float32 tile, and two parts' epilogue vectors.
constexpr int fixed_bytes(int u) {
  return 1024 + 2 * kTile * u + kSlabBytes + kEncBytes + 2 * part_of(u) * 16;
}
// A ring stage and its two mbarriers.
constexpr int stage_bytes(int u) { return part_of(u) * kKBox + 16; }
constexpr int smem_bytes(int u, int stages) { return fixed_bytes(u) + stages * stage_bytes(u); }
constexpr int most_stages(int u) { return (kSmemPerBlock - fixed_bytes(u)) / stage_bytes(u); }
// 2 stages where two blocks then share an SM, else as many as fit, at most
// kMaxStages; a width with fewer than 2 is refused.
constexpr int stages_of(int u) {
  return 2 * (smem_bytes(u, 2) + 1024) <= kSmemPerSm ? 2
         : most_stages(u) < kMaxStages               ? most_stages(u)
                                                     : kMaxStages;
}
static_assert(stages_of(256) == 2 && stages_of(1280) >= 2 && smem_bytes(1280, stages_of(1280)) <= kSmemPerBlock,
              "ray_march_mlp_int8 exceeds the H100's 227 KB of shared memory");

struct I8Params {
  CUtensorMap trunk[kMaxLayers];      // trunk_w[i]^T
  CUtensorMap trunk_enc[kMaxLayers];  // trunk_enc_w[i]^T, where bit i of skips is set
  CUtensorMap feat, feat_enc, rf_top, rf_enc;
  MlpInt8Weights w;
  const float* base;
  const float* slope;
  const float* depths;
  const float* masks;
  float* out;
  int P, S, u, n, products, stages, skips, last_enc;
};

// Product L: trunk layer L (L < n), the features (n), rgb_features (n + 1).
// Its K runs: W over the code tile (the encoding's codes for layer 0), then
// W over the encoding's codes, where the product has one.
struct Layer {
  const CUtensorMap* map[2];
  int slabs[2];  // 128-K slabs of each run (0: no run)
  bool enc0;     // the first run reads the encoding's codes
  bool relu;
  int n;         // output columns
  const float* u;
  const float* u_enc;
  const float* b;
  const float* r;
};

__device__ __forceinline__ Layer layer_of(const I8Params& prm, int L) {
  const MlpInt8Weights& w = prm.w;
  Layer l;
  l.enc0 = L == 0;
  l.relu = L < prm.n;
  l.slabs[0] = L == 0 ? 1 : prm.u / kKBox;
  l.n = prm.u;
  if (L < prm.n) {
    l.map[0] = &prm.trunk[L];
    l.map[1] = (prm.skips >> L) & 1 ? &prm.trunk_enc[L] : nullptr;
    l.u = w.trunk_u[L];
    l.u_enc = w.trunk_enc_u[L];
    l.b = w.trunk_b[L];
    l.r = w.trunk_r[L];
  } else if (L == prm.n) {
    l.map[0] = &prm.feat;
    l.map[1] = prm.last_enc ? &prm.feat_enc : nullptr;
    l.u = w.u_feat;
    l.u_enc = w.u_feat_enc;
    l.b = w.b_feat;
    l.r = w.r_feat;
  } else {
    l.map[0] = &prm.rf_top;
    l.map[1] = &prm.rf_enc;
    l.u = w.u_rf_top;
    l.u_enc = w.u_rf_enc;
    l.b = w.b_rf;
    l.r = w.r_rf;
    l.n = prm.u / 2;
  }
  l.slabs[1] = l.map[1] != nullptr ? 1 : 0;
  return l;
}

// Byte offset of code (r, k) of a [64 x K] tile in 128-column boxes with
// the 128-byte swizzle: the 16-byte chunk k / 16 of row r sits at chunk
// (k / 16) ^ (r % 8) of the row (mirrored by kernels/ray_march.py:
// swizzled_offset with elem_bytes 1).
__device__ __forceinline__ int swz(int r, int k) {
  return (k >> 7) * kSlabBytes + r * 128 + ((((k >> 4) & 7) ^ (r & 7)) << 4) + (k & 15);
}

// _quant_act: rint (ties to even, as jnp.round) of x * r, clipped to
// [lo, 127] (lo -127; 0 folds a relu before it in, as r >= 0). Clipping
// before the rounding gives the same codes. The rounding is a float32 add
// of 1.5 * 2^23, where the spacing of floats is 1 (ties to even, as rint):
// the code is then the low bits of the sum, and no conversion instruction
// (a quarter of the float32 rate) is needed.
__device__ __forceinline__ uint32_t quant_bits(float x, float r, float lo = -127.f) {
  const float y = fminf(fmaxf(__fmul_rn(x, r), lo), 127.f);
  return __float_as_uint(__fadd_rn(y, 12582912.f));
}

__device__ __forceinline__ int quant(float x, float r) {
  return static_cast<int>(quant_bits(x, r) - 0x4B400000u);
}

// The sum over the four threads of a quad, which hold one row's columns.
__device__ __forceinline__ int quad_sum(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

struct Smem {
  uint8_t* act[2];  // the ping-pong code tiles, [64 x u]
  uint8_t* qenc;    // the encoding's codes at the current site, [64 x 128]
  uint8_t* ring;
  float* encf;      // the float32 encoding, [64][128]
  float4* vec;      // [2][part]: a part's (u, b, r, u_enc) per column
  uint64_t* full;   // stages
  uint64_t* empty;  // stages
};

// The producer thread: every stage of every product in the order the
// consumers use them.
template <int kPart>
__device__ void produce(const I8Params& prm, const Smem& sm) {
  int g = 0;
  for (int L = 0; L < prm.products; ++L) {
    const Layer l = layer_of(prm, L);
    for (int run = 0; run < 2; ++run)
      if (l.slabs[run] > 0) gmma::prefetch_tensormap(l.map[run]);
    for (int part = 0; part < l.n / kPart; ++part) {
      for (int run = 0; run < 2; ++run) {
        for (int ks = 0; ks < l.slabs[run]; ++ks, ++g) {
          const int s = g % prm.stages;
          gmma::mbar_wait(&sm.empty[s], ((g / prm.stages) & 1) ^ 1);
          gmma::mbar_arrive_expect_tx(&sm.full[s], kPart * kKBox);
          gmma::tma_load_2d(sm.ring + s * kPart * kKBox, l.map[run], &sm.full[s], kKBox * ks,
                            kPart * part);
        }
      }
    }
  }
}

// One K run of a part's product: the slabs of code tile `a` times the
// stages the producer delivers, into d. The run's first product overwrites
// d (scale-d 0). A stage is released once the group after it has been
// issued, and the last one once its group has retired.
template <int kPart>
__device__ __forceinline__ void run_products(const I8Params& prm, const Smem& sm, const uint8_t* a,
                                             int slabs, int (&d)[kPart / 2], int& g, int lane) {
  int pending = -1;
  for (int ks = 0; ks < slabs; ++ks, ++g) {
    const int s = g % prm.stages;
    gmma::mbar_wait(&sm.full[s], (g / prm.stages) & 1);
    const uint64_t da = gmma::desc_sw128_kmajor(a + ks * kSlabBytes);
    const uint64_t db = gmma::desc_sw128_kmajor(sm.ring + s * kPart * kKBox);
    gmma::fence_operands(d);
    gmma::fence();
#pragma unroll
    for (int k = 0; k < kKBox / 32; ++k)
      gmma::mma_s8_m64k32<kPart>(d, da + 2 * k, db + 2 * k, ks > 0 || k > 0);
    gmma::commit();
    gmma::fence_operands(d);
    gmma::wait<1>();
    gmma::fence_operands(d);
    if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);
    pending = s;
  }
  gmma::wait<0>();
  gmma::fence_operands(d);
  if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);
}

enum Head { kNoHead, kSigmaHead, kRgbHead };

// The epilogue of the part whose columns start at c0: each code at its place
// in the next layer's code tile `out` (not rgb_features', which only the
// rgb dots read), and into the head's int32 dots, dot[row half][column].
template <int kPart, int kHead>
__device__ __forceinline__ void part_epilogue(const I8Params& prm, const Layer& l, int c0,
                                              const float4* vec, const int (&acc)[kPart / 2],
                                              const int (&acc_e)[kPart / 2], uint8_t* out,
                                              int (&dot)[2][3], int r0, int lane) {
  const bool enc = l.slabs[1] > 0;
  const float lo = l.relu ? 0.f : -127.f;
  const int half = prm.u / 2;
  // This thread's columns c = c0 + 8 j + q2 of rows r0 and r0 + 8: c0 is a
  // multiple of kPart, so swz(r0 + 8 h, c) is the box c0 / 128, chunk
  // (c0 % 128) / 16 + j / 2 XOR-ed with r0 % 8, byte 8 (j % 2) + q2, and
  // 1024 bytes more for h = 1: one XOR and one add a column pair.
  const int q2 = 2 * (lane % 4), chunk0 = (c0 & 127) >> 4, x = r0 & 7;
  uint8_t* row = out + (c0 >> 7) * kSlabBytes + r0 * 128 + q2;
  vec += q2;
#pragma unroll
  for (int j = 0; j < kPart / 8; ++j) {
    const int c = c0 + 8 * j + q2;
    const float4 v0 = vec[8 * j], v1 = vec[8 * j + 1];
    const float2 uu = make_float2(v0.x, v1.x), bb = make_float2(v0.y, v1.y);
    const float2 rr = make_float2(v0.z, v1.z), ue = make_float2(v0.w, v1.w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bits[2];
      int q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
#if defined(KNT_ABL_NOEPI)
        // profile_ablate's noepi build: the accumulator's low bits as the
        // code; no dequantization, bias, relu or requantization (wrong math).
        bits[e] = 0x4B400000u + (static_cast<uint32_t>(acc[i]) & 0x7Fu);
#else
        float v = __fmul_rn(__int2float_rn(acc[i]), e ? uu.y : uu.x);
        if (enc) v = __fadd_rn(v, __fmul_rn(__int2float_rn(acc_e[i]), e ? ue.y : ue.x));
        bits[e] = quant_bits(__fadd_rn(v, e ? bb.y : bb.x), e ? rr.y : rr.x, lo);
#endif
        q[e] = static_cast<int>(bits[e] - 0x4B400000u);
      }
      // The two codes' low bytes side by side, at swz(r0 + 8 h, c).
      if (kHead != kRgbHead)
        *reinterpret_cast<uint16_t*>(row + 1024 * h + ((((chunk0 + (j >> 1)) ^ x) << 4) |
                                                       (8 * (j & 1)))) =
            static_cast<uint16_t>(__byte_perm(bits[0], bits[1], 0x0040));
      if (kHead == kSigmaHead) {
        const char2 ws = __ldg(reinterpret_cast<const char2*>(prm.w.w_sig + c));
        dot[h][0] += q[0] * ws.x + q[1] * ws.y;
      } else if (kHead == kRgbHead) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const char2 wc = __ldg(reinterpret_cast<const char2*>(prm.w.w_rgb + k * half + c));
          dot[h][k] += q[0] * wc.x + q[1] * wc.y;
        }
      }
    }
  }
}

// Every part of product L: the code tile `in` (or the encoding's codes) in,
// `out` written, then the consumers meet so that the next product reads it.
template <int kPart, int kHead>
__device__ __forceinline__ void run_layer(const I8Params& prm, const Smem& sm, int L,
                                          const uint8_t* in, uint8_t* out, int& g,
                                          int (&dot)[2][3], int r0, int lane) {
  const Layer l = layer_of(prm, L);
  const int t = threadIdx.x - 128;
  int acc[kPart / 2], acc_e[kPart / 2];
  for (int part = 0; part < l.n / kPart; ++part) {
    // The part's epilogue vectors, one column a thread, read from device
    // memory while the products run and kept in shared memory (two buffers:
    // the last epilogue may still read the other). Read in the epilogue
    // itself they come from L2 (the L1 beside two blocks' shared memory is
    // too small to keep them), a round trip per column.
    const int c0 = part * kPart;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < kPart) {
      v.x = __ldg(l.u + c0 + t);
      v.y = __ldg(l.b + c0 + t);
      v.z = __ldg(l.r + c0 + t);
      if (l.slabs[1] > 0) v.w = __ldg(l.u_enc + c0 + t);
    }
    run_products<kPart>(prm, sm, l.enc0 ? sm.qenc : in, l.slabs[0], acc, g, lane);
    if (l.slabs[1] > 0) run_products<kPart>(prm, sm, sm.qenc, 1, acc_e, g, lane);
    float4* vec = sm.vec + (part & 1) * kPart;
    if (t < kPart) vec[t] = v;
    gmma::bar_sync(kBar, 128);
    part_epilogue<kPart, kHead>(prm, l, c0, vec, acc, acc_e, out, dot, r0, lane);
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kBar, 128);
}

// The encoding's codes at one site, once every product that read the last
// site has retired (the consumers met since): consumer thread t takes lane t
// of every row.
__device__ __forceinline__ void quant_site(const Smem& sm, const float* r, int t) {
  const float rl = __ldg(r + t);
#pragma unroll 8
  for (int row = 0; row < kTile; ++row)
    sm.qenc[swz(row, t)] = static_cast<uint8_t>(quant(sm.encf[row * kEncLanes + t], rl));
  gmma::fence_proxy_async();
  gmma::bar_sync(kBar, 128);
}

// The consumer warpgroup: the trunk, sigma, and in full mode the features,
// rgb_features and rgb. Thread t holds rows r0 and r0 + 8 of each product.
template <int kPart>
__device__ void consume(const I8Params& prm, const Smem& sm, int p0, int rows) {
  const int t = threadIdx.x - 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const MlpInt8Weights& w = prm.w;
  int g = 0, cur = 0;
  int dot[2][3] = {{0, 0, 0}, {0, 0, 0}};
  // The tile a product reads and the one it writes (selected, not indexed,
  // so that Smem stays in registers).
  const auto in = [&] { return cur ? sm.act[1] : sm.act[0]; };
  const auto out = [&] { return cur ? sm.act[0] : sm.act[1]; };
  for (int L = 0; L < prm.n; ++L, cur ^= 1) {
    if (L > 0 && ((prm.skips >> L) & 1)) quant_site(sm, w.enc_r[L], t);
    if (L == prm.n - 1)
      run_layer<kPart, kSigmaHead>(prm, sm, L, in(), out(), g, dot, r0, lane);
    else
      run_layer<kPart, kNoHead>(prm, sm, L, in(), out(), g, dot, r0, lane);
  }

  // sigma = relu(fl(fl(S u_sig) + fl(S_enc u_sig_enc)) + b_sig), S the int32
  // dot of the last trunk codes with w_sig's column 0 and S_enc that of the
  // encoding's codes at enc_r_sf (after a last skip) with w_sig_enc's.
  int s_enc[2] = {0, 0};
  if (prm.last_enc) {
    quant_site(sm, w.enc_r_sf, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int e = 0; e < 32; ++e) {
        const int k = 32 * (lane % 4) + e;
        s_enc[h] += static_cast<i8>(sm.qenc[swz(r0 + 8 * h, k)]) * __ldg(w.w_sig_enc + k);
      }
      s_enc[h] = quad_sum(s_enc[h]);
    }
  }
  float sigma[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = __fmul_rn(__int2float_rn(quad_sum(dot[h][0])), __ldg(w.u_sig));
    if (prm.last_enc) v = __fadd_rn(v, __fmul_rn(__int2float_rn(s_enc[h]), __ldg(w.u_sig_enc)));
    sigma[h] = fmaxf(__fadd_rn(v, __ldg(w.b_sig)), 0.f);
    dot[h][0] = 0;
  }
  if (prm.products == prm.n) {
    if (lane % 4 == 0)
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < rows) prm.out[p0 + r0 + 8 * h] = sigma[h];
    return;
  }

  // The features (their codes over the trunk's last tile), then
  // rgb_features from them and the encoding's codes at enc_r_rf, and rgb =
  // sigmoid(fl(R u_rgb) + b_rgb).
  run_layer<kPart, kNoHead>(prm, sm, prm.n, in(), out(), g, dot, r0, lane);
  cur ^= 1;
  quant_site(sm, w.enc_r_rf, t);
  run_layer<kPart, kRgbHead>(prm, sm, prm.n + 1, in(), nullptr, g, dot, r0, lane);
  float4 o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = __fadd_rn(__fmul_rn(__int2float_rn(quad_sum(dot[h][k])), __ldg(w.u_rgb + k)),
                                __ldg(w.b_rgb + k));
      v[k] = 1.f / (1.f + expf(-x));
    }
    o[h] = make_float4(v[0], v[1], v[2], sigma[h]);
  }
  if (lane % 4 == 0)
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < rows) reinterpret_cast<float4*>(prm.out)[p0 + r0 + 8 * h] = o[h];
}

template <int kPart>
__global__ void __launch_bounds__(kThreads, 2)
mlp_int8_kernel(const __grid_constant__ I8Params prm) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.act[0] = base;
  sm.act[1] = base + kTile * prm.u;
  sm.qenc = sm.act[1] + kTile * prm.u;
  sm.ring = sm.qenc + kSlabBytes;
  sm.encf = reinterpret_cast<float*>(sm.ring + prm.stages * kPart * kKBox);
  sm.vec = reinterpret_cast<float4*>(sm.encf + kTile * kEncLanes);
  sm.full = reinterpret_cast<uint64_t*>(sm.vec + 2 * kPart);
  sm.empty = sm.full + prm.stages;

  const int p0 = blockIdx.x * kTile;
  const int rows = min(kTile, prm.P - p0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < prm.stages; ++s) {
      gmma::mbar_init(&sm.full[s], 1);
      gmma::mbar_init(&sm.empty[s], 4);  // the consumer warps
    }
    gmma::fence_barrier_init();
  }
  // Positional encoding of the tile's points (zero past the last one) by
  // every thread, kept in float32, and its codes at enc_r[0]: thread i takes
  // lane i % 128 of every other row. Its rows' depths are read at once, and
  // its ray's coefficients again only where the ray changes (a tile spans
  // one or two rays of S >= 64).
#if !defined(KNT_ABL_NOENC)  // profile_ablate's noenc build: no encoding
  {
    constexpr int kRows = kTile / (kThreads / kEncLanes);
    const int l = threadIdx.x % kEncLanes, kind = lane_kind(prm.masks, l);
    const int r_first = threadIdx.x / kEncLanes;
    const float r0 = __ldg(prm.w.enc_r[0] + l);
    float depth[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r_first + 2 * i;
      depth[i] = r < rows ? __ldg(prm.depths + p0 + r) : 0.f;
    }
    // The ray of point p0 + r, stepped along with r (no division a row).
    int ray = (p0 + r_first) / prm.S, at = (p0 + r_first) % prm.S, loaded = -1;
    float base = 0.f, slope = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r_first + 2 * i;
      float x = 0.f;
      if (r < rows) {
        if (ray != loaded) {
          loaded = ray;
          base = __ldg(prm.base + (size_t)ray * kEncLanes + l);
          slope = __ldg(prm.slope + (size_t)ray * kEncLanes + l);
        }
        x = encode_value(depth[i], slope, base, kind);
      }
      for (at += 2; at >= prm.S; at -= prm.S) ++ray;
      sm.encf[r * kEncLanes + l] = x;
      sm.qenc[swz(r, l)] = static_cast<uint8_t>(quant(x, r0));
    }
  }
#endif
  gmma::fence_proxy_async();
  __syncthreads();

  // The producer warpgroup gives its registers to the consumers: 128 x 24 +
  // 128 x 232 = 256 x 128, the budget of a block when two share an SM.
  if (threadIdx.x < 128) {
    gmma::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce<kPart>(prm, sm);
    return;
  }
  gmma::setmaxnreg_inc<232>();
  consume<kPart>(prm, sm, p0, rows);
}

template <int kPart>
int launch_part(const I8Params& prm, cudaStream_t st) {
  const int smem = smem_bytes(prm.u, prm.stages);
  cudaError_t e = cudaFuncSetAttribute(mlp_int8_kernel<kPart>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mlp_int8_kernel<kPart>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (prm.P + kTile - 1) / kTile;
  mlp_int8_kernel<kPart><<<blocks, kThreads, smem, st>>>(prm);
  return (int)cudaGetLastError();
}

bool weights_ok(const MlpInt8Weights* w) {
  return w->n_layers >= 1 && w->n_layers <= kMaxLayers && w->units >= 256 &&
         w->units % 256 == 0 && stages_of(w->units) >= 2 && w->enc_r[0] != nullptr &&
         w->trunk_enc_w[0] == nullptr && (w->w_sig_enc == nullptr) == (w->enc_r_sf == nullptr);
}

// Returns 0, a cudaError_t, or -CUresult when a tensor map cannot be encoded.
int launch(const MlpInt8Weights* w, const float* base, const float* slope, const float* depths,
           const float* masks, float* out, int P, int S, bool sigma_only, cudaStream_t st) {
  if (!weights_ok(w)) return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const int u = w->units, n = w->n_layers, part = part_of(u);
  I8Params prm{};  // copied into the launch's parameters
  int err = 0;
  for (int i = 0; i < n && !err; ++i) {
    err = gmma::encode_map_u8(fn, &prm.trunk[i], w->trunk_w[i], i == 0 ? kEncLanes : u, u, part);
    if (!err && w->trunk_enc_w[i] != nullptr) {
      err = gmma::encode_map_u8(fn, &prm.trunk_enc[i], w->trunk_enc_w[i], kEncLanes, u, part);
      prm.skips |= 1 << i;
    }
  }
  if (!err) err = gmma::encode_map_u8(fn, &prm.feat, w->w_feat, u, u, part);
  if (!err && w->w_feat_enc != nullptr)
    err = gmma::encode_map_u8(fn, &prm.feat_enc, w->w_feat_enc, kEncLanes, u, part);
  if (!err) err = gmma::encode_map_u8(fn, &prm.rf_top, w->w_rf_top, u, u / 2, part);
  if (!err) err = gmma::encode_map_u8(fn, &prm.rf_enc, w->w_rf_enc, kEncLanes, u / 2, part);
  if (err) return -err;
  prm.w = *w;
  prm.base = base;
  prm.slope = slope;
  prm.depths = depths;
  prm.masks = masks;
  prm.out = out;
  prm.P = P;
  prm.S = S;
  prm.u = u;
  prm.n = n;
  prm.products = sigma_only ? n : n + 2;
  prm.stages = stages_of(u);
  prm.last_enc = w->w_sig_enc != nullptr;
  return part == 128 ? launch_part<128>(prm, st) : launch_part<64>(prm, st);
}

// ---- the streamed route: any width (a multiple of 256), any depth ---------
//
// The kernel above keeps both ping-pong code tiles in shared memory (2 x 64
// x u bytes) and its tensor maps in fixed arrays of kMaxLayers; above u =
// 1280 the tiles and a ring of two stages no longer fit, and past 16 layers
// the arrays run out. ray_march_mlp_int8_plan picks this route for those
// shapes (u <= 1280 up to 16 layers keep the kernel above, unchanged). It
// computes the same codes, sums and epilogues, so the same bits:
// * Each product's output codes leave the block as they are made, 128
//   columns (a part) at a time, to an int8 scratch of two [P, u] planes
//   (ping-pong); the next product reads its K slabs back by TMA, one [64
//   points x 128 K] slab a ring stage beside the stage's [128 N x 128 K] of
//   weights. Every storing thread runs fence.proxy.async.global, then
//   arrives on `ready`, which the producer waits on before it loads.
// * The encoding's codes at each quantization site are made from the
//   encoding recomputed (encode_lane, the same bits as the kernel above's
//   encode_value), not from a kept float32 tile: shared memory holds the
//   ring and one code tile at any u.
// * The weights' maps and per-column vectors are read from the quantized
//   state's device table (I8Table), built once per quantized state.
// * One consumer warpgroup (64 rows, a part at a time, m64n128k32 s8 and a
//   second accumulator set for the encoding's product), one producer warp;
//   two blocks share an SM. Shared memory: ring 3 x 24 KB + the code tile 8
//   KB + 1 KB of alignment = 81.1 KB (ray_march_mlp_int8_plan mirrors it).
// * No atomics and a fixed order: two runs give identical bits.

// The head arrays of MlpInt8Weights, in its order: the tail of a device
// table.
struct I8Heads {
  const i8* w_feat;
  const float* u_feat;
  const float* b_feat;
  const i8* w_sig;
  const float* u_sig;
  const float* b_sig;
  const i8* w_feat_enc;
  const float* u_feat_enc;
  const i8* w_sig_enc;
  const float* u_sig_enc;
  const float* enc_r_sf;
  const float* r_feat;
  const i8* w_rf_top;
  const float* u_rf_top;
  const i8* w_rf_enc;
  const float* u_rf_enc;
  const float* enc_r_rf;
  const float* b_rf;
  const float* r_rf;
  const i8* w_rgb;
  const float* u_rgb;
  const float* b_rgb;
};

namespace streamed {

constexpr int kHeadMaps = 4;                     // feat, feat_enc, rf_top, rf_enc
constexpr int kLayerPointers = 6;                // trunk_u, _b, _r, _enc_u, enc_r, trunk_enc_w
constexpr int kStages = 3;
constexpr int kPart = 128;                       // output columns a part
constexpr int kStageBytes = kSlabBytes + kPart * kKBox;  // A [64 x 128 K] + B [128 N x 128 K]
constexpr int kConsumers = 128;                  // one warpgroup
constexpr int kThreads = kConsumers + 32;        // and the producer warp
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kSlabBytes + 8 * (2 * kStages + 1);

// A view of the device table of a quantized state (kernels/ray_march.py:
// _mlp_int8_table; layout mlp_int8_table_layout): 2 n + 4 tensor maps of
// 128 bytes (the transposed trunk_w[i], trunk_enc_w[i] (zero where null),
// w_feat, w_feat_enc, w_rf_top, w_rf_enc, each in [64 rows x 128 K] boxes),
// then n pointers each of trunk_u, trunk_b, trunk_r, trunk_enc_u, enc_r and
// the transposed trunk_enc_w (null where a layer reads no encoding), then
// I8Heads.
struct I8Table {
  const CUtensorMap* trunk;
  const CUtensorMap* trunk_enc;
  const CUtensorMap* heads;
  const float* const* trunk_u;
  const float* const* trunk_b;
  const float* const* trunk_r;
  const float* const* trunk_enc_u;
  const float* const* enc_r;
  const i8* const* trunk_enc_w;
  const I8Heads* w;
};

__device__ __forceinline__ I8Table table_of(const void* base, int n) {
  I8Table t;
  t.trunk = static_cast<const CUtensorMap*>(base);
  t.trunk_enc = t.trunk + n;
  t.heads = t.trunk_enc + n;
  t.trunk_u = reinterpret_cast<const float* const*>(t.heads + kHeadMaps);
  t.trunk_b = t.trunk_u + n;
  t.trunk_r = t.trunk_b + n;
  t.trunk_enc_u = t.trunk_r + n;
  t.enc_r = t.trunk_enc_u + n;
  t.trunk_enc_w = reinterpret_cast<const i8* const*>(t.enc_r + n);
  t.w = reinterpret_cast<const I8Heads*>(
      reinterpret_cast<const void* const*>(t.trunk_u) + kLayerPointers * n);
  return t;
}

struct Params {
  CUtensorMap x;      // [2, P, u] int8: the ping-pong code planes
  const void* table;  // I8Table
  const float* base;
  const float* slope;
  const float* depths;
  const float* masks;
  float* out;
  uint8_t* x_ptr;
  int P, S, u, n, products;
};

// Product L as layer_of above, from the table.
struct SLayer {
  const CUtensorMap* map[2];
  int slabs[2];  // 128-K slabs of each run (0: no run)
  bool enc0;
  bool relu;
  int n;
  const float* u;
  const float* u_enc;
  const float* b;
  const float* r;
};

__device__ __forceinline__ SLayer layer_of(const Params& prm, const I8Table& t, int L) {
  const I8Heads* w = t.w;
  SLayer l;
  l.enc0 = L == 0;
  l.relu = L < prm.n;
  l.slabs[0] = L == 0 ? 1 : prm.u / kKBox;
  l.n = prm.u;
  bool enc;
  if (L < prm.n) {
    l.map[0] = &t.trunk[L];
    l.map[1] = &t.trunk_enc[L];
    enc = L > 0 && t.trunk_enc_w[L] != nullptr;
    l.u = t.trunk_u[L];
    l.u_enc = t.trunk_enc_u[L];
    l.b = t.trunk_b[L];
    l.r = t.trunk_r[L];
  } else if (L == prm.n) {
    l.map[0] = &t.heads[0];
    l.map[1] = &t.heads[1];
    enc = w->w_feat_enc != nullptr;
    l.u = w->u_feat;
    l.u_enc = w->u_feat_enc;
    l.b = w->b_feat;
    l.r = w->r_feat;
  } else {
    l.map[0] = &t.heads[2];
    l.map[1] = &t.heads[3];
    enc = true;
    l.u = w->u_rf_top;
    l.u_enc = w->u_rf_enc;
    l.b = w->b_rf;
    l.r = w->r_rf;
    l.n = prm.u / 2;
  }
  l.slabs[1] = enc ? 1 : 0;
  return l;
}

struct SSmem {
  uint8_t* ring;
  uint8_t* qenc;     // the encoding's codes at the current site, [64 x 128]
  uint64_t* full;    // kStages
  uint64_t* empty;   // kStages
  uint64_t* ready;   // a product's codes are in device memory
};

// The producer thread: every stage of every product, part by part (the
// codes' K slabs, then the encoding's), each product's input once the
// product before has written it.
__device__ void produce(const Params& prm, const SSmem& sm, int p0) {
  const I8Table t = table_of(prm.table, prm.n);
  int g = 0;
  for (int L = 0; L < prm.products; ++L) {
    const SLayer l = layer_of(prm, t, L);
    if (L > 0) gmma::mbar_wait(sm.ready, (L - 1) & 1);
    for (int part = 0; part < l.n / kPart; ++part) {
      for (int run = 0; run < 2; ++run) {
        for (int ks = 0; ks < l.slabs[run]; ++ks, ++g) {
          const int s = g % kStages;
          uint8_t* st = sm.ring + s * kStageBytes;
          const bool a = run == 0 && !l.enc0;
          gmma::mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
          gmma::mbar_arrive_expect_tx(&sm.full[s], kPart * kKBox + (a ? kSlabBytes : 0));
          for (int b = 0; b < kPart / 64; ++b)
            gmma::tma_load_2d(st + kSlabBytes + b * 64 * kKBox, l.map[run], &sm.full[s],
                              kKBox * ks, kPart * part + 64 * b);
          if (a) gmma::tma_load_3d(st, &prm.x, &sm.full[s], kKBox * ks, p0, (L - 1) & 1);
        }
      }
    }
  }
}

// One K run of a part's product into d, as run_products above; run 0 of a
// product past the first reads each stage's own A slab.
__device__ __forceinline__ void run_products(const SSmem& sm, const uint8_t* a_fixed, int slabs,
                                             int (&d)[kPart / 2], int& g, int lane) {
  int pending = -1;
  for (int ks = 0; ks < slabs; ++ks, ++g) {
    const int s = g % kStages;
    const uint8_t* st = sm.ring + s * kStageBytes;
    gmma::mbar_wait(&sm.full[s], (g / kStages) & 1);
    const uint64_t da = gmma::desc_sw128_kmajor(a_fixed != nullptr ? a_fixed : st);
    const uint64_t db = gmma::desc_sw128_kmajor(st + kSlabBytes);
    gmma::fence_operands(d);
    gmma::fence();
#pragma unroll
    for (int k = 0; k < kKBox / 32; ++k)
      gmma::mma_s8_m64k32<kPart>(d, da + 2 * k, db + 2 * k, ks > 0 || k > 0);
    gmma::commit();
    gmma::fence_operands(d);
    gmma::wait<1>();
    gmma::fence_operands(d);
    if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);
    pending = s;
  }
  gmma::wait<0>();
  gmma::fence_operands(d);
  if (pending >= 0 && lane == 0) gmma::mbar_arrive(&sm.empty[pending]);
}

// Every part of product L: the products, then part_epilogue's arithmetic
// with the per-column vectors read from device memory and each code pair
// stored to the product's plane (not rgb_features', which only the rgb
// dots read).
template <int kHead>
__device__ __forceinline__ void run_layer(const Params& prm, const I8Table& t, const SSmem& sm,
                                          int L, int& g, int (&dot)[2][3], int r0, int lane,
                                          int p0, int rows) {
  const SLayer l = layer_of(prm, t, L);
  const bool enc = l.slabs[1] > 0;
  const float lo = l.relu ? 0.f : -127.f;
  const int half = prm.u / 2;
  uint8_t* dst = prm.x_ptr + (size_t)(L & 1) * prm.P * prm.u;
  const i8* wsig = t.w->w_sig;
  const i8* wrgb = t.w->w_rgb;
  int acc[kPart / 2], acc_e[kPart / 2];
  for (int part = 0; part < l.n / kPart; ++part) {
    run_products(sm, l.enc0 ? sm.qenc : nullptr, l.slabs[0], acc, g, lane);
    if (enc) run_products(sm, sm.qenc, 1, acc_e, g, lane);
#pragma unroll
    for (int j = 0; j < kPart / 8; ++j) {
      const int c = kPart * part + 8 * j + 2 * (lane % 4);
      float uu[2], bb[2], rr[2], ue[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uu[e] = __ldg(l.u + c + e);
        bb[e] = __ldg(l.b + c + e);
        rr[e] = __ldg(l.r + c + e);
        if (enc) ue[e] = __ldg(l.u_enc + c + e);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bits[2];
        int q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float v = __fmul_rn(__int2float_rn(acc[i]), uu[e]);
          if (enc) v = __fadd_rn(v, __fmul_rn(__int2float_rn(acc_e[i]), ue[e]));
          bits[e] = quant_bits(__fadd_rn(v, bb[e]), rr[e], lo);
          q[e] = static_cast<int>(bits[e] - 0x4B400000u);
        }
        const int r = r0 + 8 * h;
        if (kHead != kRgbHead && r < rows)
          *reinterpret_cast<uint16_t*>(dst + (size_t)(p0 + r) * prm.u + c) =
              static_cast<uint16_t>(__byte_perm(bits[0], bits[1], 0x0040));
        if (kHead == kSigmaHead) {
          const char2 ws = __ldg(reinterpret_cast<const char2*>(wsig + c));
          dot[h][0] += q[0] * ws.x + q[1] * ws.y;
        } else if (kHead == kRgbHead) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const char2 wc = __ldg(reinterpret_cast<const char2*>(wrgb + k * half + c));
            dot[h][k] += q[0] * wc.x + q[1] * wc.y;
          }
        }
      }
    }
  }
  // The next product reads these codes by TMA; every products' reads of
  // the encoding's codes have retired once the warpgroup has met.
  if (L + 1 < prm.products) {
    gmma::fence_proxy_async_global();
    gmma::mbar_arrive(sm.ready);
  }
  gmma::bar_sync(kBar, kConsumers);
}

// The encoding's codes at one site, from the encoding recomputed: thread t
// takes lane t of every row (zeros past the last point).
__device__ __forceinline__ void quant_site(const Params& prm, const SSmem& sm, const float* r,
                                           int p0, int rows) {
  const int t = threadIdx.x;
  const float rl = __ldg(r + t);
  for (int row = 0; row < kTile; ++row) {
    const float x = row < rows ? encode_lane(prm.base, prm.slope, prm.depths, prm.masks, p0 + row,
                                             t, prm.S)
                               : 0.f;
    sm.qenc[swz(row, t)] = static_cast<uint8_t>(quant(x, rl));
  }
  gmma::fence_proxy_async();
  gmma::bar_sync(kBar, kConsumers);
}

// The consumer warpgroup, as consume above.
__device__ void consume(const Params& prm, const SSmem& sm, int p0, int rows) {
  const int t = threadIdx.x, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const I8Table tb = table_of(prm.table, prm.n);
  const I8Heads* w = tb.w;
  int g = 0;
  int dot[2][3] = {{0, 0, 0}, {0, 0, 0}};
  quant_site(prm, sm, tb.enc_r[0], p0, rows);
  for (int L = 0; L < prm.n; ++L) {
    if (L > 0 && tb.trunk_enc_w[L] != nullptr) quant_site(prm, sm, tb.enc_r[L], p0, rows);
    if (L == prm.n - 1)
      run_layer<kSigmaHead>(prm, tb, sm, L, g, dot, r0, lane, p0, rows);
    else
      run_layer<kNoHead>(prm, tb, sm, L, g, dot, r0, lane, p0, rows);
  }

  const bool last_enc = w->w_sig_enc != nullptr;
  int s_enc[2] = {0, 0};
  if (last_enc) {
    quant_site(prm, sm, w->enc_r_sf, p0, rows);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int e = 0; e < 32; ++e) {
        const int k = 32 * (lane % 4) + e;
        s_enc[h] += static_cast<i8>(sm.qenc[swz(r0 + 8 * h, k)]) * __ldg(w->w_sig_enc + k);
      }
      s_enc[h] = quad_sum(s_enc[h]);
    }
  }
  float sigma[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = __fmul_rn(__int2float_rn(quad_sum(dot[h][0])), __ldg(w->u_sig));
    if (last_enc) v = __fadd_rn(v, __fmul_rn(__int2float_rn(s_enc[h]), __ldg(w->u_sig_enc)));
    sigma[h] = fmaxf(__fadd_rn(v, __ldg(w->b_sig)), 0.f);
    dot[h][0] = 0;
  }
  if (prm.products == prm.n) {
    if (lane % 4 == 0)
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < rows) prm.out[p0 + r0 + 8 * h] = sigma[h];
    return;
  }

  run_layer<kNoHead>(prm, tb, sm, prm.n, g, dot, r0, lane, p0, rows);
  quant_site(prm, sm, w->enc_r_rf, p0, rows);
  run_layer<kRgbHead>(prm, tb, sm, prm.n + 1, g, dot, r0, lane, p0, rows);
  float4 o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = __fadd_rn(__fmul_rn(__int2float_rn(quad_sum(dot[h][k])), __ldg(w->u_rgb + k)),
                                __ldg(w->b_rgb + k));
      v[k] = 1.f / (1.f + expf(-x));
    }
    o[h] = make_float4(v[0], v[1], v[2], sigma[h]);
  }
  if (lane % 4 == 0)
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < rows) reinterpret_cast<float4*>(prm.out)[p0 + r0 + 8 * h] = o[h];
}

__global__ void __launch_bounds__(kThreads, 2)
mlp_int8_streamed_kernel(const __grid_constant__ Params prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (gmma::smem_addr(smem_raw) & 1023)) & 1023);
  SSmem sm;
  sm.ring = base;
  sm.qenc = sm.ring + kStages * kStageBytes;
  sm.full = reinterpret_cast<uint64_t*>(sm.qenc + kSlabBytes);
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
  consume(prm, sm, p0, rows);
}

// table: the quantized state's device table (n layers of u units); x: a
// [2, P, u] int8 scratch. Returns 0, a cudaError_t, or -CUresult.
int launch(const void* table, int n, int u, const float* base, const float* slope,
           const float* depths, const float* masks, float* out, int P, int S, bool sigma_only,
           uint8_t* x, cudaStream_t st) {
  if (n < 1 || u < 256 || u % 256 || table == nullptr || x == nullptr)
    return (int)cudaErrorInvalidValue;
  const gmma::EncodeTiled fn = gmma::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  Params prm{};  // copied into the launch's parameters
  const int err = gmma::encode_map_3d(fn, &prm.x, x, 1, u, P, 2, kKBox, kTile);
  if (err) return -err;
  prm.table = table;
  prm.base = base;
  prm.slope = slope;
  prm.depths = depths;
  prm.masks = masks;
  prm.out = out;
  prm.x_ptr = x;
  prm.P = P;
  prm.S = S;
  prm.u = u;
  prm.n = n;
  prm.products = sigma_only ? n : n + 2;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_int8_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int blocks = (P + kTile - 1) / kTile;
  mlp_int8_streamed_kernel<<<blocks, kThreads, kSmemBytes, st>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace streamed

}  // namespace

// base, slope: [rays, 128]; depths: [rays, S]; masks: [3, 128] raw/sin/cos
// lane selectors; out: [rays * S, 4] (r, g, b, sigma) or [rays * S] sigma.
// Returns 0, a cudaError_t, or -CUresult when a tensor map cannot be
// encoded.
KNT_EXPORT int knt_ray_march_mlp_int8(const MlpInt8Weights* w, const float* base,
                                      const float* slope, const float* depths,
                                      const float* masks, float* out, int rays,
                                      int S, int sigma_only, void* stream) {
  const long long points = (long long)rays * S;
  if (points <= 0) return 0;
  if (points > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch(w, base, slope, depths, masks, out, (int)points, S, sigma_only != 0,
                (cudaStream_t)stream);
}

// The streamed route (ray_march_mlp_int8_plan's "streamed"): table, the
// quantized state's device table of n layers of u units; x: a [2, P, u]
// int8 scratch (P = rays * S); the rest as knt_ray_march_mlp_int8. Returns
// 0, a cudaError_t, or -CUresult.
KNT_EXPORT int knt_ray_march_mlp_int8_streamed(const void* table, int n, int u,
                                               const float* base, const float* slope,
                                               const float* depths, const float* masks,
                                               float* out, int rays, int S, int sigma_only,
                                               uint8_t* x, void* stream) {
  const long long points = (long long)rays * S;
  if (points <= 0) return 0;
  if (points > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return streamed::launch(table, n, u, base, slope, depths, masks, out, (int)points, S,
                          sigma_only != 0, x, (cudaStream_t)stream);
}
