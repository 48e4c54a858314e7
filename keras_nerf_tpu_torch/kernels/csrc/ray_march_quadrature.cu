// ray_march_quadrature: volume-rendering quadrature of one pass.
//
// Replaces: keras_nerf_tpu/kernels/ray_march.py:_quadrature_fwd (:1102),
// _depth_lane3 (:1150), the compact-weights block (:1328-1340) and the
// sigma_only epilogue (:1296-1314) of _train_chunk_kernel. With
// x_s = sigma_s * delta_s (delta_s = t_{s+1} - t_s, the last delta 1e-10):
// T_s = exp(-sum_{i<s} x_i), w_s = (1 - exp(-x_s)) T_s, image = sum w rgb
// (+ 1 - sum w on a white background, then clipped to [0, 1]),
// depth = sum w t, and optionally the weights themselves. In sigma-only
// mode the image is zeros, written by the kernel.
//
// with_grad mode (knt_ray_march_quadrature_grad): also replaces the MSE
// cotangent (:1345-1349) and _quadrature_bwd (:1158-1200). After the
// forward, d_pre = 2 (clip(image) - target) / (3 R) times the clip's
// subgradient (1 inside (0, 1), 0.5 at exactly 0 or 1, 0 outside, as XLA's
// autodiff takes it); d_w_s = rgb_s . d_pre (- sum d_pre on a white
// background); dL/dx_s = e_s T_s d_w_s - sum_{j>s} w_j d_w_j, with no
// division. Out per point, in bf16 as the TPU's backward consumes them:
// d_rgb = g rgb (1 - rgb) with g = w_s d_pre (16 columns, 0..2 used: the
// K = 16 head operand of mlp_backward) and d_sigma = delta dL/dx
// [sigma > 0].
//
// Bound on the H100: bytes. Per sample it reads 16 B of (r, g, b, sigma)
// and 4 B of depth (8 B in sigma-only mode), writes 4 B of weight when
// asked and, with_grad, 32 B of d_rgb and 2 B of d_sigma; a few flops
// each. A 4096 x 192 fine chunk moves about 16 MB, about 5 us at 3.35 TB/s.
//
// Design: one warp a ray, one launch a call. Each lane owns K = ceil(S/32)
// consecutive samples (K <= 8, the kernel is templated on K) and starts all
// of its loads before any arithmetic: the depths (and, in sigma-only mode,
// the densities) as float4 or float2 where the row's alignment allows, the
// colours striped, one float4 a lane and a sample so that a warp reads 512
// contiguous bytes at a time, handed to their lanes through a staging
// buffer in shared memory. A lane's last delta takes the next lane's first
// depth by one shuffle. The exclusive optical depth is a
// serial prefix inside the lane plus one warp scan of the lane totals; the
// sums of w rgb, w and w t are per-lane partials reduced by shuffles. The
// with_grad mode keeps the walk's values in registers and runs its reverse
// walk on them: an in-lane suffix and one reverse warp scan, no re-read;
// its d_rgb rows go back through the staging buffer and out as whole rows,
// lanes on neighbouring 16-byte pieces.
// Above 256 samples the kernel walks windows of 256 (K = 8) carrying the
// scan; the with_grad mode then keeps the carry in front of each window but
// the last in the warp's slice of shared memory (one float a window, after
// the staging buffers) and re-reads the windows before the last in its
// reverse walk, each rebuilt from the very carry the forward walk used, so
// both walks see the same bits. At most kMaxCarries carries a warp, S <=
// 2^19: those of 16 rays a block still fit beside their staging buffers.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 8;                  // samples a lane holds
constexpr int kWindow = 32 * kMaxK;       // the windowed route's step
constexpr int kMaxCarries = 2047;         // with_grad: S <= 2048 windows
constexpr int kMaxThreads = 512;          // rays_per_block <= 16

// The widest load of a lane's K floats: 4 where K is a multiple of 4, else
// 2 where it is even, else 1.
template <int K>
constexpr int kVecOf = K % 4 == 0 ? 4 : (K % 2 == 0 ? 2 : 1);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// out[j] = p[j] for j < n, else 0. With vec, p is aligned to the vector
// width V and n is a multiple of V (or <= 0), so a vector is all in or out.
template <int K>
__device__ __forceinline__ void load_row(const float* p, int n, bool vec,
                                         float (&out)[K]) {
  constexpr int V = kVecOf<K>;
  if (V > 1 && vec) {
#pragma unroll
    for (int c = 0; c < K; c += V) {
      if (c < n) {
        if constexpr (V == 4) {
          const float4 q = *reinterpret_cast<const float4*>(p + c);
          out[c] = q.x, out[c + 1] = q.y, out[c + 2] = q.z, out[c + 3] = q.w;
        } else if constexpr (V == 2) {
          const float2 q = *reinterpret_cast<const float2*>(p + c);
          out[c] = q.x, out[c + 1] = q.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) out[c + i] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = j < n ? p[j] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void store_row(float* p, int n, bool vec,
                                          const float (&v)[K]) {
  constexpr int V = kVecOf<K>;
  if (V > 1 && vec) {
#pragma unroll
    for (int c = 0; c < K; c += V) {
      if (c < n) {
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(p + c) =
              make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
        } else if constexpr (V == 2) {
          *reinterpret_cast<float2*>(p + c) = make_float2(v[c], v[c + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < n) p[j] = v[j];
  }
}

// The warp's staging buffer of colours: 32 K float4, one float4 of padding
// after every 8 so that both the striped writes and the blocked reads
// (lane l reading l K + j) hit distinct banks or at most two ways. The
// with_grad mode reuses it for the d_rgb rows (one uint2 a sample, one of
// padding after every 16).
template <int K>
constexpr int kStageFloat4s = 32 * K + 4 * K;
__device__ __forceinline__ int cpad(int i) { return i + (i >> 3); }
__device__ __forceinline__ int gpad(int i) { return i + (i >> 4); }

// One window of a ray: samples [s0, s0 + 32 K), lane l holding
// s0 + l K + j for j < K. Loads every input first (the colours striped, a
// float4 a lane and a sample, through the warp's buffer), then delta, x and
// the exclusive optical depth (carry in front of the window + the warp's
// exclusive scan of lane totals + the in-lane prefix); carry moves past the
// window. Samples at or past S hold x = 0 and weight 0.
template <int K, bool kSigmaOnly>
struct Window {
  float t[K], sigma[K], delta[K], x[K], excl[K];
  float4 c[K];

  __device__ __forceinline__ void load(const float* rgbs_r, const float* t_r,
                                       int S, int s0, int lane, bool vec,
                                       float4* stage) {
    const int base = s0 + lane * K;
    const int n = S - base;
    if constexpr (kSigmaOnly) {
      load_row<K>(t_r + base, n, vec, t);
      load_row<K>(rgbs_r + base, n, vec, sigma);
    } else {
      const float4* c_r = reinterpret_cast<const float4*>(rgbs_r) + s0;
      float4 v[K];
#pragma unroll
      for (int i = 0; i < K; ++i)
        v[i] = s0 + 32 * i + lane < S ? c_r[32 * i + lane]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      load_row<K>(t_r + base, n, vec, t);
#pragma unroll
      for (int i = 0; i < K; ++i) stage[cpad(32 * i + lane)] = v[i];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < K; ++j) c[j] = stage[cpad(lane * K + j)];
#pragma unroll
      for (int j = 0; j < K; ++j) sigma[j] = c[j].w;
      __syncwarp();
    }
    // The depth after the window, for lane 31's last delta.
    const float t_after =
        (lane == 31 && s0 + 32 * K < S) ? t_r[s0 + 32 * K] : 0.f;
    float t_next = __shfl_down_sync(kFull, t[0], 1);
    if (lane == 31) t_next = t_after;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = base + j;
      const float tn = j + 1 < K ? t[j + 1] : t_next;
      delta[j] = s < S - 1 ? __fsub_rn(tn, t[j])
                           : (s == S - 1 ? knt::kLastDelta : 0.f);
      x[j] = __fmul_rn(sigma[j], delta[j]);
    }
  }

  __device__ __forceinline__ void scan(int lane, float& carry) {
    float pre[K];
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pre[j] = p;
      p = __fadd_rn(p, x[j]);
    }
    float incl = p;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, y);
    }
    float ex = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) ex = 0.f;
    const float b = __fadd_rn(carry, ex);
    carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
#pragma unroll
    for (int j = 0; j < K; ++j) excl[j] = __fadd_rn(b, pre[j]);
  }
};

template <int K, bool kSigmaOnly>
__global__ void __launch_bounds__(kMaxThreads)
    quadrature_kernel(const float* __restrict__ rgbs,
                      const float* __restrict__ t, float* __restrict__ image,
                      float* __restrict__ depth, float* __restrict__ weights,
                      int rays, int S, int white_bg, int vec) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rays) return;
  float4* stage = smem + (threadIdx.x >> 5) * kStageFloat4s<K>;
  const float* t_r = t + (size_t)r * S;
  const float* rgbs_r = rgbs + (size_t)r * S * (kSigmaOnly ? 1 : 4);
  float carry = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32 * K) {
    Window<K, kSigmaOnly> win;
    win.load(rgbs_r, t_r, S, s0, lane, vec, stage);
    win.scan(lane, carry);
    float w[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = __fmul_rn(__fsub_rn(1.f, expf(-win.x[j])), expf(-win.excl[j]));
      acc_w += w[j];
      acc_d += w[j] * win.t[j];
      if constexpr (!kSigmaOnly) {
        acc_r += w[j] * win.c[j].x;
        acc_g += w[j] * win.c[j].y;
        acc_b += w[j] * win.c[j].z;
      }
    }
    if (weights != nullptr) {
      const int base = s0 + lane * K;
      store_row<K>(weights + (size_t)r * S + base, S - base, vec, w);
    }
  }
  acc_d = warp_sum(acc_d);
  if constexpr (kSigmaOnly) {
    if (lane == 0) {
      image[(size_t)r * 3 + 0] = 0.f;
      image[(size_t)r * 3 + 1] = 0.f;
      image[(size_t)r * 3 + 2] = 0.f;
      depth[r] = acc_d;
    }
    return;
  }
  acc_w = warp_sum(acc_w);
  acc_r = warp_sum(acc_r);
  acc_g = warp_sum(acc_g);
  acc_b = warp_sum(acc_b);
  if (lane == 0) {
    const float bg = white_bg ? 1.f - acc_w : 0.f;
    image[(size_t)r * 3 + 0] = fminf(fmaxf(acc_r + bg, 0.f), 1.f);
    image[(size_t)r * 3 + 1] = fminf(fmaxf(acc_g + bg, 0.f), 1.f);
    image[(size_t)r * 3 + 2] = fminf(fmaxf(acc_b + bg, 0.f), 1.f);
    depth[r] = acc_d;
  }
}

// The clip's subgradient times the image cotangent (_quadrature_bwd
// :1171-1181).
__device__ __forceinline__ float clip_grad(float pre, float d) {
  if (pre > 0.f && pre < 1.f) return d;
  if (pre == 0.f || pre == 1.f) return __fmul_rn(0.5f, d);
  return 0.f;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    quadrature_grad_kernel(const float* __restrict__ rgbs,
                           const float* __restrict__ t,
                           const float* __restrict__ target,
                           float* __restrict__ image,
                           float* __restrict__ depth,
                           float* __restrict__ weights,
                           __nv_bfloat16* __restrict__ d_rgb,
                           __nv_bfloat16* __restrict__ d_sigma, int rays,
                           int S, int white_bg, float loss_scale, int vec) {
  constexpr int V = kVecOf<K>;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rays) return;
  // One window below K = 8 (S <= 224): the register route keeps no carry.
  const int windows = K < kMaxK ? 1 : (S + kWindow - 1) / kWindow;
  float4* stage = smem + (threadIdx.x >> 5) * kStageFloat4s<K>;
  // The carries in front of windows 0 .. windows - 2, after every warp's
  // staging buffer (stage_bytes).
  float* window_carry = reinterpret_cast<float*>(smem + (blockDim.x >> 5) * kStageFloat4s<K>) +
                        (threadIdx.x >> 5) * (windows - 1);
  // The target is loaded with the first window, not after the walk.
  const float tg_r = target[(size_t)r * 3 + 0];
  const float tg_g = target[(size_t)r * 3 + 1];
  const float tg_b = target[(size_t)r * 3 + 2];
  const float* t_r = t + (size_t)r * S;
  const float* rgbs_r = rgbs + (size_t)r * S * 4;
  float* w_r = weights == nullptr ? nullptr : weights + (size_t)r * S;

  // The forward walk. The last window's values stay in registers for the
  // reverse walk; the carry in front of every other window is kept.
  Window<K, false> win;
  float e[K], tr[K], w[K];
  float carry = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f;
  for (int k = 0; k < windows; ++k) {
    if (k + 1 < windows && lane == 0) window_carry[k] = carry;
    win.load(rgbs_r, t_r, S, k * 32 * K, lane, vec, stage);
    win.scan(lane, carry);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      e[j] = expf(-win.x[j]);
      tr[j] = expf(-win.excl[j]);
      w[j] = __fmul_rn(__fsub_rn(1.f, e[j]), tr[j]);
      acc_w += w[j];
      acc_d += w[j] * win.t[j];
      acc_r += w[j] * win.c[j].x;
      acc_g += w[j] * win.c[j].y;
      acc_b += w[j] * win.c[j].z;
    }
    if (w_r != nullptr) {
      const int base = k * 32 * K + lane * K;
      store_row<K>(w_r + base, S - base, vec, w);
    }
  }
  acc_d = warp_sum(acc_d);
  acc_w = warp_sum(acc_w);
  acc_r = warp_sum(acc_r);
  acc_g = warp_sum(acc_g);
  acc_b = warp_sum(acc_b);
  const float bg = white_bg ? 1.f - acc_w : 0.f;
  const float pre_r = acc_r + bg, pre_g = acc_g + bg, pre_b = acc_b + bg;
  const float img_r = fminf(fmaxf(pre_r, 0.f), 1.f);
  const float img_g = fminf(fmaxf(pre_g, 0.f), 1.f);
  const float img_b = fminf(fmaxf(pre_b, 0.f), 1.f);
  if (lane == 0) {
    image[(size_t)r * 3 + 0] = img_r;
    image[(size_t)r * 3 + 1] = img_g;
    image[(size_t)r * 3 + 2] = img_b;
    depth[r] = acc_d;
  }
  const float dp_r = clip_grad(pre_r, __fmul_rn(__fsub_rn(img_r, tg_r), loss_scale));
  const float dp_g = clip_grad(pre_g, __fmul_rn(__fsub_rn(img_g, tg_g), loss_scale));
  const float dp_b = clip_grad(pre_b, __fmul_rn(__fsub_rn(img_b, tg_b), loss_scale));
  const float dp_sum = white_bg ? dp_r + dp_g + dp_b : 0.f;
  if (windows > 1) __syncwarp();   // lane 0's carries, for every lane

  // The reverse walk, last window first: sum_{j>s} w_j d_w_j as an in-lane
  // suffix plus one reverse warp scan of the lane totals.
  float suffix_carry = 0.f;
  for (int k = windows - 1; k >= 0; --k) {
    const int s0 = k * 32 * K;
    if (k != windows - 1) {   // only on the windowed route
      float c0 = window_carry[k];
      win.load(rgbs_r, t_r, S, s0, lane, vec, stage);
      win.scan(lane, c0);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        e[j] = expf(-win.x[j]);
        tr[j] = expf(-win.excl[j]);
        w[j] = __fmul_rn(__fsub_rn(1.f, e[j]), tr[j]);
      }
    }
    float d_w[K], later[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d_w[j] = __fadd_rn(__fadd_rn(__fmul_rn(win.c[j].x, dp_r),
                                   __fmul_rn(win.c[j].y, dp_g)),
                         __fmul_rn(win.c[j].z, dp_b));
      d_w[j] = __fsub_rn(d_w[j], dp_sum);
    }
    float q = 0.f;   // in-lane suffix, exclusive
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      later[j] = q;
      // Past S the weight is 0: no term.
      q = __fadd_rn(q, __fmul_rn(w[j], d_w[j]));
    }
    float suf = q;   // inclusive suffix over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(kFull, suf, off);
      if (lane + off < 32) suf = __fadd_rn(suf, y);
    }
    float after = __shfl_down_sync(kFull, suf, 1);
    if (lane == 31) after = 0.f;
    const float b = __fadd_rn(suffix_carry, after);
    suffix_carry = __fadd_rn(suffix_carry, __shfl_sync(kFull, suf, 0));

    const int base = s0 + lane * K;
    const int n = S - base;
    float ds[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d_x = __fsub_rn(__fmul_rn(__fmul_rn(e[j], tr[j]), d_w[j]),
                                  __fadd_rn(b, later[j]));
      ds[j] = win.sigma[j] > 0.f ? __fmul_rn(d_x, win.delta[j]) : 0.f;
    }
    const size_t p = (size_t)r * S + base;
    if (V > 1 && vec) {
#pragma unroll
      for (int c = 0; c < K; c += 2)
        if (c < n)
          *reinterpret_cast<__nv_bfloat162*>(d_sigma + p + c) =
              __floats2bfloat162_rn(ds[c], ds[c + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < n) d_sigma[p + j] = __float2bfloat16_rn(ds[j]);
    }
    // d_rgb: each sample's (gr, gg, gb, 0) as bf16 staged in the warp's
    // buffer, then written as whole rows, 16 B a lane, lanes on neighbouring
    // addresses: the 16 columns of a sample, 8..15 zero.
    uint2* rows = reinterpret_cast<uint2*>(stage);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float4 c = win.c[j];
      const float gr = __fmul_rn(__fmul_rn(__fmul_rn(w[j], dp_r), c.x), __fsub_rn(1.f, c.x));
      const float gg = __fmul_rn(__fmul_rn(__fmul_rn(w[j], dp_g), c.y), __fsub_rn(1.f, c.y));
      const float gb = __fmul_rn(__fmul_rn(__fmul_rn(w[j], dp_b), c.z), __fsub_rn(1.f, c.z));
      const __nv_bfloat162 lo = __floats2bfloat162_rn(gr, gg);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(gb, 0.f);
      rows[gpad(lane * K + j)] =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                     *reinterpret_cast<const unsigned*>(&hi));
    }
    __syncwarp();
    const int in_window = S - s0;
    uint4* dst = reinterpret_cast<uint4*>(d_rgb + ((size_t)r * S + s0) * 16);
#pragma unroll
    for (int q = 0; q < 2 * K; ++q) {
      const int chunk = 32 * q + lane;
      if ((chunk >> 1) < in_window) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (!(chunk & 1)) {
          const uint2 g = rows[gpad(chunk >> 1)];
          v.x = g.x;
          v.y = g.y;
        }
        dst[chunk] = v;
      }
    }
    __syncwarp();
  }
}

// K = ceil(S / 32) from 1 up to 8, then windows of 256.
int lane_samples(int S) {
  const int k = (S + 31) / 32;
  return k < 1 ? 1 : (k < kMaxK ? k : kMaxK);
}

// Vector loads need each lane's first sample aligned to the vector width:
// S a multiple of it, and every row pointer 16-byte aligned.
bool vectorizable(int S, int k, const void* a, const void* b,
                  const void* c) {
  const int v = k % 4 == 0 ? 4 : (k % 2 == 0 ? 2 : 1);
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
  };
  return v > 1 && S % v == 0 && aligned(a) && aligned(b) && aligned(c);
}

// Dynamic shared memory of a block: a staging buffer a warp (none in
// sigma-only mode), then `carries` floats a warp (the with_grad mode's
// window carries). Past the 48 KB default the kernel is opted in first.
template <int K, typename Kernel>
cudaError_t stage_bytes(Kernel kernel, int rays_per_block, size_t* bytes,
                        int carries = 0) {
  *bytes = (size_t)rays_per_block *
           (kStageFloat4s<K> * sizeof(float4) + carries * sizeof(float));
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

template <bool kSigmaOnly>
cudaError_t launch_fwd(int k, dim3 grid, dim3 block, cudaStream_t st,
                       const float* rgbs, const float* t, float* image,
                       float* depth, float* weights, int rays, int S,
                       int white_bg, int vec) {
  size_t bytes = 0;
  cudaError_t err = cudaSuccess;
#define KNT_QUAD_CASE(K)                                                    \
  case K:                                                                   \
    if (!kSigmaOnly)                                                        \
      err = stage_bytes<K>(quadrature_kernel<K, kSigmaOnly>, block.x / 32, \
                           &bytes);                                         \
    if (err != cudaSuccess) return err;                                     \
    quadrature_kernel<K, kSigmaOnly><<<grid, block, bytes, st>>>(           \
        rgbs, t, image, depth, weights, rays, S, white_bg, vec);            \
    break;
  switch (k) {
    KNT_QUAD_CASE(1) KNT_QUAD_CASE(2) KNT_QUAD_CASE(3) KNT_QUAD_CASE(4)
    KNT_QUAD_CASE(5) KNT_QUAD_CASE(6) KNT_QUAD_CASE(7) KNT_QUAD_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef KNT_QUAD_CASE
  return cudaGetLastError();
}

}  // namespace

// rgbs: [rays, S, 4] (r, g, b, sigma), or [rays, S] sigma when sigma_only;
// t: [rays, S] sorted depths; image: [rays, 3] (zeros when sigma_only);
// depth: [rays]; weights: [rays, S] or null; S >= 0 (no sample: the
// background alone). rays_per_block warps a block, 1 to 16.
KNT_EXPORT int knt_ray_march_quadrature(const float* rgbs, const float* t,
                                        float* image, float* depth,
                                        float* weights, int rays, int S,
                                        int white_bg, int sigma_only,
                                        int rays_per_block, void* stream) {
  if (rays <= 0) return 0;
  if (S < 0 || rays_per_block < 1 || 32 * rays_per_block > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int k = lane_samples(S);
  const int vec = vectorizable(S, k, t, sigma_only ? rgbs : nullptr, weights);
  const dim3 grid((rays + rays_per_block - 1) / rays_per_block);
  const dim3 block(32 * rays_per_block);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(sigma_only
                   ? launch_fwd<true>(k, grid, block, st, rgbs, t, image,
                                      depth, weights, rays, S, white_bg, vec)
                   : launch_fwd<false>(k, grid, block, st, rgbs, t, image,
                                       depth, weights, rays, S, white_bg, vec));
}

// The with_grad mode: as above (full, not sigma_only) plus target [rays, 3]
// and loss_scale = 2 / (3 R_chunk); writes d_rgb [rays * S, 16] and
// d_sigma [rays * S] bf16. 1 <= S <= 2^19.
KNT_EXPORT int knt_ray_march_quadrature_grad(const float* rgbs, const float* t,
                                             const float* target, float* image,
                                             float* depth, float* weights,
                                             __nv_bfloat16* d_rgb,
                                             __nv_bfloat16* d_sigma, int rays,
                                             int S, int white_bg, float loss_scale,
                                             int rays_per_block, void* stream) {
  if (rays <= 0) return 0;
  if (S < 1 || S > (kMaxCarries + 1) * kWindow || rays_per_block < 1 ||
      32 * rays_per_block > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int k = lane_samples(S);
  const int vec = vectorizable(S, k, t, weights, d_sigma);
  const dim3 grid((rays + rays_per_block - 1) / rays_per_block);
  const dim3 block(32 * rays_per_block);
  const cudaStream_t st = (cudaStream_t)stream;
  size_t bytes = 0;
  cudaError_t err = cudaSuccess;
#define KNT_QUAD_GRAD_CASE(K)                                               \
  case K:                                                                   \
    err = stage_bytes<K>(quadrature_grad_kernel<K>, rays_per_block, &bytes, \
                         (S + kWindow - 1) / kWindow - 1);                   \
    if (err != cudaSuccess) return (int)err;                                \
    quadrature_grad_kernel<K><<<grid, block, bytes, st>>>(                  \
        rgbs, t, target, image, depth, weights, d_rgb, d_sigma, rays, S,    \
        white_bg, loss_scale, vec);                                         \
    break;
  switch (k) {
    KNT_QUAD_GRAD_CASE(1) KNT_QUAD_GRAD_CASE(2) KNT_QUAD_GRAD_CASE(3)
    KNT_QUAD_GRAD_CASE(4) KNT_QUAD_GRAD_CASE(5) KNT_QUAD_GRAD_CASE(6)
    KNT_QUAD_GRAD_CASE(7) KNT_QUAD_GRAD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef KNT_QUAD_GRAD_CASE
  return (int)cudaGetLastError();
}
