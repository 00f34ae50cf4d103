// SSIM: the structural similarity of `ops/ssim.py`, forward and backward, as
// a fused kernel pair.
//
// Replaces no TPU kernel. The JAX package (`splatter_a_video_tpu/ops/ssim.py`)
// applies the 11-tap Gaussian window as dense products with [H, H] and
// [W, W] band matrices, B_H @ img @ B_W^T, which XLA runs on the TPU's
// matrix unit. On this card the same products are float32 SIMT GEMMs (TF32
// stays off: SSIM's variances cancel), and 99.6% of their multiplies are by
// zeros: 2 x 24.9M x (2160 + 3840) = 3.0e11 flops a blur at 3840x2160x3,
// 2.4e12 for the five blurs forward and three backward of a train step.
//
// Bound: operations. The separable blur needs 2 x 11 multiply-adds a pass,
// two passes, for each pixel and channel; eight blurs and ~60 operations of
// the map forward and backward make 412 a pixel and channel: 1.03e10 at
// 3840x2160x3, 0.153 ms at 67 TFLOP/s. The bytes, x and y read once and
// the gradient written once (12 B a pixel and channel, 0.30 GB), take
// 0.089 ms at 3.35 TB/s. Built with --fmad=false, each multiply-add is two
// instructions, so the float32 pipes allow about twice the bound's time.
//
// Design. An image is H rows of W*C floats (channel-last), so a tile row of
// tp pixels and cc channels (cc = C up to 8: the loss's three) is one
// contiguous load, and the tap at pixel p + k of channel c sits k*cc floats
// on in the staged row: C is only a stride. A block owns one tile of TH rows
// of one image; the grid and the tile follow from N, H, W and C alone.
//
//  1. ssim_forward_kernel stages the tile and a halo of R = 5 rows and
//     pixels of x and y in shared memory, zeros outside the image: the
//     zero-padded "same" blur that the band matrices encode, truncated at
//     the borders. The horizontal pass forms mu_x, mu_y, E[x^2], E[y^2] and
//     E[xy] of every staged row into shared memory, four pixels of one
//     channel a thread from 14 staged values; the vertical pass keeps four
//     output rows of one float a thread in registers, so each row of the
//     horizontal pass is read once for four outputs. The map is the
//     plain formula, sigma = E[x^2] - mu^2 (a centred variance would be
//     another function at the zero-padded borders). Each block writes its
//     map's sum, taken in a fixed tree, to one slot of a buffer, which the
//     caller adds up per image (or all, for the mean) in a fixed order: no
//     float atomics, so that a fit repeats bit for bit.
//     Where an input needs a gradient the kernel also writes the map's
//     partial derivatives by E[x^2] (equal to that by E[y^2]) and E[xy],
//     and by mu_x and / or mu_y: 3 planes of N*H*W*C floats (4 when both
//     inputs need one), 0.30 GB at 3840x2160x3, stored, since recomputing
//     them would cost the backward a second halo and the five forward blurs.
//  2. ssim_backward_kernel: the zero-padded blur with a symmetric window is
//     its own adjoint (B^T = B), so for the mean over n floats and an
//     upstream gradient g,
//        dL/dx = g/n [blur(dm/dmu_x) + 2x blur(dm/dE[x^2]) + y blur(dm/dE[xy])]
//     and the same for y with x and y swapped. It stages the planes with the
//     same halo (partials outside the image are 0), runs the same two
//     passes, and reads x and y at the output.
//
// Everything is float32 and built with --fmad=false. Each blurred value is
// summed over k = 0..10 in order from 0, where the band products sum in
// cuBLAS's order, so the kernels and the plain version differ in the last
// bits; two launches on the same inputs give the same bits.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int R = 5;                   // window radius
constexpr int TAPS = 2 * R + 1;
constexpr int TH = 16;                 // output rows of a tile
constexpr int ROWS = TH + 2 * R;       // staged rows
constexpr int RPT = 4;                 // output rows of a thread in the vertical pass
constexpr int QH = 4;                  // output pixels of a thread in the horizontal pass
constexpr int TE = 96;                 // most output floats of a tile row (tp * cc)
constexpr int CC_MAX = 8;              // most channels of a tile
constexpr int NT = TH / RPT * TE;      // 384 threads: one (4 rows, 1 float) each in the vertical pass

struct Window {
  float w[TAPS];   // the normalised Gaussian, rounded to float32 as in ops/ssim.py
  float c1, c2;
};

struct Geometry {
  int N, H, W, C;
  int cc, tp, chunks, tiles_x, tiles_y;
};

Geometry geometry(int N, int H, int W, int C) {
  Geometry g;
  g.N = N, g.H = H, g.W = W, g.C = C;
  g.cc = C < CC_MAX ? C : CC_MAX;
  g.tp = TE / g.cc / QH * QH;   // whole groups of the horizontal pass
  g.chunks = (C + g.cc - 1) / g.cc;
  g.tiles_x = (W + g.tp - 1) / g.tp;
  g.tiles_y = (H + TH - 1) / TH;
  return g;
}

long long block_count(const Geometry& g) {
  return static_cast<long long>(g.N) * g.tiles_y * g.tiles_x * g.chunks;
}

// floats of a staged row: tp + 2R pixels of cc channels
__host__ __device__ inline int staged_width(const Geometry& g) { return (g.tp + 2 * R) * g.cc; }

size_t shared_bytes(const Geometry& g, int staged_planes, int quantities) {
  return sizeof(float) * ROWS * (static_cast<size_t>(staged_planes) * staged_width(g) +
                                 static_cast<size_t>(quantities) * g.tp * g.cc);
}

// The block's image, first row, first pixel and first channel. Blocks of one
// image are consecutive, so an image's block sums are one segment.
struct Place {
  int n, y0, x0, c0;
};

__device__ inline Place place(const Geometry& g) {
  int b = static_cast<int>(blockIdx.x);
  Place p;
  p.c0 = (b % g.chunks) * g.cc;
  b /= g.chunks;
  p.x0 = (b % g.tiles_x) * g.tp;
  b /= g.tiles_x;
  p.y0 = (b % g.tiles_y) * TH;
  p.n = b / g.tiles_y;
  return p;
}

// Stage rows y0 - R .. y0 + TH + R - 1, pixels x0 - R .. x0 + tp + R - 1 and
// channels c0 .. c0 + cc - 1 of the NS planes src[s] into dst[s][ROWS][sw],
// zeros outside the image.
template <int NS>
__device__ void stage(const Geometry& g, const Place& p, const float* const* src, float* dst) {
  const int sw = staged_width(g);
  for (int i = threadIdx.x; i < ROWS * sw; i += NT) {
    const int r = i / sw, j = i - r * sw;
    const int px = j / g.cc, ch = j - px * g.cc;
    const int y = p.y0 - R + r, x = p.x0 - R + px, c = p.c0 + ch;
    const bool in = y >= 0 && y < g.H && x >= 0 && x < g.W && c < g.C;
    const long long off = ((static_cast<long long>(p.n) * g.H + y) * g.W + x) * g.C + c;
#pragma unroll
    for (int s = 0; s < NS; ++s) dst[s * ROWS * sw + i] = in ? src[s][off] : 0.0f;
  }
}

// The horizontal pass: out[q][r][e] = sum over k of w[k] * v_q(r, e + k*cc)
// for e < tp*cc and every staged row r, where quantities(i, v) forms the NQ
// values v_q at staged index i. A thread takes QH consecutive pixels of one
// channel, so each staged value it forms serves up to 11 of its sums.
template <int NQ, class Quantities>
__device__ void horizontal(const Geometry& g, const Window& win, float* out, Quantities quantities) {
  const int sw = staged_width(g), te = g.tp * g.cc;
  const int per_row = g.tp / QH * g.cc;
  for (int i = threadIdx.x; i < ROWS * per_row; i += NT) {
    const int r = i / per_row, j = i - r * per_row;
    const int gq = j / g.cc, ch = j - gq * g.cc;
    const int first = r * sw + gq * QH * g.cc + ch;   // staged index of tap 0 of the first pixel
    float a[QH][NQ];
#pragma unroll
    for (int t = 0; t < QH; ++t)
#pragma unroll
      for (int q = 0; q < NQ; ++q) a[t][q] = 0.0f;
#pragma unroll
    for (int u = 0; u < QH + 2 * R; ++u) {
      float v[NQ];
      quantities(first + u * g.cc, v);
#pragma unroll
      for (int t = 0; t < QH; ++t) {
        const int k = u - t;
        if (k >= 0 && k < TAPS) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) a[t][q] += win.w[k] * v[q];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < QH; ++t)
#pragma unroll
      for (int q = 0; q < NQ; ++q) out[(q * ROWS + r) * te + (gq * QH + t) * g.cc + ch] = a[t][q];
  }
}

// The vertical pass over the horizontal pass's rows h[q][ROWS][te]: each
// thread sums RPT consecutive output rows of one float, each over k = 0..10
// in order, then calls epilogue(offset in the image, sums) for those inside
// the image.
template <int NQ, class Epilogue>
__device__ void vertical(const Geometry& g, const Place& p, const Window& win, const float* h,
                         Epilogue epilogue) {
  const int te = g.tp * g.cc;
  for (int i = threadIdx.x; i < TH / RPT * te; i += NT) {
    const int r0 = i / te * RPT, e = i - i / te * te;
    float a[RPT][NQ];
#pragma unroll
    for (int t = 0; t < RPT; ++t)
#pragma unroll
      for (int q = 0; q < NQ; ++q) a[t][q] = 0.0f;
#pragma unroll
    for (int j = 0; j < RPT + 2 * R; ++j) {
      float v[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) v[q] = h[(q * ROWS + r0 + j) * te + e];
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        const int k = j - t;
        if (k >= 0 && k < TAPS) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) a[t][q] += win.w[k] * v[q];
        }
      }
    }
    const int px = e / g.cc, c = p.c0 + e - px * g.cc, x = p.x0 + px;
    if (x >= g.W || c >= g.C) continue;
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      const int y = p.y0 + r0 + t;
      if (y < g.H) epilogue((((static_cast<long long>(p.n) * g.H + y) * g.W + x) * g.C + c), a[t]);
    }
  }
}

// The block's sum of v, in a fixed order; valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < NT / 32; ++w) s += warp_sums[w];
  }
  return s;
}

// planes: [2 + NX + NY][N*H*W*C], in order dm/dE[x^2] (= dm/dE[y^2]),
// dm/dE[xy], then dm/dmu_x if NX and dm/dmu_y if NY; not written when
// neither input needs a gradient.
template <bool NX, bool NY>
__global__ void __launch_bounds__(NT, 2) ssim_forward_kernel(
    Geometry g, Window win, const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ block_sums, float* __restrict__ planes) {
  extern __shared__ float smem[];
  const int plane = ROWS * staged_width(g);
  float* staged = smem;              // x, y: [2][ROWS][sw]
  float* h = smem + 2 * plane;       // mu_x, mu_y, E[x^2], E[y^2], E[xy]: [5][ROWS][te]
  const Place p = place(g);
  const float* src[2] = {x, y};
  stage<2>(g, p, src, staged);
  __syncthreads();
  horizontal<5>(g, win, h, [&](int i, float (&v)[5]) {
    const float a = staged[i], b = staged[plane + i];
    v[0] = a, v[1] = b, v[2] = a * a, v[3] = b * b, v[4] = a * b;
  });
  __syncthreads();
  const long long total = static_cast<long long>(g.N) * g.H * g.W * g.C;
  float sum = 0.0f;
  vertical<5>(g, p, win, h, [&](long long off, const float (&b)[5]) {
    const float mu1 = b[0], mu2 = b[1];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float s1 = b[2] - mu1_sq, s2 = b[3] - mu2_sq, s12 = b[4] - mu1_mu2;
    const float a1 = 2.0f * mu1_mu2 + win.c1, a2 = 2.0f * s12 + win.c2;
    const float b1 = mu1_sq + mu2_sq + win.c1, b2 = s1 + s2 + win.c2;
    const float den = b1 * b2;
    const float m = a1 * a2 / den;
    sum += m;
    if (NX || NY) {
      // m = a1 a2 / (b1 b2): a1 and b1 move with mu, a2 with E[xy] and mu,
      // b2 with E[x^2], E[y^2] and mu
      planes[off] = -m / b2;
      planes[total + off] = 2.0f * a1 / den;
      const float t = (a2 - a1) / den, u = m / b2 - m / b1;
      if (NX) planes[2 * total + off] = 2.0f * (mu2 * t + mu1 * u);
      if (NY) planes[(NX ? 3 : 2) * total + off] = 2.0f * (mu1 * t + mu2 * u);
    }
  });
  sum = block_sum(sum);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = sum;
}

// gx = scale[n] (blur(dm/dmu_x) + 2x blur(dm/dE[x^2]) + y blur(dm/dE[xy])),
// gy the same with x and y swapped, from the forward's planes.
template <bool NX, bool NY>
__global__ void __launch_bounds__(NT, 2) ssim_backward_kernel(
    Geometry g, Window win, const float* __restrict__ planes, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ scale, float* __restrict__ gx,
    float* __restrict__ gy) {
  constexpr int NQ = 2 + NX + NY;
  extern __shared__ float smem[];
  const int plane = ROWS * staged_width(g);
  float* staged = smem;              // the planes: [NQ][ROWS][sw]
  float* h = smem + NQ * plane;      // their horizontal pass: [NQ][ROWS][te]
  const Place p = place(g);
  const long long total = static_cast<long long>(g.N) * g.H * g.W * g.C;
  const float* src[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) src[q] = planes + q * total;
  stage<NQ>(g, p, src, staged);
  __syncthreads();
  horizontal<NQ>(g, win, h, [&](int i, float (&v)[NQ]) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = staged[q * plane + i];
  });
  __syncthreads();
  const float s = scale[p.n];
  vertical<NQ>(g, p, win, h, [&](long long off, const float (&b)[NQ]) {
    const float xv = x[off], yv = y[off];
    if (NX) gx[off] = s * (b[2] + 2.0f * xv * b[0] + yv * b[1]);
    if (NY) gy[off] = s * (b[NQ - 1] + 2.0f * yv * b[0] + xv * b[1]);
  });
}

using ForwardFn = void (*)(Geometry, Window, const float*, const float*, float*, float*);
using BackwardFn = void (*)(Geometry, Window, const float*, const float*, const float*, const float*,
                            float*, float*);

ForwardFn forward_instance(int need_x, int need_y) {
  if (need_x && need_y) return &ssim_forward_kernel<true, true>;
  if (need_x) return &ssim_forward_kernel<true, false>;
  if (need_y) return &ssim_forward_kernel<false, true>;
  return &ssim_forward_kernel<false, false>;
}

BackwardFn backward_instance(int need_x, int need_y) {
  if (need_x && need_y) return &ssim_backward_kernel<true, true>;
  if (need_x) return &ssim_backward_kernel<true, false>;
  return &ssim_backward_kernel<false, true>;
}

template <class Fn>
int allow_shared(Fn fn, size_t shared) {
  if (shared <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shared)));
}

Window window(const float* taps) {
  Window w;
  for (int k = 0; k < TAPS; ++k) w.w[k] = taps[k];
  w.c1 = taps[TAPS];
  w.c2 = taps[TAPS + 1];
  return w;
}

bool valid(int N, int H, int W, int C) {
  return N >= 1 && H >= 1 && W >= 1 && C >= 1 && block_count(geometry(N, H, W, C)) <= INT_MAX;
}

}  // namespace

// Slots of block sums that ssim_forward writes for [N, H, W, C]: each
// image's are consecutive, the same number for every image.
extern "C" long long ssim_block_count(int N, int H, int W, int C) {
  return block_count(geometry(N, H, W, C));
}

// x, y: [N, H, W, C] float32, contiguous; taps: 13 host floats, the 11
// window weights, C1 and C2; block_sums: ssim_block_count floats, each
// block's sum of the map; planes:
// [2 + need_x + need_y, N, H, W, C] (unused if neither needs a gradient).
// Returns cudaGetLastError() after the launch.
extern "C" int ssim_forward(const void* x, const void* y, int N, int H, int W, int C,
                            const float* taps, int need_x, int need_y, void* block_sums,
                            void* planes, void* stream) {
  if (!valid(N, H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(N, H, W, C);
  const ForwardFn fn = forward_instance(need_x, need_y);
  const size_t shared = shared_bytes(g, 2, 5);
  int err = allow_shared(fn, shared);
  if (err != 0) return err;
  fn<<<static_cast<unsigned>(block_count(g)), NT, shared, static_cast<cudaStream_t>(stream)>>>(
      g, window(taps), static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(block_sums), static_cast<float*>(planes));
  return static_cast<int>(cudaGetLastError());
}

// planes: the forward's, made with the same need_x and need_y (at least one
// set); x, y as the forward's; scale: [N] floats, the upstream gradient of
// each image's term over the floats it averages; gx / gy: [N, H, W, C]
// outputs, written where need_x / need_y. Returns cudaGetLastError().
extern "C" int ssim_backward(const void* planes, const void* x, const void* y, const void* scale,
                             int N, int H, int W, int C, const float* taps, int need_x, int need_y,
                             void* gx, void* gy, void* stream) {
  if (!valid(N, H, W, C) || !(need_x || need_y)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(N, H, W, C);
  const BackwardFn fn = backward_instance(need_x, need_y);
  const int nq = 2 + (need_x ? 1 : 0) + (need_y ? 1 : 0);
  const size_t shared = shared_bytes(g, nq, nq);
  int err = allow_shared(fn, shared);
  if (err != 0) return err;
  fn<<<static_cast<unsigned>(block_count(g)), NT, shared, static_cast<cudaStream_t>(stream)>>>(
      g, window(taps), static_cast<const float*>(planes), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(scale), static_cast<float*>(gx),
      static_cast<float*>(gy));
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block (static, plus the dynamic bytes of a launch at C channels) of the
// forward (backward = 0) or backward instance for need_x / need_y: out[0..2].
// Returns the CUDA error code.
extern "C" int ssim_attributes(int backward, int need_x, int need_y, int C, int* out) {
  cudaFuncAttributes a;
  const Geometry g = geometry(1, 1, 1, C < 1 ? 1 : C);
  const int nq = 2 + (need_x ? 1 : 0) + (need_y ? 1 : 0);
  const int err = static_cast<int>(
      backward ? cudaFuncGetAttributes(&a, backward_instance(need_x, need_y))
               : cudaFuncGetAttributes(&a, forward_instance(need_x, need_y)));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + (backward ? shared_bytes(g, nq, nq) : shared_bytes(g, 2, 5)));
  return 0;
}
