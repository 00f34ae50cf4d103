// K3 blend_backward: per-slot gradients of the front-to-back blend, one
// pixel tile per block.
//
// Replaces `splatter_a_video_tpu/ops/rasterize_tpu.py` `_bwd_kernel`. The
// TPU kernel re-swept each tile's packed [D, M] stream in 128-slot chunks
// with triangular-matmul scans and merged boundary chunks in a pending
// accumulator carried across its sequential grid. None of that carries
// over: blocks run in parallel and in no order, so each block owns the
// slots of its tile and writes every one of them exactly once.
//
// Per pixel (one thread each) the block replays K1's forward exactly, with
// the same order, expf, skip and stop tests (`blend_forward.cu`, also built
// with --fmad=false), so its applied set equals K1's ncontrib bit for bit.
// The suffix of the blend is total - prefix, where total is read from the
// saved output (the TPU kernel's method, no back-to-front second sweep):
//
//   G     = sum_c g_c f_c                  (masked channels: g_c * mask_c)
//   total = sum_c g_c out_c - T_fin * sum_c g_c bg_c
//   dL/dalpha = G T_excl - (total - prefix_incl + T_fin B) / (1 - alpha)
//
// with alpha's 0.99 clamp ignored (the CUDA reference's convention):
// dop = exp(power) dalpha_op, dpower = op exp(power) dalpha_all, and
// dbias = dalpha_op in the bias variant.
//
// Each slot's row (duv 2, dconic 3, dop 1, dfeat C, |duv| 2, [dbias 1]) is
// summed over the tile's pixels by a fixed tree: warp shuffles (lane i
// takes lane i + 16, 8, 4, 2, 1), then the warps' partial sums in warp
// order through shared memory. No float atomics: the result is the same
// from run to run, and the plain PyTorch version
// (`rasterize_gpu.blend_backward_plain`) repeats the same tree.
//
// Bound: operations, like K1 (the same replay per pixel and Gaussian, plus
// ~40 + 4C flops per applied pair). This first version is simple, not
// fast: two barriers and R five-step shuffle reductions per Gaussian.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(512) blend_backward_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float* __restrict__ uv, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ features,
    const float* __restrict__ opacity_bias, const float* __restrict__ bg,
    const float* __restrict__ mask, const float* __restrict__ image,
    const float* __restrict__ final_T, const float* __restrict__ grad,
    int C, int W, int H, int tw, int tgx, int R,
    float* __restrict__ dgrad, int* __restrict__ ncontrib) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int nwarp = B >> 5;
  int* s_gid = reinterpret_cast<int*>(smem);
  float* s_ux = smem + B;
  float* s_uy = smem + 2 * B;
  float* s_ca = smem + 3 * B;
  float* s_cb = smem + 4 * B;
  float* s_cc = smem + 5 * B;
  float* s_op = smem + 6 * B;
  float* s_bias = smem + 7 * B;
  float* s_red = smem + 8 * B;                 // [nwarp, R] warp partial sums
  float* s_bg = s_red + nwarp * R;             // [C]
  float* s_mask = s_bg + C;                    // [C]

  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = (t % tgx) * tw + threadIdx.x % tw;
  const int y = (t / tgx) * (B / tw) + threadIdx.x / tw;
  const bool inside = x < W && y < H;
  const float pxf = static_cast<float>(x);
  const float pyf = static_cast<float>(y);
  const long long pix = static_cast<long long>(y) * W + x;
  const int start = edges[t];
  const int end = edges[t + 1];
  const bool has_bias = opacity_bias != nullptr;
  if (threadIdx.x < C) {
    s_bg[threadIdx.x] = bg[threadIdx.x];
    s_mask[threadIdx.x] = mask[threadIdx.x];
  }
  __syncthreads();

  // per-pixel constants of the backward
  float g[MAX_C];
  float B_all = 0.0f, B_op = 0.0f, tot_all = 0.0f, tot_op = 0.0f, Tfin = 0.0f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) g[c] = 0.0f;
  if (inside) {
    Tfin = final_T[pix];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) {
        g[c] = grad[pix * C + c];
        const float gm = g[c] * s_mask[c];
        const float o = image[pix * C + c];
        B_all = B_all + g[c] * s_bg[c];
        B_op = B_op + gm * s_bg[c];
        tot_all = tot_all + g[c] * o;
        tot_op = tot_op + gm * o;
      }
    }
    tot_all = tot_all - Tfin * B_all;
    tot_op = tot_op - Tfin * B_op;
  }

  float T = 1.0f;
  float pre_all = 0.0f, pre_op = 0.0f;
  int cnt = 0;
  bool done = !inside;

  for (int base = start; base < end; base += B) {
    // also the barrier that keeps the previous batch's shared data alive
    if (__syncthreads_count(done) == B) {
      // every pixel has stopped: the rest of the tile's slots get zero rows
      for (long long i = static_cast<long long>(base) * R + threadIdx.x;
           i < static_cast<long long>(end) * R; i += B)
        dgrad[i] = 0.0f;
      break;
    }
    const int idx = base + threadIdx.x;
    if (idx < end) {
      const int gg = gid[idx];
      s_gid[threadIdx.x] = gg;
      s_ux[threadIdx.x] = uv[2 * gg];
      s_uy[threadIdx.x] = uv[2 * gg + 1];
      s_ca[threadIdx.x] = conic[3 * gg];
      s_cb[threadIdx.x] = conic[3 * gg + 1];
      s_cc[threadIdx.x] = conic[3 * gg + 2];
      s_op[threadIdx.x] = opacity[gg];
      s_bias[threadIdx.x] = has_bias ? opacity_bias[gg] : 0.0f;
    }
    __syncthreads();
    const int n = min(B, end - base);
    for (int j = 0; j < n; ++j) {
      // ---- K1's forward step, term for term ----
      bool app = false;
      float vx = 0.0f, vy = 0.0f, gexp = 0.0f, alpha = 0.0f, T_excl = 0.0f, w = 0.0f;
      if (!done) {
        vx = s_ux[j] - pxf;
        vy = s_uy[j] - pyf;
        const float power =
            -0.5f * (s_ca[j] * (vx * vx) + s_cc[j] * (vy * vy)) - s_cb[j] * vx * vy;
        if (power <= 0.0f) {
          gexp = expf(power);
          float raw = s_op[j] * gexp;
          if (has_bias) raw = raw + s_bias[j];
          alpha = fminf(ALPHA_MAX, raw);
          if (alpha >= ALPHA_MIN) {
            const float next_T = T * (1.0f - alpha);
            if (next_T < T_EPS) {
              done = true;
            } else {
              app = true;
              T_excl = T;
              w = alpha * T;
              T = next_T;
              ++cnt;
            }
          }
        }
      }
      // ---- this pixel's gradient terms for slot base + j ----
      float duvx = 0.0f, duvy = 0.0f, dca = 0.0f, dcb = 0.0f, dcc = 0.0f;
      float dop = 0.0f, dbias = 0.0f;
      if (app) {
        const float* f = features + static_cast<long long>(s_gid[j]) * C;
        float G_all = 0.0f, G_op = 0.0f;
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          if (c < C) {
            G_all = G_all + g[c] * f[c];
            G_op = G_op + (g[c] * s_mask[c]) * f[c];
          }
        }
        pre_all = pre_all + G_all * w;
        pre_op = pre_op + G_op * w;
        const float one_m = 1.0f - alpha;
        const float dal_all = G_all * T_excl - ((tot_all - pre_all) + Tfin * B_all) / one_m;
        const float dal_op = G_op * T_excl - ((tot_op - pre_op) + Tfin * B_op) / one_m;
        dop = gexp * dal_op;
        const float dpow = s_op[j] * gexp * dal_all;
        duvx = dpow * (-(s_ca[j] * vx + s_cb[j] * vy));
        duvy = dpow * (-(s_cc[j] * vy + s_cb[j] * vx));
        dca = dpow * (-0.5f * vx * vx);
        dcb = dpow * (-vx * vy);
        dcc = dpow * (-0.5f * vy * vy);
        dbias = dal_op;
      }
      float* out = dgrad + static_cast<long long>(base + j) * R;
      if (!__syncthreads_or(app)) {
        if (threadIdx.x < R) out[threadIdx.x] = 0.0f;
        continue;
      }
      // ---- fixed-order sums over the tile's pixels ----
      auto put = [&](int r, float v) {
        v = warp_tree_sum(v);
        if (lane == 0) s_red[warp * R + r] = v;
      };
      put(0, duvx);
      put(1, duvy);
      put(2, dca);
      put(3, dcb);
      put(4, dcc);
      put(5, dop);
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) put(6 + c, g[c] * w);
      }
      put(6 + C, fabsf(duvx));
      put(7 + C, fabsf(duvy));
      if (has_bias) put(8 + C, dbias);
      __syncthreads();
      if (threadIdx.x < R) {
        float acc = 0.0f;
        for (int k = 0; k < nwarp; ++k) acc = acc + s_red[k * R + threadIdx.x];
        out[threadIdx.x] = acc;
      }
      // the next __syncthreads_or (or the batch's barrier) guards s_red
    }
  }

  if (ncontrib != nullptr && inside) ncontrib[pix] = cnt;
}

}  // namespace

// gid: [M] int32 tile-sorted ids; edges: [T+1] int32; uv [N, 2], conic
// [N, 3], opacity [N], features [N, C], opacity_bias [N] or null, bg [C],
// mask [C] (alpha_grad_mask), image [H, W, C] and final_T [H, W] (K1's
// outputs), grad [H, W, C] (dL/dimage), all f32 on the device. Writes
// dgrad [M, R] f32 with R = 8 + C (+1 with a bias) for every slot in
// [edges[0], edges[T]); slots past edges[T] are not written. ncontrib
// [H, W] int32 (or null) gets the replay's applied count. C <= MAX_C,
// tw*th <= 512 and a multiple of 32 (the caller checks). One block of
// tw*th threads per tile. Returns cudaGetLastError().
extern "C" int blend_backward(const void* gid, const void* edges, const void* uv,
                              const void* conic, const void* opacity,
                              const void* features, const void* opacity_bias,
                              const void* bg, const void* mask, const void* image,
                              const void* final_T, const void* grad, int C, int W,
                              int H, int tw, int th, void* dgrad, void* ncontrib,
                              void* stream) {
  const int tgx = (W + tw - 1) / tw;
  const int tgy = (H + th - 1) / th;
  const int threads = tw * th;
  const int R = 8 + C + (opacity_bias != nullptr ? 1 : 0);
  const size_t shared =
      sizeof(float) * (8 * static_cast<size_t>(threads) + (threads / 32) * R + 2 * C);
  blend_backward_kernel<<<tgx * tgy, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(edges),
      static_cast<const float*>(uv), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), static_cast<const float*>(features),
      static_cast<const float*>(opacity_bias), static_cast<const float*>(bg),
      static_cast<const float*>(mask), static_cast<const float*>(image),
      static_cast<const float*>(final_T), static_cast<const float*>(grad), C, W, H, tw,
      tgx, R, static_cast<float*>(dgrad), static_cast<int*>(ncontrib));
  return static_cast<int>(cudaGetLastError());
}
