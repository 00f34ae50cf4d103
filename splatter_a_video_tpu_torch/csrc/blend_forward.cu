// K1 blend_forward: front-to-back alpha compositing of depth-sorted
// Gaussians, one pixel tile per block.
//
// Replaces `splatter_a_video_tpu/ops/rasterize_tpu.py` `_fwd_kernel`. The
// TPU kernel vectorised each tile over (pixels x 128-slot chunks) with a
// triangular-matmul log-transmittance scan, DMA double buffering of a
// packed [D, M] stream and a tiled output; none of that is carried over.
// This is the reference CUDA blender's design instead: one thread per
// pixel running the sequential rule of `rasterize_ref.py:116-154`.
//
// Bound: operations. Every pixel of a tile evaluates the Gaussian quadratic
// and exp for each Gaussian binned to its tile (~15 flops) until it
// saturates, plus 2*C flops per applied pair; bytes are only the sorted
// ids, the per-Gaussian records and the [H, W, C] output. So the design
// keeps the inner loop on shared memory and registers:
//  * the block walks its range edges[t]:edges[t+1] in batches of
//    blockDim.x; each thread loads one Gaussian's id, uv, conic, opacity
//    (and bias) into shared memory, so every record is read from device
//    memory once per tile, not once per pixel;
//  * the C accumulators live in registers (MAX_C unrolled, masked by C);
//    features are read only for applied Gaussians;
//  * the block leaves its range as soon as every pixel is done
//    (__syncthreads_count), which is what bounds the work in opaque scenes.
//
// Arithmetic: plain expf, and the file is compiled with --fmad=false, so
// each product and sum rounds exactly as in the plain PyTorch version
// (`rasterize_gpu.blend_forward_plain`) and the two agree bit for bit;
// ncontrib and gs_idx depend on threshold tests that a one-ulp change
// could flip.
//
// Outputs are written straight into the [H, W, C] image layout, masking
// pixels beyond W or H (tiles at the right and bottom edge are partial).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(1024) blend_forward_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float* __restrict__ uv, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ features,
    const float* __restrict__ opacity_bias, const float* __restrict__ bg,
    int C, int W, int H, int tw, int tgx, int K,
    float* __restrict__ image, float* __restrict__ final_T,
    int* __restrict__ ncontrib, int* __restrict__ gs_idx) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  int* s_gid = reinterpret_cast<int*>(smem);
  float* s_ux = smem + B;
  float* s_uy = smem + 2 * B;
  float* s_ca = smem + 3 * B;
  float* s_cb = smem + 4 * B;
  float* s_cc = smem + 5 * B;
  float* s_op = smem + 6 * B;
  float* s_bias = smem + 7 * B;

  const int t = blockIdx.x;
  const int x = (t % tgx) * tw + threadIdx.x % tw;
  const int y = (t / tgx) * (B / tw) + threadIdx.x / tw;
  const bool inside = x < W && y < H;
  const float pxf = static_cast<float>(x);
  const float pyf = static_cast<float>(y);
  const long long pix = static_cast<long long>(y) * W + x;
  const int start = edges[t];
  const int end = edges[t + 1];
  const bool has_bias = opacity_bias != nullptr;

  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  int cnt = 0;
  bool done = !inside;
  if (inside) {
    for (int k = 0; k < K; ++k) gs_idx[pix * K + k] = -1;
  }

  for (int base = start; base < end; base += B) {
    // also the barrier that keeps the previous batch's shared data alive
    if (__syncthreads_count(done) == B) break;
    const int idx = base + threadIdx.x;
    if (idx < end) {
      const int g = gid[idx];
      s_gid[threadIdx.x] = g;
      s_ux[threadIdx.x] = uv[2 * g];
      s_uy[threadIdx.x] = uv[2 * g + 1];
      s_ca[threadIdx.x] = conic[3 * g];
      s_cb[threadIdx.x] = conic[3 * g + 1];
      s_cc[threadIdx.x] = conic[3 * g + 2];
      s_op[threadIdx.x] = opacity[g];
      s_bias[threadIdx.x] = has_bias ? opacity_bias[g] : 0.0f;
    }
    __syncthreads();
    const int n = min(B, end - base);
    for (int j = 0; !done && j < n; ++j) {
      const float vx = s_ux[j] - pxf;
      const float vy = s_uy[j] - pyf;
      const float power =
          -0.5f * (s_ca[j] * (vx * vx) + s_cc[j] * (vy * vy)) - s_cb[j] * vx * vy;
      if (power > 0.0f) continue;
      float raw = s_op[j] * expf(power);
      if (has_bias) raw = raw + s_bias[j];
      const float alpha = fminf(ALPHA_MAX, raw);
      if (alpha < ALPHA_MIN) continue;
      const float next_T = T * (1.0f - alpha);
      if (next_T < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * T;
      const int g = s_gid[j];
      const float* f = features + static_cast<long long>(g) * C;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) acc[c] = acc[c] + w * f[c];
      }
      if (cnt < K) gs_idx[pix * K + cnt] = g;
      ++cnt;
      T = next_T;
    }
  }

  if (inside) {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) image[pix * C + c] = acc[c] + T * bg[c];
    }
    final_T[pix] = T;
    ncontrib[pix] = cnt;
  }
}

}  // namespace

// gid: [M] int32 tile-sorted ids; edges: [T+1] int32; uv: [N, 2], conic:
// [N, 3], opacity: [N], features: [N, C], opacity_bias: [N] or null, bg:
// [C] (all f32, on the device). Outputs: image [H, W, C] f32, final_T
// [H, W] f32, ncontrib [H, W] int32, gs_idx [H, W, K] int32 or null when
// K == 0. C <= MAX_C and tw*th <= 1024 (the caller checks both). One block
// of tw*th threads per tile. Returns cudaGetLastError().
extern "C" int blend_forward(const void* gid, const void* edges, const void* uv,
                             const void* conic, const void* opacity,
                             const void* features, const void* opacity_bias,
                             const void* bg, int C, int W, int H, int tw, int th,
                             int K, void* image, void* final_T, void* ncontrib,
                             void* gs_idx, void* stream) {
  const int tgx = (W + tw - 1) / tw;
  const int tgy = (H + th - 1) / th;
  const int threads = tw * th;
  const size_t shared = 8 * sizeof(float) * static_cast<size_t>(threads);
  blend_forward_kernel<<<tgx * tgy, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(edges),
      static_cast<const float*>(uv), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), static_cast<const float*>(features),
      static_cast<const float*>(opacity_bias), static_cast<const float*>(bg),
      C, W, H, tw, tgx, K, static_cast<float*>(image),
      static_cast<float*>(final_T), static_cast<int*>(ncontrib),
      static_cast<int*>(gs_idx));
  return static_cast<int>(cudaGetLastError());
}
