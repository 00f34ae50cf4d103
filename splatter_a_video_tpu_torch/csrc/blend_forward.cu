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
// ids, the per-Gaussian records and the [H, W, C] output. What held the
// first version back, and what this one does about it:
//  * width: one kernel for every width ran 32 guarded accumulations per
//    applied pair, whatever C, under a 1024-thread register bound. The
//    kernel is now a template over a channel bucket CB (4, 8, ..., 32: the
//    accumulators, C rounded up to a multiple of 4) and the block size NT
//    (256, 512, 1024), each instance with its own __launch_bounds__, so
//    C = 20 on 16x16 tiles runs 20 accumulations compiled for 256 threads
//    (the explicit minimum of one block per SM matters: without it ptxas
//    aims at more blocks and spills);
//  * loads: each slot's record was gathered from seven arrays through gid
//    with nothing overlapping the load. The wrapper now packs one 32-byte
//    record per Gaussian (uv, conic, opacity, bias, pad), and the block
//    copies batch k+1 (two 16-byte cp.async per record, plus its ids and
//    feature rows, 4 bytes at a time) into the second of two shared
//    buffers while it blends batch k. The record layout and this staging
//    are K3's too, in `blend_batch.cuh`;
//  * feature rows: every applied pair read its C floats one at a time from
//    global memory; they are now staged in shared memory with the batch,
//    each row padded to a multiple of 4 floats, and read as float4 (a
//    broadcast read: all lanes of a warp read the same slot);
//  * batch size: it was the block size; it is now S = 128 slots, so a
//    double buffer of records and rows stays under 48 KB at C = 32.
// Wider rows (C > 32) run a third kind of instance: one block per tile and
// group of 32 channels, each replaying the same alpha walk (the same
// arithmetic, so the same alpha, T and stop in every group) and blending
// its own channels in the plain order; group 0 alone writes final_T,
// ncontrib and gs_idx. Each block stages only its group's 32 features of a
// slot, so shared memory stays at the C = 32 size (41,984 B) for any C,
// and the accumulators at 32 registers. The price is the replay: the
// quadratic and exp run once per group.
//
// The block still leaves its range as soon as every pixel is done
// (__syncthreads_count once per batch), which is what bounds the work in
// opaque scenes, and the per-pixel arithmetic is unchanged.
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

#include "blend_batch.cuh"

namespace {

using namespace blend;

constexpr int S = 128;   // slots per batch
constexpr int GROUP = 32;  // channels of one block of the wide instance
using FwdBatch = Batch<S, true>;

// WIDE (C > 32): block (t, y) blends channels 32y .. 32y + 31 of tile t
// (fewer in the last group). Without WIDE it blends all C <= CB channels.
template <int CB, int NT, bool WIDE>
__global__ void __launch_bounds__(NT, 1) blend_forward_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float4* __restrict__ rec, const float* __restrict__ features,
    const float* __restrict__ bg, int has_bias, int C, int W, int H, int tw, int tgx,
    int K, float* __restrict__ image, float* __restrict__ final_T,
    int* __restrict__ ncontrib, int* __restrict__ gs_idx) {
  extern __shared__ float4 smem[];
  const int P = blockDim.x;
  const int t = blockIdx.x;
  const int c0 = WIDE ? static_cast<int>(blockIdx.y) * GROUP : 0;
  const int Cg = WIDE ? min(GROUP, C - c0) : C;   // the channels this block blends
  const bool lead = !WIDE || blockIdx.y == 0;      // writes final_T, ncontrib, gs_idx
  if (!lead) K = 0;
  const int x = (t % tgx) * tw + threadIdx.x % tw;
  const int y = (t / tgx) * (P / tw) + threadIdx.x / tw;
  const bool inside = x < W && y < H;
  const float pxf = static_cast<float>(x);
  const float pyf = static_cast<float>(y);
  const long long pix = static_cast<long long>(y) * W + x;
  const int start = edges[t];
  const int end = edges[t + 1];

  float acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  int cnt = 0;
  bool done = !inside;
  if (inside) {
    for (int k = 0; k < K; ++k) gs_idx[pix * K + k] = -1;
  }

  if (start < end) {
    FwdBatch::at(smem, 0, Cg).load(gid, rec, features, Cg, start, min(S, end - start), C, c0);
  }
  __pipeline_commit();
  int q = 0;
  for (int base = start; base < end; base += S, q ^= 1) {
    // Batch q has landed for this thread's copies; the barrier makes every
    // thread's copies visible and frees buffer q ^ 1 (read last batch).
    __pipeline_wait_prior(0);
    if (__syncthreads_count(done) == P) break;
    if (base + S < end) {
      FwdBatch::at(smem, q ^ 1, Cg).load(gid, rec, features, Cg, base + S, min(S, end - base - S), C, c0);
    }
    __pipeline_commit();
    const FwdBatch b = FwdBatch::at(smem, q, Cg);
    const int n = min(S, end - base);
    for (int j = 0; !done && j < n; ++j) {
      const float4 r0 = b.rec[2 * j];       // ux, uy, conic a, conic b
      const float4 r1 = b.rec[2 * j + 1];   // conic c, opacity, bias, pad
      const float vx = r0.x - pxf;
      const float vy = r0.y - pyf;
      const float power = -0.5f * (r0.z * (vx * vx) + r1.x * (vy * vy)) - r0.w * vx * vy;
      if (power > 0.0f) continue;
      float raw = r1.y * expf(power);
      if (has_bias) raw = raw + r1.z;
      const float alpha = fminf(ALPHA_MAX, raw);
      if (alpha < ALPHA_MIN) continue;
      const float next_T = T * (1.0f - alpha);
      if (next_T < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * T;
      const float4* f = b.feat + j * (row_floats(Cg) / 4);
#pragma unroll
      for (int c4 = 0; c4 < CB / 4; ++c4) {
        if (4 * c4 >= Cg) break;
        const float4 v = f[c4];
        acc[4 * c4] = acc[4 * c4] + w * v.x;
        if (4 * c4 + 1 < Cg) acc[4 * c4 + 1] = acc[4 * c4 + 1] + w * v.y;
        if (4 * c4 + 2 < Cg) acc[4 * c4 + 2] = acc[4 * c4 + 2] + w * v.z;
        if (4 * c4 + 3 < Cg) acc[4 * c4 + 3] = acc[4 * c4 + 3] + w * v.w;
      }
      if (cnt < K) gs_idx[pix * K + cnt] = b.gid[j];
      ++cnt;
      T = next_T;
    }
  }

  if (inside) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c < Cg) image[pix * C + c0 + c] = acc[c] + T * bg[c0 + c];
    }
    if (lead) {
      final_T[pix] = T;
      ncontrib[pix] = cnt;
    }
  }
}

using KernelFn = void (*)(const int*, const int*, const float4*, const float*, const float*,
                          int, int, int, int, int, int, int, float*, float*, int*, int*);

#define BLEND_FORWARD_BUCKET(CB, WIDE)                                              \
  {blend_forward_kernel<CB, 256, WIDE>, blend_forward_kernel<CB, 512, WIDE>, \
   blend_forward_kernel<CB, 1024, WIDE>}

// [channel bucket 4, 8, ..., 32, then the wide groups of 32][block bound 256 / 512 / 1024]
const KernelFn KERNELS[9][3] = {
    BLEND_FORWARD_BUCKET(4, false),  BLEND_FORWARD_BUCKET(8, false),  BLEND_FORWARD_BUCKET(12, false),
    BLEND_FORWARD_BUCKET(16, false), BLEND_FORWARD_BUCKET(20, false), BLEND_FORWARD_BUCKET(24, false),
    BLEND_FORWARD_BUCKET(28, false), BLEND_FORWARD_BUCKET(32, false), BLEND_FORWARD_BUCKET(32, true),
};

KernelFn pick(int C, int threads) {
  const int cb = C <= 4 ? 0 : (C <= GROUP ? (C - 1) / 4 : 8);
  const int nt = threads <= 256 ? 0 : (threads <= 512 ? 1 : 2);
  return KERNELS[cb][nt];
}

// a block stages the features of at most one group
size_t shared_bytes(int C) { return 2 * sizeof(float4) * static_cast<size_t>(FwdBatch::float4s(min(C, GROUP))); }

}  // namespace

// gid: [M] int32 tile-sorted ids; edges: [T+1] int32; rec: [N, 8] f32
// packed records (ux, uy, conic a, b, c, opacity, bias, 0; bias read only
// when has_bias); features: [N, C]; bg: [C] (all on the device). Outputs:
// image [H, W, C] f32, final_T [H, W] f32, ncontrib [H, W] int32, gs_idx
// [H, W, K] int32 or null when K == 0. Any C >= 1; tw*th <= 1024 (the
// caller checks). One block of tw*th threads per tile, and per group of
// 32 channels when C > 32. Returns cudaGetLastError().
extern "C" int blend_forward(const void* gid, const void* edges, const void* rec,
                             const void* features, const void* bg, int has_bias, int C,
                             int W, int H, int tw, int th, int K, void* image,
                             void* final_T, void* ncontrib, void* gs_idx, void* stream) {
  const int tgx = (W + tw - 1) / tw;
  const int tgy = (H + th - 1) / th;
  const int threads = tw * th;
  const KernelFn fn = pick(C, threads);
  const size_t shared = shared_bytes(C);
  const dim3 grid(tgx * tgy, (C + GROUP - 1) / GROUP);
  fn<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(edges),
      static_cast<const float4*>(rec), static_cast<const float*>(features),
      static_cast<const float*>(bg), has_bias, C, W, H, tw, tgx, K,
      static_cast<float*>(image), static_cast<float*>(final_T),
      static_cast<int*>(ncontrib), static_cast<int*>(gs_idx));
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block (static + dynamic) of the instance a launch with these C and tile
// sizes runs: out[0..2]. Returns the CUDA error code.
extern "C" int blend_forward_attributes(int C, int tw, int th, int* out) {
  cudaFuncAttributes a;
  const int err = static_cast<int>(cudaFuncGetAttributes(&a, pick(C, tw * th)));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + shared_bytes(C));
  return 0;
}
