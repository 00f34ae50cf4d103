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
// summed over the tile's pixels by a fixed tree: within each warp, lane i
// takes lane i + 16, 8, 4, 2, 1; then the warps' partial sums are added in
// warp order. No float atomics: the result is the same from run to run,
// and the plain PyTorch version (`rasterize_gpu.blend_backward_plain`,
// `_tile_tree_sum`) repeats the same tree.
//
// Bound: operations, like K1 (the same replay per pixel and Gaussian, plus
// ~40 + 4C flops per applied pair). The first version spent most of its
// time outside that work; this one removes it:
//  * it synchronised the block twice per slot (__syncthreads_or, then a
//    barrier before the cross-warp sum). The warps now run a batch of
//    S = 32 slots independently: each writes its partial rows to shared
//    memory as [S][warp][row] and one bit per slot saying whether any of
//    its lanes applied the slot; one barrier then lets all threads add the
//    (slot, row) pairs in warp order, in parallel, and write them out as
//    one contiguous block of rows. Two barriers per batch in all;
//  * it ran R five-step shuffle trees in every warp for every slot. A warp
//    in which no lane applied the slot (__any_sync) now does no shuffles
//    and sets no bit: its lanes hold exact zeros, which add nothing. The
//    others sum their rows with a reduce-scatter, 16 rows at a time
//    (8 + 4 + 2 + 1 + 1 = 16 shuffles instead of 80): at the step of
//    offset o each lane keeps the half of its rows selected by bit o and
//    adds its partner's copy. Every row still goes through the tree above,
//    with the two addends of some nodes swapped, and float addition is
//    commutative, so the sums are bit for bit those of `_tile_tree_sum`;
//  * the cross-warp sum was serial (R threads, the rest waiting). It is
//    now spread over the block;
//  * its registers were sized for 32 channels and 512 threads. The kernel
//    is a template over a channel bucket (8, 16, 32) and the block size
//    (256, 512), each instance with its own __launch_bounds__ (one block
//    per SM at least: higher minimums measured slower);
//  * its loads were gathered from seven arrays through gid with nothing
//    overlapping them, and feature rows came from global memory for each
//    applied pair, one float at a time. As in K1, the wrapper packs one
//    32-byte record per Gaussian, batch k+1's records and feature rows are
//    copied into a second shared buffer with cp.async while batch k is
//    replayed (K1's staging and record layout, `blend_batch.cuh`), and the
//    rows (padded to 4 floats) are read as float4; the masked gradient
//    g_c * mask_c is formed once per pixel, not per pair.

#include <cuda_runtime.h>

#include "blend_batch.cuh"

namespace {

using namespace blend;

constexpr unsigned FULL = 0xffffffffu;
constexpr int S = 32;         // slots per batch (one bit each in a warp's mask)
constexpr int BASE_ROWS = 9;  // duv 2, dconic 3, dop 1, |duv| 2, dbias 1
constexpr int MAX_PIXELS = 512;
using BwdBatch = Batch<S, false>;

// Internal row order: the 9 base rows, then dfeat 0 .. C-1; padded to a
// multiple of 16 for the reduce-scatter.
__host__ __device__ __forceinline__ int padded_rows(int C) {
  return (BASE_ROWS + C + 15) / 16 * 16;
}

// Internal row of output row r (duv 2, dconic 3, dop 1, dfeat C, |duv| 2,
// [dbias]).
__device__ __forceinline__ int internal_row(int r, int C) {
  if (r < 6) return r;
  if (r < 6 + C) return BASE_ROWS + (r - 6);
  return r - C;
}

// One step of the reduce-scatter at offset 2h: the lane keeps rows
// [0, h) or [h, 2h) of v (by its bit 2h) and adds its partner's copy.
template <int HALF>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[16], int lane) {
  const bool hi = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? v[i] : v[i + HALF];
    const float keep = hi ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 2 * HALF);
  }
}

// Sum v[0..15] over the warp's 32 lanes; lane l returns row l >> 1 (bit 16
// of the lane picks +8, bit 8 +4, bit 4 +2, bit 2 +1).
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

template <int CB, int NT>
__global__ void __launch_bounds__(NT, 1) blend_backward_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float4* __restrict__ rec, const float* __restrict__ features,
    const float* __restrict__ bg, const float* __restrict__ mask,
    const float* __restrict__ image, const float* __restrict__ final_T,
    const float* __restrict__ grad, int has_bias, int C, int W, int H, int tw, int tgx,
    float* __restrict__ dgrad, int* __restrict__ ncontrib) {
  extern __shared__ float4 smem[];
  const int P = blockDim.x;
  const int nwarp = P >> 5;
  const int R = 8 + C + has_bias;
  const int RP = padded_rows(C);
  const int groups = RP / 16;
  // two batch buffers, then [S][nwarp][RP] partial rows, the warps' masks,
  // bg and mask
  float* s_part = reinterpret_cast<float*>(smem + 2 * BwdBatch::float4s(C));
  unsigned* s_any = reinterpret_cast<unsigned*>(s_part + S * nwarp * RP);
  float* s_bg = reinterpret_cast<float*>(s_any + nwarp);
  float* s_mask = s_bg + C;

  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = (t % tgx) * tw + threadIdx.x % tw;
  const int y = (t / tgx) * (P / tw) + threadIdx.x / tw;
  const bool inside = x < W && y < H;
  const float pxf = static_cast<float>(x);
  const float pyf = static_cast<float>(y);
  const long long pix = static_cast<long long>(y) * W + x;
  const int start = edges[t];
  const int end = edges[t + 1];

  if (start < end) BwdBatch::at(smem, 0, C).load(gid, rec, features, C, start, min(S, end - start));
  __pipeline_commit();
  if (threadIdx.x < C) {
    s_bg[threadIdx.x] = bg[threadIdx.x];
    s_mask[threadIdx.x] = mask[threadIdx.x];
  }
  __syncthreads();

  // per-pixel constants of the backward
  float g[CB], gm[CB];   // dL/dimage, and its opacity-masked copy
  float B_all = 0.0f, B_op = 0.0f, tot_all = 0.0f, tot_op = 0.0f, Tfin = 0.0f;
#pragma unroll
  for (int c = 0; c < CB; ++c) g[c] = gm[c] = 0.0f;
  if (inside) {
    Tfin = final_T[pix];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c < C) {
        g[c] = grad[pix * C + c];
        gm[c] = g[c] * s_mask[c];
        const float o = image[pix * C + c];
        B_all = B_all + g[c] * s_bg[c];
        B_op = B_op + gm[c] * s_bg[c];
        tot_all = tot_all + g[c] * o;
        tot_op = tot_op + gm[c] * o;
      }
    }
    tot_all = tot_all - Tfin * B_all;
    tot_op = tot_op - Tfin * B_op;
  }

  float T = 1.0f;
  float pre_all = 0.0f, pre_op = 0.0f;
  int cnt = 0;
  bool done = !inside;

  int q = 0;
  for (int base = start; base < end; base += S, q ^= 1) {
    // Batch q has landed; the barrier also frees buffer q ^ 1 and the
    // partial rows of the last batch.
    __pipeline_wait_prior(0);
    if (__syncthreads_count(done) == P) {
      // every pixel has stopped: the rest of the tile's slots get zero rows
      for (long long i = static_cast<long long>(base) * R + threadIdx.x;
           i < static_cast<long long>(end) * R; i += P)
        dgrad[i] = 0.0f;
      break;
    }
    if (base + S < end) {
      BwdBatch::at(smem, q ^ 1, C).load(gid, rec, features, C, base + S, min(S, end - base - S));
    }
    __pipeline_commit();
    const BwdBatch b = BwdBatch::at(smem, q, C);
    const int n = min(S, end - base);
    unsigned any_mask = 0u;
    for (int j = 0; j < n; ++j) {
      // ---- K1's forward step, term for term ----
      const float4 r0 = b.rec[2 * j];       // ux, uy, conic a, conic b
      const float4 r1 = b.rec[2 * j + 1];   // conic c, opacity, bias, pad
      bool app = false;
      float vx = 0.0f, vy = 0.0f, gexp = 0.0f, alpha = 0.0f, T_excl = 0.0f, w = 0.0f;
      if (!done) {
        vx = r0.x - pxf;
        vy = r0.y - pyf;
        const float power = -0.5f * (r0.z * (vx * vx) + r1.x * (vy * vy)) - r0.w * vx * vy;
        if (power <= 0.0f) {
          gexp = expf(power);
          float raw = r1.y * gexp;
          if (has_bias) raw = raw + r1.z;
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
      if (!__any_sync(FULL, app)) continue;   // all rows of this warp are 0
      // ---- this pixel's gradient terms for slot base + j ----
      float rows[BASE_ROWS];
#pragma unroll
      for (int k = 0; k < BASE_ROWS; ++k) rows[k] = 0.0f;
      if (app) {
        const float4* f = b.feat + j * (row_floats(C) / 4);
        float G_all = 0.0f, G_op = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < CB / 4; ++c4) {
          if (4 * c4 >= C) break;
          const float4 v = f[c4];
          const float fv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * c4 + e < C) {
              G_all = G_all + g[4 * c4 + e] * fv[e];
              G_op = G_op + gm[4 * c4 + e] * fv[e];
            }
          }
        }
        pre_all = pre_all + G_all * w;
        pre_op = pre_op + G_op * w;
        const float one_m = 1.0f - alpha;
        const float dal_all = G_all * T_excl - ((tot_all - pre_all) + Tfin * B_all) / one_m;
        const float dal_op = G_op * T_excl - ((tot_op - pre_op) + Tfin * B_op) / one_m;
        const float dpow = r1.y * gexp * dal_all;
        rows[0] = dpow * (-(r0.z * vx + r0.w * vy));   // duv x
        rows[1] = dpow * (-(r1.x * vy + r0.w * vx));   // duv y
        rows[2] = dpow * (-0.5f * vx * vx);            // dconic a
        rows[3] = dpow * (-vx * vy);                   // dconic b
        rows[4] = dpow * (-0.5f * vy * vy);            // dconic c
        rows[5] = gexp * dal_op;                       // dop
        rows[6] = fabsf(rows[0]);
        rows[7] = fabsf(rows[1]);
        rows[8] = dal_op;                              // dbias
      }
      // ---- fixed-tree sums over the warp's pixels, 16 rows at a time ----
      float* part = s_part + (j * nwarp + warp) * RP;
#pragma unroll
      for (int gi = 0; gi < (BASE_ROWS + CB + 15) / 16; ++gi) {
        if (gi < groups) {
          float v[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int row = gi * 16 + k;
            if (row < BASE_ROWS) {
              v[k] = rows[row];
            } else if (row - BASE_ROWS < CB) {
              v[k] = row - BASE_ROWS < C ? g[row - BASE_ROWS] * w : 0.0f;
            } else {
              v[k] = 0.0f;
            }
          }
          const float s = reduce_scatter16(v, lane);
          if (!(lane & 1)) part[gi * 16 + (lane >> 1)] = s;
        }
      }
      any_mask |= 1u << j;
    }
    if (lane == 0) s_any[warp] = any_mask;
    __syncthreads();
    // ---- the warps' partial sums in warp order, all threads at once ----
    float* out = dgrad + static_cast<long long>(base) * R;
    for (int i = threadIdx.x; i < n * R; i += P) {
      const int j = i / R;
      const int k = internal_row(i - j * R, C);
      const float* part = s_part + j * nwarp * RP + k;
      float acc = 0.0f;
      for (int wi = 0; wi < nwarp; ++wi) {
        if ((s_any[wi] >> j) & 1u) acc = acc + part[wi * RP];
      }
      out[i] = acc;
    }
  }

  if (ncontrib != nullptr && inside) ncontrib[pix] = cnt;
}

using KernelFn = void (*)(const int*, const int*, const float4*, const float*, const float*,
                          const float*, const float*, const float*, const float*, int, int,
                          int, int, int, int, float*, int*);

// [channel bucket 8 / 16 / 32][block bound 256 / 512]
const KernelFn KERNELS[3][2] = {
    {blend_backward_kernel<8, 256>, blend_backward_kernel<8, 512>},
    {blend_backward_kernel<16, 256>, blend_backward_kernel<16, 512>},
    {blend_backward_kernel<32, 256>, blend_backward_kernel<32, 512>},
};

KernelFn pick(int C, int threads) {
  const int cb = C <= 8 ? 0 : (C <= 16 ? 1 : 2);
  return KERNELS[cb][threads <= 256 ? 0 : 1];
}

size_t shared_bytes(int C, int threads) {
  return sizeof(float4) * 2 * static_cast<size_t>(BwdBatch::float4s(C)) +
         sizeof(float) * (static_cast<size_t>(S) * (threads / 32) * padded_rows(C) +
                          threads / 32 + 2 * C);
}

}  // namespace

// gid: [M] int32 tile-sorted ids; edges: [T+1] int32; rec [N, 8] packed
// records (ux, uy, conic a, b, c, opacity, bias, 0; bias read only when
// has_bias), features [N, C], bg [C], mask [C] (alpha_grad_mask), image
// [H, W, C] and final_T [H, W] (K1's outputs), grad [H, W, C] (dL/dimage),
// all f32 on the device. Writes dgrad [M, R] f32 with R = 8 + C (+1 with a
// bias) for every slot in [edges[0], edges[T]); slots past edges[T] are
// not written. ncontrib [H, W] int32 (or null) gets the replay's applied
// count. 1 <= C <= 32, tw*th <= 512 and a multiple of 32 (the caller
// checks). One block of tw*th threads per tile. Returns cudaGetLastError().
extern "C" int blend_backward(const void* gid, const void* edges, const void* rec,
                              const void* features, const void* bg, const void* mask,
                              const void* image, const void* final_T, const void* grad,
                              int has_bias, int C, int W, int H, int tw, int th, void* dgrad,
                              void* ncontrib, void* stream) {
  const int tgx = (W + tw - 1) / tw;
  const int tgy = (H + th - 1) / th;
  const int threads = tw * th;
  if (threads > MAX_PIXELS) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = pick(C, threads);
  const size_t shared = shared_bytes(C, threads);
  if (shared > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared)));
    if (err != 0) return err;
  }
  fn<<<tgx * tgy, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(edges),
      static_cast<const float4*>(rec), static_cast<const float*>(features),
      static_cast<const float*>(bg), static_cast<const float*>(mask),
      static_cast<const float*>(image), static_cast<const float*>(final_T),
      static_cast<const float*>(grad), has_bias, C, W, H, tw, tgx,
      static_cast<float*>(dgrad), static_cast<int*>(ncontrib));
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block (static + dynamic) of the instance a launch with these C and tile
// sizes runs: out[0..2]. Returns the CUDA error code.
extern "C" int blend_backward_attributes(int C, int tw, int th, int* out) {
  cudaFuncAttributes a;
  const int err = static_cast<int>(cudaFuncGetAttributes(&a, pick(C, tw * th)));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + shared_bytes(C, tw * th));
  return 0;
}
