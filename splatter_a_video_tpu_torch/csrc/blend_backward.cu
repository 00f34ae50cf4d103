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
//    is a template over a channel bucket (8, 16, 32; 48 and 64 at 256
//    threads) and the block size (256, 512), each instance with its own
//    __launch_bounds__ (one block per SM at least: higher minimums
//    measured slower);
//  * its loads were gathered from seven arrays through gid with nothing
//    overlapping them, and feature rows came from global memory for each
//    applied pair, one float at a time. As in K1, the wrapper packs one
//    32-byte record per Gaussian, batch k+1's records and feature rows are
//    copied into a second shared buffer with cp.async while batch k is
//    replayed (K1's staging and record layout, `blend_batch.cuh`), and the
//    rows (padded to 4 floats) are read as float4; the masked gradient
//    g_c * mask_c is formed once per pixel, not per pair.
// Those narrow instances hold the C gradients of a pixel in registers and
// [32 slots][warps][rows] partials in shared memory, which grow with C and
// the tile; they run C <= 32 on tiles of whole warps up to 512 pixels, and
// C <= 64 (buckets 48 and 64) up to 256 pixels (the 16x16 tile of the
// training render with its wide render attributes). Buckets 48 and 64 run
// their channel loops over whole float4s, without a test per channel
// (10% faster at C = 52, `PERF.md` §6). The tiled instances
// run the same code over any other tile at C <= 64, in passes of at most
// 256 pixels; the wide instance takes C > 64 on any tile, with registers
// and shared memory bounded for any C.

#include <cuda_runtime.h>

#include "blend_batch.cuh"

namespace {

using namespace blend;

constexpr unsigned FULL = 0xffffffffu;
constexpr int S = 32;         // slots per batch (one bit each in a warp's mask)
constexpr int BASE_ROWS = 9;  // duv 2, dconic 3, dop 1, |duv| 2, dbias 1
// the narrow instances' limits (2 x 64 gradients a thread fit the
// registers of a 256-thread block)
constexpr int NARROW_CHANNELS = 32, NARROW_PIXELS = 512;
constexpr int MEDIUM_CHANNELS = 64, MEDIUM_PIXELS = 256;
// the wide instance: threads of a block (and pixels of one pass), channels
// of a chunk (one 16-row reduce-scatter)
constexpr int WIDE_NT = 256, CC = 16;
constexpr int WS = 16;   // slots per batch of the wide instance
using BwdBatch = Batch<S, false>;
using WideBatch = Batch<WS, false>;

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

// Output row of internal row k: the inverse of internal_row.
__device__ __forceinline__ int output_row(int k, int C) {
  if (k < 6) return k;
  if (k < BASE_ROWS) return k + C;   // |duv| 2, dbias
  return k - BASE_ROWS + 6;          // dfeat
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

// The per-slot design above over one pass of the tile: pixels p0 .. p0 +
// blockDim.x - 1 of the tile's TP, one a thread. Without PASSES the block
// is the whole tile (p0 = 0, TP = blockDim.x, first); with PASSES the
// lanes past the tile hold zero rows, and a pass after the first adds its
// warps' sums onto the rows the earlier passes wrote.
template <int CB, bool PASSES>
__device__ __forceinline__ void backward_pass(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float4* __restrict__ rec, const float* __restrict__ features,
    const float* __restrict__ bg, const float* __restrict__ mask,
    const float* __restrict__ image, const float* __restrict__ final_T,
    const float* __restrict__ grad, int has_bias, int C, int W, int H, int tw, int tgx,
    float* __restrict__ dgrad, int* __restrict__ ncontrib, int TP, int p0, bool first) {
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
  const int p = p0 + static_cast<int>(threadIdx.x);
  const int x = PASSES ? (t % tgx) * tw + p % tw : (t % tgx) * tw + threadIdx.x % tw;
  const int y = PASSES ? (t / tgx) * (TP / tw) + p / tw : (t / tgx) * (P / tw) + threadIdx.x / tw;
  const bool inside = (!PASSES || p < TP) && x < W && y < H;
  const float pxf = static_cast<float>(x);
  const float pyf = static_cast<float>(y);
  const long long pix = static_cast<long long>(y) * W + x;
  const int start = edges[t];
  const int end = edges[t + 1];

  if (start < end) BwdBatch::at(smem, 0, C).load(gid, rec, features, C, start, min(S, end - start), C, 0);
  __pipeline_commit();
  if (threadIdx.x < C) {
    s_bg[threadIdx.x] = bg[threadIdx.x];
    s_mask[threadIdx.x] = mask[threadIdx.x];
  }
  if constexpr (CB > 32) {
    // zero the rows' padding past C (no copy writes it): the channel loops
    // below then run whole float4s, padded channels adding +0.0
    const int rf = row_floats(C);
    for (int i = threadIdx.x; i < 2 * S * (rf - C); i += P) {
      const int q = i / (S * (rf - C)), j = (i / (rf - C)) % S, c = C + i % (rf - C);
      reinterpret_cast<float*>(BwdBatch::at(smem, q, C).feat)[j * rf + c] = 0.0f;
    }
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
      // (a later pass leaves them as they are)
      if (!PASSES || first) {
        for (long long i = static_cast<long long>(base) * R + threadIdx.x;
             i < static_cast<long long>(end) * R; i += P)
          dgrad[i] = 0.0f;
      }
      break;
    }
    if (base + S < end) {
      BwdBatch::at(smem, q ^ 1, C).load(gid, rec, features, C, base + S, min(S, end - base - S), C, 0);
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
            // above 32 channels the padded channels run too: g, gm and the
            // row's padding are +0.0, and G is never -0.0, so they add
            // nothing; the narrow buckets keep the test
            if (CB > 32 || 4 * c4 + e < C) {
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
              // g is +0.0 past C, and so is g * w (w >= +0.0)
              v[k] = CB > 32 || row - BASE_ROWS < C ? g[row - BASE_ROWS] * w : 0.0f;
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
      float acc = PASSES && !first ? out[i] : 0.0f;
      for (int wi = 0; wi < nwarp; ++wi) {
        if ((s_any[wi] >> j) & 1u) acc = acc + part[wi * RP];
      }
      out[i] = acc;
    }
  }

  if (ncontrib != nullptr && inside) ncontrib[pix] = cnt;
}

// The narrow instances: one block of tw*th threads (whole warps) per tile.
template <int CB, int NT>
__global__ void __launch_bounds__(NT, 1) blend_backward_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float4* __restrict__ rec, const float* __restrict__ features,
    const float* __restrict__ bg, const float* __restrict__ mask,
    const float* __restrict__ image, const float* __restrict__ final_T,
    const float* __restrict__ grad, int has_bias, int C, int W, int H, int tw, int tgx,
    float* __restrict__ dgrad, int* __restrict__ ncontrib) {
  backward_pass<CB, false>(gid, edges, rec, features, bg, mask, image, final_T, grad, has_bias, C, W, H, tw,
                           tgx, dgrad, ncontrib, 0, 0, true);
}

// The same design on any tile of TP pixels: a block of blockDim.x threads
// (the tile rounded up to whole warps, at most WIDE_NT) takes the tile's
// pixels in passes, pass k pixels k * blockDim.x .. (k + 1) * blockDim.x -
// 1, so its warps are the tile's warps of 32 consecutive pixels in order,
// and the chain of warp sums in warp order goes on from one pass to the
// next, as `_tile_tree_sum`'s does across the tile.
template <int CB>
__global__ void __launch_bounds__(WIDE_NT, 1) blend_backward_tiled_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float4* __restrict__ rec, const float* __restrict__ features,
    const float* __restrict__ bg, const float* __restrict__ mask,
    const float* __restrict__ image, const float* __restrict__ final_T,
    const float* __restrict__ grad, int has_bias, int C, int W, int H, int tw, int TP, int tgx,
    float* __restrict__ dgrad, int* __restrict__ ncontrib) {
  for (int p0 = 0; p0 < TP; p0 += blockDim.x) {
    backward_pass<CB, true>(gid, edges, rec, features, bg, mask, image, final_T, grad, has_bias, C, W, H, tw,
                            tgx, dgrad, ncontrib, TP, p0, p0 == 0);
    __syncthreads();   // every thread is past the pass's shared reads before the next one stages
  }
}

// Swap v[s] and v[s | BIT] for every s without BIT, where `swap` holds.
template <int BIT>
__device__ __forceinline__ void swap_pairs(float (&v)[16], bool swap) {
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    if (!(s & BIT)) {
      const float a = v[s], c = v[s | BIT];
      v[s] = swap ? c : a;
      v[s | BIT] = swap ? a : c;
    }
  }
}

// reduce_scatter16 without its selects: v[s] must hold row s ^ m of the
// lane's rows, m = (lane >> 1) & 15 (a lane-dependent order, set up once
// when the rows are loaded, with swap_pairs). Each step then adds the
// partner's copy of the same row, slot for slot, and lane l returns row
// l >> 1 as reduce_scatter16 does, through the same pairs of lanes and so
// the same sums.
template <int HALF>
__device__ __forceinline__ void ordered_step(float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) v[i] = v[i] + __shfl_xor_sync(FULL, v[i + HALF], 2 * HALF);
}

__device__ __forceinline__ float reduce_scatter16_ordered(float (&v)[16]) {
  ordered_step<8>(v);
  ordered_step<4>(v);
  ordered_step<2>(v);
  ordered_step<1>(v);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// The wide instance: C > 64 (the narrow and tiled instances' registers
// hold 2 x 64 gradients a thread at most), any tile. A block of NT = 256
// threads takes the tile's pixels in passes of 256, as the tiled instance
// does, carrying the rows from pass to pass in dgrad. The parent's wide
// instance ran C = 200 at 147x its bound: it read dL/dimage and every
// feature row from memory for each applied (slot, pixel) pair and summed a
// batch in rounds of 4 slots. Per batch of WS = 16 slots this one
//  * walks once: each pixel replays K1's steps over the batch and keeps a
//    bit per applied slot and its weight w in shared memory (a column of
//    its own: no barrier); its warp ORs the bits (one word a warp, read by
//    the cross-warp sums);
//  * takes the channels in chunks of CC = 16. A chunk's feature rows (the
//    batch's slots, zero-padded) and mask are staged by the block with
//    cp.async into the second of two buffers while the first is summed,
//    and the pixel's dL/dimage for the chunk into a column of its own as
//    soon as the thread has read the last one;
//  * per chunk, adds the chunk's terms to the channel dot products G_all /
//    G_op of all the batch's slots at once (16 independent chains in
//    registers, each in channel order), then sums the chunk's dfeat rows
//    g_c w through the warp tree, one 16-row reduce-scatter per slot the
//    warp applied. The rows are loaded in a lane-dependent order, so the
//    reduce-scatter needs no selects (48 instructions a slot, not 96);
//  * after the last chunk, stores the pixel's G in shared memory and goes
//    through the batch once more, in a loop of its own, for the prefix
//    sums and the 9 base rows: it recomputes the quadratic, exp and alpha
//    of the slots it applied (the same arithmetic as the walk, so the same
//    bits) and the transmittance chain from the batch's start;
//  * sums the warps' partial rows in parallel over the block after one
//    barrier a chunk, in warp order onto the carry, writing each row once.
// Registers stay at 128 and shared memory at 60,576 B for any C and tile,
// so two blocks (16 warps) fit on an SM. At C = 200 on an H100 this ran
// 11.74 ms, with 32 slots a batch (2 x 32 chains, 280 B of spills) 13.09
// ms, and at one block an SM (154 registers) 15.77 ms (`PERF.md` §6).
__global__ void __launch_bounds__(WIDE_NT, 2) blend_backward_wide_kernel(
    const int* __restrict__ gid, const int* __restrict__ edges,
    const float4* __restrict__ rec, const float* __restrict__ features,
    const float* __restrict__ bg, const float* __restrict__ mask,
    const float* __restrict__ image, const float* __restrict__ final_T,
    const float* __restrict__ grad, int has_bias, int C, int W, int H, int tw, int P, int tgx,
    float* __restrict__ dgrad, int* __restrict__ ncontrib) {
  extern __shared__ float4 smem[];
  constexpr int nt = WIDE_NT;   // pixels of a pass: compile-time, so every shared offset is an immediate
  constexpr int nw = WIDE_NT / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int order = (lane >> 1) & 15;   // reduce_scatter16_ordered's row order
  const int R = 8 + C + has_bias;
  const int nk = (C + CC - 1) / CC;   // channel chunks
  // two record buffers, then two chunk buffers of feature rows [WS][CC] and
  // masks [CC]; then columns of each thread's own: its pixel's dL/dimage
  // of a chunk [CC][nt], w and later G_all [WS][nt], G_op [WS][nt]; then
  // the partial rows [WS][nw][16] and the warps' masks
  float4* s_f4 = smem + 2 * WideBatch::float4s(0);
  float* s_mask = reinterpret_cast<float*>(s_f4 + 2 * WS * CC / 4);
  float* s_g = s_mask + 2 * CC + tid;
  float* s_w = s_g + CC * nt;
  float* s_gop = s_w + WS * nt;
  float* s_part = s_mask + 2 * CC + (CC + 2 * WS) * nt;
  unsigned* s_any = reinterpret_cast<unsigned*>(s_part + WS * nw * 16);

  const int t = blockIdx.x;
  const int tx0 = (t % tgx) * tw;
  const int ty0 = (t / tgx) * (P / tw);
  const int start = edges[t];
  const int end = edges[t + 1];

  // The block stages chunk k of the feature rows of slots base .. base +
  // n - 1 and of the mask into chunk buffer fb, zero-padded to CC channels.
  auto stage_f = [&](int base, int n, int k, int fb) {
    const int c0 = k * CC;
    const int ck = min(CC, C - c0);
    float* f = reinterpret_cast<float*>(s_f4 + fb * WS * CC / 4);
    for (int i = tid; i < WS * CC; i += nt) {
      const int j = i / CC;
      const int c = i - j * CC;
      if (j < n && c < ck) {
        __pipeline_memcpy_async(f + i, features + static_cast<long long>(gid[base + j]) * C + c0 + c, 4);
      } else {
        f[i] = 0.0f;
      }
    }
    if (tid < CC) s_mask[fb * CC + tid] = tid < ck ? mask[c0 + tid] : 0.0f;
  };
  // The thread stages chunk k of its pixel's dL/dimage (gpix; null off the
  // frame) into its column, zero-padded.
  auto stage_g = [&](int k, const float* gpix) {
    const int c0 = k * CC;
    const int ck = min(CC, C - c0);
    for (int c = 0; c < CC; ++c) {
      if (gpix != nullptr && c < ck) {
        __pipeline_memcpy_async(s_g + c * nt, gpix + c0 + c, 4);
      } else {
        s_g[c * nt] = 0.0f;
      }
    }
  };
  // The warps' partial sums of rows [0, rows) of the partials in warp
  // order, onto the carry (the rows the earlier passes wrote), all threads
  // at once; partial row r goes to row out_row(r) of its slot's dgrad row
  // (none where out_row(r) < 0).
  auto cross_warp = [&](float* out, int n, int rows, bool first, auto out_row) {
    for (int i = tid; i < n * rows; i += nt) {
      const int j = i / rows;
      const int r = i - j * rows;
      const int o = out_row(r);
      if (o < 0) continue;
      const float* pp = s_part + j * nw * 16 + r;
      float acc = first ? 0.0f : out[j * R + o];
      for (int wi = 0; wi < nw; ++wi) {
        if ((s_any[wi] >> j) & 1u) acc = acc + pp[wi * 16];
      }
      out[j * R + o] = acc;
    }
  };

  for (int p0 = 0; p0 < P; p0 += nt) {
    const int p = p0 + tid;
    const int x = tx0 + p % tw;
    const int y = ty0 + p / tw;
    const bool inside = p < P && x < W && y < H;
    const bool first = p0 == 0;   // the first pass writes the rows, later ones add to them
    const float pxf = static_cast<float>(x);
    const float pyf = static_cast<float>(y);
    const long long pix = static_cast<long long>(y) * W + x;
    const float* gpix = inside ? grad + pix * C : nullptr;

    if (start < end) {
      WideBatch::at(smem, 0, 0).load(gid, rec, features, 0, start, min(WS, end - start), C, 0);
      stage_f(start, min(WS, end - start), 0, 0);
      stage_g(0, gpix);
    }
    __pipeline_commit();

    // per-pixel constants of the backward, each sum in channel order
    float B_all = 0.0f, B_op = 0.0f, tot_all = 0.0f, tot_op = 0.0f, Tfin = 0.0f;
    if (inside) {
      Tfin = final_T[pix];
      for (int c = 0; c < C; ++c) {
        const float g = gpix[c];
        const float gm = g * mask[c];
        const float o = image[pix * C + c];
        B_all = B_all + g * bg[c];
        B_op = B_op + gm * bg[c];
        tot_all = tot_all + g * o;
        tot_op = tot_op + gm * o;
      }
      tot_all = tot_all - Tfin * B_all;
      tot_op = tot_op - Tfin * B_op;
    }

    float T = 1.0f;
    float pre_all = 0.0f, pre_op = 0.0f;
    int cnt = 0;
    bool done = !inside;
    int q = 0;    // record buffer of this batch
    int fq = 0;   // chunk buffer of this (batch, chunk)
    for (int base = start; base < end; base += WS, q ^= 1) {
      // Batch q's records and its chunk 0 have landed; the barrier also
      // frees the other buffers and the partial rows of the last batch.
      __pipeline_wait_prior(0);
      if (__syncthreads_count(done) == nt) {
        // every pixel of the pass has stopped: the rest of the tile's slots
        // get zero rows (later passes leave them as they are)
        if (first) {
          for (long long i = static_cast<long long>(base) * R + tid; i < static_cast<long long>(end) * R; i += nt)
            dgrad[i] = 0.0f;
        }
        break;
      }
      const int n = min(WS, end - base);
      if (base + WS < end) {
        WideBatch::at(smem, q ^ 1, 0).load(gid, rec, features, 0, base + WS, min(WS, end - base - WS), C, 0);
      }
      const WideBatch b = WideBatch::at(smem, q, 0);

      // ---- the walk, once: K1's forward step, term for term ----
      const float T0 = T;
      unsigned app = 0u;
      for (int j = 0; !done && j < n; ++j) {
        const float4 r0 = b.rec[2 * j];       // ux, uy, conic a, conic b
        const float4 r1 = b.rec[2 * j + 1];   // conic c, opacity, bias, pad
        const float vx = r0.x - pxf;
        const float vy = r0.y - pyf;
        const float power = -0.5f * (r0.z * (vx * vx) + r1.x * (vy * vy)) - r0.w * vx * vy;
        if (!(power <= 0.0f)) continue;   // as the plain version's test
        float raw = r1.y * expf(power);
        if (has_bias) raw = raw + r1.z;
        const float alpha = fminf(ALPHA_MAX, raw);
        if (alpha < ALPHA_MIN) continue;
        const float next_T = T * (1.0f - alpha);
        if (next_T < T_EPS) {
          done = true;
          break;
        }
        s_w[j * nt] = alpha * T;
        app |= 1u << j;
        ++cnt;
        T = next_T;
      }
      const unsigned any = __reduce_or_sync(FULL, app);   // the slots this warp applied
      if (lane == 0) s_any[warp] = any;

      float G_all[WS], G_op[WS];
#pragma unroll
      for (int j = 0; j < WS; ++j) G_all[j] = G_op[j] = 0.0f;
      float* out = dgrad + static_cast<long long>(base) * R;
      for (int k = 0; k < nk; ++k, fq ^= 1) {
        if (k > 0) {   // chunk k has landed; the barrier publishes it
          __pipeline_wait_prior(0);
          __syncthreads();
        }
        // the next (batch, chunk)'s feature rows into the other buffer
        const int nb = k + 1 < nk ? base : base + WS;
        if (nb < end) stage_f(nb, min(WS, end - nb), (k + 1) % nk, fq ^ 1);
        __pipeline_commit();

        const int c0 = k * CC;
        const int ck = min(CC, C - c0);
        const float4* sf = s_f4 + fq * WS * CC / 4;
        const float* sm = s_mask + fq * CC;

        // ---- G += the chunk's terms, all slots at once, channel order ----
#pragma unroll 1
        for (int c4 = 0; c4 < (ck + 3) / 4; ++c4) {
          const float g0 = s_g[(4 * c4) * nt], g1 = s_g[(4 * c4 + 1) * nt];
          const float g2 = s_g[(4 * c4 + 2) * nt], g3 = s_g[(4 * c4 + 3) * nt];
          const float m0 = g0 * sm[4 * c4], m1 = g1 * sm[4 * c4 + 1];
          const float m2 = g2 * sm[4 * c4 + 2], m3 = g3 * sm[4 * c4 + 3];
#pragma unroll
          for (int j = 0; j < WS; ++j) {
            if ((any >> j) & 1u) {
              // padded channels hold 0 in g and f: adding +0.0 leaves G as it
              // is (G starts at +0.0 and so is never -0.0)
              const float4 f = sf[j * (CC / 4) + c4];
              G_all[j] = G_all[j] + g0 * f.x;
              G_all[j] = G_all[j] + g1 * f.y;
              G_all[j] = G_all[j] + g2 * f.z;
              G_all[j] = G_all[j] + g3 * f.w;
              G_op[j] = G_op[j] + m0 * f.x;
              G_op[j] = G_op[j] + m1 * f.y;
              G_op[j] = G_op[j] + m2 * f.z;
              G_op[j] = G_op[j] + m3 * f.w;
            }
          }
        }

        // ---- the chunk's dfeat rows g_c w through the warp tree ----
        const bool last = k == nk - 1;
        float gv[16];   // gv[s] = g of channel s ^ order
#pragma unroll
        for (int s = 0; s < 16; ++s) gv[s] = s_g[s * nt];
        swap_pairs<8>(gv, order & 8);
        swap_pairs<4>(gv, order & 4);
        swap_pairs<2>(gv, order & 2);
        swap_pairs<1>(gv, order & 1);
        // the next chunk's gradient (the next batch's first), into the column just read
        if (!last || base + WS < end) stage_g(last ? 0 : k + 1, gpix);
        __pipeline_commit();
        for (int j = 0; j < n; ++j) {
          if (!((any >> j) & 1u)) continue;   // all rows of this warp are 0
          const float w = ((app >> j) & 1u) ? s_w[j * nt] : 0.0f;
          float v[16];
#pragma unroll
          for (int s = 0; s < 16; ++s) v[s] = gv[s] * w;
          const float sum = reduce_scatter16_ordered(v);
          if (!(lane & 1)) s_part[(j * nw + warp) * 16 + (lane >> 1)] = sum;
        }
        __syncthreads();
        cross_warp(out, n, ck, first, [&](int r) { return 6 + c0 + r; });
        if (!last) continue;
        __syncthreads();   // the partial rows are free again

        // ---- after the last chunk: prefix sums and the base rows ----
#pragma unroll
        for (int j = 0; j < WS; ++j) {
          if ((any >> j) & 1u) {
            s_w[j * nt] = G_all[j];
            s_gop[j * nt] = G_op[j];
          }
        }
        float Tb = T0;
        for (int j = 0; j < n; ++j) {
          if (!((any >> j) & 1u)) continue;
          float v[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = 0.0f;
          if ((app >> j) & 1u) {
            const float4 r0 = b.rec[2 * j];
            const float4 r1 = b.rec[2 * j + 1];
            const float vx = r0.x - pxf;
            const float vy = r0.y - pyf;
            const float power = -0.5f * (r0.z * (vx * vx) + r1.x * (vy * vy)) - r0.w * vx * vy;
            const float gexp = expf(power);
            float raw = r1.y * gexp;
            if (has_bias) raw = raw + r1.z;
            const float alpha = fminf(ALPHA_MAX, raw);
            const float T_excl = Tb;
            const float Ga = s_w[j * nt];
            const float Go = s_gop[j * nt];
            const float w = alpha * Tb;
            Tb = Tb * (1.0f - alpha);
            pre_all = pre_all + Ga * w;
            pre_op = pre_op + Go * w;
            const float one_m = 1.0f - alpha;
            const float dal_all = Ga * T_excl - ((tot_all - pre_all) + Tfin * B_all) / one_m;
            const float dal_op = Go * T_excl - ((tot_op - pre_op) + Tfin * B_op) / one_m;
            const float dpow = r1.y * gexp * dal_all;
            v[0] = dpow * (-(r0.z * vx + r0.w * vy));   // duv x
            v[1] = dpow * (-(r1.x * vy + r0.w * vx));   // duv y
            v[2] = dpow * (-0.5f * vx * vx);            // dconic a
            v[3] = dpow * (-vx * vy);                   // dconic b
            v[4] = dpow * (-0.5f * vy * vy);            // dconic c
            v[5] = gexp * dal_op;                       // dop
            v[6] = fabsf(v[0]);
            v[7] = fabsf(v[1]);
            v[8] = dal_op;                              // dbias
          }
          const float sum = reduce_scatter16(v, lane);
          if (!(lane & 1)) s_part[(j * nw + warp) * 16 + (lane >> 1)] = sum;
        }
        __syncthreads();
        cross_warp(out, n, BASE_ROWS, first,
                   [&](int r) { return r == BASE_ROWS - 1 && !has_bias ? -1 : output_row(r, C); });
      }
    }
    // the pass's copies have landed and every thread is past its reads
    // before the next pass restages the buffers
    __pipeline_wait_prior(0);
    __syncthreads();
    if (ncontrib != nullptr && inside) ncontrib[pix] = cnt;
  }
}

using KernelFn = void (*)(const int*, const int*, const float4*, const float*, const float*,
                          const float*, const float*, const float*, const float*, int, int,
                          int, int, int, int, float*, int*);
using TileKernelFn = void (*)(const int*, const int*, const float4*, const float*, const float*,
                              const float*, const float*, const float*, const float*, int, int,
                              int, int, int, int, int, float*, int*);

// [channel bucket 8 / 16 / 32 / 48 / 64][block bound 256 / 512]
const KernelFn KERNELS[5][2] = {
    {blend_backward_kernel<8, 256>, blend_backward_kernel<8, 512>},
    {blend_backward_kernel<16, 256>, blend_backward_kernel<16, 512>},
    {blend_backward_kernel<32, 256>, blend_backward_kernel<32, 512>},
    {blend_backward_kernel<48, 256>, nullptr},
    {blend_backward_kernel<64, 256>, nullptr},
};
// [channel bucket 8 / 16 / 32 / 48 / 64]
const TileKernelFn TILED_KERNELS[5] = {
    blend_backward_tiled_kernel<8>, blend_backward_tiled_kernel<16>, blend_backward_tiled_kernel<32>,
    blend_backward_tiled_kernel<48>, blend_backward_tiled_kernel<64>,
};
const TileKernelFn WIDE_KERNEL = blend_backward_wide_kernel;

int bucket(int C) { return C <= 8 ? 0 : (C <= 16 ? 1 : (C <= 32 ? 2 : (C <= 48 ? 3 : 4))); }

// Which instance a launch runs: a narrow one (C <= 32 on a tile of whole
// warps up to 512 pixels, C <= 64 up to 256), a tiled one (any other tile
// at C <= 64) or the wide one (C > 64).
enum Kind { NARROW, TILED, WIDE };

Kind kind(int C, int pixels) {
  if (C > MEDIUM_CHANNELS) return WIDE;
  if (pixels % 32 == 0 && ((C <= NARROW_CHANNELS && pixels <= NARROW_PIXELS) || pixels <= MEDIUM_PIXELS))
    return NARROW;
  return TILED;
}

// The block size: the tile, or for a tiled launch the tile rounded up to
// whole warps, at most WIDE_NT; the wide instance always WIDE_NT.
int block_threads(Kind k, int pixels) {
  if (k == NARROW) return pixels;
  if (k == WIDE) return WIDE_NT;
  return min(WIDE_NT, (pixels + 31) / 32 * 32);
}

KernelFn narrow_instance(int C, int pixels) { return KERNELS[bucket(C)][pixels <= 256 ? 0 : 1]; }

TileKernelFn tile_instance(Kind k, int C) { return k == TILED ? TILED_KERNELS[bucket(C)] : WIDE_KERNEL; }

size_t shared_bytes(int C, int threads) {
  return sizeof(float4) * 2 * static_cast<size_t>(BwdBatch::float4s(C)) +
         sizeof(float) * (static_cast<size_t>(S) * (threads / 32) * padded_rows(C) +
                          threads / 32 + 2 * C);
}

size_t wide_shared_bytes() {
  constexpr int nt = WIDE_NT;
  return sizeof(float4) * 2 * static_cast<size_t>(WideBatch::float4s(0)) +
         sizeof(float) * (2 * WS * CC + 2 * CC + static_cast<size_t>(CC + 2 * WS) * nt + WS * (nt / 32) * 16) +
         sizeof(unsigned) * (nt / 32);
}

size_t instance_shared_bytes(Kind k, int C, int pixels) {
  return k == WIDE ? wide_shared_bytes() : shared_bytes(C, block_threads(k, pixels));
}


// Let fn take `shared` bytes of dynamic shared memory (above 48 KB only
// with the opt-in).
template <typename Fn>
int allow_shared(Fn fn, size_t shared) {
  if (shared <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shared)));
}

}  // namespace

// gid: [M] int32 tile-sorted ids; edges: [T+1] int32; rec [N, 8] packed
// records (ux, uy, conic a, b, c, opacity, bias, 0; bias read only when
// has_bias), features [N, C], bg [C], mask [C] (alpha_grad_mask), image
// [H, W, C] and final_T [H, W] (K1's outputs), grad [H, W, C] (dL/dimage),
// all f32 on the device. Writes dgrad [M, R] f32 with R = 8 + C (+1 with a
// bias) for every slot in [edges[0], edges[T]); slots past edges[T] are
// not written. ncontrib [H, W] int32 (or null) gets the replay's applied
// count. Any C >= 1 and any tile (`kind` picks the instance); one block
// per tile. Returns cudaGetLastError().
extern "C" int blend_backward(const void* gid, const void* edges, const void* rec,
                              const void* features, const void* bg, const void* mask,
                              const void* image, const void* final_T, const void* grad,
                              int has_bias, int C, int W, int H, int tw, int th, void* dgrad,
                              void* ncontrib, void* stream) {
  if (tw < 1 || th < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tgx = (W + tw - 1) / tw;
  const int tgy = (H + th - 1) / th;
  const int pixels = tw * th;
  const Kind k = kind(C, pixels);
  const size_t shared = instance_shared_bytes(k, C, pixels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gid_ = static_cast<const int*>(gid);
  const auto* edges_ = static_cast<const int*>(edges);
  const auto* rec_ = static_cast<const float4*>(rec);
  const auto* f_ = static_cast<const float*>(features);
  const auto* bg_ = static_cast<const float*>(bg);
  const auto* mask_ = static_cast<const float*>(mask);
  const auto* image_ = static_cast<const float*>(image);
  const auto* fT_ = static_cast<const float*>(final_T);
  const auto* grad_ = static_cast<const float*>(grad);
  auto* dgrad_ = static_cast<float*>(dgrad);
  auto* nc_ = static_cast<int*>(ncontrib);
  if (k == NARROW) {
    const KernelFn fn = narrow_instance(C, pixels);
    const int err = allow_shared(fn, shared);
    if (err != 0) return err;
    fn<<<tgx * tgy, pixels, shared, s>>>(gid_, edges_, rec_, f_, bg_, mask_, image_, fT_, grad_, has_bias, C, W,
                                        H, tw, tgx, dgrad_, nc_);
  } else {
    const TileKernelFn fn = tile_instance(k, C);
    const int err = allow_shared(fn, shared);
    if (err != 0) return err;
    fn<<<tgx * tgy, block_threads(k, pixels), shared, s>>>(gid_, edges_, rec_, f_, bg_, mask_, image_, fT_, grad_,
                                                          has_bias, C, W, H, tw, pixels, tgx, dgrad_, nc_);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block (static + dynamic) of the instance a launch with these C and tile
// sizes runs: out[0..2]. Returns the CUDA error code.
extern "C" int blend_backward_attributes(int C, int tw, int th, int* out) {
  cudaFuncAttributes a;
  const Kind k = kind(C, tw * th);
  const int err = static_cast<int>(k == NARROW ? cudaFuncGetAttributes(&a, narrow_instance(C, tw * th))
                                                : cudaFuncGetAttributes(&a, tile_instance(k, C)));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + instance_shared_bytes(k, C, tw * th));
  return 0;
}
