// K4 reduce_gaussians: sum K3's per-slot gradient rows into per-Gaussian
// gradients.
//
// Replaces the XLA `reduce_to_gaussians` of
// `splatter_a_video_tpu/ops/rasterize_tpu.py` (`_build_splat`), which sorts
// the slots back, gathers them and runs a log2(cap)-pass Hillis-Steele
// segmented sum because TPU scatters serialise. Gaussian g sums the rows of
// its pre-sort slots offs[g] .. offs[g] + tiles[g] - 1 below the budget M,
// in that order, each sum one sequential chain from +0.0f: the order of the
// plain PyTorch version (`rasterize_gpu.reduce_gaussians_plain`), so no
// sum may be split or reassociated, and no float atomics are used.
//
// Bound: bytes. Each used slot's row (4 * R bytes) and its int64 sort
// position are read once, offs / tiles once, the [N, R] output written
// once; about 42 MB at the training shape. What the card allows is less:
// the rows are read through the inverse permutation, so each 60-byte row
// (R = 15) is a random gather that touches two or three 32-byte sectors.
// The design therefore spends its effort on keeping many such gathers in
// flight, in two launches on one stream:
//
//  1. invert_order_kernel: inv[order[i]] = i for the sorted positions
//     i < used = min(offs[N-1] + tiles[N-1], M), read on the device (no
//     host sync). The sentinel keys of K2 sort after every real key, so the
//     positions i >= used hold the sentinel slots, which no run reads.
//  2. reduce_gaussians_kernel: a block takes 32 consecutive Gaussians,
//     whose clamped runs are consecutive pre-sort slots (~120 at the
//     flagship). It loads their inv entries in one coalesced load, then
//     gathers their rows element by element across all 256 threads, eight
//     independent loads a thread in flight, into shared memory; then one
//     thread per (Gaussian, row) adds that Gaussian's rows in slot order
//     from shared memory and the block writes the [32, R] sums as one
//     contiguous store. Runs longer than 256 slots in all are staged in
//     pieces, the sums kept in shared memory between them. The launch is
//     programmatic (PDL): blocks read offs / tiles, and blocks without
//     slots write their zeros, while the inversion still runs; the others
//     wait for it (griddepcontrol.wait) before they read inv.
//
// Shared memory holds (256 + 32) staged rows of R floats, 1,152 R bytes,
// which would pass the card's 227 KB at R ~ 200. Rows wider than
// MAX_PIECE = 41 floats (47,232 B, with the static 1,296 B under the 48 KB
// that needs no opt-in) are therefore summed in pieces of at most 41
// columns, one block per (32 Gaussians, piece): each (Gaussian, row) sum
// is its own chain, so a piece changes no order. R <= 41, the training
// blend's R = 15 among them, runs the unpieced instance.
//
// Precondition, which the plain version does not have: every sorted
// position i >= used maps to a pre-sort slot >= used, so that inv is set
// at every slot a run reads. `Binning.order` meets it; for another
// permutation the result is undefined.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int GB = 32;          // Gaussians per block of the summing kernel
constexpr int CAP = 256;        // slots staged per piece (a block's runs: ~120 at the flagship)
constexpr int IN_FLIGHT = 8;    // row elements a thread loads before it stores them
constexpr int MAX_PIECE = 41;   // row floats a block stages: (CAP + GB) * 41 floats = 47,232 B
// the staged rows and sums, plus the static slot_inv, run_o, run_n and span
static_assert(((CAP + GB) * MAX_PIECE + CAP + 2 * GB + 2) * sizeof(float) <= 48 * 1024,
              "a block's shared memory needs no opt-in");
static_assert(GB == 32, "the span of a block's runs is reduced in one warp");

__global__ void __launch_bounds__(NT) invert_order_kernel(const long long* __restrict__ order,
                                                          const int* __restrict__ offs,
                                                          const int* __restrict__ tiles,
                                                          int N, int M, int* __restrict__ inv) {
  // let the summing grid start its prologue now; it waits for this grid's
  // completion before it reads inv
  asm volatile("griddepcontrol.launch_dependents;");
  const int total = N > 0 ? offs[N - 1] + tiles[N - 1] : 0;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < total && i < M) inv[order[i]] = i;
}

// Element f of a run of elements in steps of NT: p = f / R, r = f % R,
// advanced without a division.
struct Step {
  int p, r;
  __device__ void next(int dp, int dr, int R) {
    p += dp, r += dr;
    if (r >= R) r -= R, ++p;
  }
};

// One block sums the rows of GB consecutive Gaussians. Their clamped runs
// are consecutive pre-sort slots [s_begin, s_end); the block stages them in
// pieces of up to CAP slots: the piece's inv entries (one coalesced load),
// then its rows, element by element across the block with IN_FLIGHT loads
// a thread in flight, into shared memory; then one thread per (Gaussian,
// row) adds the piece's rows of that Gaussian in slot order onto its sum,
// which stays in shared memory between pieces.
__global__ void __launch_bounds__(NT) reduce_gaussians_kernel(const float* __restrict__ dgrad,
                                                              const int* __restrict__ inv,
                                                              const int* __restrict__ offs,
                                                              const int* __restrict__ tiles,
                                                              int N, int M, int R,
                                                              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                                       // [CAP][R]
  float* acc = rows + CAP * R;                              // [GB][R]
  __shared__ int slot_inv[CAP], run_o[GB], run_n[GB];
  const int tid = threadIdx.x;
  const long long ga = static_cast<long long>(blockIdx.x) * GB;
  const int count = static_cast<int>(N - ga < GB ? N - ga : GB);
  int lo = INT_MAX, hi = 0;   // the span of the live runs, in warp 0
  if (tid < GB) {
    int o = 0, n = 0;
    if (tid < count) {
      o = offs[ga + tid];
      n = max(0, min(tiles[ga + tid], M - o));
    }
    run_o[tid] = o;
    run_n[tid] = n;
    if (n > 0) lo = o, hi = o + n;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
  }
  __shared__ int span[2];
  if (tid == 0) span[0] = lo, span[1] = hi;
  const int pairs = count * R;   // (Gaussian, row) pairs: acc[gl * R + r]
  for (int q = tid; q < pairs; q += NT) acc[q] = 0.0f;
  __syncthreads();
  const int s_begin = span[0], s_end = span[1];
  const int dp = NT / R, dr = NT - dp * R;
  const Step first = {tid / R, tid - tid / R * R};
  // blocks with no slots write their zeros without waiting for the inversion
  if (s_begin < s_end) asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int p0 = s_begin; p0 < s_end; p0 += CAP) {
    const int len = min(CAP, s_end - p0);
    for (int i = tid; i < len; i += NT) slot_inv[i] = inv[p0 + i];
    __syncthreads();
    const int elems = len * R;   // rows[p * R + r] = dgrad[inv[p0 + p]][r]
    Step e = first;
    for (int f0 = tid; f0 < elems; f0 += IN_FLIGHT * NT) {
      float v[IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) {
        if (f0 + k * NT < elems) v[k] = dgrad[static_cast<long long>(slot_inv[e.p]) * R + e.r];
        e.next(dp, dr, R);
      }
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k)
        if (f0 + k * NT < elems) rows[f0 + k * NT] = v[k];
    }
    __syncthreads();
    Step pr = first;   // (gl, r) of pair q
    for (int q = tid; q < pairs; q += NT, pr.next(dp, dr, R)) {
      const int a = max(run_o[pr.p], p0), b = min(run_o[pr.p] + run_n[pr.p], p0 + len);
      float sum = acc[q];
      for (int t = a; t < b; ++t) sum = sum + rows[(t - p0) * R + pr.r];
      acc[q] = sum;
    }
    __syncthreads();
  }
  for (int q = tid; q < pairs; q += NT) out[ga * R + q] = acc[q];
}


// The same sums for rows wider than MAX_PIECE: block (b, y) sums columns
// r0 = y * RB .. r0 + rb - 1 of the R (rb = RB but in the last piece). It
// is its own text, kept in step with the kernel above by hand: both
// kernels sharing one body, as a template or as a __forceinline__
// __device__ function called with (r0, rb) = (0, R), ran slower in A/Bs on
// the card, at the training blend's R = 15 and at R = 60 and 208 (the same
// instruction count, scheduled otherwise).
__global__ void __launch_bounds__(NT) reduce_gaussians_pieced_kernel(const float* __restrict__ dgrad,
                                                                     const int* __restrict__ inv,
                                                                     const int* __restrict__ offs,
                                                                     const int* __restrict__ tiles,
                                                                     int N, int M, int R, int RB,
                                                                     float* __restrict__ out) {
  const int r0 = static_cast<int>(blockIdx.y) * RB;
  const int rb = min(RB, R - r0);
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                                       // [CAP][rb]
  float* acc = rows + CAP * rb;                             // [GB][rb]
  __shared__ int slot_inv[CAP], run_o[GB], run_n[GB];
  const int tid = threadIdx.x;
  const long long ga = static_cast<long long>(blockIdx.x) * GB;
  const int count = static_cast<int>(N - ga < GB ? N - ga : GB);
  int lo = INT_MAX, hi = 0;   // the span of the live runs, in warp 0
  if (tid < GB) {
    int o = 0, n = 0;
    if (tid < count) {
      o = offs[ga + tid];
      n = max(0, min(tiles[ga + tid], M - o));
    }
    run_o[tid] = o;
    run_n[tid] = n;
    if (n > 0) lo = o, hi = o + n;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
  }
  __shared__ int span[2];
  if (tid == 0) span[0] = lo, span[1] = hi;
  const int pairs = count * rb;   // (Gaussian, column) pairs: acc[gl * rb + r]
  for (int q = tid; q < pairs; q += NT) acc[q] = 0.0f;
  __syncthreads();
  const int s_begin = span[0], s_end = span[1];
  const int dp = NT / rb, dr = NT - dp * rb;
  const Step first = {tid / rb, tid - tid / rb * rb};
  // blocks with no slots write their zeros without waiting for the inversion
  if (s_begin < s_end) asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int p0 = s_begin; p0 < s_end; p0 += CAP) {
    const int len = min(CAP, s_end - p0);
    for (int i = tid; i < len; i += NT) slot_inv[i] = inv[p0 + i];
    __syncthreads();
    const int elems = len * rb;   // rows[p * rb + r] = dgrad[inv[p0 + p]][r0 + r]
    Step e = first;
    for (int f0 = tid; f0 < elems; f0 += IN_FLIGHT * NT) {
      float v[IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) {
        if (f0 + k * NT < elems) v[k] = dgrad[static_cast<long long>(slot_inv[e.p]) * R + r0 + e.r];
        e.next(dp, dr, rb);
      }
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k)
        if (f0 + k * NT < elems) rows[f0 + k * NT] = v[k];
    }
    __syncthreads();
    Step pr = first;   // (gl, r) of pair q
    for (int q = tid; q < pairs; q += NT, pr.next(dp, dr, rb)) {
      const int a = max(run_o[pr.p], p0), b = min(run_o[pr.p] + run_n[pr.p], p0 + len);
      float sum = acc[q];
      for (int t = a; t < b; ++t) sum = sum + rows[(t - p0) * rb + pr.r];
      acc[q] = sum;
    }
    __syncthreads();
  }
  Step pr = first;
  for (int q = tid; q < pairs; q += NT, pr.next(dp, dr, rb)) out[(ga + pr.p) * R + r0 + pr.r] = acc[q];
}

// Columns a block sums for R rows (R itself up to MAX_PIECE, else R split
// evenly into pieces of at most MAX_PIECE), and the pieces, none empty.
int piece_width(int R) {
  if (R <= MAX_PIECE) return R;
  const int p = (R + MAX_PIECE - 1) / MAX_PIECE;
  return (R + p - 1) / p;
}
int pieces(int R) { return R <= MAX_PIECE ? 1 : (R + piece_width(R) - 1) / piece_width(R); }

// Dynamic shared bytes of a summing block for R rows: the staged rows and
// the sums of its columns.
size_t smem_bytes(int R) { return static_cast<size_t>(CAP + GB) * piece_width(R) * sizeof(float); }

const void* pick(int R) {
  return pieces(R) > 1 ? reinterpret_cast<const void*>(reduce_gaussians_pieced_kernel)
                       : reinterpret_cast<const void*>(reduce_gaussians_kernel);
}

cudaError_t launch_sum(const float* dgrad, const int* inv, const int* offs, const int* tiles,
                       int N, int M, int R, float* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((static_cast<long long>(N) + GB - 1) / GB),
                     static_cast<unsigned>(pieces(R)));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(R);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (pieces(R) > 1) {
    return cudaLaunchKernelEx(&cfg, reduce_gaussians_pieced_kernel, dgrad, inv, offs, tiles, N, M, R,
                              piece_width(R), out);
  }
  return cudaLaunchKernelEx(&cfg, reduce_gaussians_kernel, dgrad, inv, offs, tiles, N, M, R, out);
}

}  // namespace

// dgrad: [M, R] f32 per-slot rows in sorted order; order: [M] int64, the
// stable sort's permutation (sorted position -> pre-sort slot) of K2's keys;
// offs, tiles: [N] int32 (exclusive prefix and clamped counts, tiles >= 0);
// inv: [M] int32 scratch. Writes out [N, R] f32. Two launches on `stream`.
// Returns the CUDA error code.
extern "C" int reduce_gaussians(const void* dgrad, const void* order, const void* offs,
                                const void* tiles, int N, int M, int R, void* inv,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offs);
  const int* t = static_cast<const int*>(tiles);
  if (N == 0 || R == 0) return 0;
  if (M > 0) {
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(M) + NT - 1) / NT);
    invert_order_kernel<<<blocks, NT, 0, s>>>(static_cast<const long long*>(order), o, t, N, M,
                                              static_cast<int*>(inv));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const float* d = static_cast<const float*>(dgrad);
  float* r = static_cast<float*>(out);
  const cudaError_t err = launch_sum(d, static_cast<const int*>(inv), o, t, N, M, R, r, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block (static + dynamic) of the summing kernel's instance for R = C rows
// (the inversion is one load and one store per slot): out[0..2]. tw and th are
// those of the other kernels' attribute functions and are not used.
// Returns the CUDA error code.
extern "C" int reduce_gaussians_attributes(int C, int tw, int th, int* out) {
  (void)tw, (void)th;
  cudaFuncAttributes a;
  const int err = static_cast<int>(cudaFuncGetAttributes(&a, pick(C)));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + smem_bytes(C));
  return 0;
}
