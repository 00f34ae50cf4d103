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
// Bound: bytes. Each used slot's row (4R bytes) and its int64 sort
// position are read once, offs / tiles once, the [N, R] output written
// once: used * (4R + 8) + N * (8 + 4R) bytes, about 42 MB at the training
// blend's R = 15 and 153 MB at the wide training blend's R = 60. What the
// card allows is less: the rows are read through the inverse permutation,
// so each row is a random gather whose first and last 32-byte sectors are
// shared with unrelated rows. The design therefore spends its effort on
// keeping many such gathers in flight, in two launches on one stream:
//
//  1. invert_order_kernel: inv[order[i]] = i for the sorted positions
//     i < used = min(offs[N-1] + tiles[N-1], M), read on the device (no
//     host sync). The sentinel keys of K2 sort after every real key, so the
//     positions i >= used hold the sentinel slots, which no run reads.
//  2. The sums, a programmatic launch (PDL): blocks read offs / tiles, and
//     those without slots write their zeros, while the inversion still
//     runs; the others wait for it (griddepcontrol.wait) before they read
//     inv. One of two kernels:
//     - R <= 41 (the training blend's R = 15, the C = 4 paths' R = 12):
//       reduce_gaussians_kernel. A block takes 32 consecutive Gaussians,
//       whose clamped runs are consecutive pre-sort slots (~120 at the
//       flagship). It loads their inv entries in one coalesced load, then
//       gathers their rows element by element across all 256 threads,
//       eight independent loads a thread in flight, into shared memory;
//       then one thread per (Gaussian, row) adds that Gaussian's rows in
//       slot order from shared memory and the block writes the [32, R]
//       sums as one contiguous store. Runs longer than 256 slots in all
//       are staged in pieces, the sums kept in shared memory between them.
//       Its (256 + 32) staged rows, 1,152 R bytes, stay under the 48 KB a
//       block takes without the opt-in up to R = 41.
//     - R > 41 (the wide training blend's R = 60, any width):
//       reduce_gaussians_wide_kernel, with 2,320 B of static shared memory
//       whatever R. A block takes 32 consecutive Gaussians, reads their
//       runs and stages the inv entries of their slots (the first
//       WIDE_SPAN, one coalesced load; the rest are read from inv). A group
//       of lanes then sums its share of the 32 in turn: a half-warp two
//       Gaussians while 16 float4s cover the row (R % 4 == 0, R <= 64),
//       else a warp four. Lane l takes column l of the row, then l + lanes,
//       ... (float4s where rows and output are 16-byte aligned, else
//       floats), so each slot's row is read once, with 16-byte loads on
//       neighbouring lanes where it can be, and the sums stay in
//       registers. A lane walks its group's runs in slot order as one
//       stream with the rows of WIDE_RING slots in flight (a ring: each add
//       issues the load WIDE_RING slots on, so that a run's end does not
//       drain the next run's loads). What holds it back is latency: each
//       row is a load that waits on loads (offs, then inv), so the loads
//       in flight come from the warps an SM rather than from the loads a
//       warp: two slots a lane in at most 40 registers, for 6 blocks of 8
//       warps an SM, measured fastest at R = 60 against rings of 1, 4 and
//       8 slots and 4, 5 and 8 blocks an SM (PERF.md).
//
// Precondition, which the plain version does not have: every sorted
// position i >= used maps to a pre-sort slot >= used, so that inv is set
// at every slot a run reads. `Binning.order` meets it; for another
// permutation the result is undefined.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int GB = 32;          // Gaussians per block of the summing kernel
constexpr int CAP = 256;        // slots staged per piece (a block's runs: ~120 at the flagship)
constexpr int IN_FLIGHT = 8;    // row elements a thread loads before it stores them
constexpr int NARROW_MAX = 41;  // widest row the staging kernel takes: (CAP + GB) * 41 floats = 47,232 B
// the staged rows and sums, plus the static slot_inv, run_o, run_n and span
static_assert(((CAP + GB) * NARROW_MAX + CAP + 2 * GB + 2) * sizeof(float) <= 48 * 1024,
              "a block's shared memory needs no opt-in");
constexpr int WIDE_RING = 2;    // slots whose rows a lane of the wide kernel has in flight
constexpr int WIDE_SPAN = 512;  // slots of a block's runs whose inv entries the wide kernel stages
constexpr int WIDE_BLOCKS = 6;  // blocks an SM of the wide kernel: at most 40 registers, none spilled
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


__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Lane-wise sums of kn consecutive Gaussians' runs (run_o / run_n from
// k0 on) into dst[k * RV] for the k-th, column c of rows of RV vectors V:
// one walk over the slots of all kn runs in order, the rows of WIDE_RING
// slots in flight (a ring: the slot WIDE_RING on is loaded as soon as a
// slot is added), so that one run's end does not drain the loads of the
// next. A slot's sorted row comes from the block's staged inv entries
// (sh_inv, from slot lo on), or from inv past them.
template <typename V>
__device__ __forceinline__ void sum_runs(const V* __restrict__ rows, const int* __restrict__ inv,
                                         const int* sh_inv, int lo, const int* run_o, const int* run_n,
                                         int k0, int kn, int RV, int c, V* __restrict__ dst) {
  int total = 0;
  for (int k = 0; k < kn; ++k) {
    total += run_n[k0 + k];
    if (run_n[k0 + k] == 0) dst[k * RV] = V{};
  }
  if (total == 0) return;
  int lk = 0;   // the load cursor: slot ls of run lk, which ends at le
  while (run_n[k0 + lk] == 0) ++lk;
  int ls = run_o[k0 + lk], le = ls + run_n[k0 + lk];
  int ak = lk, left = run_n[k0 + lk];   // the add cursor: run ak, slots left in it
  auto next = [&]() {   // the row at the load cursor's slot; the cursor one slot on
    const int d = ls - lo;
    const V r = rows[static_cast<long long>(d < WIDE_SPAN ? sh_inv[d] : inv[ls]) * RV + c];
    if (++ls == le) {
      while (lk + 1 < kn && run_n[k0 + lk + 1] == 0) ++lk;
      if (lk + 1 < kn) ++lk, ls = run_o[k0 + lk], le = ls + run_n[k0 + lk];
    }
    return r;
  };
  V v[WIDE_RING];
#pragma unroll
  for (int u = 0; u < WIDE_RING; ++u)
    if (u < total) v[u] = next();
  V acc = V{};
  for (int i = 0; i < total; i += WIDE_RING) {
#pragma unroll
    for (int u = 0; u < WIDE_RING; ++u) {
      if (i + u < total) {
        acc = add(acc, v[u]);
        if (i + u + WIDE_RING < total) v[u] = next();
        if (--left == 0) {
          dst[ak * RV] = acc;
          acc = V{};
          if (i + u + 1 < total) {
            do ++ak; while (run_n[k0 + ak] == 0);
            left = run_n[k0 + ak];
          }
        }
      }
    }
  }
}

// Lanes that own one Gaussian at a time in the wide kernel: a half-warp
// where 16 float4s cover the row.
__device__ __forceinline__ int wide_lanes(int R, int vec4) { return vec4 && R <= 64 ? 16 : 32; }

// The sums for rows wider than NARROW_MAX (any R). A block takes GB
// consecutive Gaussians: warp 0 reads their runs, the block stages the inv
// entries of their slots (one coalesced load, the first WIDE_SPAN), then
// each group of wide_lanes(R, vec4) lanes sums GB * lanes / NT consecutive
// Gaussians (sum_runs), lane l columns l, l + lanes, ... of the row:
// float4 loads and stores when vec4 (R % 4 == 0 and dgrad, out 16-byte
// aligned), float ones else.
__global__ void __launch_bounds__(NT, WIDE_BLOCKS)
    reduce_gaussians_wide_kernel(const float* __restrict__ dgrad, const int* __restrict__ inv,
                                 const int* __restrict__ offs, const int* __restrict__ tiles, int N, int M,
                                 int R, int vec4, float* __restrict__ out) {
  __shared__ int sh_inv[WIDE_SPAN], run_o[GB], run_n[GB], span[2];
  const int tid = threadIdx.x;
  const long long ga = static_cast<long long>(blockIdx.x) * GB;
  const int count = static_cast<int>(N - ga < GB ? N - ga : GB);
  if (tid < GB) {
    int o = 0, n = 0, lo = INT_MAX, hi = 0;   // the span of the live runs
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
    if (tid == 0) span[0] = lo, span[1] = hi;
  }
  __syncthreads();
  const int lo = span[0], hi = span[1];
  if (lo < hi) {   // blocks with no slots write their zeros without waiting for the inversion
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int i = tid; i < min(hi - lo, WIDE_SPAN); i += NT) sh_inv[i] = inv[lo + i];
  }
  __syncthreads();
  const int lanes = wide_lanes(R, vec4);
  const int per = GB * lanes / NT;   // Gaussians a group sums: 2 on half-warps, 4 on warps
  const int k0 = tid / lanes * per, kn = max(0, min(per, count - k0));
  if (vec4) {
    const int RV = R / 4;
    float4* dst = reinterpret_cast<float4*>(out) + (ga + k0) * RV;
    for (int c = tid % lanes; c < RV; c += lanes)
      sum_runs(reinterpret_cast<const float4*>(dgrad), inv, sh_inv, lo, run_o, run_n, k0, kn, RV, c, dst + c);
  } else {
    float* dst = out + (ga + k0) * R;
    for (int c = tid % lanes; c < R; c += lanes)
      sum_runs(dgrad, inv, sh_inv, lo, run_o, run_n, k0, kn, R, c, dst + c);
  }
}

// Dynamic shared bytes of a summing block for R rows: the staging kernel's
// rows and sums; the wide kernel has none.
size_t smem_bytes(int R) { return R <= NARROW_MAX ? static_cast<size_t>(CAP + GB) * R * sizeof(float) : 0; }

const void* pick(int R) {
  return R <= NARROW_MAX ? reinterpret_cast<const void*>(reduce_gaussians_kernel)
                         : reinterpret_cast<const void*>(reduce_gaussians_wide_kernel);
}

cudaError_t launch_sum(const float* dgrad, const int* inv, const int* offs, const int* tiles,
                       int N, int M, int R, float* out, cudaStream_t s) {
  const int vec4 = R % 4 == 0 && (reinterpret_cast<uintptr_t>(dgrad) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((static_cast<long long>(N) + GB - 1) / GB));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(R);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (R <= NARROW_MAX) {
    return cudaLaunchKernelEx(&cfg, reduce_gaussians_kernel, dgrad, inv, offs, tiles, N, M, R, out);
  }
  return cudaLaunchKernelEx(&cfg, reduce_gaussians_wide_kernel, dgrad, inv, offs, tiles, N, M, R, vec4, out);
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
