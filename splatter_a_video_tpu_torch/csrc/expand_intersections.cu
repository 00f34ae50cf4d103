// K2 expand_intersections: ragged expansion of Gaussians into tile slots.
//
// Replaces `splatter_a_video_tpu/ops/binning.py` `_monotone_expand_pallas`
// (and the scatter + fill-forward expansion of `bin_sort_pack`, the JAX
// default): for every slot s, the owner g with offs[g] <= s < offs[g] +
// tiles[g], and j = s - offs[g]. Per slot s = offs[g] + j < M it writes
//   gid[s] = g
//   key[s] = int64(tile) << 32 | bits(max(depth, 0))
// with tile = (rmy + j / rw) * tgx + (rmx + j % rw), rw = max(rect width, 1):
// the row-major placement and clamped-count truncation of
// `binning.py:382,473-475`. Non-negative float bit patterns order like the
// floats, so a stable sort of the keys gives tile-major, depth-ascending
// order with ties broken by Gaussian index. Slots in [min(total, M), M)
// get key INT64_MAX and gid -1, in the same launch; slots beyond the budget
// are dropped in Gaussian-index order, as the JAX non-presorted path drops
// them.
//
// Bound: bytes. The M slots are written once (8-byte key + 4-byte id, 12.6
// MB at M = 1 << 20), every Gaussian's tile count is read once, and offs,
// rect_min, rect_max.x and depth (20 bytes) once for each Gaussian with
// tiles; there is no arithmetic to speak of. The design is slot-parallel, like the TPU kernel's monotone
// window, so that every store is coalesced: a block owns 2048 consecutive
// slots. One warp finds the owner of its first slot and another that of
// its last used slot, each by a 128-ary search over offs (the largest g
// with offs[g] <= s; a Gaussian without tiles shares its offs with the next
// one, so the search lands on a Gaussian that has tiles, and culled
// Gaussians may lie anywhere, in runs of any length). The block walks the
// Gaussians between the two, four loads of each in flight a thread, and at
// the block position where each run starts stores the run's owner, the tile
// of its slot j = 0, its rect width and its depth key in shared memory; a
// block-wide max-scan gives every slot the start of its run. Threads then
// write two consecutive slots at a time: one 16-byte store of two keys and
// one 8-byte store of two ids, consecutive across the warp. A block wholly
// past the used slots writes only sentinels, with the same stores. The
// chain of dependent memory trips of a block is short: `used` and the
// searches (three rounds, the first search and `used` in parallel), the
// walk, then the stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int PER_THREAD = 8;           // consecutive slots per thread in the scan
constexpr int SLOTS = NT * PER_THREAD;  // slots per block

// Largest g in [0, N) with offs[g] <= s, given offs[0] <= s and offs
// nondecreasing: each round the warp probes 128 evenly spaced entries, four
// independent loads a lane, and keeps the span between the last probe <= s
// and the next (3 rounds at N = 131,000). Called by all 32 lanes of a warp.
__device__ int owner_of(const int* __restrict__ offs, int N, int s) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = N;
  while (hi - lo > 1) {
    const int step = (hi - lo + 127) / 128;
    int c = 0;   // probes <= s, a prefix of the 128; >= 1 since offs[lo] <= s
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = lo + (4 * lane + q) * step;
      c += __popc(__ballot_sync(0xffffffffu, p < hi && offs[p] <= s));
    }
    lo += (c - 1) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

__global__ void __launch_bounds__(NT) expand_intersections_kernel(
    const int* __restrict__ offs, const int* __restrict__ tiles,
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const float* __restrict__ depth, int N, int M, int tgx,
    long long* __restrict__ keys, int* __restrict__ gid) {
  // own[i]: the block position where slot i's run starts in the block (0
  // for the run that starts before it); at each such position the owner, the
  // tile of its slot j = 0, its rect width and its depth key
  __shared__ __align__(16) int own[SLOTS];
  __shared__ int run_g[SLOTS], run_tile0[SLOTS], run_rw[SLOTS];
  __shared__ unsigned run_bits[SLOTS];
  __shared__ int window[2], base0;
  __shared__ int warp_max[NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = N > 0 ? offs[N - 1] + tiles[N - 1] : 0;
  const int used = min(total, M);
  const int s0 = blockIdx.x * SLOTS;
  const int s_hi = s0 + min(SLOTS, M - s0) - 1;   // the block's last slot

  // the owners of the first and the last slot, found while `used` loads;
  // the second assumes the block is all used and is redone if it is not
  int found = 0;
  if (warp < 2) found = owner_of(offs, N, warp == 0 ? s0 : s_hi);
  if (s0 < used) {   // the same in every thread of the block
    if (warp == 1 && s_hi >= used) found = owner_of(offs, N, used - 1);
    if (warp < 2 && lane == 0) window[warp] = found;
    for (int i = tid; i < SLOTS; i += NT) own[i] = -1;
    __syncthreads();
    const int g0 = window[0], g1 = window[1];
    // every Gaussian in (g0, g1] with tiles starts its run inside the block;
    // four Gaussians a thread and step, their loads issued together
    for (int g = g0 + tid; g <= g1; g += 4 * NT) {
      int t[4], o[4], rmx[4], rmy[4], rxe[4];
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = g + q * NT;
        t[q] = 0;
        if (h <= g1) {
          t[q] = tiles[h], o[q] = offs[h], d[q] = depth[h];
          rmx[q] = rect_min[2 * h], rmy[q] = rect_min[2 * h + 1], rxe[q] = rect_max[2 * h];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (t[q] > 0) {
          const int h = g + q * NT;
          const int pos = h == g0 ? 0 : o[q] - s0;
          if (h == g0) base0 = o[q];
          own[pos] = pos;
          run_g[pos] = h;
          run_tile0[pos] = rmy[q] * tgx + rmx[q];
          run_rw[pos] = max(rxe[q] - rmx[q], 1);
          run_bits[pos] = __float_as_uint(d[q] > 0.0f ? d[q] : 0.0f);
        }
      }
    }
    __syncthreads();

    // inclusive max-scan of own[]: the marks rise with the position, so each
    // slot gets the last run start at or before it
    int v[PER_THREAD];
    const int4* mine = reinterpret_cast<const int4*>(own + tid * PER_THREAD);
#pragma unroll
    for (int q = 0; q < PER_THREAD / 4; ++q) {
      const int4 m = mine[q];
      v[4 * q] = m.x, v[4 * q + 1] = m.y, v[4 * q + 2] = m.z, v[4 * q + 3] = m.w;
    }
#pragma unroll
    for (int i = 1; i < PER_THREAD; ++i) v[i] = max(v[i], v[i - 1]);
    int incl = v[PER_THREAD - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = max(incl, y);
    }
    int before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = -1;
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
    int4* put = reinterpret_cast<int4*>(own + tid * PER_THREAD);
#pragma unroll
    for (int q = 0; q < PER_THREAD / 4; ++q)
      put[q] = make_int4(max(before, v[4 * q]), max(before, v[4 * q + 1]),
                         max(before, v[4 * q + 2]), max(before, v[4 * q + 3]));
    __syncthreads();
  }

  // two consecutive slots per thread and step, consecutive across the block
#pragma unroll
  for (int q = 0; q < SLOTS / (2 * NT); ++q) {
    const int p = q * NT + tid;
    const int s = s0 + 2 * p;
    if (s >= M) break;
    long long k[2];
    int id[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (s + i < used) {
        const int pos = own[2 * p + i];
        const int j = s + i - (pos == 0 ? base0 : s0 + pos);
        const int rw = run_rw[pos];
        const int tile = run_tile0[pos] + (j / rw) * tgx + j % rw;
        k[i] = (static_cast<long long>(tile) << 32) | static_cast<long long>(run_bits[pos]);
        id[i] = run_g[pos];
      } else {
        k[i] = INT64_MAX;
        id[i] = -1;
      }
    }
    if (s + 1 < M) {
      *reinterpret_cast<longlong2*>(keys + s) = make_longlong2(k[0], k[1]);
      *reinterpret_cast<int2*>(gid + s) = make_int2(id[0], id[1]);
    } else {   // an odd M: the last slot alone
      keys[s] = k[0];
      gid[s] = id[0];
    }
  }
}

}  // namespace

// offs, tiles: [N] int32 (offs the exclusive prefix of tiles, tiles >= 0);
// rect_min, rect_max: [N, 2] int32; depth: [N] f32; keys: [M] int64 and
// gid: [M] int32 (outputs, 16- and 8-byte aligned). Returns
// cudaGetLastError().
extern "C" int expand_intersections(const void* offs, const void* tiles,
                                    const void* rect_min, const void* rect_max,
                                    const void* depth, int N, int M, int tgx,
                                    void* keys, void* gid, void* stream) {
  if (M == 0) return 0;
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(M) + SLOTS - 1) / SLOTS);
  expand_intersections_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offs), static_cast<const int*>(tiles),
      static_cast<const int*>(rect_min), static_cast<const int*>(rect_max),
      static_cast<const float*>(depth), N, M, tgx,
      static_cast<long long*>(keys), static_cast<int*>(gid));
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block of the kernel: out[0..2]. The arguments are those of the other
// kernels' attribute functions and are not used. Returns the CUDA error code.
extern "C" int expand_intersections_attributes(int C, int tw, int th, int* out) {
  (void)C, (void)tw, (void)th;
  cudaFuncAttributes a;
  const int err = static_cast<int>(cudaFuncGetAttributes(&a, expand_intersections_kernel));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
