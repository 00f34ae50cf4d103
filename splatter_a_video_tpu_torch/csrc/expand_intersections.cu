// K2 expand_intersections: ragged expansion of Gaussians into tile slots.
//
// Replaces `splatter_a_video_tpu/ops/binning.py` `_monotone_expand_pallas`
// (and the scatter + fill-forward expansion of `bin_sort_pack`, the JAX
// default): for every slot s, the owner g with offs[g] <= s < offs[g] +
// tiles[g], and j = s - offs[g]. The TPU needed a monotone-window search
// because it has no fast scatter; on Hopper each Gaussian simply writes its
// own run of slots.
//
// Bound: bytes. Each Gaussian reads 28 bytes (offs, tiles, rect, depth) and
// each of the M slots is written once (8-byte key + 4-byte id); there is
// no arithmetic to speak of. The design keeps it to that one pass: one
// thread per Gaussian writes its slots directly (no search, no second
// pass), and the same launch fills the unused tail of the budget with
// sentinels so the sort needs no separate initialisation.
//
// Per slot s = offs[g] + j < M it writes
//   gid[s] = g
//   key[s] = int64(tile) << 32 | bits(max(depth, 0))
// with tile = (rmy + j / rw) * tgx + (rmx + j % rw), rw = max(rect width, 1):
// the row-major placement and clamped-count truncation of
// `binning.py:382,473-475`. Non-negative float bit patterns order like the
// floats, so a stable sort of the keys gives tile-major, depth-ascending
// order with ties broken by Gaussian index. Slots in [min(total, M), M)
// get key INT64_MAX and gid -1; slots beyond the budget are dropped in
// Gaussian-index order, as the JAX non-presorted path drops them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void expand_intersections_kernel(
    const int* __restrict__ offs, const int* __restrict__ tiles,
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const float* __restrict__ depth, int N, int M, int tgx,
    long long* __restrict__ keys, int* __restrict__ gid) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int total = N > 0 ? offs[N - 1] + tiles[N - 1] : 0;
  const int used = total < M ? total : M;
  if (i < M && i >= used) {
    keys[i] = INT64_MAX;
    gid[i] = -1;
  }
  if (i >= N) return;
  const int n = tiles[i];
  if (n <= 0) return;
  const int o = offs[i];
  const int rmx = rect_min[2 * i];
  const int rmy = rect_min[2 * i + 1];
  const int rw = max(rect_max[2 * i] - rmx, 1);
  const float d = depth[i];
  const long long bits = static_cast<long long>(__float_as_uint(d > 0.0f ? d : 0.0f));
  const int stop = min(n, M - o);
  for (int j = 0; j < stop; ++j) {
    const int tile = (rmy + j / rw) * tgx + (rmx + j % rw);
    keys[o + j] = (static_cast<long long>(tile) << 32) | bits;
    gid[o + j] = static_cast<int>(i);
  }
}

}  // namespace

// offs, tiles: [N] int32; rect_min, rect_max: [N, 2] int32; depth: [N] f32;
// keys: [M] int64 and gid: [M] int32 (outputs). Returns cudaGetLastError().
extern "C" int expand_intersections(const void* offs, const void* tiles,
                                    const void* rect_min, const void* rect_max,
                                    const void* depth, int N, int M, int tgx,
                                    void* keys, void* gid, void* stream) {
  const long long threads = N > M ? N : M;
  if (threads == 0) return 0;
  const int block = 256;
  const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
  expand_intersections_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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
