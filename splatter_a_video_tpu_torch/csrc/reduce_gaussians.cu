// K4 reduce_gaussians: sum K3's per-slot gradient rows into per-Gaussian
// gradients.
//
// Replaces the XLA `reduce_to_gaussians` of
// `splatter_a_video_tpu/ops/rasterize_tpu.py` (`_build_splat`), which sorts
// the slots back, gathers them and runs a log2(cap)-pass Hillis-Steele
// segmented sum because TPU scatters serialise. On the GPU the simpler
// form is also the deterministic one: invert the slot sort's permutation
// with one int scatter, then one warp per Gaussian walks its run of at
// most `max_tiles_per_gaussian` pre-sort slots offs[g] .. offs[g] +
// tiles[g] - 1 in that order, lane r summing row r. Slots at or past the
// budget M are skipped; Gaussians without tiles get zeros. No float
// atomics: the sum order is fixed, and the plain PyTorch version
// (`rasterize_gpu.reduce_gaussians_plain`) repeats it.
//
// Bound: bytes (each slot row read once, 4 * R bytes, plus the permutation
// and the [N, R] output). The row reads are gathers: a warp reads one
// slot's R contiguous floats at a time.

#include <cuda_runtime.h>

namespace {

__global__ void invert_permutation_kernel(const long long* __restrict__ order, int M,
                                          int* __restrict__ inv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) inv[order[i]] = i;
}

__global__ void reduce_gaussians_kernel(const float* __restrict__ dgrad,
                                        const int* __restrict__ inv,
                                        const int* __restrict__ offs,
                                        const int* __restrict__ tiles, int N, int M,
                                        int R, float* __restrict__ out) {
  const long long gw = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= N) return;
  const int o = offs[gw];
  const int n = max(0, min(tiles[gw], M - o));
  for (int r = lane; r < R; r += 32) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = acc + dgrad[static_cast<long long>(inv[o + j]) * R + r];
    out[gw * R + r] = acc;
  }
}

}  // namespace

// dgrad: [M, R] f32 per-slot rows in sorted order; order: [M] int64, the
// stable sort's permutation (sorted position -> pre-sort slot); offs,
// tiles: [N] int32 (exclusive prefix and clamped counts); inv: [M] int32
// scratch. Writes out [N, R] f32. Two launches on `stream`. Returns
// cudaGetLastError().
extern "C" int reduce_gaussians(const void* dgrad, const void* order, const void* offs,
                                const void* tiles, int N, int M, int R, void* inv,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    invert_permutation_kernel<<<(M + 255) / 256, 256, 0, s>>>(
        static_cast<const long long*>(order), M, static_cast<int*>(inv));
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (N > 0) {
    const long long threads = 32LL * N;
    reduce_gaussians_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(dgrad), static_cast<const int*>(inv),
        static_cast<const int*>(offs), static_cast<const int*>(tiles), N, M, R,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local (spill) bytes per thread and shared bytes per
// block of the summing kernel (the permutation inverse is one store per
// thread): out[0..2]. The arguments are those of the other kernels'
// attribute functions and are not used. Returns the CUDA error code.
extern "C" int reduce_gaussians_attributes(int C, int tw, int th, int* out) {
  (void)C, (void)tw, (void)th;
  cudaFuncAttributes a;
  const int err = static_cast<int>(cudaFuncGetAttributes(&a, reduce_gaussians_kernel));
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
