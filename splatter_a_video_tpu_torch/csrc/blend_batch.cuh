// The blend's constants, the per-Gaussian record and the cp.async batch
// staging that K1 (blend_forward.cu) and K3 (blend_backward.cu) share.
//
// Record of Gaussian g, built by `rasterize_gpu.pack_records`: two float4,
//   rec[2g]     = (ux, uy, conic a, conic b)
//   rec[2g + 1] = (conic c, opacity, bias (0 without one), 0).
//
// A batch buffer in shared memory holds S slots: their records, in K1 their
// ids (STAGE_GID), and their feature rows, each padded to a multiple of 4
// floats so the blend reads them as float4 (a broadcast: every lane of a
// warp reads the same slot). The block copies batch k+1 into the second of
// two such buffers while it works on batch k.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace blend {

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// Floats per staged feature row: C rounded up to a multiple of 4.
__host__ __device__ __forceinline__ int row_floats(int C) { return (C + 3) & ~3; }

template <int S, bool STAGE_GID>
struct Batch {
  static_assert(S % 4 == 0, "S ids fill whole float4s");
  static constexpr int GID_FLOAT4S = STAGE_GID ? S / 4 : 0;

  float4* rec;    // [S][2]
  int* gid;       // [S], or null without STAGE_GID
  float4* feat;   // [S][row_floats(C) / 4]

  __host__ __device__ static int float4s(int C) { return 2 * S + GID_FLOAT4S + S * row_floats(C) / 4; }

  // Buffer q (0 or 1) of the two that start at smem.
  __device__ static Batch at(float4* smem, int q, int C) {
    float4* b = smem + q * float4s(C);
    return {b, STAGE_GID ? reinterpret_cast<int*>(b + 2 * S) : nullptr, b + 2 * S + GID_FLOAT4S};
  }

  // Start the asynchronous copies of slots base .. base + n - 1 (n <= S):
  // one 16-byte copy per record half, one 4-byte copy per feature.
  __device__ void load(const int* __restrict__ gid_in, const float4* __restrict__ rec_in,
                       const float* __restrict__ features, int C, int base, int n) const {
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
      const long long g = gid_in[base + (i >> 1)];
      if (STAGE_GID && !(i & 1)) gid[i >> 1] = static_cast<int>(g);
      __pipeline_memcpy_async(rec + i, rec_in + 2 * g + (i & 1), 16);
    }
    for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
      const int j = i % S;
      const int c = i / S;
      if (j < n) {
        const long long g = gid_in[base + j];
        __pipeline_memcpy_async(reinterpret_cast<float*>(feat) + j * row_floats(C) + c,
                                features + g * C + c, 4);
      }
    }
  }
};

}  // namespace blend
