// Row gather of a row-major (ncols, R) X, which the tile kernels of
// seg_tile.cuh and panel_tile.cuh take at R > 1 (K8, K10). Each source
// includes it and builds alone; _build.py hashes it into every library's
// name.

#pragma once

#include <cuda_runtime.h>

namespace {

// X row c into xr: 16-byte loads where R is a multiple of 4 (8-byte ones
// where it is even) and the base pointer allows (vec), scalar loads
// otherwise. vec is the same for the whole launch, so the branch is uniform.
template <int R>
__device__ __forceinline__ void load_x_row(const float* __restrict__ X, int c,
                                           bool vec, float (&xr)[R]) {
  const float* p = X + static_cast<long long>(c) * R;
  if constexpr (R % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
        xr[4 * q] = v.x; xr[4 * q + 1] = v.y; xr[4 * q + 2] = v.z; xr[4 * q + 3] = v.w;
      }
      return;
    }
  } else if constexpr (R % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 2; ++q) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p) + q);
        xr[2 * q] = v.x; xr[2 * q + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) xr[j] = __ldg(p + j);
}

}  // namespace
