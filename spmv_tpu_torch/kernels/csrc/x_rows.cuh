// Rows of R values, row-major: the X gather of the tile kernels of
// seg_tile.cuh and panel_tile.cuh at R > 1 (K8, K10), every row store of
// the tile kernels, and K7's loads and stores (panel_spmv.cu). Each source
// includes it and builds alone; _build.py hashes it into every library's
// name.

#pragma once

#include <cuda_runtime.h>
#include <type_traits>

namespace {

// How a row is read. LdgLoad goes through the read-only path, for data no
// kernel writes while the reader runs (X). CoherentLoad is a plain load,
// for data the kernel ahead of a programmatic dependent launch writes while
// the dependent may already be resident (K7's y′, partials and spill).
struct LdgLoad {
  template <typename V>
  __device__ __forceinline__ static V at(const V* p) { return __ldg(p); }
};
struct CoherentLoad {
  template <typename V>
  __device__ __forceinline__ static V at(const V* p) { return *p; }
};

// The row of R values at p into v: 16-byte accesses where R is a multiple
// of 4 floats (8-byte ones where it is even) and vec says the launch's
// pointers allow them, scalar ones otherwise and for double. vec is the
// same for the whole launch, so the branch is uniform.
template <int R, typename Load = LdgLoad, typename T>
__device__ __forceinline__ void load_row(const T* p, bool vec, T (&v)[R]) {
  if constexpr (std::is_same_v<T, float> && R % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 w = Load::at(reinterpret_cast<const float4*>(p) + q);
        v[4 * q] = w.x; v[4 * q + 1] = w.y; v[4 * q + 2] = w.z; v[4 * q + 3] = w.w;
      }
      return;
    }
  } else if constexpr (std::is_same_v<T, float> && R % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 2; ++q) {
        const float2 w = Load::at(reinterpret_cast<const float2*>(p) + q);
        v[2 * q] = w.x; v[2 * q + 1] = w.y;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = Load::at(p + j);
}

// The row of R values v to p, with load_row's access widths (scalar
// stores unless vec is given).
template <int R, typename T>
__device__ __forceinline__ void store_row(T* p, const T (&v)[R], bool vec = false) {
  if constexpr (std::is_same_v<T, float> && R % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        reinterpret_cast<float4*>(p)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
      return;
    }
  } else if constexpr (std::is_same_v<T, float> && R % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 2; ++q) {
        reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) p[j] = v[j];
}

// X's row c (ncols rows of R floats) into xr, through the read-only path.
template <int R>
__device__ __forceinline__ void load_x_row(const float* __restrict__ X, int c,
                                           bool vec, float (&xr)[R]) {
  load_row<R>(X + static_cast<long long>(c) * R, vec, xr);
}

}  // namespace
