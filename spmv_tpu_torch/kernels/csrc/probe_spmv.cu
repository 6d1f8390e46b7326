// Probe kernels for Hopper (sm_90a): variants of K1 and K2 with one stage
// changed or cut, timed against the production kernels by
// spmv_tpu_torch/probes/. They replace the JAX package's on-chip probes
// (scripts/probe_*.py), which time Pallas variants of the TPU kernels on
// synthetic streams; these run on the real plans instead, and each variant
// computes a defined function that its plain version in
// spmv_tpu_torch/kernels/probes.py reproduces.
//
//   seg_spmv_tiles_u16      K1 with uint16 columns (6 B per nonzero, 10 in
//   seg_spmv_tiles_u16_x2   fp64): replaces scripts/probe_pack.py:147 (bytes
//                           per slot). The same bits as K1 / K12.
//   seg_spmv_tiles_at       K1 at tiles of 128 (one warp, no shared-memory
//   carry_fixup_at          stage), 512 and 2048 nonzeros, with their K2:
//                           replaces scripts/probe_accum.py:168 (the
//                           granularity at which row partials are folded).
//   seg_ablate              K1 with a stage cut (float32), and
//   seg_ablate_x2           K12 with a stage cut (float64): replace
//                           scripts/probe_ablate.py:152, probe_ablate2.py:175,
//                           probe_ablate3.py:211 and probe_x2.py:241.
//   seg_spmv_tiles_fold     K1 with K2 folded into its last block: y = A·x
//                           in one launch. Each block runs K1's block, makes
//                           its writes visible (__threadfence) and counts
//                           itself on an integer counter; the last to
//                           arrive adds every split row's carries in K2's
//                           order, reading them from L2, and resets the
//                           counter for the next launch. The same bits as
//                           K1 + K2; no float atomics. It asks what the
//                           fix-up's separate launch costs (the scatter
//                           epilogue of scripts/probe_ablate3.py:211).
//   launch_floor            a one-block kernel that does nothing: the least
//                           time a separate launch takes in a CUDA graph,
//                           beside which the fix-ups (K2, K7, K9, K13) are
//                           timed. It replaces no TPU kernel.
//   panel_ablate_nogather   K4 (float32) and K14 (float64) with x(c) =
//   panel_ablate_x2_nogather (c & 1023)·2⁻¹⁰ computed in registers: the
//                           panel tile kernel of panel_tile.cuh without the
//                           x gather, every column still copied. Equals K4 /
//                           K14 on that x̃ bit for bit. With the stream of
//                           the panel's values and columns alone (seg_ablate's
//                           dma over them) it splits K4 into stream, gather
//                           and walk (the nowin cut of
//                           scripts/probe_ablate.py:152, on the panel).
//
// seg_ablate modes, on K1's grid (one block of 256 threads per tile of
// 1024 nonzeros, 16-byte loads of values and columns):
//
//   0 nogather  K1 with x(c) = (c & 1023)·2⁻¹⁰ computed in registers: no x
//               read, every column still loaded. Equals K1 on that x̃ bit
//               for bit (the TPU probes' "nowin").
//   1 noseg     no binary search, row tracking, scan or emit: out[t] = the
//               tile's Σ v·x[c] (a block-wide sum) (the TPU probes' "noseg").
//   2 dma       out[t] = Σ (v + x̃(c)) over the tile, x̃ as in nogather:
//               streams the plan's values and columns and nothing else.
//               Both streams weigh alike in the sum (x̃ < 1), so a kernel
//               that dropped either load would fail its check. Over a
//               stream larger than the L2 it is the HBM read ceiling (the
//               TPU probes' "dma").
//   3 x32       (seg_ablate_x2 only) K12 with x gathered from a float32
//               copy: 4 B per gather instead of 8. Equals K12 on the
//               float32-rounded x, widened, bit for bit.
//
// The TPU probes' other variants cut stages that have no Hopper
// counterpart: the MXU prefix (noU), the mid-quad correction (noc2), the
// lane shift and gidx takes (noshift, nogidx), the windowed reduce (noRw),
// the Dekker/TwoSum chains and integer planes (nodekker, noqwin, noqpref),
// the P-packing and panel16's DMA-stream count. K1's row tracking, scan and
// emit, which noseg cuts, are their Hopper counterpart. The per-subtile y
// accumulate (noacc) has no stage to cut either: K1 stores each y entry
// once, with no read-modify-write; the granularity question it asked is
// seg_spmv_tiles_at's (the tile at which partials are folded).
//
// What bounds them: bytes, as K1 (seg_spmv.cu). Every variant stores every
// result it computes, so no load is dead code for the compiler.
//
// Plain C interface for ctypes, as in seg_spmv.cu.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "panel_tile.cuh"
#include "seg_tile.cuh"

namespace {

constexpr int kTileThreads = 256;  // K1's block: must match seg_spmv.cu
constexpr int kTileNnz = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / kWarp;

constexpr int kNogather = 0;
constexpr int kNoseg = 1;
constexpr int kDma = 2;
constexpr int kX32 = 3;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// noseg and dma: each thread sums its 4 nonzeros in order, then an xor
// butterfly per warp and one warp over the 8 warp totals; thread 0 writes
// out[t]. The order is fixed, so two runs give the same bits.
template <typename T, int kMode>
__global__ void __launch_bounds__(kTileThreads)
seg_ablate_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ x, T* __restrict__ out, int nnz) {
  __shared__ T s_sum[kTileWarps];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int ts = t * kTileNnz;
  const int te = min(ts + kTileNnz, nnz);
  const int e0 = ts + threadIdx.x * kTileItems;
  const int e_end = min(e0 + kTileItems, te);

  T s = T(0);
  if (e0 < te) {
    T v[kTileItems];
    int c[kTileItems];
    if (e_end - e0 == kTileItems) {
      load4(vals + e0, v);
      load_cols4(cols + e0, c);
    } else {
#pragma unroll
      for (int k = 0; k < kTileItems; ++k) {
        const bool in = e0 + k < e_end;
        v[k] = in ? __ldg(vals + e0 + k) : T(0);
        c[k] = in ? __ldg(cols + e0 + k) : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      if (e0 + k < e_end) {
        if constexpr (kMode == kNoseg) {
          s += v[k] * __ldg(x + c[k]);
        } else {
          s += v[k] + x_at<kXSynth, T, T>(nullptr, c[k]);
        }
      }
    }
  }
  s = warp_sum(s);
  if (lane == 0) s_sum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kTileWarps ? s_sum[lane] : T(0);
    w = warp_sum(w);
    if (lane == 0) out[t] = w;
  }
}

// seg_spmv_tiles_fold's kernel: K1's block, then K2 in the last block to
// arrive. `arrived` is 0 at launch and 0 again when the grid ends.
__global__ void __launch_bounds__(kTileThreads)
seg_spmv_tiles_fold_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                           const float* __restrict__ vals,
                           const int* __restrict__ tile_row0,
                           const float* __restrict__ x, float* __restrict__ y,
                           float* carry, int nnz, const int* __restrict__ carry_rows,
                           int ncarry, unsigned int* arrived) {
  seg_tiles_block<float, int32_t, kTileThreads, kXGather, float, 1>(
      ptr, cols, vals, tile_row0, x, y, carry, nnz);
  __shared__ bool s_last;
  __threadfence();  // this block's y and carries, visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int j = threadIdx.x; j < ncarry; j += kTileThreads) {
    const int r = __ldg(carry_rows + j);
    const int ta = __ldg(ptr + r) / kTileNnz;
    const int tb = (__ldg(ptr + r + 1) - 1) / kTileNnz;
    float s = __ldcg(carry + 2 * ta + 1);  // from L2: other blocks wrote them
    for (int t = ta + 1; t <= tb; ++t) s += __ldcg(carry + 2 * t);
    y[r] = s;
  }
  if (threadIdx.x == 0) *arrived = 0u;
}

// launch_floor's kernel: one block of one thread, no work.
__global__ void launch_floor_kernel() {}

template <typename T, int kMode>
int launch_ablate_stream(const void* cols, const void* vals, const void* x,
                         void* out, int nnz, int ntiles, void* stream) {
  if (ntiles <= 0 || nnz <= 0 || nnz > INT_MAX - kTileNnz ||
      ntiles != (nnz + kTileNnz - 1) / kTileNnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  seg_ablate_kernel<T, kMode><<<ntiles, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(out), nnz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ablate(const void* ptr, const void* cols, const void* vals,
                  const void* tile_row0, const void* x, void* y, void* carry,
                  void* out, int nnz, int ntiles, int mode, void* stream) {
  switch (mode) {
    case kNogather:
      return launch_seg_tiles<T, int32_t, kTileThreads, kXSynth>(
          ptr, cols, vals, tile_row0, nullptr, y, carry, nnz, ntiles, kTileNnz,
          stream);
    case kNoseg:
      return launch_ablate_stream<T, kNoseg>(cols, vals, x, out, nnz, ntiles, stream);
    case kDma:
      return launch_ablate_stream<T, kDma>(cols, vals, x, out, nnz, ntiles, stream);
    case kX32:
      if constexpr (sizeof(T) == 8) {
        return launch_seg_tiles<T, int32_t, kTileThreads, kXGather, float>(
            ptr, cols, vals, tile_row0, x, y, carry, nnz, ntiles, kTileNnz,
            stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K1 with uint16 columns: the arguments of seg_spmv_tiles, cols 8-byte aligned.
int seg_spmv_tiles_u16(const void* ptr, const void* cols16, const void* vals,
                       const void* tile_row0, const void* x, void* y, void* carry,
                       int nnz, int ntiles, int tile, void* stream) {
  return launch_seg_tiles<float, uint16_t, kTileThreads>(
      ptr, cols16, vals, tile_row0, x, y, carry, nnz, ntiles, tile, stream);
}

// K12 with uint16 columns.
int seg_spmv_tiles_u16_x2(const void* ptr, const void* cols16, const void* vals,
                          const void* tile_row0, const void* x, void* y,
                          void* carry, int nnz, int ntiles, int tile, void* stream) {
  return launch_seg_tiles<double, uint16_t, kTileThreads>(
      ptr, cols16, vals, tile_row0, x, y, carry, nnz, ntiles, tile, stream);
}

// K1 (float32) on a plan of tile 128, 512 or 2048 nonzeros.
int seg_spmv_tiles_at(const void* ptr, const void* cols, const void* vals,
                      const void* tile_row0, const void* x, void* y, void* carry,
                      int nnz, int ntiles, int tile, void* stream) {
  switch (tile) {
    case 128:
      return launch_seg_tiles<float, int32_t, 32>(ptr, cols, vals, tile_row0, x, y,
                                                  carry, nnz, ntiles, tile, stream);
    case 512:
      return launch_seg_tiles<float, int32_t, 128>(ptr, cols, vals, tile_row0, x, y,
                                                   carry, nnz, ntiles, tile, stream);
    case 2048:
      return launch_seg_tiles<float, int32_t, 512>(ptr, cols, vals, tile_row0, x, y,
                                                   carry, nnz, ntiles, tile, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2 (float32) for a plan of tile 128, 512 or 2048 nonzeros, launched as K2
// is: a programmatic dependent of the kernel ahead of it.
int carry_fixup_at(const void* ptr, const void* carry_rows, const void* carry,
                   void* y, int ncarry, int tile, void* stream) {
  switch (tile) {
    case 128:
      return launch_carry_fixup<float, 128>(ptr, carry_rows, carry, y, ncarry, tile, stream);
    case 512:
      return launch_carry_fixup<float, 512>(ptr, carry_rows, carry, y, ncarry, tile, stream);
    case 2048:
      return launch_carry_fixup<float, 2048>(ptr, carry_rows, carry, y, ncarry, tile, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1 (float32) with a stage cut, mode 0-2 (see above). nogather writes y
// and carry and reads no x; noseg and dma read only cols, vals (and x for
// noseg) and write out[ntiles]. Unused pointers may be null.
int seg_ablate(const void* ptr, const void* cols, const void* vals,
               const void* tile_row0, const void* x, void* y, void* carry,
               void* out, int nnz, int ntiles, int mode, void* stream) {
  return launch_ablate<float>(ptr, cols, vals, tile_row0, x, y, carry, out, nnz,
                              ntiles, mode, stream);
}

// K12 (float64) with a stage cut, mode 0-3; for x32, x is float32.
int seg_ablate_x2(const void* ptr, const void* cols, const void* vals,
                  const void* tile_row0, const void* x, void* y, void* carry,
                  void* out, int nnz, int ntiles, int mode, void* stream) {
  return launch_ablate<double>(ptr, cols, vals, tile_row0, x, y, carry, out, nnz,
                               ntiles, mode, stream);
}

// K1 + K2 in one launch (float32, tile 1024): the arguments of
// seg_spmv_tiles, then K2's carry_rows and ncarry, and `arrived`, one
// unsigned int that is 0 and that no other launch uses meanwhile.
int seg_spmv_tiles_fold(const void* ptr, const void* cols, const void* vals,
                        const void* tile_row0, const void* x, void* y, void* carry,
                        const void* carry_rows, void* arrived, int nnz, int ntiles,
                        int ncarry, int tile, void* stream) {
  if (tile != kTileNnz || ntiles <= 0 || nnz <= 0 || nnz > INT_MAX - kTileNnz ||
      ntiles != (nnz + kTileNnz - 1) / kTileNnz || ncarry < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  seg_spmv_tiles_fold_kernel<<<ntiles, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(tile_row0),
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(carry),
      nnz, static_cast<const int*>(carry_rows), ncarry,
      static_cast<unsigned int*>(arrived));
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing, on the stream.
int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// K4 (float32) without the x gather: the arguments of panel_spmv_tiles; x
// is not read and may be null.
int panel_ablate_nogather(const void* slice_ptr, const void* cols, const void* vals,
                          const void* tile_slice0, const void* tile_own0,
                          const void* x, void* y, void* part, int ncolumns,
                          int ntiles, int tile, int nrows, void* stream) {
  return launch_panel_spmv_tiles<float, kXSynth>(slice_ptr, cols, vals, tile_slice0,
                                                 tile_own0, x, y, part, ncolumns,
                                                 ntiles, tile, nrows, stream);
}

// K14 (float64) without the x gather.
int panel_ablate_x2_nogather(const void* slice_ptr, const void* cols, const void* vals,
                             const void* tile_slice0, const void* tile_own0,
                             const void* x, void* y, void* part, int ncolumns,
                             int ntiles, int tile, int nrows, void* stream) {
  return launch_panel_spmv_tiles<double, kXSynth>(slice_ptr, cols, vals, tile_slice0,
                                                  tile_own0, x, y, part, ncolumns,
                                                  ntiles, tile, nrows, stream);
}

}  // extern "C"
