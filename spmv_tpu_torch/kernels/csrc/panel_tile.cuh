// The panel tile kernel and its launcher, shared by panel_spmv.cu (K4, K10,
// K14) and probe_spmv.cu (the probe's instantiations with a synthesized x).
//
// panel_spmv_tiles_kernel<T, kX, R> is K4's kernel, and panel_tile_body
// its body on tile t, writing through an output policy (PartOut: K4's y
// and partial slots; panel_spmv.cu's FusedPanelOut: K6's tile mode, which
// also finishes the split slices in the same launch):
//
//   T    value, x and y type: float (K4, K10) or double (K14)
//   kX   how x(c) is read: gathered from x (kXGather, production) or
//        synthesized from the column in registers, x(c) = (c & 1023)·2⁻¹⁰
//        (kXSynth, the probe without the gather; it still copies every
//        column), as seg_tile.cuh's tile kernel does
//   R    right-hand sides: 1 (a vector x and y: K4, K14, the probes) or
//        2..8 (K10: row-major X (ncols, R), Y (nrows, R), partials
//        (2·ntiles, 32, R); float and gathered only). Each lane carries R
//        sums; the loads, the walk and the ownership are K4's.
//
// Every instantiation sums each row in the same order, so the probe gives
// K4's bits on the same x, and column j of K10 gives K4's bits on X[:, j].
// A pad slot (column kPadCol) gathers no x and adds nothing, in every
// instantiation. The host wrapper checks shapes, types and devices,
// allocates every output with torch.empty (the kernel writes all of it)
// and never launches an empty grid.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

// kWarp, kFullMask, the x modes, x_row_at, x_rows_aligned, row_of (and
// x_rows.cuh's store_row)
#include "seg_tile.cuh"

namespace {

constexpr int kC = 32;  // rows per slice: one warp. Must equal SLICE_ROWS.
// The column of a pad slot. Must equal PAD_COL in
// spmv_tpu_torch/formats/base.py. Any negative column is skipped as a pad.
constexpr int kPadCol = -1;
// Slice columns per K4 tile. Must equal TILE_COLS in
// spmv_tpu_torch/formats/base.py.
constexpr int kTileCols = 32;
// K4's columns per batch: each lane issues a batch's loads of values and
// columns, then its x gathers, before the batch's first add. 8 was the
// fastest of 2, 4, 8, 16 and 32, or within 1% of it, on every panel timed:
// larger batches hold more live registers and fewer warps, smaller ones
// fewer loads per warp.
constexpr int kBatch = 8;
// K10's at R right-hand sides, where a batch holds kB·R gathered floats
// per lane: 8 up to R = 4, 4 above. On an H100 (probes.turns, PERF.md)
// batches of 8 beat 4 by 5-23% at R = 2 and by 4-5% at R = 4 on cant and
// pl-32768 (2.8% slower on pl_big's panel); at R = 8 they took 96
// registers with a spill and were 20% slower at cant.
template <int R>
__host__ __device__ constexpr int batch_cols() {
  return R <= 4 ? kBatch : 4;
}
// K4, K6 and K10: 4 warps per block, each warp on its own tile or slice.
constexpr int kWarpsPerBlock = 4;
constexpr int kPanelThreads = kWarpsPerBlock * kC;
static_assert(kC == kWarp, "a slice is one warp, a lane per row");

int blocks_for(int items, int per_block) {
  return (items + per_block - 1) / per_block;
}

// run + v·x rounded once: what the contracted `run += v * x` computes.
__device__ __forceinline__ float fma_rn(float v, float x, float run) {
  return __fmaf_rn(v, x, run);
}
__device__ __forceinline__ double fma_rn(double v, double x, double run) {
  return __fma_rn(v, x, run);
}

// K4 — replaces _panel_kernel (spmv_tpu/kernels/engines.py:269); K14 (T =
// double) replaces _panel_kernel_x2 (spmv_tpu/kernels/engines_x2.py:205);
// K10 (R = 2..8) replaces _panel_kernel_multi (engines.py:623).
//
// One warp per tile of kTileCols consecutive slice columns (the slots
// [g0·32, g1·32), contiguous), so every warp does the same work whatever the
// slice widths: a wide slice is cut into many tiles, and a tile may hold
// many narrow slices. Lane l owns row l of every slice the tile touches.
//
// What bounds it: bytes. Each slot streams 8 B (12 in fp64) and gathers 4 B
// (8) of x, for 2 flops; a pad slot streams its 8 B and gathers nothing; at
// R right-hand sides (K10) the 8 plan bytes serve R columns and the gather
// is one row of X, R·4 B. But a cant-sized panel has ~3,900 tiles: one
// warp each is ~30 warps per SM, a single wave at
// under half occupancy, so the kernel takes about one warp's time. The
// parent's warp walked its 32 columns as a chain: each step loaded a line
// of values and of columns, then gathered x at those columns, behind a
// branch with stores and a slice_ptr load the compiler did not hoist loads
// across: ~64 dependent memory round trips per warp, 17 µs (fp64: 31 µs) at
// cant against a byte bound of 10 (15). The design cuts the chain to a few
// round trips:
//   1. the warp writes +0.0 to the rows of the empty slices it owns
//      (tile_own0, below), 32 slices to a ballot;
//   2. in batches of batch_cols<R>() columns, each lane issues the batch's
//      loads of values and columns, then every x gather (X-row gather) of
//      the batch but a pad's, before the batch's first add, into registers;
//   3. the walk runs in registers: run[j] = fma(v, x[j], run[j]) in column
//      order, a pad skipped (the parent's contracted `run += v * x`, so the
//      bits are the parent's, and column j of K10 is K4's on X[:, j]),
//      stepping to the next slice, past empty ones, with one slice_ptr load
//      each (an L1 or L2 hit; a tile steps about 0.5 slices at cant, 1-2 on
//      power-law panels).
// A pad reads no x and adds nothing: a gathered 0·x would not do, since
// 0·NaN would put a NaN in every row with a pad, and -0.0 + 0·x is +0.0,
// which a row summed without its pads (the CSR kernels') keeps as -0.0.
// The walk tests each column for a pad, so the batch's columns stay live
// through it: K4 takes 56 registers (the parent 40) and runs 0.94-0.98 of
// the parent's time at cant and pl-32768 on an H100; the forms that kept 40
// registers (a mask of the batch's pads; a pad's x set to -0.0, whose
// product -0.0 leaves every sum as it is) were 17-22% slower there
// (probes.turns; PERF.md §6). K14 is held to 64 registers
// (panel_spmv_tiles_kernel_x2), as in the parent: at 72 it fits 7 blocks
// per SM, and cant's 984 blocks no longer fit one wave.
// ptxas (sm_90a): K4 56 registers, K14 64, K10 56 / 64 / 64 at R = 2 / 4
// / 8, no shared memory; 9, 8 and 9 / 8 / 8 blocks of 4 warps resident per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, panel_tiles_occupancy).
// On an H100 it runs at the byte bound at cant in float32 (the plan in the
// L2) and at 0.41-0.79 of the parent's time on every panel timed (python -m
// spmv_tpu_torch.probes.turns; PERF.md has the runs); K10 at 0.36-0.38 of
// the chain it replaced at cant for R = 2 and 4, 0.68 at R = 8. Measured and
// dropped: two bulk async copies (TMA, 1-D) of the tile into shared memory
// on one mbarrier, then all 32 gathers, 2-44% slower than batches of 16
// (its one wait holds every gather behind the whole tile; 32-48 KB of
// shared memory per block leaves 6 or 4 blocks per SM); a window of 32
// slice ends read ahead of the walk and stepped on a ballot, 0-12% slower
// than the slice_ptr load per step.
// Ownership, so that y and part need no zero fill (formats/base.py): the
// tile writes y for every slice it owns (tile_own0[t] .. tile_own0[t+1] -
// 1, the slices whose first column lies in it, and for the last tile the
// empty slices after the final column): the sum of a slice wholly inside
// it, +0.0 for an empty slice or one that runs on into later tiles (K7
// sums those rows from the partials and never reads them). It writes both its partial slots: the head (the
// slice began in an earlier tile), the tail (it runs on), +0.0 if unused.
// At R > 1 a row of y and a lane's row of a slot are R floats (Y (nrows,
// R), part (2·ntiles, 32, R)).
//
// The policy `out` takes the tile's sums: out.y the rows of whole and empty
// slices; out.piece(t, tail, lane, v, s, last) split slice s's partial, for
// the head (tail 0) or tail (1) slot of tile t, `last` where s ends in this
// tile; kOwnerZeroesSplit says whether the owning tile also writes +0.0 to
// a split slice's rows of y; out.tile_done(t, lane, wrote_head, wrote_tail,
// head_s, tail_s) runs after the walk, with the slices whose pieces the
// tile wrote.
template <typename T, int R>
struct PartOut {  // K4, K10, K14 and the probes
  static constexpr bool kOwnerZeroesSplit = true;
  T* __restrict__ y;
  T* __restrict__ part;
  __device__ __forceinline__ void piece(int t, int tail, int lane, const T (&v)[R], int,
                                        bool) const {
    store_row<R>(row_of<R>(part, (2 * t + tail) * kC + lane), v);
  }
  // +0.0 in the slots no split slice used
  __device__ __forceinline__ void tile_done(int t, int lane, bool wrote_head, bool wrote_tail,
                                            int, int) const {
    T zero[R];
#pragma unroll
    for (int j = 0; j < R; ++j) zero[j] = T(0);
    if (!wrote_head) store_row<R>(row_of<R>(part, (2 * t) * kC + lane), zero);
    if (!wrote_tail) store_row<R>(row_of<R>(part, (2 * t + 1) * kC + lane), zero);
  }
};

template <typename T, int kX, int R, typename Out>
__device__ __forceinline__ void panel_tile_body(const int* __restrict__ slice_ptr,
                                                const int* __restrict__ cols,
                                                const T* __restrict__ vals,
                                                const int* __restrict__ tile_slice0,
                                                const int* __restrict__ tile_own0,
                                                const T* __restrict__ x, const Out& out,
                                                int ncolumns, int t, int nrows) {
  constexpr int kB = batch_cols<R>();
  static_assert(kTileCols % kB == 0, "a tile is whole batches");
  static_assert(R == 1 || (std::is_same_v<T, float> && kX == kXGather),
                "R > 1 gathers rows of a float X");
  const int lane = threadIdx.x & (kC - 1);
  T* __restrict__ y = out.y;
  const int g0 = t * kTileCols;
  const int ncol = min(kTileCols, ncolumns - g0);
  const int g1 = g0 + ncol;
  T zero[R];
#pragma unroll
  for (int j = 0; j < R; ++j) zero[j] = T(0);

  // 1. +0.0 for the rows of the empty slices this tile owns
  const int own1 = __ldg(tile_own0 + t + 1);
  for (int base = __ldg(tile_own0 + t); base < own1; base += kC) {
    const int s = base + lane;
    const bool empty = s < own1 && __ldg(slice_ptr + s) == __ldg(slice_ptr + s + 1);
    for (unsigned m = __ballot_sync(kFullMask, empty); m; m &= m - 1) {
      const int row = (base + __ffs(m) - 1) * kC + lane;
      if (row < nrows) store_row<R>(row_of<R>(y, row), zero);
    }
  }

  // 2-3. the batches and the walk, in column order
  int s = __ldg(tile_slice0 + t);
  int ce = __ldg(slice_ptr + s + 1) / kC;  // end column of slice s
  bool head = __ldg(slice_ptr + s) / kC < g0;
  bool wrote_head = false, wrote_tail = false;
  int head_s = s, tail_s = s;  // the slices of the pieces written
  const bool vec = x_rows_aligned<R>(x);
  T run[R];
#pragma unroll
  for (int j = 0; j < R; ++j) run[j] = T(0);
  // Stores the tile's sums of slice s for this lane (branches warp-uniform).
  auto emit = [&]() {
    if (head) {
      out.piece(t, 0, lane, run, s, ce <= g1);
      wrote_head = true;
      head_s = s;
      return;
    }
    T v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = run[j];
    if (ce > g1) {  // runs on into later tiles: K7 writes its rows
      out.piece(t, 1, lane, run, s, false);
      wrote_tail = true;
      tail_s = s;
      if constexpr (!Out::kOwnerZeroesSplit) return;
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = T(0);
    }
    const int row = s * kC + lane;
    if (row < nrows) store_row<R>(row_of<R>(y, row), v);
  };
#pragma unroll
  for (int b = 0; b < kTileCols; b += kB) {
    T vv[kB], xv[kB][R];
    int cc[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const bool in = b + i < ncol;
      const int p = (g0 + b + i) * kC + lane;
      cc[i] = in ? __ldg(cols + p) : kPadCol;
      vv[i] = in ? __ldg(vals + p) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (cc[i] >= 0) {  // in the tile and not a pad
        x_row_at<kX, R>(x, cc[i], vec, xv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) xv[i][j] = T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (b + i < ncol) {
        const int g = g0 + b + i;
        if (g >= ce) {  // slice s ended at column g - 1
          emit();
          head = false;
          do {  // step to the slice holding column g, past any empty slices
            ++s;
            ce = __ldg(slice_ptr + s + 1) / kC;
          } while (g >= ce);
#pragma unroll
          for (int j = 0; j < R; ++j) run[j] = T(0);
        }
        if (cc[i] >= 0) {  // a pad adds nothing
#pragma unroll
          for (int j = 0; j < R; ++j) run[j] = fma_rn(vv[i], xv[i][j], run[j]);
        }
      }
    }
  }
  // Release the programmatic dependent launched after this kernel (K7,
  // every panel's epilogue, where the panel has no spill part) once every
  // warp has walked its tile: its grid may then start while this kernel's
  // last stores drain, and does its plan reads before it waits for this
  // kernel to finish. On an H100 this placement made the sorted SELL calls
  // 0.3-1.3 µs faster than no trigger; one at the kernel's top or after the
  // first batch tied it over all the calls timed and was 1.3-1.6 µs slower
  // at cant with R = 4 (probes.turns, with K7's earlier thread per column;
  // PERF.md §6). It does nothing when the next launch is an ordinary one
  // (the spill part's first kernel, K1, K8, K12 or K3).
  asm volatile("griddepcontrol.launch_dependents;");
  emit();
  out.tile_done(t, lane, wrote_head, wrote_tail, head_s, tail_s);
}

template <typename T, int kX = kXGather, int R = 1>
__global__ void __launch_bounds__(kPanelThreads)
panel_spmv_tiles_kernel(const int* __restrict__ slice_ptr,
                        const int* __restrict__ cols,
                        const T* __restrict__ vals,
                        const int* __restrict__ tile_slice0,
                        const int* __restrict__ tile_own0,
                        const T* __restrict__ x, T* __restrict__ y,
                        T* __restrict__ part, int ncolumns, int ntiles,
                        int nrows) {
  const int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kC;
  if (t >= ntiles) return;
  panel_tile_body<T, kX, R>(slice_ptr, cols, vals, tile_slice0, tile_own0, x,
                            PartOut<T, R>{y, part}, ncolumns, t, nrows);
}

// K14 (T = double, and its probe): the same, held to 8 blocks per SM (64
// registers), as the parent's K14 ran.
template <int kX>
__global__ void __launch_bounds__(kPanelThreads, 8)
panel_spmv_tiles_kernel_x2(const int* __restrict__ slice_ptr,
                           const int* __restrict__ cols,
                           const double* __restrict__ vals,
                           const int* __restrict__ tile_slice0,
                           const int* __restrict__ tile_own0,
                           const double* __restrict__ x, double* __restrict__ y,
                           double* __restrict__ part, int ncolumns, int ntiles,
                           int nrows) {
  const int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kC;
  if (t >= ntiles) return;
  panel_tile_body<double, kX, 1>(slice_ptr, cols, vals, tile_slice0, tile_own0, x,
                                 PartOut<double, 1>{y, part}, ncolumns, t, nrows);
}

// The kernel of an instantiation: K4, K10 and the float probe; K14 and
// its probe.
template <typename T, int kX, int R>
constexpr auto tiles_kernel() {
  if constexpr (std::is_same_v<T, double>) {
    return panel_spmv_tiles_kernel_x2<kX>;
  } else {
    return panel_spmv_tiles_kernel<T, kX, R>;
  }
}

// Launches one instantiation on the plan's schedule; refuses
// (cudaErrorInvalidValue, nothing launched) a tile it was not built for or a
// schedule that does not cover the columns.
template <typename T, int kX = kXGather, int R = 1>
int launch_panel_spmv_tiles(const void* slice_ptr, const void* cols,
                            const void* vals, const void* tile_slice0,
                            const void* tile_own0, const void* x, void* y,
                            void* part, int ncolumns, int ntiles, int tile,
                            int nrows, void* stream) {
  if (tile != kTileCols || ncolumns <= 0 || nrows <= 0 ||
      ntiles != blocks_for(ncolumns, kTileCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tiles_kernel<T, kX, R>()<<<blocks_for(ntiles, kWarpsPerBlock), kPanelThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slice_ptr), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const int*>(tile_slice0),
      static_cast<const int*>(tile_own0), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<T*>(part), ncolumns, ntiles, nrows);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a production instantiation (K4, K14, K10 at R) resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: its registers decide), or
// -1 on an error.
template <typename T, int R = 1>
int panel_tiles_blocks_per_sm() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tiles_kernel<T, kXGather, R>(), kPanelThreads, 0) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // namespace
