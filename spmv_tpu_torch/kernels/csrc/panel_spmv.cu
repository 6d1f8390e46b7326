// Sliced-ELLPACK (SELL-C) SpMV kernels for Hopper (sm_90a): y = A·x in
// float32, Y = A·X for R = 2..8 right-hand sides, y = A·x in float64 (the
// fp64-grade mode), and the SELL-C-σ epilogue that sums the split slices,
// adds the spill and undoes the row sort.
//
// Five kernels, each replacing one Pallas kernel of the JAX package's
// panel engine (spmv_tpu/kernels/engines.py, engines_x2.py):
//
//   K4 panel_spmv_tiles   replaces _panel_kernel         (panel_spmv_partials)
//   K6 panel_spmv_fused   replaces _panel_kernel_fused   (panel_spmv_fused):
//                         a warp per slice, or K4's tiles with the split
//                         slices finished in the same launch
//   K7 inverse_permute    replaces _perm_kernel          (inverse_permute_blocks),
//                         and _scatter_kernel and _scatter_kernel_multi as
//                         the panel path's epilogue (_window_scatter): every
//                         panel's one epilogue, the split slices' sums, the
//                         spill's add and, on a σ-sorted SELL, the gather
//   K10 panel_spmm_tiles  replaces _panel_kernel_multi   (panel_spmv_multi)
//   K14 panel_spmv_tiles_x2  replaces _panel_kernel_x2   (panel_spmv_x2),
//                         with its epilogue (K7 in double) folded in there
//
// K14 is K4 instantiated for double and K10 is K4 at R right-hand sides
// (panel_tile.cuh), so the tile and slot rules stay in one place, and K7's
// grids share one body and one sum of a split slice (sum_split_row). B11's hi
// and lo f32 planes and its TwoSum chains answer the TPU's missing FMA;
// Hopper has native fp64 FMA, so K14 reads fp64 values and x and sums each
// row in fp64. A slot then streams 12 B and gathers 8 B of x: bytes still
// bound it. The fp64-grade panel's epilogue is K7 built for double.
//
// The plan (spmv_tpu_torch/formats/base.py:build_panel_plan): slices of
// kC = 32 rows. Slice s holds 32·K_s slots from slot slice_ptr[s], stored
// column-major: element j of row r sits at slice_ptr[s] + r % 32 + 32·j.
// Pads are value 0 with column kPadCol (−1), and every kernel here skips
// them: no gather, no add. A slice column is 32 consecutive slots.
//
// What bounds them on the H100: bytes. Each slot streams 8 B (a float32
// value and an int32 column) and gathers 4 B of x, for 2 flops. Lane l of a
// warp owns row l of its slice, so each column step of a warp reads 128
// bytes of values and 128 of columns; the lane sums its row in a register,
// in column order, and stores it once. A pad costs its 8 B of stream and
// nothing else. The TPU layout's stripes, depth-8 x windows, u8
// lo/hi and P-planes answer VMEM and DMA limits that this card does not
// have, so none of them is here.
//
// K4, K10 and K14 (panel_tile.cuh) do not reach that bound by streaming alone: a
// cant-sized panel is ~3,900 tiles, one warp each, ~30 warps per SM in a
// single wave, so the kernel takes about one warp's time, and a warp that
// walks its 32 columns as a chain of dependent loads (the parent's: a line
// of values and columns, then the x gather at those columns, ~64 round
// trips) is latency-bound. Their warp issues the loads of 8 columns of
// values and columns at once, then those columns' x gathers, before it adds
// (4 times per tile), and walks the slices in registers; each tile writes
// every row and partial slot it owns, so the wrapper allocates y and the
// partials without a zero fill. K10 is the same template at R = 2..8: each
// slot's X row (R floats) is gathered in the batch, and each lane carries R
// sums.
//
// No kernel uses float atomics: every row is summed in an order fixed by the
// plan, so two runs give the same bits. K6's tile mode passes its split
// slices' pieces as 64-bit words (a float and its flag), no atomics.
//
// Plain C interface for ctypes, as in seg_spmv.cu: device pointers and the
// stream as void*, launch on that stream, return cudaGetLastError(). The host
// wrapper (spmv_tpu_torch/kernels/panel.py) checks shapes, types and devices,
// allocates every output, and never calls a launcher with an empty grid.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "panel_tile.cuh"

namespace {

// kC, kTileCols, kWarpsPerBlock and kPanelThreads: panel_tile.cuh.
// K7's block size.
constexpr int kThreads = 256;

// K6 — replaces _panel_kernel_fused (spmv_tpu/kernels/engines.py:283).
//
// y = A·x in one launch, in one of two modes the wrapper picks from the
// plan (kernels/panel.py, fused_mode: the widest slice against
// FUSED_SLICE_COLS_MAX).
//
// Slice mode (panel_spmv_fused_kernel), for panels whose slices are all
// narrow: one warp per slice, one lane per row. The lane walks its K_s
// slots in column order, a pad adding nothing (as in K4), and stores
// y[row] once, 0 for an empty row, so y needs no clearing. A warp
// serializes its slice's width: one hub row makes its whole slice as slow
// as itself, and the widest slice sets the time of the launch.
__global__ void __launch_bounds__(kPanelThreads)
panel_spmv_fused_kernel(const int* __restrict__ slice_ptr,
                        const int* __restrict__ cols,
                        const float* __restrict__ vals,
                        const float* __restrict__ x, float* __restrict__ y,
                        int nslices, int nrows) {
  const int lane = threadIdx.x & (kC - 1);
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / kC;
  if (s >= nslices) return;
  const int end = __ldg(slice_ptr + s + 1);
  float acc = 0.f;
#pragma unroll 4
  for (int p = __ldg(slice_ptr + s) + lane; p < end; p += kC) {
    const int c = __ldg(cols + p);
    // a pad reads no x: +0.0 · -0.0 = -0.0, which leaves acc as it is
    acc += __ldg(vals + p) * (c >= 0 ? __ldg(x + c) : -0.f);
  }
  const int row = s * kC + lane;
  if (row < nrows) y[row] = acc;
}

// K4, K10 and K14: panel_spmv_tiles_kernel in panel_tile.cuh.

// K7 — replaces _perm_kernel (spmv_tpu/kernels/engines.py:719), and
// _scatter_kernel (:171) and _scatter_kernel_multi (:537) as the panel
// path's epilogue (_window_scatter) — is every panel's one epilogue after
// its tile kernel: the fix-up of the split slices, the add of the spill
// part's y′ and, on a σ-sorted SELL, the gather back to row order, in one
// launch. Three grids (K7Rows), one body:
//   kSorted (invperm given: the σ-sorted SELL): one thread per output row
//     i < nrows, p = invperm[i], y a tensor of its own;
//   kIdentity (no invperm, a spill given: ELL, HYB and unsorted SELL with a
//     spill part): one thread per row p = i of the panel, y = y′ in place;
//   kSplitRows (no invperm, no spill: the same panels without one): one
//     thread per row of a split slice, nsplit × 32 threads from
//     split_slices, y = y′ in place; the rows of whole slices are not
//     touched, so no copy of y′ is made.
//
// y′ (y_sorted) is the panel's y, (nrows_pad, R) in sorted row space or
// (nrows, R) as built: K4's, K10's or K14's, whose rows of split slices
// hold +0.0, or K6's, whole. For row p (slice s = p / 32, lane p % 32):
//   with partials: slice s is split iff it spans more than one tile
//     (split_tiles); then v is its partials summed by sum_split_row, the
//     tail slot of its first tile, then the head slot of every later tile,
//     in tile order; y′'s row of a split slice is never read;
//   else v = y′[p] (no partials: K6's y′, or a plan with no split slice);
//   with a spill's y′ (the same rows), v = v + spill[p], the single
//     rounding of a torch add y′ += spill;
//   y[i, :] = v (y′[p] in place for the identity), written once.
// So the bits are those of the split slices' sum, the torch add and the
// gather in turn; on a sorted plan with no spill or no split slice the
// kernel is the gather alone. R = 1..8 columns in float32; double (the
// fp64-grade mode, R = 1) reads fp64 y′, partials and spill and adds in
// fp64.
//
// Bytes are few (the rows of y read and written, ~0.25 MB at cant, and
// the split slices' partials) and the work a few adds: what costs is the
// launch, the chain behind the kernel ahead of it, and per row the
// dependent loads (invperm or split_slices, slice_ptr, then y′ or the
// partials). So it is a programmatic dependent launch (launch_programmatic,
// seg_tile.cuh): each thread reads invperm[i] (split_slices[i / 32]) and
// its slice's two slice_ptr entries, plan data that no kernel writes, and
// decides the slice's tile range before griddepcontrol.wait; y′, the
// partials and the spill are read after it, through coherent loads (no
// __restrict__ on them, no __ldg): the kernel ahead writes them while this
// grid may already be resident. That kernel is the tile kernel (K4, K10,
// K14; K6) where there is no spill, else the spill part's last kernel (K2,
// K9 or K13; K3): the wait returns when it has finished, and the tile
// kernel's y′ and partials are complete by then because the spill's first
// kernel (K1, K8, K12; K3) is an ordinary launch, which starts only after
// the tile kernel has finished. A row's R values move as one 16-byte
// (8-byte) access where R allows (x_rows.cuh's load_row with CoherentLoad,
// and store_row). On an H100 (probes.turns, PERF.md §6) a thread per row
// beat a thread per (row, column), the gather's layout, by 6-11% at R =
// 2..8 on pl_big's 524k rows, where the per-column threads repeated each
// row's plan reads and index work R times and lost 1-5% to the three
// launches they replaced; it lost 10% to it at R = 8 on pl-32768, whose 32k
// threads fill fewer blocks than the card has SMs; a thread per 16 bytes
// of a row tied the row layout over all the sorted calls timed. The
// sources of 32 neighbouring rows lie within one σ window (≤ 1024 rows),
// so their slice_ptr entries and partials are L1 and L2 hits; the TPU
// kernel's 8x128 windows and whi/idx tables bound its sublane gather, which
// this card does not have.
enum K7Rows { kSorted, kIdentity, kSplitRows };

// The partial slot of tile t's piece of a split slice whose first tile is
// ta: the tail slot of tile ta, the head slot of every later tile. With the
// tile order, the panel's fix-up order: K7 (sum_split_row) and K6's tile
// mode sum a split slice's pieces over t = ta .. tb in this order.
__device__ __forceinline__ int split_slot(int t, int ta) {
  return t == ta ? 2 * ta + 1 : 2 * t;
}

// The tiles [ta, tb] of slice s where it is split (it spans more than one
// tile: formats/base.py's rule on slice_ptr[s] / 32 and slice_ptr[s+1] /
// 32); else ta and tb are left as they are.
__device__ __forceinline__ void split_tiles(const int* __restrict__ slice_ptr, int s,
                                            int& ta, int& tb) {
  const int cs = __ldg(slice_ptr + s) / kC;
  const int ce = __ldg(slice_ptr + s + 1) / kC;
  if (ce > cs && cs / kTileCols != (ce - 1) / kTileCols) {
    ta = cs / kTileCols;
    tb = (ce - 1) / kTileCols;
  }
}

// Row `lane` of a split slice over tiles [ta, tb] from the tile kernel's
// partials (2·ntiles, 32, R), into v: the tail slot of tile ta, then the
// head slot of every later tile, in tile order. The one place of the
// panel's fix-up order: every K7 grid sums a split slice here.
template <int R, typename T>
__device__ __forceinline__ void sum_split_row(const T* part, int ta, int tb, int lane,
                                              bool vec, T (&v)[R]) {
  load_row<R, CoherentLoad>(part + (static_cast<long long>(split_slot(ta, ta)) * kC + lane) * R,
                            vec, v);
  for (int t = ta + 1; t <= tb; ++t) {
    T w[R];
    load_row<R, CoherentLoad>(part + (static_cast<long long>(split_slot(t, ta)) * kC + lane) * R,
                              vec, w);
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] += w[j];
  }
}

// K6's tile mode (panel_spmv_fused_tiles_kernel), for a panel with a wide
// slice: K4's tiles of kTileCols slice columns, one warp each
// (panel_tile_body), so no warp's work grows with the widest slice. Whole
// slices and the empty slices a tile owns go to y as K4 writes them. A
// split slice's pieces but its last tile's are published as 32 words
// (seg_tile.cuh's store_word: the float and its flag in one 64-bit store,
// no fence) in K4's slot layout (dev.fused_words, (2·ntiles, 32)); the
// slice's last tile tb keeps its own piece in a register, walks on, and at
// the end of its tile waits for the words of tiles ta .. tb - 1
// (kFinishBatch loads at once; in the common case published by then), adds
// them and its piece in K7's order (split_slot), writes the slice's rows
// of y and sets the words back to 0. So y is K4's then K7's identity
// mode's, bit for bit, on every plan, and every launch, and every replay
// of a CUDA graph holding one, finds the words 0, with no memset.
//
// The waits cannot hang: every wait goes to a smaller tile, and a tile
// publishes all its pieces before it waits; the grid is at most the
// resident blocks (panel_spmv_fused_resident) and each warp walks its
// tiles in increasing order, so the smallest unfinished tile never waits
// on an unpublished word (a panel of 4 MB or less has at most 512 tiles:
// one per warp). Two launches on one plan must not overlap (one stream).
//
// What bounds it: K4's bytes without the unused partial slots, 24 B of
// words (published, read, reset) per piece, in the L2; at the sizes it
// runs (at most 512 tiles, one wave) one tile's walk, then for a split
// slice one L2 round trip (kFinishBatch 8 was the fastest of 8, 16 and 32
// on four of the sweep's six skewed panels, within 0.3% on a fifth).
// Measured and dropped on an H100 (PERF.md §6): every piece in K4's
// partial slots, a fence and an integer counter per slice, the last
// arrival summing them (no wait at all): on the sweep's skewed panels it
// took 0.7-1.8 µs more than K4 + K7 in the runs where the published words
// took 0.9-2.4 µs less.
struct FusedPanelOut {
  static constexpr bool kOwnerZeroesSplit = false;  // the finisher writes them
  float* __restrict__ y;
  unsigned long long* words;  // (2·ntiles, 32), 0 at launch and at exit
  const int* __restrict__ slice_ptr;
  int nrows;
  mutable int fin_s = -1;       // the split slice this tile finishes, or -1
  mutable float fin_own = 0.f;  // and this lane's piece of it

  __device__ __forceinline__ void piece(int t, int tail, int lane, const float (&v)[1], int s,
                                        bool last) const {
    if (last) {  // the slice's last tile: keep the piece, finish at the end
      fin_s = s;
      fin_own = v[0];
    } else {
      store_word(words + (2 * t + tail) * kC + lane, kPublished | __float_as_uint(v[0]));
    }
  }

  // After the walk, and so after this tile's own words: slice fin_s from
  // the words of tiles ta .. t - 1, then this tile's piece, the last.
  __device__ __forceinline__ void tile_done(int t, int lane, bool, bool, int, int) const {
    if (fin_s < 0) return;
    const int ta = __ldg(slice_ptr + fin_s) / kC / kTileCols;
    float v = 0.f;
    for (int b = ta; b < t; b += kFinishBatch) {
      unsigned long long w[kFinishBatch];
#pragma unroll
      for (int i = 0; i < kFinishBatch; ++i) {
        w[i] = b + i < t ? load_word(words + split_slot(b + i, ta) * kC + lane) : 0ull;
      }
#pragma unroll
      for (int i = 0; i < kFinishBatch; ++i) {
        if (b + i < t) {
          unsigned long long* p = words + split_slot(b + i, ta) * kC + lane;
          while (w[i] < kPublished) w[i] = load_word(p);
          const float f = __uint_as_float(static_cast<unsigned>(w[i]));
          v = b + i == ta ? f : v + f;
          store_word(p, 0ull);
        }
      }
    }
    const int row = fin_s * kC + lane;
    if (row < nrows) y[row] = v + fin_own;  // tile t's head slot, the last
    fin_s = -1;
  }
};

__global__ void __launch_bounds__(kPanelThreads)
panel_spmv_fused_tiles_kernel(const int* __restrict__ slice_ptr,
                              const int* __restrict__ cols,
                              const float* __restrict__ vals,
                              const int* __restrict__ tile_slice0,
                              const int* __restrict__ tile_own0,
                              const float* __restrict__ x, float* __restrict__ y,
                              unsigned long long* words, int ncolumns, int ntiles,
                              int nrows) {
  const FusedPanelOut out{y, words, slice_ptr, nrows};
  const int stride = static_cast<int>(gridDim.x) * kWarpsPerBlock;
  for (int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kC; t < ntiles; t += stride) {
    panel_tile_body<float, kXGather, 1>(slice_ptr, cols, vals, tile_slice0, tile_own0, x,
                                        out, ncolumns, t, nrows);
  }
}

template <typename T, int R, int kRows>
__global__ void __launch_bounds__(kThreads)
inverse_permute_kernel(const int* __restrict__ invperm,
                       const int* __restrict__ slice_ptr,
                       const int* __restrict__ split_slices, const T* part,
                       const T* y_sorted, const T* spill, T* y, int nthreads,
                       int nrows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nthreads) return;
  int p, row;            // the row of y′ read, the row of y written
  int ta = 0, tb = -1;   // the tiles of a split slice; none
  if constexpr (kRows == kSplitRows) {
    const int s = __ldg(split_slices + i / kC);
    p = row = s * kC + (i & (kC - 1));
    if (row >= nrows) return;  // past the cut last slice
    split_tiles(slice_ptr, s, ta, tb);
  } else {
    row = i;
    p = kRows == kSorted ? __ldg(invperm + row) : row;
    if (part != nullptr) split_tiles(slice_ptr, p / kC, ta, tb);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // every row starts at a multiple of R, so the base pointers decide
  // whether the wide loads and stores are aligned
  constexpr uintptr_t kAlign = sizeof(T) * (R % 4 == 0 ? 4 : R % 2 == 0 ? 2 : 1);
  const bool vec = ((reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(y_sorted) |
                     reinterpret_cast<uintptr_t>(spill) | reinterpret_cast<uintptr_t>(y)) &
                    (kAlign - 1)) == 0;
  const long long at = static_cast<long long>(p) * R;
  T v[R];
  if (kRows == kSplitRows || tb >= 0) {
    sum_split_row<R>(part, ta, tb, p & (kC - 1), vec, v);
  } else {
    load_row<R, CoherentLoad>(y_sorted + at, vec, v);
  }
  if (kRows != kSplitRows && spill != nullptr) {
    T w[R];
    load_row<R, CoherentLoad>(spill + at, vec, w);
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = v[j] + w[j];
  }
  store_row<R>(y + static_cast<long long>(row) * R, v, vec);
}

// Launches one K7 instantiation as a programmatic dependent of the kernel
// ahead of it; part and spill may be null (no partials, no spill). With
// invperm the sorted grid; without it the identity, in place (y must be
// y_sorted): every row where there is a spill, else the nsplit split
// slices' rows (split_slices and part needed). Refuses
// (cudaErrorInvalidValue, nothing launched) an empty or too large grid,
// partials without slice_ptr or for a tile it was not built for, and an
// identity with nothing to do.
template <typename T, int R>
int launch_inverse_permute(const void* invperm, const void* slice_ptr,
                           const void* split_slices, const void* part,
                           const void* y_sorted, const void* spill, void* y, int nrows,
                           int nsplit, int tile, void* stream) {
  if (nrows <= 0 || nrows > INT_MAX - kThreads ||
      (part != nullptr && (slice_ptr == nullptr || tile != kTileCols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = [&](auto kernel, int nthreads) {
    return launch_programmatic(
        kernel, blocks_for(nthreads, kThreads), kThreads, stream,
        static_cast<const int*>(invperm), static_cast<const int*>(slice_ptr),
        static_cast<const int*>(split_slices), static_cast<const T*>(part),
        static_cast<const T*>(y_sorted), static_cast<const T*>(spill), static_cast<T*>(y),
        nthreads, nrows);
  };
  if (invperm != nullptr) return launch(inverse_permute_kernel<T, R, kSorted>, nrows);
  if (y != y_sorted) return static_cast<int>(cudaErrorInvalidValue);
  if (spill != nullptr) return launch(inverse_permute_kernel<T, R, kIdentity>, nrows);
  if (part == nullptr || split_slices == nullptr || nsplit <= 0 ||
      nsplit > (INT_MAX - kThreads) / kC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(inverse_permute_kernel<T, R, kSplitRows>, nsplit * kC);
}

// ---------------------------------------------------------------- R > 1
//
// X is row-major (ncols, R) and Y row-major (nrows, R); K10's partials are
// (2·ntiles, 32, R). Per right-hand side a slot's 8 plan bytes are shared
// by R columns, and each slot gathers one contiguous X row of R floats.

// K10 — replaces _panel_kernel_multi (spmv_tpu/kernels/engines.py:623) —
// is panel_tile.cuh's tile kernel at R = 2..8: K4's tile of kTileCols slice
// columns per warp, its batches (each batch's values and columns, then its
// X-row gathers, before the first add), its walk in registers with R sums
// per lane in K4's order (column j of K10 is K4's on X[:, j], bit for bit),
// and its ownership: every row of Y the tile owns and both partial slots,
// so the wrapper allocates Y and the partials without a zero fill.

}  // namespace

extern "C" {

// K4: y for the rows of every slice the tile owns (a whole slice's sum,
// +0.0 for an empty or split one) and both head/tail partial slots of every
// tile (32 values each; +0.0 where unused): all of y and part.
int panel_spmv_tiles(const void* slice_ptr, const void* cols, const void* vals,
                     const void* tile_slice0, const void* tile_own0, const void* x,
                     void* y, void* part, int ncolumns, int ntiles, int tile,
                     int nrows, void* stream) {
  return launch_panel_spmv_tiles<float>(slice_ptr, cols, vals, tile_slice0, tile_own0,
                                        x, y, part, ncolumns, ntiles, tile, nrows,
                                        stream);
}

// K14: K4 in float64 — fp64 vals, x, y and partials.
int panel_spmv_tiles_x2(const void* slice_ptr, const void* cols, const void* vals,
                        const void* tile_slice0, const void* tile_own0,
                        const void* x, void* y, void* part, int ncolumns,
                        int ntiles, int tile, int nrows, void* stream) {
  return launch_panel_spmv_tiles<double>(slice_ptr, cols, vals, tile_slice0, tile_own0,
                                         x, y, part, ncolumns, ntiles, tile, nrows,
                                         stream);
}

// K4's (fp64: K14's; rhs 2..8: K10's) blocks resident per SM, or -1.
int panel_tiles_occupancy(int fp64, int rhs) {
  if (fp64) return rhs == 1 ? panel_tiles_blocks_per_sm<double>() : -1;
  switch (rhs) {
    case 1: return panel_tiles_blocks_per_sm<float>();
    case 2: return panel_tiles_blocks_per_sm<float, 2>();
    case 3: return panel_tiles_blocks_per_sm<float, 3>();
    case 4: return panel_tiles_blocks_per_sm<float, 4>();
    case 5: return panel_tiles_blocks_per_sm<float, 5>();
    case 6: return panel_tiles_blocks_per_sm<float, 6>();
    case 7: return panel_tiles_blocks_per_sm<float, 7>();
    case 8: return panel_tiles_blocks_per_sm<float, 8>();
    default: return -1;
  }
}

// K6's grid cap in its tile mode on `device`: the tile kernel's resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the
// SMs, or -1 on an error. Asked once per device.
int panel_spmv_fused_resident(int device) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};  // 0: not asked yet
  if (device >= 0 && device < kDevices && known[device] > 0) return known[device];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_spmv_fused_tiles_kernel,
                                                    kPanelThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      per_sm <= 0) {
    return -1;
  }
  if (device >= 0 && device < kDevices) known[device] = per_sm * sms;
  return per_sm * sms;
}

// K6: y = A·x in one launch. mode 0, the slice mode: one warp per slice
// (tile_slice0, tile_own0 and words unread); mode 1, the tile mode: K4's
// tiles, words holding 2·ntiles·32 64-bit words, all 0 (the kernel leaves
// them so). Refuses (cudaErrorInvalidValue, nothing launched) a tile it was
// not built for, a schedule that does not cover the columns, or another
// mode.
int panel_spmv_fused(const void* slice_ptr, const void* cols, const void* vals,
                     const void* tile_slice0, const void* tile_own0, const void* x,
                     void* y, void* words, int nslices, int ncolumns, int ntiles, int tile,
                     int nrows, int mode, void* stream) {
  if (nslices <= 0 || nrows <= 0 || nslices != blocks_for(nrows, kC) || ncolumns <= 0 ||
      tile != kTileCols || ntiles != blocks_for(ncolumns, kTileCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto sp = static_cast<const int*>(slice_ptr);
  const auto c = static_cast<const int*>(cols);
  const auto v = static_cast<const float*>(vals);
  const auto xx = static_cast<const float*>(x);
  const auto yy = static_cast<float*>(y);
  if (mode == 0) {
    panel_spmv_fused_kernel<<<blocks_for(nslices, kWarpsPerBlock), kPanelThreads, 0, s>>>(
        sp, c, v, xx, yy, nslices, nrows);
  } else if (mode == 1) {
    int device = 0;
    const cudaError_t rc = cudaGetDevice(&device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const int resident = panel_spmv_fused_resident(device);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);
    panel_spmv_fused_tiles_kernel<<<std::min(blocks_for(ntiles, kWarpsPerBlock), resident),
                                    kPanelThreads, 0, s>>>(
        sp, c, v, static_cast<const int*>(tile_slice0), static_cast<const int*>(tile_own0),
        xx, yy, static_cast<unsigned long long*>(words), ncolumns, ntiles, nrows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: every panel's epilogue, on rows of rhs = 1..8 floats. With invperm
// (the σ-sorted SELL), y[i, :] for i < nrows from sorted position
// invperm[i]; without it (ELL, HYB, unsorted SELL), y′ updated in place (y
// is y_sorted): every row where spill is given, else only the rows of the
// nsplit split slices listed in split_slices. A row is its split slice's
// partials summed in tile order where part is given (else y′'s row), plus
// the spill's row where spill is given. A programmatic dependent launch.
int inverse_permute(const void* invperm, const void* slice_ptr, const void* split_slices,
                    const void* part, const void* y_sorted, const void* spill, void* y,
                    int nrows, int nsplit, int tile, int rhs, void* stream) {
  switch (rhs) {
#define K7_CASE(R)                                                                   \
  case R:                                                                            \
    return launch_inverse_permute<float, R>(invperm, slice_ptr, split_slices, part,  \
                                            y_sorted, spill, y, nrows, nsplit, tile, \
                                            stream);
    K7_CASE(1) K7_CASE(2) K7_CASE(3) K7_CASE(4) K7_CASE(5) K7_CASE(6) K7_CASE(7)
    K7_CASE(8)
#undef K7_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7 in float64 (R = 1): the fp64-grade panel's epilogue, its sums and add
// in fp64.
int inverse_permute_x2(const void* invperm, const void* slice_ptr, const void* split_slices,
                       const void* part, const void* y_sorted, const void* spill, void* y,
                       int nrows, int nsplit, int tile, void* stream) {
  return launch_inverse_permute<double, 1>(invperm, slice_ptr, split_slices, part,
                                           y_sorted, spill, y, nrows, nsplit, tile, stream);
}

// K10: K4 at R = 2..8 right-hand sides: Y (nrows, R) for the rows of every
// slice the tile owns and both head/tail partial slots of every tile (32
// rows of R each; +0.0 where unused): all of Y and part.
int panel_spmm_tiles(const void* slice_ptr, const void* cols, const void* vals,
                     const void* tile_slice0, const void* tile_own0, const void* X,
                     void* Y, void* part, int ncolumns, int ntiles, int tile,
                     int nrows, int rhs, void* stream) {
  switch (rhs) {
#define K10_CASE(R)                                                                  \
  case R:                                                                            \
    return launch_panel_spmv_tiles<float, kXGather, R>(slice_ptr, cols, vals,        \
                                                       tile_slice0, tile_own0, X, Y, \
                                                       part, ncolumns, ntiles, tile, \
                                                       nrows, stream);
    K10_CASE(2) K10_CASE(3) K10_CASE(4) K10_CASE(5) K10_CASE(6) K10_CASE(7) K10_CASE(8)
#undef K10_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
