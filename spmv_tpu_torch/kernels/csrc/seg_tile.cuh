// The segmented tile kernel and its fix-up, shared by seg_spmv.cu (K1, K2,
// K8, K9, K12, K13), seg_hot.cu (K1's hot-head kernel) and probe_spmv.cu
// (the probes' instantiations of the same code: 16-bit columns, other tile
// sizes, a synthesized or float32 x).
//
// seg_tiles_block<T, ColT, kBlockThreads, kX, XT, R> is the body of K1's
// kernel (seg_spmv_tiles_kernel, R = 1) and of K8's (seg_spmm_tiles_kernel,
// R = 2..8); K3 (seg_spmv.cu) runs the same body, seg_tile_body, with
// outputs of its own:
//
//   T             value, x and y type: float (K1) or double (K12)
//   ColT          column type: int32_t (the plan's) or uint16_t (4 columns
//                 in one 8-byte load; the probe of bytes per nonzero)
//   kBlockThreads threads per block, 4 nonzeros each: 256 is the
//                 production tile of 1024 nonzeros; 32, 128 and 512 give
//                 tiles of 128, 512 and 2048. At 32 the block is one warp:
//                 its row-offset stage needs only a warp barrier, and the
//                 warp-totals stage of the scan is not compiled.
//   kX, XT        how x(c) is read: gathered from an XT array (XT = T in
//                 production, float under double values for the probe of
//                 the 8-byte gather), synthesized from the column in
//                 registers, x(c) = (c & 1023)·2⁻¹⁰ (the probe without the
//                 gather; it still loads every column), or for the labels
//                 of x's head that the block staged in shared memory read
//                 there (a HotHead, seg_tile_body's last argument: K1's
//                 hot-head kernel, seg_hot.cu; float only).
//   R             right-hand sides: 1 (a vector x and y: K1, K12, the
//                 probes) or 2..8 (K8: row-major X (ncols, R), Y (nrows,
//                 R) and carries (2·ntiles, R); float, gathered, int32
//                 columns only). Every value the thread carries is R wide;
//                 the row tracking is shared by the R columns.
//   kGroups       tile groups per block (a parameter of seg_tile_body, 1
//                 but in the hot-head kernel): a block of kGroups ·
//                 kBlockThreads threads runs kGroups tiles at once, each
//                 group on its own named barrier and its own copy of the
//                 block's shared arrays.
//
// Every instantiation sums each row in the same order as K1, so a probe
// variant gives K1's bits on the same x, and column j of K8 gives K1's
// bits on X[:, j]. The host wrapper checks shapes, types, alignment and
// devices, allocates every output and never launches an empty grid.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "x_rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Consecutive nonzeros per thread of a tile kernel.
constexpr int kTileItems = 4;
// K2's, K9's and K13's block size.
constexpr int kFixupThreads = 256;

// How a tile kernel gets x(c).
constexpr int kXGather = 0;  // x[c], read from the XT array
constexpr int kXSynth = 1;   // (c & 1023)·2⁻¹⁰, no x read at all
constexpr int kXHot = 2;     // c < the head's kCols: the staged head; else x[c]

// The head of a float x that a kernel staged in its shared memory, for
// kXHot: x[0, min(kCols, nx)) at `x`. Every column c of the plan is below
// nx, so c < kCols reads a staged entry. The other modes take NoHead.
template <int kCols>
struct HotHead {
  static constexpr int kLabels = kCols;
  const float* x;
};
struct NoHead {};

// A thread's index in its tile group (unsigned, as threadIdx.x is), the
// group's index in the block, and the group's barrier: the block's own
// (barrier 0) for one group, else named barrier 1 + group over the group's
// kBlockThreads threads.
template <int kBlockThreads, int kGroups>
__device__ __forceinline__ unsigned group_tid() {
  if constexpr (kGroups == 1) {
    return threadIdx.x;
  } else {
    return threadIdx.x % kBlockThreads;
  }
}
template <int kBlockThreads, int kGroups>
__device__ __forceinline__ int group_of() {
  if constexpr (kGroups == 1) {
    return 0;
  } else {
    return static_cast<int>(threadIdx.x) / kBlockThreads;
  }
}
template <int kBlockThreads, int kGroups>
__device__ __forceinline__ void group_sync() {
  if constexpr (kGroups == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group_of<kBlockThreads, kGroups>()),
                 "r"(kBlockThreads) : "memory");
  }
}

// Inclusive segmented scan across a warp, driven by head flags. Keys (rows)
// are nondecreasing along the lanes, and lanes with no nonzeros (key -1)
// come last, so "the lane d back holds my key" is the same as "no run
// starts in the d lanes up to mine": one ballot of the run starts gives
// every lane the distance back to its run's first lane, and each level
// shuffles only the R values (one shuffle of a float, two of a double,
// where the scan that compared keys shuffled the key beside them at every
// level). A lane adds its neighbour's running sums at the same levels and
// in the same order as that scan did, so the bits are the same, and
// column j of R values sums as one value would. `prev_key` is the key of
// the lane before (any value on lane 0). kLanes: the lanes whose sums are
// wanted; levels past them are not run.
template <typename T, int R, int kLanes = kWarp>
__device__ __forceinline__ void warp_seg_scan(int key, int prev_key, T (&val)[R]) {
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned starts = __ballot_sync(kFullMask, lane == 0 || prev_key != key);
  // lanes back to the start of my run: lane 0 always starts one
  const int reach =
      lane - (31 - __clz(static_cast<int>(starts & (kFullMask >> (31 - lane)))));
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T v = __shfl_up_sync(kFullMask, val[j], d);
      if (d <= reach) val[j] = v + val[j];
    }
  }
}

// 4 consecutive values from a 16-byte-aligned address: one 16-byte load of
// floats, two of doubles.
__device__ __forceinline__ void load4(const float* __restrict__ p, float (&v)[4]) {
  const float4 v4 = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
}
__device__ __forceinline__ void load4(const double* __restrict__ p, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// 4 consecutive columns: one 16-byte load of int32 (16-byte aligned), one
// 8-byte load of uint16 (8-byte aligned; little-endian halves).
__device__ __forceinline__ void load_cols4(const int* __restrict__ p, int (&c)[4]) {
  const int4 c4 = __ldg(reinterpret_cast<const int4*>(p));
  c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
}
__device__ __forceinline__ void load_cols4(const uint16_t* __restrict__ p, int (&c)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  c[0] = static_cast<int>(u.x & 0xffffu);
  c[1] = static_cast<int>(u.x >> 16);
  c[2] = static_cast<int>(u.y & 0xffffu);
  c[3] = static_cast<int>(u.y >> 16);
}

// x(c) as the tile kernel multiplies it.
template <int kX, typename T, typename XT, typename Head = NoHead>
__device__ __forceinline__ T x_at(const XT* __restrict__ x, int c, Head head = {}) {
  if constexpr (kX == kXSynth) {
    return static_cast<T>(c & 1023) * static_cast<T>(0.0009765625);
  } else if constexpr (kX == kXHot) {
    static_assert(std::is_same_v<T, float> && std::is_same_v<XT, float>,
                  "the hot head is float x");
    return c < Head::kLabels ? head.x[c] : __ldg(x + c);
  } else {
    return static_cast<T>(__ldg(x + c));
  }
}

// What a tile kernel multiplies column c's products by: x(c) for R = 1,
// X's row c for R > 1 (load_x_row: float X, wide loads where `vec`).
template <int kX, int R, typename T, typename XT, typename Head = NoHead>
__device__ __forceinline__ void x_row_at(const XT* __restrict__ x, int c, bool vec,
                                         T (&xr)[R], Head head = {}) {
  if constexpr (R == 1) {
    xr[0] = x_at<kX, T>(x, c, head);
  } else {
    load_x_row<R>(x, c, vec, xr);
  }
}

// Whether a tile kernel may load X's rows with wide loads: R > 1 and X
// 16-byte aligned (the same for the whole launch, so the branch is
// uniform).
template <int R, typename XT>
__device__ __forceinline__ bool x_rows_aligned(const XT* x) {
  return R > 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Row r of a row-major (n, R) array: r itself for R = 1, so that the
// vector kernels index as they always did.
template <int R, typename T>
__device__ __forceinline__ T* row_of(T* p, int r) {
  if constexpr (R == 1) {
    return p + r;
  } else {
    return p + static_cast<long long>(r) * R;
  }
}

// A tile's row offsets ptr[r] for r in [tile_row0[t], tile_row0[t + 1] + 1],
// where the thread of a tile kernel finds, walks and closes its rows.
// StagedOffsets reads the copy the block staged in shared memory;
// GlobalOffsets reads ptr in global memory, for a tile whose span is over
// the stage's cap.
struct StagedOffsets {
  const int* s;  // shared memory: s[i] = ptr[r0 + i]
  int r0;
  __device__ __forceinline__ int operator()(int r) const { return s[r - r0]; }
};
struct GlobalOffsets {
  const int* __restrict__ ptr;
  __device__ __forceinline__ int operator()(int r) const { return __ldg(ptr + r); }
};

// Writes the tile's totals for row r (R columns): straight to y when the
// whole row lies in this tile [ts, te), else to the tile's head slot (the
// row began in an earlier tile) or tail slot (the row runs on into later
// tiles).
template <typename T, int R, typename Offsets>
__device__ __forceinline__ void emit_row(Offsets off, int r, const T (&v)[R], int t,
                                         int ts, int te, T* __restrict__ y,
                                         T* __restrict__ carry) {
  if (off(r) < ts) {
    store_row<R>(row_of<R>(carry, 2 * t), v);
  } else if (off(r + 1) > te) {
    store_row<R>(row_of<R>(carry, 2 * t + 1), v);
  } else {
    store_row<R>(row_of<R>(y, r), v);
  }
}

// Where a tile block's row sums go. `y` takes every row that begins and
// ends inside one thread; emit(off, r, v, t, ts, te) takes each other row
// the tile closes, from the thread where its run ends; tile_done(off, r0,
// r1, t) runs in every thread after the emits. CarryOut is K1's, K8's and
// K12's (and the probes'): emit_row, nothing after. K3 has its own
// (seg_spmv.cu, FusedOut).
template <typename T, int R>
struct CarryOut {
  T* __restrict__ y;
  T* __restrict__ carry;
  template <typename Offsets>
  __device__ __forceinline__ void emit(Offsets off, int r, const T (&v)[R], int t, int ts,
                                       int te) const {
    emit_row<T, R>(off, r, v, t, ts, te, y, carry);
  }
  template <typename Offsets>
  __device__ __forceinline__ void tile_done(Offsets, int, int, int) const {}
};

// Everything of a tile kernel after the loads: the row search, the runs,
// the block-wide scan and the emit, on the tile's row offsets `off`. `v`
// holds this thread's values; xrow(k, xr) gives x(c) of its k-th nonzero
// (X's row for R > 1) as the runs reach it; `out` takes the sums.
template <typename T, int kBlockThreads, int R, typename Offsets, typename XRow,
          typename Out, int kGroups = 1>
__device__ __forceinline__ void tile_rows(Offsets off, int lo, int hi, int t,
                                          int ts, int te, int e0, int e_end,
                                          const T (&v)[kTileItems], XRow xrow,
                                          const Out& out) {
  T* __restrict__ y = out.y;
  const int r0 = lo, r1 = hi;  // the tile's rows; the search moves lo and hi
  constexpr int kWarps = kBlockThreads / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);

  int key = -1;          // row of this thread's last run; -1 = no nonzeros
  T run[R];              // that run's partial sums
  int head_row = -1;     // row of the first run, if it closed in this thread
  T head_val[R];         // and its partial sums
  int row_end = 0;       // ptr[key + 1]
#pragma unroll
  for (int j = 0; j < R; ++j) {
    run[j] = T(0);
    head_val[j] = T(0);
  }

  if (e0 < te) {
    while (lo < hi) {  // largest r in [lo, hi] with ptr[r] <= e0
      const int mid = (lo + hi + 1) >> 1;
      if (off(mid) <= e0) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    int r = lo;
    row_end = off(r + 1);
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const int e = e0 + k;
      if (e < e_end) {
        T xr[R];
        xrow(k, xr);  // before the row-close branch, so no load waits on its stores
        if (e >= row_end) {  // the run of row r closed at e - 1
          if (head_row < 0) {
            head_row = r;
#pragma unroll
            for (int j = 0; j < R; ++j) head_val[j] = run[j];
          } else {
            store_row<R>(row_of<R>(y, r), run);  // began and ended inside this thread
          }
          do {  // step to the row holding e, past any empty rows
            ++r;
            row_end = off(r + 1);
          } while (e >= row_end);
#pragma unroll
          for (int j = 0; j < R; ++j) run[j] = T(0);
        }
#pragma unroll
        for (int j = 0; j < R; ++j) run[j] += v[k] * xr[j];
      }
    }
    key = r;
  }

  // Block-wide inclusive segmented scan of the (key, run) pairs. Threads
  // with no nonzeros sit at the end of the block with key -1 and add
  // nothing to anyone before them. (ek, ev) is the exclusive value: the
  // inclusive scan of the thread before this one.
  int ek = __shfl_up_sync(kFullMask, key, 1);
  T incl[R];
#pragma unroll
  for (int j = 0; j < R; ++j) incl[j] = run[j];
  warp_seg_scan<T, R>(key, ek, incl);
  int before_key = -1;  // lane 31's key in the warp before this one
  T before[R];          // and the inclusive scan over the warps before
#pragma unroll
  for (int j = 0; j < R; ++j) before[j] = T(0);
  if constexpr (kWarps > 1) {
    // One barrier: each warp's last lane posts (key, totals), then every
    // warp scans the kWarps totals itself, in the order one warp would,
    // and takes the sums over the warps before it by a shuffle.
    // (each tile group's own slots)
    __shared__ int s_keys[kGroups * kWarps];
    __shared__ T s_vals[kGroups * kWarps][R];
    int* s_key = s_keys + group_of<kBlockThreads, kGroups>() * kWarps;
    T (*s_val)[R] = s_vals + group_of<kBlockThreads, kGroups>() * kWarps;
    const int warp = group_tid<kBlockThreads, kGroups>() / kWarp;
    if (lane == kWarp - 1) {
      s_key[warp] = key;
#pragma unroll
      for (int j = 0; j < R; ++j) s_val[warp][j] = incl[j];
    }
    group_sync<kBlockThreads, kGroups>();
    const int wk = lane < kWarps ? s_key[lane] : -1;
    T wv[R];
#pragma unroll
    for (int j = 0; j < R; ++j) wv[j] = lane < kWarps ? s_val[lane][j] : T(0);
    warp_seg_scan<T, R, kWarps>(wk, __shfl_up_sync(kFullMask, wk, 1), wv);
    T w[R];
#pragma unroll
    for (int j = 0; j < R; ++j) w[j] = __shfl_sync(kFullMask, wv[j], warp > 0 ? warp - 1 : 0);
    if (warp > 0) {
      before_key = s_key[warp - 1];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        before[j] = w[j];
        if (before_key == key) incl[j] = before[j] + incl[j];
      }
    }
  }
  T ev[R];
#pragma unroll
  for (int j = 0; j < R; ++j) ev[j] = __shfl_up_sync(kFullMask, incl[j], 1);
  if (lane == 0) {  // lane 0 continues the warp before, or starts the tile
    ek = before_key;
#pragma unroll
    for (int j = 0; j < R; ++j) ev[j] = before[j];
  }

  if (e0 < te) {
    if (head_row >= 0) {
      if (ek == head_row) {
#pragma unroll
        for (int j = 0; j < R; ++j) head_val[j] = ev[j] + head_val[j];
      }
      out.emit(off, head_row, head_val, t, ts, te);
    }
    // The last run ends here if its row ends at e_end or the tile does.
    if (row_end == e_end || e_end == te) {
      out.emit(off, key, incl, t, ts, te);
    }
  }
  out.tile_done(off, r0, r1, t);
}

// Row offsets a block of kBlockThreads threads stages: ptr[r0 .. r1 + 1]
// for r0 = tile_row0[t], r1 = tile_row0[t + 1]. Every row between r0 and r1
// holds one of the tile's nonzeros or is empty, so a tile with no empty
// rows spans r1 - r0 <= kTileNnz rows and fits; only runs of empty rows
// can push a tile over (then it reads ptr in global memory).
template <int kBlockThreads>
__host__ __device__ constexpr int row_stage_cap() {
  return kBlockThreads * kTileItems + 2;
}

// K1 — replaces _seg_kernel (spmv_tpu/kernels/engines.py:414); K12 (T =
// double) replaces _seg_kernel_x2 (spmv_tpu/kernels/engines_x2.py:267); K8
// (R = 2..8) replaces _seg_kernel_multi (engines.py:571).
//
// One block per tile of 4·kBlockThreads consecutive nonzeros, so every
// block does the same work whatever the row lengths (a power-law hub row
// is cut into many tiles; a tile may hold hundreds of short rows). Each
// thread loads 4 consecutive values and columns (one 16-byte load each for
// float values and int32 columns) and gathers their x, finds the row of its
// first nonzero by binary search in the tile's row offsets, and sums its
// runs sequentially. A run that closes inside the thread and did not start
// it is a whole row: it goes straight to y. The thread's first and last
// runs may continue in the neighbouring threads; a block-wide segmented
// scan (warp shuffles driven by run-start flags, then every warp over the
// warp totals in shared memory) joins them. The thread where a row's run
// ends in the tile writes it through emit_row. Rows with no nonzeros are
// never written: the wrapper zeroes y (K3's tile_done writes them). Nor is
// a carry slot that no split row uses (a tile whose first row starts at
// its first nonzero has no head, one whose last row ends inside it no
// tail): the fix-ups read only the slots written here, so the wrapper
// allocates carry without a fill.
//
// What bounds it on the H100: bytes in principle (8 B per nonzero
// streamed, 12 in fp64, and a 4- or 8-byte x gather, for 2 flops), but the
// row tracking (search, runs, scan, emit) costs about as much again as the
// stream (spmv_tpu_torch/probes/ablate.py: noscat against noseg). Its
// design: (1) the block stages its tile's row offsets in shared memory
// with one coalesced pass, after its value, column and x loads are issued,
// so that no load waits on the tile's bounds and the search, the row steps
// and the emits read shared memory, not chains of loads of ptr; a tile over
// the stage's cap (runs of empty rows) reads ptr in global memory, the same
// code on other offsets, with the same bits; (2) the scan is driven by a
// ballot of run starts and shuffles only the values; (3) the block scan
// has one barrier, not two: every warp scans the warp totals itself. The
// additions, and so the bits, are those of the kernel that searched ptr
// in global memory. That kernel's ptr reads mostly hit L1 (a block's
// threads search the same few lines), so (1) pays where a tile holds many
// rows: on an H100, the same kernel without the stage (global reads,
// loads after the search) is 7% slower on a power-law matrix of ~110 rows
// per tile and on a 64-row band, and 2-3% faster at ~16 rows per tile
// (python -m spmv_tpu_torch.probes.turns). What the row tracking still
// costs is not load latency.
// At R > 1 (K8, its own __global__ below) each nonzero's 8 plan bytes and
// its row tracking serve R columns, and its gather is one row of X (R·4 B,
// one 32-byte sector). The thread carries R sums through the runs, the
// scan (R shuffles per level behind one ballot) and the emit (R floats per
// row), and gathers each X row in the walk, issued before the row-close
// branch, not ahead of the stage as K1 gathers x: 4·R floats held across
// the stage raised K8 from 32 to 48 registers at R = 4 and made it 9-14%
// slower than the kernel it replaced on an H100 (probes.turns, PERF.md).
//
// seg_tile_body is that block on tile t, its sums to `out` (CarryOut for
// K1, K8 and K12; K3's FusedOut); seg_tiles_block runs it on tile
// blockIdx.x into y and carry.
template <typename T, typename ColT, int kBlockThreads, int kX, typename XT, int R,
          typename Out, int kGroups = 1, typename Head = NoHead>
__device__ __forceinline__ void seg_tile_body(const int* __restrict__ ptr,
                                              const ColT* __restrict__ cols,
                                              const T* __restrict__ vals,
                                              const int* __restrict__ tile_row0,
                                              const XT* __restrict__ x, const Out& out,
                                              int nnz, int t, Head head = {}) {
  constexpr int kTileNnz = kBlockThreads * kTileItems;
  constexpr int kWarps = kBlockThreads / kWarp;
  constexpr int kStage = row_stage_cap<kBlockThreads>();
  static_assert(kBlockThreads % kWarp == 0 && kWarps <= kWarp,
                "a tile block is 1 to 32 whole warps");
  static_assert(R == 1 || (std::is_same_v<T, float> && std::is_same_v<XT, float> &&
                           kX == kXGather),
                "R > 1 gathers rows of a float X");
  __shared__ int s_ptrs[kGroups * kStage];  // each tile group's own stage
  int* s_ptr = s_ptrs + group_of<kBlockThreads, kGroups>() * kStage;

  const int ts = t * kTileNnz;
  const int te = min(ts + kTileNnz, nnz);
  // (written out, not group_tid: so that with one group K1, K3, K8 and K12
  // compile to the same instructions as without the groups)
  const int e0 = ts + (kGroups == 1 ? threadIdx.x : threadIdx.x % kBlockThreads) * kTileItems;
  const int e_end = min(e0 + kTileItems, te);  // one past this thread's last

  // The stream (and at R = 1 the x gather) first, so that no load waits on
  // the tile's bounds and they are in flight while the block stages its
  // row offsets.
  constexpr bool kAhead = R == 1;
  T v[kTileItems];
  T xv[kTileItems][R];
  int c[kTileItems];
  const bool vec = x_rows_aligned<R>(x);
  if (e0 < te) {
    if (e_end - e0 == kTileItems) {
      // aligned: e0 is a multiple of 4 and the wrapper checks the base
      // pointers (16 bytes; 8 for uint16 columns)
      load4(vals + e0, v);
      load_cols4(cols + e0, c);
    } else {
#pragma unroll
      for (int k = 0; k < kTileItems; ++k) {
        const bool in = e0 + k < e_end;
        v[k] = in ? __ldg(vals + e0 + k) : T(0);
        c[k] = in ? static_cast<int>(__ldg(cols + e0 + k)) : 0;
      }
    }
    if constexpr (kAhead) {
#pragma unroll
      for (int k = 0; k < kTileItems; ++k) {
        if (e0 + k < e_end) {
          x_row_at<kX, R>(x, c[k], vec, xv[k], head);
        } else {
#pragma unroll
          for (int j = 0; j < R; ++j) xv[k][j] = T(0);
        }
      }
    }
  }
  // Release the programmatic dependent launched after this kernel (K2,
  // K13) once every block has issued its stream: its grid may then start
  // while this kernel's last wave runs, and does its plan reads before it
  // waits for this kernel to finish. On an H100 this placement made the
  // K1 + K2 and K12 + K13 paths 0.3-1.4 µs faster than no trigger and
  // 0.4-1.8 µs faster than one after the emit, with the same registers
  // (probes.turns; PERF.md §6). It does nothing when the next launch
  // is an ordinary one.
  asm volatile("griddepcontrol.launch_dependents;");
  auto xrow = [&](int k, T (&xr)[R]) {
    if constexpr (kAhead) {
#pragma unroll
      for (int j = 0; j < R; ++j) xr[j] = xv[k][j];
    } else {
      x_row_at<kX, R>(x, c[k], vec, xr, head);
    }
  };

  const int r0 = __ldg(tile_row0 + t);
  const int r1 = __ldg(tile_row0 + t + 1);
  const int span = r1 - r0 + 2;        // offsets ptr[r0 .. r1 + 1]
  if (span <= kStage) {  // the same for the whole block
    for (int i = group_tid<kBlockThreads, kGroups>(); i < span; i += kBlockThreads) {
      s_ptr[i] = __ldg(ptr + r0 + i);
    }
    if constexpr (kWarps > 1) {
      group_sync<kBlockThreads, kGroups>();
    } else {
      __syncwarp();  // one warp (tile 128): a warp barrier is the block's
    }
    tile_rows<T, kBlockThreads, R, StagedOffsets, decltype(xrow), Out, kGroups>(
        StagedOffsets{s_ptr, r0}, r0, r1, t, ts, te, e0, e_end, v, xrow, out);
  } else {
    tile_rows<T, kBlockThreads, R, GlobalOffsets, decltype(xrow), Out, kGroups>(
        GlobalOffsets{ptr}, r0, r1, t, ts, te, e0, e_end, v, xrow, out);
  }
}

template <typename T, typename ColT, int kBlockThreads, int kX, typename XT, int R>
__device__ __forceinline__ void seg_tiles_block(const int* __restrict__ ptr,
                                                const ColT* __restrict__ cols,
                                                const T* __restrict__ vals,
                                                const int* __restrict__ tile_row0,
                                                const XT* __restrict__ x,
                                                T* __restrict__ y,
                                                T* __restrict__ carry, int nnz) {
  seg_tile_body<T, ColT, kBlockThreads, kX, XT, R>(ptr, cols, vals, tile_row0, x,
                                                    CarryOut<T, R>{y, carry}, nnz,
                                                    static_cast<int>(blockIdx.x));
}

template <typename T, typename ColT, int kBlockThreads, int kX = kXGather,
          typename XT = T>
__global__ void __launch_bounds__(kBlockThreads)
seg_spmv_tiles_kernel(const int* __restrict__ ptr, const ColT* __restrict__ cols,
                      const T* __restrict__ vals,
                      const int* __restrict__ tile_row0,
                      const XT* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ carry, int nnz) {
  seg_tiles_block<T, ColT, kBlockThreads, kX, XT, 1>(ptr, cols, vals, tile_row0, x, y,
                                                      carry, nnz);
}

// K8: the block at R = 2..8 (float, int32 columns, X gathered), with a
// bound of its own: at least 8 resident blocks of 256 (32 registers) up to
// R = 4, 5 (48) above. Left to ptxas, R = 4 took 39 registers (6 blocks)
// and ran 2.6% slower than the kernel it replaced on an H100, against 1.5%
// faster with the bound; K1 keeps its bare bound, since an explicit
// minimum of even 1 block raised it from 32 registers to 48.
template <int R>
__host__ __device__ constexpr int multi_min_blocks() {
  return R <= 4 ? 8 : 5;
}
template <int kBlockThreads, int R>
__global__ void __launch_bounds__(kBlockThreads, multi_min_blocks<R>())
seg_spmm_tiles_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int* __restrict__ tile_row0,
                      const float* __restrict__ X, float* __restrict__ Y,
                      float* __restrict__ carry, int nnz) {
  seg_tiles_block<float, int32_t, kBlockThreads, kXGather, float, R>(
      ptr, cols, vals, tile_row0, X, Y, carry, nnz);
}

// K2 — replaces _scatter_kernel (spmv_tpu/kernels/engines.py:171); K13 (T =
// double) is the epilogue of _seg_kernel_x2 (engines_x2.py:267), which the
// TPU kernel folds into its one dispatch; K9 (R = 2..8) replaces
// _scatter_kernel_multi (engines.py:537) on the segmented path.
//
// One thread per split row (a row that crosses a tile boundary of
// kTileNnz nonzeros) and column: at R > 1 neighbouring threads take
// neighbouring columns of one row, so they read neighbouring floats of a
// carry row. It adds the row's partials in tile order: the tail slot of
// the tile where the row begins, then the head slot of every later tile it
// reaches. Reads 4 B (8 B for doubles) per carry and column and writes y
// once; a few KB at cant scale, so bytes are not its cost: its launch, and
// a chain of three dependent loads (the row, its two offsets, the carries)
// behind the whole tile kernel, are.
//
// So it is launched as a programmatic dependent of the tile kernel ahead
// of it on the stream (launch_carry_fixup): the grid may start while the
// tile kernel's last blocks run, and each thread reads its row and the
// row's offsets, plan data that no kernel writes, and computes its tile
// range before griddepcontrol.wait. The wait returns once the kernel ahead
// has completed and its writes are visible; only then does the thread read
// the carries and write y. carry is written by that kernel while this grid
// may already be resident, so it is read with plain (coherent) loads after
// the wait, never through the read-only path. Launched after anything
// other than a kernel, the wait returns at once. The sum and so the bits
// are those of the kernel that waited for the launch. With the tile
// kernel's trigger (griddepcontrol.launch_dependents, seg_tiles_block),
// the launch took 0.2-1.4 µs off the K1 + K2 and K12 + K13 paths on an
// H100 against an ordinary launch; alone it costs about the time of a
// kernel that does nothing (probes.turns, chip_smoke.py; PERF.md §6).
// K8's block is K1's, trigger included, so K9 takes the same launch.
template <typename T, int kTileNnz, int R = 1>
__global__ void __launch_bounds__(kFixupThreads)
carry_fixup_kernel(const int* __restrict__ ptr,
                   const int* __restrict__ carry_rows,
                   const T* carry, T* __restrict__ y, int ncarry) {
  // ncarry·R < 2^31 - kFixupThreads (the launcher checks)
  const int i = blockIdx.x * kFixupThreads + threadIdx.x;
  if (i >= ncarry * R) return;
  const int j = i / R;            // the split row's entry
  const int col = i - j * R;      // and its column, 0 at R = 1
  const int r = __ldg(carry_rows + j);
  const int ta = __ldg(ptr + r) / kTileNnz;
  const int tb = (__ldg(ptr + r + 1) - 1) / kTileNnz;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  T s = carry[(2 * ta + 1) * R + col];
  for (int t = ta + 1; t <= tb; ++t) s += carry[2 * t * R + col];
  y[static_cast<long long>(r) * R + col] = s;
}

// The entry of an instantiation: K1's kernel at R = 1, K8's above.
template <typename T, typename ColT, int kBlockThreads, int kX, typename XT, int R>
auto seg_tiles_kernel() {
  if constexpr (R == 1) {
    return seg_spmv_tiles_kernel<T, ColT, kBlockThreads, kX, XT>;
  } else {
    return seg_spmm_tiles_kernel<kBlockThreads, R>;
  }
}

// Launches one tile kernel instantiation on the plan's schedule; refuses
// (cudaErrorInvalidValue, nothing launched) a tile it was not built for or
// a schedule that does not cover nnz.
template <typename T, typename ColT, int kBlockThreads, int kX = kXGather,
          typename XT = T, int R = 1>
int launch_seg_tiles(const void* ptr, const void* cols, const void* vals,
                     const void* tile_row0, const void* x, void* y, void* carry,
                     int nnz, int ntiles, int tile, void* stream) {
  constexpr int kTileNnz = kBlockThreads * kTileItems;
  if (tile != kTileNnz || ntiles <= 0 || nnz <= 0 || nnz > INT_MAX - kTileNnz ||
      ntiles != (nnz + kTileNnz - 1) / kTileNnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  seg_tiles_kernel<T, ColT, kBlockThreads, kX, XT, R>()<<<ntiles, kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const ColT*>(cols),
      static_cast<const T*>(vals), static_cast<const int*>(tile_row0),
      static_cast<const XT*>(x), static_cast<T*>(y), static_cast<T*>(carry), nnz);
  return static_cast<int>(cudaGetLastError());
}

// A published partial (K3's rows, K6's slices in its tile mode): one
// 64-bit word, the float's bits low and 1 high (kPublished), stored at
// once, so whoever reads the flag reads the value with it and no fence
// orders the two; the reader waits for the flag and sets the word back to
// 0. A finisher issues up to kFinishBatch word loads before it waits.
constexpr unsigned long long kPublished = 1ull << 32;
constexpr int kFinishBatch = 8;

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}
__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// Launches `kernel` on `stream` as a programmatic dependent of the kernel
// ahead of it (cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization): its grid may start
// once every block of that kernel has issued griddepcontrol.launch_dependents
// or exited, so the kernel must run griddepcontrol.wait before it reads
// anything the kernel ahead writes. K2, K9, K13 (launch_carry_fixup) and
// K7 (panel_spmv.cu) launch so. Returns cudaLaunchKernelEx's error, else
// cudaGetLastError() (which it also clears after a refused launch).
template <typename... Params, typename... Args>
int launch_programmatic(void (*kernel)(Params...), int blocks, int threads,
                        void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

// Launches K2 (K13 for T = double, K9 for R = 2..8; a probe's tile) as a
// programmatic dependent of the kernel ahead of it on the stream
// (launch_programmatic). Refuses (cudaErrorInvalidValue, nothing launched)
// a tile it was not built for.
template <typename T, int kTileNnz, int R = 1>
int launch_carry_fixup(const void* ptr, const void* carry_rows, const void* carry,
                       void* y, int ncarry, int tile, void* stream) {
  if (tile != kTileNnz || ncarry <= 0 || ncarry > (INT_MAX - kFixupThreads) / R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_programmatic(
      carry_fixup_kernel<T, kTileNnz, R>, (ncarry * R + kFixupThreads - 1) / kFixupThreads,
      kFixupThreads, stream, static_cast<const int*>(ptr),
      static_cast<const int*>(carry_rows), static_cast<const T*>(carry),
      static_cast<T*>(y), ncarry);
}

}  // namespace
