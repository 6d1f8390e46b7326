// CSR SpMV kernels for Hopper (sm_90a): y = A·x in float32, Y = A·X for
// R = 2..8 right-hand sides, and y = A·x in float64 (the fp64-grade mode).
//
// Seven kernels, each replacing one Pallas kernel of the JAX package's
// segmented engine (spmv_tpu/kernels/engines.py, engines_x2.py):
//
//   K1 seg_spmv_tiles     replaces _seg_kernel           (segmented_spmv_partials)
//   K2 carry_fixup        replaces _scatter_kernel       (_window_scatter)
//   K3 csr_spmv_fused     replaces _seg_kernel_fused     (segmented_spmv_fused)
//   K8 seg_spmm_tiles     replaces _seg_kernel_multi     (segmented_spmv_multi)
//   K9 carry_fixup_multi  replaces _scatter_kernel_multi (_window_scatter_multi)
//   K12 seg_spmv_tiles_x2 replaces _seg_kernel_x2        (segmented_spmv_x2),
//   K13 carry_fixup_x2    with its epilogue folded in there
//
// K1, K2, K8, K9, K12 and K13 are instantiations of the tile kernel and its
// fix-up in seg_tile.cuh (templates on the value type, the column type, the
// block size, the x read and, for K8 and K9, the number of right-hand sides),
// which probe_spmv.cu instantiates too, so the tile bounds and carry-slot
// rules stay in one place; K3 runs the same tile block with outputs of its
// own (FusedOut) and does K2's adds in the same launch. The TPU kernel B10
// carries hi and lo f32 planes, Dekker splits and TwoSum chains because its
// VPU has no FMA and its MXU takes bf16; Hopper has native fp64 FMA, so
// K12 reads fp64 values and x, multiplies and adds in fp64 and writes fp64
// y and carries. It streams 12 B per nonzero (an 8-byte value, a 4-byte
// column) and gathers 8 B of x for 2 flops: still bytes, not fp64 flops,
// bound it.
//
// What bounds them on the H100: bytes. Each nonzero streams 8 B (a float32
// value and an int32 column) and gathers 4 B of x, for 2 flops: at most
// 0.25 flop/B, two orders of magnitude under the card's flop-to-byte
// ratio. The row pointer adds 4 B per row. So the design goal is to read
// each value and column once, in wide coalesced loads, and to keep x in
// L2 (250 KB at cant scale, 2 MB at the 524k-row power-law size, both far
// under the 50 MB L2).
//
// No kernel uses float atomics. Every row is summed in an order fixed by
// the plan and the launch shape, so two runs give the same bits, and each
// row's sum only ever adds that row's own products.
//
// Plain C interface for ctypes: every launcher takes device pointers and
// the stream as void*, launches on that stream, and returns
// cudaGetLastError() (0 = launched; for K2, K9 and K13, which launch with
// cudaLaunchKernelEx as programmatic dependents of the tile kernel ahead
// of them, that call's error first). The host wrapper
// (spmv_tpu_torch/kernels/engines.py) checks shapes, types and devices,
// allocates every output, and never calls a launcher with an empty grid.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

#include "seg_tile.cuh"

namespace {

// K1's tile: 256 threads, each taking 4 consecutive nonzeros. Must equal
// TILE_NNZ in spmv_tpu_torch/formats/base.py. K8 and K9 share it. K1, K2,
// K12 and K13 are the <float|double, int32_t, 256> instantiations of the
// tile kernel and fix-up in seg_tile.cuh, K8 and K9 their R-wide ones.
constexpr int kTileThreads = 256;
constexpr int kTileNnz = kTileThreads * kTileItems;

// K3 — replaces _seg_kernel_fused (spmv_tpu/kernels/engines.py:430).
//
// y = A·x in one launch, K1's block on K1's tiles of 1024 nonzeros, so no
// block's work grows with the longest row: a hub row is cut into tiles as
// K1 cuts it, and the TPU kernel's nonzero-balanced chunks are what it
// keeps. What K2 does in a second launch is done here by the block that
// owns a split row's last tile. The other tiles of the row publish their
// partial of it (FusedOut::emit): the tile where the row begins its tail
// partial, each tile inside the row its whole sum, the values K1 writes to
// carry slots 2ta + 1 and 2t. A published partial is one 64-bit word per
// tile, the float's bits low and 1 high, stored at once, so whoever reads
// the flag reads the value with it and no fence orders the two. The block
// of the last tile waits for the words of tiles ta .. t - 1, adds them in
// tile order and its own head partial last (finish_row): K2's order, so y
// is K1 + K2's, bit for bit, and which side of the one-dispatch threshold
// a plan falls on does not change the answer. It then sets each word back
// to 0: every launch, and every replay of a CUDA graph holding one, finds
// them all 0, with no memset. Integer flags and plain float adds, no float
// atomics. That is the mode wherever a row is long; on plans whose rows
// are all short the launcher runs the second mode below
// (csr_spmv_rows_kernel), which the wrapper picks from the plan.
//
// The waits are safe because every wait goes to a smaller tile and all
// blocks are resident together: the grid is at most the resident blocks
// of the card (csr_spmv_fused_resident), each block walks its tiles in
// increasing order, and a tile publishes before it waits. So the smallest
// tile not yet done has its block running and waits on no one (the plans
// under the one-dispatch threshold have fewer tiles than the card holds
// blocks: one tile per block). Rows with no nonzeros are written 0 by the
// tile whose span holds them (tile_done), those before the first nonzero
// by tile 0 and after the last by the last tile, so the wrapper allocates
// y without a fill.
//
// What bounds it on the H100: K1's bytes (8 B per nonzero, a 4-byte x
// gather, 4 B per row of ptr and y), and 24 B of words (published, read,
// reset) per tile a split row runs on from; at the sizes it runs (plans of
// at most 4 MB, under one wave of blocks) mostly latency: one tile's
// loads, stage, scan and emit, then for a split row one L2 round trip for
// the words, in the common case published by then (finish_row issues up
// to kFinishBatch loads at once, so a row over many tiles waits about one
// round trip per kFinishBatch tiles).
// kPublished, kFinishBatch, load_word and store_word: seg_tile.cuh.

// Split row r's y, in tile t where it ends: the partials tiles ta .. t - 1
// published, in tile order, then `own`, this tile's partial; each word is
// waited for, then reset to 0.
__device__ __forceinline__ float finish_row(unsigned long long* pub, int ta, int t,
                                            float own) {
  float s = 0.f;
  for (int b = ta; b < t; b += kFinishBatch) {
    unsigned long long w[kFinishBatch];
#pragma unroll
    for (int i = 0; i < kFinishBatch; ++i) w[i] = b + i < t ? load_word(pub + b + i) : 0ull;
#pragma unroll
    for (int i = 0; i < kFinishBatch; ++i) {
      if (b + i < t) {
        while (w[i] < kPublished) w[i] = load_word(pub + b + i);
        const float v = __uint_as_float(static_cast<unsigned>(w[i]));
        s = b + i == ta ? v : s + v;
        store_word(pub + b + i, 0ull);
      }
    }
  }
  return s + own;
}

// K3's outputs for seg_tile_body: y, and the published partials. One per
// thread; a thread that closes a split row's last run keeps it (fin_row)
// and finishes it in tile_done, after its emits, so that a thread holding
// both a finishing row and the row that runs on publishes before it waits.
struct FusedOut {
  float* __restrict__ y;
  unsigned long long* pub;  // one word per tile, 0 at launch and at exit
  int nrows;
  int ntiles;
  mutable int fin_row = -1;  // the split row this thread finishes, or -1
  mutable float fin_own = 0.f;  // and this tile's partial of it

  template <typename Offsets>
  __device__ __forceinline__ void emit(Offsets off, int r, const float (&v)[1], int t,
                                       int ts, int te) const {
    if (off(r + 1) > te) {  // runs on into later tiles
      store_word(pub + t, kPublished | __float_as_uint(v[0]));
    } else if (off(r) < ts) {  // began in an earlier tile, ends in this one
      fin_row = r;
      fin_own = v[0];
    } else {
      y[r] = v[0];
    }
  }

  // The empty rows strictly between the tile's first and last rows (both
  // hold nonzeros), those before row r0 in tile 0 and after r1 in the last
  // tile; then the split row this thread finishes.
  template <typename Offsets>
  __device__ __forceinline__ void tile_done(Offsets off, int r0, int r1, int t) const {
    const int tid = static_cast<int>(threadIdx.x);
    for (int q = r0 + 1 + tid; q < r1; q += kTileThreads) {
      if (off(q) == off(q + 1)) y[q] = 0.f;
    }
    if (t == 0) {
      for (int q = tid; q < r0; q += kTileThreads) y[q] = 0.f;
    }
    if (t == ntiles - 1) {
      for (int q = r1 + 1 + tid; q < nrows; q += kTileThreads) y[q] = 0.f;
    }
    if (fin_row >= 0) {
      y[fin_row] = finish_row(pub, off(fin_row) / kTileNnz, t, fin_own);
      fin_row = -1;
    }
  }
};

// K3's second mode, for plans whose rows are all short (the wrapper's
// rule, engines.fused_lanes: no row longer than 3 steps of the sub-warp):
// VEC lanes (a sub-warp) per row.
// Each lane sums the row's nonzeros lane, lane + VEC, ... (coalesced across
// the sub-warp), then an xor butterfly over the sub-warp adds the lanes;
// lane 0 writes y, including 0 for an empty row. Its order is fixed by the
// plan and VEC, not K1's: the bits are its own. On such plans it beats the
// tile mode, whose row tracking and fix-up cost more than a few steps of a
// sub-warp (1.8-1.9x on an H100 at the sweep's regular plans, 512-16,384
// rows; PERF.md).
template <int VEC>
__global__ void __launch_bounds__(kTileThreads)
csr_spmv_rows_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                     const float* __restrict__ vals, const float* __restrict__ x,
                     float* __restrict__ y, int nrows) {
  const long long gid = static_cast<long long>(blockIdx.x) * kTileThreads + threadIdx.x;
  const long long row = gid / VEC;
  const int lane = threadIdx.x & (VEC - 1);
  const bool valid = row < nrows;
  // Threads past the last row stay for the shuffles with a zero sum.
  const int rs = valid ? __ldg(ptr + row) : 0;
  const int re = valid ? __ldg(ptr + row + 1) : 0;
  float s = 0.f;
  for (int e = rs + lane; e < re; e += VEC) s += __ldg(vals + e) * __ldg(x + __ldg(cols + e));
#pragma unroll
  for (int off = VEC / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off, VEC);
  if (valid && lane == 0) y[row] = s;
}

__global__ void __launch_bounds__(kTileThreads)
csr_spmv_fused_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                      const float* __restrict__ vals, const int* __restrict__ tile_row0,
                      const float* __restrict__ x, float* __restrict__ y,
                      unsigned long long* pub, int nnz, int ntiles, int nrows) {
  const FusedOut out{y, pub, nrows, ntiles};
  const int first = static_cast<int>(blockIdx.x);
  for (int t = first; t < ntiles; t += static_cast<int>(gridDim.x)) {
    if (t != first) __syncthreads();  // the stage and the scan's slots are reused
    seg_tile_body<float, int32_t, kTileThreads, kXGather, float, 1>(
        ptr, cols, vals, tile_row0, x, out, nnz, t);
  }
}

// ---------------------------------------------------------------- R > 1
//
// X is row-major (ncols, R), so the R values of x that one nonzero needs
// are one contiguous row of 8-32 B, a single 32-byte sector. Y is row-major
// (nrows, R) and carries are (2·ntiles, R). What bounds K8 on the H100 is
// still bytes: each nonzero streams its 8 plan bytes once for all R columns
// and gathers R·4 B of X, so per right-hand side the plan costs 8/R B
// against K1's 8 — that is the point of the multi-RHS engine
// (spmv_tpu/api.py:94-97).
//
// K8 — replaces _seg_kernel_multi (spmv_tpu/kernels/engines.py:571) — is
// seg_tile.cuh's tile block at R = 2..8 (seg_spmm_tiles_kernel): K1's
// tile, its value and column loads, its staged offsets, its ballot scan
// with one barrier and its emit, each carrying R sums, with each X row
// gathered in the walk and a launch bound of its own (seg_tile.cuh says
// why). Column j adds in K1's order, so it is what K1 gives for X[:, j],
// bit for bit. The TPU kernel's stacked x tables, sub-chunk windows and b2
// bank bits answer VMEM limits; none is here.

// K9 — replaces _scatter_kernel_multi (spmv_tpu/kernels/engines.py:537) on
// the segmented path — is seg_tile.cuh's fix-up at R = 2..8
// (carry_fixup_kernel, launch_carry_fixup): K2's thread per split row and
// column, its tile order, and its programmatic dependent launch behind K8,
// whose block triggers it as K1's triggers K2.

// Blocks of K1 (T = double: K12; R = 2..8: K8) resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers and the
// static shared memory decide), or -1 on an error.
template <typename T, int R = 1>
int seg_tiles_blocks_per_sm() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, seg_tiles_kernel<T, int32_t, kTileThreads, kXGather, T, R>(),
          kTileThreads, 0) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // namespace

extern "C" {

// K1: y[r] for every row wholly inside a tile, and the head/tail partials
// of the rows that cross tile boundaries into carry (2 slots per tile).
int seg_spmv_tiles(const void* ptr, const void* cols, const void* vals,
                   const void* tile_row0, const void* x, void* y, void* carry,
                   int nnz, int ntiles, int tile, void* stream) {
  return launch_seg_tiles<float, int32_t, kTileThreads>(
      ptr, cols, vals, tile_row0, x, y, carry, nnz, ntiles, tile, stream);
}

// K2: y[r] = the sum of a split row's partials, in tile order; a
// programmatic dependent launch (seg_tile.cuh, launch_carry_fixup).
int carry_fixup(const void* ptr, const void* carry_rows, const void* carry,
                void* y, int ncarry, int tile, void* stream) {
  return launch_carry_fixup<float, kTileNnz>(ptr, carry_rows, carry, y, ncarry,
                                             tile, stream);
}

// K12: K1 in float64 — fp64 vals, x, y and carry.
int seg_spmv_tiles_x2(const void* ptr, const void* cols, const void* vals,
                      const void* tile_row0, const void* x, void* y, void* carry,
                      int nnz, int ntiles, int tile, void* stream) {
  return launch_seg_tiles<double, int32_t, kTileThreads>(
      ptr, cols, vals, tile_row0, x, y, carry, nnz, ntiles, tile, stream);
}

// K13: K2 in float64.
int carry_fixup_x2(const void* ptr, const void* carry_rows, const void* carry,
                   void* y, int ncarry, int tile, void* stream) {
  return launch_carry_fixup<double, kTileNnz>(ptr, carry_rows, carry, y, ncarry,
                                              tile, stream);
}

// K1's (fp64: K12's; rhs 2..8: K8's) blocks resident per SM, or -1.
int seg_tiles_occupancy(int fp64, int rhs) {
  if (fp64) return rhs == 1 ? seg_tiles_blocks_per_sm<double>() : -1;
  switch (rhs) {
    case 1: return seg_tiles_blocks_per_sm<float>();
    case 2: return seg_tiles_blocks_per_sm<float, 2>();
    case 3: return seg_tiles_blocks_per_sm<float, 3>();
    case 4: return seg_tiles_blocks_per_sm<float, 4>();
    case 5: return seg_tiles_blocks_per_sm<float, 5>();
    case 6: return seg_tiles_blocks_per_sm<float, 6>();
    case 7: return seg_tiles_blocks_per_sm<float, 7>();
    case 8: return seg_tiles_blocks_per_sm<float, 8>();
    default: return -1;
  }
}

// K3's grid cap on `device`: its resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs, or -1 on
// an error. Asked once per device.
int csr_spmv_fused_resident(int device) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};  // 0: not asked yet
  if (device >= 0 && device < kDevices && known[device] > 0) return known[device];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csr_spmv_fused_kernel,
                                                    kTileThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      per_sm <= 0) {
    return -1;
  }
  if (device >= 0 && device < kDevices) known[device] = per_sm * sms;
  return per_sm * sms;
}

// K3: y = A·x in one launch. vec 0: on K1's tile schedule, `pub` holding
// one word per tile, all 0 (the kernel leaves them so); vec 4, 8, 16 or
// 32: that many lanes per row (tile_row0 and pub unread). Refuses
// (cudaErrorInvalidValue, nothing launched) a tile it was not built for, a
// schedule that does not cover nnz, or another vec.
int csr_spmv_fused(const void* ptr, const void* cols, const void* vals,
                   const void* tile_row0, const void* x, void* y, void* pub, int nnz,
                   int ntiles, int nrows, int tile, int vec, void* stream) {
  if (tile != kTileNnz || ntiles <= 0 || nnz <= 0 || nnz > INT_MAX - kTileNnz ||
      ntiles != (nnz + kTileNnz - 1) / kTileNnz || nrows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 0) {
    const long long blocks = (static_cast<long long>(nrows) * vec + kTileThreads - 1) /
                             kTileThreads;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int* p = static_cast<const int*>(ptr);
    const int* c = static_cast<const int*>(cols);
    const float* v = static_cast<const float*>(vals);
    const float* xx = static_cast<const float*>(x);
    float* yy = static_cast<float*>(y);
    const int g = static_cast<int>(blocks);
    switch (vec) {
      case 4: csr_spmv_rows_kernel<4><<<g, kTileThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
      case 8: csr_spmv_rows_kernel<8><<<g, kTileThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
      case 16: csr_spmv_rows_kernel<16><<<g, kTileThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
      case 32: csr_spmv_rows_kernel<32><<<g, kTileThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0;
  const cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int resident = csr_spmv_fused_resident(device);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);
  csr_spmv_fused_kernel<<<std::min(ntiles, resident), kTileThreads, 0, s>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(tile_row0),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<unsigned long long*>(pub), nnz, ntiles, nrows);
  return static_cast<int>(cudaGetLastError());
}

// K8: Y[r, :] for every row wholly inside a tile, and the head/tail
// partials of the split rows into carry (2 rows of R per tile); R = 2..8.
int seg_spmm_tiles(const void* ptr, const void* cols, const void* vals,
                   const void* tile_row0, const void* X, void* Y, void* carry,
                   int nnz, int ntiles, int tile, int rhs, void* stream) {
  switch (rhs) {
#define K8_CASE(R)                                                                  \
  case R:                                                                           \
    return launch_seg_tiles<float, int32_t, kTileThreads, kXGather, float, R>(      \
        ptr, cols, vals, tile_row0, X, Y, carry, nnz, ntiles, tile, stream);
    K8_CASE(2) K8_CASE(3) K8_CASE(4) K8_CASE(5) K8_CASE(6) K8_CASE(7) K8_CASE(8)
#undef K8_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9: Y[r, j] = the sum of split row r's partials in column j, in tile
// order; R = 2..8; a programmatic dependent launch (launch_carry_fixup).
int carry_fixup_multi(const void* ptr, const void* carry_rows, const void* carry,
                      void* Y, int ncarry, int tile, int rhs, void* stream) {
  switch (rhs) {
#define K9_CASE(R)                                                                 \
  case R:                                                                          \
    return launch_carry_fixup<float, kTileNnz, R>(ptr, carry_rows, carry, Y, ncarry, \
                                                  tile, stream);
    K9_CASE(2) K9_CASE(3) K9_CASE(4) K9_CASE(5) K9_CASE(6) K9_CASE(7) K9_CASE(8)
#undef K9_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
