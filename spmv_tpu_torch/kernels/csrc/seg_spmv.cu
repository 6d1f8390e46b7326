// CSR SpMV kernels for Hopper (sm_90a): y = A·x in float32.
//
// Three kernels, each replacing one Pallas kernel of the JAX package's
// segmented engine (spmv_tpu/kernels/engines.py):
//
//   K1 seg_spmv_tiles  replaces _seg_kernel        (segmented_spmv_partials)
//   K2 carry_fixup     replaces _scatter_kernel    (_window_scatter)
//   K3 csr_spmv_fused  replaces _seg_kernel_fused  (segmented_spmv_fused)
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
// cudaGetLastError() (0 = launched). The host wrapper
// (spmv_tpu_torch/kernels/engines.py) checks shapes, types and devices,
// allocates every output, and never calls a launcher with an empty grid.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// K1's tile: 256 threads, each taking 4 consecutive nonzeros. Must equal
// TILE_NNZ in spmv_tpu_torch/formats/base.py.
constexpr int kTileThreads = 256;
constexpr int kTileItems = 4;
constexpr int kTileNnz = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / kWarp;

// K2 and K3 block size.
constexpr int kThreads = 256;

// Inclusive segmented scan across a warp. Keys (rows) are nondecreasing
// along the lanes; a lane adds its neighbour's running sum only while the
// two keys agree, so every partial stays inside one row, and the order of
// the additions is fixed by the lane positions.
__device__ __forceinline__ float warp_seg_scan(int key, float val) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int k = __shfl_up_sync(kFullMask, key, d);
    const float v = __shfl_up_sync(kFullMask, val, d);
    if (lane >= d && k == key) val = v + val;
  }
  return val;
}

// Writes the tile's total for row r: straight to y when the whole row lies
// in this tile [ts, te), else to the tile's head slot (the row began in an
// earlier tile) or tail slot (the row runs on into later tiles).
__device__ __forceinline__ void emit_row(const int* __restrict__ ptr, int r,
                                         float v, int t, int ts, int te,
                                         float* __restrict__ y,
                                         float* __restrict__ carry) {
  const int rs = __ldg(ptr + r);
  const int re = __ldg(ptr + r + 1);
  if (rs < ts) {
    carry[2 * t] = v;
  } else if (re > te) {
    carry[2 * t + 1] = v;
  } else {
    y[r] = v;
  }
}

// K1 — replaces _seg_kernel (spmv_tpu/kernels/engines.py:414).
//
// One block per tile of kTileNnz consecutive nonzeros, so every block does
// the same work whatever the row lengths (a power-law hub row is cut into
// many tiles; a tile may hold hundreds of short rows). Each thread loads 4
// consecutive values and columns as one 16-byte load each, finds the row
// of its first nonzero by binary search in ptr between the plan's
// tile_row0 bounds, and sums its runs sequentially. A run that closes
// inside the thread and did not start it is a whole row: it goes straight
// to y. The thread's first and last runs may continue in the neighbouring
// threads; a block-wide segmented scan (warp shuffles, then one warp over
// the 8 warp totals in shared memory) joins them. The thread where a row's
// run ends in the tile writes it through emit_row. Rows with no nonzeros
// are never written: the wrapper zeroes y.
__global__ void __launch_bounds__(kTileThreads)
seg_spmv_tiles_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int* __restrict__ tile_row0,
                      const float* __restrict__ x, float* __restrict__ y,
                      float* __restrict__ carry, int nnz) {
  __shared__ int s_key[kTileWarps];
  __shared__ float s_val[kTileWarps];

  const int t = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int ts = t * kTileNnz;
  const int te = min(ts + kTileNnz, nnz);
  const int e0 = ts + threadIdx.x * kTileItems;
  const int e_end = min(e0 + kTileItems, te);  // one past this thread's last

  int key = -1;          // row of this thread's last run; -1 = no nonzeros
  float run = 0.f;       // that run's partial sum
  int head_row = -1;     // row of the first run, if it closed in this thread
  float head_val = 0.f;  // and its partial sum
  int row_end = 0;       // ptr[key + 1]

  if (e0 < te) {
    int lo = __ldg(tile_row0 + t);
    int hi = __ldg(tile_row0 + t + 1);
    while (lo < hi) {  // largest r in [lo, hi] with ptr[r] <= e0
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(ptr + mid) <= e0) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    int r = lo;
    row_end = __ldg(ptr + r + 1);

    float v[kTileItems];
    int c[kTileItems];
    if (e_end - e0 == kTileItems) {
      // 16-byte aligned: e0 is a multiple of 4 and the wrapper checks the
      // base pointers.
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(vals + e0));
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(cols + e0));
      v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
      c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
    } else {
#pragma unroll
      for (int k = 0; k < kTileItems; ++k) {
        const bool in = e0 + k < e_end;
        v[k] = in ? __ldg(vals + e0 + k) : 0.f;
        c[k] = in ? __ldg(cols + e0 + k) : 0;
      }
    }

#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const int e = e0 + k;
      if (e < e_end) {
        if (e >= row_end) {  // the run of row r closed at e - 1
          if (head_row < 0) {
            head_row = r;
            head_val = run;
          } else {
            y[r] = run;  // began and ended inside this thread
          }
          do {  // step to the row holding e, past any empty rows
            ++r;
            row_end = __ldg(ptr + r + 1);
          } while (e >= row_end);
          run = 0.f;
        }
        run += v[k] * __ldg(x + c[k]);
      }
    }
    key = r;
  }

  // Block-wide inclusive segmented scan of the (key, run) pairs. Threads
  // with no nonzeros sit at the end of the block with key -1 and add
  // nothing to anyone before them.
  float incl = warp_seg_scan(key, run);
  if (lane == kWarp - 1) {
    s_key[warp] = key;
    s_val[warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    const int wk = lane < kTileWarps ? s_key[lane] : -1;
    const float wv = warp_seg_scan(wk, lane < kTileWarps ? s_val[lane] : 0.f);
    if (lane < kTileWarps) s_val[lane] = wv;  // inclusive over warps 0..lane
  }
  __syncthreads();
  if (warp > 0 && s_key[warp - 1] == key) incl = s_val[warp - 1] + incl;

  // Exclusive value: the inclusive scan of the thread before this one.
  int ek = __shfl_up_sync(kFullMask, key, 1);
  float ev = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) {
    ek = warp > 0 ? s_key[warp - 1] : -1;
    ev = warp > 0 ? s_val[warp - 1] : 0.f;
  }

  if (e0 < te) {
    if (head_row >= 0) {
      emit_row(ptr, head_row, ek == head_row ? ev + head_val : head_val, t, ts,
               te, y, carry);
    }
    // The last run ends here if its row ends at e_end or the tile does.
    if (row_end == e_end || e_end == te) {
      emit_row(ptr, key, incl, t, ts, te, y, carry);
    }
  }
}

// K2 — replaces _scatter_kernel (spmv_tpu/kernels/engines.py:171).
//
// One thread per split row (a row that crosses a tile boundary). It adds
// the row's partials in tile order: the tail slot of the tile where the row
// begins, then the head slot of every later tile it reaches. Reads 4 B per
// carry and writes y once; a few KB at cant scale, so launch latency is its
// cost.
__global__ void __launch_bounds__(kThreads)
carry_fixup_kernel(const int* __restrict__ ptr,
                   const int* __restrict__ carry_rows,
                   const float* __restrict__ carry, float* __restrict__ y,
                   int ncarry) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= ncarry) return;
  const int r = __ldg(carry_rows + j);
  const int ta = __ldg(ptr + r) / kTileNnz;
  const int tb = (__ldg(ptr + r + 1) - 1) / kTileNnz;
  float s = carry[2 * ta + 1];
  for (int t = ta + 1; t <= tb; ++t) s += carry[2 * t];
  y[r] = s;
}

// K3 — replaces _seg_kernel_fused (spmv_tpu/kernels/engines.py:430).
//
// One dispatch for small plans: VEC lanes (a sub-warp) per row. Each lane
// sums the row's nonzeros lane, lane + VEC, ... (coalesced across the
// sub-warp), then an xor butterfly over the sub-warp adds the lanes; lane 0
// writes y, including 0 for an empty row. The wrapper picks VEC from the
// mean row length so that short rows do not leave most lanes idle.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
csr_spmv_fused_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ x, float* __restrict__ y,
                      int nrows) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
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

}  // namespace

extern "C" {

// K1: y[r] for every row wholly inside a tile, and the head/tail partials
// of the rows that cross tile boundaries into carry (2 slots per tile).
int seg_spmv_tiles(const void* ptr, const void* cols, const void* vals,
                   const void* tile_row0, const void* x, void* y, void* carry,
                   int nnz, int ntiles, int tile, void* stream) {
  if (tile != kTileNnz || ntiles <= 0 || nnz <= 0 || nnz > INT_MAX - kTileNnz ||
      ntiles != (nnz + kTileNnz - 1) / kTileNnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  seg_spmv_tiles_kernel<<<ntiles, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(tile_row0),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(carry), nnz);
  return static_cast<int>(cudaGetLastError());
}

// K2: y[r] = the sum of a split row's partials, in tile order.
int carry_fixup(const void* ptr, const void* carry_rows, const void* carry,
                void* y, int ncarry, int tile, void* stream) {
  if (tile != kTileNnz || ncarry <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (ncarry + kThreads - 1) / kThreads;
  carry_fixup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(carry_rows),
      static_cast<const float*>(carry), static_cast<float*>(y), ncarry);
  return static_cast<int>(cudaGetLastError());
}

// K3: y = A·x in one dispatch, vec lanes per row (4, 8, 16 or 32).
int csr_spmv_fused(const void* ptr, const void* cols, const void* vals,
                   const void* x, void* y, int nrows, int vec, void* stream) {
  if (nrows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(nrows) * vec + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* c = static_cast<const int*>(cols);
  const float* v = static_cast<const float*>(vals);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  const int g = static_cast<int>(blocks);
  switch (vec) {
    case 4: csr_spmv_fused_kernel<4><<<g, kThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
    case 8: csr_spmv_fused_kernel<8><<<g, kThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
    case 16: csr_spmv_fused_kernel<16><<<g, kThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
    case 32: csr_spmv_fused_kernel<32><<<g, kThreads, 0, s>>>(p, c, v, xx, yy, nrows); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
