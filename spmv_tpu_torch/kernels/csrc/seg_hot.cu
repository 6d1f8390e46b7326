// K1's hot-head kernel for Hopper (sm_90a): K1 (seg_spmv.cu) on a CSR plan
// whose columns are relabelled hottest-first, with the x of its hottest
// labels read from shared memory. It runs seg_tile.cuh's tile block, K1's,
// in a grid of its own shape; K2 (seg_spmv.cu's carry_fixup) follows it as
// it follows K1. A source of its own, so that its dynamic shared memory
// leaves the code of seg_spmv.cu's kernels as it was.
//
// Plain C interface for ctypes, as seg_spmv.cu's: device pointers and the
// stream as void*, cudaGetLastError() returned; the host wrapper
// (spmv_tpu_torch/kernels/engines.py, hot_head) checks and allocates.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

#include "seg_tile.cuh"

namespace {

// K1's tile (seg_spmv.cu): 256 threads of 4 nonzeros.
constexpr int kTileThreads = 256;
constexpr int kTileNnz = kTileThreads * kTileItems;

// K1's hot-head kernel: K1 on a plan whose columns are relabelled
// hottest-first (DevCsr.col_order), where the labels below kHotCols take a
// large share of the nonzeros (43.0% on the Kronecker graph at scale 22)
// and the plan's x is a gather into label order.
//
// Each warp of K1 gathers 32 x entries at scattered labels, and the L1
// serves such a gather one cache line per wavefront: on the Kronecker graph
// the gather took about 515 of K1 + K2's 958 µs on an H100 (PERF.md), about
// the time of one L1 line per cycle for each of its 128.3M gathers. Here
// each block copies x[0, min(kHotCols, nx)) into shared memory once, and
// every tile it runs reads x(c) for c < kHotCols there (seg_tile.cuh's
// kXHot, given the head as a HotHead): a warp's 32 reads take a few bank
// cycles, and lanes that read one label get it by broadcast. Labels past
// the head are gathered through L1 as K1 gathers them. To stage the head
// once per block and not once per tile, the grid is persistent: the SMs'
// resident blocks (seg_spmv_tiles_hot_resident: 2 a SM), each of
// kHotGroups tile groups of 256 threads, group g of block b running tiles
// (b·kHotGroups + g) + k·gridDim.x·kHotGroups. A group runs K1's block (seg_tile_body) on its
// tile with its own stage, scan slots and named barrier; a barrier
// between its tiles frees both for the next. Every tile sums its rows in
// K1's order into K1's outputs and carry slots, and x(c) is the same float
// from either copy, so y and the carries are K1's bit for bit and K2
// follows unchanged. Each group releases K2 as K1's block does, at its
// first tile: once every block has, K2's grid may take an SM as this
// grid's blocks leave it (a release after the block's last tile timed the
// same on an H100).
//
// On the Kronecker graph at scale 22 on an H100 the gather, this kernel and
// K2 took 789 µs where the gather, K1 and K2 took 957 (PERF.md). Of the
// 168 µs, the persistent shape without the head gives 63 and the head 105.
// Loading the stream past L1 (ld.global.nc.L1::no_allocate) so that x's
// hot lines stay there made K1 slower, and so did every shape that leaves
// the L1 less than 60 KB (kHotCols).
constexpr int kHotGroups = 4;

// The labels whose x a block stages: 80 KB of floats. The kernel runs 2
// blocks of 4 tile groups (1024 threads) on each SM, so the registers stay
// at K1's 32 for the SM's 2048 threads. A block holds the head, its 4
// groups' row-offset stages and scan slots (4 × 4,232 B) and the 1 KB the
// card reserves per block: 99,872 B, 199,744 B for the two, which fits
// the H100's 196 KB shared-memory carveout (under the 227 KB a block may
// have) and leaves 60 KB of the SM's 256 KB of L1 for the stream and the
// gathers of every other label. The next step, 24,576 labels, needs the
// 228 KB carveout, leaves 28 KB of L1 and on an H100 ran 30% slower than
// 20,480 on the Kronecker graph at scale 22, where 20,480 labels hold
// 43.0% of the nonzeros (PERF.md).
constexpr int kHotCols = 20480;
constexpr int kHotThreads = kHotGroups * kTileThreads;
constexpr int kHotBytes = kHotCols * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kHotThreads, 2048 / kHotThreads)
seg_spmv_tiles_hot_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                          const float* __restrict__ vals, const int* __restrict__ tile_row0,
                          const float* __restrict__ x, float* __restrict__ y,
                          float* __restrict__ carry, int nnz, int ntiles, int nx) {
  extern __shared__ float head[];  // x[0, nhot)
  const int nhot = min(kHotCols, nx);
  for (int i = threadIdx.x; i < nhot; i += kHotThreads) head[i] = __ldg(x + i);
  __syncthreads();
  const HotHead<kHotCols> hot{head};
  const CarryOut<float, 1> out{y, carry};
  const int first =
      static_cast<int>(blockIdx.x) * kHotGroups + group_of<kTileThreads, kHotGroups>();
  const int stride = static_cast<int>(gridDim.x) * kHotGroups;
  for (int t = first; t < ntiles; t += stride) {
    // the group's stage and scan slots are reused
    if (t != first) group_sync<kTileThreads, kHotGroups>();
    seg_tile_body<float, int32_t, kTileThreads, kXHot, float, 1, CarryOut<float, 1>,
                  kHotGroups, HotHead<kHotCols>>(ptr, cols, vals, tile_row0, x, out, nnz,
                                                 t, hot);
  }
}

}  // namespace

extern "C" {

// The labels whose x the hot-head kernel reads from shared memory: the
// plan.upload span's hot_cols (DevCsr.relabeled) is min(this, the used
// columns).
int seg_spmv_tiles_hot_cols() { return kHotCols; }

// The hot-head kernel's grid cap on `device`: its resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the staged head)
// times the SMs, or -1 on an error. Asked once per device, which also
// lets the kernel take the head's dynamic shared memory there.
int seg_spmv_tiles_hot_resident(int device) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};  // 0: not asked yet
  if (device >= 0 && device < kDevices && known[device] > 0) return known[device];
  int per_sm = 0, sms = 0;
  if (cudaFuncSetAttribute(seg_spmv_tiles_hot_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kHotBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_spmv_tiles_hot_kernel,
                                                    kHotThreads, kHotBytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      per_sm <= 0) {
    return -1;
  }
  if (device >= 0 && device < kDevices) known[device] = per_sm * sms;
  return per_sm * sms;
}

// K1's hot-head kernel on a relabelled plan: K1's y and carries, bit for
// bit; x is in label order, nx entries (the used columns). Refuses
// (cudaErrorInvalidValue, nothing launched) what K1 refuses, or nx <= 0.
int seg_spmv_tiles_hot(const void* ptr, const void* cols, const void* vals,
                       const void* tile_row0, const void* x, void* y, void* carry,
                       int nnz, int ntiles, int tile, int nx, void* stream) {
  if (tile != kTileNnz || ntiles <= 0 || nnz <= 0 || nnz > INT_MAX - kTileNnz ||
      ntiles != (nnz + kTileNnz - 1) / kTileNnz || nx <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  const cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int resident = seg_spmv_tiles_hot_resident(device);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = std::min((ntiles + kHotGroups - 1) / kHotGroups, resident);
  seg_spmv_tiles_hot_kernel<<<blocks, kHotThreads, kHotBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(tile_row0),
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(carry), nnz,
      ntiles, nx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
