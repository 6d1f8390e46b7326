// Conjugate gradients' body after its SpMV, fused into three kernels for
// Hopper (sm_90a): the dots, the updates of x, r and p, and the
// recurrence's scalars, for one vector (R = 1) or a block of R = 2..8
// right-hand sides, each column with its own mask.
//
// It replaces no Pallas kernel: the JAX package's cg body is jnp outside
// every pallas_call (spmv_tpu/solve.py), and the port ran it as PyTorch
// calls around the SpMV. Those were some 17 launches an iteration for one
// vector, and for a block the broadcast multiplies, adds, column sums and
// the three torch.where that froze a stopped column: about 558 MB of
// elementwise traffic a body at n = 1,124,864 and R = 4, where the (n, R)
// arrays (18 MB each) do not fit in the L2 beside the matrix.
//
// What bounds them on the H100: HBM bytes. Each body has to read P and AP
// for p·Ap; X, R, P and AP, and write X and R, for x, r and r·r; R and P,
// and write P, for p: 11 arrays, 198 MB at that size, 59 µs at 3.35 TB/s,
// for about one flop a byte. So the design makes one pass for each
// reduction and updates in place:
//
//   cg_body_pap  the column mask on = rs > tol2 && k < kmax, from the
//                body's entry state (written by block 0 for the next two);
//                p_j·ap_j into per-block partials; the last block to
//                finish sums them and writes alpha_j = rs_j / pap_j.
//   cg_body_xr   x += alpha·p and r -= alpha·ap in place, r_j·r_j into
//                partials; the last block writes beta_j = rs_new_j / rs_j,
//                then rs_j = rs_new_j and k_j += 1.
//   cg_body_p    p = r + beta·p in place.
//
// Only the columns the mask holds on change. A row is loaded and stored
// whole (16-byte accesses), so an inactive column's entries are stored
// back as they were read and keep their bits, as the torch.where of the
// plain version keeps them; a body with no active column reads and writes
// no vector. The arrays are row-major (n, R), read as units of U rows,
// U·R a multiple of 4 floats (a row of R = 4 is one float4; at R = 1 four
// rows), so a unit is V = U·R/4 float4s and the column of each of its
// entries is known at compile time; the n mod U rows past the last whole
// unit are taken by block 0, one row a thread.
//
// Numerics. The products and sums are written __fmul_rn / __fadd_rn /
// __fsub_rn so nvcc contracts none into an FMA: given the same alpha and
// beta, x, r and p are the plain version's bits (x + alpha·p, r − alpha·ap,
// r + beta·p, each product rounded, then the sum). alpha and beta are
// IEEE divisions, as PyTorch's. The dots are deterministic: for a given
// (n, R) and block cap the grid is fixed, each thread sums its units in
// order, a block sums its threads in a fixed shuffle tree and then its
// warps in order, and the last block sums the per-block partials in block
// order (strided over its threads, then the same tree). No float atomics;
// the last block is found through an integer ticket, which it sets back
// to 0 for the next launch, so a CUDA graph replays them as they are. Only
// the dots' order differs from torch.dot's and a column sum's.
//
// Plain C interface for ctypes: every launcher takes device pointers and
// the stream as void*, launches on that stream, and returns
// cudaGetLastError(). The host wrapper (spmv_tpu_torch/kernels/cg_body.py)
// checks shapes, types, devices and 16-byte alignment and allocates the
// scratch: partials (blocks·R floats), the ticket (0), the mask, alpha
// and beta.

#include <cuda_runtime.h>
#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A unit: U whole rows of R floats, U·R a multiple of 4.
template <int R>
struct Unit {
  static constexpr int kRows = R % 4 == 0 ? 1 : (R % 2 == 0 ? 2 : 4);
  static constexpr int kVecs = kRows * R / 4;  // float4s
  static constexpr int kFloats = 4 * kVecs;
};

template <int R>
__device__ __forceinline__ void load_unit(const float* a, long long u,
                                          float (&v)[Unit<R>::kFloats]) {
  const float4* q = reinterpret_cast<const float4*>(a) + u * Unit<R>::kVecs;
#pragma unroll
  for (int m = 0; m < Unit<R>::kVecs; ++m) {
    const float4 w = q[m];
    v[4 * m] = w.x; v[4 * m + 1] = w.y; v[4 * m + 2] = w.z; v[4 * m + 3] = w.w;
  }
}

template <int R>
__device__ __forceinline__ void store_unit(float* a, long long u,
                                           const float (&v)[Unit<R>::kFloats]) {
  float4* q = reinterpret_cast<float4*>(a) + u * Unit<R>::kVecs;
#pragma unroll
  for (int m = 0; m < Unit<R>::kVecs; ++m) {
    q[m] = make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
}

// The column mask and one scalar per column (alpha or beta), read once per
// block into shared memory; false where no column is on.
template <int R>
__device__ __forceinline__ bool load_columns(const int* mask, const float* scalar,
                                             int (&on)[R], float (&s)[R]) {
  __shared__ int on_s[R];
  __shared__ float s_s[R];
  if (threadIdx.x < R) {
    on_s[threadIdx.x] = mask[threadIdx.x];
    s_s[threadIdx.x] = scalar[threadIdx.x];
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    on[c] = on_s[c];
    s[c] = s_s[c];
    any |= on[c] != 0;
  }
  return any;
}

// The block's sum of acc, column by column: a shuffle tree within each warp,
// then the warps in order. Thread j < R returns column j's sum.
template <int R>
__device__ __forceinline__ float block_sum(const float (&acc)[R]) {
  __shared__ float warp_sums[kWarps][R];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) warp_sums[warp][c] = v;
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < R) {
    s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_sums[w][threadIdx.x]);
  }
  return s;
}

// Publishes the block's sums s (thread j < R: column j) to partials and
// takes a ticket: true in the last block of the grid to do so, whose
// threads then see every block's partials.
template <int R>
__device__ __forceinline__ bool last_block(float s, float* partials, unsigned* ticket) {
  __shared__ bool last;
  if (threadIdx.x < R) {
    partials[blockIdx.x * R + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// In the last block: the grid's sum of each column (thread j < R: column
// j), the partials taken in block order; sets the ticket back to 0.
template <int R>
__device__ __forceinline__ float grid_sum(const float* partials, unsigned* ticket) {
  __threadfence();
  float acc[R];
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = __fadd_rn(acc[c], __ldcg(partials + b * R + c));
  }
  if (threadIdx.x == 0) *ticket = 0u;
  return block_sum<R>(acc);
}

// cg_body_pap: the mask, p·ap per column, and alpha where on.
template <int R>
__global__ void __launch_bounds__(kThreads)
cg_pap_kernel(const float* __restrict__ P, const float* __restrict__ AP,
              const float* rs, const int* k, const float* tol2, const long long* kmax,
              float* partials, unsigned* ticket, int* mask, float* alpha,
              long long units, int tail_rows) {
  __shared__ int on[R];
  if (threadIdx.x < R) {
    const int j = threadIdx.x;
    on[j] = rs[j] > tol2[j] && static_cast<long long>(k[j]) < *kmax;
    if (blockIdx.x == 0) mask[j] = on[j];
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int c = 0; c < R; ++c) any |= on[c] != 0;
  if (!any) return;  // every block reads the same state: none takes a ticket

  float acc[R];
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       u < units; u += stride) {
    float p[Unit<R>::kFloats], ap[Unit<R>::kFloats];
    load_unit<R>(P, u, p);
    load_unit<R>(AP, u, ap);
#pragma unroll
    for (int i = 0; i < Unit<R>::kFloats; ++i) {
      acc[i % R] = __fadd_rn(acc[i % R], __fmul_rn(p[i], ap[i]));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail_rows) {
    const long long e = (units * Unit<R>::kRows + threadIdx.x) * R;
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(P[e + c], AP[e + c]));
  }
  const float s = block_sum<R>(acc);
  if (!last_block<R>(s, partials, ticket)) return;
  const float pap = grid_sum<R>(partials, ticket);
  if (threadIdx.x < R && on[threadIdx.x]) {
    alpha[threadIdx.x] = __fdiv_rn(rs[threadIdx.x], pap);
  }
}

// cg_body_xr: x += alpha·p, r -= alpha·ap where on; r·r per column; the
// last block writes beta, rs and k where on.
template <int R>
__global__ void __launch_bounds__(kThreads)
cg_xr_kernel(float* __restrict__ X, float* __restrict__ Rv, const float* __restrict__ P,
             const float* __restrict__ AP, float* rs, int* k, const int* mask,
             const float* alpha, float* beta, float* partials, unsigned* ticket,
             long long units, int tail_rows) {
  int on[R];
  float a[R];
  if (!load_columns<R>(mask, alpha, on, a)) return;

  float acc[R];
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       u < units; u += stride) {
    float x[Unit<R>::kFloats], r[Unit<R>::kFloats], p[Unit<R>::kFloats],
        ap[Unit<R>::kFloats];
    load_unit<R>(X, u, x);
    load_unit<R>(Rv, u, r);
    load_unit<R>(P, u, p);
    load_unit<R>(AP, u, ap);
#pragma unroll
    for (int i = 0; i < Unit<R>::kFloats; ++i) {
      const int c = i % R;
      if (on[c]) {
        x[i] = __fadd_rn(x[i], __fmul_rn(a[c], p[i]));
        r[i] = __fsub_rn(r[i], __fmul_rn(a[c], ap[i]));
      }
      acc[c] = __fadd_rn(acc[c], __fmul_rn(r[i], r[i]));
    }
    store_unit<R>(X, u, x);
    store_unit<R>(Rv, u, r);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail_rows) {
    const long long e = (units * Unit<R>::kRows + threadIdx.x) * R;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      if (on[c]) {
        X[e + c] = __fadd_rn(X[e + c], __fmul_rn(a[c], P[e + c]));
        Rv[e + c] = __fsub_rn(Rv[e + c], __fmul_rn(a[c], AP[e + c]));
      }
      const float rc = Rv[e + c];
      acc[c] = __fadd_rn(acc[c], __fmul_rn(rc, rc));
    }
  }
  const float s = block_sum<R>(acc);
  if (!last_block<R>(s, partials, ticket)) return;
  const float rr = grid_sum<R>(partials, ticket);
  if (threadIdx.x < R && on[threadIdx.x]) {
    const int j = threadIdx.x;
    beta[j] = __fdiv_rn(rr, rs[j]);
    rs[j] = rr;
    k[j] += 1;
  }
}

// cg_body_p: p = r + beta·p where on.
template <int R>
__global__ void __launch_bounds__(kThreads)
cg_p_kernel(const float* __restrict__ Rv, float* __restrict__ P, const int* mask,
            const float* beta, long long units, int tail_rows) {
  int on[R];
  float b[R];
  if (!load_columns<R>(mask, beta, on, b)) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       u < units; u += stride) {
    float r[Unit<R>::kFloats], p[Unit<R>::kFloats];
    load_unit<R>(Rv, u, r);
    load_unit<R>(P, u, p);
#pragma unroll
    for (int i = 0; i < Unit<R>::kFloats; ++i) {
      const int c = i % R;
      if (on[c]) p[i] = __fadd_rn(r[i], __fmul_rn(b[c], p[i]));
    }
    store_unit<R>(P, u, p);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail_rows) {
    const long long e = (units * Unit<R>::kRows + threadIdx.x) * R;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      if (on[c]) P[e + c] = __fadd_rn(Rv[e + c], __fmul_rn(b[c], P[e + c]));
    }
  }
}

// The launch shape for n rows of R: whole units, the rows past them, and a
// grid of at most `blocks` blocks (at least one, which takes those rows).
struct Shape {
  long long units;
  int tail_rows;
  int grid;
};

template <int R>
Shape shape(int n, int blocks) {
  const long long units = n / Unit<R>::kRows;
  const long long want = (units + kThreads - 1) / kThreads;
  return {units, static_cast<int>(n % Unit<R>::kRows),
          static_cast<int>(std::max(1LL, std::min(want, static_cast<long long>(blocks))))};
}

}  // namespace

#define CG_BODY_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

extern "C" {

// cg_body_pap on P and AP of n rows of rhs floats (rs, k, tol2: rhs
// entries; kmax one int64), at most `blocks` blocks, partials of
// blocks·rhs floats. Refuses (cudaErrorInvalidValue) n < 1, blocks < 1
// or rhs outside 1..8.
int cg_body_pap(const void* P, const void* AP, const void* rs, const void* k,
                const void* tol2, const void* kmax, void* partials, void* ticket,
                void* mask, void* alpha, int n, int rhs, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rhs) {
#define PAP_CASE(R)                                                                   \
  case R: {                                                                           \
    const Shape sh = shape<R>(n, blocks);                                             \
    cg_pap_kernel<R><<<sh.grid, kThreads, 0, s>>>(                                    \
        static_cast<const float*>(P), static_cast<const float*>(AP),                  \
        static_cast<const float*>(rs), static_cast<const int*>(k),                    \
        static_cast<const float*>(tol2), static_cast<const long long*>(kmax),         \
        static_cast<float*>(partials), static_cast<unsigned*>(ticket),                \
        static_cast<int*>(mask), static_cast<float*>(alpha), sh.units, sh.tail_rows); \
    break;                                                                            \
  }
    CG_BODY_CASES(PAP_CASE)
#undef PAP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// cg_body_xr on X, R, P and AP of n rows of rhs floats, after cg_body_pap
// with the same n, rhs and blocks (its mask, alpha, partials and ticket).
int cg_body_xr(void* X, void* Rv, const void* P, const void* AP, void* rs, void* k,
               const void* mask, const void* alpha, void* beta, void* partials,
               void* ticket, int n, int rhs, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rhs) {
#define XR_CASE(R)                                                                       \
  case R: {                                                                              \
    const Shape sh = shape<R>(n, blocks);                                                \
    cg_xr_kernel<R><<<sh.grid, kThreads, 0, s>>>(                                        \
        static_cast<float*>(X), static_cast<float*>(Rv), static_cast<const float*>(P),   \
        static_cast<const float*>(AP), static_cast<float*>(rs), static_cast<int*>(k),    \
        static_cast<const int*>(mask), static_cast<const float*>(alpha),                 \
        static_cast<float*>(beta), static_cast<float*>(partials),                        \
        static_cast<unsigned*>(ticket), sh.units, sh.tail_rows);                         \
    break;                                                                               \
  }
    CG_BODY_CASES(XR_CASE)
#undef XR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// cg_body_p on R and P of n rows of rhs floats, after cg_body_xr (its
// beta; cg_body_pap's mask).
int cg_body_p(const void* Rv, void* P, const void* mask, const void* beta, int n,
              int rhs, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rhs) {
#define P_CASE(R)                                                                      \
  case R: {                                                                            \
    const Shape sh = shape<R>(n, blocks);                                              \
    cg_p_kernel<R><<<sh.grid, kThreads, 0, s>>>(                                       \
        static_cast<const float*>(Rv), static_cast<float*>(P),                         \
        static_cast<const int*>(mask), static_cast<const float*>(beta), sh.units,      \
        sh.tail_rows);                                                                 \
    break;                                                                             \
  }
    CG_BODY_CASES(P_CASE)
#undef P_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
