// Variants of kernel #1 (submax) timed against the package's kernel
// (skrx_torch/ops/kernels/csrc/topk_blocks.cu: 256 threads a (row, column
// block), a thread's first 8 mask ids and then its 16 columns loaded into
// registers before the mask scan). It is not part of the package;
// experiments/submax_variants.py builds it and times each variant against
// the package's kernel on one card, and PERF.md says how they fared. Each
// launcher has skrx_submax's C signature and computes its function bit for
// bit: out[b, j*128 + l] = the max of the masked columns l + 128 t of
// column block j, as jnp.maximum folds them (NaN when the group holds one,
// -0.0 below +0.0).
//
//   skrx_submax_scores_first  the scores loaded first and the mask ids
//                             only in the scan, as the design was first
//                             built: the scan's loads wait behind the
//                             scores';
//   skrx_submax_bounds6       scores_first held to 6 blocks an SM
//                             (__launch_bounds__(256, 6): 40 registers),
//                             so the evaluation batch's 704 blocks fit one
//                             wave on 132 SMs where 5 an SM leave 44 for a
//                             second;
//   skrx_submax_staged        the block's scores copied into shared memory
//                             by cp.async (4 bytes a column: rows are not
//                             16-byte aligned) before the mask scan, so no
//                             register holds them while it waits: 8 blocks
//                             an SM.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxBlockN = 4096;
constexpr int kMaskWords = kMaxBlockN / 32;
constexpr int kThreads = 256;
constexpr int kCols = kMaxBlockN / kThreads;
constexpr int kMaskBatch = 8;

__device__ __forceinline__ int order_key(int i) {
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ int max_key(float v) {
  const int i = __float_as_int(v);
  return (i & 0x7FFFFFFF) > 0x7F800000 ? INT_MAX : order_key(i);
}

__device__ __forceinline__ bool is_masked(const unsigned* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

__device__ __forceinline__ void scan_mask_bits(unsigned* bits,
                                               const int* __restrict__ mask_row,
                                               int L, int lo, int width) {
  for (int w = threadIdx.x; w < kMaskWords; w += kThreads) bits[w] = 0u;
  __syncthreads();
  for (int e0 = threadIdx.x; e0 < L; e0 += kMaskBatch * kThreads) {
    int id[kMaskBatch];
#pragma unroll
    for (int u = 0; u < kMaskBatch; ++u) {
      const int e = e0 + u * kThreads;
      id[u] = e < L ? __ldg(mask_row + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < kMaskBatch; ++u) {
      const long long rel = (long long)id[u] - lo;
      if (rel >= 0 && rel < width) atomicOr(&bits[rel >> 5], 1u << (rel & 31));
    }
  }
}

// the group max of threads t and t + 128, written by thread t
__device__ __forceinline__ void write_group(int m, int* upper, float* out) {
  const int tid = threadIdx.x;
  if (tid >= kLanes) upper[tid - kLanes] = m;
  __syncthreads();
  if (tid < kLanes) out[tid] = __int_as_float(order_key(max(m, upper[tid])));
}

template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
submax_registers_kernel(const float* __restrict__ scores, int n, int block_n,
                        const int* __restrict__ mask, int L,
                        float* __restrict__ out, int out_w) {
  __shared__ unsigned bits[kMaskWords];
  __shared__ int upper[kLanes];
  const long long b = blockIdx.x;
  const int j = blockIdx.y;
  const int lo = j * block_n;
  const int width = min(block_n, n - lo);
  const int tid = threadIdx.x;
  const float* row = scores + b * n + lo;
  float v[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = tid + kThreads * q;
    v[q] = c < width ? __ldg(row + c) : -INFINITY;
  }
  if (mask != nullptr) {
    scan_mask_bits(bits, mask + b * L, L, lo, width);
    __syncthreads();
  }
  int m = order_key(__float_as_int(-INFINITY));
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    if (mask == nullptr || !is_masked(bits, tid + kThreads * q))
      m = max(m, max_key(v[q]));
  write_group(m, upper, out + b * out_w + (long long)j * kLanes);
}

__global__ void __launch_bounds__(kThreads, 8)
submax_staged_kernel(const float* __restrict__ scores, int n, int block_n,
                     const int* __restrict__ mask, int L,
                     float* __restrict__ out, int out_w) {
  __shared__ float sv[kMaxBlockN];
  __shared__ unsigned bits[kMaskWords];
  __shared__ int upper[kLanes];
  const long long b = blockIdx.x;
  const int j = blockIdx.y;
  const int lo = j * block_n;
  const int width = min(block_n, n - lo);
  const int tid = threadIdx.x;
  const float* row = scores + b * n + lo;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = tid + kThreads * q;
    if (c < width) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(sv + c);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                   "l"(row + c));
    }
  }
  asm volatile("cp.async.commit_group;");
  if (mask != nullptr) scan_mask_bits(bits, mask + b * L, L, lo, width);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  int m = order_key(__float_as_int(-INFINITY));
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = tid + kThreads * q;
    if (c < width && (mask == nullptr || !is_masked(bits, c)))
      m = max(m, max_key(sv[c]));
  }
  write_group(m, upper, out + b * out_w + (long long)j * kLanes);
}

}  // namespace

extern "C" {

int skrx_submax_bounds6(const float* scores, int b, int n, int block_n,
                        const int* mask, int L, float* out,
                        cudaStream_t stream) {
  const int n_blocks = (n + block_n - 1) / block_n;
  submax_registers_kernel<6><<<dim3(b, n_blocks), kThreads, 0, stream>>>(
      scores, n, block_n, mask, L, out, n_blocks * kLanes);
  return (int)cudaGetLastError();
}

int skrx_submax_staged(const float* scores, int b, int n, int block_n,
                       const int* mask, int L, float* out,
                       cudaStream_t stream) {
  const int n_blocks = (n + block_n - 1) / block_n;
  submax_staged_kernel<<<dim3(b, n_blocks), kThreads, 0, stream>>>(
      scores, n, block_n, mask, L, out, n_blocks * kLanes);
  return (int)cudaGetLastError();
}

int skrx_submax_scores_first(const float* scores, int b, int n,
                             int block_n, const int* mask, int L, float* out,
                             cudaStream_t stream) {
  const int n_blocks = (n + block_n - 1) / block_n;
  submax_registers_kernel<1><<<dim3(b, n_blocks), kThreads, 0, stream>>>(
      scores, n, block_n, mask, L, out, n_blocks * kLanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
