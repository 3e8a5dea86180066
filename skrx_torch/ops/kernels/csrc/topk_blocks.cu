// Blockwise exact top-k over a (B, N) f32 score matrix, written by hand for
// Hopper (sm_90a). Port of the four Pallas kernels of
// skrx/ops/pallas/topk_blocks.py that serving runs (blockwise_topk):
//
//   skrx_submax        <- _submax_kernel        (topk_blocks.py:488)
//   skrx_kth_largest   <- _kth_largest_kernel   (topk_blocks.py:224)
//   skrx_extract       <- _extract_kernel       (topk_blocks.py:601)
//   skrx_pruned_merge  <- _pruned_merge_kernel  (topk_blocks.py:295)
//
// Each kernel computes the JAX function's contract, not its TPU layout:
// ties rank by (value desc, id asc), an empty top-k slot is (-inf,
// INT_MAX / 2). Masking of seen items is fused: a block turns its row's
// (B, L) id table into a shared-memory bitmask of its column block, so the
// score matrix is neither copied nor written.
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the Python wrappers in ../topk_blocks.py check
// shapes, types and devices, allocate the outputs and count launches.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kLanes = 128;                   // strided groups per block
constexpr int kMaxBlockN = 4096;              // widest column block
constexpr int kMaskWords = kMaxBlockN / 32;
constexpr int kSentinel = INT_MAX / 2;        // id of an empty slot
constexpr int kKthWarps = 4;                  // rows a block of kth_largest
constexpr int kKthSums = 8;                   // independent counts a lane
constexpr int kExtractThreads = 256;
constexpr int kMergeThreads = 128;

struct Pair {
  float v;
  int id;
};

// true when (av, aid) ranks before (bv, bid): value desc, then id asc
__device__ __forceinline__ bool before(float av, int aid, float bv, int bid) {
  return av > bv || (av == bv && aid < bid);
}

__device__ __forceinline__ Pair better(Pair a, Pair b) {
  return before(b.v, b.id, a.v, a.id) ? b : a;
}

__device__ __forceinline__ Pair warp_best(Pair p) {
  for (int off = 16; off > 0; off >>= 1) {
    Pair o;
    o.v = __shfl_xor_sync(0xffffffffu, p.v, off);
    o.id = __shfl_xor_sync(0xffffffffu, p.id, off);
    p = better(p, o);
  }
  return p;
}

// Best pair of the block, returned to every thread. sh holds 33 pairs.
__device__ Pair block_best(Pair p, Pair* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  p = warp_best(p);
  if (lane == 0) sh[wid] = p;
  __syncthreads();
  if (wid == 0) {
    Pair q = lane < (int)(blockDim.x >> 5) ? sh[lane] : Pair{-INFINITY, INT_MAX};
    q = warp_best(q);
    if (lane == 0) sh[32] = q;
  }
  __syncthreads();
  const Pair r = sh[32];
  __syncthreads();
  return r;
}

// Bit c of bits = 1 when column lo + c of this row is in its mask row.
// Ids outside [lo, lo + width) (other blocks, padding, out of range) are
// ignored; duplicates are harmless. Ends with a barrier.
__device__ void load_mask_bits(unsigned* bits, const int* __restrict__ mask_row,
                               int L, int lo, int width) {
  for (int w = threadIdx.x; w < kMaskWords; w += blockDim.x) bits[w] = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < L; e += blockDim.x) {
    const long long rel = (long long)mask_row[e] - lo;
    if (rel >= 0 && rel < width) atomicOr(&bits[rel >> 5], 1u << (rel & 31));
  }
  __syncthreads();
}

__device__ __forceinline__ bool is_masked(const unsigned* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// Order-preserving f32 -> int32 map of the JAX kernel: -inf lowest, -0.0
// below +0.0; an involution, so it also maps back.
__device__ __forceinline__ int order_key(int i) {
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

// Replaces _submax_kernel. Grid (B, column blocks), one thread per strided
// group: thread l of block j takes the max of columns j*block_n + l + 128*t
// of the masked row. The 128 threads read 512 contiguous bytes per step.
// Bound: bytes (one read of the scores and the mask table, B x 128 maxima
// per block written); one compare per element.
__global__ void __launch_bounds__(kLanes)
submax_kernel(const float* __restrict__ scores, int n, int block_n,
              const int* __restrict__ mask, int L, float* __restrict__ out,
              int out_w) {
  __shared__ unsigned bits[kMaskWords];
  const long long b = blockIdx.x;
  const int j = blockIdx.y;
  const int lo = j * block_n;
  const int width = min(block_n, n - lo);
  const float* row = scores + b * n + lo;
  if (mask != nullptr) load_mask_bits(bits, mask + b * L, L, lo, width);
  float m = -INFINITY;
#pragma unroll 8
  for (int c = threadIdx.x; c < width; c += kLanes) {
    const float v = __ldg(row + c);
    if (mask == nullptr || !is_masked(bits, c)) m = fmaxf(m, v);
  }
  out[b * out_w + (long long)j * kLanes + threadIdx.x] = m;
}

// Replaces _kth_largest_kernel. One warp per row, kKthWarps rows a block:
// 32 rounds of bitwise bisection over the order keys as the JAX kernel runs
// them (the sign, then bits 30..0), each a count of the row's keys >= the
// candidate, summed over the warp by one redux.sync, so no round waits on a
// block barrier. A warp alone on its scheduler is bound by its latency, so
// a lane counts into kKthSums independent sums, not one serial chain. With
// KPL > 0 the row's keys sit in registers, KPL a lane (key i of lane l is
// element l + 32 i; slots past W hold INT_MIN, the key of no float but a
// NaN, below every candidate, so they are never counted); with KPL = 0
// (rows wider than 32 * 128) each round reads the row again from L1 / L2.
// Bit-identical to the JAX kernel: any exact selection returns the same
// key. Bound: bytes of the (B, W) read; 33 compares per element.
template <int KPL>
__global__ void __launch_bounds__(kKthWarps * 32)
kth_largest_kernel(const float* __restrict__ vals, int b, int w, int k,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kKthWarps + (threadIdx.x >> 5);
  if (r >= b) return;                       // the whole warp
  const int* row = reinterpret_cast<const int*>(vals) + r * w;
  int key[KPL > 0 ? KPL : 1];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int c = lane + 32 * i;
    key[i] = c < w ? order_key(__ldg(row + c)) : INT_MIN;
  }
  auto count = [&](int cand) {
    int cnt[kKthSums] = {};
    if constexpr (KPL > 0) {
#pragma unroll
      for (int i = 0; i < KPL; ++i) cnt[i % kKthSums] += key[i] >= cand;
    } else {
      for (int c = lane; c < w; c += 32 * kKthSums) {
#pragma unroll
        for (int u = 0; u < kKthSums; ++u)
          if (c + 32 * u < w) cnt[u] += order_key(__ldg(row + c + 32 * u)) >= cand;
      }
    }
    int total = 0;
#pragma unroll
    for (int u = 0; u < kKthSums; ++u) total += cnt[u];
    return __reduce_add_sync(0xffffffffu, total);
  };
  int cur = count(0) >= k ? 0 : INT_MIN;
  for (int bit = 30; bit >= 0; --bit) {
    const int cand = cur | (1 << bit);
    if (count(cand) >= k) cur = cand;
  }
  if (lane == 0) out[r] = __int_as_float(order_key(cur));
}

// Replaces _extract_kernel. Grid (B, column blocks). A block gathers the
// finite masked elements >= tau of its column block into shared memory
// (usually a handful: tau is the k-th largest group max), then emits its
// block-local top-min(k, found) by (value desc, column asc) with one
// block-wide argmax round per output; the rest of its k slots get
// (-inf, sentinel). Every element of the row's top-k is >= tau and in its
// block's top-k, so the (B, n_blocks * k) output is a superset of it, each
// element at most once. Bound: bytes (one read of the scores and mask table,
// the candidates written); a tie storm costs k rounds over the block.
__global__ void __launch_bounds__(kExtractThreads)
extract_kernel(const float* __restrict__ scores, int n, int block_n,
               const int* __restrict__ mask, int L,
               const float* __restrict__ tau, int k,
               float* __restrict__ out_v, int* __restrict__ out_i, int out_w) {
  __shared__ unsigned bits[kMaskWords];
  __shared__ float sv[kMaxBlockN];
  __shared__ int si[kMaxBlockN];
  __shared__ Pair sh[33];
  __shared__ int found_sh;
  const long long b = blockIdx.x;
  const int j = blockIdx.y;
  const int lo = j * block_n;
  const int width = min(block_n, n - lo);
  const float* row = scores + b * n + lo;
  if (threadIdx.x == 0) found_sh = 0;
  if (mask != nullptr) load_mask_bits(bits, mask + b * L, L, lo, width);
  __syncthreads();
  const float t = tau[b];
#pragma unroll 4
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    const float v = __ldg(row + c);
    if (v >= t && v != -INFINITY && (mask == nullptr || !is_masked(bits, c))) {
      const int p = atomicAdd(&found_sh, 1);
      sv[p] = v;
      si[p] = c;
    }
  }
  __syncthreads();
  const int found = found_sh;
  const int rounds = min(k, found);
  float* ov = out_v + b * out_w + (long long)j * k;
  int* oi = out_i + b * out_w + (long long)j * k;
  Pair prev{INFINITY, -1};
  for (int r = 0; r < rounds; ++r) {
    Pair best{-INFINITY, INT_MAX};
    for (int e = threadIdx.x; e < found; e += blockDim.x) {
      const Pair p{sv[e], si[e]};
      if (r == 0 || before(prev.v, prev.id, p.v, p.id)) best = better(best, p);
    }
    best = block_best(best, sh);
    if (threadIdx.x == 0) {
      ov[r] = best.v;
      oi[r] = lo + best.id;
    }
    prev = best;
  }
  for (int r = rounds + threadIdx.x; r < k; r += blockDim.x) {
    ov[r] = -INFINITY;
    oi[r] = kSentinel;
  }
}

// Replaces _pruned_merge_kernel (and, with tau = -inf, _vmem_topk_kernel).
// One block per row: round r takes the best (value, id) pair >= tau that
// ranks strictly after round r-1's pick, so a pair repeated across lanes is
// taken once; the first -inf pick ends the row and the remaining slots get
// (-inf, sentinel). Bound: bytes of the (B, W) candidates; k compares per
// lane, from L1 (W is n_blocks * k, a few hundred lanes on the serving path).
__global__ void __launch_bounds__(kMergeThreads)
pruned_merge_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                    int w, const float* __restrict__ tau, int k,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ Pair sh[33];
  const long long b = blockIdx.x;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  const float t = tau[b];
  float* ov = out_v + b * k;
  int* oi = out_i + b * k;
  Pair prev{INFINITY, INT_MIN};
  int r = 0;
  for (; r < k; ++r) {
    Pair best{-INFINITY, INT_MAX};
    for (int e = threadIdx.x; e < w; e += blockDim.x) {
      const Pair p{__ldg(rv + e), __ldg(ri + e)};
      if (p.v >= t && (r == 0 || before(prev.v, prev.id, p.v, p.id))) best = better(best, p);
    }
    best = block_best(best, sh);
    if (best.v == -INFINITY) break;
    if (threadIdx.x == 0) {
      ov[r] = best.v;
      oi[r] = best.id;
    }
    prev = best;
  }
  for (int q = r + threadIdx.x; q < k; q += blockDim.x) {
    ov[q] = -INFINITY;
    oi[q] = kSentinel;
  }
}

}  // namespace

extern "C" {

int skrx_topk_abi_version() { return 1; }

int skrx_submax(const float* scores, int b, int n, int block_n, const int* mask,
                int L, float* out, cudaStream_t stream) {
  const int n_blocks = (n + block_n - 1) / block_n;
  submax_kernel<<<dim3(b, n_blocks), kLanes, 0, stream>>>(
      scores, n, block_n, mask, L, out, n_blocks * kLanes);
  return (int)cudaGetLastError();
}

// Keys a lane holds in registers: the smallest instantiation whose 32 * KPL
// slots hold the row, else 0 (the row read each round).
int skrx_kth_largest(const float* vals, int b, int w, int k, float* out,
                     cudaStream_t stream) {
  const int blocks = (b + kKthWarps - 1) / kKthWarps;
#define SKRX_KTH(KPL_)                                                        \
  kth_largest_kernel<KPL_><<<blocks, kKthWarps * 32, 0, stream>>>(vals, b, w, \
                                                                 k, out)
  if (w <= 32 * 8) SKRX_KTH(8);
  else if (w <= 32 * 16) SKRX_KTH(16);
  else if (w <= 32 * 48) SKRX_KTH(48);
  else if (w <= 32 * 128) SKRX_KTH(128);
  else SKRX_KTH(0);
#undef SKRX_KTH
  return (int)cudaGetLastError();
}

int skrx_extract(const float* scores, int b, int n, int block_n, const int* mask,
                 int L, const float* tau, int k, float* out_v, int* out_i,
                 cudaStream_t stream) {
  const int n_blocks = (n + block_n - 1) / block_n;
  extract_kernel<<<dim3(b, n_blocks), kExtractThreads, 0, stream>>>(
      scores, n, block_n, mask, L, tau, k, out_v, out_i, n_blocks * k);
  return (int)cudaGetLastError();
}

int skrx_pruned_merge(const float* vals, const int* ids, int b, int w,
                      const float* tau, int k, float* out_v, int* out_i,
                      cudaStream_t stream) {
  pruned_merge_kernel<<<b, kMergeThreads, 0, stream>>>(vals, ids, w, tau, k,
                                                        out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
