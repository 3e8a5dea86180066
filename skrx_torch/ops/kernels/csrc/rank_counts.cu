// Rank counting for full-catalog evaluation, written by hand for Hopper
// (sm_90a). Port of the three Pallas kernels of
// skrx/ops/pallas/topk_blocks.py that evaluation runs:
//
//   skrx_rank_count         <- _rank_count_kernel         (topk_blocks.py:815),
//                              the tail of masked_topk_ranks
//   skrx_rank_lookup_count  <- _rank_lookup_count_kernel  (topk_blocks.py:872),
//                              the tail of dot_topk_ranks (fused evaluation)
//   skrx_direct_rank        <- _direct_rank_kernel        (topk_blocks.py:935),
//                              behind masked_topk_ranks_small
//
// All count, for each probe (score s, id t) of a row, the row's elements
// (v, i) with v > s or (v == s and i < t): the probe's 0-based position in
// the row's (value desc, id asc) order. The TPU kernels take at most 128
// probes (one unrolled round each, lane-padded); here any number: one thread
// owns one probe and keeps its count in a register, and the block walks the
// row in shared-memory tiles that all its threads read by broadcast. Grid
// (B, ceil(T / 128)), so a batch of 64 rows with a few hundred probes each
// still fills the card.
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the wrappers in ../topk_blocks.py check shapes, types
// and devices, allocate the outputs and count launches.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;   // probes per block
constexpr int kTile = 2048;     // row elements staged per round

// Replaces _rank_count_kernel. Counts over a (B, W) candidate set with the
// probes' scores given. Bound: operations (one lexicographic compare and an
// add per (probe, candidate) pair, from shared memory); the bytes are the
// candidates, read once per probe block, and the probes.
__global__ void __launch_bounds__(kThreads)
rank_count_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                  int w, const float* __restrict__ st,
                  const int* __restrict__ tid, int t_count,
                  int* __restrict__ out) {
  __shared__ float sv[kTile];
  __shared__ int si[kTile];
  const long long b = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const bool has = p < t_count;
  const float s = has ? st[b * t_count + p] : 0.f;
  const int t = has ? tid[b * t_count + p] : 0;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  int cnt = 0;
  for (int lo = 0; lo < w; lo += kTile) {
    const int width = min(kTile, w - lo);
    for (int e = threadIdx.x; e < width; e += kThreads) {
      sv[e] = __ldg(rv + lo + e);
      si[e] = __ldg(ri + lo + e);
    }
    __syncthreads();
    if (has) {
#pragma unroll 8
      for (int e = 0; e < width; ++e) {
        const float v = sv[e];
        cnt += (v > s) | ((v == s) & (si[e] < t));
      }
    }
    __syncthreads();
  }
  if (has) out[b * t_count + p] = cnt;
}

// Replaces _rank_lookup_count_kernel. As rank_count_kernel, but the probe
// arrives as an id alone: its score is looked up among the row's candidates
// (the max value over the lanes that hold its id; -inf when none does), so
// the fused route never recomputes a score outside its kernels. Two walks
// over the candidate tiles: the lookup, then the count. found = the
// looked-up score is finite; a probe whose id is masked, out of range or
// padding is among no candidates and is not found. Bound: operations (two
// compares per (probe, candidate) pair in each walk).
__global__ void __launch_bounds__(kThreads)
rank_lookup_count_kernel(const float* __restrict__ vals,
                         const int* __restrict__ ids, int w,
                         const int* __restrict__ tid, int t_count,
                         int* __restrict__ out, bool* __restrict__ found) {
  __shared__ float sv[kTile];
  __shared__ int si[kTile];
  const long long b = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const bool has = p < t_count;
  const int t = has ? tid[b * t_count + p] : 0;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  float s = -INFINITY;
  int cnt = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int lo = 0; lo < w; lo += kTile) {
      const int width = min(kTile, w - lo);
      for (int e = threadIdx.x; e < width; e += kThreads) {
        sv[e] = __ldg(rv + lo + e);
        si[e] = __ldg(ri + lo + e);
      }
      __syncthreads();
      if (has && pass == 0) {
#pragma unroll 8
        for (int e = 0; e < width; ++e) {
          if (si[e] == t) s = fmaxf(s, sv[e]);
        }
      } else if (has) {
#pragma unroll 8
        for (int e = 0; e < width; ++e) {
          const float v = sv[e];
          cnt += (v > s) | ((v == s) & (si[e] < t));
        }
      }
      __syncthreads();
    }
  }
  if (has) {
    out[b * t_count + p] = cnt;
    found[b * t_count + p] = isfinite(s);
  }
}

// Replaces _direct_rank_kernel. Counts over the whole masked score row, so
// the rank is exact at any depth. A probe's score is the row's score at its
// id; an id out of [0, n) or in the row's (B, L) mask table, or a score
// that is not finite, makes the probe miss and its rank k. The row is tiled:
// per tile the block builds a shared-memory bitmap of the masked columns
// from the mask row (ids outside the tile, padding included, are ignored)
// and stages the scores with masked columns at -inf, which never count
// above a finite probe. Bound: operations (T compares per score); the bytes
// are one read of the scores and of the mask row per probe block.
__global__ void __launch_bounds__(kThreads)
direct_rank_kernel(const float* __restrict__ scores, int n,
                   const int* __restrict__ mask, int L,
                   const int* __restrict__ tid, int t_count, int k,
                   int* __restrict__ out) {
  __shared__ float sv[kTile];
  __shared__ int sm[kTile];
  __shared__ unsigned bits[kTile / 32];
  const long long b = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const bool has = p < t_count;
  const int t = has ? tid[b * t_count + p] : -1;
  const float* row = scores + b * n;
  const int* mrow = mask + b * L;   // L == 0 without a mask
  // is the probe's id in the mask row? (unsorted, duplicates allowed)
  bool masked = false;
  for (int lo = 0; lo < L; lo += kTile) {
    const int width = min(kTile, L - lo);
    for (int e = threadIdx.x; e < width; e += kThreads) sm[e] = __ldg(mrow + lo + e);
    __syncthreads();
    if (has) {
      for (int e = 0; e < width; ++e) masked |= sm[e] == t;
    }
    __syncthreads();
  }
  const float s = (has && t >= 0 && t < n && !masked) ? __ldg(row + t) : -INFINITY;
  const bool valid = isfinite(s);
  int cnt = 0;
  if (__syncthreads_or(valid)) {
    for (int lo = 0; lo < n; lo += kTile) {
      const int width = min(kTile, n - lo);
      for (int e = threadIdx.x; e < kTile / 32; e += kThreads) bits[e] = 0u;
      __syncthreads();
      for (int e = threadIdx.x; e < L; e += kThreads) {
        const long long rel = (long long)__ldg(mrow + e) - lo;
        if (rel >= 0 && rel < width) atomicOr(&bits[rel >> 5], 1u << (rel & 31));
      }
      __syncthreads();
      for (int c = threadIdx.x; c < width; c += kThreads) {
        sv[c] = ((bits[c >> 5] >> (c & 31)) & 1u) ? -INFINITY : __ldg(row + lo + c);
      }
      __syncthreads();
      if (valid) {
        const int rel_t = t - lo;   // column c of the tile ranks before t iff c < rel_t
#pragma unroll 8
        for (int c = 0; c < width; ++c) {
          const float v = sv[c];
          cnt += (v > s) | ((v == s) & (c < rel_t));
        }
      }
      __syncthreads();
    }
  }
  if (has) out[b * t_count + p] = valid ? cnt : k;
}

}  // namespace

extern "C" {

int skrx_rank_counts_abi_version() { return 1; }

int skrx_rank_count(const float* vals, const int* ids, int b, int w,
                    const float* st, const int* tid, int t, int* out,
                    cudaStream_t stream) {
  const dim3 grid(b, (t + kThreads - 1) / kThreads);
  rank_count_kernel<<<grid, kThreads, 0, stream>>>(vals, ids, w, st, tid, t, out);
  return (int)cudaGetLastError();
}

int skrx_rank_lookup_count(const float* vals, const int* ids, int b, int w,
                           const int* tid, int t, int* out, bool* found,
                           cudaStream_t stream) {
  const dim3 grid(b, (t + kThreads - 1) / kThreads);
  rank_lookup_count_kernel<<<grid, kThreads, 0, stream>>>(vals, ids, w, tid, t,
                                                           out, found);
  return (int)cudaGetLastError();
}

int skrx_direct_rank(const float* scores, int b, int n, const int* mask, int L,
                     const int* tid, int t, int k, int* out,
                     cudaStream_t stream) {
  const dim3 grid(b, (t + kThreads - 1) / kThreads);
  direct_rank_kernel<<<grid, kThreads, 0, stream>>>(scores, n, mask, L, tid, t,
                                                     k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
