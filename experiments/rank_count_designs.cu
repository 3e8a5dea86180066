// Experimental designs of kernel #6 (rank_count) that lost to the
// package's kernel (skrx_torch/ops/kernels/csrc/rank_counts.cu: packed
// keys, runs of equal adjacent keys counted once). It is not part of the
// package; experiments/rank_count_designs.py builds it and times each
// design against the package's kernel on one card, and PERF.md says how
// they fared. Each launcher has skrx_rank_count's C signature and computes
// its function bit for bit: for each probe (s, t) of a row, the row's
// candidates (v, i) with v > s, or v == s and i < t, as floats and signed
// ints, by the packed key of the package (candidate before probe exactly
// when rank_key(c) < rank_probe_key(p) as unsigned 64-bit integers).
//
//   skrx_rank_count_linear  design (1) as first measured: every candidate
//                           key staged in shared memory, 4 probe keys a
//                           lane, 8 warps splitting each 2,048-key tile;
//   skrx_rank_count_sorted  design (2): one block a row sorts each tile's
//                           keys (bitonic, in shared memory, padded with
//                           the largest key), then a lower-bound search a
//                           probe;
//   skrx_rank_count_runs    design (3): as linear, but a tile of at most
//                           128 ascending runs (extract's column blocks are
//                           sorted) counts each probe by a lower-bound search
//                           in every run.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTile = 2048;
constexpr int kProbes = 4;                 // probe keys a lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockProbes = 32 * kProbes;
constexpr int kMaxRuns = 128;

__device__ __forceinline__ unsigned long long rank_key(float v, int id) {
  unsigned u = __float_as_uint(v);
  const unsigned mag = u & 0x7FFFFFFFu;
  if (mag > 0x7F800000u) return ~0ull;              // NaN
  if (mag == 0u) u = 0u;                            // -0.0 -> +0.0
  const unsigned asc = u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
  return ((unsigned long long)~asc << 32) | (unsigned)(id ^ INT_MIN);
}

__device__ __forceinline__ unsigned long long rank_probe_key(float s, int t) {
  return (__float_as_uint(s) & 0x7FFFFFFFu) > 0x7F800000u ? 0ull
                                                          : rank_key(s, t);
}

// count of keys[s, s + n) below pk, keys ascending there
__device__ __forceinline__ int lower_count(const unsigned long long* keys,
                                           int s, int n,
                                           unsigned long long pk) {
  int lo = s;
  while (n > 0) {
    const int half = n >> 1;
    if (keys[lo + half] < pk) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo - s;
}

// Probe keys of lane `lane` of a block starting at probe p0.
__device__ __forceinline__ void load_probes(const float* st, const int* tid,
                                            long long row, int t_count,
                                            int p0, int lane,
                                            unsigned long long* pk, int* cnt) {
#pragma unroll
  for (int q = 0; q < kProbes; ++q) {
    const int p = p0 + lane + 32 * q;
    pk[q] = p < t_count ? rank_probe_key(__ldg(st + row * t_count + p),
                                         __ldg(tid + row * t_count + p))
                        : 0ull;
    cnt[q] = 0;
  }
}

// The warps' partial counts of probe slot i summed and written.
__device__ __forceinline__ void write_counts(int (*part)[kBlockProbes],
                                             int* out, long long row,
                                             int t_count, int p0) {
  for (int i = threadIdx.x; i < kBlockProbes; i += kThreads) {
    const int p = p0 + i;
    if (p < t_count) {
      int total = 0;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) total += part[u][i];
      out[row * t_count + p] = total;
    }
  }
}

template <bool RUNS>
__global__ void __launch_bounds__(kThreads)
keyed_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
             int w, const float* __restrict__ st, const int* __restrict__ tid,
             int t_count, int* __restrict__ out) {
  __shared__ unsigned long long keys[kTile];
  __shared__ int part[kWarps][kBlockProbes];
  __shared__ int starts[kMaxRuns + 1];
  __shared__ int wsum[kWarps];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.y * kBlockProbes;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  unsigned long long pk[kProbes];
  int cnt[kProbes];
  load_probes(st, tid, b, t_count, p0, lane, pk, cnt);
  // design (3): thread t searches for probe t % 128, runs of parity t / 128
  const int rp = p0 + threadIdx.x % kBlockProbes;
  const unsigned long long rpk =
      RUNS && rp < t_count ? rank_probe_key(__ldg(st + b * t_count + rp),
                                            __ldg(tid + b * t_count + rp))
                           : 0ull;
  int rcnt = 0;
  for (int lo = 0; lo < w; lo += kTile) {
    const int width = min(kTile, w - lo);
    for (int e = threadIdx.x; e < width; e += kThreads)
      keys[e] = rank_key(__ldg(rv + lo + e), __ldg(ri + lo + e));
    __syncthreads();
    int n_runs = kMaxRuns + 1;
    int mine = 0, incl = 0;
    const int e0 = threadIdx.x * (kTile / kThreads);
    if (RUNS) {          // run starts, thread t at positions 8t .. 8t + 7
#pragma unroll
      for (int u = 0; u < kTile / kThreads; ++u) {
        const int e = e0 + u;
        mine += e < width && (e == 0 || keys[e - 1] > keys[e]);
      }
      incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      n_runs = 0;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) n_runs += wsum[u];
    }
    if (RUNS && n_runs <= kMaxRuns && n_runs * 16 <= width) {
      int r = incl - mine;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) r += u < warp ? wsum[u] : 0;
#pragma unroll
      for (int u = 0; u < kTile / kThreads; ++u) {
        const int e = e0 + u;
        if (e < width && (e == 0 || keys[e - 1] > keys[e])) starts[r++] = e;
      }
      if (threadIdx.x == 0) starts[n_runs] = width;
      __syncthreads();
      for (int r2 = threadIdx.x / kBlockProbes; r2 < n_runs;
           r2 += kThreads / kBlockProbes)
        rcnt += lower_count(keys, starts[r2], starts[r2 + 1] - starts[r2],
                            rpk);
    } else {
      const int per = (width + kWarps - 1) / kWarps;
      const int end = min(width, (warp + 1) * per);
#pragma unroll 4
      for (int e = warp * per; e < end; ++e) {
        const unsigned long long kc = keys[e];
#pragma unroll
        for (int q = 0; q < kProbes; ++q) cnt[q] += kc < pk[q];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kProbes; ++q) part[warp][lane + 32 * q] = cnt[q];
  __syncthreads();
  if (RUNS) part[threadIdx.x / kBlockProbes][threadIdx.x % kBlockProbes] += rcnt;
  __syncthreads();
  write_counts(part, out, b, t_count, p0);
}

// design (2): N keys a tile (a power of two), THREADS threads
template <int N, int THREADS>
__global__ void __launch_bounds__(THREADS)
sorted_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
              int w, const float* __restrict__ st,
              const int* __restrict__ tid, int t_count,
              int* __restrict__ out) {
  __shared__ unsigned long long keys[N];
  const long long b = blockIdx.x;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  for (int lo = 0; lo < w; lo += N) {
    const int width = min(N, w - lo);
    for (int e = threadIdx.x; e < N; e += THREADS)
      keys[e] = e < width ? rank_key(__ldg(rv + lo + e), __ldg(ri + lo + e))
                          : ~0ull;
    __syncthreads();
    for (int size = 2; size <= N; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < N / 2; i += THREADS) {
          const int a_i = 2 * i - (i & (stride - 1));
          const int b_i = a_i + stride;
          const unsigned long long x = keys[a_i], y = keys[b_i];
          if ((x > y) == ((a_i & size) == 0)) {
            keys[a_i] = y;
            keys[b_i] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int p = threadIdx.x; p < t_count; p += THREADS) {
      const int c = lower_count(keys, 0, N, rank_probe_key(
          __ldg(st + b * t_count + p), __ldg(tid + b * t_count + p)));
      out[b * t_count + p] = lo == 0 ? c : out[b * t_count + p] + c;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int skrx_rank_count_linear(const float* vals, const int* ids, int b, int w,
                           const float* st, const int* tid, int t, int* out,
                           cudaStream_t stream) {
  const dim3 grid(b, (t + kBlockProbes - 1) / kBlockProbes);
  keyed_kernel<false><<<grid, kThreads, 0, stream>>>(vals, ids, w, st, tid, t,
                                                     out);
  return (int)cudaGetLastError();
}

int skrx_rank_count_runs(const float* vals, const int* ids, int b, int w,
                         const float* st, const int* tid, int t, int* out,
                         cudaStream_t stream) {
  const dim3 grid(b, (t + kBlockProbes - 1) / kBlockProbes);
  keyed_kernel<true><<<grid, kThreads, 0, stream>>>(vals, ids, w, st, tid, t,
                                                    out);
  return (int)cudaGetLastError();
}

int skrx_rank_count_sorted(const float* vals, const int* ids, int b, int w,
                           const float* st, const int* tid, int t, int* out,
                           cudaStream_t stream) {
  if (w <= 512)
    sorted_kernel<512, 256><<<b, 256, 0, stream>>>(vals, ids, w, st, tid, t,
                                                   out);
  else if (w <= 1024)
    sorted_kernel<1024, 512><<<b, 512, 0, stream>>>(vals, ids, w, st, tid, t,
                                                    out);
  else
    sorted_kernel<2048, 1024><<<b, 1024, 0, stream>>>(vals, ids, w, st, tid,
                                                      t, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
