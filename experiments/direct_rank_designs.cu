// Designs of kernel #8 (direct_rank) timed against the package's kernel
// (skrx_torch/ops/kernels/csrc/rank_counts.cu, included below: the found
// probes of a row placed among themselves, each column searched among their
// keys into a histogram, the row's columns split over a cluster when wide).
// It is not part of the package; experiments/direct_rank_designs.py builds
// it and times each design against the package's kernel on one card, and
// PERF.md says how they fared. Each launcher computes skrx_direct_rank's
// function, count for count, and takes its arguments, then its own:
//
//   skrx_direct_rank_cl         the package's kernel at the cluster size
//                               given (1..8) instead of its own choice;
//   skrx_direct_rank_warp       design (a): a warp per 4 found probes, their
//                               packed keys in registers, the CTA's columns
//                               over the lanes, a warp reduction, the row
//                               split over a cluster as in the package;
//   skrx_direct_rank_loop       design (c): the parent's loop (one thread a
//                               found probe, serial over the row's tiles of
//                               packed keys) with only the mask bitmap and
//                               the list of found probes, no cluster;
//   skrx_direct_rank_sort       design (b) as first built (a bitonic sort,
//                               __match_any_sync, the leader pulling the
//                               histograms), cluster size given;
//   skrx_direct_rank_workbench  the package's kernel with its choices as
//                               switches (threads, skewed keys, match) and
//                               phase marks, cluster size given;
//   skrx_direct_rank_floor      the same grid writing k to every slot.
//
// All but the first take rows of one bitmap window (n <= kWinCols) and
// return cudaErrorInvalidValue otherwise.
#include "../skrx_torch/ops/kernels/csrc/rank_counts.cu"

namespace {

// The found probes of the CTA's slots [p0, p0 + kRankThreads) of row b,
// listed in slot order as (rank_key, slot) in key[] and slot[] (their
// number returned); k written to every other slot by the leader; bits[]
// holds the row's mask afterwards (rows of one window). Ends with a
// barrier. (The package's kernel as first built did this; designs (a) and
// (c) keep it.)
__device__ __forceinline__ int list_found(
    const float* __restrict__ row, int n, const int* __restrict__ mrow, int L,
    const int* __restrict__ tid_row, int t_count, int p0, int k, int rank,
    int* __restrict__ out_row, unsigned* bits, unsigned long long* key,
    int* slot, int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = p0 + threadIdx.x;
  const int t = p < t_count ? __ldg(tid_row + p) : -1;
  const bool in_row = t >= 0 && t < n;
  const float s = in_row ? __ldg(row + t) : 0.f;
  bool masked = false;
  if (L > 0) {
    build_bits(bits, mrow, L, 0, n);
    masked = in_row && bit_set(bits, (unsigned)t);
  }
  const bool found = in_row && !masked && isfinite(s);
  if (p < t_count && !found && rank == 0) out_row[p] = k;
  const unsigned ballot = __ballot_sync(0xffffffffu, found);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), n_found = 0;
#pragma unroll
  for (int u = 0; u < kRankWarps; ++u) {
    pos += u < warp ? warp_n[u] : 0;
    n_found += warp_n[u];
  }
  if (found) {
    key[pos] = rank_key(s, t);
    slot[pos] = p;
  }
  __syncthreads();
  return n_found;
}

template <int kT>
__device__ __forceinline__ int block_scan_t(int h, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, h, d);
    if (lane >= d) h += o;
  }
  if (lane == 31) warp_sum[warp] = h;
  __syncthreads();
  for (int u = 0; u < warp; ++u) h += warp_sum[u];
  return h;
}

constexpr int kLoopTile = 2048;   // design (c): packed keys a tile

__global__ void __launch_bounds__(kRankThreads)
direct_rank_warp_kernel(const float* __restrict__ scores, int n,
                        const int* __restrict__ mask, int L,
                        const int* __restrict__ tid, int t_count, int k,
                        int* __restrict__ out) {
  __shared__ unsigned bits[kBitWords];
  __shared__ unsigned long long xk[kRankThreads];
  __shared__ int xi[kRankThreads];
  __shared__ int part[kRankThreads];
  __shared__ int warp_n[kRankWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = scores + b * n;
  const int* mrow = mask + b * L;
  int* out_row = out + b * t_count;
  const int n_found = list_found(row, n, mrow, L, tid + b * t_count, t_count,
                                 blockIdx.y * kRankThreads, k, rank, out_row,
                                 bits, xk, xi, warp_n);
  if (n_found == 0) return;
  const int per = ((n + cl - 1) / cl + 31) & ~31;
  const int c0 = min(n, rank * per), c1 = min(n, c0 + per);
  for (int g = 4 * warp; g < n_found; g += 4 * kRankWarps) {
    unsigned long long pk[4];
    int cnt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pk[q] = g + q < n_found ? xk[g + q] : 0ull;   // 0 counts nothing
      cnt[q] = 0;
    }
#pragma unroll 4
    for (int c = c0 + lane; c < c1; c += 32) {
      const bool live = !(L > 0 && bit_set(bits, (unsigned)c));
      const unsigned long long ck = live ? rank_key(__ldg(row + c), c) : ~0ull;
#pragma unroll
      for (int q = 0; q < 4; ++q) cnt[q] += ck < pk[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) cnt[q] += __shfl_xor_sync(0xffffffffu, cnt[q], d);
      if (lane == 0 && g + q < n_found) part[g + q] = cnt[q];
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < n_found; i += kRankThreads) {
      int h = part[i];
      for (int q = 1; q < cl; ++q) h += cluster.map_shared_rank(part, q)[i];
      out_row[xi[i]] = h;
    }
  }
  cluster.sync();
}

__global__ void __launch_bounds__(kRankThreads)
direct_rank_loop_kernel(const float* __restrict__ scores, int n,
                        const int* __restrict__ mask, int L,
                        const int* __restrict__ tid, int t_count, int k,
                        int* __restrict__ out) {
  __shared__ unsigned bits[kBitWords];
  __shared__ unsigned long long xk[kRankThreads];
  __shared__ int xi[kRankThreads];
  __shared__ unsigned long long tk[kLoopTile];
  __shared__ int warp_n[kRankWarps];
  const long long b = blockIdx.x;
  const float* row = scores + b * n;
  const int* mrow = mask + b * L;
  int* out_row = out + b * t_count;
  const int n_found = list_found(row, n, mrow, L, tid + b * t_count, t_count,
                                 blockIdx.y * kRankThreads, k, 0, out_row, bits,
                                 xk, xi, warp_n);
  if (n_found == 0) return;
  const int i = threadIdx.x;
  const unsigned long long pk = i < n_found ? xk[i] : 0ull;
  int cnt = 0;
  for (int lo = 0; lo < n; lo += kLoopTile) {
    const int width = min(kLoopTile, n - lo);
    for (int c = i; c < width; c += kRankThreads) {
      const bool live = !(L > 0 && bit_set(bits, (unsigned)(lo + c)));
      tk[c] = live ? rank_key(__ldg(row + lo + c), lo + c) : ~0ull;
    }
    __syncthreads();
    if (i < n_found) {
#pragma unroll 8
      for (int c = 0; c < width; ++c) cnt += tk[c] < pk;
    }
    __syncthreads();
  }
  if (i < n_found) out_row[xi[i]] = cnt;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Design (b) as first built, then with its loads issued first: the found
// probes' keys sorted by a bitonic network in registers (a shuffle a stage
// within a warp, shared memory across warps), each found probe's place
// found again by a search in the sorted keys, equal bins of a warp added
// once (__match_any_sync), and the leader reading the other CTAs'
// histograms through distributed shared memory between two cluster
// barriers. Rows of one window only.
constexpr int kSortMaskU = 4;

template <bool kCluster>
__global__ void __launch_bounds__(kRankThreads)
direct_rank_sort_kernel(const float* __restrict__ scores, int n,
                        const int* __restrict__ mask, int L,
                        const int* __restrict__ tid, int t_count, int k,
                        int* __restrict__ out) {
  __shared__ unsigned bits[kBitWords];
  __shared__ unsigned long long xk[2][kRankThreads];
  __shared__ int hist[kRankThreads];
  __shared__ int warp_n[kRankWarps];
  const int cl = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const long long b = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = scores + b * n;
  const int* mrow = mask + b * L;
  int* out_row = out + b * t_count;
  const int p = blockIdx.y * kRankThreads + threadIdx.x;
  const int t = p < t_count ? __ldg(tid + b * t_count + p) : -1;
  int m[kSortMaskU];
#pragma unroll
  for (int u = 0; u < kSortMaskU; ++u) {
    const int e = u * kRankThreads + threadIdx.x;
    m[u] = e < L ? __ldg(mrow + e) : -1;
  }
  const int per = ((n + cl - 1) / cl + 31) & ~31;
  const int c0 = min(n, rank * per), c1 = min(n, c0 + per);
  const int base0 = c0 + warp * 32;
  float v[kColUnroll];
#pragma unroll
  for (int u = 0; u < kColUnroll; ++u) {
    const int c = base0 + u * kRankThreads + lane;
    v[u] = c < c1 ? __ldg(row + c) : 0.f;
  }
  const bool in_row = t >= 0 && t < n;
  const float s = in_row ? __ldg(row + t) : 0.f;
  for (int e = threadIdx.x; e < (n + 31) >> 5; e += kRankThreads) bits[e] = 0u;
  hist[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSortMaskU; ++u)
    if ((unsigned)m[u] < (unsigned)n) atomicOr(&bits[m[u] >> 5], 1u << (m[u] & 31));
  for (int e = kSortMaskU * kRankThreads + threadIdx.x; e < L; e += kRankThreads) {
    const unsigned id = (unsigned)__ldg(mrow + e);
    if (id < (unsigned)n) atomicOr(&bits[id >> 5], 1u << (id & 31));
  }
  __syncthreads();
  const bool found = in_row && !(L > 0 && bit_set(bits, (unsigned)t)) && isfinite(s);
  if (p < t_count && !found && rank == 0) out_row[p] = k;
  const unsigned ballot = __ballot_sync(0xffffffffu, found);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), n_found = 0;
#pragma unroll
  for (int u = 0; u < kRankWarps; ++u) {
    pos += u < warp ? warp_n[u] : 0;
    n_found += warp_n[u];
  }
  const unsigned long long pk = found ? rank_key(s, t) : 0ull;
  if (found) xk[0][pos] = pk;
  __syncthreads();
  if (n_found == 0) return;
  int p2 = 32;
  while (p2 < n_found) p2 <<= 1;
  const int i = threadIdx.x;
  unsigned long long key = i < n_found ? xk[0][i] : ~0ull;
  int buf = 1;
  for (int kk = 2; kk <= p2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      unsigned long long ok;
      if (j >= 32) {
        xk[buf][i] = key;
        __syncthreads();
        ok = xk[buf][i ^ j];
        buf ^= 1;
      } else {
        ok = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool keep_min = ((i & kk) == 0) == ((i & j) == 0);
      key = keep_min ? min(key, ok) : max(key, ok);
    }
  }
  unsigned long long* skey = xk[buf];   // not the buffer last read
  skey[i] = key;
  __syncthreads();
  int ps = 1;                            // search width: n_found rounded up
  while (ps < n_found) ps <<= 1;
  for (int base = base0; base < c1; base += kColUnroll * kRankThreads) {
    float nv[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int c = base + kColUnroll * kRankThreads + u * kRankThreads + lane;
      nv[u] = c < c1 ? __ldg(row + c) : 0.f;
    }
    unsigned long long ck[kColUnroll];
    int j[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int c = base + u * kRankThreads + lane;
      const bool live = c < c1 && !(L > 0 && bit_set(bits, (unsigned)c));
      ck[u] = live ? rank_key(v[u], c) : ~0ull;
      j[u] = 0;
    }
    for (int half = ps >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u)
        j[u] += skey[j[u] + half - 1] <= ck[u] ? half : 0;
    }
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      j[u] += skey[j[u]] <= ck[u];
      const int bin = j[u] < n_found ? j[u] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(same) - 1) atomicAdd(&hist[bin], __popc(same));
      v[u] = nv[u];
    }
  }
  if (kCluster) cg::this_cluster().sync(); else __syncthreads();
  if (rank == 0) {
    int h = i < n_found ? hist[i] : 0;
    if (kCluster)
      for (int q = 1; q < cl; ++q)
        h += i < n_found ? cg::this_cluster().map_shared_rank(hist, q)[i] : 0;
    h = block_scan(h, warp_n);
    if (kCluster) cg::this_cluster().sync();
    hist[i] = h;
    __syncthreads();
    if (found) {
      int at = 0;                        // the first place of its key
      for (int half = ps >> 1; half > 0; half >>= 1)
        at += skey[at + half - 1] < pk ? half : 0;
      at += skey[at] < pk;
      out_row[p] = hist[at];
    }
  } else if (kCluster) {
    cg::this_cluster().sync();           // the leader has read this CTA
  }
}

// The workbench: a copy of the package's kernel (rows of one window only)
// with its choices as switches: kT threads a CTA (the package: 512), kSkew
// (the package's skewed keys; without, key e at e), kMatch (equal bins of a
// warp added once by __match_any_sync; the package: a shared add a
// column). With marks, thread 0 of each CTA writes clock64() at the phase
// ends (0 start, 1 mask bitmap built, 2 found probes listed, 3 probes
// placed, 4 columns counted, 5 the histograms met, 6 the end), then
// globaltimer at its start and end, and its found probes: 10 int64 a CTA.
template <int kT, bool kCluster, bool kSkew, bool kMatch>
__global__ void __launch_bounds__(kT)
direct_rank_workbench_kernel(const float* __restrict__ scores, int n,
                             const int* __restrict__ mask, int L,
                             const int* __restrict__ tid, int t_count, int k,
                             int* __restrict__ out, long long* __restrict__ marks) {
  constexpr int kW = kT / 32;
  constexpr int kMaskU = 4096 / kT;
  __shared__ unsigned bits[kBitWords];
  __shared__ unsigned long long lk[kT];
  __shared__ unsigned long long skey[kT + kT / 16];
  __shared__ int hist[kT];
  __shared__ int warp_n[kW];
  long long* mk = marks ? marks + 10 * ((long long)blockIdx.y * gridDim.x + blockIdx.x) : nullptr;
  const long long g0 = mk ? global_ns() : 0;
  const long long c_0 = clock64();
  const int cl = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const long long b = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = scores + b * n;
  const int* mrow = mask + b * L;
  int* out_row = out + b * t_count;
  const int p = blockIdx.y * kT + threadIdx.x;
  const int t = p < t_count ? __ldg(tid + b * t_count + p) : -1;
  int m[kMaskU];
#pragma unroll
  for (int u = 0; u < kMaskU; ++u) {
    const int e = u * kT + threadIdx.x;
    m[u] = e < L ? __ldg(mrow + e) : -1;
  }
  const int per = ((n + cl - 1) / cl + 31) & ~31;
  const int c0 = min(n, rank * per), c1 = min(n, c0 + per);
  const int base0 = c0 + warp * 32;
  float v[kColUnroll];
#pragma unroll
  for (int u = 0; u < kColUnroll; ++u) {
    const int c = base0 + u * kT + lane;
    v[u] = c < c1 ? __ldg(row + c) : 0.f;
  }
  const bool in_row = t >= 0 && t < n;
  const float s = in_row ? __ldg(row + t) : 0.f;
  unsigned long long ck[kColUnroll];
#pragma unroll
  for (int u = 0; u < kColUnroll; ++u) {
    const int c = base0 + u * kT + lane;
    ck[u] = c < c1 ? rank_key(v[u], c) : ~0ull;
  }
  for (int e = threadIdx.x; e < (n + 31) >> 5; e += kT) bits[e] = 0u;
  hist[threadIdx.x] = 0;
  __syncthreads();
  if (kCluster) cluster_arrive();        // this CTA's histogram is zeroed
#pragma unroll
  for (int u = 0; u < kMaskU; ++u)
    if ((unsigned)m[u] < (unsigned)n) atomicOr(&bits[m[u] >> 5], 1u << (m[u] & 31));
  for (int e = kMaskU * kT + threadIdx.x; e < L; e += kT) {
    const unsigned id = (unsigned)__ldg(mrow + e);
    if (id < (unsigned)n) atomicOr(&bits[id >> 5], 1u << (id & 31));
  }
  __syncthreads();
  const long long c_1 = clock64();
  const bool found = in_row && !(L > 0 && bit_set(bits, (unsigned)t)) && isfinite(s);
  if (p < t_count && !found && rank == 0) out_row[p] = k;
  const unsigned ballot = __ballot_sync(0xffffffffu, found);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), n_found = 0;
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    pos += u < warp ? warp_n[u] : 0;
    n_found += warp_n[u];
  }
  const unsigned long long pk = found ? rank_key(s, t) : 0ull;
  if (found) lk[pos] = pk;
  __syncthreads();
  const long long c_2 = clock64();
  if (n_found == 0) {                    // the same in every CTA of the cluster
    if (kCluster) cluster_wait();
    if (mk && threadIdx.x == 0) {
      mk[0] = c_0; mk[1] = c_1; mk[2] = c_2; mk[3] = mk[4] = mk[5] = mk[6] = c_2;
      mk[7] = g0; mk[8] = global_ns(); mk[9] = 0;
    }
    return;
  }
  int ps = 1;
  while (ps < n_found) ps <<= 1;
#define SKEY(e) skey[kSkew ? (e) + ((e) >> 4) : (e)]
  int r = 0;
  if (found) {
    int j = 0;
    for (; j + 4 <= n_found; j += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned long long kj = lk[j + q];
        r += (kj < pk) | ((kj == pk) & (j + q < pos));
      }
    }
    for (; j < n_found; ++j) {
      const unsigned long long kj = lk[j];
      r += (kj < pk) | ((kj == pk) & (j < pos));
    }
    SKEY(r) = pk;
  }
  if ((int)threadIdx.x >= n_found && (int)threadIdx.x < ps) SKEY((int)threadIdx.x) = ~0ull;
  __syncthreads();
  const long long c_3 = clock64();
  for (int base = base0; base < c1; base += kColUnroll * kT) {
    if (base != base0) {
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        const int c = base + u * kT + lane;
        ck[u] = c < c1 ? rank_key(__ldg(row + c), c) : ~0ull;
      }
    }
    int j[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int c = base + u * kT + lane;
      if (c < c1 && L > 0 && bit_set(bits, (unsigned)c)) ck[u] = ~0ull;
      j[u] = 0;
    }
    for (int half = ps >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        const int e = j[u] + half - 1;
        j[u] += SKEY(e) <= ck[u] ? half : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int e = j[u];
      j[u] += SKEY(e) <= ck[u];
      if (kMatch) {
        const int bin = j[u] < n_found ? j[u] : -1;
        const unsigned same = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(same) - 1) atomicAdd(&hist[bin], __popc(same));
      } else if (j[u] < n_found) {
        atomicAdd(&hist[j[u]], 1);
      }
    }
  }
#undef SKEY
  const long long c_4 = clock64();
  if (kCluster) {
    __syncthreads();                     // this CTA's histogram is complete
    cluster_wait();                      // every CTA's histogram was zeroed
    if (rank != 0 && (int)threadIdx.x < n_found) {
      const int h = hist[threadIdx.x];
      if (h) atomicAdd(cg::this_cluster().map_shared_rank(hist, 0) + threadIdx.x, h);
    }
    cg::this_cluster().sync();           // the leader's histogram is complete
  } else {
    __syncthreads();
  }
  const long long c_5 = clock64();
  if (rank == 0) {
    const int i = threadIdx.x;
    const int h = block_scan_t<kT>(i < n_found ? hist[i] : 0, warp_n);
    hist[i] = h;
    __syncthreads();
    if (found) out_row[p] = hist[r];
  }
  if (mk && threadIdx.x == 0) {
    mk[0] = c_0; mk[1] = c_1; mk[2] = c_2; mk[3] = c_3; mk[4] = c_4; mk[5] = c_5;
    mk[6] = clock64(); mk[7] = g0; mk[8] = global_ns(); mk[9] = n_found;
  }
}

// The floor: the same grid writes k to every slot and reads nothing else.
__global__ void __launch_bounds__(kRankThreads)
direct_rank_floor_kernel(int t_count, int k, int cl, int* __restrict__ out) {
  const long long b = blockIdx.x / cl;
  const int p = blockIdx.y * kRankThreads + threadIdx.x;
  if (blockIdx.x % cl == 0 && p < t_count) out[b * t_count + p] = k;
}

template <class Kernel, class... Args>
int launch_grid_t(Kernel kernel, int threads, int b, int t, int cl, bool cluster,
                  cudaStream_t stream, Args... args) {
  const int slices = (t + threads - 1) / threads;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * cl), (unsigned)slices);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = cluster ? attr : nullptr;
  cfg.numAttrs = cluster ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" {

int skrx_direct_rank_cl(const float* scores, int b, int n, const int* mask,
                        int L, const int* tid, int t, int k, int* out, int cl,
                        cudaStream_t stream) {
  if (cl < 1 || cl > kMaxCluster) return (int)cudaErrorInvalidValue;
  return launch_direct_rank(scores, b, n, mask, L, tid, t, k, out, cl, stream);
}

int skrx_direct_rank_warp(const float* scores, int b, int n, const int* mask,
                          int L, const int* tid, int t, int k, int* out,
                          cudaStream_t stream) {
  if (n > kWinCols) return (int)cudaErrorInvalidValue;
  const int cl = std::max(1, direct_rank_cluster(b, n, sm_count()));
  return launch_grid_t(direct_rank_warp_kernel, kRankThreads, b, t, cl, true, stream,
                       scores, n, mask, L, tid, t, k, out);
}

int skrx_direct_rank_loop(const float* scores, int b, int n, const int* mask,
                          int L, const int* tid, int t, int k, int* out,
                          cudaStream_t stream) {
  if (n > kWinCols) return (int)cudaErrorInvalidValue;
  return launch_grid_t(direct_rank_loop_kernel, kRankThreads, b, t, 1, false, stream,
                       scores, n, mask, L, tid, t, k, out);
}

int skrx_direct_rank_sort(const float* scores, int b, int n, const int* mask,
                          int L, const int* tid, int t, int k, int* out, int cl,
                          cudaStream_t stream) {
  if (n > kWinCols || cl < 1 || cl > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (cl == 1)
    return launch_grid_t(direct_rank_sort_kernel<false>, kRankThreads, b, t, 1, false,
                         stream, scores, n, mask, L, tid, t, k, out);
  return launch_grid_t(direct_rank_sort_kernel<true>, kRankThreads, b, t, cl, true,
                       stream, scores, n, mask, L, tid, t, k, out);
}

// threads 512 or 1024, skew and match 0 or 1, marks null or (CTAs, 10).
int skrx_direct_rank_workbench(const float* scores, int b, int n, const int* mask,
                               int L, const int* tid, int t, int k, int* out,
                               int cl, int threads, int skew, int match,
                               long long* marks, cudaStream_t stream) {
  if (n > kWinCols || cl < 1 || cl > kMaxCluster) return (int)cudaErrorInvalidValue;
#define SKRX_WB(T_, C_, S_, M_)                                                   \
  return launch_grid_t(direct_rank_workbench_kernel<T_, C_, S_, M_>, T_, b, t, cl, \
                       C_, stream, scores, n, mask, L, tid, t, k, out, marks)
#define SKRX_WB_T(T_)                                              \
  if (cl == 1) {                                                   \
    if (skew) { if (match) SKRX_WB(T_, false, true, true);         \
                SKRX_WB(T_, false, true, false); }                 \
    if (match) SKRX_WB(T_, false, false, true);                    \
    SKRX_WB(T_, false, false, false);                              \
  }                                                                \
  if (skew) { if (match) SKRX_WB(T_, true, true, true);            \
              SKRX_WB(T_, true, true, false); }                    \
  if (match) SKRX_WB(T_, true, false, true);                       \
  SKRX_WB(T_, true, false, false)
  if (threads == 1024) { SKRX_WB_T(1024); }
  SKRX_WB_T(512);
#undef SKRX_WB_T
#undef SKRX_WB
}

// The floor of a launch of this grid at cluster size cl (0: no cluster).
int skrx_direct_rank_floor(int b, int t, int k, int* out, int cl,
                           cudaStream_t stream) {
  return launch_grid_t(direct_rank_floor_kernel, kRankThreads, b, t, cl ? cl : 1,
                       cl != 0, stream, t, k, cl ? cl : 1, out);
}

}  // extern "C"
