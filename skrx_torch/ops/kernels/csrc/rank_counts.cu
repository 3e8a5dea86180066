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
// the row's (value desc, id asc) order, as one compare of packed 64-bit
// keys (rank_key). The TPU kernels take at most 128 probes (one unrolled
// round each, lane-padded); here any number. In rank_count and
// rank_lookup_count a lane holds several probes' keys and the block's warps
// split each tile's segments of equal keys, grid (B, probe blocks); in
// direct_rank a CTA sorts its row's found probes and each column finds its
// place among them, the row's columns split over a cluster, grid (B * cl,
// probe blocks). So a batch of 64 rows with a few hundred probes each still
// fills the card.
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the wrappers in ../topk_blocks.py check shapes, types
// and devices, allocate the outputs and count launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

// direct_rank: probe slots a CTA (one a thread), mask bitmap words (a
// window of kWinCols columns), columns a thread searches at once, mask ids
// a thread loads up front, the fewest columns a CTA of a split row takes,
// most CTAs a row's columns are split over (a portable cluster)
constexpr int kRankThreads = 512;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kBitWords = 2048;
constexpr int kWinCols = 32 * kBitWords;
constexpr int kColUnroll = 4;
constexpr int kMaskUnroll = 8;
constexpr int kClusterCols = 1024;
constexpr int kMaxCluster = 8;
// rank_count and rank_lookup_count: probe keys a lane holds, warps that
// split a tile between them, probes a block, candidates a tile (its
// segments take 24 KB, rank_lookup_count's list of it 16 KB more)
constexpr int kCountProbes = 4;
constexpr int kCountWarps = 8;
constexpr int kCountBlockProbes = 32 * kCountProbes;
constexpr int kKeyTile = 2048;

// rank_count's packed key: candidate c ranks before probe p (v_c > s_p, or
// v_c == s_p and i_c < t_p, as floats and signed ints) exactly when
// rank_key(c) < rank_key(p) as unsigned 64-bit integers. The high word is a
// descending order map of the value with -0.0 and +0.0 made one (so equal
// values fall to the id), the low word the id biased by 0x80000000 (so the
// signed order holds). A NaN candidate gets the largest key, which no key
// exceeds, so it is never counted; a NaN probe gets 0 (rank_probe_key),
// below every key, so it counts nothing. Integer operations only: no flush
// of subnormals can touch the order. topk_blocks.py's rank_key is the same
// map in plain PyTorch (with the top bit flipped, to order as int64).
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

// The order key of f32 values under which jnp.max takes its max: -inf
// lowest, -0.0 below +0.0, every NaN (either sign) above +inf; the largest
// key maps back (key_value) to a NaN.
__device__ __forceinline__ int max_key(float v) {
  const int i = __float_as_int(v);
  return (i & 0x7FFFFFFF) > 0x7F800000 ? INT_MAX : i ^ ((i >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// One tile of a row's candidates (rv, ri: the tile's first), staged by the
// block's kCountWarps warps as rank_count counts over it. Warp w loads its
// chunk of the tile into registers (lanes on consecutive positions), finds
// the segment starts against the key before each position (a shuffle; lane
// 0 carries the last key of the step before), and the block lists the
// segments in order in shared memory (one scan over the warps' counts):
// seg_key[i] and seg_start[i], seg_start[n_seg] = width. With kList the
// same pass lists the tile's lanes whose value is not -inf (NaN included)
// as (max_key, id) in `listed`, in tile order, their number in n_listed:
// the only lanes whose value can be a looked-up score above -inf.
// warp_n holds 2 * kCountWarps counts. Returns n_seg; ends with a barrier.
template <bool kList>
__device__ __forceinline__ int stage_tile(const float* __restrict__ rv,
                                          const int* __restrict__ ri, int width,
                                          unsigned long long* seg_key,
                                          int* seg_start, int* warp_n,
                                          int2* listed, int& n_listed) {
  constexpr int kSteps = kKeyTile / (kCountWarps * 32);   // a warp's steps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = ((width + kCountWarps - 1) / kCountWarps + 31) & ~31;
  const int c0 = warp * chunk, c1 = min(width, c0 + chunk);
  float v[kSteps];
  int id[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int e = c0 + 32 * it + lane;
    v[it] = e < c1 ? __ldg(rv + e) : 0.f;
    id[it] = e < c1 ? __ldg(ri + e) : 0;
  }
  unsigned long long carry = 0ull;      // the key before the step
  if (lane == 0 && c0 > 0 && c0 < c1)
    carry = rank_key(__ldg(rv + c0 - 1), __ldg(ri + c0 - 1));
  unsigned long long key[kSteps];
  unsigned starts[kSteps], live[kSteps];
  int n_mine = 0, l_mine = 0;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int e = c0 + 32 * it + lane;
    key[it] = rank_key(v[it], id[it]);
    unsigned long long prev = __shfl_up_sync(0xffffffffu, key[it], 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(0xffffffffu, key[it], 31);
    starts[it] = __ballot_sync(0xffffffffu,
                               e < c1 && (e == 0 || prev != key[it]));
    n_mine += __popc(starts[it]);
    if (kList) {
      live[it] = __ballot_sync(0xffffffffu, e < c1 && v[it] != -INFINITY);
      l_mine += __popc(live[it]);
    }
  }
  if (lane == 0) {
    warp_n[warp] = n_mine;
    if (kList) warp_n[kCountWarps + warp] = l_mine;
  }
  __syncthreads();
  int base = 0, n_seg = 0, lbase = 0;
  n_listed = 0;
#pragma unroll
  for (int u = 0; u < kCountWarps; ++u) {
    base += u < warp ? warp_n[u] : 0;
    n_seg += warp_n[u];
    if (kList) {
      lbase += u < warp ? warp_n[kCountWarps + u] : 0;
      n_listed += warp_n[kCountWarps + u];
    }
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    if ((starts[it] >> lane) & 1u) {
      const int i = base + __popc(starts[it] & below);
      seg_key[i] = key[it];
      seg_start[i] = c0 + 32 * it + lane;
    }
    base += __popc(starts[it]);
    if (kList) {
      if ((live[it] >> lane) & 1u)
        listed[lbase + __popc(live[it] & below)] = make_int2(max_key(v[it]), id[it]);
      lbase += __popc(live[it]);
    }
  }
  if (threadIdx.x == 0) seg_start[n_seg] = width;
  __syncthreads();
  return n_seg;
}

// Warp w's share of a staged tile's n_seg segments (seg_start[n_seg] =
// width): each probe key pk[q] (q < nq) adds the multiplicity of every
// segment whose key is below its own (a tile without repeats, n_seg ==
// width, counts 1 a key and reads no multiplicity).
__device__ __forceinline__ void count_segments(
    const unsigned long long* seg_key, const int* seg_start, int n_seg,
    int width, const unsigned long long (&pk)[kCountProbes],
    int (&cnt)[kCountProbes], int nq) {
  const int warp = threadIdx.x >> 5;
  const int per = (n_seg + kCountWarps - 1) / kCountWarps;
  const int end = min(n_seg, (warp + 1) * per);
  if (n_seg == width) {
    for (int i = warp * per; i < end; ++i) {
      const unsigned long long kc = seg_key[i];
#pragma unroll
      for (int q = 0; q < kCountProbes; ++q)
        if (q < nq) cnt[q] += kc < pk[q];
    }
  } else {
    for (int i = warp * per; i < end; ++i) {
      const unsigned long long kc = seg_key[i];
      const int m = seg_start[i + 1] - seg_start[i];
#pragma unroll
      for (int q = 0; q < kCountProbes; ++q)
        if (q < nq) cnt[q] += kc < pk[q] ? m : 0;
    }
  }
}

// The warps' partial counts of the block's probes summed through `part` and
// written to out (the row's). The caller's last barrier has freed `part`.
__device__ __forceinline__ void write_counts(int (*part)[kCountBlockProbes],
                                             const int (&cnt)[kCountProbes],
                                             int* __restrict__ out, int p0,
                                             int t_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kCountProbes; ++q) part[warp][lane + 32 * q] = cnt[q];
  __syncthreads();
  for (int i = threadIdx.x; i < kCountBlockProbes; i += kCountWarps * 32) {
    const int p = p0 + i;
    if (p < t_count) {
      int total = 0;
#pragma unroll
      for (int u = 0; u < kCountWarps; ++u) total += part[u][i];
      out[p] = total;
    }
  }
}

// Replaces _rank_count_kernel. Counts over a (B, W) candidate set with the
// probes' scores given. The parent ran one probe a thread over the whole
// row, ~8 instructions a (probe, candidate) pair (two shared loads, three
// compares, two logic ops and an add), so it was bound by its compares.
// Here each candidate and probe is one packed key (rank_key), so a pair is
// one unsigned 64-bit compare; and equal neighbouring keys are counted
// once: a tile of the row becomes a list of segments (key, multiplicity),
// each a maximal run of equal adjacent keys (stage_tile), and a probe adds
// the multiplicity of every segment whose key is below its own
// (count_segments). The count stays exact for any input; it is cheap where
// the row repeats keys, as extract's candidates do (a column block's empty
// slots are all (-inf, sentinel): at the evaluation batch, B=64, W=550,
// ~61 segments a row). A block holds 32 * kCountProbes probes,
// kCountProbes probe keys a lane in registers (one 8-byte shared broadcast
// of a segment key feeds that many compares, with independent counts); its
// kCountWarps warps hold the same probes, split each tile's segments and
// sum their partial counts through shared memory. Grid (B,
// ceil(T / (32 * kCountProbes))): at the evaluation batch (T=416) 256
// blocks of 8 warps. Bound: operations (a compare and an add per (probe,
// segment) pair, and building a key per candidate); the bytes are the
// candidates, read once per probe block, and the probes.
__global__ void __launch_bounds__(kCountWarps * 32)
rank_count_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                  int w, const float* __restrict__ st,
                  const int* __restrict__ tid, int t_count,
                  int* __restrict__ out) {
  __shared__ unsigned long long seg_key[kKeyTile];
  __shared__ int seg_start[kKeyTile + 1];
  __shared__ int part[kCountWarps][kCountBlockProbes];
  __shared__ int warp_n[2 * kCountWarps];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int p0 = blockIdx.y * kCountBlockProbes;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  unsigned long long pk[kCountProbes];
  int cnt[kCountProbes];
#pragma unroll
  for (int q = 0; q < kCountProbes; ++q) {
    const int p = p0 + lane + 32 * q;
    pk[q] = p < t_count ? rank_probe_key(__ldg(st + b * t_count + p),
                                         __ldg(tid + b * t_count + p))
                        : 0ull;
    cnt[q] = 0;
  }
  // probe slots of this block that hold a probe (the last block's may not)
  const int nq = min(kCountProbes, (t_count - p0 + 31) / 32);
  int n_listed;
  for (int lo = 0; lo < w; lo += kKeyTile) {
    const int width = min(kKeyTile, w - lo);
    const int n_seg = stage_tile<false>(rv + lo, ri + lo, width, seg_key,
                                        seg_start, warp_n, nullptr, n_listed);
    count_segments(seg_key, seg_start, n_seg, width, pk, cnt, nq);
    __syncthreads();
  }
  write_counts(part, cnt, out + b * t_count, p0, t_count);
}

// Replaces _rank_lookup_count_kernel. As rank_count_kernel, but the probe
// arrives as an id t alone: its score s is looked up among the row's
// candidates, the max value (as jnp.max takes it: NaN when any is NaN) over
// the lanes that hold id t, -inf when none does, so the fused route never
// recomputes a score outside its kernels. found = s is finite; a probe
// whose id is masked, out of range or padding is among no candidates and
// is not found. The block is rank_count's (8 warps, 4 probe keys a lane,
// grid (B, ceil(T / 128))) and shares its staging: while a tile collapses
// into segments, the block lists the lanes whose value is not -inf,
// (max_key, id), in shared memory. Only those can give a probe a score
// above -inf (a probe found only among -inf lanes gets -inf either way),
// and fused evaluation fills a block's empty slots with (-inf, sentinel):
// ~51 of a row's 550 lanes are listed at B=64. Each warp compares its share
// of the list with its lane's 4 probe ids, the warps' partial maxima meet
// in shared memory as keys (NaN the largest), and the probe's packed key is
// rank_probe_key(s, t): 0 for a NaN s, which counts nothing, exactly the
// plain version's (v > NaN) | (v == NaN & ...) = 0. Then the count runs
// over the segments as in rank_count. A row of one tile (W <= kKeyTile) is
// read once; a wider row needs every tile's list before any count, so it
// is read twice (the lookup, then the count). Bound: operations (a compare
// and an add per (probe, segment) pair, a compare per (probe, listed
// lane)); the bytes are the candidates and the probes.
__global__ void __launch_bounds__(kCountWarps * 32)
rank_lookup_count_kernel(const float* __restrict__ vals,
                         const int* __restrict__ ids, int w,
                         const int* __restrict__ tid, int t_count,
                         int* __restrict__ out, bool* __restrict__ found) {
  __shared__ unsigned long long seg_key[kKeyTile];
  __shared__ int seg_start[kKeyTile + 1];
  __shared__ int2 listed[kKeyTile];
  __shared__ int part[kCountWarps][kCountBlockProbes];
  __shared__ int warp_n[2 * kCountWarps];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.y * kCountBlockProbes;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  int t[kCountProbes], sk[kCountProbes], cnt[kCountProbes];
#pragma unroll
  for (int q = 0; q < kCountProbes; ++q) {
    const int p = p0 + lane + 32 * q;
    t[q] = p < t_count ? __ldg(tid + b * t_count + p) : 0;
    sk[q] = max_key(-INFINITY);
    cnt[q] = 0;
  }
  const int nq = min(kCountProbes, (t_count - p0 + 31) / 32);
  const bool one_tile = w <= kKeyTile;
  int n_seg = 0, width = 0, n_listed;
  for (int lo = 0; lo < w; lo += kKeyTile) {      // the lookup
    width = min(kKeyTile, w - lo);
    n_seg = stage_tile<true>(rv + lo, ri + lo, width, seg_key, seg_start,
                             warp_n, listed, n_listed);
    const int per = (n_listed + kCountWarps - 1) / kCountWarps;
    const int end = min(n_listed, (warp + 1) * per);
    for (int i = warp * per; i < end; ++i) {
      const int2 e = listed[i];
#pragma unroll
      for (int q = 0; q < kCountProbes; ++q)
        if (e.y == t[q]) sk[q] = max(sk[q], e.x);
    }
    if (!one_tile) __syncthreads();     // the next tile overwrites the list
  }
#pragma unroll
  for (int q = 0; q < kCountProbes; ++q) part[warp][lane + 32 * q] = sk[q];
  __syncthreads();
  unsigned long long pk[kCountProbes];
#pragma unroll
  for (int q = 0; q < kCountProbes; ++q) {
    int k = part[0][lane + 32 * q];
#pragma unroll
    for (int u = 1; u < kCountWarps; ++u) k = max(k, part[u][lane + 32 * q]);
    const float s = key_value(k);
    pk[q] = rank_probe_key(s, t[q]);
    const int p = p0 + lane + 32 * q;
    if (warp == 0 && p < t_count) found[b * t_count + p] = isfinite(s);
  }
  if (one_tile) {           // the tile's segments are still staged
    count_segments(seg_key, seg_start, n_seg, width, pk, cnt, nq);
    __syncthreads();
  } else {
    for (int lo = 0; lo < w; lo += kKeyTile) {    // the count
      width = min(kKeyTile, w - lo);
      n_seg = stage_tile<false>(rv + lo, ri + lo, width, seg_key, seg_start,
                                warp_n, nullptr, n_listed);
      count_segments(seg_key, seg_start, n_seg, width, pk, cnt, nq);
      __syncthreads();
    }
  }
  write_counts(part, cnt, out + b * t_count, p0, t_count);
}

// direct_rank's pieces. A CTA holds kRankThreads probe slots of one row,
// one a thread; the row's columns are split over a cluster of cl CTAs.

// Sets bits[] to the columns [lo, lo + width) of the row that its mask row
// (L ids, unsorted, duplicates allowed) lists; ids outside, padding
// included, are ignored. Starts and ends with a barrier of the CTA.
__device__ __forceinline__ void build_bits(unsigned* bits,
                                           const int* __restrict__ mrow, int L,
                                           int lo, int width) {
  __syncthreads();                        // the previous window is read
  for (int e = threadIdx.x; e < (width + 31) >> 5; e += kRankThreads) bits[e] = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < L; e += kRankThreads) {
    const unsigned rel = (unsigned)__ldg(mrow + e) - (unsigned)lo;
    if (rel < (unsigned)width) atomicOr(&bits[rel >> 5], 1u << (rel & 31));
  }
  __syncthreads();
}

__device__ __forceinline__ bool bit_set(const unsigned* bits, unsigned rel) {
  return (bits[rel >> 5] >> (rel & 31)) & 1u;
}

// Where sorted key e is kept: e + e / 16. Unskewed, 8-byte keys 16 apart
// share a pair of banks, and the first levels of a binary search read keys
// 16 * 2^i apart, so its lanes would wait on each other there.
__device__ __forceinline__ int skewed(int e) { return e + (e >> 4); }

// The count, inverted: each column c of [c0, c1) (bits[] holds the mask of
// the window starting at lo, when has_mask) finds its bin among the sorted
// probe keys, sorted[skewed(0 .. ps)) (ps a power of two, padded with ~0):
// j = the number of probe keys <= its rank_key. The column ranks before
// exactly the probes of sorted place >= j, so it adds 1 to hist[j], and a
// prefix sum over the bins gives each probe its count. A masked column, or
// a NaN one (the largest key), lands past every probe and counts for none.
// A thread takes kColUnroll columns at once, so that their loads and
// searches overlap; with `loaded`, ck holds the keys of the first columns
// already (their loads were issued before the probes were listed).
__device__ __forceinline__ void count_columns(
    const float* __restrict__ row, const unsigned* bits, bool has_mask, int lo,
    int c0, int c1, const unsigned long long* sorted, int ps, int n_found,
    int* hist, unsigned long long (&ck)[kColUnroll], bool loaded) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = c0 + warp * 32; base < c1; base += kColUnroll * kRankThreads) {
    if (!loaded || base != c0 + warp * 32) {
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        const int c = base + u * kRankThreads + lane;
        ck[u] = c < c1 ? rank_key(__ldg(row + c), c) : ~0ull;
      }
    }
    int j[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int c = base + u * kRankThreads + lane;
      if (c < c1 && has_mask && bit_set(bits, (unsigned)(c - lo))) ck[u] = ~0ull;
      j[u] = 0;
    }
    for (int half = ps >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u)
        j[u] += sorted[skewed(j[u] + half - 1)] <= ck[u] ? half : 0;
    }
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      j[u] += sorted[skewed(j[u])] <= ck[u];
      if (j[u] < n_found) atomicAdd(&hist[j[u]], 1);
    }
  }
}

// Inclusive prefix sum of h over the CTA's threads (warp_sum: kRankWarps
// ints, free). Ends after a barrier.
__device__ __forceinline__ int block_scan(int h, int* warp_sum) {
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

// The cluster barrier split in two (cg's sync() is both): arrive releases
// this thread's writes, wait acquires every CTA's that arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Replaces _direct_rank_kernel. The exact rank of each probe id t of a row
// over the whole masked row of scores: the columns (v, c) with v > s or
// (v == s and c < t), s = row[t]; an id out of [0, n) or in the row's (B,
// L) mask table, or a score that is not finite, makes the probe miss and its
// rank k. As JAX's kernel, a NaN column never counts (neither compare holds).
// The parent ran one thread a probe slot over the whole row: padding slots
// worked as much as found probes, each slot scanned the mask row for its
// id, and a found probe's count was one lane's serial walk over all n
// columns, on the few SMs whose blocks held found probes (latency: 0.045 ms
// at B=64, N=3,706, T=488 on an H100). Here the work is per column, not per
// probe. The CTA issues every load first (its mask ids, its probe ids and
// their scores, its first columns), builds the row's mask as a bitmap once,
// lists its found probes (id in range, not masked, score finite) as packed
// keys (rank_key: one 64-bit compare a pair), gives each its place among
// them by counting the smaller keys (a handful to a few hundred a row), and
// inverts the count (count_columns): a binary search a column and one
// shared add, O(n log T_found) a row whatever its padding. Slots that hold
// no found probe only write k. Where the batch leaves SMs free, a row of
// at least 2 * kClusterCols columns is split over a cluster of cl CTAs
// (each lists and ranks the same probes); each adds its bins into the
// leader's histogram through distributed shared memory, and the leader
// (rank 0) prefix-sums them and writes the counts. Grid (B * cl,
// ceil(T / kRankThreads)),
// clusters of (cl, 1, 1) with kCluster. Rows wider than kWinCols build the
// bitmap a window at a time (twice: the list, then the count). Bound: bytes
// (the row, the mask row and the probes read once); the parent's work, a
// compare and an add per (found probe, column), takes less time still.
template <bool kCluster>
__global__ void __launch_bounds__(kRankThreads)
direct_rank_kernel(const float* __restrict__ scores, int n,
                   const int* __restrict__ mask, int L,
                   const int* __restrict__ tid, int t_count, int k,
                   int* __restrict__ out) {
  __shared__ unsigned bits[kBitWords];
  __shared__ unsigned long long listed[kRankThreads];
  __shared__ unsigned long long sorted[kRankThreads + kRankThreads / 16];
  __shared__ int hist[kRankThreads];
  __shared__ int warp_n[kRankWarps];
  const int cl = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const long long b = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = scores + b * n;
  const int* mrow = mask + b * L;   // L == 0 without a mask
  int* out_row = out + b * t_count;
  const bool one_window = n <= kWinCols;
  // every load first, so that their latencies overlap
  const int p = blockIdx.y * kRankThreads + threadIdx.x;
  const int t = p < t_count ? __ldg(tid + b * t_count + p) : -1;
  int m[kMaskUnroll];
#pragma unroll
  for (int u = 0; u < kMaskUnroll; ++u) {
    const int e = u * kRankThreads + threadIdx.x;
    m[u] = one_window && e < L ? __ldg(mrow + e) : -1;
  }
  const int per = ((n + cl - 1) / cl + 31) & ~31;
  const int c0 = min(n, rank * per), c1 = min(n, c0 + per);
  unsigned long long ck[kColUnroll];
#pragma unroll
  for (int u = 0; u < kColUnroll; ++u) {
    const int c = c0 + warp * 32 + u * kRankThreads + lane;
    ck[u] = one_window && c < c1 ? rank_key(__ldg(row + c), c) : ~0ull;
  }
  const bool in_row = t >= 0 && t < n;
  const float s = in_row ? __ldg(row + t) : 0.f;
  if (one_window)
    for (int e = threadIdx.x; e < (n + 31) >> 5; e += kRankThreads) bits[e] = 0u;
  hist[threadIdx.x] = 0;
  __syncthreads();
  if (kCluster) cluster_arrive();        // this CTA's histogram is zeroed
  bool masked = false;
  if (one_window) {
#pragma unroll
    for (int u = 0; u < kMaskUnroll; ++u)
      if ((unsigned)m[u] < (unsigned)n) atomicOr(&bits[m[u] >> 5], 1u << (m[u] & 31));
    for (int e = kMaskUnroll * kRankThreads + threadIdx.x; e < L; e += kRankThreads) {
      const unsigned id = (unsigned)__ldg(mrow + e);
      if (id < (unsigned)n) atomicOr(&bits[id >> 5], 1u << (id & 31));
    }
    __syncthreads();
    masked = in_row && L > 0 && bit_set(bits, (unsigned)t);
  } else {
    for (int lo = 0; L > 0 && lo < n; lo += kWinCols) {
      const int width = min(kWinCols, n - lo);
      build_bits(bits, mrow, L, lo, width);
      const unsigned rel = (unsigned)t - (unsigned)lo;
      if (in_row && rel < (unsigned)width) masked = bit_set(bits, rel);
    }
  }
  // the found probes, listed in slot order as packed keys
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
  const unsigned long long pk = found ? rank_key(s, t) : 0ull;
  if (found) listed[pos] = pk;
  __syncthreads();
  if (n_found == 0) {                    // the same in every CTA of the cluster
    if (kCluster) cluster_wait();
    return;
  }
  // each found probe's place among them: the smaller keys, ties by slot
  int ps = 1;
  while (ps < n_found) ps <<= 1;
  int r = 0;
  if (found) {
    int j = 0;
    for (; j + 4 <= n_found; j += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned long long kj = listed[j + q];
        r += (kj < pk) | ((kj == pk) & (j + q < pos));
      }
    }
    for (; j < n_found; ++j) {
      const unsigned long long kj = listed[j];
      r += (kj < pk) | ((kj == pk) & (j < pos));
    }
    sorted[skewed(r)] = pk;
  }
  if ((int)threadIdx.x >= n_found && (int)threadIdx.x < ps)
    sorted[skewed(threadIdx.x)] = ~0ull;
  __syncthreads();
  if (one_window) {
    count_columns(row, bits, L > 0, 0, c0, c1, sorted, ps, n_found, hist, ck, true);
  } else {
    for (int lo = 0; lo < n; lo += kWinCols) {
      const int a = max(c0, lo), e = min(c1, lo + kWinCols);
      if (a >= e) continue;          // the same in every thread of the CTA
      if (L > 0) build_bits(bits, mrow, L, lo, min(kWinCols, n - lo));
      count_columns(row, bits, L > 0, lo, a, e, sorted, ps, n_found, hist, ck, false);
    }
  }
  __syncthreads();                       // this CTA's histogram is complete
  if (kCluster) {
    cluster_wait();                      // every CTA's histogram was zeroed
    if (rank != 0 && (int)threadIdx.x < n_found && hist[threadIdx.x])
      atomicAdd(cg::this_cluster().map_shared_rank(hist, 0) + threadIdx.x,
                hist[threadIdx.x]);
    cg::this_cluster().sync();           // the leader's histogram is complete
  }
  if (rank == 0) {
    const int h = block_scan((int)threadIdx.x < n_found ? hist[threadIdx.x] : 0,
                             warp_n);
    hist[threadIdx.x] = h;
    __syncthreads();
    if (found) out_row[p] = hist[r];
  }
}

// CTAs a row's columns are split over: at least kClusterCols columns each,
// B * cl within the SM count, at most kMaxCluster (1: no cluster).
int direct_rank_cluster(int b, int n, int sms) {
  return std::max(1, std::min({sms / std::max(b, 1), n / kClusterCols, kMaxCluster}));
}

int launch_direct_rank(const float* scores, int b, int n, const int* mask, int L,
                       const int* tid, int t, int k, int* out, int cl,
                       cudaStream_t stream) {
  const int slices = (t + kRankThreads - 1) / kRankThreads;
  if ((long long)b * cl > INT_MAX || slices > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * cl), (unsigned)slices);
  cfg.blockDim = dim3(kRankThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;         // one CTA a row: no cluster
  const cudaError_t err =
      cl > 1 ? cudaLaunchKernelEx(&cfg, direct_rank_kernel<true>, scores, n, mask, L,
                                  tid, t, k, out)
             : cudaLaunchKernelEx(&cfg, direct_rank_kernel<false>, scores, n, mask, L,
                                  tid, t, k, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int skrx_rank_counts_abi_version() { return 1; }

int skrx_rank_count(const float* vals, const int* ids, int b, int w,
                    const float* st, const int* tid, int t, int* out,
                    cudaStream_t stream) {
  const dim3 grid(b, (t + kCountBlockProbes - 1) / kCountBlockProbes);
  rank_count_kernel<<<grid, kCountWarps * 32, 0, stream>>>(vals, ids, w, st,
                                                            tid, t, out);
  return (int)cudaGetLastError();
}

int skrx_rank_lookup_count(const float* vals, const int* ids, int b, int w,
                           const int* tid, int t, int* out, bool* found,
                           cudaStream_t stream) {
  const dim3 grid(b, (t + kCountBlockProbes - 1) / kCountBlockProbes);
  rank_lookup_count_kernel<<<grid, kCountWarps * 32, 0, stream>>>(
      vals, ids, w, tid, t, out, found);
  return (int)cudaGetLastError();
}

int skrx_direct_rank(const float* scores, int b, int n, const int* mask, int L,
                     const int* tid, int t, int k, int* out,
                     cudaStream_t stream) {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_direct_rank(scores, b, n, mask, L, tid, t, k, out,
                            direct_rank_cluster(b, n, sms[dev]), stream);
}

}  // extern "C"
