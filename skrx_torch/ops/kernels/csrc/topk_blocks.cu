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
// columns a thread of extract holds in registers
constexpr int kExtractCols = kMaxBlockN / kExtractThreads;
// Most survivors of a block that extract ranks directly (F); above it a tie
// storm takes k argmax rounds. At F a thread ranks one survivor in F
// shared-memory reads, about the cost of two or three rounds.
constexpr int kRankCap = kExtractThreads;
constexpr int kMaskBatch = 8;                 // mask ids a thread loads at once
constexpr int kMergeThreads = 256;
// Most survivors of a row that pruned_merge ranks directly (F), one a
// thread; above it a tie storm takes k argmax rounds. The chunked merge at
// k <= 128 (W = 2k) stays below it. On an H100 (chip_ab.py, B=64 rows of
// distinct survivors) the rank pass at F took 0.005-0.006 ms, the rounds
// at F + 1 0.0095 ms at k = 10 and 0.042 at k = 50.
constexpr int kMergeCap = kMergeThreads;

struct Pair {
  float v;
  int id;
};

struct Cand {       // a candidate of pruned_merge with its lane in the row
  float v;
  int id;
  int lane;
};

// true when (av, aid) ranks before (bv, bid): value desc, then id asc
__device__ __forceinline__ bool before(float av, int aid, float bv, int bid) {
  return av > bv || (av == bv && aid < bid);
}

__device__ __forceinline__ Pair better(Pair a, Pair b) {
  return before(b.v, b.id, a.v, a.id) ? b : a;
}

// b replaces a when it ranks before a, or when it is the same pair (value
// ==, id ==) from a lower lane
__device__ __forceinline__ Cand better(Cand a, Cand b) {
  const bool take = before(b.v, b.id, a.v, a.id) ||
                    (b.v == a.v && b.id == a.id && b.lane < a.lane);
  return take ? b : a;
}

__device__ __forceinline__ Pair shfl_xor(Pair p, int off) {
  return Pair{__shfl_xor_sync(0xffffffffu, p.v, off),
              __shfl_xor_sync(0xffffffffu, p.id, off)};
}

__device__ __forceinline__ Cand shfl_xor(Cand p, int off) {
  return Cand{__shfl_xor_sync(0xffffffffu, p.v, off),
              __shfl_xor_sync(0xffffffffu, p.id, off),
              __shfl_xor_sync(0xffffffffu, p.lane, off)};
}

template <class P>
__device__ __forceinline__ P warp_best(P p) {
  for (int off = 16; off > 0; off >>= 1) p = better(p, shfl_xor(p, off));
  return p;
}

// Best of the block's P, returned to every thread. sh holds 33; none is
// what a warp past the block's last holds.
template <class P>
__device__ P block_best(P p, P* sh, P none) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  p = warp_best(p);
  if (lane == 0) sh[wid] = p;
  __syncthreads();
  if (wid == 0) {
    P q = lane < (int)(blockDim.x >> 5) ? sh[lane] : none;
    q = warp_best(q);
    if (lane == 0) sh[32] = q;
  }
  __syncthreads();
  const P r = sh[32];
  __syncthreads();
  return r;
}

// Thread t's columns t + 256 q (q < kExtractCols) of a column block of
// ``width`` columns starting at row, -inf past the block, loaded in one
// batch: a block of kExtractThreads threads issues the whole block's scores
// before it waits on anything.
__device__ __forceinline__ void load_columns(float (&v)[kExtractCols],
                                             const float* __restrict__ row,
                                             int width) {
#pragma unroll
  for (int q = 0; q < kExtractCols; ++q) {
    const int c = threadIdx.x + kExtractThreads * q;
    v[q] = c < width ? __ldg(row + c) : -INFINITY;
  }
}

// Ids e0 + 256 u (u < kMaskBatch) of a mask row, -1 past L: one batch of
// scan_mask_bits, the first loaded where the caller wants it in flight.
__device__ __forceinline__ void load_mask_batch(int (&id)[kMaskBatch],
                                                const int* __restrict__ mask_row,
                                                int L, int e0) {
#pragma unroll
  for (int u = 0; u < kMaskBatch; ++u) {
    const int e = e0 + u * kExtractThreads;
    id[u] = e < L ? __ldg(mask_row + e) : -1;
  }
}

// Bit c of bits = 1 when column lo + c of this row is in its mask row. `id`
// holds the thread's first batch (load_mask_batch at e0 = threadIdx.x);
// the rest of the row follows kMaskBatch ids a thread at once (one batch
// for L <= 2,048 with kExtractThreads threads). Ids outside [lo, lo +
// width) (other blocks, padding, out of range) are ignored; duplicates are
// harmless. The caller's next barrier completes the bitmap.
__device__ __forceinline__ void scan_mask_bits(unsigned* bits,
                                               const int* __restrict__ mask_row,
                                               int L, int lo, int width,
                                               int (&id)[kMaskBatch]) {
  for (int w = threadIdx.x; w < kMaskWords; w += kExtractThreads) bits[w] = 0u;
  __syncthreads();
  for (int e0 = threadIdx.x; e0 < L; e0 += kMaskBatch * kExtractThreads) {
    if (e0 != (int)threadIdx.x) load_mask_batch(id, mask_row, L, e0);
#pragma unroll
    for (int u = 0; u < kMaskBatch; ++u) {
      const long long rel = (long long)id[u] - lo;
      if (rel >= 0 && rel < width) atomicOr(&bits[rel >> 5], 1u << (rel & 31));
    }
  }
}

__device__ __forceinline__ bool is_masked(const unsigned* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// Order-preserving f32 -> int32 map of the JAX kernel: -inf lowest, -0.0
// below +0.0; an involution, so it also maps back.
__device__ __forceinline__ int order_key(int i) {
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

// The key under which jnp.maximum takes its max: order_key, with every NaN
// (either sign) above +inf. order_key maps the largest key back to a NaN.
__device__ __forceinline__ int max_key(float v) {
  const int i = __float_as_int(v);
  return (i & 0x7FFFFFFF) > 0x7F800000 ? INT_MAX : order_key(i);
}

// Replaces _submax_kernel. Grid (B, column blocks) of kExtractThreads
// threads: out[b, j*128 + l] = the max of the masked columns l + 128 t of
// block j, as jnp.maximum folds them (NaN when the group holds one, -0.0
// below +0.0). A block's time is latency, a mask read and a score read,
// not bytes; so thread t loads its first 8 mask ids and then columns t +
// 256 q (q < 16) into registers before the mask scan (extract's load and
// scan, the same device functions), and both reads are in flight together,
// the ids first so that the scan's loads do not queue behind the scores'
// (experiments/submax_variants.py times the other order). Its 16 columns
// all belong to group t % 128: a thread takes their max as order keys (one
// integer max a column), threads t and t + 128 meet in shared memory, and
// 128 threads write. Held to 6 blocks an SM, or with the scores staged in
// shared memory to run 8, it was slower (the same script). Bound: bytes
// (one read of the scores and the mask table, B x 128 maxima per block
// written).
__global__ void __launch_bounds__(kExtractThreads)
submax_kernel(const float* __restrict__ scores, int n, int block_n,
              const int* __restrict__ mask, int L, float* __restrict__ out,
              int out_w) {
  __shared__ unsigned bits[kMaskWords];
  __shared__ int upper[kLanes];
  const long long b = blockIdx.x;
  const int j = blockIdx.y;
  const int lo = j * block_n;
  const int width = min(block_n, n - lo);
  const int tid = threadIdx.x;
  int id[kMaskBatch];
  if (mask != nullptr) load_mask_batch(id, mask + b * L, L, tid);
  float v[kExtractCols];
  load_columns(v, scores + b * n + lo, width);
  if (mask != nullptr) {
    scan_mask_bits(bits, mask + b * L, L, lo, width, id);
    __syncthreads();
  }
  int m = order_key(__float_as_int(-INFINITY));
#pragma unroll
  for (int q = 0; q < kExtractCols; ++q) {
    if (mask == nullptr || !is_masked(bits, tid + kExtractThreads * q))
      m = max(m, max_key(v[q]));
  }
  if (tid >= kLanes) upper[tid - kLanes] = m;
  __syncthreads();
  if (tid < kLanes)
    out[b * out_w + (long long)j * kLanes + tid] =
        __int_as_float(order_key(max(m, upper[tid])));
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

// Replaces _extract_kernel. Grid (B, column blocks) of kExtractThreads
// threads; thread t holds columns t + 256 q (q < kExtractCols) of its block
// in registers, loaded before the mask is scanned so that both reads are in
// flight at once. The block turns its row's mask table into a shared bitmap
// (the ids batched kMaskBatch a thread, one round trip for L <= 2,048), then
// lists the finite unmasked elements >= tau in shared memory (one shared
// atomic a warp and a column step). Those survivors are usually a handful:
// tau is the k-th largest group max, and the evaluation shape (B=64, k=50,
// 11 blocks a row) sends ~5-10 to a block. Every survivor is then written
// straight to its slot: thread i counts the survivors that rank before
// survivor i by (value desc, column asc), reading the list as shared-memory
// broadcasts, and writes it to slot rank_i when rank_i < k. Columns are
// distinct, so the ranks are a permutation and the slots are those of a
// selection in that order, signed zeros included; no barrier is needed
// between ranks. The slots from min(k, found) to k get (-inf, sentinel).
// A tie storm (more than kRankCap survivors, up to the whole block when
// every column equals tau) would cost O(found^2) that way; it takes k
// rounds of a block-wide argmax over the registers instead, each picking
// the best pair after the last one picked, so its cost stays bounded by k.
// Every element of the row's top-k is >= tau and in its block's top-k, so
// the (B, n_blocks * k) output is a superset of it, each element at most
// once. Bound: bytes (one read of the scores and mask table, the
// candidates written).
__global__ void __launch_bounds__(kExtractThreads)
extract_kernel(const float* __restrict__ scores, int n, int block_n,
               const int* __restrict__ mask, int L,
               const float* __restrict__ tau, int k,
               float* __restrict__ out_v, int* __restrict__ out_i, int out_w) {
  __shared__ unsigned bits[kMaskWords];
  __shared__ float sv[kRankCap];
  __shared__ int si[kRankCap];
  __shared__ Pair sh[33];
  __shared__ int found_sh;
  const long long b = blockIdx.x;
  const int j = blockIdx.y;
  const int lo = j * block_n;
  const int width = min(block_n, n - lo);
  const float* row = scores + b * n + lo;
  const int tid = threadIdx.x, lane = tid & 31;
  float v[kExtractCols];
  load_columns(v, row, width);
  const float t = __ldg(tau + b);
  if (tid == 0) found_sh = 0;
  if (mask != nullptr) {
    int id[kMaskBatch];
    load_mask_batch(id, mask + b * L, L, tid);
    scan_mask_bits(bits, mask + b * L, L, lo, width, id);
  }
  __syncthreads();
  unsigned keep = 0u;                 // bit q: column tid + 256 q survives
#pragma unroll
  for (int q = 0; q < kExtractCols; ++q) {
    const int c = tid + kExtractThreads * q;
    const bool ok = v[q] >= t && v[q] != -INFINITY &&
                    (mask == nullptr || !is_masked(bits, c));
    keep |= (unsigned)ok << q;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ballot != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&found_sh, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      const int p = base + __popc(ballot & ((1u << lane) - 1u));
      if (ok && p < kRankCap) {
        sv[p] = v[q];
        si[p] = c;
      }
    }
  }
  __syncthreads();
  const int found = found_sh;
  float* ov = out_v + b * out_w + (long long)j * k;
  int* oi = out_i + b * out_w + (long long)j * k;
  if (found <= kRankCap) {
    if (tid < found) {
      const float vi = sv[tid];
      const int ci = si[tid];
      int rank = 0;
      for (int e = 0; e < found; ++e) rank += before(sv[e], si[e], vi, ci);
      if (rank < k) {
        ov[rank] = vi;
        oi[rank] = lo + ci;
      }
    }
  } else {
    Pair prev{INFINITY, -1};
    for (int r = 0; r < min(k, found); ++r) {
      Pair best{-INFINITY, INT_MAX};
#pragma unroll
      for (int q = 0; q < kExtractCols; ++q) {
        const Pair p{v[q], tid + kExtractThreads * q};
        if (((keep >> q) & 1u) && (r == 0 || before(prev.v, prev.id, p.v, p.id)))
          best = better(best, p);
      }
      best = block_best(best, sh, Pair{-INFINITY, INT_MAX});
      if (tid == 0) {
        ov[r] = best.v;
        oi[r] = lo + best.id;
      }
      prev = best;
    }
  }
  for (int r = min(k, found) + tid; r < k; r += kExtractThreads) {
    ov[r] = -INFINITY;
    oi[r] = kSentinel;
  }
}

__device__ __forceinline__ Pair unpack(float2 p) {
  return Pair{p.x, __float_as_int(p.y)};
}

// Replaces _pruned_merge_kernel (and, with tau = -inf, _vmem_topk_kernel).
// One block a row. A survivor is a candidate with v >= tau and v != -inf
// (NaN fails >=). The block lists the row's survivors in shared memory with
// their lanes (one shared atomic a warp and a step of the row), then ranks
// them in one pass, as extract does: thread i counts the survivors that
// rank before survivor i by (value desc, id asc), reading the list as
// shared-memory broadcasts, and writes survivor i to slot rank_i when
// rank_i < k. The same pass counts the survivors that hold survivor i's
// pair (value ==, id ==). When some pair repeats (rare: the main path's
// candidates are distinct), a second pass takes only the first of each
// pair, the one from the lowest lane (so -0.0 and +0.0 of one id are one
// pair with the lowest lane's sign bit, as in pruned_merge_plain), and
// ranks it among the first ones. Either way the ranks are a permutation of
// distinct pairs and need no barrier between them; the slots from
// min(k, #distinct) to k get (-inf, sentinel). At the chunked evaluation's
// merge (W=100, every candidate a survivor) that is one row load and ~100
// shared reads a thread where the parent ran k = 50 block-wide argmax
// rounds. Above kMergeCap survivors (a tie storm, a wide row, up to W =
// 16,984 in the tests) the list would cost O(found^2); the row takes k
// argmax rounds instead, each the best (value, id, lane) after the last
// pick, read from global memory, so its cost stays bounded by k. Bound:
// bytes of the (B, W) candidates and the (B, k) output.
__global__ void __launch_bounds__(kMergeThreads)
pruned_merge_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                    int w, const float* __restrict__ tau, int k,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float2 sp[kMergeCap];   // (value, id bits): one 8-byte read
  __shared__ int sl[kMergeCap];
  __shared__ bool sfirst[kMergeCap];
  __shared__ Cand sh[33];
  __shared__ int found_sh;
  const long long b = blockIdx.x;
  const float* rv = vals + b * w;
  const int* ri = ids + b * w;
  const float t = __ldg(tau + b);
  float* ov = out_v + b * k;
  int* oi = out_i + b * k;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) found_sh = 0;
  __syncthreads();
  for (int e0 = 0; e0 < w; e0 += kMergeThreads) {
    const int e = e0 + tid;
    const Pair p = e < w ? Pair{__ldg(rv + e), __ldg(ri + e)}
                         : Pair{-INFINITY, kSentinel};
    const bool ok = p.v >= t && p.v != -INFINITY;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ballot != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&found_sh, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      const int q = base + __popc(ballot & ((1u << lane) - 1u));
      if (ok && q < kMergeCap) {
        sp[q] = make_float2(p.v, __int_as_float(p.id));
        sl[q] = e;
      }
    }
  }
  __syncthreads();
  const int found = found_sh;
  int distinct;
  if (found <= kMergeCap) {
    bool mine = tid < found;
    const Pair me = mine ? unpack(sp[tid]) : Pair{0.f, 0};
    int rank = 0, same = 0;
    if (mine) {
      for (int j = 0; j < found; ++j) {
        const Pair o = unpack(sp[j]);
        rank += before(o.v, o.id, me.v, me.id);
        same += (o.v == me.v) & (o.id == me.id);
      }
    }
    distinct = found;
    if (__syncthreads_or(same > 1)) {   // a pair repeats: rank distinct pairs
      if (mine) {
        const int my_lane = sl[tid];
        for (int j = 0; j < found; ++j) {
          const Pair o = unpack(sp[j]);
          if (o.v == me.v && o.id == me.id && sl[j] < my_lane) mine = false;
        }
        sfirst[tid] = mine;
      }
      distinct = __syncthreads_count(mine);
      if (mine) {
        rank = 0;
        for (int j = 0; j < found; ++j) {
          const Pair o = unpack(sp[j]);
          rank += sfirst[j] && before(o.v, o.id, me.v, me.id);
        }
      }
    }
    if (mine && rank < k) {
      ov[rank] = me.v;
      oi[rank] = me.id;
    }
  } else {
    Cand prev{INFINITY, INT_MIN, -1};
    int r = 0;
    for (; r < k; ++r) {
      Cand best{-INFINITY, INT_MAX, INT_MAX};
      for (int e = tid; e < w; e += kMergeThreads) {
        const Cand p{__ldg(rv + e), __ldg(ri + e), e};
        if (p.v >= t && p.v != -INFINITY &&
            (r == 0 || before(prev.v, prev.id, p.v, p.id)))
          best = better(best, p);
      }
      best = block_best(best, sh, Cand{-INFINITY, INT_MAX, INT_MAX});
      if (best.v == -INFINITY) break;     // no survivor after prev
      if (tid == 0) {
        ov[r] = best.v;
        oi[r] = best.id;
      }
      prev = best;
    }
    distinct = r;
  }
  for (int q = min(k, distinct) + tid; q < k; q += kMergeThreads) {
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
  submax_kernel<<<dim3(b, n_blocks), kExtractThreads, 0, stream>>>(
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
