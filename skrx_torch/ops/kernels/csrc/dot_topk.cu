// Fused score-and-select for dot models, written by hand for Hopper
// (sm_90a). Port of the two Pallas kernels of skrx/ops/pallas/dot_topk.py:
//
//   skrx_dot_submax   <- _dot_submax_kernel   (dot_topk.py:109)
//   skrx_dot_extract  <- _dot_extract_kernel  (dot_topk.py:115)
//
// Each computes what skrx_submax / skrx_extract (topk_blocks.cu) compute on
// the score matrix uv @ items^T + bias, but every score is computed inside
// the kernel from the (B, d) user vectors and the packed item table: no
// (B, N) tensor exists.
//
// Score arithmetic is fixed so that the kernels equal their plain PyTorch
// version bit for bit: acc = 0; for c in 0..d-1: acc = acc + u[c] * it[c],
// each product and each sum rounded (__fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA), then acc + bias. The selection that follows does
// no arithmetic.
//
// Layout. The packed table is (d4 / 4, n_pad, 4) f32: for each quad q of
// four dimensions, the n_pad columns' four values side by side, so a
// 128-column stripe of one quad is 2 KB of contiguous bytes. n_pad is a
// multiple of block_n; pad columns have zero vectors and bias -inf, so they
// score -inf and are never selected. uv is (B_pad, d4) with zero rows and
// columns past (B, d).
//
// Staging, the same in both kernels (Stripes below). A CTA takes TR (16 or
// 32) user rows and a slice of one column block: the block's CTAs form a
// cluster of cl (1..8) CTAs, each scoring block_n / cl columns, so that a
// small batch still spreads over the card (fused_grid picks TR and cl from B
// and the SM count). Warps 0..7 score; one lane of warp 8, the producer,
// feeds them. The tile's user rows are copied into shared memory once. The
// item table streams through a ring of kStages stages; a stage holds four
// quads of one 128-column stripe (8 KB), copied by the producer with
// cp.async.bulk (one 2 KB copy per quad) and completed on the stage's "full"
// mbarrier; each scoring warp arrives on the stage's "empty" mbarrier once
// it has read it. The eight warps are TR / 4 row groups of 4 rows by 32 / TR
// column parts; a thread scores its group's 4 rows against CT = TR / 8
// columns of each stripe (lane + 32 j of its part), a register tile whose
// item quads are reused across the four rows in registers and whose user
// quads are warp-wide broadcasts from shared memory. The four quads of a
// stage are unrolled; with d = 64 (kDQ = 16) the stage count of a stripe is
// a constant too, other d take the generic instantiation. A thread's
// columns of every stripe are the same strided groups (column % 128), so
// dot_submax keeps their running maxima in registers. Each kernel then
// hands every score to its own epilogue. Bound: operations, 2*B*N*d f32
// (mul and add issued apart, as the exact order needs).
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the wrappers in ../dot_topk.py check shapes, types
// and devices, pack and pad the operands, allocate the outputs and count
// launches. A refused cluster launch or shared-memory opt-in returns its
// CUDA error.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;                    // strided groups per block
constexpr int kMaxBlockN = 4096;
constexpr int kMaskWords = kMaxBlockN / 32;
constexpr int kSentinel = INT_MAX / 2;
constexpr int kXRT = 4;                        // rows a thread scores
constexpr int kXWarps = 8;                     // scoring warps
constexpr int kXThreads = (kXWarps + 1) * 32;  // and the producer's warp
constexpr int kStripe = kLanes;                // columns of a stripe
constexpr int kStageQuads = 4;
constexpr int kStages = 4;
constexpr int kStageFloats = kStageQuads * kStripe * 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxQuads = 128;                 // d <= 512
constexpr int kMaxTile = 32;
constexpr int kListBytes = 64 * 1024;          // survivor lists of a tile
// dynamic shared memory of the largest launch: the ring, the user rows and
// extract's lists (more than submax's partial maxima, kMaxTile * kLanes * 4)
constexpr int kMaxXDyn = kStages * kStageFloats * 4 + kMaxTile * kMaxQuads * 16
                         + kListBytes;

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

__device__ __forceinline__ float madd(float acc, float u, float it) {
  return __fadd_rn(acc, __fmul_rn(u, it));
}

__device__ __forceinline__ float quad_dot(float acc, float4 u, float4 it) {
  acc = madd(acc, u.x, it.x);
  acc = madd(acc, u.y, it.y);
  acc = madd(acc, u.z, it.z);
  return madd(acc, u.w, it.w);
}

// One score without the bias, the same arithmetic as the staged loop (the
// overflow path of extract).
__device__ __forceinline__ float dot_one(const float4* __restrict__ u4, int dq,
                                         const float4* __restrict__ it4,
                                         long long n_pad, long long col) {
  float acc = 0.f;
  for (int q = 0; q < dq; ++q) acc = quad_dot(acc, __ldg(u4 + q), __ldg(it4 + q * n_pad + col));
  return acc;
}

// jnp.maximum as dot_submax needs it: NaN when either is NaN (max.NaN,
// sm_80+); no score is -0.0 (see dot_submax_kernel), so no signed-zero tie
// needs ordering.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ bool masked_at(const unsigned* row_bits, int c) {
  return (row_bits[c >> 5] >> (c & 31)) & 1u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The staging both kernels share: this CTA's place in the grid and its
// cluster, the ring and its barriers, the tile's user rows (see the top of
// the file). Dynamic shared memory starts with the ring, then the user
// rows; a kernel's own arrays follow at tail().
template <int TR, int kDQ>
struct Stripes {
  static constexpr int kParts = kXWarps / (TR / kXRT);  // column parts of a stripe
  static constexpr int kCT = kStripe / (32 * kParts);   // columns a thread scores

  const float* items;
  const float* bias;
  long long n_pad, row0;
  int dq, lo, c0, slice, n_qst, n_steps;
  float* ring;          // [kStages][kStageFloats]
  float4* users;        // [TR][dq]
  unsigned long long* full_bar;
  unsigned long long* empty_bar;

  __device__ __forceinline__ Stripes(const float* items_, const float* bias_, long long n_pad_,
                     int dq_arg, int block_n, int cl, int rank, unsigned char* dyn,
                     unsigned long long* full, unsigned long long* empty)
      : items(items_), bias(bias_), n_pad(n_pad_),
        row0((long long)blockIdx.x * TR), dq(kDQ > 0 ? kDQ : dq_arg),
        lo(blockIdx.y / cl * block_n), c0(rank * (block_n / cl)),
        slice(block_n / cl), n_qst((dq + kStageQuads - 1) / kStageQuads),
        n_steps(block_n / cl / kStripe * n_qst),
        ring(reinterpret_cast<float*>(dyn)),
        users(reinterpret_cast<float4*>(ring + kStages * kStageFloats)),
        full_bar(full), empty_bar(empty) {}

  __device__ __forceinline__ unsigned char* tail() const {
    return reinterpret_cast<unsigned char*>(users + TR * dq);
  }

  static constexpr int dyn_bytes(int dq) { return kStages * kStageFloats * 4 + TR * dq * 16; }

  // the group (column % 128) of a thread's column j of every stripe
  static __device__ __forceinline__ int group(int j) {
    return ((threadIdx.x >> 5) % kParts) * 32 * kCT + (threadIdx.x & 31) + 32 * j;
  }

  // the producer's copies of step `step` (stripe step / n_qst, its quads
  // from 4 (step % n_qst) on) into stage step % kStages
  __device__ __forceinline__ void issue(int step) const {
    const int s = step % kStages, q0 = step % n_qst * kStageQuads;
    const int qn = min(kStageQuads, dq - q0);
    const long long col = lo + c0 + (long long)(step / n_qst) * kStripe;
    mbar_expect(&full_bar[s], qn * kStripe * 16);
    for (int q = 0; q < qn; ++q)
      bulk_copy(ring + s * kStageFloats + q * kStripe * 4,
                items + ((long long)(q0 + q) * n_pad + col) * 4, kStripe * 16,
                &full_bar[s]);
  }

  // the producer, before the CTA's first barrier
  __device__ __forceinline__ void init_ring() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kXWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // the producer, after that barrier: the first stages; every thread then
  // copies the tile's user rows
  __device__ __forceinline__ void start(bool producer, const float* uv) const {
    if (producer)
      for (int step = 0; step < min(kStages, n_steps); ++step) issue(step);
    const float4* uv4 = reinterpret_cast<const float4*>(uv) + row0 * dq;
    for (int e = threadIdx.x; e < TR * dq; e += kXThreads) users[e] = __ldg(uv4 + e);
  }

  // the producer: the remaining stages, each once the warps have read it
  __device__ __forceinline__ void produce() const {
    for (int step = kStages; step < n_steps; ++step) {
      mbar_wait(&empty_bar[step % kStages], ((step / kStages) & 1) ^ 1);
      issue(step);
    }
  }

  // A scoring warp: every score of its rows and columns of the slice, in
  // stripe order, to on_score(i, j, r, c, v): tile row r = 4 (row group) +
  // i, block column c (its group is group(j)), v = acc + bias.
  template <class OnScore>
  __device__ __forceinline__ void score(OnScore&& on_score) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rg = warp / kParts, part = warp % kParts;
    const float4* u4 = users + rg * kXRT * dq;
    int step = 0;
    for (int c_st = c0; c_st < c0 + slice; c_st += kStripe) {
      float acc[kXRT][kCT];
#pragma unroll
      for (int i = 0; i < kXRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) acc[i][j] = 0.f;
      for (int qs = 0; qs < n_qst; ++qs, ++step) {
        const int s = step % kStages, q0 = qs * kStageQuads;
        mbar_wait(&full_bar[s], (step / kStages) & 1);
        const float4* it4 = reinterpret_cast<const float4*>(ring + s * kStageFloats)
                            + part * 32 * kCT + lane;
#pragma unroll
        for (int q = 0; q < kStageQuads; ++q) {
          if (q0 + q < dq) {
            float4 u[kXRT], it[kCT];
#pragma unroll
            for (int i = 0; i < kXRT; ++i) u[i] = u4[i * dq + q0 + q];
#pragma unroll
            for (int j = 0; j < kCT; ++j) it[j] = it4[q * kStripe + 32 * j];
#pragma unroll
            for (int i = 0; i < kXRT; ++i)
#pragma unroll
              for (int j = 0; j < kCT; ++j) acc[i][j] = quad_dot(acc[i][j], u[i], it[j]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[s]);
      }
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int c = c_st + part * 32 * kCT + lane + 32 * j;
        const float bj = __ldg(bias + lo + c);
#pragma unroll
        for (int i = 0; i < kXRT; ++i)
          on_score(i, j, rg * kXRT + i, c, __fadd_rn(acc[i][j], bj));
      }
    }
  }
};

// The tile's mask rows (rows < b), scanned once by the cluster: CTA `rank`
// takes its share of the entries, four loads in flight a thread, and sets
// bit (r, id - lo) in the bitmap [TR][kMaskWords] that bits_of(id - lo)
// returns (this CTA's or another's of the cluster: a remote atomicOr). Ids
// outside [lo, lo + width) are ignored; duplicates are harmless.
template <int TR, class BitsOf>
__device__ __forceinline__ void scan_mask(const int* __restrict__ mask, int L,
                                          long long row0, int b, int lo, int width,
                                          int rank, int cl, BitsOf&& bits_of) {
  const int total = (int)(b - row0 < TR ? b - row0 : TR) * L;
  const int stride = cl * kXThreads;
  const int* m = mask + row0 * L;
  for (int e0 = rank * kXThreads + threadIdx.x; e0 < total; e0 += 4 * stride) {
    int id[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) id[u] = e0 + u * stride < total ? __ldg(m + e0 + u * stride) : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * stride;
      const long long rel = (long long)id[u] - lo;
      if (e < total && rel >= 0 && rel < width)
        atomicOr(bits_of((int)rel) + (e / L) * kMaskWords + (rel >> 5), 1u << (rel & 31));
    }
  }
}

// Replaces _dot_submax_kernel. out[b, j*128 + l] = the max of the masked
// scores of block j's group l (columns j*block_n + l + 128*t). Each CTA
// owns the bitmap of its slice's columns: the cluster's scan sets each bit
// in the owner's shared memory, so every score tests its bit locally. A
// thread keeps the running maxima of its 4 rows and CT groups over the
// slice's stripes and leaves them in the CTA's partial maxima [TR][128];
// after a cluster barrier CTA `rank` takes every cl-th entry of the tile,
// folds the cl CTAs' partials in rank order (distributed shared memory)
// and writes it. Max is exact in any order and keeps NaN, as jnp.maximum
// does (a NaN score makes its group's max NaN); no score is -0.0 (acc
// starts at +0.0, and a rounded sum is -0.0 only when both terms are), so a
// zero maximum is +0.0.
template <int TR, int kDQ>
__global__ void __launch_bounds__(kXThreads, TR == 16 ? 3 : 2)
dot_submax_kernel(const float* __restrict__ uv, int b, int dq_arg,
                  const float* __restrict__ items, const float* __restrict__ bias,
                  int n, long long n_pad, int block_n,
                  const int* __restrict__ mask, int L, float* __restrict__ out,
                  int out_w) {
  using S = Stripes<TR, kDQ>;
  __shared__ unsigned bits[TR][kMaskWords];
  __shared__ __align__(8) unsigned long long full_bar[kStages], empty_bar[kStages];
  extern __shared__ __align__(16) unsigned char dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const S st(items, bias, n_pad, dq_arg, block_n, cl, rank, dyn, full_bar, empty_bar);
  float* part = reinterpret_cast<float*>(st.tail());              // [TR][kLanes]
  const int warp = threadIdx.x >> 5;
  const bool producer = threadIdx.x == kXWarps * 32;
  const int width = min(block_n, n - st.lo);

  if (producer) st.init_ring();
  for (int e = threadIdx.x; e < TR * kMaskWords; e += kXThreads) (&bits[0][0])[e] = 0u;
  __syncthreads();
  st.start(producer, uv);
  cluster.sync();            // every CTA's bitmap is 0
  if (mask != nullptr)
    scan_mask<TR>(mask, L, st.row0, b, st.lo, width, rank, cl, [&](int rel) {
      return cluster.map_shared_rank(&bits[0][0], rel / st.slice);
    });
  cluster.sync();            // every CTA's bitmap is complete

  if (warp < kXWarps) {
    float m[kXRT][S::kCT];
#pragma unroll
    for (int i = 0; i < kXRT; ++i)
#pragma unroll
      for (int j = 0; j < S::kCT; ++j) m[i][j] = -INFINITY;
    st.score([&](int i, int j, int r, int c, float v) {
      if (mask == nullptr || !masked_at(bits[r], c)) m[i][j] = max_nan(m[i][j], v);
    });
    const int rg = warp / S::kParts;
#pragma unroll
    for (int i = 0; i < kXRT; ++i)
#pragma unroll
      for (int j = 0; j < S::kCT; ++j) part[(rg * kXRT + i) * kLanes + S::group(j)] = m[i][j];
  } else if (producer) {
    st.produce();
  }
  __syncwarp();
  cluster.sync();            // every CTA's partial maxima are complete
  const int j_blk = blockIdx.y / cl;
  for (int e = rank * kXThreads + threadIdx.x; e < TR * kLanes; e += cl * kXThreads) {
    const long long row = st.row0 + e / kLanes;
    if (row >= b) break;
    float v = part[e];
    for (int q = 0; q < cl; ++q)
      if (q != rank) v = max_nan(v, cluster.map_shared_rank(part, q)[e]);
    out[row * out_w + (long long)j_blk * kLanes + e % kLanes] = v;
  }
  cluster.sync();            // no CTA leaves while another reads its partials
}

// Replaces _dot_extract_kernel. The cluster's first CTA (rank 0, the leader)
// holds the tile's mask bitmap of the whole block, the survivor lists and
// their counts; the other CTAs reach them through distributed shared
// memory. Each CTA scans its share of the tile's mask rows into the
// leader's bitmap (remote atomicOr). A score >= its row's tau (finite,
// unmasked) is appended to the row's list: a remote atomicAdd on the row's
// count, then the value and the column at that slot while it is below cap;
// the count goes on past cap. After a cluster barrier the leader's warps
// take a row each: with found <= cap, min(k, found) argmax rounds over the
// list by (value desc, column asc), each strictly after the last pick; with
// found > cap (a tie storm, or tau = -inf on a small catalog), the same
// rounds over the whole column block, recomputing each score with the same
// arithmetic from global memory. Output: slots j*k .. j*k+k-1 of the row
// hold block j's top-min(k, found), then (-inf, sentinel), as skrx_extract
// writes them.
template <int TR, int kDQ>
__global__ void __launch_bounds__(kXThreads, TR == 16 ? 3 : 2)
dot_extract_kernel(const float* __restrict__ uv, int b, int dq_arg,
                   const float* __restrict__ items, const float* __restrict__ bias,
                   int n, long long n_pad, int block_n,
                   const int* __restrict__ mask, int L,
                   const float* __restrict__ tau, int k, int cap,
                   float* __restrict__ out_v, int* __restrict__ out_i, int out_w) {
  using S = Stripes<TR, kDQ>;
  __shared__ unsigned bits[TR][kMaskWords];
  __shared__ int found_sh[TR];
  __shared__ __align__(8) unsigned long long full_bar[kStages], empty_bar[kStages];
  extern __shared__ __align__(16) unsigned char dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const S st(items, bias, n_pad, dq_arg, block_n, cl, rank, dyn, full_bar, empty_bar);
  float* sv = reinterpret_cast<float*>(st.tail());               // [TR][cap]
  int* si = reinterpret_cast<int*>(sv + TR * cap);               // [TR][cap]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool producer = threadIdx.x == kXWarps * 32;
  const int dq = st.dq, lo = st.lo;
  const long long row0 = st.row0;
  const int j_blk = blockIdx.y / cl;
  const int width = min(block_n, n - lo);
  unsigned* bits_l = cluster.map_shared_rank(&bits[0][0], 0);   // the leader's

  if (producer) st.init_ring();
  if (threadIdx.x < TR) found_sh[threadIdx.x] = 0;
  for (int e = threadIdx.x; e < TR * kMaskWords; e += kXThreads) (&bits[0][0])[e] = 0u;
  __syncthreads();
  st.start(producer, uv);
  cluster.sync();            // the leader's bitmap and counts are 0
  if (mask != nullptr)
    scan_mask<TR>(mask, L, row0, b, lo, width, rank, cl, [&](int) { return bits_l; });
  cluster.sync();            // the leader's bitmap is complete

  if (warp < kXWarps) {
    const int rg = warp / S::kParts;
    float t[kXRT];
#pragma unroll
    for (int i = 0; i < kXRT; ++i) {
      const long long row = row0 + rg * kXRT + i;
      t[i] = row < b ? __ldg(tau + row) : INFINITY;   // padding rows keep none
    }
    int* found_l = cluster.map_shared_rank(found_sh, 0);
    float* sv_l = cluster.map_shared_rank(sv, 0);
    int* si_l = cluster.map_shared_rank(si, 0);
    st.score([&](int i, int, int r, int c, float v) {
      if (v >= t[i] && v != -INFINITY
          && (mask == nullptr || !masked_at(bits_l + r * kMaskWords, c))) {
        const int p = atomicAdd(found_l + r, 1);
        if (p < cap) {
          sv_l[r * cap + p] = v;
          si_l[r * cap + p] = c;
        }
      }
    });
  } else if (producer) {
    st.produce();
  }
  __syncwarp();
  cluster.sync();            // every survivor of the block is in the leader's lists
  if (rank != 0) return;
  const float4* it4 = reinterpret_cast<const float4*>(items);
  for (int r = warp; r < TR; r += kXWarps + 1) {
    const long long row = row0 + r;
    if (row >= b) break;
    const float t = __ldg(tau + row);
    const int found = found_sh[r];
    const int rounds = min(k, found);
    float* ov = out_v + row * out_w + (long long)j_blk * k;
    int* oi = out_i + row * out_w + (long long)j_blk * k;
    const unsigned* rb = bits[r];
    const float4* ur = reinterpret_cast<const float4*>(uv) + row * dq;
    Pair prev{INFINITY, -1};     // ranks before every pair
    for (int q = 0; q < rounds; ++q) {
      Pair best{-INFINITY, INT_MAX};
      if (found <= cap) {
        for (int e = lane; e < found; e += 32) {
          const Pair p{sv[r * cap + e], si[r * cap + e]};
          if (before(prev.v, prev.id, p.v, p.id)) best = better(best, p);
        }
      } else {
        for (int c = lane; c < block_n; c += 32) {
          if (mask != nullptr && masked_at(rb, c)) continue;
          const float v = __fadd_rn(dot_one(ur, dq, it4, n_pad, lo + c), __ldg(bias + lo + c));
          const Pair p{v, c};
          if (v >= t && v != -INFINITY && before(prev.v, prev.id, p.v, p.id))
            best = better(best, p);
        }
      }
      best = warp_best(best);
      if (lane == 0) {
        ov[q] = best.v;
        oi[q] = lo + best.id;
      }
      prev = best;
    }
    for (int q = rounds + lane; q < k; q += 32) {
      ov[q] = -INFINITY;
      oi[q] = kSentinel;
    }
  }
}

// Tile rows and cluster size of a launch: tiles of 32 rows (the item table
// read half as often) where they alone give two CTAs an SM, else 16; then
// column blocks split in two until the grid has eight CTAs an SM, a slice
// is one stripe, or the cluster has 8 CTAs.
struct FusedGrid {
  int tile, cl;
};

FusedGrid fused_grid(int b, int n_blocks, int block_n, int sms) {
  FusedGrid g{32, 1};
  if ((long long)((b + 31) / 32) * n_blocks < 2LL * sms) g.tile = 16;
  const long long tiles = (long long)((b + g.tile - 1) / g.tile) * n_blocks;
  while (g.cl < kMaxCluster && block_n / (2 * g.cl) >= kStripe
         && tiles * g.cl < 8LL * sms && 2LL * n_blocks * g.cl <= 65535)
    g.cl *= 2;
  return g;
}

// Checks the operands and picks the launch's grid from B and this device's
// SM count; 0 or a CUDA error.
int plan_launch(const float* uv, int b, int dq, const float* items, long long n_pad,
                int block_n, FusedGrid* g) {
  if (dq < 1 || dq > kMaxQuads || reinterpret_cast<uintptr_t>(items) % 16
      || reinterpret_cast<uintptr_t>(uv) % 16)
    return (int)cudaErrorInvalidValue;
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_blocks = (int)(n_pad / block_n);
  *g = fused_grid(b, n_blocks, block_n, sms[dev]);
  if ((long long)n_blocks * g->cl > 65535) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// Opts `kernel` in to kMaxXDyn bytes of shared memory once per device
// (opted: that kernel's flags), then launches it on (row tiles, n_blocks *
// cl) CTAs in clusters of (1, cl, 1).
template <class... KArgs, class... Args>
int launch_cluster(void (*kernel)(KArgs...), bool (&opted)[64], int tile, int b,
                   int n_blocks, int cl, int dyn, cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxXDyn);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((b + tile - 1) / tile), (unsigned)(n_blocks * cl));
  cfg.blockDim = dim3(kXThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int TR, int kDQ>
int launch_submax(const float* uv, int b, int dq, const float* items, const float* bias,
                  int n, long long n_pad, int block_n, const int* mask, int L,
                  float* out, int cl, cudaStream_t stream) {
  static bool opted[64] = {};
  const int n_blocks = (int)(n_pad / block_n);
  const int dyn = Stripes<TR, kDQ>::dyn_bytes(dq) + TR * kLanes * 4;
  return launch_cluster(dot_submax_kernel<TR, kDQ>, opted, TR, b, n_blocks, cl, dyn,
                        stream, uv, b, dq, items, bias, n, n_pad, block_n, mask, L,
                        out, n_blocks * kLanes);
}

template <int TR, int kDQ>
int launch_extract(const float* uv, int b, int dq, const float* items,
                   const float* bias, int n, long long n_pad, int block_n,
                   const int* mask, int L, const float* tau, int k,
                   float* out_v, int* out_i, int cl, cudaStream_t stream) {
  static bool opted[64] = {};
  // survivor slots a row: 2k (at least 64), as many as kListBytes allow
  const int cap = min(max(((2 * k + 31) / 32) * 32, 64), kListBytes / (TR * 8));
  const int n_blocks = (int)(n_pad / block_n);
  const int dyn = Stripes<TR, kDQ>::dyn_bytes(dq) + TR * cap * 8;
  return launch_cluster(dot_extract_kernel<TR, kDQ>, opted, TR, b, n_blocks, cl, dyn,
                        stream, uv, b, dq, items, bias, n, n_pad, block_n, mask, L,
                        tau, k, cap, out_v, out_i, n_blocks * k);
}

}  // namespace

extern "C" {

int skrx_dot_topk_abi_version() { return 2; }

// uv: (B_pad, 4*dq) with B_pad a multiple of 32; items: (dq, n_pad, 4);
// bias: (n_pad,); mask: (B, L) or null; out: (B, n_pad / block_n * 128).
int skrx_dot_submax(const float* uv, int b, int dq, const float* items,
                    const float* bias, int n, int n_pad, int block_n,
                    const int* mask, int L, float* out, cudaStream_t stream) {
  FusedGrid g;
  const int err = plan_launch(uv, b, dq, items, n_pad, block_n, &g);
  if (err) return err;
#define SKRX_SUBMAX(TR_, DQ_)                                                    \
  return launch_submax<TR_, DQ_>(uv, b, dq, items, bias, n, n_pad, block_n, mask, \
                                 L, out, g.cl, stream)
  if (g.tile == 32) {
    if (dq == 16) SKRX_SUBMAX(32, 16);
    SKRX_SUBMAX(32, 0);
  }
  if (dq == 16) SKRX_SUBMAX(16, 16);
  SKRX_SUBMAX(16, 0);
#undef SKRX_SUBMAX
}

// As skrx_dot_submax, plus tau: (B,); out_v, out_i: (B, n_pad / block_n * k).
int skrx_dot_extract(const float* uv, int b, int dq, const float* items,
                     const float* bias, int n, int n_pad, int block_n,
                     const int* mask, int L, const float* tau, int k, float* out_v,
                     int* out_i, cudaStream_t stream) {
  FusedGrid g;
  const int err = plan_launch(uv, b, dq, items, n_pad, block_n, &g);
  if (err) return err;
#define SKRX_EXTRACT(TR_, DQ_)                                                      \
  return launch_extract<TR_, DQ_>(uv, b, dq, items, bias, n, n_pad, block_n, mask, \
                                  L, tau, k, out_v, out_i, g.cl, stream)
  if (g.tile == 32) {
    if (dq == 16) SKRX_EXTRACT(32, 16);
    SKRX_EXTRACT(32, 0);
  }
  if (dq == 16) SKRX_EXTRACT(16, 16);
  SKRX_EXTRACT(16, 0);
#undef SKRX_EXTRACT
}

}  // extern "C"
