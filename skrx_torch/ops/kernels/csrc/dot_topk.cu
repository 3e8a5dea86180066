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
// four dimensions, the n_pad columns' four values side by side, so a warp
// reading 32 neighbouring columns at one quad reads 512 contiguous bytes.
// n_pad is a multiple of block_n; pad columns have zero vectors and bias
// -inf, so they score -inf and are never selected. uv is (B_pad, d4) with
// zero rows and columns past (B, d).
//
// Tiling of dot_submax. A block of 8 warps takes a tile of 8 * RT user rows
// and one column block; warp w owns rows w*RT .. w*RT+RT-1, lane l the
// columns 32*j + l (j < 4) of each 128-column stripe, i.e. the strided
// groups l + 32*j. Per quad a thread loads RT user quads (the same address
// across the warp: a broadcast) and four item quads, and does 2*4*RT*4
// operations, so the item slab is read once per tile of rows, from L2 (10.5
// MB at the Gowalla catalog, d = 64), not once per row. dot_extract stages
// its tiles in shared memory and splits a column block across a cluster of
// CTAs (see the kernel). Bound: operations, 2*B*N*d f32 (mul and add issued
// apart, as the exact order needs).
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the wrappers in ../dot_topk.py check shapes, types
// and devices, pack and pad the operands, allocate the outputs and count
// launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;                   // strided groups per block
constexpr int kMaxBlockN = 4096;
constexpr int kMaskWords = kMaxBlockN / 32;
constexpr int kSentinel = INT_MAX / 2;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;                      // columns a lane takes per stripe

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

// acc[i][j] = score of tile row i (of this warp) and column col + 32*j,
// without the bias. u4: the warp's first row, rows dq quads apart.
template <int RT>
__device__ __forceinline__ void dot_tile(const float4* __restrict__ u4, int dq,
                                         const float4* __restrict__ it4,
                                         long long n_pad, int col,
                                         float (&acc)[RT][kCols]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int q = 0; q < dq; ++q) {
    float4 u[RT], it[kCols];
#pragma unroll
    for (int i = 0; i < RT; ++i) u[i] = __ldg(u4 + (long long)i * dq + q);
#pragma unroll
    for (int j = 0; j < kCols; ++j) it[j] = __ldg(it4 + q * n_pad + col + 32 * j);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = quad_dot(acc[i][j], u[i], it[j]);
  }
}

// One score, the same arithmetic as dot_tile (the overflow path of extract).
__device__ __forceinline__ float dot_one(const float4* __restrict__ u4, int dq,
                                         const float4* __restrict__ it4,
                                         long long n_pad, long long col) {
  float acc = 0.f;
  for (int q = 0; q < dq; ++q) acc = quad_dot(acc, __ldg(u4 + q), __ldg(it4 + q * n_pad + col));
  return acc;
}

// bits[r][w]: bit c of word w of tile row r = 1 when column lo + 32w + c is
// in row r's mask row. Ids outside [lo, lo + width) are ignored (other
// blocks, padding, out of range); duplicates are harmless. Ends with a
// barrier.
__device__ void load_tile_mask(unsigned (*bits)[kMaskWords], int rows,
                               const int* __restrict__ mask, int L,
                               long long row0, int b, int lo, int width) {
  for (int e = threadIdx.x; e < rows * kMaskWords; e += blockDim.x)
    bits[e / kMaskWords][e % kMaskWords] = 0u;
  __syncthreads();
  if (mask != nullptr) {
    for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
      const int r = e / L;
      if (row0 + r >= b) break;
      const long long rel = (long long)__ldg(mask + (row0 + r) * L + e % L) - lo;
      if (rel >= 0 && rel < width) atomicOr(&bits[r][rel >> 5], 1u << (rel & 31));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool masked_at(const unsigned* row_bits, int c) {
  return (row_bits[c >> 5] >> (c & 31)) & 1u;
}

// Replaces _dot_submax_kernel. Grid (row tiles, column blocks): out[b,
// j*128 + l] = the max of the masked scores of block j's group l (columns
// j*block_n + l + 128*t). A thread keeps the running maxima of its RT rows
// and four groups over the block's stripes.
template <int RT>
__global__ void __launch_bounds__(kThreads)
dot_submax_kernel(const float* __restrict__ uv, int b, int dq,
                  const float* __restrict__ items, const float* __restrict__ bias,
                  int n, long long n_pad, int block_n,
                  const int* __restrict__ mask, int L, float* __restrict__ out,
                  int out_w) {
  __shared__ unsigned bits[kWarps * RT][kMaskWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kWarps * RT;
  const int j_blk = blockIdx.y;
  const int lo = j_blk * block_n;
  load_tile_mask(bits, kWarps * RT, mask, L, row0, b, lo, min(block_n, n - lo));
  const float4* u4 = reinterpret_cast<const float4*>(uv) + (row0 + warp * RT) * dq;
  const float4* it4 = reinterpret_cast<const float4*>(items);
  float m[RT][kCols];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) m[i][j] = -INFINITY;
  for (int s = 0; s < block_n; s += kLanes) {
    float acc[RT][kCols];
    dot_tile<RT>(u4, dq, it4, n_pad, lo + s + lane, acc);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = s + lane + 32 * j;
      const float bj = __ldg(bias + lo + c);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if (mask == nullptr || !masked_at(bits[warp * RT + i], c))
          m[i][j] = fmaxf(m[i][j], __fadd_rn(acc[i][j], bj));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const long long row = row0 + warp * RT + i;
    if (row < b) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        out[row * out_w + (long long)j_blk * kLanes + lane + 32 * j] = m[i][j];
    }
  }
}

// Replaces _dot_extract_kernel. A CTA takes TR (16 or 32) user rows and a
// slice of one column block: the block's CTAs form a cluster of cl (1..8)
// CTAs, each scoring block_n / cl columns, so that a small batch still
// spreads over the card (launch_extract picks TR and cl). Warps 0..7 score;
// one lane of warp 8, the producer, feeds them.
//
// Staging. The tile's user rows are copied into shared memory once. The item
// table streams through a ring of kStages stages; a stage holds four quads
// of one 128-column stripe (8 KB), copied by the producer with
// cp.async.bulk (one 2 KB copy per quad: the packed table keeps a quad's
// columns side by side) and completed on the stage's "full" mbarrier; each
// scoring warp arrives on the stage's "empty" mbarrier once it has read it.
//
// Scores. The eight warps are TR / 4 row groups of 4 rows by 32 / TR column
// parts; a thread scores its group's 4 rows against CT = TR / 8 columns of
// each stripe (lane + 32 j of its part), a register tile whose item quads
// are reused across the four rows in registers and whose user quads are
// warp-wide broadcasts from shared memory. The four quads of a stage are
// unrolled; with d = 64 (kDQ = 16) the stage count of a stripe is a
// constant too, other d take the generic instantiation. The arithmetic is
// dot_tile's: acc = acc + u * it per dimension in quad order, each rounded,
// then + bias.
//
// The cluster's first CTA (rank 0, the leader) holds the tile's mask bitmap
// of the whole block, the survivor lists and their counts; the other CTAs
// reach them through distributed shared memory. Each CTA scans its share of
// the tile's mask rows into the leader's bitmap (remote atomicOr). A score
// >= its row's tau (finite, unmasked) is appended to the row's list: a
// remote atomicAdd on the row's count, then the value and the column at
// that slot while it is below cap; the count goes on past cap. After a
// cluster barrier the leader's warps take a row each: with found <= cap,
// min(k, found) argmax rounds over the list by (value desc, column asc),
// each strictly after the last pick; with found > cap (a tie storm, or tau
// = -inf on a small catalog), the same rounds over the whole column block,
// recomputing each score with the same arithmetic from global memory.
// Output: slots j*k .. j*k+k-1 of the row hold block j's top-min(k, found),
// then (-inf, sentinel), as skrx_extract writes them.
constexpr int kXRT = 4;                        // rows a thread scores
constexpr int kXWarps = 8;                     // scoring warps
constexpr int kXThreads = (kXWarps + 1) * 32;  // and the producer's warp
constexpr int kStripe = 128;                   // columns of a stripe
constexpr int kStageQuads = 4;
constexpr int kStages = 4;
constexpr int kStageFloats = kStageQuads * kStripe * 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxQuads = 128;                 // d <= 512
constexpr int kMaxTile = 32;
constexpr int kListBytes = 64 * 1024;          // survivor lists of a tile
constexpr int kMaxXDyn = kStages * kStageFloats * 4 + kMaxTile * kMaxQuads * 16
                         + kListBytes;

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

template <int TR, int kDQ>
__global__ void __launch_bounds__(kXThreads, TR == 16 ? 3 : 2)
dot_extract_kernel(const float* __restrict__ uv, int b, int dq_arg,
                   const float* __restrict__ items, const float* __restrict__ bias,
                   int n, long long n_pad, int block_n,
                   const int* __restrict__ mask, int L,
                   const float* __restrict__ tau, int k, int cap,
                   float* __restrict__ out_v, int* __restrict__ out_i, int out_w) {
  constexpr int kParts = kXWarps / (TR / kXRT);      // column parts of a stripe
  constexpr int kCT = kStripe / (32 * kParts);       // columns a thread scores
  const int dq = kDQ > 0 ? kDQ : dq_arg;
  __shared__ unsigned bits[TR][kMaskWords];
  __shared__ int found_sh[TR];
  __shared__ __align__(8) unsigned long long full_bar[kStages], empty_bar[kStages];
  extern __shared__ __align__(16) unsigned char dyn[];
  float* ring = reinterpret_cast<float*>(dyn);                   // [kStages][kStageFloats]
  float4* users = reinterpret_cast<float4*>(ring + kStages * kStageFloats);  // [TR][dq]
  float* sv = reinterpret_cast<float*>(users + TR * dq);         // [TR][cap]
  int* si = reinterpret_cast<int*>(sv + TR * cap);               // [TR][cap]
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * TR;
  const int j_blk = blockIdx.y / cl;
  const int lo = j_blk * block_n;
  const int width = min(block_n, n - lo);
  const int slice = block_n / cl;
  const int c0 = rank * slice;                 // this CTA's first column in the block
  const int n_qst = (dq + kStageQuads - 1) / kStageQuads;
  const int n_steps = slice / kStripe * n_qst;
  const bool producer = threadIdx.x == kXWarps * 32;
  unsigned* bits_l = cluster.map_shared_rank(&bits[0][0], 0);   // the leader's

  // the producer's copies of step `step` (stripe step / n_qst, its quads
  // from 4 (step % n_qst) on) into stage step % kStages
  auto issue = [&](int step) {
    const int s = step % kStages, q0 = step % n_qst * kStageQuads;
    const int qn = min(kStageQuads, dq - q0);
    const long long col = lo + c0 + (long long)(step / n_qst) * kStripe;
    mbar_expect(&full_bar[s], qn * kStripe * 16);
    for (int q = 0; q < qn; ++q)
      bulk_copy(ring + s * kStageFloats + q * kStripe * 4,
                items + ((long long)(q0 + q) * n_pad + col) * 4, kStripe * 16,
                &full_bar[s]);
  };

  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kXWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < TR) found_sh[threadIdx.x] = 0;
  for (int e = threadIdx.x; e < TR * kMaskWords; e += kXThreads) (&bits[0][0])[e] = 0u;
  __syncthreads();
  if (producer)
    for (int step = 0; step < min(kStages, n_steps); ++step) issue(step);
  const float4* uv4 = reinterpret_cast<const float4*>(uv) + row0 * dq;
  for (int e = threadIdx.x; e < TR * dq; e += kXThreads) users[e] = __ldg(uv4 + e);
  cluster.sync();            // the leader's bitmap and counts are 0
  if (mask != nullptr) {
    // this CTA's share of the tile's mask entries (rows < b), four loads
    // in flight a thread; ids outside [lo, lo + width) are ignored
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
          atomicOr(bits_l + (e / L) * kMaskWords + (rel >> 5), 1u << (rel & 31));
      }
    }
  }
  cluster.sync();            // the leader's bitmap is complete

  if (warp < kXWarps) {
    const int rg = warp / kParts, part = warp % kParts;
    float t[kXRT];
#pragma unroll
    for (int i = 0; i < kXRT; ++i) {
      const long long row = row0 + rg * kXRT + i;
      t[i] = row < b ? __ldg(tau + row) : INFINITY;   // padding rows keep none
    }
    const float4* u4 = users + rg * kXRT * dq;
    int* found_l = cluster.map_shared_rank(found_sh, 0);
    float* sv_l = cluster.map_shared_rank(sv, 0);
    int* si_l = cluster.map_shared_rank(si, 0);
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
        for (int i = 0; i < kXRT; ++i) {
          const int r = rg * kXRT + i;
          const float v = __fadd_rn(acc[i][j], bj);
          if (v >= t[i] && v != -INFINITY
              && (mask == nullptr || !masked_at(bits_l + r * kMaskWords, c))) {
            const int p = atomicAdd(found_l + r, 1);
            if (p < cap) {
              sv_l[r * cap + p] = v;
              si_l[r * cap + p] = c;
            }
          }
        }
      }
    }
  } else if (producer) {
    for (int step = kStages; step < n_steps; ++step) {
      mbar_wait(&empty_bar[step % kStages], ((step / kStages) & 1) ^ 1);
      issue(step);
    }
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

// Rows a thread takes: the largest of 4, 2, 1 that still gives the card
// two blocks an SM (132 SMs), so small batches spread over more blocks.
int rows_per_thread(int b, int n_blocks) {
  for (int rt = 4; rt > 1; rt >>= 1) {
    const long long tiles = (long long)((b + kWarps * rt - 1) / (kWarps * rt)) * n_blocks;
    if (tiles >= 2 * 132) return rt;
  }
  return 1;
}

template <int RT>
int launch_submax(const float* uv, int b, int dq, const float* items, const float* bias,
                  int n, long long n_pad, int block_n, const int* mask, int L,
                  float* out, cudaStream_t stream) {
  const int n_blocks = (int)(n_pad / block_n);
  const dim3 grid((b + kWarps * RT - 1) / (kWarps * RT), n_blocks);
  dot_submax_kernel<RT><<<grid, kThreads, 0, stream>>>(
      uv, b, dq, items, bias, n, n_pad, block_n, mask, L, out, n_blocks * kLanes);
  return (int)cudaGetLastError();
}

// Tile rows and cluster size of a launch: tiles of 32 rows (the item table
// read half as often) where they alone give two CTAs an SM, else 16; then
// column blocks split in two until the grid has eight CTAs an SM, a slice
// is one stripe, or the cluster has 8 CTAs.
struct ExtractGrid {
  int tile, cl;
};

ExtractGrid extract_grid(int b, int n_blocks, int block_n, int sms) {
  ExtractGrid g{32, 1};
  if ((long long)((b + 31) / 32) * n_blocks < 2LL * sms) g.tile = 16;
  const long long tiles = (long long)((b + g.tile - 1) / g.tile) * n_blocks;
  while (g.cl < kMaxCluster && block_n / (2 * g.cl) >= kStripe
         && tiles * g.cl < 8LL * sms && 2LL * n_blocks * g.cl <= 65535)
    g.cl *= 2;
  return g;
}

template <int TR, int kDQ>
int launch_extract_tile(const float* uv, int b, int dq, const float* items,
                        const float* bias, int n, long long n_pad, int block_n,
                        const int* mask, int L, const float* tau, int k,
                        float* out_v, int* out_i, int cl, cudaStream_t stream) {
  // survivor slots a row: 2k (at least 64), as many as kListBytes allow
  const int cap = min(max(((2 * k + 31) / 32) * 32, 64), kListBytes / (TR * 8));
  const int dyn = kStages * kStageFloats * 4 + TR * dq * 16 + TR * cap * 8;
  // past 48 KB of shared memory: opt in once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(dot_extract_kernel<TR, kDQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxXDyn);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  const int n_blocks = (int)(n_pad / block_n);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((b + TR - 1) / TR), (unsigned)(n_blocks * cl));
  cfg.blockDim = dim3(kXThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dot_extract_kernel<TR, kDQ>, uv, b, dq, items, bias,
                           n, n_pad, block_n, mask, L, tau, k, cap, out_v, out_i,
                           n_blocks * k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_extract(const float* uv, int b, int dq, const float* items,
                   const float* bias, int n, long long n_pad, int block_n,
                   const int* mask, int L, const float* tau, int k, float* out_v,
                   int* out_i, cudaStream_t stream) {
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
  const ExtractGrid g = extract_grid(b, n_blocks, block_n, sms[dev]);
  if ((long long)n_blocks * g.cl > 65535) return (int)cudaErrorInvalidConfiguration;
#define SKRX_EXTRACT(TR_, DQ_)                                                       \
  return launch_extract_tile<TR_, DQ_>(uv, b, dq, items, bias, n, n_pad, block_n, \
                                       mask, L, tau, k, out_v, out_i, g.cl, stream)
  if (g.tile == 32) {
    if (dq == 16) SKRX_EXTRACT(32, 16);
    SKRX_EXTRACT(32, 0);
  }
  if (dq == 16) SKRX_EXTRACT(16, 16);
  SKRX_EXTRACT(16, 0);
#undef SKRX_EXTRACT
}

}  // namespace

extern "C" {

int skrx_dot_topk_abi_version() { return 2; }

// uv: (B_pad, 4*dq) with B_pad a multiple of 32; items: (dq, n_pad, 4);
// bias: (n_pad,); mask: (B, L) or null; out: (B, n_pad / block_n * 128).
int skrx_dot_submax(const float* uv, int b, int dq, const float* items,
                    const float* bias, int n, int n_pad, int block_n,
                    const int* mask, int L, float* out, cudaStream_t stream) {
  switch (rows_per_thread(b, n_pad / block_n)) {
    case 4: return launch_submax<4>(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, out, stream);
    case 2: return launch_submax<2>(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, out, stream);
    default: return launch_submax<1>(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, out, stream);
  }
}

// As skrx_dot_submax, plus tau: (B,); out_v, out_i: (B, n_pad / block_n * k).
int skrx_dot_extract(const float* uv, int b, int dq, const float* items,
                     const float* bias, int n, int n_pad, int block_n,
                     const int* mask, int L, const float* tau, int k, float* out_v,
                     int* out_i, cudaStream_t stream) {
  return launch_extract(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, tau, k,
                        out_v, out_i, stream);
}

}  // extern "C"
