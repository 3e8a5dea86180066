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
// Tiling. A block of 8 warps takes a tile of 8 * RT user rows and one
// column block; warp w owns rows w*RT .. w*RT+RT-1, lane l the columns
// 32*j + l (j < 4) of each 128-column stripe, i.e. the strided groups
// l + 32*j. Per quad a thread loads RT user quads (the same address across
// the warp: a broadcast) and four item quads, and does 2*4*RT*4 operations,
// so the item slab is read once per tile of rows, from L2 (10.5 MB at the
// Gowalla catalog, d = 64), not once per row. Bound: operations, 2*B*N*d
// f32 (mul and add issued apart, as the exact order needs).
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the wrappers in ../dot_topk.py check shapes, types
// and devices, pack and pad the operands, allocate the outputs and count
// launches.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kLanes = 128;                   // strided groups per block
constexpr int kMaxBlockN = 4096;
constexpr int kMaskWords = kMaxBlockN / 32;
constexpr int kSentinel = INT_MAX / 2;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;                      // columns a lane takes per stripe
constexpr int kMaxDynSmem = 96 * 1024;        // survivor lists of dot_extract

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

// Replaces _dot_extract_kernel. Grid (row tiles, column blocks). Pass 1:
// every score of the tile is computed once; the finite unmasked ones >= the
// row's tau are appended to the row's survivor list in shared memory (cap
// entries a row; the count goes on past cap). Pass 2, a warp per row (the
// rows it scored): with found <= cap, min(k, found) argmax rounds over the
// list by (value desc, column asc), each strictly after the last pick; with
// found > cap (a tie storm, or tau = -inf on a small catalog), the same
// rounds over the whole column block, recomputing each score with the same
// arithmetic. Output: slots j*k .. j*k+k-1 of the row hold block j's
// top-min(k, found), then (-inf, sentinel), as skrx_extract writes them.
template <int RT>
__global__ void __launch_bounds__(kThreads)
dot_extract_kernel(const float* __restrict__ uv, int b, int dq,
                   const float* __restrict__ items, const float* __restrict__ bias,
                   int n, long long n_pad, int block_n,
                   const int* __restrict__ mask, int L,
                   const float* __restrict__ tau, int k, int cap,
                   float* __restrict__ out_v, int* __restrict__ out_i, int out_w) {
  constexpr int kRows = kWarps * RT;
  __shared__ unsigned bits[kRows][kMaskWords];
  __shared__ int found_sh[kRows];
  extern __shared__ unsigned char dyn[];
  float* sv = reinterpret_cast<float*>(dyn);                 // [kRows][cap]
  int* si = reinterpret_cast<int*>(dyn) + kRows * cap;       // [kRows][cap]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int j_blk = blockIdx.y;
  const int lo = j_blk * block_n;
  if (threadIdx.x < kRows) found_sh[threadIdx.x] = 0;
  load_tile_mask(bits, kRows, mask, L, row0, b, lo, min(block_n, n - lo));
  const float4* u4 = reinterpret_cast<const float4*>(uv) + (row0 + warp * RT) * dq;
  const float4* it4 = reinterpret_cast<const float4*>(items);
  float t[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const long long row = row0 + warp * RT + i;
    t[i] = row < b ? __ldg(tau + row) : INFINITY;   // padding rows keep none
  }
  for (int s = 0; s < block_n; s += kLanes) {
    float acc[RT][kCols];
    dot_tile<RT>(u4, dq, it4, n_pad, lo + s + lane, acc);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = s + lane + 32 * j;
      const float bj = __ldg(bias + lo + c);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = warp * RT + i;
        const float v = __fadd_rn(acc[i][j], bj);
        if (v >= t[i] && v != -INFINITY && (mask == nullptr || !masked_at(bits[r], c))) {
          const int p = atomicAdd(&found_sh[r], 1);
          if (p < cap) {
            sv[r * cap + p] = v;
            si[r * cap + p] = c;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < RT; ++i) {
    const int r = warp * RT + i;
    const long long row = row0 + r;
    if (row >= b) break;
    const int found = found_sh[r];
    const int rounds = min(k, found);
    float* ov = out_v + row * out_w + (long long)j_blk * k;
    int* oi = out_i + row * out_w + (long long)j_blk * k;
    const unsigned* rb = bits[r];
    const float4* ur = u4 + (long long)i * dq;
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
          if (v >= t[i] && v != -INFINITY && before(prev.v, prev.id, p.v, p.id))
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

template <int RT>
int launch_extract(const float* uv, int b, int dq, const float* items,
                   const float* bias, int n, long long n_pad, int block_n,
                   const int* mask, int L, const float* tau, int k, float* out_v,
                   int* out_i, cudaStream_t stream) {
  constexpr int kRows = kWarps * RT;
  // survivor slots a row: 2k (at least 64), as many as 96 KB allow
  int cap = ((2 * k + 31) / 32) * 32;
  cap = max(cap, 64);
  cap = min(cap, kMaxDynSmem / (kRows * 8));
  const int dyn = kRows * cap * 8;
  // static + dynamic shared memory may pass 48 KB: opt in once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(dot_extract_kernel<RT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  const int n_blocks = (int)(n_pad / block_n);
  const dim3 grid((b + kRows - 1) / kRows, n_blocks);
  dot_extract_kernel<RT><<<grid, kThreads, dyn, stream>>>(
      uv, b, dq, items, bias, n, n_pad, block_n, mask, L, tau, k, cap, out_v, out_i,
      n_blocks * k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int skrx_dot_topk_abi_version() { return 1; }

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
  switch (rows_per_thread(b, n_pad / block_n)) {
    case 4: return launch_extract<4>(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, tau, k, out_v, out_i, stream);
    case 2: return launch_extract<2>(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, tau, k, out_v, out_i, stream);
    default: return launch_extract<1>(uv, b, dq, items, bias, n, n_pad, block_n, mask, L, tau, k, out_v, out_i, stream);
  }
}

}  // extern "C"
