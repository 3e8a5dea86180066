// An experimental design of kernel #2 (kth_largest): radix select, timed
// by an earlier chip_ab.py (see the repository's history) against the
// package's kernel (skrx_torch/ops/kernels/csrc/topk_blocks.cu, a warp a
// row bisecting in 32 rounds). It is not part of the package, and no script
// builds it now; PERF.md says how it fared.
//
// It computes what the package's kth_largest_kernel computes, bit for bit:
// out[r] = the k-th largest of row r of the (B, W) f32 matrix in the total
// order of the JAX kernel (-inf lowest, -0.0 below +0.0), by the same
// order keys. Any exact selection returns the same key.
//
// Design. One warp per row, kWarps rows a block, the row's keys in
// registers as there (KPL a lane; KPL = 0 reads the row each round). The
// key with its sign bit flipped, u, orders as an unsigned integer (an
// empty slot is u = 0, the NaN pattern, which no input holds and which is
// skipped). Four rounds of 8-bit digits, most significant first: the lanes
// count the digits of the keys that match the prefix chosen so far into the
// warp's 256-bin histogram in shared memory (atomicAdd), then each lane sums
// 8 bins from the top, a warp scan finds the bin where the count from the
// top reaches the rank still sought, and that digit joins the prefix.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 4;
constexpr int kBins = 256;

__device__ __forceinline__ int order_key(int i) {
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

// From the warp's histogram of this round's digits: the digit d whose bin
// holds the kr-th largest key (the count from the largest digit down first
// reaches kr there), and kr becomes that key's rank within the bin.
__device__ __forceinline__ void pick_digit(const int* hist, int& kr, unsigned& d) {
  const int lane = threadIdx.x & 31;
  int bins[8], sum = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    bins[t] = hist[kBins - 1 - 8 * lane - t];
    sum += bins[t];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const int excl = incl - sum;
  const unsigned owner = __ballot_sync(0xffffffffu, excl < kr && kr <= incl);
  const int src = __ffs(owner) - 1;
  int my_d = 0, my_kr = 0;
  if (lane == src) {
    int above = excl;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (above + bins[t] >= kr) {
        my_d = kBins - 1 - 8 * lane - t;
        my_kr = kr - above;
        break;
      }
      above += bins[t];
    }
  }
  d = (unsigned)__shfl_sync(0xffffffffu, my_d, src);
  kr = __shfl_sync(0xffffffffu, my_kr, src);
}

template <int KPL>
__global__ void __launch_bounds__(kWarps * 32)
kth_radix_kernel(const float* __restrict__ vals, int b, int w, int k,
                 float* __restrict__ out) {
  __shared__ int hist_sh[kWarps][kBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= b) return;                       // the whole warp
  const int* row = reinterpret_cast<const int*>(vals) + r * w;
  int* hist = hist_sh[warp];
  unsigned u[KPL > 0 ? KPL : 1];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int c = lane + 32 * i;
    u[i] = c < w ? (unsigned)order_key(__ldg(row + c)) ^ 0x80000000u : 0u;
  }
  unsigned prefix = 0;
  int kr = k;
#pragma unroll
  for (int shift = 24; shift >= 0; shift -= 8) {
#pragma unroll
    for (int t = 0; t < 8; ++t) hist[lane * 8 + t] = 0;
    __syncwarp();
    auto add = [&](unsigned x) {
      if (x != 0u && (shift == 24 || (x >> (shift + 8)) == prefix))
        atomicAdd(&hist[(x >> shift) & (kBins - 1)], 1);
    };
    if constexpr (KPL > 0) {
#pragma unroll
      for (int i = 0; i < KPL; ++i) add(u[i]);
    } else {
      for (int c = lane; c < w; c += 32) add((unsigned)order_key(__ldg(row + c)) ^ 0x80000000u);
    }
    __syncwarp();
    unsigned d;
    pick_digit(hist, kr, d);
    prefix = (prefix << 8) | d;
    __syncwarp();
  }
  if (lane == 0) out[r] = __int_as_float(order_key((int)(prefix ^ 0x80000000u)));
}

}  // namespace

extern "C" {

int skrx_kth_largest(const float* vals, int b, int w, int k, float* out,
                     cudaStream_t stream) {
  const int blocks = (b + kWarps - 1) / kWarps;
#define SKRX_KTH(KPL_)                                                    \
  kth_radix_kernel<KPL_><<<blocks, kWarps * 32, 0, stream>>>(vals, b, w, k, \
                                                             out)
  if (w <= 32 * 8) SKRX_KTH(8);
  else if (w <= 32 * 16) SKRX_KTH(16);
  else if (w <= 32 * 48) SKRX_KTH(48);
  else if (w <= 32 * 128) SKRX_KTH(128);
  else SKRX_KTH(0);
#undef SKRX_KTH
  return (int)cudaGetLastError();
}

}  // extern "C"
