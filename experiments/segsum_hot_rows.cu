// An experimental design of kernel #11 (segsum), measured against the
// package's kernel (skrx_torch/ops/kernels/csrc/segsum.cu) and not merged:
// it lost at the Gowalla-scale LightGCN graph in every variant (PERF.md).
// It is not part of the package, and no script builds it now: an earlier
// chip_ab.py (see the repository's history) laid out the hot list for it
// and compiled it with -DSKRX_SEGSUM_CLUSTER=1, 8 and 16. Its partial rows
// are left for a separate merge pass, as the package's kernel once did.
//
// It computes what the package's segsum_kernel computes, bit for bit (the
// same edges in the same order, one fmaf each):
//
//   out[d] = sum over edges e into row d of  x[src_e] * w_e,
//   w_e = weight_e * mask[orig_e] (mask optional)
//
// with exact zeros for zero-weight edges and bf16 messages as there.
//
// Design. Besides the CSR segments the host lists the hottest source rows
// (most out-edges first) and encodes each edge's source as a hot slot
// -(slot + 1) or as the source row. The kernel runs a persistent grid of
// thread-block clusters of kCluster CTAs, one CTA of 1,024 threads an SM.
// Each CTA first copies its share of the hot rows that fit (up to 192 KiB a
// CTA) from x into its shared memory with cp.async.bulk, completed on an
// mbarrier; after a cluster barrier every warp of the cluster reads a hot
// row from the shared memory of the CTA that holds it (distributed shared
// memory) and any other row from global memory (__ldg), so that a hot row
// leaves the L2 once per cluster instead of once per edge. A warp takes one
// segment at a time from a queue (an atomic counter): its lanes load 32
// edges' encodings and weights and turn them into row addresses, which
// shuffles broadcast, and it keeps eight edges' row loads in flight (the
// package's kernel: four). Rows of several segments write partial rows, as
// in the package's kernel.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

// CTAs of a cluster that share one hot set (chip_ab.py builds 1, 8, 16).
#ifndef SKRX_SEGSUM_CLUSTER
#define SKRX_SEGSUM_CLUSTER 8
#endif

namespace {

constexpr int kCluster = SKRX_SEGSUM_CLUSTER;
constexpr int kUnroll = 8;                // edges' row loads a warp keeps in flight
constexpr int kSegWarps = 32;             // warps of a segsum CTA
constexpr int kSegThreads = kSegWarps * 32;
constexpr int kHotBytes = 192 * 1024;     // hot rows a CTA holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = q.x; r[1] = q.y;
  } else {
    r[0] = __ldg(p);
  }
}

// V features from a generic address: global memory or the shared memory of
// a CTA of the cluster.
template <int V>
__device__ __forceinline__ void load_any(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    r[0] = q.x; r[1] = q.y;
  } else {
    r[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Lane `lane` owns features (j * 32 + lane) * V .. + V - 1 for j < NV; with
// V == 1 the features at or past d are idle (D not a multiple of 32).
// Hot slot s lives in CTA s / per of the cluster, at row s % per of its
// shared memory, for s < n_fit; slots from n_fit on are read from x at row
// hot[s].
template <int V, int NV, bool kBf16>
__global__ void __launch_bounds__(kSegThreads, 1)
segsum_kernel(const float* __restrict__ x, int d,
              const int* __restrict__ seg_ptr, const int* __restrict__ seg_dst,
              int nseg, const int* __restrict__ enc,
              const int* __restrict__ hot, int n_fit, int per,
              const float* __restrict__ weight, const int* __restrict__ orig,
              const float* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ partial, int* __restrict__ next) {
  extern __shared__ __align__(16) float hot_rows[];      // [per][d]
  __shared__ __align__(8) unsigned long long staged;     // mbarrier
  cg::cluster_group cluster = cg::this_cluster();
  const int h0 = (int)cluster.block_rank() * per;
  const int h_n = max(0, min(per, n_fit - h0));
  const unsigned bar = smem_addr(&staged);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (h_n > 0) {
    const unsigned bytes = 4u * d;
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes * h_n) : "memory");
    for (int i = threadIdx.x; i < h_n; i += kSegThreads) {
      const float* src = x + (size_t)__ldg(hot + h0 + i) * d;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(hot_rows + (size_t)i * d)), "l"(src), "r"(bytes),
             "r"(bar) : "memory");
    }
    mbar_wait(bar, 0);
  }
  cluster.sync();            // every CTA's hot rows are in place

  const int lane = threadIdx.x & 31;
  // segments from a queue, one at a time a warp
  int seg = lane == 0 ? atomicAdd(next, 1) : 0;
  seg = __shfl_sync(kFull, seg, 0);
  for (; seg < nseg; seg = __shfl_sync(kFull, lane == 0 ? atomicAdd(next, 1) : 0, 0)) {
    const int e0 = __ldg(seg_ptr + seg), e1 = __ldg(seg_ptr + seg + 1);
    float acc[NV][V];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int t = 0; t < V; ++t) acc[j][t] = 0.f;

    for (int base = e0; base < e1; base += 32) {
      const int n = min(32, e1 - base);
      const float* p_l = x;          // the source row of edge base + lane
      float w_l = 0.f;
      int shared_l = 0;              // 1 where that row is in shared memory
      if (lane < n) {
        const int c = __ldg(enc + base + lane);
        w_l = __ldg(weight + base + lane);
        if (mask != nullptr) w_l *= __ldg(mask + __ldg(orig + base + lane));
        if (c >= 0) {
          p_l = x + (size_t)c * d;
        } else if (-1 - c < n_fit) {
          const int s = -1 - c, owner = s / per;
          p_l = cluster.map_shared_rank(hot_rows, owner)
                + (size_t)(s - owner * per) * d;
          shared_l = 1;
        } else {
          p_l = x + (size_t)__ldg(hot - 1 - c) * d;
        }
      }
      const unsigned long long a_l = reinterpret_cast<unsigned long long>(p_l);
#pragma unroll kUnroll
      for (int i = 0; i < n; ++i) {
        const float* row =
            reinterpret_cast<const float*>(__shfl_sync(kFull, a_l, i));
        const bool in_shared = __shfl_sync(kFull, shared_l, i) != 0;
        const float w = __shfl_sync(kFull, w_l, i);
        const bool keep = w != 0.f;
        const float wm = kBf16 ? bf16_round(w) : w;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int f = (j * 32 + lane) * V;
          if (V > 1 || f < d) {
            float v[V];
            if (in_shared)
              load_any<V>(row + f, v);
            else
              load_vec<V>(row + f, v);
#pragma unroll
            for (int t = 0; t < V; ++t) {
              if (kBf16) {
                const float m = bf16_round(bf16_round(v[t]) * wm);
                acc[j][t] = keep ? acc[j][t] + m : acc[j][t];
              } else {
                acc[j][t] = keep ? fmaf(v[t], w, acc[j][t]) : acc[j][t];
              }
            }
          }
        }
      }
    }
    const int dst = __ldg(seg_dst + seg);
    float* o = dst >= 0 ? out + (size_t)dst * d
                        : partial + (size_t)(-1 - dst) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int f = (j * 32 + lane) * V;
      if (V > 1 || f < d) store_vec<V>(o + f, acc[j]);
    }
  }
  cluster.sync();            // no CTA leaves while others read its rows
}

// Features a lane loads at once: 4 where D is a multiple of 128 and every
// row of `p` is 16-byte aligned, 2 for multiples of 64 and 8 bytes, else 1.
int vec_width(int d, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (d % 128 == 0 && a % 16 == 0) return 4;
  if (d % 64 == 0 && a % 8 == 0) return 2;
  return 1;
}

constexpr int kMaxDim = 256;

// One instantiation's launch: its shared-memory and cluster opt-ins once per
// device, the number of clusters that fit on the card (cached per device and
// shared-memory size), then a grid of at most that many clusters.
template <int V, int NV, bool kBf16>
int launch_one(int nseg, const float* x, int d, const int* seg_ptr,
               const int* seg_dst, const int* enc, const int* hot, int n_fit,
               int per, const float* weight, const int* orig,
               const float* mask, float* out, float* partial, int* next,
               cudaStream_t stream) {
  auto kernel = segsum_kernel<V, NV, kBf16>;
  static bool opted[64] = {};
  static int fits_smem[64], fits[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kHotBytes);
    if (err == cudaSuccess && kCluster > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
    fits_smem[dev] = -1;
  }
  const int smem = n_fit > 0 ? per * d * 4 : 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kSegThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fits_smem[dev] != smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    fits[dev] = clusters;
    fits_smem[dev] = smem;
  }
  const long long ctas = (nseg + kSegWarps - 1) / kSegWarps;
  const long long clusters =
      std::min<long long>(fits[dev], (ctas + kCluster - 1) / kCluster);
  cfg.gridDim = dim3((unsigned)(clusters * kCluster));
  err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, x, d, seg_ptr, seg_dst, nseg, enc, hot,
                           n_fit, per, weight, orig, mask, out, partial, next);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int V, int NV>
int launch_segsum(bool bf16, int nseg, const float* x, int d,
                  const int* seg_ptr, const int* seg_dst, const int* enc,
                  const int* hot, int n_hot, const float* weight,
                  const int* orig, const float* mask, float* out,
                  float* partial, int* next, cudaStream_t stream) {
  // Hot rows this launch holds: as many of the list as fit in the cluster's
  // shared memory, spread evenly over its CTAs; none where a row cannot be
  // copied whole (cp.async.bulk moves 16-byte multiples between 16-byte
  // aligned addresses).
  const bool whole = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int n_fit = whole ? std::min(n_hot, kCluster * (kHotBytes / (4 * d))) : 0;
  const int per = std::max(1, (n_fit + kCluster - 1) / kCluster);
  if (bf16)
    return launch_one<V, NV, true>(nseg, x, d, seg_ptr, seg_dst, enc, hot, n_fit,
                                   per, weight, orig, mask, out, partial, next,
                                   stream);
  return launch_one<V, NV, false>(nseg, x, d, seg_ptr, seg_dst, enc, hot, n_fit,
                                  per, weight, orig, mask, out, partial, next,
                                  stream);
}

// The instantiation for (V, NV = ceil(d / (32 V))), d <= kMaxDim: `launch`
// is launch_segsum, the rest its arguments.
#define SKRX_DISPATCH(V_, NV_, launch, ...)                    \
  switch (V_ * 16 + NV_) {                                     \
    case 4 * 16 + 1: return launch<4, 1>(__VA_ARGS__);         \
    case 4 * 16 + 2: return launch<4, 2>(__VA_ARGS__);         \
    case 2 * 16 + 1: return launch<2, 1>(__VA_ARGS__);         \
    case 2 * 16 + 2: return launch<2, 2>(__VA_ARGS__);         \
    case 2 * 16 + 3: return launch<2, 3>(__VA_ARGS__);         \
    case 2 * 16 + 4: return launch<2, 4>(__VA_ARGS__);         \
    case 1 * 16 + 1: return launch<1, 1>(__VA_ARGS__);         \
    case 1 * 16 + 2: return launch<1, 2>(__VA_ARGS__);         \
    case 1 * 16 + 3: return launch<1, 3>(__VA_ARGS__);         \
    case 1 * 16 + 4: return launch<1, 4>(__VA_ARGS__);         \
    case 1 * 16 + 5: return launch<1, 5>(__VA_ARGS__);         \
    case 1 * 16 + 6: return launch<1, 6>(__VA_ARGS__);         \
    case 1 * 16 + 7: return launch<1, 7>(__VA_ARGS__);         \
    case 1 * 16 + 8: return launch<1, 8>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidValue;                \
  }

}  // namespace

extern "C" {

// out (num rows, d) gets every single-segment row; partial (P, d) the
// partial sums of the other rows' segments. enc: per edge, -(slot + 1) for
// the source row hot[slot] or the source row; hot: n_hot rows, hottest
// first (may be null when n_hot is 0). mask may be null. next: one int of
// scratch, the segment queue (zeroed here on the stream).
int skrx_segsum(const float* x, int d, const int* seg_ptr, const int* seg_dst,
                int nseg, const int* enc, const int* hot, int n_hot,
                const float* weight, const int* orig, const float* mask,
                int bf16, float* out, float* partial, int* next,
                cudaStream_t stream) {
  if (d < 1 || d > kMaxDim || nseg < 1 || n_hot < 0)
    return (int)cudaErrorInvalidValue;
  const int v = vec_width(d, x);
  const int nv = (d + 32 * v - 1) / (32 * v);
  SKRX_DISPATCH(v, nv, launch_segsum, bf16 != 0, nseg, x, d, seg_ptr,
                seg_dst, enc, hot, n_hot, weight, orig, mask, out, partial,
                next, stream);
}

}  // extern "C"
