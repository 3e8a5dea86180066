// Graph propagation, written by hand for Hopper (sm_90a). Replaces the
// Pallas kernel _segsum_kernel of skrx/ops/pallas/segsum_mxu.py (:203, its
// pallas_call at :249) together with the gather and weighting that
// _run_direction does around it in XLA:
//
//   out[d] = sum over edges e into row d of  msg_e,
//   msg_e  = x[src_e] * w_e,  w_e = weight_e * mask[orig_e] (mask optional)
//
// An edge with w_e == 0 adds an exact 0 even when x[src_e] is inf or NaN (the
// accumulator keeps its value; nothing is multiplied). With bf16 messages
// msg_e = bf16(bf16(x[src_e]) * bf16(w_e)), summed in f32: the product of two
// bf16 values is exact in f32, so rounding it once gives JAX's message.
//
// Bound: bytes. At the Gowalla-scale LightGCN graph (70,839 rows, 1.46M
// edges, D = 64) one call reads x once (18 MB) and the edge arrays (~12 MB)
// and writes the output (18 MB): ~48 MB, ~0.014 ms at 3.35 TB/s, against
// 0.003 ms for its 2*E*D flops. The row gathers repeat x ~20 times over, but
// x fits in the 50 MB L2.
//
// Design. The host lays the edges out by destination (CSR) and cuts every
// row into segments of at most SEGMENT_EDGES edges (../segsum.py); a row
// without edges has one empty segment. One warp walks one segment: its lanes
// load 32 edges' source ids and weights at once and broadcast them with
// shuffles, and for each edge the warp reads the source row coalesced, each
// lane owning V * NV features (float2 or float4 loads where D and alignment
// allow). Hub rows (11,582 edges into one item at Gowalla scale, against a
// mean of 21) are thus many short work items instead of one long warp that
// would set the time of the whole launch. A row of one segment is written by
// its warp. A row of several writes one partial row per segment to scratch,
// publishes it (__threadfence, then an atomicAdd on the row's arrival
// counter), and the warp that arrives last merges the row in the same
// launch: it reads the other partials through L2 (__ldcg: they were written
// during this launch, so the non-coherent path could serve stale lines),
// kMergeFloats registers of them in flight a lane, adds them in segment
// order from +0.0 and sets the counter back to 0 for the next launch. So a
// hub row of 91 partials costs its merging warp a dozen L2 round trips, not
// a second launch whose time one warp's 91 dependent loads set. The host
// puts the segments of such rows first, the rows of most segments first,
// so that their merges overlap the edge loops of the rest of the grid
// instead of trailing it. The adds are the same f32 adds in the same order
// whichever warp merges, so the sum is the same from run to run. Two
// launches on one set of counters must not overlap (one stream). The
// kernel is held to 32 registers (8 blocks of 256 threads an SM): the
// gather is latency-bound, and the merge's registers would otherwise cost
// it a quarter of its warps in flight, more than the merge saves.
//
// Plain C interface (launch on the caller's stream, return
// cudaGetLastError()); the wrapper in ../segsum.py checks shapes, types and
// devices, allocates the output and the scratch, and counts launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // segments (warps) per block
constexpr int kThreads = kWarps * 32;
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

// Loads and stores of partial rows: cached in L2 only, so a partial written
// by one SM during the launch is read from L2 by the SM that merges it.
template <int V>
__device__ __forceinline__ void load_cg(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
    r[0] = q.x; r[1] = q.y;
  } else {
    r[0] = __ldcg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_cg(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    __stcg(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
  } else if constexpr (V == 2) {
    __stcg(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
    __stcg(p, r[0]);
  }
}

// Partial-row features a lane of the merging warp keeps in flight.
constexpr int kMergeFloats = 16;

// Lane `lane` owns features (j * 32 + lane) * V .. + V - 1 for j < NV; with
// V == 1 the features at or past d are idle (D not a multiple of 32).
// part_merge maps a partial slot to its merged row m: merge_row[m] is the
// output row, merge_ptr[m] .. merge_ptr[m + 1] - 1 its partial slots in
// segment order, merge_count[m] its arrival counter (0 between launches).
template <int V, int NV, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
segsum_kernel(const float* __restrict__ x, int d,
              const int* __restrict__ seg_ptr, const int* __restrict__ seg_dst,
              int nseg, const int* __restrict__ src,
              const float* __restrict__ weight, const int* __restrict__ orig,
              const float* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ partial, const int* __restrict__ part_merge,
              const int* __restrict__ merge_row,
              const int* __restrict__ merge_ptr, int* __restrict__ merge_count) {
  const int lane = threadIdx.x & 31;
  const long long seg = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= nseg) return;                      // whole warps leave
  const int e0 = __ldg(seg_ptr + seg), e1 = __ldg(seg_ptr + seg + 1);
  float acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int t = 0; t < V; ++t) acc[j][t] = 0.f;

  for (int base = e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    int s_l = 0;
    float w_l = 0.f;
    if (lane < n) {
      s_l = __ldg(src + base + lane);
      w_l = __ldg(weight + base + lane);
      if (mask != nullptr) w_l *= __ldg(mask + __ldg(orig + base + lane));
    }
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int s = __shfl_sync(kFull, s_l, i);
      const float w = __shfl_sync(kFull, w_l, i);
      const bool keep = w != 0.f;
      const float wm = kBf16 ? bf16_round(w) : w;
      const float* row = x + (size_t)s * d;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int f = (j * 32 + lane) * V;
        if (V > 1 || f < d) {
          float v[V];
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
  if (dst >= 0) {
    float* o = out + (size_t)dst * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int f = (j * 32 + lane) * V;
      if (V > 1 || f < d) store_vec<V>(o + f, acc[j]);
    }
    return;
  }
  // a partial row: publish it, and merge the row if this warp came last
  const int slot = -1 - dst;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int f = (j * 32 + lane) * V;
    if (V > 1 || f < d) store_cg<V>(partial + (size_t)slot * d + f, acc[j]);
  }
  __threadfence();                   // each lane's stores before the count
  __syncwarp();
  const int m = __ldg(part_merge + slot);
  const int p0 = __ldg(merge_ptr + m), p1 = __ldg(merge_ptr + m + 1);
  int last = 0;
  if (lane == 0) last = atomicAdd(merge_count + m, 1) == p1 - p0 - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();                   // the count before the partials' loads
  constexpr int kRows = V * NV >= kMergeFloats ? 1 : kMergeFloats / (V * NV);
  float sum[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int t = 0; t < V; ++t) sum[j][t] = 0.f;
  for (int p = p0; p < p1; p += kRows) {
    float v[kRows][NV][V];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int f = (j * 32 + lane) * V;
        if (p + r == slot) {
#pragma unroll
          for (int t = 0; t < V; ++t) v[r][j][t] = acc[j][t];
        } else if (p + r < p1 && (V > 1 || f < d)) {
          load_cg<V>(partial + (size_t)(p + r) * d + f, v[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (p + r < p1)
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int t = 0; t < V; ++t) sum[j][t] += v[r][j][t];
  }
  float* o = out + (size_t)__ldg(merge_row + m) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int f = (j * 32 + lane) * V;
    if (V > 1 || f < d) store_vec<V>(o + f, sum[j]);
  }
  if (lane == 0) merge_count[m] = 0;
}

// Features a lane loads at once: 4 where D is a multiple of 128 and every
// row of `p` is 16-byte aligned, 2 for multiples of 64 and 8 bytes, else 1.
int vec_width(int d, uintptr_t p) {
  if (d % 128 == 0 && p % 16 == 0) return 4;
  if (d % 64 == 0 && p % 8 == 0) return 2;
  return 1;
}

constexpr int kMaxDim = 256;

template <int V, int NV>
int launch_segsum(bool bf16, int nseg, const float* x, int d,
                  const int* seg_ptr, const int* seg_dst, const int* src,
                  const float* weight, const int* orig, const float* mask,
                  float* out, float* partial, const int* part_merge,
                  const int* merge_row, const int* merge_ptr,
                  int* merge_count, cudaStream_t stream) {
  const int blocks = (nseg + kWarps - 1) / kWarps;
  if (bf16) {
    segsum_kernel<V, NV, true><<<blocks, kThreads, 0, stream>>>(
        x, d, seg_ptr, seg_dst, nseg, src, weight, orig, mask, out, partial,
        part_merge, merge_row, merge_ptr, merge_count);
  } else {
    segsum_kernel<V, NV, false><<<blocks, kThreads, 0, stream>>>(
        x, d, seg_ptr, seg_dst, nseg, src, weight, orig, mask, out, partial,
        part_merge, merge_row, merge_ptr, merge_count);
  }
  return (int)cudaGetLastError();
}

// The instantiation for (V, NV = ceil(d / (32 V))), d <= kMaxDim.
#define SKRX_DISPATCH(V_, NV_, ...)                                  \
  switch (V_ * 16 + NV_) {                                           \
    case 4 * 16 + 1: return launch_segsum<4, 1>(__VA_ARGS__);        \
    case 4 * 16 + 2: return launch_segsum<4, 2>(__VA_ARGS__);        \
    case 2 * 16 + 1: return launch_segsum<2, 1>(__VA_ARGS__);        \
    case 2 * 16 + 2: return launch_segsum<2, 2>(__VA_ARGS__);        \
    case 2 * 16 + 3: return launch_segsum<2, 3>(__VA_ARGS__);        \
    case 2 * 16 + 4: return launch_segsum<2, 4>(__VA_ARGS__);        \
    case 1 * 16 + 1: return launch_segsum<1, 1>(__VA_ARGS__);        \
    case 1 * 16 + 2: return launch_segsum<1, 2>(__VA_ARGS__);        \
    case 1 * 16 + 3: return launch_segsum<1, 3>(__VA_ARGS__);        \
    case 1 * 16 + 4: return launch_segsum<1, 4>(__VA_ARGS__);        \
    case 1 * 16 + 5: return launch_segsum<1, 5>(__VA_ARGS__);        \
    case 1 * 16 + 6: return launch_segsum<1, 6>(__VA_ARGS__);        \
    case 1 * 16 + 7: return launch_segsum<1, 7>(__VA_ARGS__);        \
    case 1 * 16 + 8: return launch_segsum<1, 8>(__VA_ARGS__);        \
    default: return (int)cudaErrorInvalidValue;                      \
  }

}  // namespace

extern "C" {

int skrx_segsum_abi_version() { return 2; }

// out (num rows, d) gets every row; partial (P, d) is scratch for the
// partial sums of the rows of several segments. mask may be null; so may
// the four merge arrays, when no segment is partial (seg_dst >= 0).
int skrx_segsum(const float* x, int d, const int* seg_ptr, const int* seg_dst,
                int nseg, const int* src, const float* weight,
                const int* orig, const float* mask, int bf16, float* out,
                float* partial, const int* part_merge, const int* merge_row,
                const int* merge_ptr, int* merge_count, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim || nseg < 1) return (int)cudaErrorInvalidValue;
  // x's, out's and partial's rows share one vector width
  const uintptr_t all = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(partial);
  const int v = vec_width(d, all);
  const int nv = (d + 32 * v - 1) / (32 * v);
  SKRX_DISPATCH(v, nv, bf16 != 0, nseg, x, d, seg_ptr, seg_dst, src, weight,
                orig, mask, out, partial, part_merge, merge_row, merge_ptr,
                merge_count, stream);
}

}  // extern "C"
