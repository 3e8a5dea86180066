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
// its warp; a row of several writes one partial row per segment to scratch,
// and segsum_merge_kernel adds a row's partials in segment order. No
// atomics, so the sum is the same from run to run.
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

// Lane `lane` owns features (j * 32 + lane) * V .. + V - 1 for j < NV; with
// V == 1 the features at or past d are idle (D not a multiple of 32).
template <int V, int NV, bool kBf16>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ x, int d,
              const int* __restrict__ seg_ptr, const int* __restrict__ seg_dst,
              int nseg, const int* __restrict__ src,
              const float* __restrict__ weight, const int* __restrict__ orig,
              const float* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ partial) {
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
  float* o = dst >= 0 ? out + (size_t)dst * d
                      : partial + (size_t)(-1 - dst) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int f = (j * 32 + lane) * V;
    if (V > 1 || f < d) store_vec<V>(o + f, acc[j]);
  }
}

// Row merge_row[r] = sum of partial rows merge_ptr[r] .. merge_ptr[r+1]-1,
// in order; one warp a row, lanes own features as above.
template <int V, int NV>
__global__ void __launch_bounds__(kThreads)
segsum_merge_kernel(const float* __restrict__ partial, int d,
                    const int* __restrict__ merge_row,
                    const int* __restrict__ merge_ptr, int nmerge,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= nmerge) return;
  const int p0 = __ldg(merge_ptr + r), p1 = __ldg(merge_ptr + r + 1);
  float acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int t = 0; t < V; ++t) acc[j][t] = 0.f;
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const float* row = partial + (size_t)p * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int f = (j * 32 + lane) * V;
      if (V > 1 || f < d) {
        float v[V];
        load_vec<V>(row + f, v);
#pragma unroll
        for (int t = 0; t < V; ++t) acc[j][t] += v[t];
      }
    }
  }
  float* o = out + (size_t)__ldg(merge_row + r) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int f = (j * 32 + lane) * V;
    if (V > 1 || f < d) store_vec<V>(o + f, acc[j]);
  }
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

template <int V, int NV>
int launch_segsum(bool bf16, int nseg, const float* x, int d,
                  const int* seg_ptr, const int* seg_dst, const int* src,
                  const float* weight, const int* orig, const float* mask,
                  float* out, float* partial, cudaStream_t stream) {
  const int blocks = (nseg + kWarps - 1) / kWarps;
  if (bf16) {
    segsum_kernel<V, NV, true><<<blocks, kThreads, 0, stream>>>(
        x, d, seg_ptr, seg_dst, nseg, src, weight, orig, mask, out, partial);
  } else {
    segsum_kernel<V, NV, false><<<blocks, kThreads, 0, stream>>>(
        x, d, seg_ptr, seg_dst, nseg, src, weight, orig, mask, out, partial);
  }
  return (int)cudaGetLastError();
}

template <int V, int NV>
int launch_merge(int nmerge, const float* partial, int d,
                 const int* merge_row, const int* merge_ptr, float* out,
                 cudaStream_t stream) {
  const int blocks = (nmerge + kWarps - 1) / kWarps;
  segsum_merge_kernel<V, NV><<<blocks, kThreads, 0, stream>>>(
      partial, d, merge_row, merge_ptr, nmerge, out);
  return (int)cudaGetLastError();
}

// The instantiation for (V, NV = ceil(d / (32 V))), d <= kMaxDim: `launch`
// is launch_segsum or launch_merge, the rest its arguments.
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

int skrx_segsum_abi_version() { return 1; }

// out (num rows, d) gets every single-segment row; partial (P, d) the
// partial sums of the other rows' segments. mask may be null.
int skrx_segsum(const float* x, int d, const int* seg_ptr, const int* seg_dst,
                int nseg, const int* src, const float* weight,
                const int* orig, const float* mask, int bf16, float* out,
                float* partial, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim || nseg < 1) return (int)cudaErrorInvalidValue;
  const int v = vec_width(d, x);
  const int nv = (d + 32 * v - 1) / (32 * v);
  SKRX_DISPATCH(v, nv, launch_segsum, bf16 != 0, nseg, x, d, seg_ptr,
                seg_dst, src, weight, orig, mask, out, partial, stream);
}

int skrx_segsum_merge(const float* partial, int d, const int* merge_row,
                      const int* merge_ptr, int nmerge, float* out,
                      cudaStream_t stream) {
  if (d < 1 || d > kMaxDim || nmerge < 1) return (int)cudaErrorInvalidValue;
  // out's rows share partial's alignment only if out's base allows it too
  const uintptr_t both = reinterpret_cast<uintptr_t>(partial) |
                         reinterpret_cast<uintptr_t>(out);
  const int v = vec_width(d, reinterpret_cast<const void*>(both));
  const int nv = (d + 32 * v - 1) / (32 * v);
  SKRX_DISPATCH(v, nv, launch_merge, nmerge, partial, d, merge_row,
                merge_ptr, out, stream);
}

}  // extern "C"
