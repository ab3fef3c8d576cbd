// K1 point_dist: distances of queries to per-query rows, one warp per
// (query, row).
//
// Replaces (JAX): hnsw_slim_tpu/ops/distance.py gathered_dist (q f32[B, d]
// against gathered rows f32/bf16[B, W, d] by one einsum, upcast to fp32) and
// point_dist (the rowwise form). On the query path it scores every query's
// entry point (graph/search.py entry_dist: vectors[cur] gathered first, then
// the einsum); the NN-descent build scores its pruned edges with it.
//
// What bounds it: the row reads, D*4 bytes a row (D*2 from a bfloat16
// store), and one dot of 2*D flops on each; at the entry point's B x 1 rows
// (4096 x 512 B) the launch itself dominates.
//
// Design: the rows are named by id and gathered inside the kernel (row
// ids[b, w] of the store x[N, D]), so no [B, W, D] copy is made; without
// ids, row (b, w) is x[b * W + w] (rows already gathered). A warp reads its
// row with one 16-byte (fp32) or 8-byte (bf16) load a lane at D = 128 and
// the query with the same pattern, widens bf16 to fp32 in registers
// (common.cuh load4) and reduces with a butterfly. The formulas are the JAX
// package's: expanded |q|^2 + |x|^2 - 2 q.x (|x|^2 from xn when given, else
// from the row), the difference form sum (q - x)^2 of point_dist, or
// 1 - q.x for the inner-product metric. A negative id gives +inf.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

template <class T>
__global__ void __launch_bounds__(THREADS)
point_kernel(const float* __restrict__ q, const float* __restrict__ qn,
             const T* __restrict__ x, const float* __restrict__ xn,
             const int* __restrict__ ids, int B, int W, int D, int metric,
             int diff, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const size_t g = (size_t)blockIdx.x * NW + (threadIdx.x >> 5);
  if (g >= (size_t)B * W) return;  // whole warp; no block barrier
  const size_t b = g / W;
  const long long row = ids ? (long long)ids[g] : (long long)g;
  if (row < 0) {
    if (lane == 0) out[g] = HS_INF;
    return;
  }
  const float* qr = q + b * D;
  const T* xr = x + (size_t)row * D;
  const bool vec4 = hs::can_vec4(x, D) && hs::can_vec4(q, D);
  float s = 0.f, n = 0.f;  // q.x (or the squared difference) and |x|^2
  if (vec4) {
    for (int e = lane * 4; e < D; e += 128) {
      const float4 a = hs::load4(qr + e);
      const float4 v = hs::load4(xr + e);
      if (diff && !metric) {
        const float d0 = a.x - v.x, d1 = a.y - v.y;
        const float d2 = a.z - v.z, d3 = a.w - v.w;
        s = fmaf(d0, d0, s); s = fmaf(d1, d1, s);
        s = fmaf(d2, d2, s); s = fmaf(d3, d3, s);
      } else {
        s = fmaf(a.x, v.x, s); s = fmaf(a.y, v.y, s);
        s = fmaf(a.z, v.z, s); s = fmaf(a.w, v.w, s);
        n = fmaf(v.x, v.x, n); n = fmaf(v.y, v.y, n);
        n = fmaf(v.z, v.z, n); n = fmaf(v.w, v.w, n);
      }
    }
  } else {
    for (int e = lane; e < D; e += 32) {
      const float a = __ldg(qr + e), v = hs::load1(xr + e);
      if (diff && !metric) {
        s = fmaf(a - v, a - v, s);
      } else {
        s = fmaf(a, v, s);
        n = fmaf(v, v, n);
      }
    }
  }
  s = hs::warp_sum(s);
  const bool own_norm = !metric && !diff && !xn;  // |x|^2 from the row
  if (own_norm) n = hs::warp_sum(n);  // warp-uniform branch
  if (lane) return;
  float dist;
  if (metric) {
    dist = 1.f - s;
  } else if (diff) {
    dist = s;
  } else {
    const float nx = own_norm ? n : xn[ids ? row : (long long)g];
    dist = (qn[b] + nx) - 2.f * s;
  }
  out[g] = dist;
}

template <class T>
int launch_point(const float* q, const float* qn, const T* x, const float* xn,
                 const int* ids, int B, int W, int D, int metric, int diff,
                 float* out, void* stream) {
  const size_t warps = (size_t)B * W;
  const unsigned grid = static_cast<unsigned>((warps + NW - 1) / NW);
  point_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qn, x, xn, ids, B, W, D, metric, diff, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q f32[B, D]; rows x[ids[b, w]] (ids i32[B, W]) or x[b * W + w] (ids
// null); qn f32[B] (expanded L2 only); xn f32 per row of x or null (|x|^2
// from the row); diff: the difference form; out f32[B, W]
extern "C" int hs_point_dist(const float* q, const float* qn, const float* x,
                             const float* xn, const int* ids, int B, int W,
                             int D, int metric, int diff, float* out,
                             void* stream) {
  return launch_point(q, qn, x, xn, ids, B, W, D, metric, diff, out, stream);
}

// the same over bfloat16 rows
extern "C" int hs_point_dist_bf16(const float* q, const float* qn,
                                  const __nv_bfloat16* x, const float* xn,
                                  const int* ids, int B, int W, int D,
                                  int metric, int diff, float* out,
                                  void* stream) {
  return launch_point(q, qn, x, xn, ids, B, W, D, metric, diff, out, stream);
}
