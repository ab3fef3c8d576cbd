// Kκ radix_sort: stable LSD radix sort of u32 keys carrying an i32 payload.
//
// Replaces (JAX): the large sorts of the NN-descent build —
// hnsw_slim_tpu/graph/nnd.py rp_init's per-projection argsort of n f32 keys
// (:116), the reverse-edge sort of n*k (target, source) pairs in
// _nnd_candidates / nnd_round (:171, :253), and the two lexsorts of
// hnsw_slim_tpu/graph/build.py mutual_union (:232, :239; each lexsort is two
// stable passes of this sort). Equal keys keep their input order, as
// lax.sort and jnp.argsort leave them.
//
// Keys: the low key_bits bits of each word (the caller guarantees the rest
// are zero), or, with float_keys, f32 bit patterns compared through an
// order-preserving map: -0.0 becomes +0.0 first (lax.sort and torch.sort
// treat the two as equal and keep input order), then a negative key has all
// its bits flipped and a non-negative one its top bit set, so +inf sorts
// after every finite key. The map is applied when a digit is taken; the
// output holds the input words unchanged.
//
// What bounds it: bytes. A pass reads each key once for the histogram and
// each key and payload once for the scatter, and writes both: 20 B an
// element a pass, ceil(key_bits / 8) passes (3 for ids below 2^24).
//
// Design, per 8-bit digit from the lowest: (1) a histogram per tile of 4096
// elements in shared memory, also summed into the 256 digit totals with
// atomics; (2) one block per digit scans that digit's per-tile counts and
// adds the totals of all lower digits, giving each (digit, tile) its first
// output position; (3) a scatter per tile: each of 8 warps takes 512
// consecutive elements in 16 steps of 32, ranks equal digits inside a step
// with __match_any_sync (lanes are in input order), and keeps a running
// offset per (warp, digit) in shared memory; a first walk counts each warp's
// digits so the warps' offsets follow the input order. Tiles, warps, steps
// and lanes all follow the input order, so the pass is stable. Passes
// alternate between the output and a scratch buffer so that the last one
// lands in the output.
#include "common.cuh"

namespace {

constexpr int TILE = 4096;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int STEPS = TILE / THREADS;  // 16 steps of 32 per warp
constexpr int RADIX = 256;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ unsigned sort_bits(unsigned u, bool flt) {
  if (!flt) return u;
  if (u == 0x80000000u) u = 0u;  // -0.0 sorts as +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const unsigned* __restrict__ keys, int E, int shift, bool flt,
            int n_tiles, unsigned* __restrict__ counts,
            unsigned* __restrict__ totals) {
  __shared__ unsigned h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += THREADS) h[d] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long g = base + t;
    if (g < E) atomicAdd(&h[(sort_bits(keys[g], flt) >> shift) & 255u], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += THREADS) {
    counts[(size_t)d * n_tiles + blockIdx.x] = h[d];
    if (h[d]) atomicAdd(&totals[d], h[d]);
  }
}

// exclusive scan over a block of SCAN_THREADS; *total gets the block's sum
__device__ unsigned block_exscan(unsigned v, unsigned* ws, unsigned* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(HS_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    unsigned s = ws[lane];  // SCAN_THREADS / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(HS_FULL, s, o);
      if (lane >= o) s += y;
    }
    ws[lane] = s;
  }
  __syncthreads();
  const unsigned out = (w ? ws[w - 1] : 0u) + x - v;
  *total = ws[31];
  __syncthreads();
  return out;
}

// one block per digit: counts[d, :] -> first output position of each tile's
// elements of digit d
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(unsigned* __restrict__ counts, int n_tiles,
            const unsigned* __restrict__ totals) {
  __shared__ unsigned ws[32];
  __shared__ unsigned base_s;
  const int d = blockIdx.x;
  if (threadIdx.x < 32) {
    unsigned s = 0u;
    for (int j = threadIdx.x; j < d; j += 32) s += totals[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(HS_FULL, s, o);
    if (threadIdx.x == 0) base_s = s;
  }
  __syncthreads();
  unsigned carry = base_s;
  unsigned* row = counts + (size_t)d * n_tiles;
  for (int start = 0; start < n_tiles; start += SCAN_THREADS) {
    const int i = start + threadIdx.x;
    const unsigned v = i < n_tiles ? row[i] : 0u;
    unsigned tot;
    const unsigned ex = block_exscan(v, ws, &tot);
    if (i < n_tiles) row[i] = carry + ex;
    carry += tot;
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const unsigned* __restrict__ keys_in,
               const int* __restrict__ pay_in, int E, int shift, bool flt,
               int n_tiles, const unsigned* __restrict__ offs,
               unsigned* __restrict__ keys_out, int* __restrict__ pay_out) {
  __shared__ unsigned wofs[NWARP][RADIX];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long wbase = (long long)blockIdx.x * TILE + w * (TILE / NWARP);
  unsigned k[STEPS];
  int p[STEPS];
  int dg[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const long long g = wbase + s * 32 + lane;
    const bool ok = g < E;
    k[s] = ok ? keys_in[g] : 0u;
    p[s] = ok ? pay_in[g] : 0;
    dg[s] = ok ? (int)((sort_bits(k[s], flt) >> shift) & 255u) : RADIX;
  }
  for (int d = lane; d < RADIX; d += 32) wofs[w][d] = 0u;
  __syncwarp();
  // walk 1: this warp's count of each digit
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const unsigned m = __match_any_sync(HS_FULL, dg[s]);
    if (dg[s] < RADIX && lane == __ffs(m) - 1) wofs[w][dg[s]] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first position per digit: the tile's offset plus the counts
  // of the warps before it
  for (int d = threadIdx.x; d < RADIX; d += THREADS) {
    unsigned run = offs[(size_t)d * n_tiles + blockIdx.x];
    for (int j = 0; j < NWARP; ++j) {
      const unsigned c = wofs[j][d];
      wofs[j][d] = run;
      run += c;
    }
  }
  __syncthreads();
  // walk 2: rank inside each step, write, advance the running offsets
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const unsigned m = __match_any_sync(HS_FULL, dg[s]);
    if (dg[s] < RADIX) {
      const unsigned pos = wofs[w][dg[s]] + __popc(m & lt);
      keys_out[pos] = k[s];
      pay_out[pos] = p[s];
    }
    __syncwarp();
    if (dg[s] < RADIX && lane == __ffs(m) - 1) wofs[w][dg[s]] += __popc(m);
    __syncwarp();
  }
}

}  // namespace

// keys_tmp / pay_tmp: E words each; counts: 256 * ceil(E / 4096) words;
// totals: 256 words. The inputs are not modified.
extern "C" int hs_radix_sort(const int* keys_in, const int* pay_in, int E,
                             int key_bits, int float_keys, int* keys_out,
                             int* pay_out, int* keys_tmp, int* pay_tmp,
                             void* counts, void* totals, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  const int passes = (key_bits + 7) / 8;
  const int n_tiles = (E + TILE - 1) / TILE;
  const unsigned* src_k = reinterpret_cast<const unsigned*>(keys_in);
  const int* src_p = pay_in;
  unsigned* cnt = static_cast<unsigned*>(counts);
  unsigned* tot = static_cast<unsigned*>(totals);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < passes && err == cudaSuccess; ++i) {
    const bool to_out = ((passes - 1 - i) & 1) == 0;
    unsigned* dst_k = reinterpret_cast<unsigned*>(to_out ? keys_out
                                                         : keys_tmp);
    int* dst_p = to_out ? pay_out : pay_tmp;
    err = cudaMemsetAsync(tot, 0, RADIX * sizeof(unsigned), st);
    if (err != cudaSuccess) break;
    hist_kernel<<<n_tiles, THREADS, 0, st>>>(src_k, E, 8 * i, float_keys != 0,
                                             n_tiles, cnt, tot);
    scan_kernel<<<RADIX, SCAN_THREADS, 0, st>>>(cnt, n_tiles, tot);
    scatter_kernel<<<n_tiles, THREADS, 0, st>>>(
        src_k, src_p, E, 8 * i, float_keys != 0, n_tiles, cnt, dst_k, dst_p);
    err = cudaGetLastError();
    src_k = dst_k;
    src_p = dst_p;
  }
  return static_cast<int>(err);
}
