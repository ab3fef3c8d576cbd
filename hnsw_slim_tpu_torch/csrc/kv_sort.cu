// Kι kv_sort: stable ascending sort of i32 keys carrying an i32 payload.
//
// Replaces (JAX): hnsw_slim_tpu/graph/revconn.py apply_insert's three
// lax.sort programs — the reverse-edge list (target, inserter) sorted by
// target, the overflow edges sorted by target again, and the key-only sort of
// the first-of-run overflow targets. Equal keys keep their input order and
// the padding key 2^30 sorts last, as lax.sort(num_keys=1) leaves them.
//
// What bounds it: bytes on paper (E keys and payloads read, E written), but E
// is a few 10^4 to 10^5, so the launches rule: the sort is a chain of
// dependent passes over at most a megabyte.
//
// Design: a bitonic network over composite 64-bit words
// (key with its sign bit flipped) << 32 | input position, padded to a power
// of two with all-ones words. The words are distinct, so any correct network
// sorts them stably, and the padding lands behind every element. A tile of
// 4096 words lives in shared memory: one launch sorts every tile, and each
// later merge stage k runs its strides >= 4096 as one global compare-exchange
// pass each and its strides < 4096 in one tile launch. The last tile launch
// unpacks the keys and gathers the payload by position. Everything is
// enqueued on the caller's stream; nothing is read back.
#include "common.cuh"

namespace {

typedef unsigned long long u64;
constexpr int TILE = 4096;
constexpr int THREADS = 1024;
constexpr int GTHREADS = 256;
constexpr unsigned SIGN = 0x80000000u;

// index of the lower element of compare-exchange pair t at stride j
__device__ __forceinline__ unsigned pair_lo(unsigned t, unsigned j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// strides j0, j0/2 .. 1 of merge stage k on the tile starting at word `base`
__device__ void tile_steps(u64* s, unsigned base, unsigned k, unsigned j0) {
  for (unsigned j = j0; j > 0; j >>= 1) {
    for (unsigned t = threadIdx.x; t < TILE / 2; t += THREADS) {
      const unsigned i = pair_lo(t, j), p = i | j;
      const bool asc = ((base + i) & k) == 0;
      const u64 a = s[i], b = s[p];
      if ((a > b) == asc) {
        s[i] = b;
        s[p] = a;
      }
    }
    __syncthreads();
  }
}

// write the tile back, or, after the last stage, unpack it into the outputs
__device__ void tile_store(const u64* s, unsigned base, bool last, u64* comp,
                           int n, const int* __restrict__ payload_in,
                           int* __restrict__ keys_out,
                           int* __restrict__ payload_out) {
  for (unsigned t = threadIdx.x; t < TILE; t += THREADS) {
    const unsigned g = base + t;
    if (!last) {
      comp[g] = s[t];
    } else if (g < (unsigned)n) {
      keys_out[g] = (int)((unsigned)(s[t] >> 32) ^ SIGN);
      if (payload_in) payload_out[g] = payload_in[(unsigned)s[t]];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sort_tile_kernel(const int* __restrict__ keys_in, int n, bool last, u64* comp,
                 const int* __restrict__ payload_in,
                 int* __restrict__ keys_out, int* __restrict__ payload_out) {
  __shared__ u64 s[TILE];
  const unsigned base = blockIdx.x * TILE;
  for (unsigned t = threadIdx.x; t < TILE; t += THREADS) {
    const unsigned g = base + t;
    s[t] = g < (unsigned)n
               ? ((u64)((unsigned)keys_in[g] ^ SIGN) << 32) | g
               : ~0ull;
  }
  __syncthreads();
  for (unsigned k = 2; k <= TILE; k <<= 1) tile_steps(s, base, k, k >> 1);
  tile_store(s, base, last, comp, n, payload_in, keys_out, payload_out);
}

__global__ void __launch_bounds__(GTHREADS)
global_step_kernel(u64* comp, unsigned half, unsigned j, unsigned k) {
  const unsigned t = blockIdx.x * GTHREADS + threadIdx.x;
  if (t >= half) return;
  const unsigned i = pair_lo(t, j), p = i | j;
  const bool asc = (i & k) == 0;
  const u64 a = comp[i], b = comp[p];
  if ((a > b) == asc) {
    comp[i] = b;
    comp[p] = a;
  }
}

__global__ void __launch_bounds__(THREADS)
merge_tile_kernel(u64* comp, unsigned k, int n, bool last,
                  const int* __restrict__ payload_in,
                  int* __restrict__ keys_out, int* __restrict__ payload_out) {
  __shared__ u64 s[TILE];
  const unsigned base = blockIdx.x * TILE;
  for (unsigned t = threadIdx.x; t < TILE; t += THREADS) s[t] = comp[base + t];
  __syncthreads();
  tile_steps(s, base, k, TILE / 2);
  tile_store(s, base, last, comp, n, payload_in, keys_out, payload_out);
}

}  // namespace

// comp: scratch of n_pad 64-bit words, n_pad = max(4096, next power of two of
// n). payload_in / payload_out may both be null (a key-only sort).
extern "C" int hs_kv_sort(const int* keys_in, const int* payload_in, int n,
                          int n_pad, void* comp, int* keys_out,
                          int* payload_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(comp);
  const unsigned np = (unsigned)n_pad;
  const unsigned tiles = np / TILE;
  sort_tile_kernel<<<tiles, THREADS, 0, st>>>(
      keys_in, n, np == (unsigned)TILE, c, payload_in, keys_out, payload_out);
  cudaError_t err = cudaGetLastError();
  for (unsigned k = 2u * TILE; k <= np && err == cudaSuccess; k <<= 1) {
    for (unsigned j = k >> 1; j >= (unsigned)TILE && err == cudaSuccess;
         j >>= 1) {
      global_step_kernel<<<(np / 2 + GTHREADS - 1) / GTHREADS, GTHREADS, 0,
                           st>>>(c, np / 2, j, k);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) break;
    merge_tile_kernel<<<tiles, THREADS, 0, st>>>(
        c, k, n, k == np, payload_in, keys_out, payload_out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
