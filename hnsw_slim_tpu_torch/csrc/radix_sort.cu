// Kκ radix_sort: stable one-sweep LSD radix sort of 32-bit keys carrying an
// optional i32 payload.
//
// Replaces (JAX): the large sorts of the NN-descent build —
// hnsw_slim_tpu/graph/nnd.py rp_init's per-projection argsort of n f32 keys
// (:116), the reverse-edge sort of n*k (target, source) pairs in
// _nnd_candidates / nnd_round (:171, :253), the two lexsorts of
// hnsw_slim_tpu/graph/build.py mutual_union (:232, :239; each lexsort is two
// stable passes of this sort) — and, in its ids map, the reverse-edge
// lax.sort of hnsw_slim_tpu/graph/revconn.py apply_insert (:90; its sorts at
// :110 and :117 order lists that are already in order, and Kζ's settle
// launch numbers them with a scan instead, csrc/rev_connect.cu).
// Equal keys keep their input order, as lax.sort and jnp.argsort leave them.
//
// Digit maps (applied only when a digit is taken; the output holds the input
// words unchanged):
//   u32     the word itself (the caller keeps the bits above key_bits zero);
//   f32     -0.0 becomes +0.0 (lax.sort and torch.sort tie the two), then a
//           negative key has all its bits flipped and a non-negative one its
//           top bit set, so +inf sorts after every finite key;
//   signed  the sign bit flipped: i32 order;
//   ids     min(word, 2^key_bits - 1): node ids below n < 2^key_bits, and
//           the padding word 2^30 sent to the top digit value, where all
//           padding words tie and keep their input order.
//
// What bounds it: bytes. One histogram launch reads every key once (4 B an
// element); each digit pass reads a key and a payload and writes both (16 B
// an element, 8 B without payload); ceil(key_bits / 8) passes.
//
// Design (Adinets & Merrill, "Onesweep", 2022), 1 + passes launches:
// (1) hist_kernel reads the keys once with 16-byte loads, counts the digits
//     of every pass in shared memory and adds them to a zeroed accumulator
//     with global atomics; the last block to finish (a ticket on the same
//     buffer) turns each pass's 256 totals into their exclusive scan — the
//     first output slot of each digit — and zeroes the accumulator and the
//     ticket again for the next sort. The same launch zeroes every pass's
//     look-back words and tile counters.
// (2) pass_kernel, one block per tile of 8192 elements (512 threads x 16):
//     the tile id comes from an atomic counter, not blockIdx, so a tile only
//     waits on tiles whose blocks already run (no deadlock in the
//     look-back). The tile is staged in shared memory with 16-byte loads
//     (any start alignment). Each warp ranks its 512 elements in input
//     order, 32 at a time: every lane sets its bit in the warp's shared
//     mask of its digit (cheaper than __match_any_sync), and the mask's
//     lower bits are its rank.
//     An exclusive scan over the (warp, digit) counts places them, and each
//     digit's count is published at once as one 32-bit word (2-bit status:
//     aggregate or inclusive, 30-bit count). The tile is scattered into
//     shared memory in digit order, then one thread per digit walks back
//     over earlier tiles (8 words at a time) for its exclusive prefix and
//     publishes the inclusive one, and the block writes from shared memory
//     so that consecutive threads fill consecutive slots of a digit's run
//     (whole sectors, not one word per run). Tiles, warps, steps and lanes
//     all follow the input order, so every pass is stable. Passes alternate
//     between the output and a scratch buffer so that the last one lands in
//     the output.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int NWARP = THREADS / 32;
constexpr int ITEMS = 16;                // elements a thread ranks
constexpr int WARP_ITEMS = 32 * ITEMS;   // elements a warp ranks
constexpr int TILE = THREADS * ITEMS;    // 8192
constexpr int VPT = TILE / 4 / THREADS + 1;  // 16-byte loads a thread
constexpr int RADIX = 256;
constexpr int LOOK_AHEAD = 8;            // look-back words read at once
constexpr int MAX_PASSES = 4;
constexpr int HIST_THREADS = 512;
constexpr int HIST_BLOCKS = 1056;        // 8 a streaming multiprocessor
constexpr unsigned FLAG_A = 1u << 30;    // the tile's own count
constexpr unsigned FLAG_P = 2u << 30;    // the count through this tile
constexpr unsigned COUNT = FLAG_A - 1u;

enum KeyMap { MAP_U32 = 0, MAP_F32 = 1, MAP_SIGNED = 2, MAP_IDS = 3 };

template <int MAP>
__device__ __forceinline__ unsigned map_key(unsigned u, unsigned top) {
  if (MAP == MAP_F32) {
    if (u == 0x80000000u) u = 0u;  // -0.0 sorts as +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  if (MAP == MAP_SIGNED) return u ^ 0x80000000u;
  if (MAP == MAP_IDS) return min(u, top);
  return u;
}

// Exclusive scan of v over threads 0..255 (the others pass anything and get
// junk). Every thread of the block calls it; ws holds 8 words.
__device__ unsigned scan256(unsigned v, unsigned* ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(HS_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (w < RADIX / 32 && lane == 31) ws[w] = x;
  __syncthreads();
  unsigned pre = 0u;
  for (int i = 0; i < w && i < RADIX / 32; ++i) pre += ws[i];
  __syncthreads();
  return pre + x - v;
}

template <int MAP>
__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(const unsigned* __restrict__ keys, int E, int passes,
            unsigned top, unsigned* acc, unsigned* __restrict__ bases,
            uint4* __restrict__ zero, long long zero_vecs) {
  __shared__ unsigned h[MAX_PASSES * RADIX];
  __shared__ unsigned ws[8];
  __shared__ bool last;
  const long long gtid = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
  const long long gstride = (long long)gridDim.x * HIST_THREADS;
  for (long long i = gtid; i < zero_vecs; i += gstride)
    zero[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < MAX_PASSES * RADIX; i += HIST_THREADS)
    h[i] = 0u;
  __syncthreads();
  auto add = [&](unsigned u) {
    const unsigned m = map_key<MAP>(u, top);
#pragma unroll
    for (int p = 0; p < MAX_PASSES; ++p)
      if (p < passes) atomicAdd(&h[p * RADIX + ((m >> (8 * p)) & 255u)], 1u);
  };
  // the words before the first 16-byte boundary, whole vectors, the tail
  const int head =
      min((int)(((16u - ((unsigned)(uintptr_t)keys & 15u)) & 15u) >> 2), E);
  const long long nvec = (E - head) / 4;
  const uint4* kv = reinterpret_cast<const uint4*>(keys + head);
  for (long long i = gtid; i < nvec; i += gstride) {
    const uint4 v = kv[i];
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
  const long long rest = head + nvec * 4;
  if (gtid < head) add(keys[gtid]);
  if (gtid < E - rest) add(keys[rest + gtid]);
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += HIST_THREADS)
    if (h[i]) atomicAdd(&acc[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&acc[MAX_PASSES * RADIX], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < passes; ++p) {
    const unsigned v = threadIdx.x < RADIX
                           ? atomicExch(&acc[p * RADIX + threadIdx.x], 0u)
                           : 0u;
    const unsigned ex = scan256(v, ws);
    if (threadIdx.x < RADIX) bases[p * RADIX + threadIdx.x] = ex;
  }
  if (threadIdx.x == 0) atomicExch(&acc[MAX_PASSES * RADIX], 0u);
}

// Stage cnt words from src (any 4-byte alignment) into dst[0, cnt) with
// 16-byte loads. A load may cover up to 3 words before src or after its end,
// inside the same 16-byte block; they are not stored.
__device__ __forceinline__ void load_tile(const unsigned* __restrict__ src,
                                          int cnt, unsigned* dst) {
  const int off = (int)(((unsigned)(uintptr_t)src & 15u) >> 2);
  const uint4* v = reinterpret_cast<const uint4*>(src - off);
  const int nv = (off + cnt + 3) >> 2;
  uint4 buf[VPT];
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const int i = threadIdx.x + q * THREADS;
    if (i < nv) buf[q] = v[i];
  }
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const int i = threadIdx.x + q * THREADS;
    if (i >= nv) continue;
    const int e0 = 4 * i - off;
    if (off == 0 && e0 + 4 <= cnt) {
      reinterpret_cast<uint4*>(dst)[i] = buf[q];
      continue;
    }
    const unsigned w[4] = {buf[q].x, buf[q].y, buf[q].z, buf[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e0 + c >= 0 && e0 + c < cnt) dst[e0 + c] = w[c];
  }
}

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void st_volatile(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

template <bool PAY>
constexpr int pass_smem() {
  return (TILE + 2 * NWARP * RADIX + (PAY ? TILE : 0)) * (int)sizeof(unsigned);
}

template <int MAP, bool PAY>
__global__ void __launch_bounds__(THREADS, 2)
pass_kernel(const unsigned* __restrict__ keys_in,
            const unsigned* __restrict__ pay_in, int E, int shift,
            unsigned top, const unsigned* __restrict__ bases,
            unsigned* lookback, unsigned* counter,
            unsigned* __restrict__ keys_out, unsigned* __restrict__ pay_out) {
  extern __shared__ uint4 smem_v[];
  unsigned* s_k = reinterpret_cast<unsigned*>(smem_v);  // TILE
  unsigned* s_wc = s_k + TILE;                           // NWARP x RADIX
  unsigned* s_p = s_wc + NWARP * RADIX;                  // TILE (PAY)
  unsigned* s_mb = s_p + (PAY ? TILE : 0);  // NWARP x RADIX lane masks
  __shared__ unsigned s_off[RADIX];  // the tile's first slot of each digit
  __shared__ unsigned s_gb[RADIX];   // output slot of the tile's slot 0
  __shared__ unsigned ws[8];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter, 1u);
  for (int i = threadIdx.x; i < NWARP * RADIX; i += THREADS)
    s_wc[i] = s_mb[i] = 0u;
  __syncthreads();
  const int tile = s_tile;
  const long long tb = (long long)tile * TILE;
  const int cnt = (int)min((long long)TILE, (long long)E - tb);
  load_tile(keys_in + tb, cnt, s_k);
  if (PAY) load_tile(pay_in + tb, cnt, s_p);
  __syncthreads();

  // rank: item j of lane l of warp w is tile element w*512 + j*32 + l, so
  // (warp, step, lane) is the input order
  unsigned k[ITEMS], r[ITEMS];
  unsigned* wc = s_wc + w * RADIX;
  unsigned* mb = s_mb + w * RADIX;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int idx = w * WARP_ITEMS + j * 32 + lane;
    const bool ok = idx < cnt;
    k[j] = ok ? s_k[idx] : 0u;
    const unsigned d =
        ok ? (map_key<MAP>(k[j], top) >> shift) & 255u : (unsigned)RADIX;
    // m: the lanes of this step that share my digit
    if (ok) atomicOr(&mb[d], 1u << lane);
    __syncwarp();
    const unsigned m = ok ? mb[d] : 0u;
    const unsigned before = ok ? wc[d] : 0u;
    r[j] = before + __popc(m & lt);
    __syncwarp();
    if (ok && lane == __ffs(m) - 1) {
      wc[d] = before + __popc(m);
      mb[d] = 0u;
    }
    __syncwarp();
  }
  __syncthreads();

  // per digit: each warp's first rank (exclusive over warps), the tile's
  // count, published as this tile's aggregate at once
  const int dg = threadIdx.x;
  unsigned dcount = 0u;
  if (dg < RADIX) {
#pragma unroll
    for (int j = 0; j < NWARP; ++j) {
      const unsigned c = s_wc[j * RADIX + dg];
      s_wc[j * RADIX + dg] = dcount;
      dcount += c;
    }
    st_volatile(&lookback[(size_t)tile * RADIX + dg],
                (tile ? FLAG_A : FLAG_P) | dcount);
  }
  const unsigned off = scan256(dcount, ws);
  if (dg < RADIX) s_off[dg] = off;
  __syncthreads();

  // scatter the tile into shared memory in digit order: keys, then payload
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (w * WARP_ITEMS + j * 32 + lane < cnt) {
      const unsigned d = (map_key<MAP>(k[j], top) >> shift) & 255u;
      r[j] += s_off[d] + wc[d];
      s_k[r[j]] = k[j];
    }
  }
  if (PAY) {
    unsigned p[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = w * WARP_ITEMS + j * 32 + lane;
      p[j] = idx < cnt ? s_p[idx] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (w * WARP_ITEMS + j * 32 + lane < cnt) s_p[r[j]] = p[j];
  }

  // decoupled look-back, one thread per digit: LOOK_AHEAD earlier tiles'
  // words read at once, summed back to the first inclusive one; a word not
  // yet published is read again
  if (dg < RADIX) {
    unsigned excl = 0u;
    unsigned spins = 0u;
    for (int t = tile - 1; t >= 0;) {
      unsigned v[LOOK_AHEAD];
#pragma unroll
      for (int q = 0; q < LOOK_AHEAD; ++q)  // before tile 0: inclusive 0
        v[q] = t - q >= 0
                   ? ld_volatile(&lookback[(size_t)(t - q) * RADIX + dg])
                   : FLAG_P;
      int q = 0;
      bool done = false;
#pragma unroll
      for (; q < LOOK_AHEAD; ++q) {
        if ((v[q] & ~COUNT) == 0u) break;  // not published yet
        excl += v[q] & COUNT;
        if (v[q] & FLAG_P) {
          done = true;
          break;
        }
      }
      if (done) break;
      // an earlier tile's block always runs, so it publishes within
      // microseconds; fail the launch rather than hang if it never does
      if (q == 0 && ++spins == (1u << 24)) __trap();
      t -= q;
    }
    if (tile) st_volatile(&lookback[(size_t)tile * RADIX + dg],
                          FLAG_P | (excl + dcount));
    s_gb[dg] = bases[dg] + excl - off;
  }
  __syncthreads();

  // write: consecutive threads, consecutive slots of one digit's run
  for (int i = threadIdx.x; i < cnt; i += THREADS) {
    const unsigned key = s_k[i];
    const unsigned g = s_gb[(map_key<MAP>(key, top) >> shift) & 255u] + i;
    keys_out[g] = key;
    if (PAY) pay_out[g] = s_p[i];
  }
}

template <int MAP, bool PAY>
cudaError_t launch_pass(int tiles, cudaStream_t st, const unsigned* keys_in,
                        const unsigned* pay_in, int E, int shift,
                        unsigned top, const unsigned* bases,
                        unsigned* lookback, unsigned* counter,
                        unsigned* keys_out, unsigned* pay_out) {
  static unsigned long long ready = 0ull;  // devices with the attribute set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !((ready >> dev) & 1ull))) {
    err = cudaFuncSetAttribute(pass_kernel<MAP, PAY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pass_smem<PAY>());
    if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  }
  if (err != cudaSuccess) return err;
  pass_kernel<MAP, PAY><<<tiles, THREADS, pass_smem<PAY>(), st>>>(
      keys_in, pay_in, E, shift, top, bases, lookback, counter, keys_out,
      pay_out);
  return cudaGetLastError();
}

template <int MAP>
int run(const unsigned* keys_in, const unsigned* pay_in, int E, int key_bits,
        unsigned* keys_out, unsigned* pay_out, unsigned* keys_tmp,
        unsigned* pay_tmp, unsigned* lookback, unsigned* bases,
        unsigned* acc, cudaStream_t st) {
  const int passes = (key_bits + 7) / 8;
  const int tiles = (E + TILE - 1) / TILE;
  const unsigned top = key_bits >= 32 ? ~0u : (1u << key_bits) - 1u;
  // per pass: tiles x RADIX look-back words; then one tile counter a pass
  const size_t lb_words = (size_t)passes * tiles * RADIX;
  unsigned* counters = lookback + lb_words;
  const int hblocks =
      (int)min((long long)HIST_BLOCKS,
               ((long long)E + HIST_THREADS * 16 - 1) / (HIST_THREADS * 16));
  hist_kernel<MAP><<<hblocks, HIST_THREADS, 0, st>>>(
      keys_in, E, passes, top, acc, bases, reinterpret_cast<uint4*>(lookback),
      (long long)(lb_words + MAX_PASSES) / 4);
  cudaError_t err = cudaGetLastError();
  const unsigned* src_k = keys_in;
  const unsigned* src_p = pay_in;
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    unsigned* dst_k = to_out ? keys_out : keys_tmp;
    unsigned* dst_p = to_out ? pay_out : pay_tmp;
    unsigned* lb = lookback + (size_t)p * tiles * RADIX;
    err = pay_in ? launch_pass<MAP, true>(tiles, st, src_k, src_p, E, 8 * p,
                                          top, bases + p * RADIX, lb,
                                          counters + p, dst_k, dst_p)
                 : launch_pass<MAP, false>(tiles, st, src_k, nullptr, E,
                                           8 * p, top, bases + p * RADIX, lb,
                                           counters + p, dst_k, nullptr);
    src_k = dst_k;
    src_p = dst_p;
  }
  return static_cast<int>(err);
}

}  // namespace

// keys_in / pay_in: E words (pay_in null: a key-only sort, pay_out and
// pay_tmp ignored); keys_tmp / pay_tmp: E words each, 16-byte aligned;
// lookback: passes * ceil(E / 8192) * 256 + 4 words, 16-byte aligned; bases:
// passes * 256 words; acc: 4 * 256 + 1 words, zero before the call and zero
// again after it (keep one per stream). key_map: 0 u32, 1 f32, 2 signed,
// 3 ids. E < 2^30. The inputs are not modified.
extern "C" int hs_radix_sort(const int* keys_in, const int* pay_in, int E,
                             int key_bits, int key_map, int* keys_out,
                             int* pay_out, int* keys_tmp, int* pay_tmp,
                             void* lookback, void* bases, void* acc,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  if (E > (int)COUNT || key_bits < 1 || key_bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const int* p) { return reinterpret_cast<const unsigned*>(p); };
  auto w = [](int* p) { return reinterpret_cast<unsigned*>(p); };
  const auto args = [&](auto fn) {
    return fn(u(keys_in), u(pay_in), E, key_bits, w(keys_out), w(pay_out),
              w(keys_tmp), w(pay_tmp), static_cast<unsigned*>(lookback),
              static_cast<unsigned*>(bases), static_cast<unsigned*>(acc), st);
  };
  switch (key_map) {
    case MAP_U32: return args(run<MAP_U32>);
    case MAP_F32: return args(run<MAP_F32>);
    case MAP_SIGNED: return args(run<MAP_SIGNED>);
    case MAP_IDS: return args(run<MAP_IDS>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
