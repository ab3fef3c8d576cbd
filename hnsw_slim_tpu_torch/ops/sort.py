"""Sorts and run scatters of the NN-descent build and of the insert apply:
kernels Kκ (``radix_sort``) and Kμ (``run_scatter``), each beside its plain
PyTorch version.

``kv_radix_sort`` is a stable key-payload sort (csrc/radix_sort.cu: one
histogram launch, then one launch per 8-bit digit of ``key_bits``) under
one of four digit maps — u32 words, f32 keys, signed i32 keys, and node ids
with the 2^30 padding (the ``ids`` map that ``graph/revconn.py kv_sort``
takes); ``lexsort_stable`` sorts by two keys with two of its sorts;
``run_scatter`` ranks a sorted key array within its runs and writes the
first R of each run into rows, and ``dedup_pairs`` marks repeated (key,
value) pairs (both csrc/run_scatter.cu). CPU tensors take the plain
versions; CUDA tensors launch the kernels or raise. Nothing here reads the
card back.
"""

from __future__ import annotations

import torch

from . import cuda

TILE = 8192  # elements a block of radix_sort.cu's digit passes takes
MAX_KEYS = 2**30 - 1  # radix_sort.cu's look-back counts have 30 bits
I32_MAX = 2**31 - 1
KEY_MAPS = {"u32": 0, "f32": 1, "signed": 2, "ids": 3}  # radix_sort.cu
_ACC = {}  # (device, stream) -> radix_sort.cu's zero-kept digit accumulator


def f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving map of f32 keys that Kκ sorts float keys by, as
    int64 values of u32 words: -0.0 becomes +0.0, a negative key has all its
    bits flipped, a non-negative one its top bit set. Sorting by it equals
    torch.sort(stable=True) on the floats (which treats -0.0 and +0.0 as
    equal); +inf sorts after every finite key."""
    x = torch.where(x == 0, torch.zeros_like(x), x).contiguous()
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u | 2**31)


def signed_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Kκ's signed map of i32 keys, as int64 values of u32 words: the sign
    bit flipped (word ^ 2^31 read as u32 = word + 2^31). Sorting by it
    equals torch.sort(stable=True) on the i32 keys."""
    return x.to(torch.int64) + 2**31


def ids_sort_key(x: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Kκ's ids map, as int64 values of u32 words: min(word, 2^key_bits - 1).
    For node ids below n < 2^key_bits and the padding word 2^30 it orders as
    the i32 keys do, every padding word tied at the top."""
    return torch.clamp(x.to(torch.int64) & 0xFFFFFFFF, max=2**key_bits - 1)


def kv_radix_sort_plain(keys, payload=None, key_bits: int = 32,
                        key_map: str = "u32"):
    """Plain PyTorch Kκ: torch.sort(stable=True) of the keys under the digit
    map (f32 and signed keys as they are, i32 words read as u32, ids through
    ``ids_sort_key``) and a gather of the payload (None: keys only)."""
    if key_map not in KEY_MAPS:
        raise ValueError(f"radix_sort: key_map={key_map!r}")
    if key_map in ("f32", "signed"):
        sk, order = torch.sort(keys, stable=True)
    else:
        _, order = torch.sort(ids_sort_key(keys, key_bits) if key_map == "ids"
                              else keys.to(torch.int64) & 0xFFFFFFFF,
                              stable=True)
        sk = keys[order]
    return sk, None if payload is None else payload[order]


def _accumulator(dev: torch.device) -> torch.Tensor:
    """radix_sort.cu's digit accumulator for the current stream: zeroed once,
    and zero again after every sort's histogram launch."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _ACC:
        _ACC[key] = torch.zeros((4 * 256 + 4,), dtype=torch.int32, device=dev)
    return _ACC[key]


def kv_radix_sort(keys, payload=None, key_bits: int = 32,
                  key_map: str = "u32"):
    """Kκ (csrc/radix_sort.cu): stable ascending sort of keys[E] carrying
    payload i32[E] (None: keys only) under a digit map: ``u32`` i32 words
    below 2^key_bits read as u32, ``f32`` f32 keys, ``signed`` i32 keys,
    ``ids`` node ids below n < 2^key_bits with the 2^30 padding (counted as
    the ``radix_sort.ids`` mode). f32 and signed keys take key_bits 32.
    Returns new (keys, payload). CPU tensors run ``kv_radix_sort_plain``."""
    if not keys.is_cuda:
        return kv_radix_sort_plain(keys, payload, key_bits, key_map)
    e = keys.shape[0]
    cuda.require(keys, torch.float32 if key_map == "f32" else torch.int32,
                 "keys", (e,))
    if payload is not None:
        cuda.require(payload, torch.int32, "payload", (e,))
    if key_map not in KEY_MAPS or not 1 <= key_bits <= 32 or (
            key_map in ("f32", "signed") and key_bits != 32):
        raise ValueError(f"radix_sort: key_bits={key_bits} ({key_map})")
    if e > MAX_KEYS:
        raise ValueError(f"radix_sort: {e} keys (> 2^30 - 1)")
    out_k = torch.empty_like(keys)
    out_p = None if payload is None else torch.empty_like(payload)
    if e:
        dev = keys.device
        ev = -(-e // 4) * 4  # 16-byte aligned scratch segments
        n_buf = 1 if payload is None else 2
        passes = -(-key_bits // 8)
        lb = passes * -(-e // TILE) * 256 + 4
        scratch = torch.empty((n_buf * ev + lb + passes * 256,),
                              dtype=torch.int32, device=dev)
        base = scratch.data_ptr()
        cuda.launch("radix_sort", keys.data_ptr(),
                    None if payload is None else payload.data_ptr(), e,
                    key_bits, KEY_MAPS[key_map], out_k.data_ptr(),
                    None if payload is None else out_p.data_ptr(), base,
                    None if payload is None else base + 4 * ev,
                    base + 4 * n_buf * ev, base + 4 * (n_buf * ev + lb),
                    _accumulator(dev).data_ptr(),
                    modes=("ids",) if key_map == "ids" else ())
    return out_k, out_p


def lexsort_stable(primary, secondary, key_bits: int):
    """Sort by (primary, secondary), ties in input order: a stable sort by
    the secondary key (f32, or ids below 2^key_bits), then a stable sort by
    the primary ids (below 2^key_bits) gathered through that permutation,
    carrying it. Returns (sorted primary, permutation)."""
    flt = secondary.dtype == torch.float32
    iota = torch.arange(primary.shape[0], dtype=torch.int32,
                        device=primary.device)
    _, o1 = kv_radix_sort(secondary, iota, 32 if flt else key_bits,
                          "f32" if flt else "u32")
    return kv_radix_sort(torch.index_select(primary, 0, o1), o1, key_bits)


def sorted_run_rank(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values (keys sorted
    ascending)."""
    iota = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    start = torch.searchsorted(keys, keys, side="left").to(torch.int32)
    return iota - start


def run_scatter_plain(keys, payload, n: int, width: int,
                      n_valid: int = I32_MAX):
    """Plain PyTorch Kμ, scatter mode: sorted_run_rank and a masked
    scatter into a -1 filled i32[n, width]."""
    rank = sorted_run_rank(keys)
    keep = (rank < width) & (keys < n) & (payload < n_valid)
    rows = torch.full((n + 1, width), -1, dtype=torch.int32,
                      device=keys.device)
    rows[keys[keep].long(), rank[keep].long()] = payload[keep].to(torch.int32)
    return rows[:n]


def run_scatter(keys, payload, n: int, width: int, n_valid: int = I32_MAX):
    """Kμ (csrc/run_scatter.cu): keys i32[E] sorted ascending (values in
    [0, n], n = dropped) with payload i32[E]. Element i ranks within its run
    (every element of the run counts); it is kept when rank < width, key < n
    and payload < n_valid, and rows[key, rank] = payload. Returns rows
    i32[n, width], -1 elsewhere. CPU tensors run ``run_scatter_plain``."""
    if not keys.is_cuda:
        return run_scatter_plain(keys, payload, n, width, n_valid)
    e = keys.shape[0]
    cuda.require(keys, torch.int32, "keys", (e,))
    cuda.require(payload, torch.int32, "payload", (e,))
    rows = torch.full((n, width), -1, dtype=torch.int32, device=keys.device)
    if e and n and width:
        cuda.launch("run_scatter", keys.data_ptr(), payload.data_ptr(), e, n,
                    width, min(n_valid, I32_MAX), rows.data_ptr())
    return rows


def dedup_pairs_plain(keys, vals, n: int):
    """Plain PyTorch Kμ, dedup mode: n where (key, value) equals the pair
    before it, else key."""
    dup = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    dup[1:] = (keys[1:] == keys[:-1]) & (vals[1:] == vals[:-1])
    return torch.where(dup, n, keys).to(torch.int32)


def dedup_pairs(keys, vals, n: int):
    """Kμ's dedup mode (csrc/run_scatter.cu): keys, vals i32[E] sorted by
    (key, value); returns keys with every repeat of the pair before it
    replaced by n. CPU tensors run ``dedup_pairs_plain``."""
    if not keys.is_cuda:
        return dedup_pairs_plain(keys, vals, n)
    e = keys.shape[0]
    cuda.require(keys, torch.int32, "keys", (e,))
    cuda.require(vals, torch.int32, "vals", (e,))
    out = torch.empty_like(keys)
    if e:
        cuda.launch("run_scatter", keys.data_ptr(), vals.data_ptr(), e, n,
                    out.data_ptr(), entry="run_dedup", modes=("dedup",))
    return out
