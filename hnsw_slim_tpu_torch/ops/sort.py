"""Sorts and run scatters of the NN-descent build: kernels Kκ (``radix_sort``)
and Kμ (``run_scatter``), each beside its plain PyTorch version.

``kv_radix_sort`` is a stable key-payload sort (csrc/radix_sort.cu, one pass
per 8-bit digit of ``key_bits``); ``lexsort_stable`` sorts by two keys with
two of its passes; ``run_scatter`` ranks a sorted key array within its runs
and writes the first R of each run into rows, and ``dedup_pairs`` marks
repeated (key, value) pairs (both csrc/run_scatter.cu). CPU tensors take the
plain versions; CUDA tensors launch the kernels or raise. Nothing here reads
the card back.
"""

from __future__ import annotations

import torch

from . import cuda

TILE = 4096  # elements a block of radix_sort.cu takes
I32_MAX = 2**31 - 1


def f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving map of f32 keys that Kκ sorts float keys by, as
    int64 values of u32 words: -0.0 becomes +0.0, a negative key has all its
    bits flipped, a non-negative one its top bit set. Sorting by it equals
    torch.sort(stable=True) on the floats (which treats -0.0 and +0.0 as
    equal); +inf sorts after every finite key."""
    x = torch.where(x == 0, torch.zeros_like(x), x).contiguous()
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u | 2**31)


def kv_radix_sort_plain(keys, payload, key_bits: int = 32,
                        float_keys: bool = False):
    """Plain PyTorch Kκ: torch.sort(stable=True) of the keys (f32 with
    float_keys, else i32 words read as u32) and a gather of the payload."""
    if float_keys:
        sk, order = torch.sort(keys, stable=True)
        return sk, payload[order]
    _, order = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF, stable=True)
    return keys[order], payload[order]


def kv_radix_sort(keys, payload, key_bits: int = 32,
                  float_keys: bool = False):
    """Kκ (csrc/radix_sort.cu): stable ascending sort of keys i32[E] (words
    below 2^key_bits, read as u32) or, with float_keys, f32[E] (key_bits 32)
    carrying payload i32[E]. Returns new (keys, payload). CPU tensors run
    ``kv_radix_sort_plain``."""
    if not keys.is_cuda:
        return kv_radix_sort_plain(keys, payload, key_bits, float_keys)
    e = keys.shape[0]
    cuda.require(keys, torch.float32 if float_keys else torch.int32, "keys",
                 (e,))
    cuda.require(payload, torch.int32, "payload", (e,))
    if not 1 <= key_bits <= 32 or (float_keys and key_bits != 32):
        raise ValueError(f"radix_sort: key_bits={key_bits} "
                         f"(float_keys={float_keys})")
    if e > I32_MAX - TILE:
        raise ValueError(f"radix_sort: {e} keys")
    out_k, out_p = torch.empty_like(keys), torch.empty_like(payload)
    if e:
        dev = keys.device
        tmp_k, tmp_p = torch.empty_like(keys), torch.empty_like(payload)
        counts = torch.empty((256 * -(-e // TILE),), dtype=torch.int32,
                             device=dev)
        totals = torch.empty((256,), dtype=torch.int32, device=dev)
        cuda.launch("radix_sort", keys.data_ptr(), payload.data_ptr(), e,
                    key_bits, int(float_keys), out_k.data_ptr(),
                    out_p.data_ptr(), tmp_k.data_ptr(), tmp_p.data_ptr(),
                    counts.data_ptr(), totals.data_ptr())
    return out_k, out_p


def lexsort_stable(primary, secondary, key_bits: int):
    """Sort by (primary, secondary), ties in input order: a stable sort by
    the secondary key (f32, or ids below 2^key_bits), then a stable sort by
    the primary ids (below 2^key_bits) gathered through that permutation,
    carrying it. Returns (sorted primary, permutation)."""
    flt = secondary.dtype == torch.float32
    iota = torch.arange(primary.shape[0], dtype=torch.int32,
                        device=primary.device)
    _, o1 = kv_radix_sort(secondary, iota, 32 if flt else key_bits, flt)
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
