"""A plain RaBitQ reference: plain PyTorch, float32 unless given float64
tensors, TF32 off, importing nothing of the index packages.

It holds the rotation rebuilt from its flip bits, the 1-bit and ex-bit codes
of a residual to its centroid with their four factors, and the L2 distance
estimate. It follows RaBitQ (Gao & Long, SIGMOD 2024) and its extended-bit
form (Gao et al., SIGMOD 2025) as the rabitqlib library implements them:

- a vector o with centroid c has the residual r = o - c. Its 1-bit code is
  the sign of each rotated coordinate, x = bit - 1/2. Its B-bit code (1 sign
  bit, then B - 1 extra bits) is x = total - (2^(B-1) - 1/2), where total is
  the sign bit shifted up past the extra bits plus the extra-bit level;
- <r, q - c> is estimated as ||r||^2 <x, q - c> / <x, r>. So
  ||o - q||^2 ~= ||r||^2 + ||q - c||^2 - 2 ||r||^2 <x, q - c> / <x, r>.
  That is f_add + g_add + f_rescale <x, q>, with
  f_add = ||r||^2 + 2 ||r||^2 <x, c> / <x, r>,
  f_rescale = -2 ||r||^2 / <x, r> and g_add = ||q - c||^2.

Departures from the published description, each as the index does it:

- The rotation is structured: four rounds of a sign flip from the flip
  bits, then the Walsh-Hadamard transform (Sylvester order, scaled by
  1/sqrt(P)), over the rows zero-padded to P. P is the power of two at or
  above the dimension, and at least 64. The papers draw a dense random
  orthogonal matrix, and rabitqlib adds a Kac walk between halves for
  widths that are not a power of two; the padded width always is.
- The extra-bit level of a coordinate is floor(t |r_i| / ||r|| + 1e-5),
  capped at 2^(B-1) - 1, and mirrored (cap - level) where r_i < 0. One
  constant t serves every vector: rabitqlib's fast quantizer, not each
  vector's own best t. t is the mean of the best rescale factors of 100
  Gaussian directions drawn from numpy's ``default_rng(0)``, each found by
  the sweep over the points where a coordinate's level steps
  (``rescale_constant``, float64).
- The cluster ids are inputs, not recomputed from the centroids. A
  Lloyd's KMeans returns the assignment of its last step, which comes
  before its last centroid update.
- With no extra bits, the ex factors repeat the 1-bit ones, and the ex
  planes are empty.
- The error-bound factors are not computed: no search here reads them.

Code words are u32 bit planes held as int32: bit j of word w is dimension
32 w + j.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

LEVEL_EPS = 1e-5  # rabitqlib's kEps: a level just under an integer rounds up
TIGHT_START = (0.0, 0.15, 0.20, 0.52, 0.59, 0.71, 0.75, 0.77, 0.81)
SWEEP_PAST_TOP = 10  # rabitqlib's kNEnum: the sweep ends this far past the cap


def padded_dim(dim: int) -> int:
    """The power of two at or above ``dim``, at least 64."""
    p = 64
    while p < dim:
        p *= 2
    return p


def flip_signs(flip_bits, dim: int, device=None) -> torch.Tensor:
    """f32[4, P] of +-1: bit j of byte i of round r (little-endian) set
    means coordinate 8 i + j flips its sign in round r."""
    fb = torch.as_tensor(np.asarray(flip_bits, np.uint8).astype(np.int64),
                         device=device)
    bits = (fb[..., None] >> torch.arange(8, device=device)) & 1
    bits = bits.reshape(fb.shape[0], -1)[:, :padded_dim(dim)]
    return (1 - 2 * bits).to(torch.float32)


def hadamard(x: torch.Tensor) -> torch.Tensor:
    """The unnormalised Walsh-Hadamard transform of each row (Sylvester
    order), by butterflies of width 1, 2, 4, ..."""
    b, p = x.shape
    h = 1
    while h < p:
        y = x.reshape(b, p // (2 * h), 2, h)
        x = torch.stack((y[:, :, 0] + y[:, :, 1], y[:, :, 0] - y[:, :, 1]),
                        dim=2).reshape(b, p)
        h *= 2
    return x


def rotate(x: torch.Tensor, flip_bits) -> torch.Tensor:
    """[B, P] rotation of rows [B, D], in their dtype."""
    b, d = x.shape
    p = padded_dim(d)
    signs = flip_signs(flip_bits, d, x.device).to(x.dtype)
    scale = torch.tensor(1.0 / np.sqrt(p), dtype=torch.float32).to(x.dtype)
    y = torch.nn.functional.pad(x, (0, p - d))
    for r in range(4):
        y = hadamard(y * signs[r]) * scale
    return y


def unpack(words: torch.Tensor) -> torch.Tensor:
    """i32[..., W] words -> i64[..., 32 W] bits."""
    shifts = torch.arange(32, device=words.device)
    bits = (words.long()[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """bits [..., 32 W] -> i32[..., W] words."""
    lead, p = bits.shape[:-1], bits.shape[-1]
    shifts = torch.arange(32, device=bits.device)
    w = (bits.long().reshape(*lead, p // 32, 32) << shifts).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def best_rescale(o: torch.Tensor, ex_bits: int) -> float:
    """The t that maximises <y + 1/2, o> / ||y + 1/2|| for one direction's
    absolute coordinates ``o`` (f64[P], unit norm), where y is the level
    floor(t o + eps) of each coordinate, capped at 2^ex_bits - 1 as t grows.
    The sweep starts at TIGHT_START[ex_bits] of its end and looks at every
    point where a level steps; a level above the cap at the start stays."""
    top = (1 << ex_bits) - 1
    t_end = (top + SWEEP_PAST_TOP) / float(o.max())
    t_start = t_end * TIGHT_START[ex_bits]
    cur = (t_start * o + LEVEL_EPS).long()
    levels = torch.arange(1, top + 1, dtype=torch.float64)
    times = levels[None, :] / o[:, None]  # [P, top]: level l reached at l / o
    steps = (levels[None, :] > cur[:, None]) & (times < t_end)
    t_ev = times[steps]
    if t_ev.numel() == 0:
        return t_start
    t_ev = torch.sort(t_ev).values
    # the levels after each step: the start, plus every step at or before it
    passed = (steps[None] & (times[None] <= t_ev[:, None, None])).sum(-1)
    y = cur[None, :] + passed + 0.5
    ip = (y * o[None, :]).sum(1) / torch.sqrt((y * y).sum(1))
    return float(t_ev[int(torch.argmax(ip))])


@functools.lru_cache(maxsize=16)
def rescale_constant(p: int, ex_bits: int, samples: int = 100) -> float:
    """One rescale factor for every vector: the mean best factor of
    ``samples`` Gaussian directions from ``default_rng(0)``."""
    if ex_bits == 0:
        return 1.0
    x = np.random.default_rng(0).standard_normal((samples, p))
    o = torch.as_tensor(np.abs(x / np.linalg.norm(x, axis=1, keepdims=True)))
    return float(np.mean([best_rescale(row, ex_bits) for row in o]))


def rabitq_codes(x_rot: torch.Tensor, cent_rot: torch.Tensor, cluster_ids,
                 ex_bits: int) -> dict:
    """The codes of rotated rows ``x_rot`` [N, P] against their clusters'
    rotated centroids (``cent_rot`` [C, P], ``cluster_ids`` [N]), computed
    in the dtype of ``x_rot``: ``bin_code`` i32[N, P/32], ``ex_planes``
    i32[N, ex_bits, P/32] (plane b holds bit b of each level), and the f32
    factors ``f_add``, ``f_rescale``, ``f_add_ex``, ``f_rescale_ex``."""
    n, p = x_rot.shape
    c = cent_rot.to(x_rot.dtype)[torch.as_tensor(cluster_ids).long()
                                 .to(x_rot.device)]
    r = x_rot - c
    sign = r > 0
    l2_sqr = (r * r).sum(1)

    def factors(x):
        ip_r, ip_c = (r * x).sum(1), (c * x).sum(1)
        return (l2_sqr + 2 * l2_sqr * ip_c / ip_r, -2 * l2_sqr / ip_r)

    f_add, f_rescale = factors(sign.to(r.dtype) - 0.5)
    out = {"bin_code": pack(sign)}
    if ex_bits:
        top = (1 << ex_bits) - 1
        t = rescale_constant(p, ex_bits)
        o = r.abs() / torch.sqrt(l2_sqr)[:, None]
        level = torch.clamp((t * o + LEVEL_EPS).long(), max=top)
        level = torch.where(r < 0, top - level, level)
        total = level + (sign.long() << ex_bits)
        f_add_ex, f_rescale_ex = factors(total.to(r.dtype)
                                         - ((1 << ex_bits) - 0.5))
        out["ex_planes"] = torch.stack(
            [pack((level >> b) & 1) for b in range(ex_bits)], dim=1)
    else:
        f_add_ex, f_rescale_ex = f_add, f_rescale
        out["ex_planes"] = torch.zeros((n, 0, p // 32), dtype=torch.int32,
                                       device=x_rot.device)
    for name, v in (("f_add", f_add), ("f_rescale", f_rescale),
                    ("f_add_ex", f_add_ex), ("f_rescale_ex", f_rescale_ex)):
        out[name] = v.to(torch.float32)
    return out


def estimate_l2(q_rot: torch.Tensor, codes: dict, cent_rot: torch.Tensor,
                cluster_ids, use_ex: bool = False) -> torch.Tensor:
    """f32[B, N]: the estimated squared L2 distance of each rotated query to
    each coded row, f_add + ||q - c||^2 + f_rescale <x, q>, from the 1-bit
    code or (``use_ex``) the whole code."""
    with no_tf32():
        cid = torch.as_tensor(cluster_ids).long().to(q_rot.device)
        g = ((q_rot[:, None, :] - cent_rot[None, :, :]) ** 2).sum(-1)[:, cid]
        sign = unpack(codes["bin_code"]).to(q_rot.dtype)
        ex_bits = codes["ex_planes"].shape[1]
        if use_ex and ex_bits:
            level = sum(unpack(codes["ex_planes"][:, b]) << b
                        for b in range(ex_bits))
            x = (level + (unpack(codes["bin_code"]) << ex_bits)).to(
                q_rot.dtype) - ((1 << ex_bits) - 0.5)
            f_add, f_rescale = codes["f_add_ex"], codes["f_rescale_ex"]
        else:
            x = sign - 0.5
            f_add, f_rescale = codes["f_add"], codes["f_rescale"]
        return f_add[None, :] + g + f_rescale[None, :] * (q_rot @ x.T)


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in true float32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
