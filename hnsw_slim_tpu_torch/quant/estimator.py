"""Distance estimation from RaBitQ codes (port of
hnsw_slim_tpu/quant/estimator.py), with the exact rotated query:

    est = f_add + g_add + f_rescale * (<q_rot, bits> - 1/2 * sum(q_rot))

and, over the 1-bit code and the ex planes together (total code =
(bin << ex_bits) + ex),

    est = f_add_ex + g_add + f_rescale_ex *
          (2^ex * <q, bin> + <q, ex> - (2^ex - 1/2) * sum(q_rot))

with g_add = ||q - centroid||^2 (L2) or -<q, centroid> (IP). Codes are u32
bit planes held as int32 tensors (bit j of word w is dimension 32 * w + j).

These functions are the plain PyTorch version of the estimate. On the card
the estimate is computed inside the search kernels from one packed row per
node (``QuantScorer``; csrc/common.cuh quant_score_rows, which gathers a
group of rows' words in ``gather_rounds`` rounds): the beam (Kβ), the
greedy descent with its entry point's estimate (Kε) and the seed scan (Kα),
never as a [B, W, P] unpack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cuda


def unpack_bits(codes: torch.Tensor) -> torch.Tensor:
    """u32 words as i32[..., W] -> f32[..., W * 32] of {0, 1}, little-endian
    bit order."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    bits = (codes[..., None] >> shifts) & 1
    return bits.reshape(*codes.shape[:-1], codes.shape[-1] * 32).float()


def bin_ip(q_rot: torch.Tensor, bin_code: torch.Tensor) -> torch.Tensor:
    """<q_rot, x_u> for per-query candidate codes: q_rot f32[B, P], bin_code
    i32[B, W, P/32] -> f32[B, W]."""
    return torch.einsum("bp,bwp->bw", q_rot, unpack_bits(bin_code))


def est_dist_1bit(q_rot, sumq, bin_code, f_add, f_rescale, g_add):
    """1-bit estimate f32[B, W]: q_rot f32[B, P], sumq f32[B], bin_code
    i32[B, W, P/32], f_add / f_rescale / g_add f32[B, W]."""
    ip = bin_ip(q_rot, bin_code)
    return f_add + g_add + f_rescale * (ip + -0.5 * sumq[:, None])


def est_dist_ex(q_rot, sumq, bin_code, ex_planes, f_add_ex, f_rescale_ex,
                g_add, ex_bits: int):
    """Full-code estimate f32[B, W]; ex_planes i32[B, W, ex_bits, P/32]."""
    ip_bin = bin_ip(q_rot, bin_code)
    ip_ex = torch.zeros_like(ip_bin)
    for b in range(ex_bits):
        ip_ex = ip_ex + (2.0 ** b) * bin_ip(q_rot, ex_planes[:, :, b])
    cb = -((1 << ex_bits) - 0.5)
    return f_add_ex + g_add + f_rescale_ex * (
        (2.0 ** ex_bits) * ip_bin + ip_ex + cb * sumq[:, None]
    )


def centroid_g_tables(q_rot, centroids_rot, metric: str = "l2"):
    """Per-(query, cluster) (g_add, g_error), f32[B, C] each."""
    diff = q_rot[:, None, :] - centroids_rot[None, :, :]
    sq = (diff * diff).sum(dim=-1)
    if metric == "ip":
        return -(q_rot @ centroids_rot.T), sq.sqrt()
    return sq, sq.sqrt()


def unpack_fields(rows: torch.Tensor, nb: int, ex_bits: int):
    """Packed rows i32[..., R] (index/slimq.pack_code_rows) -> (bin, ex,
    f_add, f_rescale, f_add_ex, f_rescale_ex, cluster_id) views; ex is
    i32[..., ex_bits, nb] or None."""
    off = nb + ex_bits * nb
    ex = rows[..., nb:off].reshape(*rows.shape[:-1], ex_bits, nb) \
        if ex_bits else None
    fl = rows[..., off:off + 4].contiguous().view(torch.float32)
    return (rows[..., :nb], ex, fl[..., 0], fl[..., 1], fl[..., 2],
            fl[..., 3], rows[..., off + 4])


# words of each code row that one gather round of the kernels' scorer takes
# (csrc/common.cuh QUANT_ROUND_WORDS)
ROUND_WORDS = 32


def gather_rounds(nb: int, ex_bits: int, use_ex: bool) -> int:
    """The gather rounds in which the kernels' scorer (csrc/common.cuh
    quant_score_rows) takes a packed code row: the words an estimate reads
    (the bin plane, or every plane with ``use_ex``, and the five words of
    factors and cluster id; the whole stride with ``use_ex``) over
    ``ROUND_WORDS`` a round."""
    words = nb * (1 + ex_bits if use_ex else 1) + 5
    return -(-words // ROUND_WORDS)


class QuantScorer(NamedTuple):
    """What a search kernel needs to score node ids by RaBitQ estimate (the
    port's form of JAX's quantized score closure): the packed code rows and
    the per-query terms."""

    rows: torch.Tensor  # i32[N, R] packed rows, R = nb * (1 + ex_bits) + 5
    nb: int  # words per bit plane (P / 32)
    ex_bits: int
    use_ex: bool  # estimate from the full code instead of the 1-bit code
    q_rot: torch.Tensor  # f32[B, P]
    sumq: torch.Tensor  # f32[B]
    g_add: torch.Tensor  # f32[B, C]

    def args(self) -> tuple:
        """The kernels' nine scorer arguments, validated."""
        b, p = self.q_rot.shape
        r = self.nb * (1 + self.ex_bits) + 5
        if p != 32 * self.nb:
            raise ValueError(f"q_rot has {p} dims, the codes {32 * self.nb}")
        cuda.require(self.rows, torch.int32, "packed rows", (-1, r))
        cuda.require(self.q_rot, torch.float32, "q_rot", (b, p))
        cuda.require(self.sumq, torch.float32, "sumq", (b,))
        cuda.require(self.g_add, torch.float32, "g_add", (b, -1))
        return (self.rows.data_ptr(), r, self.nb, self.ex_bits,
                int(self.use_ex), self.q_rot.data_ptr(), self.sumq.data_ptr(),
                self.g_add.data_ptr(), int(self.g_add.shape[1]))

    def counters(self) -> tuple:
        """The trace counters a kernel launch with this scorer counts:
        ``index.quant_one_round`` where its code rows arrive in one gather
        round (``gather_rounds``)."""
        one = gather_rounds(self.nb, self.ex_bits, self.use_ex) == 1
        return ("index.quant_one_round",) if one else ()


def packed_estimate_plain(sc: QuantScorer, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch estimate f32[B, W] of node ids i[B, W] (every id valid)
    from their packed rows: one row gather, a direct index into the query's
    g_add row, then the 1-bit or the full-code estimate."""
    rows = sc.rows[ids.long()]
    bc, ex, fa, fr, fae, fre, cid = unpack_fields(rows, sc.nb, sc.ex_bits)
    ga = torch.gather(sc.g_add, 1, cid.long())
    if sc.use_ex:
        return est_dist_ex(sc.q_rot, sc.sumq, bc, ex, fae, fre, ga, sc.ex_bits)
    return est_dist_1bit(sc.q_rot, sc.sumq, bc, fa, fr, ga)
