"""Kα (``csrc/topk_dist.cu``) in estimate mode, as the seed scan of a SlimQ
search: the s lowest 1-bit RaBitQ estimates over every level >= 1 row for
each query of a batch.

Each input byte is read once and each output byte written once: the
rotated queries (B x P f32) and their sums (B f32); of each level >= 1
row, what a 1-bit estimate reads of its packed code row, the 1-bit plane
(P / 8 bytes), ``f_add``, ``f_rescale`` and the cluster id (4 bytes each:
28 B at P = 128); the per-query, per-centroid ``g_add`` table (B x C f32);
and the seeds out (B x s, an f32 estimate and an i32 position each). The
operations are the multiply-adds of the <query, code> products, 2 B n_up P.
``n_up`` is the real number of level >= 1 rows, not the padded table.
"""


def estimate_scan_work(batch: int, n_up: int, p: int, clusters: int,
                       seeds: int) -> tuple[float, float]:
    """(flops, bytes) of one estimate-mode seed scan."""
    flops = 2.0 * batch * n_up * p
    nbytes = (4.0 * batch * (p + 1) + n_up * (p / 8.0 + 12.0)
              + 4.0 * batch * clusters + 8.0 * batch * seeds)
    return flops, nbytes
