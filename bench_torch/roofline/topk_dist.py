"""Kα (``csrc/topk_dist.cu``) as the seed scan of a Slim search: the exact
top-s of every level >= 1 row for each query of a batch.

Each input byte is read once and each output byte written once: the queries
(B x D f32), the rows and their norms (n_up x (D + 1) f32), and the seeds
out (B x s, an f32 distance and an i32 id each). The operations are the
multiply-adds of the distance products, 2 B n_up D. ``n_up`` is the real
number of level >= 1 rows, not the padded table.
"""


def seed_scan_work(batch: int, n_up: int, dim: int,
                   seeds: int) -> tuple[float, float]:
    """(flops, bytes) of one seed scan."""
    flops = 2.0 * batch * n_up * dim
    nbytes = 4.0 * batch * dim + 4.0 * n_up * (dim + 1) + 8.0 * batch * seeds
    return flops, nbytes
