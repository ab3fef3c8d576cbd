"""``closed_batch``'s loop over a SlimQ index: the same load and the same
queries as the Slim cell, and a check of the codes the index holds.

End to end and compared as in ``closed_batch``. Compared besides, over a
seeded sample of ``SAMPLE`` stored rows (``collect`` reads them before the
index is freed):

- ``code_miss``: the share of sampled rows whose packed code words (1-bit
  plane, ex planes, cluster id) differ from the plain reference's codes of
  the same raw rows, under the index's own rotation (its flip bits), rotated
  centroids and cluster assignment;
- ``factor_err``: the largest gap between the index's four factors and the
  reference's, each over the largest magnitude of that factor in the sample
  (an additive factor can cancel to near zero in one row, where a ratio row
  by row would measure the cancellation); inf where a factor is not finite.

The reference rotates the raw rows in float32, as the index does, then
quantizes in float64, the precision of the index's host quantizer (the
configuration's ``precision``), so the codes must be equal word for word
and the factors equal after their float32 rounding. Quantized in float32, a
level within rounding of a step flips in about one row in 4096, and the ex
factors of that row move by ~1e-3.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from drivers import closed_batch
from drivers.closed_batch import checked, setup, window  # noqa: F401

SYSTEM = "slimq_index"
SAMPLE = 4096
FACTORS = ("f_add", "f_rescale", "f_add_ex", "f_rescale_ex")


def collect(run) -> None:
    idx = run.system.index
    n = run.info["n"]
    rows = np.sort(np.random.default_rng([run.seed, 1]).choice(
        n, min(SAMPLE, n), replace=False))
    sel = torch.as_tensor(rows, device=idx.cluster_ids.device)
    run.rec["codes"] = {
        "rows": rows,
        "packed": idx._packed_rows()[sel].cpu().numpy(),
        "cluster_ids": idx.cluster_ids[sel].cpu().numpy(),
        "centroids_rot": idx.centroids_rot.cpu().numpy(),
        "flip_bits": np.asarray(idx.rotator.flip_bits),
        "words": int(idx.codes.bin_code.shape[1]),
        "ex_bits": int(idx.codes.ex_bits)}


def code_numbers(run) -> dict:
    """``code_miss`` and ``factor_err`` of the rows ``collect`` read."""
    ref, c = run.reference, run.rec.pop("codes")
    nb, ex = c["words"], c["ex_bits"]
    off = nb * (1 + ex)
    packed = ref.to_device(c["packed"], run.device)
    if packed.shape[1] != off + 5:
        return {"code_miss": math.inf, "factor_err": math.inf}
    raw = ref.to_device(run.data.base[c["rows"]], run.device)
    cent = ref.to_device(c["centroids_rot"], run.device)
    want = ref.rabitq_codes(ref.rotate(raw, c["flip_bits"]).double(), cent,
                            c["cluster_ids"], ex)
    cid = ref.to_device(c["cluster_ids"], run.device)
    same = ((packed[:, :nb] == want["bin_code"]).all(1)
            & (packed[:, nb:off]
               == want["ex_planes"].reshape(len(packed), -1)).all(1)
            & (packed[:, off + 4] == cid))
    got = packed[:, off:off + 4].contiguous().view(torch.float32)
    err = 0.0
    for j, name in enumerate(FACTORS):
        scale = float(want[name].abs().max())
        gap = float((got[:, j] - want[name]).abs().max())
        err = max(err, gap / scale if scale > 0 else math.inf)
    if math.isnan(err):
        err = math.inf
    out = {"code_miss": 1.0 - float(same.double().mean()), "factor_err": err}
    run.say(f"codes checked: {len(packed)} rows; code_miss "
            f"{out['code_miss']}; factor_err {out['factor_err']}")
    return out


def evaluate(run):
    e2e, numbers = closed_batch.evaluate(run)
    numbers.update(code_numbers(run))
    return e2e, numbers
