"""``control.py``'s readings for a label-filtered configuration, with the
faults that a filtered search can have planted besides ``control.FAULTS``,
and the TF32 control scored as the cell scores answers:

- ``ef_half``: the search's ef cut to half the configuration's;
- ``predicate_ignored``: every query's need word replaced by 0, which every
  tag word holds: the search runs the tag mode, but with no filter;
- ``tf32`` (with every ``program`` seed): the plain reference's filtered
  top-k computed with TF32 products, in the system's place, checked against
  the fp32 reference (``dist_err``, ``recall_miss``, ``filter_miss``).

    python3 bench_torch/control_label.py --config sift1m-slim-label12 \
        --cells sift1m-slim-label12.batch --seeds 1,2,3 --bf16-seeds 4,5 \
        --faults ef_half,predicate_ignored --fault-seeds 7,8 --seconds 3 \
        --out chiprun_out/control_label.jsonl

The arguments and the output are ``control.py``'s.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import control  # noqa: E402
from harness import manifest  # noqa: E402


def predicate_ignored():
    """Plant the fault: ``HnswSlimIndex.search`` gets need words of 0 in
    place of the caller's. Returns the function that removes it."""
    import numpy as np

    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex

    plain = HnswSlimIndex.search

    def search(self, queries, k, filter_mask=None, entry=None, need=None):
        if need is not None:
            need = np.zeros(len(need), np.uint32)
        return plain(self, queries, k, filter_mask, entry, need)

    HnswSlimIndex.search = search

    def undo():
        HnswSlimIndex.search = plain
    return undo


def faults(cfg: dict) -> dict:
    """The label configuration ``cfg``'s faults."""
    return {"ef_half": {"search": {"ef": cfg["search"]["ef"] // 2}},
            "predicate_ignored": predicate_ignored}


def tf32_numbers(run) -> dict:
    """The control's reading: the reference's TF32 filtered top-k of every
    pool query, scored as the system's answers are."""
    import numpy as np

    ref, dev, k = run.reference, run.device, run.cfg["k"]
    pool_n = run.data.pool_n
    base = ref.to_device(run.data.base, dev)
    pool = ref.to_device(run.data.pool[:pool_n], dev)
    tags = ref.words(run.rec["tags"]).to(dev)
    need = ref.words(run.rec["need"]).to(dev)
    d, i = ref.filtered_topk(base, pool, tags, need, k, tf32=True)
    del base, pool
    sc = run.driver.score(run, np.arange(pool_n), i.cpu().numpy(),
                          d.cpu().numpy())
    return {"dist_err": sc["dist_err"],
            "recall_miss": control.check.recall_miss(sc["recall"]),
            "filter_miss": sc["filter_miss"]}


def main(argv) -> int:
    config = argv[argv.index("--config") + 1] if "--config" in argv else None
    if config is not None:
        control.FAULTS.update(faults(manifest.config(manifest.load(),
                                                     config)))
    control.tf32_numbers = tf32_numbers
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
