"""``control.py``'s readings for a SlimQ configuration, with the faults
that SlimQ can have planted besides ``control.FAULTS``:

- ``ef_half``: the search's ef cut to half the configuration's;
- ``ex_zeroed``: the ex planes of the index's packed code rows zeroed
  after the build. The whole-code beam then ranks by wrong estimates, but
  the rerank keeps every answered distance exact: the check of the codes
  sees it on every row.

    python3 bench_torch/control_slimq.py --config sift1m-slimq \
        --cells sift1m-slimq.batch --seeds 1,2,3 --bf16-seeds 4,5 \
        --faults ef_half,stop1,ex_zeroed --fault-seeds 7,8 --seconds 3 \
        --out chiprun_out/control_slimq.jsonl

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


def ex_zeroed():
    """Plant the fault: the packed code rows the index builds at its first
    search (and keeps) come with their ex planes zeroed. Returns the
    function that removes it."""
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex

    plain = HnswSlimQIndex._packed_rows

    def packed_rows(self):
        if self._packed is None:
            rows = plain(self).clone()
            nb = int(self.codes.bin_code.shape[1])
            rows[:, nb:nb * (1 + self.codes.ex_bits)] = 0
            self._packed = rows
        return self._packed

    HnswSlimQIndex._packed_rows = packed_rows

    def undo():
        HnswSlimQIndex._packed_rows = plain
    return undo


def faults(cfg: dict) -> dict:
    """SlimQ's faults for the configuration ``cfg``."""
    return {"ef_half": {"search": {"ef": cfg["search"]["ef"] // 2}},
            "ex_zeroed": ex_zeroed}


def main(argv) -> int:
    config = argv[argv.index("--config") + 1] if "--config" in argv else None
    if config is not None:
        control.FAULTS.update(faults(manifest.config(manifest.load(),
                                                     config)))
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
