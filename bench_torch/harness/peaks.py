"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit), by the name
``torch.cuda.get_device_name()`` gives."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops_per_s": 67e12,
    },
}


def bound_s(device_name: str, flops: float, nbytes: float) -> float | None:
    """The least seconds the card could take for this work: the larger of
    fp32 operations over the fp32 rate and bytes over the memory rate. None
    for a card the table does not hold."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return max(flops / p["fp32_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
