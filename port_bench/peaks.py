"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet for the H100 SXM,
dense rates without sparsity, at the full power limit of 700 W. A card that
is not here has no roofline or utilization: the readers then report
nothing."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)
