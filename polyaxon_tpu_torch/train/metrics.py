"""Throughput/MFU meter of the port — counterpart of
``polyaxon_tpu/train/metrics.py`` with its own accelerator table (the JAX
package's lives in ``schemas/tpu.py``)."""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Optional

#: dense bf16 tensor-core peak per accelerator, TFLOP/s (NVIDIA's data
#: sheet for the H100 SXM, without sparsity)
ACCELERATOR_SPECS = {
    "h100": {"bf16_tflops": 989.0},
}


def peak_tflops(accelerator: Optional[str] = "h100") -> Optional[float]:
    """The accelerator's peak, or None for one the table does not hold (a
    CPU run has no MFU)."""
    return ACCELERATOR_SPECS.get(accelerator or "", {}).get("bf16_tflops")


@dataclass
class ThroughputMeter:
    """Tracks step wall time -> tokens/sec/chip and model FLOPs utilization.

    ``flops_per_token`` comes from the model config
    (TransformerConfig.flops_per_token); MFU = achieved FLOPs / peak FLOPs.
    """

    tokens_per_step: int
    flops_per_token: float
    num_chips: int = 1
    accelerator: Optional[str] = "h100"
    _t0: Optional[float] = field(default=None, repr=False)
    steps: int = 0
    elapsed: float = 0.0
    # bounded per-step interval sample: p50/p95 next to the mean
    _intervals: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096), repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def step(self) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self.elapsed += now - self._t0
            self.steps += 1
            self._intervals.append(now - self._t0)
        self._t0 = now

    def _interval_quantile(self, q: float) -> float:
        if not self._intervals:
            return 0.0
        vs = sorted(self._intervals)
        return vs[min(int(round(q * (len(vs) - 1))), len(vs) - 1)]

    @property
    def tokens_per_sec(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.tokens_per_step * self.steps / self.elapsed

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / self.num_chips

    @property
    def achieved_tflops_per_chip(self) -> float:
        return self.tokens_per_sec_per_chip * self.flops_per_token / 1e12

    @property
    def mfu(self) -> Optional[float]:
        peak = peak_tflops(self.accelerator)
        return self.achieved_tflops_per_chip / peak if peak else None

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "step_time_ms": (self.elapsed / self.steps * 1e3) if self.steps else 0.0,
            "step_time_p50_ms": self._interval_quantile(0.50) * 1e3,
            "step_time_p95_ms": self._interval_quantile(0.95) * 1e3,
            "tokens_per_sec": self.tokens_per_sec,
            "tokens_per_sec_per_chip": self.tokens_per_sec_per_chip,
            "achieved_tflops_per_chip": self.achieved_tflops_per_chip,
            "mfu": self.mfu,
        }
