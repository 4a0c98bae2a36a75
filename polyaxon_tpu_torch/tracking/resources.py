"""Host and GPU resource logger of the port — its own copy of
``polyaxon_tpu/tracking/resources.py``, with :func:`sample_gpu` (device
memory from ``torch.cuda``) in place of the TPU's HBM stats."""

from __future__ import annotations

import threading
from typing import Optional

from .run import Run


def sample_host() -> dict:
    """Host CPU and memory through psutil; nothing where psutil is absent
    (the GPU's samples go on without it)."""
    try:
        import psutil
    except ImportError:
        return {}
    vm = psutil.virtual_memory()
    return {
        "host_cpu_percent": psutil.cpu_percent(interval=None),
        "host_mem_percent": vm.percent,
        "host_mem_used_gib": vm.used / 2**30,
    }


def sample_gpu() -> dict:
    """Each CUDA device's allocated and peak allocated memory in GiB, as
    PyTorch's caching allocator counts it; ``{}`` without a CUDA device."""
    import torch

    out: dict = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"gpu{i}_mem_gib"] = torch.cuda.memory_allocated(i) / 2**30
        out[f"gpu{i}_mem_peak_gib"] = torch.cuda.max_memory_allocated(i) / 2**30
    return out


class ResourceLogger:
    """Background thread logging host + GPU resource metrics every
    ``interval`` seconds to the run's event files."""

    def __init__(self, run: Run, interval: float = 10.0, gpu: bool = True):
        self.run = run
        self.interval = interval
        self.gpu = gpu
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ResourceLogger":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="plx-resources")
        self._thread.start()
        return self

    def sample(self) -> dict:
        metrics = sample_host()
        if self.gpu:
            metrics.update(sample_gpu())
        return metrics

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                metrics = self.sample()
                if metrics:
                    self.run.log_metrics(**metrics)
            except Exception:  # noqa: BLE001 — telemetry must never kill a run
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
