"""Multi-process rendezvous of the port — counterpart of
``polyaxon_tpu/parallel/distributed.py``: the same ``PLX_*`` env the
compiler injects into every pod of a distributed run, consumed by
``torch.distributed`` instead of ``jax.distributed``:

- ``PLX_COORDINATOR_ADDRESS``  — host:port of process 0
- ``PLX_NUM_PROCESSES``        — the number of processes
- ``PLX_PROCESS_ID``           — this process's index

Where the JAX module honours JAX's raw names, this one honours
``torchrun``'s: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``, so a hand-launched ``torchrun`` works as a hand-rolled JAX pod
does. One process drives one GPU (torch's idiom; the JAX package runs one
process per TPU host): its device index is ``LOCAL_RANK``, else the
process id modulo the visible GPUs.

``initialize()`` is idempotent and a no-op for one process. It joins an
NCCL group for a CUDA device and a gloo group for the CPU; a failed join
raises.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch

ENV_COORDINATOR = "PLX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "PLX_NUM_PROCESSES"
ENV_PROCESS_ID = "PLX_PROCESS_ID"
# torchrun's names, honoured when the PLX_* ones are absent
_FALLBACKS = {
    ENV_NUM_PROCESSES: "WORLD_SIZE",
    ENV_PROCESS_ID: "RANK",
}


@dataclass(frozen=True)
class ProcessInfo:
    process_id: int
    num_processes: int
    coordinator_address: Optional[str]

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def _env(name: str) -> Optional[str]:
    return os.environ.get(name) or os.environ.get(_FALLBACKS.get(name, ""), None) or None


def _coordinator() -> Optional[str]:
    addr = _env(ENV_COORDINATOR)
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def process_info_from_env() -> ProcessInfo:
    num = int(_env(ENV_NUM_PROCESSES) or 1)
    pid = int(_env(ENV_PROCESS_ID) or 0)
    return ProcessInfo(process_id=pid, num_processes=num, coordinator_address=_coordinator())


def local_rank(info: Optional[ProcessInfo] = None) -> int:
    """This process's GPU index: ``LOCAL_RANK`` when set, else the process
    id modulo the visible GPUs (0 without one)."""
    raw = os.environ.get("LOCAL_RANK")
    if raw:
        return int(raw)
    info = info or process_info_from_env()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return info.process_id % count if count else 0


def initialize(info: Optional[ProcessInfo] = None, *, device=None,
               timeout_s: float = 600.0) -> ProcessInfo:
    """Join the job's process group if the env says it is multi-process:
    NCCL when ``device`` is a CUDA device (bound to it), gloo otherwise.
    A no-op for one process and when a group already exists."""
    info = info or process_info_from_env()
    dist = torch.distributed
    if not info.is_distributed or dist.is_initialized():
        return info
    if not info.coordinator_address:
        raise RuntimeError(
            f"{ENV_NUM_PROCESSES}={info.num_processes} but no {ENV_COORDINATOR} set")
    device = torch.device(device) if device is not None else torch.device("cpu")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{info.coordinator_address}",
        world_size=info.num_processes, rank=info.process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return info


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def rendezvous_env(coordinator_host: str, port: int, num_processes: int,
                   process_id: int) -> dict[str, str]:
    """The env block the compiler injects into each process's pod."""
    return {
        ENV_COORDINATOR: f"{coordinator_host}:{port}",
        ENV_NUM_PROCESSES: str(num_processes),
        ENV_PROCESS_ID: str(process_id),
    }
