"""PyTorch/CUDA port of the polyaxon_tpu runtime: serving and training.

A second package beside ``polyaxon_tpu`` (the JAX reference): the same
model zoo layouts, paged KV cache, continuous-batching engine and HTTP
routes, and the same builtin training runtime (trainer, AdamW, data,
remat policies), written in PyTorch for an NVIDIA H100. The TPU kernels on
these paths — paged decode attention and the flash-attention forward, dQ
and dK/dV — are hand-written CUDA kernels (``csrc/``) built with nvcc at
first use.

Layout mirrors the JAX package so each counterpart is found by name:
``models/`` (configs, params, init, training forward), ``ops/`` (layers,
attention, flash and paged attention), ``serve/`` (kv cache, decode model,
engine, server, runtime), ``train/`` (optimizers, data, tasks, meter,
watchdog, trainer), ``runtime/`` (the builtin training entry), ``obs/``
(metrics, the heartbeat's history buffer), ``tracking/`` (run events,
outputs, heartbeats and the API client a pod reports through),
``resilience/`` (the HTTP retry policy, trainer and serving fault
injection), ``parallel/`` (the ``PLX_*`` rendezvous into
``torch.distributed``, the process mesh, sharding rules and fsdp). This
package never imports JAX or ``polyaxon_tpu``.
"""
