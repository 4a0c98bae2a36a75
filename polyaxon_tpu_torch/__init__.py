"""PyTorch/CUDA port of the polyaxon_tpu serving path.

A second package beside ``polyaxon_tpu`` (the JAX reference): the same
model zoo layouts, paged KV cache, continuous-batching engine and HTTP
routes, written in PyTorch for an NVIDIA H100. The one TPU kernel on the
serving path, paged decode attention, is a hand-written CUDA kernel
(``csrc/paged_decode.cu``) built with nvcc at first use.

Layout mirrors the JAX package so each counterpart is found by name:
``models/`` (configs, params, init), ``ops/`` (layers, paged attention),
``serve/`` (kv cache, decode model, engine, server, runtime), ``obs/``
(metrics). This package never imports JAX or ``polyaxon_tpu``.
"""
