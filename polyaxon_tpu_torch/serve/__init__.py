"""Online inference of the port: paged KV cache, continuous batching and
HTTP serving, on PyTorch.

- :mod:`kv_cache` — the block pool (torch tensors on the engine's device)
  + free-list allocator + refcounted prefix index (host Python).
- :mod:`model`    — decode-mode transformer: chunked prefill and batched
  single-token decode over the paged cache.
- :mod:`engine`   — Orca-style iteration-level (continuous) batching.
- :mod:`server`   — the HTTP routes on the standard library's http.server.
- :mod:`runtime`  — engine construction from a spec and ``run_serve``.
"""

from .engine import (  # noqa: F401
    EngineDrainingError, EngineOverloadedError, GenRequest, SamplingParams,
    ServeEngine,
)
from .kv_cache import BlockAllocator, PagedKVCache  # noqa: F401
