"""Plain reference of the port's GPT-2 (``gpt2-345m``): a causal decoder
(``learned_pos.py``) trained on next-token prediction at every position, as
Radford et al. describe it (LayerNorm before each block and after the last,
learned positions, GELU, biases, the head tied to the token table). The
paper's scaled init of the residual projections is the benchmark's own
weights' (``layouts/learned_pos.py``), which both sides share.
"""

from __future__ import annotations

from port_bench.reference import core
from port_bench.reference.learned_pos import Model


def train(cfg: dict, runtime: dict, weights: dict, batches: list, **kwargs) -> dict:
    return core.train(cfg, runtime, weights, batches, model=Model(cfg, causal=True),
                      weight_key=None, **kwargs)
