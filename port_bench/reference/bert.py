"""Plain reference of the port's BERT (``bert-base``): a bidirectional
encoder (``learned_pos.py``, not causal) trained on the masked-LM loss,
which reads the selected positions alone (the batch's ``mask``).

It is the architecture the port states for its BERT, not Devlin et al.'s
in every part: LayerNorm before each block with a final LayerNorm (the paper
normalises after each residual), no token-type embeddings, no pooler or
next-sentence head, and an MLM head that is the tied token table alone (the
paper's transform layer and output bias are absent). Widths and depth are
the paper's.
"""

from __future__ import annotations

from port_bench.reference import core
from port_bench.reference.learned_pos import Model


def train(cfg: dict, runtime: dict, weights: dict, batches: list, **kwargs) -> dict:
    return core.train(cfg, runtime, weights, batches, model=Model(cfg, causal=False),
                      weight_key="mask", **kwargs)
