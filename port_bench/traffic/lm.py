"""Causal-LM batches, made from the seed.

A copy of the port's ``synthetic_lm_batches`` label shift
(``train/data.py``): ``seq_len + 1`` uniform tokens a row, the first
``seq_len`` as inputs and the last ``seq_len`` as labels. Batch ``i`` of a
pool comes from its own ``numpy.random.default_rng((seed, i))``.
"""

from __future__ import annotations

import numpy as np
import torch


def make_pool(seed: int, params: dict, cfg: dict) -> list[dict]:
    """``params["pool"]`` batches of ``params["batch_size"] x
    params["seq_len"]`` over the configuration's vocabulary."""
    rows, seq = int(params["batch_size"]), int(params["seq_len"])
    pool = []
    for i in range(int(params["pool"])):
        rng = np.random.default_rng((seed, i))
        tok = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (rows, seq + 1),
                                            dtype=np.int64))
        pool.append({"inputs": tok[:, :-1].contiguous(), "labels": tok[:, 1:].contiguous()})
    return pool


def loss_tokens(batch: dict) -> int:
    """Positions whose prediction the loss needs: every one."""
    return int(batch["labels"].numel())
