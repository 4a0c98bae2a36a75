"""Masked-LM batches (BERT's 80/10/10 masking), made from the seed.

A copy of the port's ``synthetic_mlm_batches`` draw (``train/data.py``): of
the uniformly drawn tokens, ``mask_rate`` are selected; of those,
``mask_share`` become the mask token, ``random_share`` a random token, and
the rest stay. Batch ``i`` of a pool comes from its own
``numpy.random.default_rng((seed, i))``. The batch is the trainer's:
``{inputs, labels}`` int64 ``[batch_size, seq_len]`` and ``mask`` float32 (the
selected positions, which the loss counts).
"""

from __future__ import annotations

import numpy as np
import torch


def make_pool(seed: int, params: dict, cfg: dict) -> list[dict]:
    """``params["pool"]`` batches of ``params["batch_size"] x
    params["seq_len"]`` over the configuration's vocabulary."""
    vocab = cfg["vocab_size"]
    mask_id = min(int(cfg["mask_token_id"]), vocab - 1)
    rate, to_mask = float(params["mask_rate"]), float(params["mask_share"])
    to_random = float(params["random_share"])
    shape = (int(params["batch_size"]), int(params["seq_len"]))
    pool = []
    for i in range(int(params["pool"])):
        rng = np.random.default_rng((seed, i))
        tok = rng.integers(0, vocab, shape, dtype=np.int64)
        selected = rng.random(shape) < rate
        roll = rng.random(shape)
        rand = rng.integers(0, vocab, shape, dtype=np.int64)
        inputs = np.where(selected & (roll < to_mask), mask_id, tok)
        inputs = np.where(selected & (roll >= to_mask) & (roll < to_mask + to_random),
                          rand, inputs)
        pool.append({"inputs": torch.from_numpy(inputs), "labels": torch.from_numpy(tok),
                     "mask": torch.from_numpy(selected.astype(np.float32))})
    return pool


def loss_tokens(batch: dict) -> int:
    """Positions whose prediction the loss needs: the selected ones."""
    return int(batch["mask"].sum())
