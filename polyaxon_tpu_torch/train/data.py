"""Input pipelines of the port — counterpart of ``polyaxon_tpu/train/data.py``
for synthetic LM data.

Every source is a seekable :class:`BatchStream` whose batch ``i`` is a pure
function of ``(cfg.seed, i)``: one fresh ``np.random.default_rng((seed,
i))`` per batch, so ``skip``/``seek`` are O(1) cursor moves. numpy does the
drawing, so batch ``i`` is bit-identical to the JAX package's. Batches come
back as int64 CPU tensors; the trainer moves them to its device. The
tokens-file, MLM and image sources wait for ROADMAP A4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic-lm"      # synthetic-lm (the only kind ported)
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 32000
    seed: int = 0


class BatchStream:
    """Seekable batch iterator: ``__next__`` yields batch ``position`` and
    advances the cursor; ``skip``/``seek`` move the cursor in O(1)."""

    def __init__(self, make_batch: Callable[[int], dict], position: int = 0):
        self._make = make_batch
        self._pos = int(position)

    def __iter__(self) -> "BatchStream":
        return self

    def __next__(self) -> dict:
        batch = self._make(self._pos)
        self._pos += 1
        return batch

    @property
    def position(self) -> int:
        """Index of the NEXT batch this stream will yield."""
        return self._pos

    def skip(self, n: int) -> None:
        self._pos += int(n)

    def seek(self, position: int) -> None:
        self._pos = int(position)


def _rng_for(cfg: DataConfig, index: int) -> np.random.Generator:
    # one generator per (seed, batch index): the seekability contract
    return np.random.default_rng((cfg.seed, index))


def synthetic_lm_batches(cfg: DataConfig) -> BatchStream:
    """Endless {inputs, labels} batches (next-token objective)."""

    def make(i: int) -> dict:
        tok = _rng_for(cfg, i).integers(0, cfg.vocab_size,
                                        (cfg.batch_size, cfg.seq_len + 1), dtype=np.int32)
        tok = torch.from_numpy(tok.astype(np.int64))
        return {"inputs": tok[:, :-1], "labels": tok[:, 1:]}

    return BatchStream(make)


def make_batches(cfg: DataConfig) -> BatchStream:
    if cfg.kind == "synthetic-lm":
        return synthetic_lm_batches(cfg)
    raise ValueError(f"data kind {cfg.kind!r} is not ported; only synthetic-lm "
                     f"(ROADMAP A4)")
