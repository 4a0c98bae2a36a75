"""Input pipelines of the port — counterpart of ``polyaxon_tpu/train/data.py``
on one host: synthetic LM, MLM and image batches and a tokenized corpus on
disk.

Every source is a seekable :class:`BatchStream` whose batch ``i`` is a pure
function of ``(cfg.seed, i)``: one fresh ``np.random.default_rng((seed,
i))`` per batch, so ``skip``/``seek`` are O(1) cursor moves. numpy does the
drawing in the JAX package's order, so batch ``i`` is bit-identical to the
JAX package's. Batches come back as CPU tensors (token ids and labels
int64, images NHWC float32, the MLM mask float32); the trainer moves them to
its device.

Over a mesh every rank draws the same global batch, as each JAX process
does, and keeps its rows (``cfg.rows``, from :func:`local_rows`) and,
under a ``context`` axis, its chunk of their sequence (``cfg.cols``, from
:func:`local_cols`): the JAX streams shard the token arrays as
``P(batch, "context")``. The token-file stream reads only those rows'
windows from disk.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic-lm"  # synthetic-lm | synthetic-mlm | synthetic-image | tokens-file
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 32000
    image_size: int = 224
    num_classes: int = 1000
    path: Optional[str] = None  # tokens-file: .npy, or .bin of uint16/uint32 by the vocab
    seed: int = 0
    # the rows of the global batch this rank keeps (None: all), in the
    # order the trainer splits its microbatches
    rows: Optional[tuple] = None
    # (start, stop) of the sequence this rank keeps of inputs, labels and
    # mask (None: all of it)
    cols: Optional[tuple] = None


def local_rows(batch_size: int, microbatches: int, index: int, count: int) -> tuple:
    """Rows of a global batch that rank ``index`` of ``count`` (its place
    over the batch axes) trains on, microbatch-major. JAX splits the
    global batch into ``microbatches`` slices of consecutive rows first and
    shards each slice over the ranks, so the rank's part of microbatch i is
    rows ``[i*B/k + index*m, i*B/k + (index+1)*m)`` with ``m = B/(k*count)``;
    the rank's microbatch i is then its i-th chunk of ``m`` rows."""
    k = max(int(microbatches), 1)
    if batch_size % k:
        raise ValueError(f"batch_size {batch_size} not divisible by microbatches {k}")
    per_micro = batch_size // k
    if per_micro % count:
        raise ValueError(f"a microbatch of {per_micro} rows does not split over {count} "
                         f"ranks (batch_size {batch_size}, microbatches {k})")
    m = per_micro // count
    return tuple(i * per_micro + index * m + j for i in range(k) for j in range(m))


def local_cols(batch_size: int, seq_len: int, index: int, count: int) -> Optional[tuple]:
    """(start, stop) of the sequence that context rank ``index`` of
    ``count`` keeps: its equal chunk (None for one rank). A sequence that
    does not cut into ``count`` chunks raises as JAX's sharding does."""
    if count == 1:
        return None
    if seq_len % count:
        raise ValueError(
            f"the sharding ('data', 'fsdp', 'expert'), 'context' implies that the global "
            f"size of its dimension 1 should be divisible by {count}, but it is equal to "
            f"{seq_len} (full shape: ({batch_size}, {seq_len}))")
    s = seq_len // count
    return (index * s, (index + 1) * s)


def _keep(cfg: DataConfig, arr: np.ndarray) -> np.ndarray:
    """This rank's rows of a global batch array."""
    return arr if cfg.rows is None else arr[np.asarray(cfg.rows)]


def _chunk(cfg: DataConfig, t: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of the sequence of a [rows, seq] token array."""
    return t if cfg.cols is None else t[:, cfg.cols[0]:cfg.cols[1]]


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

    def at(self, position: int) -> "BatchStream":
        """A NEW independent stream over the same batch function, cursor at
        ``position``: the prefetch wrapper hands each worker its own, so an
        abandoned worker can never advance a cursor its successor reads."""
        return BatchStream(self._make, position)


def _rng_for(cfg: DataConfig, index: int) -> np.random.Generator:
    # one generator per (seed, batch index): the seekability contract
    return np.random.default_rng((cfg.seed, index))


def _ids(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int64))


def synthetic_lm_batches(cfg: DataConfig) -> BatchStream:
    """Endless {inputs, labels} batches (next-token objective)."""

    def make(i: int) -> dict:
        tok = _ids(_keep(cfg, _rng_for(cfg, i).integers(
            0, cfg.vocab_size, (cfg.batch_size, cfg.seq_len + 1), dtype=np.int32)))
        return {"inputs": _chunk(cfg, tok[:, :-1]), "labels": _chunk(cfg, tok[:, 1:])}

    return BatchStream(make)


def synthetic_mlm_batches(cfg: DataConfig) -> BatchStream:
    """BERT-style {inputs, labels, mask} batches: 15% of positions
    selected, of them 80% [MASK], 10% a random token, 10% kept. The draws
    come in the JAX package's order: tokens, ``selected``, ``roll``, the
    random tokens."""
    from ..models.bert import MASK_TOKEN_ID

    mask_id = min(MASK_TOKEN_ID, cfg.vocab_size - 1)

    def make(i: int) -> dict:
        rng = _rng_for(cfg, i)
        tok = rng.integers(0, cfg.vocab_size, (cfg.batch_size, cfg.seq_len), dtype=np.int32)
        selected = rng.random(tok.shape) < 0.15
        roll = rng.random(tok.shape)
        inputs = np.where(selected & (roll < 0.8), mask_id, tok)
        rand = rng.integers(0, cfg.vocab_size, tok.shape, dtype=np.int32)
        inputs = np.where(selected & (roll >= 0.8) & (roll < 0.9), rand, inputs)
        return {"inputs": _chunk(cfg, _ids(_keep(cfg, inputs))),
                "labels": _chunk(cfg, _ids(_keep(cfg, tok))),
                "mask": _chunk(cfg, torch.from_numpy(_keep(cfg, selected).astype(np.float32)))}

    return BatchStream(make)


def synthetic_image_batches(cfg: DataConfig) -> BatchStream:
    """Endless {images [B, H, W, 3] float32 (NHWC), labels [B]} batches."""

    def make(i: int) -> dict:
        rng = _rng_for(cfg, i)
        images = rng.standard_normal(
            (cfg.batch_size, cfg.image_size, cfg.image_size, 3), dtype=np.float32)
        labels = rng.integers(0, cfg.num_classes, (cfg.batch_size,), dtype=np.int32)
        return {"images": torch.from_numpy(_keep(cfg, images)),
                "labels": _ids(_keep(cfg, labels))}

    return BatchStream(make)


def _window_gather(tokens: np.ndarray, starts: np.ndarray, seq_len: int) -> np.ndarray:
    """One vectorized gather of [len(starts), seq_len + 1] windows; on a
    memmap only the touched pages are read."""
    idx = starts[:, None] + np.arange(seq_len + 1, dtype=np.int64)[None, :]
    return np.asarray(tokens[idx], dtype=np.int32)


def token_file_batches(cfg: DataConfig) -> BatchStream:
    """Fixed-length windows from a flat token array on disk (memory-mapped):
    a ``.npy`` file, or a raw ``.bin`` whose dtype follows the vocab (uint16
    when it fits, else uint32)."""
    if not cfg.path:
        raise ValueError("tokens-file data needs `path`")
    if cfg.path.endswith(".npy"):
        tokens = np.load(cfg.path, mmap_mode="r")
    else:
        dtype = np.uint16 if cfg.vocab_size <= np.iinfo(np.uint16).max + 1 else np.uint32
        tokens = np.memmap(cfg.path, dtype=dtype, mode="r")
    n = len(tokens) - cfg.seq_len - 1

    def make(i: int) -> dict:
        # every rank draws every start; it reads only its rows' windows
        starts = _keep(cfg, _rng_for(cfg, i).integers(0, n, cfg.batch_size))
        window = _ids(_window_gather(tokens, starts, cfg.seq_len))
        return {"inputs": _chunk(cfg, window[:, :-1]), "labels": _chunk(cfg, window[:, 1:])}

    return BatchStream(make)


def prefetch(it: Iterator[dict], size: int = 2) -> Iterator[dict]:
    """Background prefetch: a daemon thread runs the producer (disk reads)
    ``size`` batches ahead of the consumer. A producer's exception re-raises
    at the consumer. Closing the generator stops the worker instead of
    leaving it parked on a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end, err = object(), object()
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            q.put((err, e))

    threading.Thread(target=worker, daemon=True, name="plx-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                raise item[1]
            yield item
    finally:
        stop.set()
        while True:  # drain, so that the worker's pending put returns
            try:
                q.get_nowait()
            except queue.Empty:
                break


class PrefetchedStream:
    """A :class:`BatchStream` behind :func:`prefetch` that stays seekable: a
    seek closes the current worker (its buffered batches are stale) and the
    next pull starts a new one from the new cursor, on a stream of its own
    (``inner.at``). The worker starts on the first pull, so a resume's skip
    before any pull starts none."""

    def __init__(self, inner: BatchStream, size: int = 2):
        self._inner = inner
        self._size = size
        self._it: Optional[Iterator[dict]] = None
        self._pos = inner.position

    def __iter__(self) -> "PrefetchedStream":
        return self

    def __next__(self) -> dict:
        if self._it is None:
            self._it = prefetch(self._inner.at(self._pos), size=self._size)
        batch = next(self._it)
        self._pos += 1
        return batch

    @property
    def position(self) -> int:
        return self._pos

    def skip(self, n: int) -> None:
        self.seek(self._pos + int(n))

    def seek(self, position: int) -> None:
        self.close()
        self._pos = int(position)

    def close(self) -> None:
        if self._it is not None:
            self._it.close()  # stops the worker; buffered batches dropped
            self._it = None


def skip_batches(batches, n: int):
    """Fast-forward past ``n`` batches: O(1) for a seekable stream, else by
    drawing and dropping them (a plain iterator)."""
    if n <= 0:
        return batches
    skip = getattr(batches, "skip", None)
    if callable(skip):
        skip(n)
    else:
        for _ in range(n):
            next(batches)
    return batches


def make_batches(cfg: DataConfig):
    if cfg.kind == "synthetic-lm":
        return synthetic_lm_batches(cfg)
    if cfg.kind == "synthetic-mlm":
        return synthetic_mlm_batches(cfg)
    if cfg.kind == "synthetic-image":
        return synthetic_image_batches(cfg)
    if cfg.kind == "tokens-file":
        return PrefetchedStream(token_file_batches(cfg))
    raise ValueError(f"Unknown data kind {cfg.kind!r}")
