"""Port parity: every input stream of ``polyaxon_tpu_torch.train.data`` is
bit-identical to the JAX package's for the same ``(seed, i)`` — synthetic
LM, MLM and image batches and token files (``.npy``, uint16 ``.bin``,
uint32 ``.bin``) written under ``tmp_path`` — at batches 0, 1 and 7,
reached by ``skip`` and by ``seek``; and ``PrefetchedStream`` keeps its
order, re-raises a worker's error and survives a seek."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from polyaxon_tpu.train import data as jdata
from polyaxon_tpu_torch.train import data

INDICES = (0, 1, 7)


def _cfgs(**kw):
    return jdata.DataConfig(**kw), data.DataConfig(**kw)


def _assert_same(tb: dict, jb: dict):
    assert set(tb) == set(jb)
    for key in jb:
        ref = np.asarray(jb[key])
        got = tb[key].numpy()
        assert got.shape == ref.shape, key
        if key in ("images", "mask"):
            assert tb[key].dtype == torch.float32, key
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            assert tb[key].dtype == torch.int64, key
            np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=key)


def _check_stream(jcfg, tcfg):
    for index in INDICES:
        for move in ("skip", "seek"):
            jstream = jdata.make_batches(jcfg)
            tstream = data.make_batches(tcfg)
            jstream.seek(index)
            getattr(tstream, move)(index)
            _assert_same(next(tstream), next(jstream))
            assert tstream.position == index + 1
            close = getattr(tstream, "close", None)
            if close:
                close()


@pytest.mark.parametrize("kind,kw", [
    ("synthetic-lm", dict(batch_size=3, seq_len=16, vocab_size=500)),
    ("synthetic-mlm", dict(batch_size=4, seq_len=24, vocab_size=30522)),
    # a vocab under 104: the mask id is vocab - 1
    ("synthetic-mlm", dict(batch_size=4, seq_len=24, vocab_size=64)),
    ("synthetic-image", dict(batch_size=2, image_size=8, num_classes=10)),
])
def test_synthetic_streams_are_bit_identical(kind, kw):
    _check_stream(*_cfgs(kind=kind, seed=5, **kw))


def test_mlm_batches_select_and_mask_as_bert_does():
    _, tcfg = _cfgs(kind="synthetic-mlm", batch_size=16, seq_len=128, vocab_size=30522, seed=1)
    b = next(data.make_batches(tcfg))
    mask = b["mask"].bool()
    assert 0.12 < mask.float().mean() < 0.18
    assert torch.equal(b["inputs"][~mask], b["labels"][~mask])
    masked = (b["inputs"] == 103) & mask
    assert 0.7 < masked.sum() / mask.sum() < 0.9


def test_mlm_mask_tokens_draws_bert_s_80_10_10():
    from polyaxon_tpu_torch.models.bert import MASK_TOKEN_ID, mlm_mask_tokens

    tokens = torch.randint(0, 30522, (32, 512), generator=torch.Generator().manual_seed(0))
    inputs, labels, selected = mlm_mask_tokens(torch.Generator().manual_seed(1), tokens, 30522)
    assert torch.equal(labels, tokens) and 0.14 < selected.float().mean() < 0.16
    assert torch.equal(inputs[~selected], tokens[~selected])
    masked = (inputs[selected] == MASK_TOKEN_ID).float().mean()
    kept = (inputs[selected] == tokens[selected]).float().mean()
    assert 0.78 < masked < 0.82 and 0.08 < kept < 0.12


def _write_tokens(tmp_path, suffix: str, dtype, vocab: int):
    tokens = np.random.default_rng(0).integers(0, vocab, 5000).astype(dtype)
    path = tmp_path / f"tokens{suffix}"
    if suffix == ".npy":
        np.save(path, tokens)
    else:
        tokens.tofile(path)
    return str(path)


@pytest.mark.parametrize("suffix,dtype,vocab", [
    (".npy", np.uint16, 32000), (".bin", np.uint16, 32000), (".bin", np.uint32, 100000),
])
def test_token_file_streams_are_bit_identical(tmp_path, suffix, dtype, vocab):
    path = _write_tokens(tmp_path, suffix, dtype, vocab)
    jcfg, tcfg = _cfgs(kind="tokens-file", batch_size=4, seq_len=32, vocab_size=vocab,
                       path=path, seed=3)
    assert isinstance(data.make_batches(tcfg), data.PrefetchedStream)
    _check_stream(jcfg, tcfg)
    if dtype == np.uint32:  # ids past uint16 are read whole
        assert int(next(data.token_file_batches(tcfg))["inputs"].max()) >= 2 ** 16


def test_token_file_needs_a_path():
    with pytest.raises(ValueError, match="path"):
        data.token_file_batches(data.DataConfig(kind="tokens-file"))


class _Failing:
    """A batch function that fails at one index."""

    def __init__(self, at: int):
        self.at = at

    def __call__(self, i: int) -> dict:
        if i == self.at:
            raise RuntimeError(f"bad batch {i}")
        return {"i": torch.tensor(i)}


def _prefetch_workers() -> list:
    return [t for t in threading.enumerate() if t.name == "plx-prefetch" and t.is_alive()]


def test_prefetched_stream_keeps_order_and_survives_a_seek():
    stream = data.PrefetchedStream(data.BatchStream(lambda i: {"i": torch.tensor(i)}))
    assert [int(next(stream)["i"]) for _ in range(5)] == [0, 1, 2, 3, 4]
    stream.seek(2)
    assert [int(next(stream)["i"]) for _ in range(3)] == [2, 3, 4]
    stream.skip(10)
    assert stream.position == 15 and int(next(stream)["i"]) == 15
    stream.close()
    deadline = time.monotonic() + 5.0
    while _prefetch_workers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _prefetch_workers(), "a closed stream's worker is still running"


def test_prefetched_stream_reraises_the_worker_error():
    stream = data.PrefetchedStream(data.BatchStream(_Failing(at=3)))
    assert [int(next(stream)["i"]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="bad batch 3"):
        next(stream)
    stream.seek(4)  # a seek past the failure starts a new worker
    assert int(next(stream)["i"]) == 4
    stream.close()


def test_skip_batches_seeks_a_stream_and_drains_an_iterator():
    stream = data.make_batches(data.DataConfig(batch_size=1, seq_len=4, vocab_size=9))
    assert data.skip_batches(stream, 3).position == 3
    it = iter([1, 2, 3, 4])
    assert next(data.skip_batches(it, 2)) == 3


def test_unknown_data_kind_raises():
    with pytest.raises(ValueError, match="Unknown data kind"):
        data.make_batches(data.DataConfig(kind="tfrecords"))
