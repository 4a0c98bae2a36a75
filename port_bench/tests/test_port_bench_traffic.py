"""The batch generators: the same seed gives the same batches, another
seed others, at the cell's shapes and with the objective's statistics."""

from __future__ import annotations

import torch

from port_bench.traffic import lm, mlm

CFG = {"vocab_size": 30522, "mask_token_id": 103}
MLM = {"batch_size": 16, "seq_len": 512, "mask_rate": 0.15, "mask_share": 0.8,
       "random_share": 0.1, "pool": 3}
LM = {"batch_size": 4, "seq_len": 1024, "pool": 3}
BIG = 2 ** 31 + 987654321


def _same(a: list, b: list) -> bool:
    return all(all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def test_mlm_pool_is_a_function_of_the_seed():
    a, b = mlm.make_pool(BIG, MLM, CFG), mlm.make_pool(BIG, MLM, CFG)
    assert _same(a, b)
    assert not _same(a, mlm.make_pool(BIG + 1, MLM, CFG))
    assert not torch.equal(a[0]["inputs"], a[1]["inputs"])


def test_mlm_masks_fifteen_percent_eighty_ten_ten():
    batch = mlm.make_pool(7, MLM, CFG)[0]
    sel = batch["mask"].bool()
    assert batch["inputs"].shape == (16, 512) and batch["inputs"].dtype == torch.int64
    assert abs(sel.float().mean().item() - 0.15) < 0.01
    masked = (batch["inputs"] == 103) & sel
    kept = (batch["inputs"] == batch["labels"]) & sel
    assert abs(masked.sum().item() / sel.sum().item() - 0.8) < 0.02
    assert abs(kept.sum().item() / sel.sum().item() - 0.1) < 0.02
    assert torch.equal(batch["inputs"][~sel], batch["labels"][~sel])
    assert mlm.loss_tokens(batch) == int(sel.sum())


def test_lm_pool_is_a_function_of_the_seed_and_shifts_labels():
    a, b = lm.make_pool(BIG, LM, CFG), lm.make_pool(BIG, LM, CFG)
    assert _same(a, b)
    assert not _same(a, lm.make_pool(BIG + 1, LM, CFG))
    batch = a[0]
    assert batch["inputs"].shape == batch["labels"].shape == (4, 1024)
    assert torch.equal(batch["inputs"][:, 1:], batch["labels"][:, :-1])
    assert lm.loss_tokens(batch) == 4 * 1024
