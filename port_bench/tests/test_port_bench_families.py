"""A family is files: its layout (``layouts/<family>.py``), its reference
(``reference/<family>.py`` over ``reference/core.py``'s loop) and its
counts. The two families of the benchmark's cells read as they did when
the layout, the size check and the forward were the harness's own (numbers
taken from that code at the same seed and written here); the Llama
family's layout is the port's at its presets; and a term over the whole
microbatch gives the same gradient at any block size."""

from __future__ import annotations

import hashlib
import math

import pytest
import torch

from port_bench import compare, guard, manifest, weights
from port_bench.reference import core
from port_bench.tests.tiny import REPO, TINY, tiny_config
from port_bench.traffic import lm, mlm

SEED = 2 ** 31 + 4242
W, BERT_OUT, GPT2_OUT = 0.02, 0.004082482904638631, 0.002886751345948129


def _frozen(h, L, n, m, V, P, out):
    """The learned-position layout as the harness's own table gave it, in
    sorted path order: (path, shape, scale, offset)."""
    d = h // n
    return [
        ("embed/pos", (P, h), W, 0.0), ("embed/tokens", (V, h), W, 0.0),
        ("final_norm/bias", (h,), W, 0.0), ("final_norm/scale", (h,), 0.1, 1.0),
        ("layers/attn/bk", (L, n, d), W, 0.0), ("layers/attn/bo", (L, h), W, 0.0),
        ("layers/attn/bq", (L, n, d), W, 0.0), ("layers/attn/bv", (L, n, d), W, 0.0),
        ("layers/attn/wk", (L, h, n, d), W, 0.0), ("layers/attn/wo", (L, n, d, h), out, 0.0),
        ("layers/attn/wq", (L, h, n, d), W, 0.0), ("layers/attn/wv", (L, h, n, d), W, 0.0),
        ("layers/attn_norm/bias", (L, h), W, 0.0), ("layers/attn_norm/scale", (L, h), 0.1, 1.0),
        ("layers/mlp/bi", (L, m), W, 0.0), ("layers/mlp/bo", (L, h), W, 0.0),
        ("layers/mlp/wi", (L, h, m), W, 0.0), ("layers/mlp/wo", (L, m, h), out, 0.0),
        ("layers/mlp_norm/bias", (L, h), W, 0.0), ("layers/mlp_norm/scale", (L, h), 0.1, 1.0),
    ]


LAYOUTS = {
    "bert-base.mlm-s512": _frozen(768, 12, 12, 3072, 30522, 512, BERT_OUT),
    "gpt2-345m.lm-s1024": _frozen(1024, 24, 16, 4096, 50257, 1024, GPT2_OUT),
}


@pytest.mark.parametrize("cell", sorted(LAYOUTS))
def test_the_cells_layouts_are_the_harness_tables(cell):
    found = manifest.resolve(cell)
    spec = weights.leaves(found.layout, found.config)
    assert [leaf[:4] for leaf in spec] == LAYOUTS[cell]
    assert weights.stacked(spec) == {leaf.path for leaf in spec
                                     if leaf.path.startswith("layers/")}


# sha256 of the weights' bytes in path order, and the reference's readings
# over three steps (each loss; the sums of the sliced norms of the first
# moment and of the change), at the tiny sizes, 8 x 64 in 2 microbatches,
# blocks of 2 rows, one thread
WEIGHTS_SHA256 = "2382551a0095502ac5dfe71732306fe5b9e5ea83cf800f60a6cdca20f9b4c4a4"
READINGS = {
    ("bert-base", "plain"): ([5.476037502288818, 5.526452004909515, 5.530859351158142],
                             0.31417763029929335, 0.00022259482466235284),
    ("bert-base", "quant"): ([5.476128458976746, 5.526828050613403, 5.53259539604187],
                             0.3136316383621998, 0.00022544580489206438),
    ("bert-base", "half"): ([5.426444053649902, 5.5186991691589355, 5.536446571350098],
                            0.3136766303587853, 0.00022901569393494868),
    ("gpt2-345m", "plain"): ([5.555963635444641, 5.56076180934906, 5.562764406204224],
                             0.1760528662469523, 0.006614346754710342),
    ("gpt2-345m", "quant"): ([5.555846691131592, 5.561105728149414, 5.56295382976532],
                             0.17691880206881946, 0.0066739794129079795),
    ("gpt2-345m", "half"): ([5.54881477355957, 5.556371450424194, 5.5794408321380615],
                            0.24209547666765668, 0.006546231660394052),
}
KWARGS = {"plain": {}, "quant": {"quant": True}, "half": {"keep_rows": 0.5}}
PARAMS = {"batch_size": 8, "seq_len": 64, "pool": 4, "mask_rate": 0.15, "mask_share": 0.8,
          "random_share": 0.1}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("like,side", sorted(READINGS))
def test_the_weights_and_the_reference_read_as_before(like, side, one_thread):
    cell = {"bert-base": "bert-base.mlm-s512", "gpt2-345m": "gpt2-345m.lm-s1024"}[like]
    found = manifest.resolve(cell)
    cfg = tiny_config(like.split("-")[0] + "-tiny", like)
    spec = weights.leaves(found.layout, cfg)
    first = weights.make(spec, SEED, "cpu")
    digest = hashlib.sha256()
    for path in sorted(first):
        digest.update(path.encode())
        digest.update(first[path].numpy().tobytes())
    assert digest.hexdigest() == WEIGHTS_SHA256
    pool = (mlm if like == "bert-base" else lm).make_pool(SEED, PARAMS, cfg)
    runtime = dict(cfg["runtime"], batch_size=8, seq_len=64, checkpoint=False, microbatches=2)
    out = found.reference.train(cfg, runtime, first, pool[:3], microbatches=2,
                                block_tokens=128, device="cpu", **KWARGS[side])
    stacked = weights.stacked(spec)
    grad, change = compare.slice_norms(out["mu"], stacked), \
        compare.slice_norms(out["change"], stacked)
    assert (out["loss"], math.fsum(grad.values()), math.fsum(change.values())) == \
        READINGS[(like, side)]


def test_slicing_cuts_the_layer_stacked_leaves_alone():
    for name, like in (("bert-tiny", "bert-base"), ("llama-tiny", None)):
        cfg = tiny_config(name, like)
        family = manifest._load(REPO / f"port_bench/layouts/{cfg['family']}.py", "layout")
        spec = weights.leaves(family, cfg)
        norms = compare.slice_norms(weights.make(spec, SEED, "cpu"), weights.stacked(spec))
        want = {f"{leaf.path}[{i}]" for leaf in spec if leaf.path.startswith("layers/")
                for i in range(TINY["num_hidden_layers"])}
        want |= {leaf.path for leaf in spec if not leaf.path.startswith("layers/")}
        assert set(norms) == want
    assert "lm_head/w" in norms and "embed/pos" not in norms


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-1b", "llama2-7b", "llama2-70b"])
def test_the_llama_layout_is_the_ports_at_its_presets(preset):
    """The configuration the family's ``stated`` gives for a preset lays
    out as the port's own parameter tree."""
    from polyaxon_tpu_torch.models.llama import CONFIGS
    from polyaxon_tpu_torch.models.transformer import abstract_params

    family = manifest._load(REPO / "port_bench/layouts/llama.py", "layout")
    cfg = family.stated(CONFIGS[preset])
    spec = weights.leaves(family, cfg)
    tree = weights.flat_paths(abstract_params(CONFIGS[preset]))
    assert {p: leaf[0] for p, leaf in tree.items()} == {leaf.path: leaf.shape for leaf in spec}
    assert weights.stacked(spec) == {p for p in tree if p.startswith("layers/")}


@pytest.mark.parametrize("kind", ["layouts", "reference", "counts"])
def test_the_llama_files_import_nothing_of_jax_or_the_program(kind):
    tops = guard.imported_tops(REPO / f"port_bench/{kind}/llama.py")
    assert not tops & (guard.FORBIDDEN | {guard.PROGRAM}), tops


# a term over the whole microbatch: the toy's loss is the mean cross
# entropy plus COEF x E x sum_e f_e P_e, f_e the share of the microbatch's
# tokens whose top router logit is e (no gradient), P_e the mean router
# probability of e over the microbatch
V, H, E, COEF = 32, 16, 4, 0.5
CFG = {"optimizer": {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0,
                     "grad_clip": 1e9, "min_lr_ratio": 0.1}}
RUNTIME = {"learning_rate": 1e-2, "steps": 10, "warmup_steps": 0}


class Toy:
    def __init__(self, f_per_block: bool = False):
        self.f_per_block = f_per_block     # the fault: f from the block alone

    @staticmethod
    def _f(p, inputs, mm):
        top = mm(p["embed"][inputs], p["router"]).argmax(-1)
        return torch.nn.functional.one_hot(top, E).float().mean(dim=(0, 1))

    def stats(self, p, inputs, weight, mm):
        return {"f": self._f(p, inputs, mm), "tokens": inputs.numel()}

    def block(self, p, inputs, labels, weight, mm, stats):
        x = p["embed"][inputs]
        logits = mm(x, p["head"])
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
        probs = torch.softmax(mm(x, p["router"]), -1)
        f = self._f(p, inputs, mm) if self.f_per_block else stats["f"]
        return nll.sum(), COEF * E * (f * probs.sum(dim=(0, 1))).sum() / stats["tokens"]


def _toy_inputs():
    gen = torch.Generator().manual_seed(11)
    first = {"embed": torch.randn(V, H, generator=gen), "head": torch.randn(H, V, generator=gen),
             "router": torch.randn(H, E, generator=gen)}
    batches = [{k: torch.randint(0, V, (16, 8), generator=gen) for k in ("inputs", "labels")}
               for _ in range(2)]
    return first, batches


def _whole_microbatch_grad(first, batch, k):
    """The step's gradient with each microbatch in one piece."""
    p = {name: w.clone().requires_grad_() for name, w in first.items()}
    loss, per = 0.0, batch["inputs"].shape[0] // k
    for j in range(k):
        take = {key: t[j * per:(j + 1) * per] for key, t in batch.items()}
        x = p["embed"][take["inputs"]]
        ce = torch.nn.functional.cross_entropy((x @ p["head"]).reshape(-1, V),
                                               take["labels"].reshape(-1))
        router = x @ p["router"]
        f = torch.nn.functional.one_hot(router.argmax(-1), E).float().mean(dim=(0, 1))
        balance = E * (f * torch.softmax(router, -1).mean(dim=(0, 1))).sum()
        loss = loss + (ce + COEF * balance) / k
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_a_microbatch_term_gives_the_same_gradient_at_any_block_size(rows):
    first, batches = _toy_inputs()
    out = core.train(CFG, RUNTIME, first, batches, model=Toy(), weight_key=None,
                     microbatches=2, block_tokens=rows * 8, device="cpu")
    whole = core.train(CFG, RUNTIME, first, batches, model=Toy(), weight_key=None,
                       microbatches=2, block_tokens=8 * 8, device="cpu")
    grad = _whole_microbatch_grad(first, batches[0], 2)
    for name in first:
        # Adam's first moment after one step is (1 - b1) g
        torch.testing.assert_close(out["mu"][name], 0.1 * grad[name], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(out["change"][name], whole["change"][name],
                                   rtol=1e-5, atol=1e-7)
    if rows < 8:
        # the share taken block by block is another gradient
        wrong = core.train(CFG, RUNTIME, first, batches, model=Toy(f_per_block=True),
                           weight_key=None, microbatches=2, block_tokens=rows * 8,
                           device="cpu")
        gap = (wrong["mu"]["router"] - out["mu"]["router"]).norm() / out["mu"]["router"].norm()
        assert gap > 1e-2
