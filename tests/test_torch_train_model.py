"""Port parity: the training forward of ``polyaxon_tpu_torch.models``
(``apply``, ``LMTask.loss`` and its grads, the remat policies, the chunked
loss) against the JAX package on the CPU, llama-tiny, from the same
weights (``convert.params_from_jax``) and numpy-seeded tokens.

The flash cases force ``attn_impl="flash"`` at seq 128: the port then runs
its kernels' plain versions, JAX its Pallas kernels in interpret mode.

Tolerances (f32 throughout): the two frameworks sum the same products in
other orders; over two layers and a 256-way softmax that stays within
2e-5 on logits and loss. Grads: 1e-5 absolute plus 1e-4 relative, as the
smallest grads (norm scales) are sums of many cancelling terms. Remat
policies recompute the same ops on the same inputs: their values agree to
1e-6.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.models import transformer as jtf
from polyaxon_tpu.train.tasks import LMTask as JaxLMTask
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import llama, transformer
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.train.tasks import LMTask

fa = importlib.import_module("polyaxon_tpu_torch.ops.flash_attention")

SEQ = 128


def _cfgs(impl):
    return (replace(jllama.LLAMA_TINY, attn_impl=impl, attn_block_q=64, attn_block_k=32),
            replace(llama.LLAMA_TINY, attn_impl=impl, attn_block_q=64, attn_block_k=32))


@pytest.fixture(scope="module")
def weights():
    params = jtf.init(jax.random.PRNGKey(0), jllama.LLAMA_TINY)
    return jax.tree.map(np.asarray, params)


def _batch(b=2, s=SEQ, seed=0, vocab=256):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1), dtype=np.int32)
    return {"inputs": tok[:, :-1], "labels": tok[:, 1:]}


def _tbatch(batch):
    return {k: torch.tensor(v.astype(np.int64)) for k, v in batch.items()}


def _port_loss_and_grads(params_np, cfg, batch):
    params = params_from_jax(params_np, device="cpu")
    for _, leaf in flatten(params):
        leaf.requires_grad_()
    loss, _, _ = LMTask(cfg).loss(params, None, _tbatch(batch))
    loss.backward()
    return loss.item(), {path: leaf.grad for path, leaf in flatten(params)}


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax(weights, impl):
    jcfg, tcfg = _cfgs(impl)
    batch = _batch()
    ref = jtf.apply(jax.tree.map(jnp.asarray, weights), jnp.asarray(batch["inputs"]), jcfg,
                    interpret=True)
    out = transformer.apply(params_from_jax(weights, device="cpu"),
                            torch.tensor(batch["inputs"].astype(np.int64)), tcfg)
    assert out.dtype == torch.float32 and out.shape == (2, SEQ, 256)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_loss_and_every_grad_match_jax(weights, impl):
    jcfg, tcfg = _cfgs(impl)
    batch = _batch(seed=1)
    task = JaxLMTask(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: task.loss(p, None, jbatch, interpret=True)[:2], has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    loss, grads = _port_loss_and_grads(weights, tcfg, batch)
    assert loss == pytest.approx(float(jloss), abs=2e-5)
    jflat = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[path], atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))


@pytest.fixture(scope="module")
def remat_reference(weights):
    _, tcfg = _cfgs("flash")
    return _port_loss_and_grads(weights, replace(tcfg, remat="none"), _batch(seed=2))


@pytest.mark.parametrize("remat", ["full", "attn", "attn_qkv", "dots"])
def test_remat_policies_keep_values_and_rerun_the_forward(weights, remat_reference,
                                                          monkeypatch, remat):
    _, tcfg = _cfgs("flash")
    calls = []
    orig = fa.flash_fwd_plain
    monkeypatch.setattr(fa, "flash_fwd_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    loss, grads = _port_loss_and_grads(weights, replace(tcfg, remat=remat), _batch(seed=2))
    ref_loss, ref_grads = remat_reference
    assert loss == pytest.approx(ref_loss, abs=1e-6)
    for path, g in grads.items():
        torch.testing.assert_close(g, ref_grads[path], atol=1e-6, rtol=1e-6)
    # the flash forward runs once per layer, and once more in the backward
    # under every policy that drops its LSE
    assert len(calls) == 2 * tcfg.num_layers


def test_no_remat_runs_the_forward_once_per_layer(weights, monkeypatch):
    _, tcfg = _cfgs("flash")
    calls = []
    orig = fa.flash_fwd_plain
    monkeypatch.setattr(fa, "flash_fwd_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    _port_loss_and_grads(weights, tcfg, _batch(seed=2))
    assert len(calls) == tcfg.num_layers


def test_unknown_remat_policy_raises(weights):
    _, tcfg = _cfgs("dense")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _port_loss_and_grads(weights, replace(tcfg, remat="offload"), _batch())


@pytest.mark.parametrize("b,s,budget,expected", [
    (2, 12, 8, 3), (2, 12, 24, 1), (2, 12, 0, 1), (3, 7, 5, 7), (4, 64, 64, 4),
])
def test_chunk_count_rule(b, s, budget, expected):
    assert transformer.loss_chunks(b, s, budget) == expected


@pytest.mark.parametrize("chunk_tokens", [0, 64, 96])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_loss_matches_unchunked_and_jax(chunk_tokens, masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 48)).astype(np.int32)
    mask = (rng.random((2, 48)) < 0.7).astype(np.float32) if masked else None
    ref = jtf.lm_loss_from_hidden(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask),
                                  chunk_tokens=chunk_tokens)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tmask = None if mask is None else torch.tensor(mask)
    out = transformer.lm_loss_from_hidden(tx, tw, torch.tensor(labels.astype(np.int64)),
                                          tmask, chunk_tokens=chunk_tokens)
    assert out.item() == pytest.approx(float(ref), abs=1e-6)
    out.backward()
    whole = transformer.lm_loss_from_hidden(tx.detach().requires_grad_(), tw,
                                            torch.tensor(labels.astype(np.int64)), tmask,
                                            chunk_tokens=0)
    assert out.item() == pytest.approx(whole.item(), abs=1e-6)
    jgx, jgw = jax.grad(lambda a, b: jtf.lm_loss_from_hidden(
        a, b, jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
        chunk_tokens=chunk_tokens), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-6, rtol=1e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = np.array([[1, 1, 0, 1, 0], [0, 0, 0, 0, 1]], np.float32)
    for m in (None, mask):
        ref = jtf.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        out = transformer.cross_entropy_loss(torch.tensor(logits),
                                             torch.tensor(labels.astype(np.int64)),
                                             None if m is None else torch.tensor(m))
        assert out.item() == pytest.approx(float(ref), abs=1e-6)


def test_flops_per_token_and_params_match_jax():
    for name in ("llama-tiny", "llama-1b", "llama2-7b"):
        jcfg = {"llama-tiny": jllama.LLAMA_TINY, "llama-1b": jllama.LLAMA_1B,
                "llama2-7b": jllama.LLAMA2_7B}[name]
        tcfg = llama.CONFIGS[name]
        assert tcfg.active_params() == jcfg.active_params()
        assert tcfg.flops_per_token(2048) == jcfg.flops_per_token(2048)
        assert (tcfg.remat, tcfg.attn_impl) == (jcfg.remat, jcfg.attn_impl)
