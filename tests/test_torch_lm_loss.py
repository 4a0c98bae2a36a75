"""The fused LM loss (``ops/lm_loss.py``) on the CPU: the row kernel's
plain version under the same pad, chunk, gradient-in-forward and scale
logic as the kernel path, held against the recomputed path it replaced
(``transformer._recomputed_lm_loss``, the vocab-parallel path's code) and
the JAX package's ``lm_loss_from_hidden``.

Tolerances (f32 throughout) are those of the chunked-loss test in
``test_torch_train_model.py``: the grads 1e-6 absolute plus 1e-5 relative,
the loss 1e-6 absolute at that test's ~4 nats (a 40-way vocabulary), here
2.5e-7 relative, as a 1,001-way loss is ~7.6 nats (four f32 steps there);
the three sum the same terms in other orders.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import transformer as jtf
from polyaxon_tpu_torch.models import transformer

ll = importlib.import_module("polyaxon_tpu_torch.ops.lm_loss")

B, S, H = 2, 48, 16
CHUNKED = 24          # tokens a chunk: loss_chunks(2, 48, 24) == 4
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
LOSS_REL = 2.5e-7


def _inputs(vocab: int, vocab_major: bool, masked: bool, seed: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    shape = (vocab, H) if vocab_major else (H, vocab)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S))
    labels[0, :2] = (vocab - 1, 0)            # the first and the last real column
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    if masked:
        mask[0, :2] = 1.0
    return x, w, labels, mask


def _jax_loss_and_grads(x, w, labels, mask, vocab_major, chunk_tokens):
    def f(a, b):
        return jtf.lm_loss_from_hidden(a, b, jnp.asarray(labels),
                                       None if mask is None else jnp.asarray(mask),
                                       vocab_major=vocab_major, chunk_tokens=chunk_tokens)

    loss, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return float(loss), np.asarray(gx), np.asarray(gw)


def _port(fn, x, w, labels, mask, vocab_major, chunk_tokens, grad_out, w_grad=True):
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=w_grad)
    out = fn(tx, tw, torch.tensor(labels), None if mask is None else torch.tensor(mask),
             vocab_major=vocab_major, chunk_tokens=chunk_tokens)
    (out * grad_out).backward()
    return out.item(), tx.grad, tw.grad


@pytest.mark.parametrize("grad_out", [1.0, 0.375])
@pytest.mark.parametrize("chunk_tokens", [0, CHUNKED])
@pytest.mark.parametrize("vocab", [1001, 1024])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("vocab_major", [True, False])
def test_fused_loss_matches_the_recomputed_path_and_jax(vocab_major, masked, vocab,
                                                         chunk_tokens, grad_out):
    x, w, labels, mask = _inputs(vocab, vocab_major, masked)
    args = (x, w, labels, mask, vocab_major, chunk_tokens, grad_out)
    loss, gx, gw = _port(transformer.lm_loss_from_hidden, *args)
    old_loss, old_gx, old_gw = _port(transformer._recomputed_lm_loss, *args)
    ref_loss, ref_gx, ref_gw = _jax_loss_and_grads(x, w, labels, mask, vocab_major,
                                                   chunk_tokens)
    assert loss == pytest.approx(ref_loss, rel=LOSS_REL)
    assert loss == pytest.approx(old_loss, rel=LOSS_REL)
    assert gw.shape == w.shape
    np.testing.assert_allclose(gx.numpy(), grad_out * ref_gx, **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), grad_out * ref_gw, **GRAD_TOL)
    np.testing.assert_allclose(gx.numpy(), old_gx.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), old_gw.numpy(), **GRAD_TOL)


def test_a_frozen_head_gets_no_grad_and_x_still_does(monkeypatch):
    x, w, labels, mask = _inputs(1001, True, True)
    products = []
    real_matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda *a, **k: products.append(
        tuple(a[0].shape)) or real_matmul(*a, **k))
    loss, gx, gw = _port(transformer.lm_loss_from_hidden, x, w, labels, mask, True, CHUNKED,
                         1.0, w_grad=False)
    monkeypatch.undo()
    ref_loss, ref_gx, _ = _jax_loss_and_grads(x, w, labels, mask, True, CHUNKED)
    assert gw is None
    assert loss == pytest.approx(ref_loss, rel=LOSS_REL)
    np.testing.assert_allclose(gx.numpy(), ref_gx, **GRAD_TOL)
    # a chunk's logits and its dx, no dW product (whose left operand is
    # the logits transposed: [vp, rows])
    assert products == [(CHUNKED, H), (CHUNKED, 1024)] * 4


def test_no_grad_forms_no_gradient(monkeypatch):
    x, w, labels, mask = _inputs(1001, False, True)
    asked = []
    real = ll.lm_loss_rows

    def spy(*args, grad, **kw):
        asked.append(grad)
        return real(*args, grad=grad, **kw)

    monkeypatch.setattr(ll, "lm_loss_rows", spy)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    with torch.no_grad():
        out = transformer.lm_loss_from_hidden(tx, tw, torch.tensor(labels), torch.tensor(mask),
                                              chunk_tokens=CHUNKED)
    assert not out.requires_grad and out.grad_fn is None
    assert asked == [False] * 4
    ref_loss, _, _ = _jax_loss_and_grads(x, w, labels, mask, False, CHUNKED)
    assert out.item() == pytest.approx(ref_loss, rel=LOSS_REL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_columns_reach_neither_the_loss_nor_the_gradient(dtype):
    vocab, rows = 1001, 6
    vp = ll.padded_vocab(vocab)
    assert (vp, ll.padded_vocab(1024)) == (1024, 1024)
    gen = torch.Generator().manual_seed(0)
    real = (torch.randn(rows, vocab, generator=gen) * 3).to(dtype)
    labels = torch.tensor([vocab - 1, 0, 7, 500, 999, 3])
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.5, 1.0])
    scale = torch.tensor([0.25])

    def run(logits):
        out = torch.empty(rows)
        ll.lm_loss_rows(logits, labels, mask, scale, vocab, grad=True, out=out)
        return out, logits

    padded = torch.full((rows, vp), 1e4).to(dtype)     # garbage in the pad
    padded[:, :vocab] = real
    loss, grad = run(padded)
    ref_loss, ref_grad = run(real.clone())
    torch.testing.assert_close(loss, ref_loss, atol=0, rtol=0)
    torch.testing.assert_close(grad[:, :vocab], ref_grad, atol=0, rtol=0)
    assert not grad[:, vocab:].any()
    assert loss[2] == 0 and not grad[2].any()           # a row whose mask is 0
    z = real.float()
    want = mask * (torch.logsumexp(z, -1) - z.gather(-1, labels[:, None])[:, 0])
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-6)
    expect = (torch.softmax(z, -1) - torch.nn.functional.one_hot(labels, vocab)) \
        * (mask * scale)[:, None]
    torch.testing.assert_close(grad[:, :vocab].float(), expect.to(dtype).float(), atol=1e-6,
                               rtol=0 if dtype == torch.float32 else 2.0 ** -7)


def test_a_label_outside_the_vocabulary_gives_nan():
    logits = torch.randn(3, 128)
    out = torch.empty(3)
    ll.lm_loss_rows(logits, torch.tensor([0, 100, -1]), torch.tensor([1.0, 0.0, 1.0]),
                    torch.tensor([1.0]), 100, grad=True, out=out)
    assert out[0].isfinite() and out[1] == 0 and out[2].isnan()
    assert not logits[1].any()


@pytest.mark.parametrize("vocab_major", [True, False])
def test_the_returned_head_grad_has_the_vocabulary_rows(vocab_major):
    x, w, labels, _ = _inputs(1001, vocab_major, False)
    _, _, gw = _port(transformer.lm_loss_from_hidden, x, w, labels, None, vocab_major,
                     CHUNKED, 1.0)
    assert gw.shape == ((1001, H) if vocab_major else (H, 1001))


def test_the_row_kernel_counts_among_the_other_kernels():
    """The benchmark sorts device kernels by name: the row kernel is
    neither a GEMM nor flash attention."""
    from port_bench.kernels import classify

    name = ("void (anonymous namespace)::lm_loss_rows_kernel<__nv_bfloat16>"
            "((anonymous namespace)::Args)")
    assert classify(name) == "other"
