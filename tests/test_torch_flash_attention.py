"""Port parity: ``polyaxon_tpu_torch.ops.flash_attention`` and
``ops.attention`` against the JAX package on the CPU.

On a CPU tensor the port's flash path runs the plain versions of its CUDA
kernels (PyTorch tile loops with the TPU kernels' clamps, masking and
roundings); they are held here against the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them, on the same
numpy-seeded inputs. The CUDA kernels are held against the plain versions
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances. f32: the two walk the same blocks with the same f32 formulas
and differ only in the order of the sums inside each product: 1e-5 on O,
LSE and the grads (2e-5 relative on grads, which sum over every key).
bf16: both compute in f32 from the same bf16 inputs and round p, dS and
the outputs to bf16 at the same places; an f32 sum that lands on the other
side of a rounding boundary moves an output by one bf16 place (<= 2^-7
relative): atol 1e-2 and rtol 2^-7.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax_attention_mod = importlib.import_module("polyaxon_tpu.ops.attention")
jfa = importlib.import_module("polyaxon_tpu.ops.flash_attention")

fa = importlib.import_module("polyaxon_tpu_torch.ops.flash_attention")
ta = importlib.import_module("polyaxon_tpu_torch.ops.attention")

TOL = {"float32": dict(atol=1e-5, rtol=2e-5), "bfloat16": dict(atol=1e-2, rtol=2.0 ** -7)}


def _arrays(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(x, dtype):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def _torch(x, dtype):
    return torch.tensor(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, dtype, what=""):
    np.testing.assert_allclose(_np(out), _np(ref), err_msg=what, **TOL[dtype])


# (q_offset, k_offset, causal, block_q, block_k): offsets move the global
# diagonal; (0, 64) leaves the first 64 rows with no visible key
CASES = [
    (0, 0, True, 32, 32),
    (0, 0, True, 64, 32),
    (0, 0, False, 32, 64),
    (32, 0, True, 32, 64),
    (0, 64, True, 64, 32),
]


def _fwd_both(case, dtype, bh=2, s=128, d=16, seed=0):
    qo, ko, causal, bq, bk = case
    q, k, v = _arrays(seed, [(bh, s, d)] * 3, dtype)
    scale = d ** -0.5
    o_j, lse_j = jfa._flash_fwd(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), qo, ko,
                                sm_scale=scale, causal=causal, block_q=bq, block_k=bk,
                                interpret=True)
    o_t, lse_t = fa._flash_fwd(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), qo, ko,
                               sm_scale=scale, causal=causal, block_q=bq, block_k=bk)
    return (o_t, lse_t), (o_j, lse_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "qo{}-ko{}-{}-bq{}-bk{}".format(
    c[0], c[1], "causal" if c[2] else "full", c[3], c[4]))
def test_plain_forward_matches_pallas(case, dtype):
    (o_t, lse_t), (o_j, lse_j) = _fwd_both(case, dtype)
    assert o_t.dtype == getattr(torch, dtype) and lse_t.dtype == torch.float32
    _close(o_t, o_j, dtype, "o")
    lse_t, lse_j = _np(lse_t), _np(lse_j)
    np.testing.assert_array_equal(np.isinf(lse_t), np.isinf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], atol=1e-5, rtol=1e-6)
    if case[1] > case[0]:  # rows before k_offset see nothing
        hidden = case[1] - case[0]
        assert np.all(_np(o_t)[:, :hidden] == 0.0)
        assert np.all(np.isneginf(lse_t[:, :hidden]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES[1:], ids=lambda c: "qo{}-ko{}-{}-bq{}-bk{}".format(
    c[0], c[1], "causal" if c[2] else "full", c[3], c[4]))
def test_plain_backward_matches_pallas(case, dtype):
    qo, ko, causal, bq, bk = case
    bh, s, d = 2, 128, 16
    q, k, v, do = _arrays(1, [(bh, s, d)] * 4, dtype)
    scale = d ** -0.5
    jq, jk, jv, jdo = (_jax(x, dtype) for x in (q, k, v, do))
    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    # both backwards get the port's forward o and lse (the forward is held
    # to the Pallas one above), so only the backward differs
    o_t, lse_t = fa._flash_fwd(tq, tk, tv, qo, ko, sm_scale=scale, causal=causal,
                               block_q=bq, block_k=bk)
    o_j, lse_j = _jax(_np(o_t), dtype), jnp.asarray(lse_t.numpy())
    ref = jfa._flash_bwd(jq, jk, jv, o_j, lse_j, jdo, qo, ko, sm_scale=scale,
                         causal=causal, block_q=bk, block_k=bq, interpret=True)
    out = fa._flash_bwd(tq, tk, tv, o_t, lse_t, tdo, qo, ko, sm_scale=scale,
                        causal=causal, block_q=bk, block_k=bq)
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == getattr(torch, dtype)
        _close(a, b, dtype, name)


def test_backward_takes_hoisted_row_stats():
    qo, ko, causal, bq, bk = 32, 0, True, 32, 64
    q, k, v, do = (torch.tensor(x) for x in _arrays(2, [(2, 128, 16)] * 4, "float32"))
    o, lse = fa._flash_fwd(q, k, v, qo, ko, sm_scale=0.25, causal=causal, block_q=bq,
                           block_k=bk)
    stats = fa.bwd_row_stats(o, lse, do)
    j_stats = jfa.bwd_row_stats(jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()),
                                jnp.asarray(do.numpy()))
    np.testing.assert_allclose(stats[1].numpy(), _np(j_stats[1]), atol=1e-5, rtol=1e-6)
    kw = dict(sm_scale=0.25, causal=causal, block_q=bq, block_k=bk)
    hoisted = fa._flash_bwd(q, k, v, None, None, do, qo, ko, row_stats=stats, **kw)
    direct = fa._flash_bwd(q, k, v, o, lse, do, qo, ko, **kw)
    for a, b in zip(hoisted, direct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("blocks", [(32, 32, None, None), (64, 32, 32, 64)])
def test_autograd_grads_match_jax_grad(blocks):
    bq, bk, bqb, bkb = blocks
    q, k, v, w = _arrays(3, [(2, 128, 16)] * 4, "float32")
    kw = dict(causal=True, block_q=bq, block_k=bk, block_q_bwd=bqb, block_k_bwd=bkb)

    def jloss(q, k, v):
        return (jfa.flash_attention_bhsd(q, k, v, interpret=True, **kw) * w).sum()

    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fa.flash_attention_bhsd(*leaves, **kw)
    (o * torch.tensor(w)).sum().backward()
    for leaf, g in zip(leaves, j_grads):
        _close(leaf.grad, g, "float32")


def test_offsets_get_no_gradient_and_grads_keep_the_input_dtype():
    q, k, v = (torch.tensor(x).bfloat16().requires_grad_()
               for x in _arrays(4, [(1, 128, 16)] * 3, "bfloat16"))
    o = fa.flash_attention_bhsd(q, k, v, q_offset=64, k_offset=0, block_q=64, block_k=64)
    o.float().square().sum().backward()
    assert {t.grad.dtype for t in (q, k, v)} == {torch.bfloat16}


def test_return_lse_matches_the_forward():
    q, k, v = (torch.tensor(x) for x in _arrays(5, [(2, 128, 16)] * 3, "float32"))
    o, lse = fa.flash_attention_bhsd(q, k, v, block_q=64, block_k=64, return_lse=True)
    o2 = fa.flash_attention_bhsd(q, k, v, block_q=64, block_k=64)
    assert torch.equal(o, o2) and lse.shape == (2, 128)


# -- ops/attention.py ----------------------------------------------------------


def test_repeat_kv_repeats_each_head_in_place():
    k = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    out = ta.repeat_kv(torch.tensor(k), 6).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_attention_mod.repeat_kv(jnp.asarray(k), 6)))


@pytest.mark.parametrize("offsets", [(0, 0), (16, 0), (0, 48)])
def test_dense_attention_matches_jax(offsets):
    qo, ko = offsets
    q, k, v = _arrays(6, [(2, 4, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16)], "float32")
    ref = jax_attention_mod.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=True, q_offset=qo, k_offset=ko)
    out = ta.dense_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             causal=True, q_offset=qo, k_offset=ko)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    if ko > qo:
        assert np.all(out.numpy()[:, :, :ko - qo] == 0.0)  # zeros, not NaN


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_gqa_attention_and_grads_match_jax(impl):
    q, k, v, w = _arrays(7, [(2, 4, 128, 16), (2, 2, 128, 16), (2, 2, 128, 16),
                             (2, 4, 128, 16)], "float32")
    kw = dict(causal=True, impl=impl, block_q=64, block_k=32)

    def jloss(q, k, v):
        o = jax_attention_mod.attention(q, k, v, interpret=True, **kw)
        return (o * w).sum(), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = ta.attention(*leaves, **kw)
    (o * torch.tensor(w)).sum().backward()
    _close(o, o_j, "float32", "o")
    # dk/dv of the compact heads are sums over their group of query heads
    for leaf, g in zip(leaves, g_j):
        _close(leaf.grad, g, "float32")


def test_auto_falls_back_to_dense_on_nondividing_bwd_blocks(monkeypatch):
    # 256 % 96 != 0 in the backward only: 'auto' must take the dense path
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _arrays(8, [(1, 2, 256, 16)] * 3, "float32"))
    calls = []
    orig = fa.flash_fwd_plain
    monkeypatch.setattr(fa, "flash_fwd_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    out = ta.attention(q, k, v, impl="auto", block_q=128, block_k=128, block_q_bwd=96)
    out.square().sum().backward()
    assert not calls
    ta.attention(q, k, v, impl="auto", block_q=128, block_k=128)
    assert calls  # dividing blocks at s >= 128 take flash
    ref = ta.dense_attention(q.detach(), k.detach(), v.detach())
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)


def test_short_sequences_take_dense():
    q = torch.zeros(1, 2, 64, 16)
    out = ta.attention(q, q, q, impl="auto", block_q=32, block_k=32)
    assert torch.equal(out, ta.dense_attention(q, q, q))


def test_cuda_only_argument_check_raises_on_cpu_tensors():
    q = torch.zeros(2, 128, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_cuda(q, q, q, 0, 0, sm_scale=0.125, causal=True)
    lse = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dq_cuda(q, q, q, q, lse, lse, 0, 0, sm_scale=0.125, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dkv_cuda(q, q, q, q, lse, lse, 0, 0, sm_scale=0.125, causal=True)
