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
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

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


# -- the f32 kernels' split-TF32 arithmetic ----------------------------------------
#
# On the card the f32 kernels run each product A B on the tensor cores as
# A_hi B_lo + A_lo B_hi + A_hi B_hi, with hi = tf32(x) and lo = tf32(x - hi)
# rounded by cvt.rna.tf32.f32 (csrc/hopper.cuh). hi + lo misses x by up to
# one place of x, so every kernel's scores take Q in three parts (A_rest =
# A - A_hi - A_lo adds A_rest B_hi): in the backward P = exp(s scale - LSE)
# with the LSE from outside, and a score's error times |s scale| becomes
# P's relative error; in the forward two far keys whose scores nearly tie
# split a row's P by the difference of their scores' errors. The model
# below repeats that arithmetic in the plain versions' products, in the
# order they make them, so the JAX kernels can hold it here. It is held to the tolerance the card holds those kernels
# to against their f32 plain versions (FLASH_TOL in
# tests/test_torch_kernels_cuda.py and chip_smoke.py): 5e-5 + 5e-5 |ref|.
# The other models must fall outside it: a single tf32 pass (~2^-12
# relative per operand) everywhere, and two-part scores where they reach
# hundreds: key 0 at 2000 along one axis with a scale of +-1/8 (the cuda
# test of the scale's sign) in dV, keys 0 and 1 at 2000 along two axes
# that share the rows' P in dQ, and the same two keys at a near tie
# (q[..., 1] = q[..., 0] + 0.002 noise) in the forward's o.
#
# With one far key, where key 0 takes a row's whole P, dS = P (dO . v_0 -
# delta) scale cancels and dq[..., 0] = 2000 dS is the rounding of dO . v_0
# and delta times 250: there no two f32 orders of summation agree within
# SPLIT_TOL, the exact f32 plain version's dq neither with JAX's. Column 0
# of dq is held there against the plain version with f64 products instead,
# no further from it than the f32 plain version is; so are columns 0 and 1
# at the near tie, where the two far keys share such a cancellation. That column also holds
# dQ's dP = dO V^T to f32's accuracy. Each wgmma truncates its sum, and
# along one accumulator of D / 8 steps that bias passes f32's rounding; so
# the dQ kernel runs dO_hi V_hi^T in four chains, each from zero, added to
# nearest. The "kernel" model sums dQ's dP as the tensor cores do (_chains);
# "one_chain", with dO_hi V_hi^T in one accumulator, must fall further
# from the f64 products than f32 there, and so must two-part scores.
SPLIT_TOL = dict(atol=5e-5, rtol=5e-5)


def _tf32(x):
    """x rounded to tf32 on its bits, as cvt.rna.tf32.f32 does: to nearest,
    ties away from zero, on the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, a_parts=2):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    small = torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)
    if a_parts == 3:
        small = small + torch.matmul(a - a_hi - a_lo, b_hi)
    return small + torch.matmul(a_hi, b_hi)


def _rz(x):
    """f64 x to f32 rounded toward zero, as a tensor-core sum leaves it."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _chains(a, b, chains):
    """a b for tf32 a and b as wgmma sums it: in k8 steps, each adding its
    eight exact products to the accumulator and truncating, with the steps
    in ``chains`` runs, each from zero into an accumulator of its own, and
    the runs added to nearest."""
    d = a.shape[-1]
    out = 0.0
    for c in range(0, d, d // chains):
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for kk in range(c, c + d // chains, 8):
            acc = _rz(acc.double() + a[..., kk:kk + 8].double() @ b[..., kk:kk + 8, :].double())
        out = out + acc
    return out


#: products per pair of tiles in each plain version, scores first: the
#: forward makes S, P V; dK/dV makes S, dP, dV, dK; dQ makes S, dP, dQ
_PRODUCTS = {"fwd": 2, "dkv": 4, "dq": 3}


def _kernel_products(kernel, model):
    """``_matmul`` for the plain version of ``kernel`` ("fwd", "dkv" or
    "dq"): ``model`` "kernel" as the kernels compute, "two_part" with the
    scores from two parts of Q, "one_chain" with dQ's dO_hi
    V_hi^T in one accumulator, "single" one tf32 pass."""
    calls = itertools.count()

    def matmul(a, b):
        if model == "single":
            return torch.matmul(_tf32(a), _tf32(b))
        step = next(calls) % _PRODUCTS[kernel]
        if kernel == "dq" and step == 1 and model in ("kernel", "one_chain"):
            a_hi, b_hi = _tf32(a), _tf32(b)
            rest = torch.matmul(a_hi, _tf32(b - b_hi)) + torch.matmul(_tf32(a - a_hi), b_hi)
            return _chains(a_hi, b_hi, 4 if model == "kernel" else 1) + rest
        return _product(a, b, a_parts=3 if step == 0 and model != "two_part" else 2)
    return matmul


def _worst(out, ref):
    """The largest |out - ref| over SPLIT_TOL's atol + rtol |ref|."""
    return ((out - ref).abs() / (SPLIT_TOL["atol"] + SPLIT_TOL["rtol"] * ref.abs())).max().item()


@pytest.mark.parametrize("d,q_offset,causal,large,model", [
    (64, 0, True, 0, "kernel"), (64, 0, False, 0, "kernel"), (64, 40, True, 0, "kernel"),
    (128, 0, True, 0, "kernel"), (128, 0, False, 0, "kernel"), (128, 40, True, 0, "kernel"),
    (64, 0, True, 1, "kernel"), (128, 0, True, -1, "kernel"), (128, 0, False, 2, "kernel"),
    (64, 40, True, 0, "single"), (128, 0, False, 0, "single"),
    (64, 0, True, 1, "two_part"), (128, 0, False, 2, "two_part"),
    (128, 0, True, -1, "one_chain"),
    (64, 0, True, 3, "kernel"), (128, 0, True, 3, "kernel"),
    (64, 0, True, 3, "two_part"), (128, 0, True, 3, "two_part"),
])
def test_split_tf32_products_hold_the_f32_tolerance(monkeypatch, d, q_offset, causal, large,
                                                    model):
    bh, s, block = 2, 128, 64
    q, k, v, do, noise = _arrays(10 + d + q_offset, [(bh, s, d)] * 5, "float32")
    scale = d ** -0.5
    if large in (1, -1):  # scores of +-2000 q[i, 0] / 8 on key 0, exact in f32
        k[:, 0] = 0.0
        k[:, 0, 0] = 2000.0
        scale = 0.125 * large
    if large in (2, 3):  # keys 0 and 1 far out on two axes, with equal scores
        k[:, :2] = 0.0
        k[:, 0, 0] = k[:, 1, 1] = 2000.0
        q[..., 1] = q[..., 0]
        scale = 0.125
    if large == 3:  # ... or nearly equal ones
        q[..., 1] += 0.002 * noise[..., 0]
    kw = dict(sm_scale=scale, causal=causal, block_q=block, block_k=block)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o_j, lse_j = jfa._flash_fwd(jq, jk, jv, q_offset, 0, interpret=True, **kw)
    dq_j, dk_j, dv_j = jfa._flash_bwd(jq, jk, jv, o_j, lse_j, jdo, q_offset, 0, interpret=True,
                                      **kw)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    monkeypatch.setattr(fa, "_matmul", _kernel_products("fwd", model))
    o, lse = fa.flash_fwd_plain(tq, tk, tv, q_offset, 0, **kw)
    # the backward kernels take LSE and delta from outside (the reference's here)
    lse_ref, delta = fa.bwd_row_stats(torch.tensor(_np(o_j)), torch.tensor(_np(lse_j)), tdo)
    bwd_args = (tq, tk, tv, tdo, lse_ref, delta, q_offset, 0)
    monkeypatch.setattr(fa, "_matmul", _kernel_products("dkv", model))
    dk, dv = fa.flash_bwd_dkv_plain(*bwd_args, **kw)
    monkeypatch.setattr(fa, "_matmul", _kernel_products("dq", model))
    dq = fa.flash_bwd_dq_plain(*bwd_args, **kw)
    dq_j = torch.tensor(_np(dq_j))
    pairs = {"o": (o, o_j), "dq": (dq, dq_j), "dk": (dk, dk_j), "dv": (dv, dv_j)}
    col0 = None
    # the far keys' columns of dq against f64 products, the rest against JAX
    far = 2 if large == 3 and model == "kernel" else int(large in (1, -1))
    if far:
        monkeypatch.setattr(fa, "_matmul", torch.matmul)
        dq_f32 = fa.flash_bwd_dq_plain(*bwd_args, **kw)
        monkeypatch.setattr(fa, "_matmul", lambda a, b: (a.double() @ b.double()).float())
        dq_64 = fa.flash_bwd_dq_plain(*bwd_args, **kw)
        col0 = (_worst(dq[..., :far], dq_64[..., :far]),
                _worst(dq_f32[..., :far], dq_64[..., :far]))
        pairs["dq"] = (dq[..., far:], dq_j[..., far:])
    outside = {"kernel": (), "single": tuple(pairs), "one_chain": (),
               "two_part": {2: ("dq",), 3: ("o",)}.get(large, ("dv",))}[model]
    if model == "two_part":
        pairs = {name: pairs[name] for name in outside}
    for name, (out, ref) in pairs.items():
        if name in outside:
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(_np(out), _np(ref), err_msg=name, **SPLIT_TOL)
        elif model != "single":
            np.testing.assert_allclose(_np(out), _np(ref), err_msg=name, **SPLIT_TOL)
    if col0 is not None:  # the model's worst against f32's
        assert col0[0] <= col0[1] if model == "kernel" else col0[0] > col0[1], col0
    if model == "kernel":
        np.testing.assert_allclose(_np(lse), _np(lse_j), atol=1e-4, rtol=1e-5)


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
