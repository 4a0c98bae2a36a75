"""The port's ring attention (``polyaxon_tpu_torch/ops/ring_attention.py``)
against the JAX package's, in one process.

The port's ring runs over a :class:`LoopbackRing` (every position of the
ring in this process, the chunks rotated in memory) with the kernels'
plain versions on the CPU; the JAX ring runs under ``shard_map`` on the
8-device CPU mesh with the Pallas kernels in interpret mode, as
``tests/test_ops_attention.py``'s ring tests run it. The inputs are the
same numpy draws on both sides, and the cases mirror that file's: causal
and non-causal outputs at cp 8, grads, compact GQA kv against kv expanded
up front, and the visits the causal skip leaves.

Tolerances, ``tests/test_ops_attention.py``'s for a ring against dense
attention: outputs 2e-5 absolute and relative, grads 5e-5 absolute and
5e-4 relative (f32 on both sides, merged over the chunks in the same
order). A planted fault, one visit's ``k_offset + 1`` (rank 0's diagonal
visit: the causal mask moves by one key where rows see fewest keys), must
miss them.
"""

from __future__ import annotations

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.ops import repeat_kv as jrepeat_kv
from polyaxon_tpu.ops import ring_attention as jring_attention
from polyaxon_tpu.parallel import build_mesh
from polyaxon_tpu.parallel.compat import shard_map
from polyaxon_tpu_torch.ops.attention import dense_attention, repeat_kv
from polyaxon_tpu_torch.ops.ring_attention import LoopbackRing, ring_attention

ring_mod = importlib.import_module("polyaxon_tpu_torch.ops.ring_attention")

CP = 8
OUT_TOL = (2e-5, 2e-5)     # atol, rtol
GRAD_TOL = (5e-5, 5e-4)
SPEC = P(None, None, "context", None)


@pytest.fixture(scope="module")
def mesh():
    return build_mesh({"context": CP})


def _qkv(seed: int, b: int, h: int, s: int, d: int, kv_heads=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, d), (b, kv_heads or h, s, d), (b, kv_heads or h, s, d)]
    return [(rng.standard_normal(shape) * 0.3).astype(np.float32) for shape in shapes]


def _jax_ring(mesh, causal: bool, block: int):
    @functools.partial(shard_map, mesh=mesh, check_vma=False, in_specs=(SPEC,) * 3,
                       out_specs=SPEC)
    def ring(q, k, v):
        return jring_attention(q, k, v, axis_name="context", axis_size=CP, causal=causal,
                               block_q=block, block_k=block, interpret=True)

    return ring


def _put(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, SPEC))


def _port_ring(q, k, v, causal: bool, block: int, grads: bool = False):
    """The port's ring over a loopback ring of CP positions: the output,
    and with ``grads`` the grads of sum(o²)."""
    ts = [torch.from_numpy(x).requires_grad_(grads) for x in (q, k, v)]
    o = ring_attention(*ts, exchange=LoopbackRing(CP), causal=causal, block_q=block,
                       block_k=block)
    if not grads:
        return o.detach().numpy()
    (o ** 2).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(a, b, tol) -> None:
    np.testing.assert_allclose(a, np.asarray(b), atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("causal", [True, False])
def test_ring_output_matches_the_jax_ring(mesh, causal):
    q, k, v = _qkv(7, b=1, h=2, s=256, d=32)
    ref = _jax_ring(mesh, causal, 32)(*(_put(mesh, x) for x in (q, k, v)))
    _close(_port_ring(q, k, v, causal, 32), ref, OUT_TOL)


def test_ring_grads_match_the_jax_ring(mesh):
    q, k, v = _qkv(8, b=1, h=1, s=256, d=32)
    ring = _jax_ring(mesh, True, 32)
    ref = jax.grad(lambda *a: (ring(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    _, grads = _port_ring(q, k, v, True, 32, grads=True)
    for ours, theirs in zip(grads, ref):
        _close(ours, theirs, GRAD_TOL)


def test_gqa_compact_kv_matches_the_jax_ring_and_expanded_kv(mesh):
    """Compact kv (2 heads for 8 q heads) rides the ring: outputs and every
    grad match the JAX ring's and the port's own ring over kv expanded up
    front (whose dk/dv the autograd of repeat_kv sums over each group)."""
    q, k, v = _qkv(11, b=1, h=8, s=256, d=32, kv_heads=2)
    ring = _jax_ring(mesh, True, 32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref_out = ring(jq, jk, jv)
    ref = jax.grad(lambda *a: (ring(*a) ** 2).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _port_ring(q, k, v, True, 32, grads=True)
    _close(out, ref_out, OUT_TOL)
    for ours, theirs in zip(grads, ref):
        _close(ours, theirs, GRAD_TOL)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = ring_attention(ts[0], repeat_kv(ts[1], 8), repeat_kv(ts[2], 8),
                       exchange=LoopbackRing(CP), causal=True, block_q=32, block_k=32)
    (o ** 2).sum().backward()
    _close(out, o.detach().numpy(), OUT_TOL)
    for ours, expanded in zip(grads, ts):
        _close(ours, expanded.grad.numpy(), GRAD_TOL)
    # and the JAX ring over kv expanded up front agrees with both
    _close(out, ring(jq, jrepeat_kv(jk, 8), jrepeat_kv(jv, 8)), OUT_TOL)


@pytest.mark.parametrize("causal,visits", [(True, CP * (CP + 1) // 2), (False, CP * CP)])
def test_each_visit_runs_the_kernels_at_its_offsets(monkeypatch, causal, visits):
    """Causal skips the chunks in the future: cp(cp+1)/2 visits, each with
    the chunks' global offsets (q at my*s, k at src*s, src <= my), in the
    forward and in the backward; non-causal visits every pair."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = ring_mod._flash_fwd, ring_mod._flash_bwd

    def count_fwd(q, k, v, q_offset, k_offset, **kw):
        seen["fwd"].append((q_offset, k_offset))
        return fwd(q, k, v, q_offset, k_offset, **kw)

    def count_bwd(q, k, v, o, lse, do, q_offset, k_offset, **kw):
        seen["bwd"].append((q_offset, k_offset))
        return bwd(q, k, v, o, lse, do, q_offset, k_offset, **kw)

    monkeypatch.setattr(ring_mod, "_flash_fwd", count_fwd)
    monkeypatch.setattr(ring_mod, "_flash_bwd", count_bwd)
    q, k, v = _qkv(3, b=1, h=2, s=128, d=32)
    out, grads = _port_ring(q, k, v, causal, 16, grads=True)
    s = 128 // CP
    want = sorted((my * s, src * s) for my in range(CP) for src in range(CP)
                  if not causal or src <= my)
    assert len(seen["fwd"]) == len(seen["bwd"]) == visits
    assert sorted(seen["fwd"]) == sorted(seen["bwd"]) == want
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref = dense_attention(*ts, causal=causal)
    (ref ** 2).sum().backward()
    _close(out, ref.detach().numpy(), OUT_TOL)
    for ours, theirs in zip(grads, ts):
        _close(ours, theirs.grad.numpy(), GRAD_TOL)


def test_a_planted_offset_fault_fails_the_comparison(mesh, monkeypatch):
    """``k_offset + 1`` on one visit (rank 0's diagonal one, forward and
    backward) must miss the JAX ring's output by more than the
    tolerance."""
    fwd, bwd = ring_mod._flash_fwd, ring_mod._flash_bwd
    s = 256 // CP

    def shift(q_offset, k_offset):
        return k_offset + 1 if q_offset == k_offset == 0 else k_offset

    monkeypatch.setattr(ring_mod, "_flash_fwd", lambda q, k, v, qo, ko, **kw: fwd(
        q, k, v, qo, shift(qo, ko), **kw))
    monkeypatch.setattr(ring_mod, "_flash_bwd", lambda q, k, v, o, lse, do, qo, ko, **kw: bwd(
        q, k, v, o, lse, do, qo, shift(qo, ko), **kw))
    q, k, v = _qkv(7, b=1, h=2, s=256, d=32)
    ref = np.asarray(_jax_ring(mesh, True, 32)(*(_put(mesh, x) for x in (q, k, v))))
    out = _port_ring(q, k, v, True, 32)
    ratio = np.abs(out - ref) / (OUT_TOL[0] + OUT_TOL[1] * np.abs(ref))
    assert ratio.max() > 1, f"the offset fault went unseen: {ratio.max():.3g} of the tolerance"
    # only the first chunk's rows moved
    assert ratio[:, :, s:].max() <= 1
