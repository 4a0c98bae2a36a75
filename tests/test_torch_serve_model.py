"""Port parity: ``polyaxon_tpu_torch.serve.model`` (prefill_chunk,
decode_step) and ``serve.kv_cache`` against the JAX package on the CPU,
from the same llama-tiny weights carried across with ``params_from_jax``.

Tolerance: llama-tiny is f32 end to end; both sides run the same f32
formulas in the same order per layer, and differ only in the summation
order inside each matrix product (XLA's vs PyTorch's CPU kernels). Over
two layers that stays below 1e-5 on logits of magnitude ~0.5, and the
written pools agree to the same bound.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as JT
from polyaxon_tpu.serve import model as jm
from polyaxon_tpu.serve.kv_cache import SequenceBlocks as JaxSequenceBlocks
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.serve import model as tm
from polyaxon_tpu_torch.serve.kv_cache import (
    BlockAllocator, OutOfBlocksError, PagedKVCache, PrefixIndex, SequenceBlocks,
)

TOL = 1e-5
BS = 8
PROMPTS = [list(range(2, 2 + n)) for n in (7, 8, 9, 19)]


@pytest.fixture(scope="module")
def tiny():
    jcfg = JAX_REGISTRY["llama-tiny"][1]
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, REGISTRY["llama-tiny"][1]


def _caches(jcfg, tcfg, prompts, max_new):
    """One JAX and one port cache with identical tables."""
    t = -(-(max(len(p) for p in prompts) + max_new) // BS)
    n = len(prompts) * t + 1
    jc = jm.init_cache(jcfg, num_blocks=n, block_size=BS)
    tc = tm.init_cache(tcfg, num_blocks=n, block_size=BS, device="cpu")
    jseqs, tseqs = [], []
    for p in prompts:
        js, ts = JaxSequenceBlocks(), SequenceBlocks()
        jc.ensure(js, len(p) + max_new)
        tc.ensure(ts, len(p) + max_new)
        assert js.block_ids == ts.block_ids
        jseqs.append(js)
        tseqs.append(ts)
    return jc, tc, jseqs, tseqs, t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


class TestParamsFromJax:
    def test_same_tree_and_values(self, tiny):
        jparams, _, tparams, _ = tiny
        flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
        for path, leaf in flat_j:
            node = tparams
            for k in path:
                node = node[k.key]
            assert isinstance(node, torch.Tensor)
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    def test_bfloat16_leaves_stay_bfloat16(self):
        tree = {"a": {"w": np.asarray(jnp.arange(4, dtype=jnp.bfloat16))}}
        out = params_from_jax(tree, device="cpu")
        assert out["a"]["w"].dtype == torch.bfloat16
        assert out["a"]["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


class TestPrefillAndDecode:
    def test_prefill_chunks_logits_and_pools(self, tiny):
        jparams, jcfg, tparams, tcfg = tiny
        prompt = list(range(5, 26))  # 21 tokens, 4-token chunks
        jc, tc, jseqs, tseqs, t = _caches(jcfg, tcfg, [prompt], 4)
        jt = jnp.asarray(jc.block_table_array(jseqs, t))
        tt = torch.as_tensor(tc.block_table_array(tseqs, t))
        for lo in range(0, len(prompt), 4):
            chunk = prompt[lo:lo + 4]
            padded = chunk + [0] * (4 - len(chunk))
            jl, jc.k, jc.v = jm.prefill_chunk(
                jparams, jnp.asarray([padded], jnp.int32),
                jnp.asarray(lo, jnp.int32), jnp.asarray(len(chunk), jnp.int32),
                jc.k, jc.v, jt, cfg=jcfg)
            tl = tm.prefill_chunk(tparams, torch.tensor([padded]), lo, len(chunk),
                                  tc.k, tc.v, tt, cfg=tcfg)
            assert tl.dtype == torch.float32 and tuple(tl.shape) == (1, 256)
            _close(tl.numpy(), jl)
        _close(tc.k.numpy(), jc.k)
        _close(tc.v.numpy(), jc.v)

    @pytest.mark.parametrize("impl", ["gather", "flash"])
    def test_batched_decode_logits_and_pools(self, tiny, impl):
        """Prefill each row, then decode the ragged batch (lengths 7/8/9/19
        crossing bs=8 boundaries) with one inactive slot."""
        jparams, jcfg, tparams, tcfg = tiny
        prompts = PROMPTS
        jc, tc, jseqs, tseqs, t = _caches(jcfg, tcfg, prompts, 4)
        for i, p in enumerate(prompts):
            jt1 = jnp.asarray(jc.block_table_array([jseqs[i]], t))
            tt1 = torch.as_tensor(tc.block_table_array([tseqs[i]], t))
            _, jc.k, jc.v = jm.prefill_chunk(
                jparams, jnp.asarray([p], jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(len(p), jnp.int32), jc.k, jc.v, jt1, cfg=jcfg)
            tm.prefill_chunk(tparams, torch.tensor([p]), 0, len(p), tc.k, tc.v,
                             tt1, cfg=tcfg)
        seqs_j = jseqs + [None]
        seqs_t = tseqs + [None]
        jt = jnp.asarray(jc.block_table_array(seqs_j, t))
        tt = torch.as_tensor(tc.block_table_array(seqs_t, t))
        toks = [11, 12, 13, 14, 0]
        pos = [len(p) for p in prompts] + [0]
        active = [True] * 4 + [False]
        for step in range(3):
            jl, jc.k, jc.v = jm.decode_step(
                jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
                jc.k, jc.v, jt, jnp.asarray(active), cfg=jcfg, impl=impl)
            tl = tm.decode_step(
                tparams, torch.tensor(toks), torch.tensor(pos), tc.k, tc.v, tt,
                torch.tensor(active), cfg=tcfg, impl=impl)
            _close(tl.numpy()[:4], np.asarray(jl)[:4])
            toks = [int(x) for x in np.asarray(jl).argmax(-1)]
            pos = [p + 1 for p in pos]
        # live blocks hold the same K/V (the trash block is excluded: slots
        # written by several masked rows keep whichever write landed last)
        _close(tc.k[:, :-1].numpy(), np.asarray(jc.k)[:, :-1])
        _close(tc.v[:, :-1].numpy(), np.asarray(jc.v)[:, :-1])

    def test_bf16_decode_runs_and_stays_close(self, tiny):
        _, _, tparams, tcfg = tiny
        cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
        params = tm.serving_params(tparams, cfg)
        assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
        assert params["layers"]["attn_norm"]["scale"].dtype == torch.float32
        outs = {}
        for impl in ("gather", "flash"):
            cache = tm.init_cache(cfg, num_blocks=4, block_size=BS, device="cpu")
            seq = SequenceBlocks()
            cache.ensure(seq, 20)
            tbl = torch.as_tensor(cache.block_table_array([seq], 3))
            tm.prefill_chunk(params, torch.tensor([PROMPTS[3]]), 0, 19,
                             cache.k, cache.v, tbl, cfg=cfg)
            assert cache.k.dtype == torch.bfloat16
            outs[impl] = tm.decode_step(
                params, torch.tensor([3]), torch.tensor([19]), cache.k, cache.v,
                tbl, torch.tensor([True]), cfg=cfg, impl=impl)
        assert torch.isfinite(outs["flash"]).all()
        # the two bf16 paths round p and the attention output at different
        # places; logits here are ~0.5, bf16's last place there is 2^-9
        torch.testing.assert_close(outs["flash"], outs["gather"], atol=2e-2,
                                   rtol=0)

    def test_dense_reference_decode_matches_jax(self, tiny):
        jparams, jcfg, tparams, tcfg = tiny
        ref = jm.dense_reference_decode(jparams, jcfg, PROMPTS[:2], 5)
        out = tm.dense_reference_decode(tparams, tcfg, PROMPTS[:2], 5)
        assert out == ref


class TestKVCache:
    def test_allocator_roundtrip_and_refcounts(self):
        a = BlockAllocator(4)
        ids = a.alloc(3)
        a.incref(ids[0])
        a.free(ids)
        assert a.free_count == 3 and a.ref(ids[0]) == 1
        with pytest.raises(OutOfBlocksError):
            a.alloc(4)
        a.decref(ids[0])
        with pytest.raises(RuntimeError, match="double free"):
            a.decref(ids[0])
        assert a.audit_violations == 1

    def test_pools_live_on_the_device_with_a_trash_block(self):
        cache = PagedKVCache(num_layers=2, num_blocks=3, block_size=4,
                             kv_heads=2, head_dim=8, dtype=torch.bfloat16,
                             device="cpu")
        assert tuple(cache.k.shape) == (2, 4, 4, 2, 8)
        assert cache.k.dtype == torch.bfloat16 and cache.k.device.type == "cpu"
        seq = SequenceBlocks()
        cache.ensure(seq, 12)
        assert cache.trash_block not in seq.block_ids

    def test_cow_copies_every_layer_in_place(self):
        cache = PagedKVCache(num_layers=3, num_blocks=4, block_size=2,
                             kv_heads=1, head_dim=4, device="cpu")
        k_ptr = cache.k.data_ptr()
        cache.k.copy_(torch.randn_like(cache.k))
        cache.v.copy_(torch.randn_like(cache.v))
        tokens = [1, 2, 3, 4]
        a = SequenceBlocks()
        cache.ensure(a, 4)
        cache.publish_prefix(a, tokens)
        b = SequenceBlocks()
        assert cache.share_prefix(b, tokens) == 4
        src = b.block_ids[1]
        cache.ensure_writable(b, 3)
        dst = b.block_ids[1]
        assert dst != src and cache.cow_copies == 1
        assert cache.k.data_ptr() == k_ptr          # written in place
        assert torch.equal(cache.k[:, dst], cache.k[:, src])
        assert torch.equal(cache.v[:, dst], cache.v[:, src])

    def test_prefix_index_evicts_leaf_first(self):
        a = BlockAllocator(4)
        idx = PrefixIndex(block_size=2)
        ids = a.alloc(2)
        for b in idx.insert([1, 2, 3, 4], ids):
            a.incref(b)
        a.free(ids)                                  # index-only now
        assert idx.evictable(a) == 2
        assert idx.evict(1, a) == 1 and idx.match([1, 2, 3, 4]) == [ids[0]]
