"""Port parity: ``polyaxon_tpu_torch.ops.layers`` and the model configs /
param layout / init law against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both sides as
float32. Tolerances: the elementwise ops are the same f32 formulas, so
they agree to a few ulps (atol/rtol 1e-6); the transcendental tables
(cos/sin, silu, tanh-gelu) come from different libm implementations and
get 2e-6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as jax_transformer
from polyaxon_tpu.ops import layers as jl
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.models import transformer as T
from polyaxon_tpu_torch.ops import layers as tl
from polyaxon_tpu_torch.parallel.blocks import Law, draw_slice

RNG = np.random.default_rng(1234)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


class TestLayers:
    x = RNG.normal(size=(3, 5, 16)).astype(np.float32)
    w = RNG.normal(size=(16,)).astype(np.float32)
    bias = RNG.normal(size=(16,)).astype(np.float32)

    def test_rms_norm(self):
        _close(tl.rms_norm(torch.tensor(self.x), torch.tensor(self.w)),
               jl.rms_norm(jnp.asarray(self.x), jnp.asarray(self.w)))

    def test_rms_norm_keeps_bf16_and_computes_in_f32(self):
        xb = torch.tensor(self.x).bfloat16()
        out = tl.rms_norm(xb, torch.tensor(self.w))
        assert out.dtype == torch.bfloat16
        ref = jl.rms_norm(jnp.asarray(self.x, jnp.bfloat16), jnp.asarray(self.w))
        # both compute in f32 from the same bf16 inputs and round once
        np.testing.assert_array_equal(
            out.float().numpy(), np.asarray(ref.astype(jnp.float32)))

    def test_layer_norm(self):
        _close(tl.layer_norm(torch.tensor(self.x), torch.tensor(self.w),
                             torch.tensor(self.bias)),
               jl.layer_norm(jnp.asarray(self.x), jnp.asarray(self.w),
                             jnp.asarray(self.bias)), tol=2e-6)

    @pytest.mark.parametrize("head_dim,max_seq,theta",
                             [(16, 64, 10000.0), (64, 128, 1e6)])
    def test_rope_frequencies(self, head_dim, max_seq, theta):
        tc, ts = tl.rope_frequencies(head_dim, max_seq, theta)
        jc, js = jl.rope_frequencies(head_dim, max_seq, theta)
        assert tuple(tc.shape) == (max_seq, head_dim // 2)
        _close(tc, jc, tol=2e-6)
        _close(ts, js, tol=2e-6)

    @pytest.mark.parametrize("positions", ["none", "1d", "2d"])
    def test_apply_rope(self, positions):
        x = RNG.normal(size=(2, 3, 4, 16)).astype(np.float32)  # [B, H, S, D]
        cos, sin = jl.rope_frequencies(16, 32)
        pos = {"none": None,
               "1d": np.array([3, 9, 1, 30]),
               "2d": np.array([[0, 1, 2, 3], [7, 8, 9, 31]])}[positions]
        ref = jl.apply_rope(jnp.asarray(x), cos, sin,
                            positions=None if pos is None else jnp.asarray(pos))
        out = tl.apply_rope(torch.tensor(x), torch.tensor(_np(cos)),
                            torch.tensor(_np(sin)),
                            positions=None if pos is None else torch.tensor(pos))
        _close(out, ref, tol=2e-6)

    def test_apply_rope_rotates_halves_not_pairs(self):
        # NeoX layout: element i pairs with i + D/2, not with i + 1
        d = 8
        x = torch.zeros(1, 1, 1, d)
        x[..., 0] = 1.0
        cos, sin = tl.rope_frequencies(d, 4)
        out = tl.apply_rope(x, cos, sin, positions=torch.tensor([[1]]))
        nz = torch.nonzero(out[0, 0, 0].abs() > 1e-7).flatten().tolist()
        assert nz == [0, d // 2]

    def test_swiglu_and_gelu(self):
        a = RNG.normal(size=(4, 32)).astype(np.float32)
        g = RNG.normal(size=(4, 32)).astype(np.float32)
        _close(tl.swiglu(torch.tensor(a), torch.tensor(g)),
               jl.swiglu(jnp.asarray(a), jnp.asarray(g)), tol=2e-6)
        _close(tl.gelu(torch.tensor(a)), jl.gelu(jnp.asarray(a)), tol=2e-6)


class TestModelConfigs:
    def test_registry_names_match_the_dense_llama_entries(self):
        for name, (family, cfg) in REGISTRY.items():
            jfam, jcfg = JAX_REGISTRY[name]
            assert family == jfam
            if family not in ("lm", "mlm"):
                continue  # ViT and ResNet: tests/test_torch_families.py
            for f in dataclasses.fields(cfg):
                if f.name in ("dtype", "param_dtype"):
                    continue
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)
            assert str(cfg.dtype).split(".")[1] == jnp.dtype(jcfg.dtype).name
            assert cfg.kv_heads == jcfg.kv_heads and cfg.hd == jcfg.hd
            assert cfg.num_params() == jcfg.num_params(), name

    def test_llama_1b_shape(self):
        cfg = REGISTRY["llama-1b"][1]
        assert (cfg.hidden, cfg.num_layers, cfg.num_heads, cfg.kv_heads,
                cfg.hd, cfg.mlp_dim, cfg.vocab_size) == (
            2048, 22, 32, 4, 64, 5632, 32000)
        assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32

    @pytest.mark.parametrize("name", ["llama-tiny", "llama-1b"])
    def test_abstract_params_match(self, name):
        cfg = REGISTRY[name][1]
        assert T.abstract_params(cfg) == jax_transformer.abstract_params(
            JAX_REGISTRY[name][1])

    def test_learned_pos_bias_and_tied_layouts_match(self):
        cfg = dataclasses.replace(REGISTRY["llama-tiny"][1], pos="learned",
                                  use_bias=True, tie_embeddings=True,
                                  norm="ln", act="gelu")
        jcfg = dataclasses.replace(JAX_REGISTRY["llama-tiny"][1], pos="learned",
                                   use_bias=True, tie_embeddings=True,
                                   norm="ln", act="gelu")
        assert T.abstract_params(cfg) == jax_transformer.abstract_params(jcfg)
        assert cfg.num_params() == jcfg.num_params()


class TestInit:
    cfg = REGISTRY["llama-tiny"][1]

    def test_shapes_dtypes_and_law(self):
        p = T.init(self.cfg, seed=0, device="cpu")
        ab = T.abstract_params(self.cfg)

        def walk(tree, shapes, name=None):
            if isinstance(tree, dict):
                assert tree.keys() == shapes.keys()
                for k in tree:
                    walk(tree[k], shapes[k], k)
                return
            assert tuple(tree.shape) == shapes[0]
            assert tree.dtype == torch.float32
        walk(p, ab)
        assert torch.equal(p["layers"]["attn_norm"]["scale"],
                           torch.ones(2, 64))
        wq = p["layers"]["attn"]["wq"]
        # truncated normal at ±2σ, σ = 0.02
        assert wq.abs().max() <= 0.04 + 1e-7
        assert 0.015 < wq.std().item() < 0.0195
        wo = p["layers"]["attn"]["wo"]
        assert wo.abs().max() <= 0.04 / 2.0 + 1e-7     # ÷ sqrt(2L), L = 2

    def test_seeded_and_distinct(self):
        a = T.init(self.cfg, seed=3, device="cpu")["lm_head"]["w"]
        b = T.init(self.cfg, seed=3, device="cpu")["lm_head"]["w"]
        c = T.init(self.cfg, seed=4, device="cpu")["lm_head"]["w"]
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_truncated_normal_moments_match_jax(self):
        # the two packages draw different values from a seed, but the
        # same distribution: compare the moments of a large draw of the
        # port's init law
        ours = draw_slice(Law((200_000,), "trunc_normal"), (), 0, "cpu").numpy()
        ref = np.asarray(jax.random.truncated_normal(
            jax.random.PRNGKey(0), -2, 2, (200_000,), jnp.float32))
        assert abs(ours.std() - ref.std()) < 5e-3
        assert abs(ours.mean()) < 1e-2 and ours.min() >= -2 and ours.max() <= 2

    def test_norm_and_head_weights(self):
        p = T.init(self.cfg, seed=0, device="cpu")
        w, vocab_major = T.head_weights(p, self.cfg)
        assert w is p["lm_head"]["w"] and not vocab_major
        tied = dataclasses.replace(self.cfg, tie_embeddings=True)
        w, vocab_major = T.head_weights(T.init(tied, seed=0, device="cpu"), tied)
        assert vocab_major and tuple(w.shape) == (256, 64)
        x = torch.randn(2, 3, 64)
        _close(T._norm(x, {"scale": torch.ones(64)}, self.cfg),
               tl.rms_norm(x, torch.ones(64)))
        ln = dataclasses.replace(self.cfg, norm="ln")
        _close(T._norm(x, {"scale": torch.ones(64)}, ln),
               tl.layer_norm(x, torch.ones(64), torch.zeros(64)))
