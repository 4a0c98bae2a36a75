"""Port parity for speculative decoding, on the CPU: the port's
``verify_step`` against the JAX package's (logits and written pools) on
llama-tiny and gpt2-tiny from the same weights, ``verify_step[:, j]``
against the port's own ``decode_step`` at the same positions, the JAX
package's five engine cases (``tests/test_serve.py`` TestSpeculativeDecoding)
on the port's engine, and the port engine's speculative tokens against the
JAX engine's on the same converted weights.

Tolerance: both models are f32 end to end; verify and decode run the same
per-layer formulas and differ in the order of the sums inside each product
(a different matrix shape, or XLA's kernels against PyTorch's CPU ones):
below 1e-5 on logits of magnitude ~0.5 over two layers, pools likewise.
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as JT
from polyaxon_tpu.serve import model as jm
from polyaxon_tpu.serve.engine import SamplingParams as JaxSamplingParams
from polyaxon_tpu.serve.engine import ServeEngine as JaxServeEngine
from polyaxon_tpu.serve.kv_cache import SequenceBlocks as JaxSequenceBlocks
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY, transformer
from polyaxon_tpu_torch.serve import model as tm
from polyaxon_tpu_torch.serve.engine import SamplingParams, ServeEngine
from polyaxon_tpu_torch.serve.kv_cache import SequenceBlocks
from polyaxon_tpu_torch.serve.runtime import build_engine

TOL = 1e-5
BS = 8
PREFILL = [list(range(2, 2 + n)) for n in (7, 8, 9, 19)]
PROMPTS = [list(range(3, 3 + n)) for n in (5, 12, 17, 9)]
ENGINE_KW = dict(max_slots=4, block_size=8, prefill_chunk=16, max_seq_len=96)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module", params=["llama-tiny", "gpt2-tiny"])
def model(request):
    jcfg = JAX_REGISTRY[request.param][1]
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, REGISTRY[request.param][1]


def _prefilled(jparams, jcfg, tparams, tcfg, window):
    """JAX and port caches with PREFILL written through each side's
    prefill_chunk, room for ``window`` more tokens per row, plus an idle
    fifth row; returns (jax cache, port cache, jax tables, port tables)."""
    t = -(-(max(len(p) for p in PREFILL) + window) // BS)
    n = len(PREFILL) * t + 1
    jc = jm.init_cache(jcfg, num_blocks=n, block_size=BS)
    tc = tm.init_cache(tcfg, num_blocks=n, block_size=BS, device="cpu")
    jseqs, tseqs = [], []
    for p in PREFILL:
        js, ts = JaxSequenceBlocks(), SequenceBlocks()
        jc.ensure(js, len(p) + window)
        tc.ensure(ts, len(p) + window)
        jt1 = jnp.asarray(jc.block_table_array([js], t))
        _, jc.k, jc.v = jm.prefill_chunk(
            jparams, jnp.asarray([p], jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(len(p), jnp.int32), jc.k, jc.v, jt1, cfg=jcfg)
        tm.prefill_chunk(tparams, torch.tensor([p]), 0, len(p), tc.k, tc.v,
                         torch.as_tensor(tc.block_table_array([ts], t)), cfg=tcfg)
        jseqs.append(js)
        tseqs.append(ts)
    return (jc, tc, jnp.asarray(jc.block_table_array(jseqs + [None], t)),
            torch.as_tensor(tc.block_table_array(tseqs + [None], t)))


WINDOW = [[11, 40, 41, 42], [12, 50, 51, 52], [13, 60, 61, 62],
          [14, 70, 71, 72], [0, 0, 0, 0]]
POSITIONS = [len(p) for p in PREFILL] + [0]
ACTIVE = [True] * 4 + [False]


class TestVerifyStep:
    def test_logits_and_pools_match_jax(self, model):
        jparams, jcfg, tparams, tcfg = model
        jc, tc, jt, tt = _prefilled(jparams, jcfg, tparams, tcfg, 4)
        jl, jk, jv = jm.verify_step(
            jparams, jnp.asarray(WINDOW, jnp.int32), jnp.asarray(POSITIONS, jnp.int32),
            jc.k, jc.v, jt, jnp.asarray(ACTIVE), cfg=jcfg)
        tl = tm.verify_step(tparams, torch.tensor(WINDOW), torch.tensor(POSITIONS),
                            tc.k, tc.v, tt, torch.tensor(ACTIVE), cfg=tcfg)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (5, 4, tcfg.vocab_size)
        _close(tl.numpy()[:4], np.asarray(jl)[:4])
        # live blocks hold the same K/V (the trash block keeps whichever
        # masked write landed last)
        _close(tc.k[:, :-1].numpy(), np.asarray(jk)[:, :-1])
        _close(tc.v[:, :-1].numpy(), np.asarray(jv)[:, :-1])

    def test_each_position_matches_decode_step(self, model):
        """verify_step's logits[:, j] are decode_step's at the same
        position, with the window's tokens fed one step at a time."""
        jparams, jcfg, tparams, tcfg = model
        _, tc, _, tt = _prefilled(jparams, jcfg, tparams, tcfg, 4)
        k2, v2 = tc.k.clone(), tc.v.clone()
        tl = tm.verify_step(tparams, torch.tensor(WINDOW), torch.tensor(POSITIONS),
                            tc.k, tc.v, tt, torch.tensor(ACTIVE), cfg=tcfg)
        for j in range(4):
            dl = tm.decode_step(
                tparams, torch.tensor([w[j] for w in WINDOW]),
                torch.tensor([p + j for p in POSITIONS]), k2, v2, tt,
                torch.tensor(ACTIVE), cfg=tcfg, impl="gather")
            _close(tl[:4, j].numpy(), dl[:4].numpy())
        _close(tc.k[:, :-1].numpy(), k2[:, :-1].numpy())

    def test_identity_layers_keep_the_logits(self, model):
        _, _, tparams, tcfg = model
        big, big_cfg = tm.extend_with_identity_layers(tparams, tcfg, 3)
        assert big_cfg.num_layers == tcfg.num_layers + 3
        assert big["layers"]["attn"]["wq"].shape[0] == tcfg.num_layers + 3
        assert not big["layers"]["mlp"]["wo"][tcfg.num_layers:].any()
        tokens = torch.tensor([[5, 9, 31, 7, 2, 99]])
        a = transformer.apply(tparams, tokens, tcfg)
        b = transformer.apply(big, tokens, big_cfg)
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def _drive(engine, reqs, max_steps=4000):
    for _ in range(max_steps):
        if all(r.state in ("done", "failed") for r in reqs):
            return
        engine.step()
    raise AssertionError(f"engine did not finish: {[r.state for r in reqs]}")


@pytest.fixture(scope="module")
def tiny():
    cfg = REGISTRY["llama-tiny"][1]
    return transformer.init(cfg, seed=0, device="cpu"), cfg


class TestSpeculativeEngine:
    """``tests/test_serve.py`` TestSpeculativeDecoding, on the port."""

    def _outputs(self, params, cfg, jobs, **kw):
        eng = ServeEngine(params, cfg, **ENGINE_KW, **kw)
        reqs = [eng.submit(p, sp) for p, sp in jobs]
        _drive(eng, reqs)
        return eng, [r.out_tokens for r in reqs]

    def test_greedy_parity_with_independent_draft(self, tiny):
        """Whatever a stranger draft proposes, greedy output equals plain
        decode (longest agreeing prefix + the target's correction)."""
        params, cfg = tiny
        draft = transformer.init(cfg, seed=9, device="cpu")
        jobs = [(p, SamplingParams(max_new_tokens=8)) for p in PROMPTS]
        _, plain = self._outputs(params, cfg, jobs)
        eng, spec = self._outputs(params, cfg, jobs, draft_params=draft,
                                  draft_cfg=cfg, spec_k=3)
        assert spec == plain
        snap = eng.snapshot()
        assert snap["spec_tokens_proposed"] > 0
        assert snap["spec_tokens_accepted"] <= snap["spec_tokens_proposed"]
        assert snap["kv_audit_violations"] == 0

    def test_identity_extended_target_accepts_everything(self, tiny):
        params, cfg = tiny
        big, big_cfg = tm.extend_with_identity_layers(params, cfg, cfg.num_layers)
        jobs = [(p, SamplingParams(max_new_tokens=8)) for p in PROMPTS]
        plain_eng, plain = self._outputs(big, big_cfg, jobs)
        eng, spec = self._outputs(big, big_cfg, jobs, draft_params=params,
                                  draft_cfg=cfg, spec_k=4)
        assert spec == plain
        snap = eng.snapshot()
        assert snap["spec_tokens_proposed"] > 0
        assert snap["spec_tokens_accepted"] == snap["spec_tokens_proposed"]
        assert snap["kv_audit_violations"] == 0
        assert eng.decode_steps < plain_eng.decode_steps  # fewer target steps

    def test_sampled_rows_match_plain_decode(self, tiny):
        params, cfg = tiny
        draft = transformer.init(cfg, seed=9, device="cpu")
        jobs = [(p, SamplingParams(max_new_tokens=6, temperature=0.8, seed=100 + i))
                for i, p in enumerate(PROMPTS)]
        _, plain = self._outputs(params, cfg, jobs)
        _, spec = self._outputs(params, cfg, jobs, draft_params=draft,
                                draft_cfg=cfg, spec_k=3)
        assert spec == plain

    def test_stop_token_respected_mid_acceptance(self, tiny):
        params, cfg = tiny
        big, big_cfg = tm.extend_with_identity_layers(params, cfg, cfg.num_layers)
        _, [probe] = self._outputs(big, big_cfg,
                                   [(PROMPTS[1], SamplingParams(max_new_tokens=6))])
        stop = probe[3]  # lands mid-window for spec_k=4
        sp = SamplingParams(max_new_tokens=20, stop_token=stop)
        _, [plain] = self._outputs(big, big_cfg, [(PROMPTS[1], sp)])
        _, [spec] = self._outputs(big, big_cfg, [(PROMPTS[1], sp)],
                                  draft_params=params, draft_cfg=cfg, spec_k=4)
        assert spec == plain and spec[-1] == stop

    def test_draft_vocab_mismatch_raises(self, tiny):
        params, cfg = tiny
        with pytest.raises(ValueError, match="vocab"):
            ServeEngine(params, cfg, max_slots=2, block_size=8, draft_params=params,
                        draft_cfg=replace(cfg, vocab_size=128), spec_k=2)


class TestAgainstTheJaxEngine:
    @pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
    def test_spec_tokens_match_jax(self, name):
        """Same converted weights, same draft: the port's speculative
        tokens and counters are the JAX engine's."""
        jcfg = JAX_REGISTRY[name][1]
        jparams = JT.init(jax.random.PRNGKey(0), jcfg)
        jdraft = JT.init(jax.random.PRNGKey(9), jcfg)
        tcfg = REGISTRY[name][1]
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        tdraft = params_from_jax(jax.tree.map(np.asarray, jdraft), device="cpu")
        je = JaxServeEngine(jparams, jcfg, **ENGINE_KW, draft_params=jdraft,
                            draft_cfg=jcfg, spec_k=3)
        te = ServeEngine(tparams, tcfg, **ENGINE_KW, draft_params=tdraft,
                         draft_cfg=tcfg, spec_k=3)
        jr = [je.submit(p, JaxSamplingParams(max_new_tokens=8)) for p in PROMPTS]
        tr = [te.submit(p, SamplingParams(max_new_tokens=8)) for p in PROMPTS]
        _drive(je, jr)
        _drive(te, tr)
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
        js, ts = je.snapshot(), te.snapshot()
        for key in ("spec_tokens_proposed", "spec_tokens_accepted", "decode_steps",
                    "tokens_total", "kv_audit_violations"):
            assert ts[key] == js[key], key


class TestRuntime:
    SPEC = {"model": "llama-tiny", "platform": "cpu", "block_size": 8,
            "max_seq_len": 96, "prefill_chunk": 16}

    def test_speculative_key_builds_a_spec_engine(self):
        engine = build_engine({**self.SPEC, "speculative": {"draft": "llama-tiny", "k": 3}})
        assert engine.spec_k == 3 and engine.draft_cache is not None
        plain = build_engine(self.SPEC)
        a = [engine.submit(p, SamplingParams(max_new_tokens=6)) for p in PROMPTS]
        b = [plain.submit(p, SamplingParams(max_new_tokens=6)) for p in PROMPTS]
        _drive(engine, a)
        _drive(plain, b)
        assert [r.out_tokens for r in a] == [r.out_tokens for r in b]
        # the draft is the target itself (same name, same seed): all accepted
        snap = engine.snapshot()
        assert snap["spec_tokens_accepted"] == snap["spec_tokens_proposed"] > 0

    @pytest.mark.parametrize("value,match", [
        ({"draft": "llama-125m", "k": 4}, "vocab 32000 != target vocab 256"),
        ({"draft": "no-such-model"}, "speculative.draft model 'no-such-model' unknown"),
        ({"draft": "llama-tiny", "k": 17}, "speculative.k must be 1..16, got 17"),
        ({"draft": "llama-tiny", "k": 0}, "speculative.k must be 1..16, got 0"),
        ({"k": 4}, "needs {draft, k}"),
    ])
    def test_bad_speculative_blocks_raise(self, value, match):
        with pytest.raises(SystemExit, match=match.replace("{", r"\{").replace("}", r"\}")
                           .replace(".", r"\.")):
            build_engine({**self.SPEC, "speculative": value})
