"""Port parity: the port's ``ServeEngine`` against the JAX package's, on
the CPU, at llama-tiny (f32) from the same weights. Greedy generation
must agree token for token — at width 1 and with 4 concurrent requests,
prefix cache on (two prompts share full blocks) — with both engines
driven step by step through the same schedule. Then the engine's own
request-path behaviour (drain, overload shedding, deadlines, resume by
id, preemption) on the port alone.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as JT
from polyaxon_tpu.serve.engine import SamplingParams as JaxSamplingParams
from polyaxon_tpu.serve.engine import ServeEngine as JaxServeEngine
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.serve.engine import (
    EngineDrainingError, EngineOverloadedError, SamplingParams, ServeEngine,
    sample_token,
)

SHARED = list(range(40, 56))                      # two full bs=8 blocks
PROMPTS = [list(range(3, 8)), SHARED + [7, 9, 11], list(range(3, 20)),
           SHARED + [100, 101, 102, 103, 104]]
ENGINE_KW = dict(block_size=8, prefill_chunk=16, max_seq_len=64)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JAX_REGISTRY["llama-tiny"][1]
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, REGISTRY["llama-tiny"][1]


def _drive(engine, reqs, max_steps=2000):
    for _ in range(max_steps):
        if all(r.state in ("done", "failed") for r in reqs):
            return
        engine.step()
    raise AssertionError(f"engine did not finish: {[r.state for r in reqs]}")


def _run(engine, sampling, max_new):
    """Submit the first three prompts, step until the second (a sharer)
    has its first token — its full blocks are published — then submit
    the fourth, which maps them; drive everything to the end."""
    reqs = [engine.submit(p, sampling(max_new_tokens=max_new))
            for p in PROMPTS[:3]]
    for _ in range(200):
        if reqs[1].out_tokens:
            break
        engine.step()
    reqs.append(engine.submit(PROMPTS[3], sampling(max_new_tokens=max_new)))
    _drive(engine, reqs)
    return reqs


def _run_both(tiny, width, impl, max_new=8):
    jparams, jcfg, tparams, tcfg = tiny
    je = JaxServeEngine(jparams, jcfg, max_slots=width, attn_impl=impl,
                        **ENGINE_KW)
    te = ServeEngine(tparams, tcfg, max_slots=width, attn_impl=impl,
                     **ENGINE_KW)
    return (je, te, _run(je, JaxSamplingParams, max_new),
            _run(te, SamplingParams, max_new))


class TestEngineParity:
    @pytest.mark.parametrize("width,impl", [(1, "gather"), (4, "flash")])
    def test_greedy_tokens_match_jax(self, tiny, width, impl):
        je, te, jr, tr = _run_both(tiny, width, impl)
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
        assert all(len(r.out_tokens) == 8 for r in tr)
        js, ts = je.snapshot(), te.snapshot()
        for key in ("requests_total", "tokens_total", "decode_steps",
                    "prefix_cache_hits", "prefix_cache_misses", "cow_copies"):
            assert ts[key] == js[key], key
        # the fourth prompt mapped the second's two shared blocks
        assert ts["prefix_cache_hits"] >= 2
        assert ts["kv_audit_violations"] == 0

    def test_width_does_not_change_tokens(self, tiny):
        _, te1, _, t1 = _run_both(tiny, 1, "flash", max_new=6)
        te1.cache.prefix_index.drop_all(te1.cache.allocator)
        assert te1.cache.allocator.used_count == 0   # nothing leaked
        _, _, _, t4 = _run_both(tiny, 4, "gather", max_new=6)
        assert [r.out_tokens for r in t1] == [r.out_tokens for r in t4]


@pytest.fixture(scope="module")
def engine_params(tiny):
    return tiny[2], tiny[3]


def _engine(engine_params, **kw):
    params, cfg = engine_params
    return ServeEngine(params, cfg, **{**ENGINE_KW, "max_slots": 2, **kw})


class TestEngineBehaviour:
    def test_sample_token_greedy_and_seeded(self):
        logits = np.array([0.1, 3.0, 0.2, 2.9])
        assert sample_token(logits, SamplingParams(), np.random.default_rng(0)) == 1
        sp = SamplingParams(temperature=1.0, top_k=2, seed=5)
        a = [sample_token(logits, sp, np.random.default_rng(5)) for _ in range(20)]
        assert set(a) <= {1, 3}

    def test_drain_refuses_admission_but_finishes_inflight(self, engine_params):
        eng = _engine(engine_params)
        sp = SamplingParams(max_new_tokens=3)
        req = eng.submit(PROMPTS[0], sp)
        eng.begin_drain()
        with pytest.raises(EngineDrainingError):
            eng.submit(PROMPTS[1], sp)
        _drive(eng, [req])
        assert req.state == "done" and eng.drained

    def test_overload_sheds_with_retry_after(self, engine_params):
        eng = _engine(engine_params, max_waiting=1)
        sp = SamplingParams(max_new_tokens=3)
        eng.submit(PROMPTS[0], sp)
        with pytest.raises(EngineOverloadedError) as e:
            eng.submit(PROMPTS[1], sp)
        assert 1.0 <= e.value.retry_after_s <= 60.0
        assert eng.snapshot()["rejected_total"] == 1

    def test_oversized_and_empty_requests_fail_loudly(self, engine_params):
        eng = _engine(engine_params)
        big = eng.submit(list(range(60)), SamplingParams(max_new_tokens=10))
        assert big.state == "failed" and "max_seq_len" in big.error
        assert eng.submit([]).error == "empty prompt"

    def test_deadline_cancels_and_recycles_blocks(self, engine_params):
        eng = _engine(engine_params)
        req = eng.submit(PROMPTS[2], SamplingParams(max_new_tokens=30),
                         deadline_s=1e-4)
        _drive(eng, [req])
        assert req.state == "failed" and req.error == "deadline exceeded"
        assert eng.cache.allocator.used_count == len(eng.cache.prefix_index)

    def test_resume_by_request_id_is_exactly_once(self, engine_params):
        eng = _engine(engine_params)
        a, created = eng.submit_request(PROMPTS[0], SamplingParams(max_new_tokens=3),
                                        request_id="r1")
        b, again = eng.submit_request(PROMPTS[0], SamplingParams(max_new_tokens=3),
                                      request_id="r1")
        assert created and not again and a is b
        _drive(eng, [a])
        assert eng.lookup("r1").out_tokens == a.out_tokens
        assert eng.snapshot()["requests_total"] == 1

    def test_preemption_readmits_with_the_same_tokens(self, engine_params):
        params, cfg = engine_params
        sp = SamplingParams(max_new_tokens=8)
        prompts = (list(range(3, 11)), list(range(20, 28)), list(range(40, 48)))
        oracle = ServeEngine(params, cfg, max_slots=3, **ENGINE_KW)
        oreqs = [oracle.submit(p, sp) for p in prompts]
        _drive(oracle, oreqs)
        # tight pool: A and B fill it; C starves until B (newest) is
        # evicted behind C and later re-prefills its prefix
        eng = ServeEngine(params, cfg, max_slots=3, num_blocks=4,
                          preempt_grace_s=0.0, **ENGINE_KW)
        a, b = eng.submit(prompts[0], sp), eng.submit(prompts[1], sp)
        for _ in range(3):
            eng.step()
        c = eng.submit(prompts[2], sp)
        _drive(eng, [a, b, c])
        assert b.preemptions == 1
        assert [r.out_tokens for r in (a, b, c)] == [r.out_tokens for r in oreqs]
        assert eng.snapshot()["kv_audit_violations"] == 0

    def test_unknown_attn_impl_is_refused(self, engine_params):
        with pytest.raises(ValueError, match="attn_impl"):
            _engine(engine_params, attn_impl="dense")

    def test_engine_runs_where_the_params_live(self, engine_params):
        # no device argument: the engine takes the params' device and never
        # moves them; params split over two devices are refused
        eng = _engine(engine_params)
        assert eng.device == torch.device("cpu")
        assert eng.cache.k.device == eng.device
        with pytest.raises(TypeError, match="device"):
            _engine(engine_params, device="cpu")
        params, cfg = engine_params
        split = {**params, "lm_head": {"w": params["lm_head"]["w"].to("meta")}}
        with pytest.raises(ValueError, match="one device"):
            ServeEngine(split, cfg, **ENGINE_KW)
