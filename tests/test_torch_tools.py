"""The port's measurement tools against the repository's JAX tools, on the
CPU at tiny sizes:

- ``polyaxon_tpu_torch.bench.bench_config`` against a literal table of
  ``bench.py:167-213``'s branches, and the CPU smoke's line (dense and
  ``--moe``) against ``bench.py``'s own, run in this process;
  ``--data tokens-file`` on a small corpus;
- ``polyaxon_tpu_torch.scripts.serve_bench``'s functions against
  ``scripts/serve_bench.py``'s, the weights carried across with
  ``params_from_jax``: equal key sets and equal deterministic counts
  (tokens, prefix hits and misses, extra blocks, layers), acceptance and
  the KV audit — no wall-clock figure is compared;
- ``polyaxon_tpu_torch.scripts.perf_exp``'s keys (``scripts/perf_exp.py:
  96-104``) and its ``--profile`` Chrome trace;
- ``python -m polyaxon_tpu_torch.partition plan`` against the JAX
  ``polyaxon partition plan`` verb on every polyaxonfile under
  ``examples/``, fed the compiled runtime dict and the topology's devices
  and slices;
- ``polyaxon_tpu_torch.scripts.ring_bench`` on a loopback ring (seq 2048,
  cp 4, f32) against ``scripts/ring_bench.py``'s ring and gather, rebuilt
  from the JAX package's ``ring_attention`` and ``_flash_fwd`` in
  interpret mode on 4 of the 8 CPU devices: each output within 1e-5 of
  its largest element, the line's keys those of the JAX script's own line
  (``v5e_`` as ``h100_``, plus ``platform``, ``dtype`` and ``ranks``), the
  ``kv_resident_mb_*`` columns equal, the ``h100_*`` columns the formula
  at 989e12 FLOP/s and 450e9 B/s, and a planted fault (the gather path's
  first q chunk placed one block late) breaking the agreement;
- every CLI without ``--platform cpu`` on a machine without CUDA exits
  non-zero, naming CUDA; ``pp_bench`` alone in one process exits
  non-zero, naming the stage ranks (its group paths run in
  ``tests/test_torch_pipeline.py``'s gloo groups).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import threading
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as JT
from polyaxon_tpu_torch import bench as tbench
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY, llama
from polyaxon_tpu_torch.partition import __main__ as tpartition_cli
from polyaxon_tpu_torch.ops.ring_attention import LoopbackRing
from polyaxon_tpu_torch.scripts import perf_exp as tperf
from polyaxon_tpu_torch.scripts import pp_bench as tpp
from polyaxon_tpu_torch.scripts import ring_bench as trb
from polyaxon_tpu_torch.scripts import serve_bench as tsb

ROOT = Path(__file__).resolve().parents[1]
BF16 = {"mu_dtype": "bfloat16", "nu_dtype": "bfloat16"}
BLOCKS = dict(attn_block_q=1024, attn_block_k=1024)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_serve_bench():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return _load("jax_serve_bench", ROOT / "scripts" / "serve_bench.py")
    finally:
        sys.path.remove(str(ROOT / "scripts"))


@pytest.fixture(scope="module")
def tiny():
    jcfg = JAX_REGISTRY["llama-tiny"][1]
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, jcfg, tparams, REGISTRY["llama-tiny"][1]


# -- bench.py ---------------------------------------------------------------

#: bench.py:167-213, branch by branch: (n, on the accelerator, --moe) ->
#: (base config, its replaced fields, batch, seq, axes, steps,
#: microbatches, moments, grad dtype, accumulator dtype)
BENCH_BRANCHES = {
    "moe-card-1": ((1, True, True), (
        llama.LLAMA_MOE_1B, dict(remat="attn_qkv", moe_cap_block=512, **BLOCKS),
        32, 2048, {"data": 1}, 8, 8, BF16, "bfloat16", "bfloat16")),
    "moe-card-4": ((4, True, True), (
        llama.LLAMA_MOE_1B, dict(remat="attn_qkv", moe_cap_block=512, **BLOCKS),
        128, 2048, {"data": 4}, 8, 8, BF16, "bfloat16", "bfloat16")),
    "moe-cpu-1": ((1, False, True), (
        llama.LLAMA_MOE_TINY, dict(attn_impl="dense", moe_cap_block=4),
        8, 64, {"data": 1}, 5, 1, {}, None, None)),
    "moe-cpu-16": ((16, False, True), (
        llama.LLAMA_MOE_TINY, dict(attn_impl="dense", moe_cap_block=4),
        8, 64, {"data": 8}, 5, 1, {}, None, None)),
    "7b-fsdp-32": ((32, True, False), (
        llama.LLAMA2_7B, dict(remat="attn_qkv", **BLOCKS),
        128, 2048, {"fsdp": 32}, 20, 2, BF16, "bfloat16", "bfloat16")),
    "7b-fsdp-64": ((64, True, False), (
        llama.LLAMA2_7B, dict(remat="attn_qkv", **BLOCKS),
        256, 2048, {"fsdp": 64}, 20, 2, BF16, "bfloat16", "bfloat16")),
    "1b-card-1": ((1, True, False), (
        llama.LLAMA_1B, dict(remat="attn_qkv", max_seq=2048, **BLOCKS),
        64, 2048, {"data": 1}, 8, 32, BF16, "bfloat16", "bfloat16")),
    "1b-card-31": ((31, True, False), (
        llama.LLAMA_1B, dict(remat="attn_qkv", max_seq=2048, **BLOCKS),
        64 * 31, 2048, {"data": 31}, 8, 32, BF16, "bfloat16", "bfloat16")),
    "cpu-smoke-1": ((1, False, False), (
        llama.LLAMA_TINY, dict(attn_impl="dense"), 8, 64, {"data": 1}, 5, 1, {}, None, None)),
    "cpu-smoke-64": ((64, False, False), (
        llama.LLAMA_TINY, dict(attn_impl="dense"), 8, 64, {"data": 8}, 5, 1, {}, None, None)),
}


@pytest.mark.parametrize("branch", sorted(BENCH_BRANCHES))
def test_bench_config_is_bench_pys_branch(branch):
    """``bench_config(n, on_cuda, moe)`` is the recipe ``bench.py:167-213``
    picks for n chips: the MoE branch on the card and on the CPU, llama2-7b
    over ``{fsdp: n}`` from 32, llama-1b in 32 microbatches of 2 per chip,
    and the CPU smoke (``{data: min(n, 8)}``)."""
    args, (base, fields, *rest) = BENCH_BRANCHES[branch]
    recipe = tbench.bench_config(*args)
    assert recipe.model == replace(base, **fields)
    assert tuple(recipe)[1:] == tuple(rest)


def _unit_fields(unit: str) -> dict:
    """``tokens/s/chip (k=v, k=v, ...)`` as {k: v}, in order."""
    head, _, body = unit.partition(" (")
    assert head == "tokens/s/chip"
    return dict(part.split("=", 1) for part in body.rstrip(")").split(", "))


def _json_lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("mode", ["dense", "moe"])
def test_cpu_smoke_line_has_bench_pys_keys(mode, monkeypatch, capsys):
    """The CPU smoke of both benches: the same metric name and keys, and
    the same ``unit`` fields, equal but for the measured ones (``mfu``,
    ``drop``) and ``chips``, each tool's own device count (the JAX process
    holds 8 CPU devices, the port's run is one process)."""
    flags = ["--moe"] if mode == "moe" else []
    monkeypatch.setattr(sys, "argv", ["bench.py", *flags])
    _load("jax_bench", ROOT / "bench.py").main()
    ref = _json_lines(capsys.readouterr().out)[-1]
    assert tbench.main([*flags, "--platform", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    got = lines[0]
    assert got.keys() == ref.keys() == {"metric", "value", "unit", "vs_baseline"}
    assert got["metric"] == ref["metric"]
    want, have = _unit_fields(ref["unit"]), _unit_fields(got["unit"])
    assert list(have) == list(want)
    assert want["chips"] == str(len(jax.devices())) and have["chips"] == "1"
    for key in set(want) - {"mfu", "drop", "chips"}:
        assert have[key] == want[key], key
    assert got["value"] > 0 and got["vs_baseline"] >= 0


def test_tokens_file_mode_streams_a_packed_corpus(tmp_path):
    """``data="tokens-file"`` writes the uint16 corpus once (the vocab in
    its name), trains the dense recipe from it and stops its prefetch
    thread; a second run reuses the file."""
    logged = []
    before = set(threading.enumerate())
    res = tbench.run_bench(data="tokens-file", platform="cpu", steps=2, tokens=20_000,
                           token_dir=str(tmp_path), track=lambda i, m: logged.append(m))
    path = tmp_path / "plx_bench_tokens_v256.npy"
    corpus = np.load(path, mmap_mode="r")
    assert corpus.dtype == np.uint16 and corpus.shape == (20_000,)
    assert int(corpus.max()) < 256
    assert res.line["metric"] == "llama_train_tokens_per_sec_per_chip"
    assert len(logged) == 2 and all(np.isfinite(m["loss"]) for m in logged)
    # closing the stream stops its worker at the worker's next check
    for worker in [t for t in set(threading.enumerate()) - before
                   if t.name == "plx-prefetch"]:
        worker.join(timeout=30)
        assert not worker.is_alive()
    stamp = path.stat().st_mtime_ns
    tbench.run_bench(data="tokens-file", platform="cpu", steps=1, tokens=20_000,
                     token_dir=str(tmp_path))
    assert path.stat().st_mtime_ns == stamp


def test_bench_mfu_is_the_meters_identity():
    """The line's MFU is tokens/s/chip x flops per token over the H100's
    989 TFLOP/s, and ``vs_baseline`` is it over 0.45."""
    res = tbench.run_bench(platform="cpu", steps=2)
    mfu = res.metrics["tokens_per_sec_per_chip"] * res.flops_per_token / 989e12
    assert res.metrics["mfu"] == pytest.approx(mfu, rel=1e-12)
    assert res.line["vs_baseline"] == round(res.metrics["mfu"] / 0.45, 4)
    assert res.steps == 2 and res.chips == 1


# -- scripts/serve_bench.py -------------------------------------------------


def test_engine_bench_counts_match(jax_serve_bench, tiny):
    """One sweep point from the same weights: the same keys and counts."""
    jparams, jcfg, tparams, tcfg = tiny
    kw = dict(requests=3, prompt_len=8, max_new=4, block_size=8)
    ref = jax_serve_bench.run_engine_bench(2, params=jparams, cfg=jcfg, **kw)
    got = tsb.run_engine_bench(2, params=tparams, cfg=tcfg, platform="cpu", **kw)
    assert got.keys() == ref.keys()
    for key in ("concurrency", "requests", "prompt_len", "max_new", "tokens"):
        assert got[key] == ref[key], key
    assert got["tokens"] == 3 * 4


def test_sweep_keys_and_rows(jax_serve_bench):
    """The sweep over two widths, each tool on its own llama-tiny init."""
    kw = dict(requests=2, prompt_len=8, max_new=3)
    ref = jax_serve_bench.run_sweep((1, 2), **kw)
    got = tsb.run_sweep((1, 2), platform="cpu", **kw)
    assert got.keys() == ref.keys()
    assert [r.keys() for r in got["rows"]] == [r.keys() for r in ref["rows"]]
    for key in ("kind", "model", "platform"):
        assert got[key] == ref[key]
    assert [r["tokens"] for r in got["rows"]] == [r["tokens"] for r in ref["rows"]] == [6, 6]


@pytest.mark.parametrize("attn_impl", ["flash", "gather"])
def test_prefix_share_counts_match(jax_serve_bench, tiny, attn_impl):
    """A shared 32-token system prompt over 4 requests: the same hits,
    misses, extra blocks and copies as the JAX engine, no audit
    violation."""
    jparams, jcfg, tparams, tcfg = tiny
    kw = dict(requests=4, sys_len=32, tail_len=4, max_new=2, block_size=8, best_of=1)
    ref = jax_serve_bench.run_prefix_share_bench(params=jparams, cfg=jcfg, **kw)
    got = tsb.run_prefix_share_bench(params=tparams, cfg=tcfg, platform="cpu",
                                     attn_impl=attn_impl, **kw)
    assert got.keys() == ref.keys()
    for side in ("shared", "reprefill"):
        assert got[side].keys() == ref[side].keys()
        for key in ("prefix_hits", "prefix_misses", "extra_kv_blocks_per_request",
                    "cow_copies", "kv_audit_violations"):
            assert got[side][key] == ref[side][key], (side, key)
    assert got["shared"]["prefix_hits"] >= 4 * (32 // 8)
    assert got["shared"]["extra_kv_blocks_per_request"] <= 1
    assert got["shared"]["kv_audit_violations"] == got["reprefill"]["kv_audit_violations"] == 0
    for key in ("requests", "sys_len", "tail_len", "max_new", "block_size",
                "shared_prefix_blocks"):
        assert got[key] == ref[key], key


def test_speculative_bench_fixture(jax_serve_bench):
    """The identity-extended fixture (here 2x llama-tiny): the same keys
    and depths, acceptance at least 0.5 on both, no audit violation."""
    kw = dict(requests=2, prompt_len=8, max_new=8, spec_k=3, target_layers_mult=2,
              block_size=8, best_of=1)
    ref = jax_serve_bench.run_speculative_bench(**kw)
    got = tsb.run_speculative_bench(platform="cpu", **kw)
    assert got.keys() == ref.keys()
    for key in ("requests", "prompt_len", "max_new", "spec_k", "target_layers",
                "draft_layers"):
        assert got[key] == ref[key], key
    assert (got["target_layers"], got["draft_layers"]) == (4, 2)
    assert got["acceptance_rate"] >= 0.5 and ref["acceptance_rate"] >= 0.5
    assert got["kv_audit_violations"] == ref["kv_audit_violations"] == 0


def test_serve_bench_cli_line(capsys, tmp_path):
    """The CLI's line: the sweep's keys, ``host``, and a copy at ``--out``."""
    out = tmp_path / "sub" / "line.json"
    assert tsb.main(["--platform", "cpu", "--requests", "2", "--max-new", "2",
                     "--sweep", "1,2", "--out", str(out)]) == 0
    line = _json_lines(capsys.readouterr().out)[-1]
    assert set(line) == {"kind", "model", "platform", "rows", "batched_vs_sequential",
                         "host"}
    assert json.loads(out.read_text()) == line


# -- scripts/perf_exp.py ----------------------------------------------------

#: scripts/perf_exp.py:96-104
PERF_EXP_KEYS = ["model", "batch", "seq", "remat", "mu_bf16", "nu_bf16", "grad_bf16",
                 "chunk", "micro", "tokens_per_sec_per_chip", "step_time_ms", "mfu"]


def test_perf_exp_line_and_flags(capsys):
    assert tperf.main(["llama-tiny", "4", "32", "attn_qkv", "2", "--platform", "cpu",
                       "--micro", "2", "--mu-bf16", "--chunk", "64", "--block", "16",
                       "--bk-bwd", "16"]) == 0
    line = _json_lines(capsys.readouterr().out)[-1]
    assert list(line) == PERF_EXP_KEYS
    assert (line["model"], line["batch"], line["seq"], line["remat"]) == (
        "llama-tiny", 4, 32, "attn_qkv")
    assert (line["mu_bf16"], line["nu_bf16"], line["chunk"], line["micro"]) == (
        True, False, 64, 2)
    assert line["tokens_per_sec_per_chip"] > 0


def test_perf_exp_profile_writes_a_chrome_trace(tmp_path):
    line = tperf.run_perf_exp("llama-tiny", 2, 32, "none", profile_dir=str(tmp_path / "p"),
                              platform="cpu")
    assert list(line) == PERF_EXP_KEYS
    trace = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert trace["traceEvents"]


# -- scripts/ring_bench.py --------------------------------------------------

RING_SEQ, RING_CP = 2048, 4
RING_TOL = 1e-5  # of the output's largest element


def _ring_inputs() -> tuple:
    rng = np.random.default_rng(0)
    shape = (trb.BATCH, trb.HEADS, RING_SEQ, trb.HEAD_DIM)
    return tuple((rng.standard_normal(shape) * 0.1).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def jax_ring_bench():
    """The JAX script's ring and gather (``scripts/ring_bench.py:86-112``)
    on ``_ring_inputs`` over a ``{context: 4}`` mesh of 4 CPU devices, and
    the script's own line at seq 2048, cp 4."""
    import contextlib
    import functools
    import io

    from jax.sharding import PartitionSpec as P

    from polyaxon_tpu.ops import ring_attention
    from polyaxon_tpu.ops.flash_attention import _flash_fwd
    from polyaxon_tpu.parallel import build_mesh
    from polyaxon_tpu.parallel.compat import shard_map

    mesh = build_mesh({"context": RING_CP}, devices=jax.devices()[:RING_CP])
    spec = P(None, None, "context", None)
    block, s = trb.BLOCK, RING_SEQ
    on_mesh = functools.partial(shard_map, mesh=mesh, check_vma=False,
                                in_specs=(spec,) * 3, out_specs=spec)

    @on_mesh
    def ring(q, k, v):
        return ring_attention(q, k, v, axis_name="context", axis_size=RING_CP, causal=True,
                              block_q=block, block_k=block, interpret=True)

    @on_mesh
    def gather(q, k, v):
        kf = jax.lax.all_gather(k, "context", axis=2, tiled=True)
        vf = jax.lax.all_gather(v, "context", axis=2, tiled=True)
        bq, nq, sl, dq = q.shape
        my = jax.lax.axis_index("context")
        o, _ = _flash_fwd(q.reshape(bq * nq, sl, dq), kf.reshape(bq * nq, s, dq),
                          vf.reshape(bq * nq, s, dq), my * sl, 0, sm_scale=dq ** -0.5,
                          causal=True, block_q=block, block_k=block, interpret=True)
        return o.reshape(bq, nq, sl, dq).astype(q.dtype)

    qkv = [jax.numpy.asarray(a) for a in _ring_inputs()]
    outs = {"ring": np.asarray(jax.jit(ring)(*qkv)), "gather": np.asarray(jax.jit(gather)(*qkv))}
    script = _load("jax_ring_bench", ROOT / "scripts" / "ring_bench.py")
    argv, sys.argv = sys.argv, ["ring_bench.py", "--seq", str(RING_SEQ), "--cp", str(RING_CP)]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            script.main()
    finally:
        sys.argv = argv
    return outs, _json_lines(buf.getvalue())[-1]


@pytest.mark.parametrize("path", ["ring", "gather"])
def test_ring_bench_paths_match_the_jax_script(jax_ring_bench, path):
    outs, _ = jax_ring_bench
    q, k, v = (torch.from_numpy(a) for a in _ring_inputs())
    fn = trb.ring_forward if path == "ring" else trb.gather_forward
    got = fn(q, k, v, LoopbackRing(RING_CP)).numpy()
    want = outs[path]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RING_TOL * np.abs(want).max()


def test_ring_bench_line_has_the_jax_keys(jax_ring_bench):
    _, jline = jax_ring_bench
    (row,) = trb.run_ring_bench([RING_SEQ], RING_CP, platform="cpu", steps=1)
    renamed = {k.replace("v5e_", "h100_") for k in jline}
    assert set(row) == renamed | {"platform", "dtype", "ranks"}
    assert (row["platform"], row["dtype"], row["ranks"]) == ("cpu", "float32", 1)
    for key in ("seq", "cp", "b", "heads", "head_dim", "kv_resident_mb_ring",
                "kv_resident_mb_gather"):
        assert row[key] == jline[key], key
    assert row["ring_fwd_ms"] > 0 and row["gather_fwd_ms"] > 0


@pytest.mark.parametrize("seq,ratio", [(8192, 1.86), (16384, 3.73)])
def test_ring_bench_h100_columns_are_the_formula(seq, ratio):
    """llama-1b's ring step at the H100's data-sheet peaks: 4 x 32 heads x
    s_l^2 x 64 x 0.5 FLOPs at 989e12, 2 x 2 x 4 kv heads x s_l x 64 bytes at
    450e9 B/s, cp 8."""
    s_l = seq // 8
    compute = 4 * 32 * s_l * s_l * 64 * 0.5 / 989e12
    comm = 2 * 2 * 4 * s_l * 64 / 450e9
    got = trb.analytic(seq, 8)
    assert got["h100_step_compute_us_llama1b"] == pytest.approx(compute * 1e6, rel=1e-12)
    assert got["h100_step_comm_us_llama1b_gqa_compact"] == pytest.approx(comm * 1e6, rel=1e-12)
    assert got["h100_compute_over_comm"] == pytest.approx(compute / comm, rel=1e-12)
    assert round(got["h100_compute_over_comm"], 2) == ratio


def test_a_late_q_chunk_breaks_the_ring_bench_agreement(monkeypatch):
    """The gather path's first position placed one block late: the tool's
    agreement check fails (the sound paths pass it, above)."""
    offset = trb.gather_q_offset
    monkeypatch.setattr(trb, "gather_q_offset", lambda i, s_l: offset(i, s_l) + (
        trb.BLOCK if i == 0 else 0))
    q, k, v = (torch.from_numpy(a) for a in _ring_inputs())
    ring = LoopbackRing(RING_CP)
    worst = trb.agreement(trb.ring_forward(q, k, v, ring), trb.gather_forward(q, k, v, ring))
    assert worst > trb.AGREE_TOL[torch.float32]
    with pytest.raises(AssertionError, match="differs from the gather path"):
        trb.run_ring_bench([RING_SEQ], RING_CP, platform="cpu", steps=1)


def test_ring_bench_cp_must_be_the_world_size_under_a_group(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="--cp 4 differs from the 2 ranks"):
        trb.ring_of(4, torch.device("cpu"))


def test_pp_bench_alone_exits_naming_the_stage_ranks(monkeypatch):
    for name in ("PLX_NUM_PROCESSES", "PLX_PROCESS_ID", "PLX_COORDINATOR_ADDRESS",
                 "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit) as exc:
        tpp.main(["--platform", "cpu"])
    assert exc.value.code != 0 and "stage ranks" in str(exc.value.code)


# -- partition plan ---------------------------------------------------------

EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.yaml"))


def _jax_plan(path: Path, as_json: bool):
    from click.testing import CliRunner

    from polyaxon_tpu.cli.main import cli

    res = CliRunner().invoke(cli, ["partition", "plan", "-f", str(path),
                                   *(["--json"] if as_json else [])])
    return res.exit_code, res.output


def _compiled_spec(path: Path) -> tuple:
    """(the builtin dict a pod gets, the topology's flags): the runtime
    block with the run's parallelism and partition rules merged in."""
    from polyaxon_tpu.compiler import compile_operation
    from polyaxon_tpu.polyaxonfile import check_polyaxonfile

    run = compile_operation(check_polyaxonfile([str(path)])).run
    runtime = getattr(run, "runtime", None)
    if not isinstance(runtime, dict):
        return None, []
    builtin = dict(runtime)
    if getattr(run, "parallelism", None) and "parallelism" not in builtin:
        builtin["parallelism"] = run.parallelism.to_dict()
    if getattr(run, "partition_rules", None) and not builtin.get("partition_rules"):
        builtin["partition_rules"] = run.partition_rules
    flags = []
    if hasattr(run, "get_slice") and (getattr(run, "topology", None)
                                      or getattr(run, "slice_alias", None)):
        topo = run.get_slice()
        flags = ["--num-devices", str(topo.num_chips), "--num-slices", str(topo.num_slices)]
    return builtin, flags


@pytest.mark.parametrize("example", EXAMPLES)
def test_partition_plan_matches_the_jax_verb(example, tmp_path, capsys):
    """Every example the JAX verb plans: the same JSON and the same table;
    one it refuses (no builtin runtime) the port refuses too."""
    path = ROOT / "examples" / example
    code, ref_json = _jax_plan(path, as_json=True)
    builtin, flags = _compiled_spec(path)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(builtin))
    got = tpartition_cli.main(["plan", "--spec", str(spec), "--json", *flags])
    out = capsys.readouterr()
    if code:
        assert builtin is None and got == 1
        assert "needs a `runtime:` builtin-trainer block" in out.err
        return
    assert got == 0
    assert json.loads(out.out) == json.loads(ref_json)
    assert out.out == ref_json
    code, ref_text = _jax_plan(path, as_json=False)
    assert code == 0
    assert tpartition_cli.main(["plan", "--spec", str(spec), *flags]) == 0
    assert capsys.readouterr().out == ref_text


def test_partition_plan_reads_the_pod_env_and_keeps_the_audit(monkeypatch, capsys):
    """Without ``--spec`` the verb reads ``PLX_BUILTIN_SPEC``; the spec's
    ``num_slices`` wins over the flag; the audit's CLI is unchanged."""
    monkeypatch.setenv("PLX_BUILTIN_SPEC", json.dumps(
        {"model": "llama-tiny", "parallelism": {"fsdp": 2}, "num_slices": 2}))
    assert tpartition_cli.main(["plan", "--json", "--num-devices", "8",
                                "--num-slices", "4"]) == 0
    summary = json.loads(capsys.readouterr().out)["summary"]
    assert summary["num_slices"] == 2 and summary["axis_sizes"] == {"data": 4, "fsdp": 2}
    monkeypatch.delenv("PLX_BUILTIN_SPEC")
    assert tpartition_cli.main(["plan"]) == 2
    assert tpartition_cli.main(["llama-tiny"]) == 0
    assert "partition audit OK: 1 models" in capsys.readouterr().out


# -- the CLIs without CUDA --------------------------------------------------

CLIS = {
    "bench": (tbench.main, []),
    "bench-moe": (tbench.main, ["--moe"]),
    "bench-tokens": (tbench.main, ["--data", "tokens-file"]),
    "perf_exp": (tperf.main, ["llama-tiny", "4", "32", "none"]),
    "serve_bench": (tsb.main, ["--prefix-share", "--speculative"]),
    "ring_bench": (trb.main, []),
    "pp_bench": (tpp.main, []),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_a_cli_without_cuda_exits_naming_cuda(cli, monkeypatch):
    """No fallback to the CPU: without ``--platform cpu`` and with no
    usable CUDA device each CLI exits non-zero, naming CUDA, before it
    builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = CLIS[cli]
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code != 0 and "CUDA" in str(exc.value.code)


@pytest.mark.parametrize("main", [tbench.main, tsb.main], ids=["bench", "serve_bench"])
def test_orchestrated_is_refused(main, capsys):
    assert main(["--orchestrated"]) == 2
    assert "not ported" in capsys.readouterr().err
