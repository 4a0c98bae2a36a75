"""The CUDA kernels (paged decode; flash forward, dQ and dK/dV) against
their plain PyTorch versions, on the card. In bf16 the flash kernels are
the wgmma/TMA ones (tiles of 64 or 128 rows; dQ streams 128-key tiles at
D = 64, 64 at D = 128) and paged decode is split over CTAs of 256 tokens; in f32 they
are the CUDA-core ones (32-row tiles; one paged CTA per sequence and KV
head). Every test here needs a CUDA device (the kernels have no CPU build)
and skips without one; this file imports nothing of JAX, so it runs on a
machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, elementwise |out - ref| <= atol + rtol |ref|: both versions
compute in f32. In f32 they differ only in the order of the sums (1e-5).
In bf16 they split the softmax differently (each warp's 32-token tiles vs
whole blocks in order), so p is rounded to bf16 against other
running maxima (~1e-3 absolute at most on the output for unit-normal
inputs), and the output rounds to bf16 (one place is <= 2^-7 relative):
atol 3e-3, rtol 2^-6.
"""

from __future__ import annotations

import importlib
import math

import pytest
import torch

pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (3e-3, 2.0 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged-decode kernel has no "
                    "CPU build")
    return torch.device("cuda")


def _inputs(dev, dtype, b=5, kvh=2, g=4, d=64, bs=16, t=6, seed=0, lengths=None):
    """One row per length (by default a full table, 0, 1, one block and one
    past it) over disjoint blocks of a t-block table, except the last row,
    whose first two blocks are the first row's."""
    lengths = [t * bs, 0, 1, bs, bs + 1][:b] if lengths is None else lengths
    b = len(lengths)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = b * t + 1
    q = torch.randn(b, kvh, g, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(n, bs, kvh, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(n, bs, kvh, d, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(n - 1, generator=gen, device=dev)[:b * t]
    tables = tables.reshape(b, t).to(torch.int32)
    tables[b - 1, :2] = tables[0, :2]          # an aliased prefix
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, tables.contiguous(), lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_matches_plain(cuda, dtype, d):
    q, k, v, tables, lengths = _inputs(cuda, dtype, d=d)
    before = pa.launch_counts["paged_decode"]
    out = pa.paged_decode(q, k, v, tables, lengths)
    torch.cuda.synchronize()
    assert pa.launch_counts["paged_decode"] == before + 1
    ref = pa.paged_decode_plain(q, k, v, tables, lengths, sm_scale=d ** -0.5)
    assert out.dtype == dtype and out.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    assert out[1].abs().max().item() == 0.0          # length 0 -> zeros


@pytest.mark.cuda
def test_a_skipped_tile_fails_the_tolerance(cuda):
    # the check must see a walk that stops one 32-token tile short
    q, k, v, tables, lengths = _inputs(cuda, torch.bfloat16, d=64)
    short = lengths.clone()
    short[0] -= 32
    out = pa.paged_decode(q, k, v, tables, short)
    ref = pa.paged_decode_plain(q, k, v, tables, lengths, sm_scale=64 ** -0.5)
    atol, rtol = TOL[torch.bfloat16]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 8])
def test_kernel_query_groups_and_gather_path(cuda, g):
    q, k, v, tables, lengths = _inputs(cuda, torch.float32, g=g, seed=g)
    out = pa.paged_attention(q, k, v, tables, lengths, impl="flash")
    ref = pa.paged_attention(q, k, v, tables, lengths, impl="gather")
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def _assert_matches_plain(q, k, v, tables, lengths):
    out = pa.paged_decode(q, k, v, tables, lengths)
    torch.cuda.synchronize()
    ref = pa.paged_decode_plain(q, k, v, tables, lengths, sm_scale=q.shape[-1] ** -0.5)
    atol, rtol = TOL[q.dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("g", [1, 8])
def test_kernel_length_edges(cuda, dtype, d, bs, g):
    # a 768-token table (three splits in bf16): lengths 0 and 1, one block
    # and one past it, each split boundary and one either side, the
    # capacity, and a length past it (which attends over the capacity); the
    # last row aliases the first row's leading blocks
    t = 768 // bs
    cap, split = t * bs, pa.split_tokens()
    lengths = [cap, 0, 1, bs, bs + 1, split - 1, split, split + 1, 2 * split - 1,
               2 * split + 1, cap - 1, cap + 5, 200]
    out = _assert_matches_plain(*_inputs(cuda, dtype, g=g, d=d, bs=bs, t=t, seed=bs + g,
                                         lengths=lengths))
    assert out[1].abs().max().item() == 0.0          # length 0 -> zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_batch_of_empty_rows_gives_zeros(cuda, dtype):
    q, k, v, tables, lengths = _inputs(cuda, dtype, g=8, bs=128, t=4, lengths=[0, 0, 0])
    out = pa.paged_decode(q, k, v, tables, lengths)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_one_long_row(cuda, dtype, d):
    # B = 1: the whole 2048-token table, every split of it live
    t = 16
    q, k, v, tables, lengths = _inputs(cuda, dtype, g=8, d=d, bs=128, t=t, seed=d,
                                       lengths=[t * 128])
    _assert_matches_plain(q, k, v, tables, lengths)


@pytest.mark.cuda
def test_refused_arguments_raise(cuda):
    q, k, v, tables, lengths = _inputs(cuda, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode(q, k, v, tables.long(), lengths)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), tables, lengths)


# -- flash attention (forward, dQ, dK/dV) --------------------------------------

fa = importlib.import_module("polyaxon_tpu_torch.ops.flash_attention")
ta = importlib.import_module("polyaxon_tpu_torch.ops.attention")

# kernel vs plain, elementwise |out - ref| <= atol + rtol |ref|. f32: both
# f32, only the order of the sums and the online-softmax split differ (the
# kernel's 32-row tiles vs the plain version's blocks): 5e-5. bf16: p (and
# dS) are rounded to bf16 against other running maxima or other f32 sums in
# the two, and outputs round to bf16 (one place is <= 2^-7 relative): the
# paged kernel's 3e-3 + 2^-6 |ref|.
FLASH_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (3e-3, 2.0 ** -6)}
# the ring against one flash call: max |ring - single| over the largest
# |single| (see test_the_loopback_ring_matches_one_flash_call)
RING_TOL = {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6}


def _flash_inputs(dev, dtype, bh=3, sq=256, sk=256, d=64, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    return q, k, v, do


def _both_ways(q, k, v, do, qo, ko, causal, blocks=(128, 64), walk_cut=0, scale=None):
    """Every kernel output and its plain version on the same inputs (the
    plain forward at ``blocks``, the plain backward at them swapped)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kw = dict(sm_scale=scale, causal=causal)
    bq, bk = blocks
    o, lse = fa.flash_fwd_cuda(q, k, v, qo, ko, walk_cut=walk_cut, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, qo, ko, block_q=bq, block_k=bk, **kw)
    _, delta = fa.bwd_row_stats(o_p, lse_p, do)
    args = (q, k, v, do, lse_p, delta, qo, ko)
    dq = fa.flash_bwd_dq_cuda(*args, walk_cut=walk_cut, **kw)
    dk, dv = fa.flash_bwd_dkv_cuda(*args, walk_cut=walk_cut, **kw)
    dq_p = fa.flash_bwd_dq_plain(*args, block_q=bk, block_k=bq, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*args, block_q=bk, block_k=bq, **kw)
    torch.cuda.synchronize()
    return {"o": (o, o_p), "lse": (lse, lse_p), "dq": (dq, dq_p), "dk": (dk, dk_p),
            "dv": (dv, dv_p)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offsets", [(0, 0, True), (64, 0, True), (0, 128, True),
                                     (72, 0, True), (0, 0, False)])
@pytest.mark.parametrize("lengths", [
    (256, 256, (128, 64)),
    (200, 200, (40, 50)),     # no multiple of either tile: partial last tiles
    (96, 224, (32, 32)),      # sq != sk, both partial in bf16
    (127, 127, (127, 127)),   # one row short of the bf16 kernels' 128-row tiles
    (129, 129, (129, 43)),    # one row past them
    (383, 383, (383, 383)),   # three tiles, the last one row short
    (64, 64, (64, 32)),       # shorter than one 128-row tile
    (197, 197, (197, 197)),   # ViT-B/16's 196 patches + CLS: 128 + 69
])
def test_flash_kernels_match_plain(cuda, dtype, d, offsets, lengths):
    # (0, 128): the first 128 q rows see no key, O = 0 and LSE = -inf there;
    # (72, 0): a q offset that is no multiple of any tile. BH is 3, so a
    # tile that read past its head's end into the next head's rows would
    # show in the partial lengths (the kernels' TMA maps are [BH, S, D]).
    qo, ko, causal = offsets
    sq, sk, blocks = lengths
    q, k, v, do = _flash_inputs(cuda, dtype, sq=sq, sk=sk, d=d, seed=d)
    before = dict(fa.launch_counts)
    pairs = _both_ways(q, k, v, do, qo, ko, causal, blocks)
    assert all(fa.launch_counts[n] == before[n] + 1 for n in before)
    _assert_pairs_close(pairs, dtype)
    if ko > qo:
        assert pairs["o"][0][:, :ko - qo].abs().max().item() == 0.0


def _assert_pairs_close(pairs, dtype):
    atol, rtol = FLASH_TOL[dtype]
    for name, (out, ref) in pairs.items():
        if name == "lse":
            assert torch.equal(torch.isinf(out), torch.isinf(ref)), name
            out, ref = out.nan_to_num(neginf=0.0), ref.nan_to_num(neginf=0.0)
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5, msg=name)
            continue
        assert out.dtype == dtype, name
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [-0.125, 0.0, 0.125])
def test_flash_kernels_take_a_scale_of_either_sign(cuda, dtype, d, scale):
    # A negative scale makes a row's smallest raw score its largest scaled
    # one. Key 0 lies far out along one axis, so its score 2000 q[i, 0] is
    # exact in any order of summation, and it spreads many rows' scaled
    # scores past 2^7 in base 2: a softmax that took its reference from the
    # wrong end of the raw scores would overflow to inf in those rows.
    q, k, v, do = _flash_inputs(cuda, dtype, sq=200, sk=200, d=d, seed=5)
    k[:, 0] = 0.0
    k[:, 0, 0] = 2000.0
    spread = (2000.0 * q[..., 0].float()).abs() * abs(scale) * math.log2(math.e)
    assert scale == 0.0 or (spread > 2.0 ** 7).float().mean().item() > 0.25
    _assert_pairs_close(_both_ways(q, k, v, do, 0, 0, True, (40, 50), scale=scale), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_offset", [0, 72])
@pytest.mark.parametrize("length", [63, 64, 65, 127, 128, 129, 255, 256, 257])
def test_flash_tile_edges(cuda, d, q_offset, length):
    # the bf16 kernels' tiles: 128 q rows (the forward at D = 128), 64 q
    # rows (the forward at D = 64, dQ, dK/dV's streamed tiles), 128 keys
    # (the forward, dQ at D = 64, dK/dV) and 64 keys (dQ at D = 128): lengths
    # one short of, equal to and one past each, once and twice over
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, sq=length, sk=length, d=d,
                                seed=length + q_offset)
    pairs = _both_ways(q, k, v, do, q_offset, 0, True, (length, length))
    _assert_pairs_close(pairs, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_planted_faults_fail_the_tolerance(cuda, dtype):
    # walk_cut=1: the forward and dQ stop before the diagonal kv tile, dK/dV
    # starts one q tile late; the check must see each
    q, k, v, do = _flash_inputs(cuda, dtype, seed=3)
    pairs = _both_ways(q, k, v, do, 0, 0, True, walk_cut=1)
    atol, rtol = FLASH_TOL[dtype]
    for name in ("o", "dq", "dk", "dv"):
        out, ref = pairs[name]
        with pytest.raises(AssertionError):
            torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("s,block", [(128, 64), (200, 40)])
def test_flash_autograd_runs_the_kernels(cuda, s, block):
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, bh=2, sq=s, sk=s)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    o = fa.flash_attention_bhsd(*leaves, block_q=block, block_k=block)
    o.backward(do)
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    qc, kc, vc = (t.cpu() for t in (q, k, v))
    ref = [t.float().requires_grad_() for t in (qc, kc, vc)]
    o_ref = fa.flash_attention_bhsd(*ref, block_q=block, block_k=block)
    o_ref.backward(do.cpu().float())
    atol, rtol = (2e-2, 2.0 ** -5)  # bf16 kernel vs the f32 plain version
    torch.testing.assert_close(o.float().cpu(), o_ref.detach(), atol=atol, rtol=rtol)
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.dtype == torch.bfloat16
        torch.testing.assert_close(leaf.grad.float().cpu(), r.grad, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_flash_refused_arguments_raise(cuda):
    q, k, v, do = _flash_inputs(cuda, torch.float32, sq=96, sk=96, d=64)
    lse = torch.zeros(3, 95, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq_cuda(q, k, v, do, lse, lse, 0, 0, sm_scale=0.125, causal=True)
    q, k, v, _ = _flash_inputs(cuda, torch.float32, d=32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(q, k, v, 0, 0, sm_scale=0.125, causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd_cuda(q.half(), k.half(), v.half(), 0, 0, sm_scale=0.125, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s,block", [(128, 32), (160, 32), (200, 512)])
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.float32)])
def test_auto_follows_the_jax_rule_on_the_card(cuda, s, block, d, dtype):
    # flash wherever the JAX package's rule picks it, partial tiles included
    # (160 and 200 are no multiple of the 64-row bf16 tile)
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn(1, 2, s, d, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    fa.reset_launch_counts()
    out = ta.attention(q, k, v, impl="auto", block_q=block, block_k=block)
    assert fa.launch_counts["flash_fwd"] == 1
    ref = ta.dense_attention(q, k, v)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,error", [
    (32, torch.bfloat16, ValueError),    # no kernel for head dim 32
    (64, torch.float16, TypeError),      # no kernel for float16
])
def test_auto_raises_where_the_kernels_do_not_run(cuda, d, dtype, error):
    # a CUDA tensor never falls back to the plain or dense path
    q = torch.randn(1, 2, 128, d, device=cuda).to(dtype)
    with pytest.raises(error):
        ta.attention(q, q, q, impl="auto", block_q=32, block_k=32)


# -- speculative verify and checkpoints on the card -----------------------------


def _small_llama(dtype):
    """llama-tiny widened to a head dim the paged kernel takes (64)."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY

    return replace(REGISTRY["llama-tiny"][1], hidden=256, num_heads=4, num_kv_heads=2,
                   mlp_dim=512, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,impl", [(torch.float32, "gather"), (torch.float32, "flash"),
                                        (torch.bfloat16, "flash")])
def test_verify_step_matches_decode_step_on_the_card(cuda, dtype, impl):
    """verify_step's logits[:, j] against decode_step's (gather, or the
    paged kernel) at the same positions, on pools prefilled on the card.
    f32: the two differ in the order of their sums (1e-4 absolute on
    logits of ~0.3). bf16: each layer rounds its activations to bf16 after
    products of different shapes, 2^-5 of the largest logit."""
    from polyaxon_tpu_torch.models import transformer
    from polyaxon_tpu_torch.serve import model as tm
    from polyaxon_tpu_torch.serve.kv_cache import SequenceBlocks

    cfg = _small_llama(dtype)
    params = tm.serving_params(transformer.init(cfg, seed=0, device=cuda), cfg)
    bs, window = 16, 5
    prompts = [list(range(2, 2 + n)) for n in (7, 16, 33, 60)]
    t = -(-(max(map(len, prompts)) + window) // bs)
    cache = tm.init_cache(cfg, num_blocks=len(prompts) * t + 1, block_size=bs, device=cuda)
    seqs = []
    for p in prompts:
        seq = SequenceBlocks()
        cache.ensure(seq, len(p) + window)
        tm.prefill_chunk(params, torch.tensor([p], device=cuda), 0, len(p), cache.k, cache.v,
                         torch.as_tensor(cache.block_table_array([seq], t), device=cuda),
                         cfg=cfg)
        seqs.append(seq)
    tables = torch.as_tensor(cache.block_table_array(seqs + [None], t), device=cuda)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (5, window), generator=gen).to(cuda)
    positions = torch.tensor([len(p) for p in prompts] + [0], device=cuda)
    active = torch.tensor([True] * 4 + [False], device=cuda)
    k2, v2 = cache.k.clone(), cache.v.clone()
    verify = tm.verify_step(params, tokens, positions, cache.k, cache.v, tables, active,
                            cfg=cfg)
    for j in range(window):
        decode = tm.decode_step(params, tokens[:, j], positions + j, k2, v2, tables, active,
                                cfg=cfg, impl=impl)
        ref = decode[:4].float()
        atol = 1e-4 if dtype == torch.float32 else 2.0 ** -5 * ref.abs().max().item()
        torch.testing.assert_close(verify[:4, j], ref, atol=atol, rtol=0)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """An async save of CUDA tensors (f32 params, bf16 moments) restores bit
    for bit into CUDA tensors; a trainer resumes its state on the card."""
    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.partition.rules import tree_paths
    from polyaxon_tpu_torch.train import (
        DataConfig, OptimizerConfig, Trainer, TrainerConfig, make_batches,
    )
    from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from polyaxon_tpu_torch.train.trainer import state_tree

    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(64, 128, generator=gen, device=cuda)
    state = {"params": {"w": w}, "opt_state": {"count": 3, "mu": [w.to(torch.bfloat16)]},
             "step": 3}
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "ck"), async_save=True))
    assert ck.maybe_save(3, state, force=True)
    ck.wait()
    like = {"params": {"w": torch.zeros_like(w)},
            "opt_state": {"count": 0, "mu": [torch.zeros_like(w, dtype=torch.bfloat16)]},
            "step": 0}
    restored, step = ck.restore(like)
    assert step == 3 and restored["step"] == 3 and restored["opt_state"]["count"] == 3
    assert restored["params"]["w"].device == w.device
    assert torch.equal(restored["params"]["w"], w)
    assert torch.equal(restored["opt_state"]["mu"][0], w.to(torch.bfloat16))

    cfg = TrainerConfig(model=REGISTRY["llama-tiny"][1], batch_size=2, seq_len=32,
                        optimizer=OptimizerConfig(warmup_steps=1, total_steps=3,
                                                  mu_dtype="bfloat16"),
                        checkpoint=CheckpointConfig(directory=str(tmp_path / "run"),
                                                    save_interval_steps=1))
    data = DataConfig(batch_size=2, seq_len=32, vocab_size=256)
    final, _ = Trainer(cfg, device=cuda).fit(make_batches(data), num_steps=2)
    resumed, start = Trainer(cfg, device=cuda).restore_or_init()
    assert start == 2
    for (path, a), (_, b) in zip(tree_paths(state_tree(final)),
                                 tree_paths(state_tree(resumed))):
        if isinstance(a, torch.Tensor):
            assert b.device == a.device and torch.equal(a, b), path
        else:
            assert a == b, path


def _two_bert_steps(dev, parallelism):
    """Two bert-tiny training steps on ``dev`` from seed 0: (losses, grad
    norms, final params as one flat tensor)."""
    from polyaxon_tpu_torch.models import bert
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.parallel.mesh import BATCH_AXES, build_mesh
    from polyaxon_tpu_torch.train import (
        DataConfig, MLMTask, OptimizerConfig, Trainer, TrainerConfig, make_batches,
    )
    from polyaxon_tpu_torch.train.data import local_rows

    cfg = TrainerConfig(model=bert.BERT_TINY, batch_size=8, seq_len=32,
                        parallelism=parallelism, accelerator=None,
                        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                                  total_steps=2))
    mesh = build_mesh(parallelism)
    trainer = Trainer(cfg, device=dev, mesh=mesh, task=MLMTask(bert.BERT_TINY))
    rows = local_rows(8, 1, mesh.index(BATCH_AXES), mesh.axis_size(*BATCH_AXES))
    batches = make_batches(DataConfig(kind="synthetic-mlm", batch_size=8, seq_len=32,
                                      vocab_size=bert.BERT_TINY.vocab_size, rows=rows))
    state = trainer.init_state(seed=0)
    step = trainer.make_step()
    losses, norms = [], []
    for _ in range(2):
        state, m = step(state, next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    flat = torch.cat([t.detach().reshape(-1) for _, t in flatten(state.params)])
    return losses, norms, flat


@pytest.mark.cuda
@pytest.mark.parametrize("parallelism", [{"data": 1}, {"fsdp": 1}])
def test_a_one_rank_nccl_group_steps_as_no_group(cuda, parallelism):
    """bert-tiny's step under a 1-rank NCCL group (the mesh path: global
    MLM counts and metrics, grads summed over the group; under fsdp the
    per-layer gather and the reduce-scatter) equals the step without a
    group, bit for bit: on one rank every collective copies."""
    import socket

    dist = torch.distributed
    alone = _two_bert_steps(cuda, parallelism)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        grouped = _two_bert_steps(cuda, parallelism)
    finally:
        dist.destroy_process_group()
    assert grouped[0] == alone[0] and grouped[1] == alone[1]
    assert torch.equal(grouped[2], alone[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cp", [2, 4])
def test_the_loopback_ring_matches_one_flash_call(cuda, dtype, causal, cp):
    """Ring attention over a loopback ring of cp chunks (each visit B1-B3
    at its chunks' global offsets, compact GQA kv expanded per visit)
    against one flash call over the whole sequence, output and grads, each
    within RING_TOL of its largest element: the ring rounds each visit's
    partial output and grads to the dtype before its f32 merge, as the JAX
    ring does, and a partial's rounding can exceed the merged element it
    lands in, so the bound is normwise (chip_smoke.py's RING_TOL)."""
    from polyaxon_tpu_torch.ops.attention import repeat_kv
    from polyaxon_tpu_torch.ops.ring_attention import LoopbackRing, ring_attention

    gen = torch.Generator(device=cuda).manual_seed(cp)
    q, g = (torch.randn(2, 8, 512, 64, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(2, 2, 512, 64, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    ours = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.launch_counts)
    o = ring_attention(*ours, exchange=LoopbackRing(cp), causal=causal)
    o.backward(g)
    visits = cp * (cp + 1) // 2 if causal else cp * cp
    assert all(fa.launch_counts[n] == before[n] + visits for n in before)
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    kr, vr = repeat_kv(ref_in[1], 8), repeat_kv(ref_in[2], 8)
    ref = fa.flash_attention_bhsd(ref_in[0].reshape(16, 512, 64), kr.reshape(16, 512, 64),
                                  vr.reshape(16, 512, 64), causal=causal)
    ref.backward(g.reshape(16, 512, 64))
    torch.cuda.synchronize()
    pairs = [("o", o, ref.reshape(o.shape))] + [
        (name, a.grad, b.grad) for name, a, b in zip(("dq", "dk", "dv"), ours, ref_in)]
    for name, out, want in pairs:
        err = (out.float() - want.float()).abs().max().item()
        assert err <= RING_TOL[dtype] * want.float().abs().max().item(), (name, err)
