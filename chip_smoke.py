#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``polyaxon_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own; any failure exits
non-zero:

1. device — the card's name and power limit (nvidia-smi); CUDA required.
2. build  — nvcc builds the four kernel libraries from
   ``polyaxon_tpu_torch/csrc`` at once, one nvcc per source (seconds, and
   ptxas's register, spill and shared-memory report); then sass: the f32
   flash kernels' TF32 tensor-core instructions (``cuobjdump -sass``), which
   the split-TF32 forward, dQ and dK/dV must each issue.
3. kernel — the paged-decode kernels against their plain PyTorch version
   at the llama-1b serving shape (B=8, KVH=4, G=8, D=64, bs=128, T=16,
   ragged lengths incl. 0/1/127/128/129/2048, one table aliasing another
   row's leading blocks), and again at D=128, each in bf16 and f32: max
   abs error and its tolerance, the kernel's time (its launches captured
   in a CUDA graph and replayed, so that the wrapper's host work does not
   pace them; also as launched from the host), the plain version's time,
   one PyTorch call's time (scaled_dot_product_attention over the gathered
   cache, a yardstick the port never calls, timed both ways), the bound
   (live K/V bytes over 3.35 TB/s), the splits of the walk (bf16: CTAs of
   256 tokens and a combine kernel; f32: one cluster of CTAs a row and KV
   head) and the tokens a split takes, the previous f32 design's time
   (one CTA a row and KV head) as recorded, and the kernel's registers,
   shared memory per CTA, CTAs per SM and spills. Two planted faults (the
   long row's last tile skipped, one of its blocks read off by one) must
   fail the same check.
4. flash kernels — the forward, dQ and dK/dV kernels against their plain
   versions at the llama-1b training shape (BH = 2 x 32 heads, S = 2048,
   D = 64, causal) and at D = 128, in bf16 and f32, with cold L2, plus
   small cases with nonzero offsets, rows that see no key, and lengths
   (64, 129, 200, 383) that end in a partial tile, and in f32 lengths one
   row short of and past the split-TF32 kernels' tiles at D 64 and 128
   (F32_EDGE_SEQS), and the f32 forward at a near tie of two far keys
   (flash_near_tie): errors and tolerances,
   kernel, plain and library times (scaled_dot_product_attention with
   is_causal, and the median of five timings of its backward for dQ +
   dK/dV), the bounds (f32: split-TF32, three products at 495 TFLOP/s),
   the previous design's time beside each redesigned kernel's (bf16: wgmma
   and TMA; f32: split-TF32), and each kernel's
   registers, shared memory per CTA, CTAs per SM and spills. Three faults
   planted in the kernels (``walk_cut=1``: the forward and dQ stop before
   the diagonal kv tile, dK/dV starts one q tile late) must fail the same
   check. Then flash_f32_path: ``ops.attention.attention(impl="flash")``
   forward and backward in f32 at llama-1b's training attention (32 q
   heads over 4 kv heads, S 2048) at D 64 and 128, each kernel launched
   once (counts set to 0 before, read after), against dense attention.
5. flash_bidir — the three kernels non-causal in bf16 at the new
   families' shapes: BERT-base (BH = 16 x 12, S = 512) and ViT-B/16 (BH =
   32 x 12, S = 197 = 128 + 69, a partial last q and kv tile on every
   walk), against their plain versions, with cold-L2 kernel, plain and
   SDPA (is_causal=False) times and the bounds; ``walk_cut=1`` must fail
   the same check at both shapes. Then ring_kernels: ring attention
   (``ops/ring_attention.py``) over a loopback ring that holds every
   position in this process, in bf16 at llama-1b's training attention (2 x
   32 q heads over 4 kv heads, D 64, S 2048 as cp 4 chunks of 512,
   causal), llama2-7b's (32 heads, D 128, its max_seq 4096 as cp 2 chunks
   of 2048, causal) and BERT-base's (16 x 12 heads, S 512 over cp 2,
   non-causal): the ring's launches of B1-B3 equal its visits (cp(cp+1)/2
   causal, cp^2 not), its output and dQ/dK/dV equal one flash call over
   the whole sequence within RING_TOL, each visit's kernels equal their
   plain versions at the visit's global offsets, and a planted fault
   (k_offset + 1 on rank 0's diagonal visit when causal, the last rank's
   visit of chunk 0 dropped when not) must fail; the ring's fwd+bwd time
   against the single call's. Then ring_bench (slice 15):
   ``polyaxon_tpu_torch.scripts.ring_bench.run_ring_bench`` on a loopback
   ring of cp 8 in bf16 at seq 8192 and 16384, at the tool's 4 heads and at
   llama-1b's 32 q heads over 4 kv heads: its lines carry the JAX script's
   keys (``v5e_`` as ``h100_``, plus platform, dtype and ranks), its B1
   launches equal seqs x (1 + steps) x (36 visits + 8 gathered calls); per
   sequence one call of each path launches B1 36 and 8 times, the ring
   agrees with the gather path within RING_TOL normwise, the gather
   path's first q chunk placed one block late (a planted fault) must not,
   and each path's rise of ``max_memory_allocated`` and CUDA-event time
   are printed beside the tool's host-clock times. Then lm_loss: the LM
   loss's row kernel (``csrc/lm_loss.cu``) at the benchmark cells' chunk
   of 4,096 rows (GPT-2's 50,304 padded columns every row live, BERT's
   30,592 with its masked 15% live and with every row live) against its
   plain version, with kernel, plain and library (``F.cross_entropy``
   forward and backward) times beside the byte bound and the kernel's
   resources; and each cell's microbatch through the whole loss, forward
   and backward, fused (``lm_loss_from_hidden``) against the recomputed
   path it replaced: times, launches, the extra memory and the grads'
   normwise gaps.
6. serve — the port's ``build_engine`` at llama-1b full width (22 layers,
   hidden 2048, bf16, random init from seed 0) with the
   examples/llama1b_service.yaml runtime settings and attn_impl flash,
   served by the port's HTTP server on an ephemeral port: 8 concurrent
   greedy /generate requests (prompts of 100..1000 tokens, 64 new tokens
   each, two sharing a 256-token prefix). The paged kernel's launch count
   over that run must equal decode steps x 22. Then one decode_step with
   impl flash against impl gather on the same pools, and the time of a
   decode step on each path.
7. train — ``run_builtin`` (the port's builtin runtime) on llama-1b at full
   width with the examples/llama1b_tpujob.yaml runtime keys (steps cut from
   8 to 3): every loss finite, no anomaly, the step-0 loss near ln 32000,
   each flash kernel's launch count and the LM loss row kernel's (one a
   loss chunk of each microbatch) equal to their formulas; step time p50,
   tokens/s, MFU against 989 TFLOP/s, peak device memory. Then one
   microbatch (2 x 2048) at full depth, loss and grads with attn_impl flash
   against dense, which must agree; with each of the three planted faults
   in turn they must not.
7b. lora — train_lora: ``run_builtin`` with the train phase's
   keys plus examples/llama7b_import_lora.yaml's ``lora: {rank: 16, alpha:
   32, target: "attn/(wq|wk|wv|wo)$"}`` and its ``partition_rules:
   [["embed/tokens$", [null, "fsdp"]]]``, 3 steps: the train phase's checks
   (its flash launches: the base's attention runs as in full training),
   every base leaf bit-equal to the random init after the steps and every
   ``b`` moved off zero; step p50, MFU (the full model's FLOPs) and peak
   memory beside the train phase's. lora_compare: one microbatch (2 x
   2048) at full depth through ``LoRATask`` on the train phase's base:
   with b = 0 its loss is ``LMTask``'s bit for bit; with b random, flash
   against dense within the train phase's limits, and the three planted
   kernel faults outside them.
8. families — ``run_builtin`` with the runtime keys of
   examples/bert_tfjob.yaml (bert-base, seq 512, batch 64: 256 over 4
   workers), examples/vit_hyperband.yaml's trial (vit-b16, batch 128) and
   examples/resnet50_ddp.yaml (resnet50-cifar, 32 px, batch 256, sgd), one
   process each, 3 steps: losses finite, the step-0 loss within 0.5 of ln
   of the vocab or the classes, the flash launches equal their formula (12
   layers), step p50, samples/s, MFU and peak memory; ViT's and ResNet's
   accuracy in the final metrics and the host seconds per batch of their
   image stream, timed apart from the step; every ResNet batch statistic
   moves in one step. Then BERT's and ViT's one microbatch at full depth,
   flash against dense with the planted faults, within their own limits
   (FAMILY_COMPARE_TOL). Their profiles run with the others, last. Then
   train_gpt2: gpt2-345m at the benchmark cell's 64 x 1024 in 2
   microbatches, the same checks (the loss row kernel 16 launches a step,
   BERT's 8).
8b. moe (slice 10) — train_moe: ``run_builtin`` on llama-moe-1b at full
   width with bench.py's single-chip MoE recipe (32 x 2048 in 8
   microbatches, remat attn_qkv, flash blocks 1024, capacity dispatch
   streamed in cap blocks of 512, bf16 moments, grads and accumulator), 3
   steps: losses (step 0 within 0.5 of ln 32000), router_aux and
   router_drop_frac per step, step p50, tokens/s, MFU from the
   active-param flops per token, peak memory, flash launches equal to
   their formula (16 layers x 8 microbatches). moe_compare: one
   microbatch (4 x 2048, bf16) with capacity at ample capacity against
   the dense oracle, at cf 0.5 against the dense oracle with the plan's
   drops weighted zero (layer by layer, on the dense oracle's inputs of
   each layer), streamed against one-shot at cf 1.25, all-to-all
   at ``{expert: 1}`` against capacity (bit-equal) and one MoE layer's
   forward and backward twice (bit-equal); three planted faults (a slot
   off by one, the keep mask ignored, the combine's dw dropped) must
   break the compare. moe_parts: CUDA-event times of one MoE layer's
   pieces at that microbatch (router and plan, gathers, expert products,
   the MLP one-shot and streamed, a dense MLP of the same active width).
   pp_gate: layer 0 of llama-1b and of llama-moe-1b with ``active=False``
   emits exact zeros, with ``active=True`` the ungated body bit for bit.
9. spec — ``build_engine`` with the serve phase's settings plus
   ``speculative: {draft: llama-125m, k: 4}`` (both random-init), the same
   8 requests over HTTP: the paged kernel's launches must equal
   speculative iterations x (k+1) x 12 draft layers (the target never
   runs ``decode_step`` then), no KV audit violation; acceptance (near 0
   for two random models: nothing is claimed from it), tokens/s, the host
   clock of an iteration with every row running.
10. spec_accept — scripts/serve_bench.py's fixture at full width: a
   llama-1b draft (seed 0) and the same model plus 22 identity layers as
   the target. First ``verify_step``'s logits against ``decode_step``'s
   at the same positions (gather and flash, within the compare phase's
   0.125); then speculative and plain decode of the target for each impl:
   acceptance (at least 0.5 with gather), rows token-identical to plain
   decode, tokens/s of both, and the flash runs' launch counts.
11. restore — one llama-1b training step through the builtin runtime's
   trainer, the state (f32 params, bf16 AdamW moments, step) saved with
   the port's ``Checkpointer`` (one rank's file, its record and the index;
   bytes, seconds, GB/s beside the one-file layout's save) and restored into a
   fresh state, every leaf bit-equal; then one decode step's logits
   through ``build_engine``'s ``checkpoint:`` and, after
   ``export_hf_llama``, its ``import:`` must equal those of an engine on
   the in-memory params, bit for bit; import_lora: one ``run_builtin`` step
   from that export with ``lora:`` and one without, their step-0 losses
   bit-equal. The files go in a temporary directory that is removed after.
11b. sharded state — sharded_init, in this process with no group:
   mixtral-8x7b's blocks of ranks 0 and 63 of examples/mixtral_ep_tpujob.yaml's
   ``{expert: 8, fsdp: 8}`` (each block's bytes the plan's bytes per
   device, the rise of ``max_memory_allocated`` at most the block plus
   one slice plus SHARDED_INIT_SLACK, every slice distinct) and
   llama2-7b's eight ``{fsdp: 8}`` blocks, each bit-equal to its block of
   the whole ``{fsdp: 1}`` init; sharded_init_faults: a rank that builds
   its neighbour's coordinates and a slice seed without its indices must
   each fail that phase. train_7b_import_lora: a random-init llama2-7b
   exported in bf16 as hf-llama (a temporary directory, removed after),
   then ``run_builtin`` with examples/llama7b_import_lora.yaml's keys
   (IMPORT_7B_SPEC; IMPORT_7B_REDUCED lists the cuts): train_phase's
   checks (B1-B3 at D=128 launched as their formula says), the step-0 loss
   bit-equal to the import alone's first step, each import's rise within
   the bf16 base plus one layer; export and import seconds, step p50, MFU,
   peak memory.
12. bridge — the control-plane bridge, reporting to an in-process stdlib
   recorder of the API (``PLX_API_HOST``) with a temporary artifacts
   directory (removed after). bridge_train: the train phase's
   ``run_builtin`` with ``progress_interval`` and ``resources: {interval:
   1}``: the recorder must receive ``running`` then ``succeeded``,
   progress heartbeats carrying the step, outputs whose ``mfu`` and
   ``tokens_per_sec_per_chip`` equal the ``{"final"}`` summary; the run's
   events must hold ``gpu0_mem_gib``; the flash launches must still equal
   their formula; it prints the host seconds spent inside the bridge's
   callbacks per step. bridge_serve: ``start_replica`` with
   ``report_interval: 0.5`` and the watchdog on, 8 requests of 128 new
   tokens: heartbeats carry the ``serve`` payload, a
   ``serve-drain-0.json`` marker written while they decode flips /healthz
   to 503 and refuses a new request while they finish, removing it
   reopens admission, and the paged launches equal decode steps x 22.
13. dist — data and fsdp over ``torch.distributed``, each run in child
   processes of this script (``--dist-child``), so no process group
   outlives its phase. dist_env: the GPU count, NCCL's version, the
   cards' names and power limits. dist_train_1rank: bert-base (the
   bert_tfjob keys, 64 x 512, ``{data: 1}``), resnet50-cifar (the
   resnet50_ddp keys at one replica's 64, ``{data: 1}``) and llama-1b (the
   llama1b_tpujob keys, batch 16 in 4 microbatches, ``{fsdp: 1}``) and
   llama-1b-adafactor (the same keys with ``optimizer: adafactor``: its
   factor means and RMS sums run through NCCL), each twice without a
   group and once under a 1-rank NCCL group (the mesh path: global counts
   and metrics, all-reduced batch norms and grads; fsdp's per-layer gather
   and reduce-scatter around B1-B3): the group's losses must be bit-equal
   to the run without one, or within that run's spread against itself;
   step p50 and MFU with and without the group, peak memory, flash
   launches against their formula. dist_train_multi: with 2+ GPUs,
   min(GPUs, 4) ranks from the PLX_* env of bert-base ``{data: W}``,
   llama-1b and llama-1b-adafactor ``{fsdp: W}`` and resnet50-cifar
   ``{model: W}`` (its compute replicated) at the same global batch,
   step-0/1 losses against the 1-rank run's (DIST_MULTI_RTOL), and
   adafactor's factors after one step against one rank's
   (ADAFACTOR_DIGEST_RTOL); the same with adafactor factored by the
   rank's block shape (a planted fault) must fail; with one GPU it prints
   ``{"skipped": "1 GPU"}``. tp_cp_multi: with 2+ GPUs, W = min(GPUs, 4)
   ranks of llama-1b ``{model: W}`` and ``{context: W}`` (ring) at
   dist_train_1rank's llama-1b keys, their step-0/1 losses against its
   1-rank run's, llama-1b LoRA ``{model: W}`` against a one-rank LoRA run
   at those keys, llama-1b ``{model: W}`` with the example's
   ``embed/tokens$ -> [null, fsdp]`` rule against the 1-rank run (the
   token table it replicates bit-equal on every rank after a step; read
   unresharded, a planted fault, it must differ), and with 4 GPUs
   llama2-7b ``{fsdp: 2, model: 2}`` for two
   steps (the llama7b_tpujob keys at batch 4 in 2 microbatches; its state
   does not fit one card, so its step-0 loss is held within
   LLAMA7B_LOSS0_MARGIN of ln 32000), with peak memory per rank; with one
   GPU it prints ``{"skipped": "1 GPU"}``. pp_ep_multi: with 2+ GPUs two
   ranks of llama-1b ``{stage: 2}`` at dist_train_1rank's llama-1b keys
   (one row a pipeline microbatch), step-0/1 losses against its 1-rank
   run's (DIST_MULTI_RTOL); with 4 GPUs also llama-1b ``{stage: 2, model:
   2}`` (examples/llama_pp_tp.yaml's keys, 3 steps) and llama-moe-1b
   ``{stage: 2, expert: 2}`` with a2a, peak memory per rank; with one GPU
   ``{"skipped": "1 GPU"}``. ring_bench_multi: with 2+ GPUs
   scripts/ring_bench.py as W NCCL ranks (the largest power of two up to
   min(GPUs, 8)), its ring crossing NVLink, at both head counts, with each
   rank's peak memory; pp_bench_multi: scripts/pp_bench.py as 4 ranks
   (``{stage: 2, model: 2}``) with 4+ GPUs, else 2 (``{stage: 2}``), both
   gates' losses within 1e-6 and its lines' keys; with one GPU each prints
   ``{"skipped": "1 GPU"}``. dist_train_multi also runs llama2-7b ``{fsdp:
   W}`` (SHARD_7B_SPEC: examples/llama7b_tpujob.yaml's keys, 4 rows a
   rank): each rank's rise while it builds its blocks at full depth within
   the f32 params over W plus one slice plus SHARDED_INIT_SLACK; at
   SHARD_7B_LAYERS layers two steps saved at W restore at world 1 in this
   process with every rank's blocks bit-equal (sha256), that state saved
   at world 1 restores at W bit-equal, and with rank 1's file of the
   newest step left out (a planted fault) the restore walks back a step.
13b. tools — the port's measurement tools through their library calls.
   bench: ``polyaxon_tpu_torch.bench.run_bench`` at its one-GPU recipe
   (bench.py's: llama-1b, 64 x 2048 in 32 microbatches, remat attn_qkv,
   flash blocks 1024, bf16 moments, grads and accumulator), BENCH_STEPS
   steps; bench_moe: its ``--moe`` recipe (llama-moe-1b, 32 x 2048 in 8
   microbatches, capacity streamed in cap blocks of 512); bench_tokens:
   the dense recipe on ``--data tokens-file``'s 200 M-token uint16 corpus
   (written into a temporary directory, removed after), its tokens/s over
   bench's (reported, no limit). Each: the line parses with bench.py's
   keys and metric name, every loss is finite, the MFU is in (0, 1] and
   equals tokens/s/chip x flops per token / 989e12, and each flash
   kernel's launches equal ``flash_launch_formula``. serve_bench:
   ``polyaxon_tpu_torch.scripts.serve_bench`` with the paged kernel
   (attn_impl flash) — the sweep at llama-1b with block 128
   (examples/llama1b_service.yaml) over widths 1, 2, 4, 8 at the tool's
   16 requests of 24 + 32 tokens, prefix share at llama-1b
   (PREFIX_SHARE_REQUESTS requests of the tool's 1024-token system prompt,
   PREFIX_SHARE_BEST_OF repeat) and the tool's speculative fixture
   (llama-tiny against itself plus 31 x 2 identity layers, k 6), whose
   decode steps give the paged kernel f32 at D 16: before it runs,
   kernel_tiny holds the kernel against its plain version at that shape
   (TINY_KERNEL_SHAPE; phase 3's tolerance, planted faults, times and
   bound). Each
   result has scripts/serve_bench.py's keys, every sweep row's tokens are
   requests x max_new, the paged kernel runs in every sweep row and in both
   other benches, no KV audit violation, prefix hits at least requests x
   (sys_len // block) with at most one extra block a request, and
   acceptance at least ACCEPT_MIN. No timing ratio is a check.
14. profiles — ``torch.profiler``'s split of the compare phase's decode
   step per impl, of a training microbatch and the AdamW tail, and of a
   speculative iteration's draft steps against its verify step, then
   bridge_profile: ``run_builtin`` with ``profile: {steps: 1}`` must write
   a non-empty Chrome trace under ``outputs/profile`` and post its
   ``profile`` artifact. They run last: once the profiler has run, every
   later kernel launch in the process pays CUPTI's overhead, which would
   inflate the host-clock readings of the phases above. train_moe_profile
   splits a llama-moe-1b microbatch and its AdamW tail the same way (with
   the index and sort/scan kernels' shares); lora_profile sets a LoRA
   microbatch's device time, wall time and kernel launches beside a plain
   one's; flash_f32_split_profile reads the f32 backward's split pass
   beside the dQ and dK/dV kernels at BH 64, S 2048, D 64 and 128. Last,
   one step of each new family's trainer (BERT, ViT, ResNet) by kernel.
15. the ``{"kernels": [...]}`` line (each flash kernel's launches are the
   llama-1b train phase's; ``launches_by_path`` adds train_lora's, train_bert's,
   train_vit's, train_gpt2's, the 1-rank group runs' of dist_train_1rank, each
   ring_kernels case's, each ring_bench case's (B1's), train_moe's, moe_compare's,
   train_7b_import_lora's, bench's, bench_moe's and bench_tokens'; the
   paged kernel's ``launches_by_path`` holds the serve phase's and each
   serve_bench part's; ``paged_decode_f32`` is the f32 cluster walk, with
   the speculative fixture's launches beside kernel_tiny's error, times and
   bound, and phase 3's f32 rows at D 64 and 128; ``d128`` holds that D=128 path's launches
   beside the kernels' D=128 bf16 times, bounds and SDPA times; the
   ``*_f32`` entries are the f32 kernels, with flash_f32_path's launches
   and the D=64 and D=128 f32 rows' numbers), then the last line
   ``{"ok": true, "device": {...}}``. The ``lm_loss`` entry's launches are
   the llama-1b train phase's; its ``launches_by_path`` holds train_lora's,
   each family's and train_gpt2's, the 1-rank group runs', train_moe's,
   moe_compare's and train_7b_import_lora's, and ``per_step`` BERT's and
   GPT-2's launches a step.

Needs one card and the repository checkout around this file; imports
nothing of JAX.
"""

from __future__ import annotations

import functools
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 and TF32 on the tensor cores, f32
# on the CUDA cores. The f32 flash kernels' products run as split-TF32,
# three TF32 products each, so f32 flash work is bound at a third of the
# TF32 rate (a figure no f32 kernel can beat without dropping below f32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
SPLIT_TF32_PASSES = 3

KERNEL_SHAPE = dict(batch=8, kv_heads=4, groups=8, block_size=128, max_blocks=16,
                    long_row=5,                # the 2048-token row
                    alias=(7, 5, 4))           # row 7 reads row 5's first 4 blocks
KERNEL_LENGTHS = (0, 1, 127, 128, 129, 2048, 700, 1000)
# the decode shape of serve_bench's speculative fixture (its draft's decode
# steps, and plain decode of its target): llama-tiny, f32, KVH 2, G 2, D 16,
# 4 slots, block 16, 150 tokens of capacity (32 + 96 + k 6 + one block)
TINY_KERNEL_SHAPE = dict(batch=4, kv_heads=2, groups=2, block_size=16, max_blocks=10,
                         long_row=1, alias=(3, 1, 4))
TINY_KERNEL_LENGTHS = (0, 150, 33, 100)
TINY_HEAD_DIM = 16
# kernel vs plain version, held elementwise to |out - ref| <= atol + rtol|ref|.
# Both compute in f32. In f32 only the order of the sums differs (~1e-6
# relative). In bf16 the two split the softmax differently (each warp's
# 32-token tiles vs 128-token blocks in order), so p is rounded to bf16
# against another running max (<= 2^-9 relative per term, an absolute
# ~1e-3 at most on the output for unit-normal K/V), and the output rounds
# to bf16 (one place is <= 2^-7 relative): atol 3e-3 and rtol 2^-6 hold
# both with a factor of two.
KERNEL_TOL = {"bfloat16": (3e-3, 2.0 ** -6), "float32": (1e-5, 1e-5)}
# flash vs gather logits at llama-1b in bf16: flash rounds p to bf16 before
# p.V (as the TPU kernel does) and gather does not, and the difference
# travels 22 layers of bf16 activations. Logits reach about ±4, where
# bf16's last place is 1/64; 0.125 (8 such places) holds that drift while
# a wrong kernel (a lost mask, a wrong block) moves logits by O(1).
LOGIT_TOL = 0.125

SERVE_SPEC = {
    # examples/llama1b_service.yaml runtime, random init, on the card
    "model": "llama-1b", "init_seed": 0, "max_slots": 8, "block_size": 128,
    "max_seq_len": 2048, "prefill_chunk": 256, "attn_impl": "flash",
    "platform": "cuda", "warmup": True,
}
# -- flash attention (training) -------------------------------------------------

# the llama-1b training shape: microbatch 2 x 32 heads, seq 2048, head dim 64
FLASH_SHAPE = dict(bh=64, seq=2048)
FLASH_BLOCK = 1024   # the recipe's attn_block_q/k: the plain versions' blocks
# kernel vs plain, elementwise |out - ref| <= atol + rtol|ref|. f32: both
# compute in f32 and differ in the order of the sums and in how the online
# softmax is split (the kernel's tiles against 1024-row blocks), and the
# forward and dK/dV run each product as split-TF32 (~2^-22 of |A||B| a
# term): sums over up to 2048 keys keep that under 1e-5 relative, so 5e-5. bf16:
# p and dS are rounded to bf16 in both, but against other running maxima
# (forward) or after other f32 sums (backward), which moves a rounded term
# by up to one bf16 place (2^-8 relative), and outputs round to bf16: the
# paged kernel's 3e-3 + 2^-6 |ref|. LSE is f32 in both: 1e-4 absolute.
FLASH_TOL = {"bfloat16": (3e-3, 2.0 ** -6), "float32": (5e-5, 5e-5)}
LSE_TOL = (1e-4, 1e-5)
# the bf16 kernels' previous designs (flash: nvcuda::wmma tiles, scores and
# accumulators in shared memory, synchronous loads; paged decode: one CTA
# per sequence and KV head) are no longer built, so this run cannot time
# them: each one's time at D=64 bf16, from an earlier run of this script on
# an NVIDIA H100 80GB HBM3 (700 W) as PERF.md records it, stands in the
# redesigned kernel's log row as a recorded figure, never on the `kernels`
# line
PREV_MS_RECORDED = {"flash_fwd": 0.9156, "flash_bwd_dq": 1.0534, "flash_bwd_dkv": 2.2295,
                    "paged_decode": 0.0930}
# the same for the f32 kernels, whose CUDA-core designs gave way to
# split-TF32 ones: their D=64 f32 times as PERF.md records them
PREV_MS_RECORDED_F32 = {"flash_fwd": 7.244, "flash_bwd_dq": 11.14, "flash_bwd_dkv": 14.29}
# and the f32 paged walk's previous design (one CTA per sequence and KV
# head, CUDA cores), which gave way to the cluster walk: its times at the
# serving shape (D 64, 128) and at the speculative fixture's (D 16), host-
# launched and from a CUDA graph, as PERF.md records them
PREV_MS_RECORDED_PAGED_F32 = {
    (64, "serving"): {"ms": 0.1156, "ms_graph": 0.1140},
    (128, "serving"): {"ms": 0.1959, "ms_graph": 0.1938},
    (16, "tiny"): {"ms": 0.03179, "ms_graph": 0.007258},
}
# the f32 kernels' tiles (forward: 128 q rows and 64 keys at D 64, 64 and
# 32 at D 128; dK/dV: 64 keys and 64 q rows at D 64, 16 q rows at D 128;
# dQ: 64 q rows and 32 keys at D 64, 16 keys at D 128): small causal
# lengths one short of and one past them, per head dim
F32_EDGE_SEQS = {64: (31, 33, 63, 65, 127), 128: (15, 17, 31, 33, 63, 65)}
# SDPA's backward, the yardstick for dQ + dK/dV, moves from timing to
# timing: its median of this many
LIBRARY_BWD_TIMINGS = 5
# the non-causal shapes of the new training families, D = 64 bf16: BERT-base
# at seq 512 (12 heads, a batch of 16) and ViT-B/16 at 197 tokens (12 heads,
# a batch of 32), where 197 = 128 + 69 ends in a partial tile on every walk
BIDIR_CASES = {"bert-base": dict(batch=16, heads=12, seq=512),
               "vit-b16": dict(batch=32, heads=12, seq=197)}

# ring attention over a loopback ring (every position in this process), bf16:
# llama-1b's training attention (a microbatch of 2, 32 q heads over 4 kv
# heads, D 64, S 2048) as 4 chunks of 512; llama2-7b's (32 heads, D 128, its
# max_seq 4096, one row) as 2 chunks of 2048; BERT-base's (16 x 12 heads, S
# 512) over 2, non-causal
RING_CASES = {
    "llama-1b": dict(batch=2, heads=32, kv_heads=4, head_dim=64, seq=2048, cp=4,
                     causal=True),
    "llama2-7b": dict(batch=1, heads=32, kv_heads=32, head_dim=128, seq=4096, cp=2,
                      causal=True),
    "bert-base": dict(batch=16, heads=12, kv_heads=12, head_dim=64, seq=512, cp=2,
                      causal=False),
}
# the ring against one flash call over the whole sequence, per tensor
# max |ring - single| <= RING_TOL x max |single|: both run the same kernels,
# but the ring rounds each visit's partial output (and each visit's dQ, dK,
# dV, per q head) to bf16 before its f32 merge, as the JAX ring does, where
# the single call rounds once (and sums GQA's q-head copies of dK/dV in
# bf16). A partial's rounding is a bf16 place of the partial, which may be
# larger than the merged element it lands in, so the bound is normwise, not
# elementwise. On an NVIDIA H100 80GB HBM3 (700 W) the sound ring read
# 0.015-0.45 of 2^-6 (dK and dV the largest), the dropped visit 63 times it;
# k_offset + 1 on the last rank's diagonal visit read only 1.2-1.7 times it
# (its rows see 1024-4096 keys, one lost key moves them little), so the
# fault sits on rank 0's diagonal visit, whose first rows see a few keys:
# 90-91 times it. 2^-6 is a bf16 place or two of the largest element
RING_TOL = 2.0 ** -6
RING_TIMINGS = 5
# ring_bench (slice 15): scripts/ring_bench.py's loopback ring of cp 8 in
# bf16 over its default sequences, at the tool's own 4 heads and at
# llama-1b's 32 q heads over 4 kv heads (D 64, one row, blocks of 512)
RING_BENCH_SEQS = (8192, 16384)
RING_BENCH_CP = 8
RING_BENCH_STEPS = 3
RING_BENCH_CASES = {"tool": dict(heads=4, kv_heads=4),
                    "llama-1b": dict(heads=32, kv_heads=4)}
# the repository's scripts/ring_bench.py line (v5e_ as h100_) and the port's
# additions
RING_BENCH_KEYS = {"seq", "cp", "b", "heads", "head_dim", "ring_fwd_ms", "gather_fwd_ms",
                   "ring_over_gather", "kv_resident_mb_ring", "kv_resident_mb_gather",
                   "h100_step_compute_us_llama1b", "h100_step_comm_us_llama1b_gqa_compact",
                   "h100_compute_over_comm", "platform", "dtype", "ranks"}
# pp_bench_multi: scripts/pp_bench.py's lines, each gate's and the last
PP_BENCH_KEYS = ({"gate", "step_ms", "loss", "resolved_gate"},
                 {"gated_over_ungated", "bubble_fraction", "note", "mesh"})

TRAIN_SPEC = {
    # examples/llama1b_tpujob.yaml runtime, steps cut from 8 to 3, on the card
    "model": "llama-1b", "steps": 3, "batch_size": 64, "seq_len": 2048,
    "learning_rate": 3.0e-4, "warmup_steps": 5, "remat": "attn_qkv",
    "attn_block_q": 1024, "attn_block_k": 1024, "mu_dtype": "bfloat16",
    "nu_dtype": "bfloat16", "grad_dtype": "bfloat16", "microbatches": 32,
    "accum_dtype": "bfloat16", "loss_chunk_tokens": 4096, "checkpoint": False,
    "log_interval": 1, "data": {"kind": "synthetic-lm"}, "platform": "cuda",
}
# step-0 loss of a random init: the logits have std ~0.8 (lm-head std
# 0.0176 x sqrt(2048) over unit-RMS hidden states), which lifts the
# expected loss above ln 32000 = 10.37 by about var/2 = 0.32; 0.5 holds
# that, while a model that reads its inputs wrongly (NaN, a blown-up
# activation) lands far outside
LOSS0_MARGIN = 0.5
# flash vs dense at llama-1b on one microbatch, bf16 activations and grads:
# the kernels round p and dS to bf16 where dense keeps f32 probabilities
# (<= 2^-9 relative per term), and the difference travels 22 layers of
# bf16 activations. The limits sit between the sound readings and those of
# the planted faults (FLASH_FAULTS), which the train-compare phase measures
# in every run. On an H100 80GB HBM3 (700 W) it read: sound, loss 0.00021
# and worst grad 0.037 (layers/mlp/wg); the forward fault, loss 0.017 and
# grad 1.6 (wq); the dQ fault, grad 0.56 (wq); the dK/dV fault, grad 0.68
# (wv). The backward faults leave the loss as it is, so the grad limit
# must see them: each limit is about the geometric mean of the two sides.
TRAIN_LOSS_TOL = 0.002
TRAIN_GRAD_REL_TOL = 0.15
# leaves whose exact gradient is zero, left out of the grad compare: a key
# bias (BERT's, ViT's) shifts each query row's scores by one constant, which
# the softmax removes, so its computed grad is rounding noise (~1e-7 of the
# others) and its relative error between two roundings means nothing
ZERO_GRAD_LEAVES = ("attn/bk",)
# the faults a check must see, planted in the kernels with walk_cut=1: the
# launcher each is planted in
FLASH_FAULTS = {
    "fwd_drops_diagonal_tile": "flash_fwd_cuda",
    "dq_skips_diagonal_tile": "flash_bwd_dq_cuda",
    "dkv_starts_one_q_tile_late": "flash_bwd_dkv_cuda",
}
# -- LoRA: the train phase's recipe with
# examples/llama7b_import_lora.yaml's lora block and partition rule; the
# base is the train phase's random init (seed 0), frozen
LORA_KEYS = {"rank": 16, "alpha": 32, "target": "attn/(wq|wk|wv|wo)$"}
LORA_SPEC = {**TRAIN_SPEC, "lora": LORA_KEYS,
             "partition_rules": [["embed/tokens$", [None, "fsdp"]]]}
# lora_compare's random b: N(0, 1) x 0.02, so that scaling x a @ b (a at
# 0.02, rank 16) moves each merged weight by ~15% of its own scale
LORA_B_STD = 0.02
# import_lora: one step of the import with and without lora, at
# dist_train_1rank's llama-1b batch (16 in 4 microbatches)
IMPORT_LORA_KEYS = {"steps": 1, "log_interval": 1, "batch_size": 16, "microbatches": 4}

# -- the other training families (examples/bert_tfjob.yaml, vit_hyperband.yaml,
# resnet50_ddp.yaml) on one process: each recipe's runtime keys at its
# per-replica batch, steps cut to 3 (the first untimed), no checkpoints

BERT_SPEC = {
    # bert_tfjob.yaml: 256 over 4 workers -> 64 per process
    "model": "bert-base", "steps": 3, "batch_size": 64, "seq_len": 512,
    "learning_rate": 1.0e-4, "warmup_steps": 1000, "data": {"kind": "synthetic-mlm"},
    "checkpoint": False, "log_interval": 1, "platform": "cuda",
}
VIT_SPEC = {
    # vit_hyperband.yaml's trial at its default batch
    "model": "vit-b16", "steps": 3, "batch_size": 128, "learning_rate": 1.0e-3,
    "data": {"kind": "synthetic-image"}, "checkpoint": False, "log_interval": 1,
    "platform": "cuda",
}
GPT2_SPEC = {
    # gpt2_mpijob.yaml's 64 x 1024 a card in 2 microbatches, as the
    # benchmark's gpt2-345m cell runs it (at 1 it runs out of memory)
    "model": "gpt2-345m", "steps": 3, "batch_size": 64, "seq_len": 1024,
    "microbatches": 2, "learning_rate": 3.0e-4, "data": {"kind": "synthetic-lm"},
    "checkpoint": False, "log_interval": 1, "platform": "cuda",
}
RESNET_SPEC = {
    # resnet50_ddp.yaml: its 256 on one process
    "model": "resnet50-cifar", "image_size": 32, "steps": 3, "batch_size": 256,
    "learning_rate": 0.1, "optimizer": "sgd", "data": {"kind": "synthetic-image"},
    "checkpoint": False, "log_interval": 1, "platform": "cuda",
}
# flash vs dense on one microbatch at full depth, f32 grads: (loss, worst
# per-leaf grad relative error) limits, each about the geometric mean of the
# sound reading and the nearest planted fault's. On an H100 80GB HBM3 (700
# W) they read: bert-base sound, loss 9.5e-5 and grad 0.029 (embed/tokens);
# the forward fault, loss 0.0014 and grad 1.16 (bv); the dQ fault, grad
# 0.35 (wq); the dK/dV fault, grad 0.36. vit-b16 sound, loss 4.8e-4 and
# grad 0.015 (patch/w); the forward fault, loss 0.0051 and grad 0.68 (wo);
# dQ, grad 0.53 (wq); dK/dV, grad 1.0 (bv). The backward faults leave the
# loss as it is, so the grad limit must see them.
FAMILY_COMPARE_TOL = {"bert-base": (3.5e-4, 0.10), "vit-b16": (1.5e-3, 0.09)}

# -- speculative decoding and checkpoints -------------------------------------------

SPEC_K = 4
# the production pairing examples/llama_tiny_speculative.yaml names, on the
# serve phase's settings: a llama-125m draft for the llama-1b target
SPEC_SPEC = {**SERVE_SPEC, "speculative": {"draft": "llama-125m", "k": SPEC_K}}
# spec_accept: scripts/serve_bench.py's fixture at full width, the target
# the draft plus as many identity layers again; a broken accept path reads
# an acceptance near 0 there
ACCEPT_EXTRA_LAYERS = 22
ACCEPT_MIN = 0.5
# training steps before the restore phase's save
RESTORE_STEPS = 1
# prefilled rows of the step-level checks (the compare phase's lengths)
VERIFY_LENGTHS = (1, 127, 128, 129, 300, 700, 1000, 1900)

PROMPT_LENGTHS = (100, 230, 400, 556, 700, 850, 930, 1000)
SHARED_PREFIX = 256          # tokens (two full 128-token blocks)
SHARED_ROWS = (2, 3)         # request 3 goes out after request 2's first token
MAX_NEW = 64


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -- phase 1 -----------------------------------------------------------------


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return smi.stdout.strip().splitlines()[0]


def build_phase(libs) -> None:
    """Build every kernel library at once (one nvcc per source), then load
    each; prints the seconds and ptxas's report."""
    t0 = time.monotonic()
    errors = []

    def build(lib):
        try:
            lib.build()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for lib in libs:
        lib.load()
    log("build", seconds=time.monotonic() - t0, libraries=[lib.path().name for lib in libs])
    for lib in libs:
        for line in lib.build_log.splitlines():
            if ("registers" in line or "Compiling entry" in line or "spill" in line
                    or "smem" in line or "warning" in line):
                print("  " + line.strip(), flush=True)


def sass_phase(fa) -> dict:
    """The f32 flash kernels' tensor-core instructions in the built
    libraries (``cuobjdump -sass``), per kernel and head dim: the
    split-TF32 forward, dQ and dK/dV must each issue HGMMA (wgmma) or HMMA
    (mma.sync) on TF32."""
    import re

    from polyaxon_tpu_torch.ops.cuda_build import _nvcc

    cuobjdump = str(Path(_nvcc()).parent / "cuobjdump")
    counts = {}
    for lib in (fa.FLASH_FWD_LIB, fa.FLASH_BWD_LIB):
        sass = subprocess.run([cuobjdump, "-sass", str(lib.path())], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        kernel = None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(r"\d(flash_\w+?_kernel)ILi(\d+)", line)
                kernel = f"{m.group(1)}/d{m.group(2)}" if m else None
                if kernel:
                    counts.setdefault(kernel, {"hgmma_tf32": 0, "hmma_tf32": 0})
            elif kernel and "TF32" in line:
                for op in ("HGMMA", "HMMA"):
                    if f"{op}." in line:
                        counts[kernel][f"{op.lower()}_tf32"] += 1
    for name in ("flash_fwd_tf32_kernel", "flash_bwd_dq_tf32_kernel",
                 "flash_bwd_dkv_tf32_kernel"):
        for head_dim in (64, 128):
            c = counts.get(f"{name}/d{head_dim}")
            if not c or not c["hgmma_tf32"] + c["hmma_tf32"]:
                raise AssertionError(f"{name} at D {head_dim} issues no TF32 tensor-core "
                                     f"instruction: {c}")
    return counts


# -- phase 3 helpers ----------------------------------------------------------


def kernel_inputs(torch, head_dim: int, dtype, seed: int = 0, s: dict = KERNEL_SHAPE,
                  lengths=KERNEL_LENGTHS):
    """q, pools, tables and lengths at a decode shape (the serving one by
    default), made from a seed on the card. Rows own disjoint blocks except
    the shape's alias row, whose leading blocks are its source row's."""
    b, kvh, g, bs, t = (s["batch"], s["kv_heads"], s["groups"],
                        s["block_size"], s["max_blocks"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = b * t + 1
    q = torch.randn(b, kvh, g, head_dim, generator=gen, device="cuda").to(dtype)
    k = torch.randn(n, bs, kvh, head_dim, generator=gen, device="cuda").to(dtype)
    v = torch.randn(n, bs, kvh, head_dim, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device="cuda")
    tables = perm[:b * t].reshape(b, t).to(torch.int32)
    row, src, blocks = s["alias"]
    tables[row, :blocks] = tables[src, :blocks]
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, tables.contiguous(), lengths


def live_kv_bytes(tables, lengths, block_size: int, row_bytes: int) -> int:
    """Bytes of the distinct K and V rows the lengths reach (an aliased
    block counts once)."""
    rows = set()
    for tbl, n in zip(tables.tolist(), lengths.tolist()):
        for p in range(n):
            rows.add((tbl[p // block_size], p % block_size))
    return 2 * len(rows) * row_bytes


def bound_ms(q, tables, lengths, head_dim: int, dtype_name: str,
             s: dict = KERNEL_SHAPE) -> tuple[float, str]:
    esize = q.element_size()
    kv = live_kv_bytes(tables, lengths, s["block_size"],
                       s["kv_heads"] * head_dim * esize)
    io = 2 * q.numel() * esize + 4 * (tables.numel() + lengths.numel())
    tokens = int(lengths.clamp(max=s["max_blocks"] * s["block_size"]).sum())
    flops = 4.0 * tokens * s["kv_heads"] * s["groups"] * head_dim
    t_bytes = (kv + io) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, args_list, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    through ``args_list`` (copies that together exceed the 50 MB L2, so
    every launch reads cold memory as a decode step does), after a warm-up
    pass over every copy."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(torch, fn, args_list, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches cycling
    through ``args_list`` as in time_ms, captured in one CUDA graph and
    replayed: the launches run back to back with no host work between
    them, so a kernel that is shorter than its wrapper's host work is timed
    by its own work (each kernel's launch within the graph included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture asks
        for args in args_list:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def worst_ratio(out, ref, tol) -> float:
    """max of |out - ref| / (atol + rtol |ref|): the check passes at <= 1."""
    atol, rtol = tol
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def planted_faults(pa, q, k, v, tables, lengths, ref, scale, tol, long_row: int) -> dict:
    """The kernel run on inputs that model two faults of the long row's
    walk, held against the true plain output by the same check: each must
    fail it (ratio > 1), or the check could not see such a fault."""
    skipped = lengths.clone()
    skipped[long_row] -= 32                       # its last 32-token tile
    shifted = tables.clone()
    shifted[long_row, 7] = tables[long_row, 8]    # block 7 read as block 8
    ratios = {
        "skipped_last_tile": worst_ratio(
            pa.paged_decode_cuda(q, k, v, tables, skipped, sm_scale=scale), ref, tol),
        "block_off_by_one": worst_ratio(
            pa.paged_decode_cuda(q, k, v, shifted, lengths, sm_scale=scale), ref, tol),
    }
    for fault, ratio in ratios.items():
        if not ratio > 1.0:
            raise AssertionError(f"planted fault {fault} passes the kernel check "
                                 f"(ratio {ratio}); the tolerance cannot see it")
    return ratios


def kernel_phase(torch, pa) -> list[dict]:
    results = []
    for head_dim in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            row = kernel_case(torch, pa, head_dim, dtype)
            log("kernel", **row)
            results.append(row)
    return results


def kernel_case(torch, pa, head_dim: int, dtype, s: dict = KERNEL_SHAPE,
                lengths=KERNEL_LENGTHS) -> dict:
    """The paged kernel against its plain version at one decode shape, the
    planted faults, the times and the bound."""
    import torch.nn.functional as F

    name = str(dtype).split(".")[1]
    q, k, v, tables, lengths = kernel_inputs(torch, head_dim, dtype, s=s,
                                             lengths=lengths)
    scale = head_dim ** -0.5
    before = pa.launch_counts["paged_decode"]
    out = pa.paged_decode_cuda(q, k, v, tables, lengths, sm_scale=scale)
    torch.cuda.synchronize()
    if pa.launch_counts["paged_decode"] != before + 1:
        raise AssertionError("the kernel wrapper did not count its launch")
    ref = pa.paged_decode_plain(q, k, v, tables, lengths, sm_scale=scale)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"non-finite kernel output at D={head_dim} {name}")
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("a length-0 row must come back as zeros")
    err = (out.float() - ref.float()).abs().max().item()
    tol = KERNEL_TOL[name]
    ratio = worst_ratio(out, ref, tol)
    if not ratio <= 1.0:
        raise AssertionError(
            f"kernel vs plain at D={head_dim} {name}: max abs err "
            f"{err}, {ratio} times the tolerance {tol}")
    faults = planted_faults(pa, q, k, v, tables, lengths, ref, scale, tol, s["long_row"])

    # cold-L2 timing over copies of the pools (and gathered caches)
    pair_bytes = 2 * k.numel() * k.element_size()
    copies = max(2, math.ceil(200e6 / pair_bytes))
    pools = [(q, k.clone(), v.clone(), tables, lengths) for _ in range(copies)]
    t = s["max_blocks"] * s["block_size"]
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]
    qh = q.reshape(s["batch"], s["kv_heads"] * s["groups"], 1, head_dim)
    gathered = [(qh, pa.gather_blocks(kk, tables).transpose(1, 2).contiguous(),
                 pa.gather_blocks(vv, tables).transpose(1, 2).contiguous(), mask)
                for _, kk, vv, _, _ in pools]
    kern = lambda *a: pa.paged_decode_cuda(*a, sm_scale=scale)  # noqa: E731
    plain = lambda *a: pa.paged_decode_plain(*a, sm_scale=scale)  # noqa: E731
    lib = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
        *a[:3], attn_mask=a[3], scale=scale, enable_gqa=True)
    # ms, plain_ms and library_ms are launched from the host, as in
    # every slice; a call this short is paced by its wrapper's host
    # work, so the log row adds both from a CUDA graph replay
    ms = time_ms(torch, kern, pools, 200)
    ms_graph = graph_time_ms(torch, kern, pools, 200)
    plain_ms = time_ms(torch, plain, pools, 20)
    library_ms = time_ms(torch, lib, gathered, 200)
    library_ms_graph = graph_time_ms(torch, lib, gathered, 200)
    b_ms, b_by = bound_ms(q, tables, lengths, head_dim, name, s)
    splits, split_tokens = pa.walk_split(dtype, s["max_blocks"], s["block_size"])
    row = {"head_dim": head_dim, "dtype": name, "max_abs_err": err,
           "atol": tol[0], "rtol": tol[1], "tol_ratio": ratio,
           "planted_fault_ratios": faults, "ms": ms, "ms_graph": ms_graph,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_ms_graph": library_ms_graph, "bound_ms": b_ms,
           "bound_us": b_ms * 1e3, "bound_by": b_by,
           "splits": splits, "split_tokens": split_tokens,
           **pa.kernel_resources(head_dim, dtype)}
    if (head_dim, name, s) == (64, "bfloat16", KERNEL_SHAPE):
        row["prev_ms_recorded"] = PREV_MS_RECORDED["paged_decode"]
    shape = "tiny" if s == TINY_KERNEL_SHAPE else "serving" if s == KERNEL_SHAPE else None
    if name == "float32" and (head_dim, shape) in PREV_MS_RECORDED_PAGED_F32:
        row["prev_ms_recorded"] = PREV_MS_RECORDED_PAGED_F32[(head_dim, shape)]
    del pools, gathered
    return row


# -- phase 4 -------------------------------------------------------------------


def make_prompts(vocab: int, seed: int = 0):
    """PROMPT_LENGTHS token prompts; the SHARED_ROWS pair starts with one
    SHARED_PREFIX-token prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    prompts = []
    for i, n in enumerate(PROMPT_LENGTHS):
        if i in SHARED_ROWS:
            prompts.append(prefix + rng.integers(0, vocab, n - SHARED_PREFIX).tolist())
        else:
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def _post(url: str, body: dict, timeout: float = 900.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def drive_requests(base: str, prompts: list, max_new: int,
                   shared_rows: tuple = SHARED_ROWS) -> list[dict]:
    """POST every prompt to /generate at once, greedy. The first of
    ``shared_rows`` streams, and the second goes out only after that
    stream's first token (its prompt's blocks are published by then).
    Returns one result body per prompt."""
    results: list = [None] * len(prompts)
    errors: list = []
    first_token = threading.Event()

    def whole(i):
        if i == shared_rows[1]:
            if not first_token.wait(900):
                raise TimeoutError("the first sharer never produced a token")
        with _post(base + "/generate", {"tokens": prompts[i],
                                        "max_new_tokens": max_new}) as r:
            results[i] = json.loads(r.read())

    def streamed(i):
        toks = []
        with _post(base + "/generate", {"tokens": prompts[i], "stream": True,
                                        "max_new_tokens": max_new}) as r:
            for line in r:
                msg = json.loads(line)
                if "token" in msg:
                    toks.append(msg["token"])
                    first_token.set()
                elif msg.get("done"):
                    if msg["tokens"] != toks:
                        raise AssertionError("stream lines disagree with the final body")
                    results[i] = msg
        first_token.set()

    def run(i):
        try:
            (streamed if i == shared_rows[0] else whole)(i)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append((i, e))
            first_token.set()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise RuntimeError(f"requests failed: {errors}")
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise TimeoutError("requests did not complete")
    return results


def wait_healthy(base: str, timeout: float = 600.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                if r.status == 200:
                    return
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
        except urllib.error.URLError:
            pass
        time.sleep(0.2)
    raise TimeoutError("/healthz never answered 200")


def serve_phase(torch, spec: dict, prompts: list, max_new: int) -> dict:
    """Build the engine, serve it, drive the requests; returns the
    measurements and leaves the engine (stopped) for the next phase."""
    from polyaxon_tpu_torch.serve.runtime import build_engine, warmup
    from polyaxon_tpu_torch.serve.server import build_server

    pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    t0 = time.monotonic()
    engine = build_engine(spec)
    build_s = time.monotonic() - t0
    engine.start()
    srv = build_server(engine, "127.0.0.1", 0, model_name=engine.model_name)
    http = threading.Thread(target=srv.serve_forever, daemon=True)
    http.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        warm = threading.Thread(target=warmup, args=(engine,), daemon=True)
        warm.start()
        wait_healthy(base)
        warm.join(timeout=600)
        if warm.is_alive():
            raise TimeoutError("warmup request did not finish")

        if engine.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
        steps0 = engine.decode_steps
        t1 = time.monotonic()
        results = drive_requests(base, prompts, max_new)
        wall_s = time.monotonic() - t1
        launches = pa.launch_counts["paged_decode"]
        steps = engine.decode_steps - steps0
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    vocab = engine.cfg.vocab_size
    for i, res in enumerate(results):
        toks = res["tokens"]
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"request {i} returned {len(toks)} tokens: {toks}")
    ttfts = sorted(r["ttft_ms"] for r in results)
    return {
        "engine": engine, "engine_build_s": build_s, "launches": launches,
        "decode_steps": steps, "wall_s": wall_s,
        "tokens_per_s": sum(len(r["tokens"]) for r in results) / wall_s,
        "ttft_p50_ms": ttfts[len(ttfts) // 2],
        "prefix_cache_hits": stats["prefix_cache_hits"],
        "kv_audit_violations": stats["kv_audit_violations"],
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if engine.device.type == "cuda" else None),
    }


def decode_setup(torch, engine, lengths=VERIFY_LENGTHS):
    """Prefill one row per length through the engine's own model code;
    returns (cache, step) where ``step(impl, k, v)`` runs one decode_step of
    every row on the pools ``k``, ``v`` (copies of the cache's)."""
    import numpy as np

    from polyaxon_tpu_torch.serve.model import decode_step

    cfg, dev = engine.cfg, engine.device
    rng = np.random.default_rng(1)
    cache, tables = prefilled_rows(torch, engine.params, cfg, dev, lengths,
                                   engine.block_size, engine.max_blocks_per_seq,
                                   engine.prefill_chunk, rng)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, len(lengths)), device=dev)
    positions = torch.as_tensor(lengths, device=dev)
    active = torch.ones(len(lengths), dtype=torch.bool, device=dev)

    def step(impl, k, v):
        return decode_step(engine.params, tokens, positions, k, v, tables, active,
                           cfg=cfg, impl=impl)

    return cache, step


def compare_phase(torch, engine, lengths=VERIFY_LENGTHS, timed_steps: int = 20) -> dict:
    """Prefill len(lengths) sequences through the engine's own model code,
    then run one decode_step with impl flash and one with impl gather on
    copies of the same pools; returns the max logit difference and, for
    each impl, the decode step's time (host clock over ``timed_steps``
    steps; its profile is decode_profile_phase's, at the end of the run)."""
    cache, step = decode_setup(torch, engine, lengths)
    dev = engine.device
    flash = step("flash", cache.k.clone(), cache.v.clone())
    gather = step("gather", cache.k.clone(), cache.v.clone())
    if not (torch.isfinite(flash).all() and torch.isfinite(gather).all()):
        raise AssertionError("non-finite decode logits")
    diff = (flash - gather).abs().max().item()
    if not diff <= LOGIT_TOL:
        raise AssertionError(f"flash vs gather logits differ by {diff} > {LOGIT_TOL}")
    out = {"max_logit_diff": diff, "logit_tol": LOGIT_TOL,
           "max_abs_logit": gather.abs().max().item(),
           "batch": len(lengths), "lengths": list(lengths)}
    k, v = cache.k.clone(), cache.v.clone()
    for impl in ("flash", "gather"):
        step(impl, k, v)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            logits = step(impl, k, v)
        logits.cpu()
        out[impl] = {"decode_step_ms": (time.perf_counter() - t0) * 1e3 / timed_steps}
    return out


def decode_profile_phase(torch, spec: dict) -> dict:
    """The compare phase's decode step (the serve phase's model, rebuilt
    from its seed) profiled per impl."""
    from polyaxon_tpu_torch.serve.runtime import build_engine

    engine = build_engine(spec)
    cache, step = decode_setup(torch, engine)
    k, v = cache.k.clone(), cache.v.clone()
    out = {}
    for impl in ("flash", "gather"):
        step(impl, k, v)
        out[impl] = profile_steps(torch, functools.partial(step, impl, k, v))
    return out


def prefilled_rows(torch, params, cfg, dev, lengths, block_size: int, max_blocks: int,
                   chunk: int, rng, room: int = 1):
    """A fresh paged cache holding one prefilled row per length (random
    tokens from ``rng``, in chunks as the engine prefills), each with
    blocks for ``room`` more tokens; returns (cache, tables)."""
    import numpy as np

    from polyaxon_tpu_torch.serve.kv_cache import SequenceBlocks
    from polyaxon_tpu_torch.serve.model import init_cache, prefill_chunk

    cache = init_cache(cfg, num_blocks=len(lengths) * max_blocks, block_size=block_size,
                       enable_prefix_cache=False, device=dev)
    seqs = []
    for n in lengths:
        seq = SequenceBlocks()
        cache.ensure(seq, n + room)
        tbl = torch.as_tensor(cache.block_table_array([seq], max_blocks), device=dev)
        toks = rng.integers(0, cfg.vocab_size, n)
        for lo in range(0, n, chunk):
            part = toks[lo:lo + chunk]
            padded = np.zeros((1, chunk), np.int64)
            padded[0, :len(part)] = part
            prefill_chunk(params, torch.as_tensor(padded, device=dev), lo,
                          len(part), cache.k, cache.v, tbl, cfg=cfg)
        seq.length = n
        seqs.append(seq)
    return cache, torch.as_tensor(cache.block_table_array(seqs, max_blocks), device=dev)


def profile_steps(torch, fn, steps: int = 3,
                  kernels: tuple = ("paged_decode", "paged_decode_combine")) -> dict:
    """Device time of ``steps`` calls of ``fn`` by kernel, from
    torch.profiler: the per-step device time, each named kernel's time and
    share of it (``name`` counts every ``name_*kernel`` of the port, so
    ``paged_decode`` holds the bf16 split and combine kernels together), the
    device's idle share of the wall time, and the largest kernels."""
    import re

    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(evt, attr, None) is not None:
                return float(getattr(evt, attr))
        return 0.0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: a CPU op's self device time repeats its kernels' time,
    # and so does a ``record_function`` range's row on the device (the
    # trainer's ``train.*`` ranges)
    rows = sorted(((e.key, device_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and device_us(e) > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    out = {
        "profiled_steps": steps,
        "device_ms_per_step": total / steps / 1e3,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_idle_share": (1.0 - total / wall_us) if total else None,
    }
    for name in kernels:
        named = re.compile(rf"\b{name}_(\w+_)?kernel[<(]")
        t = sum(r[1] for r in rows if named.search(r[0]))
        out[f"{name}_ms_per_step"] = t / steps / 1e3
        out[f"{name}_share"] = t / total if total else None
    # cuBLAS's kernels: gemm*, gemv*, cutlass*, sm90_xmma*, nvjet*
    gemm = sum(r[1] for r in rows
               if any(tag in r[0].lower() for tag in ("gemm", "cutlass", "xmma", "nvjet")))
    out["gemm_ms_per_step"] = gemm / steps / 1e3
    # indexing (the MoE gathers, the embedding), sorts and scans (the
    # router's top-k and the capacity plan)
    for cat, tags in (("index", ("index", "gather", "scatter")),
                      ("sort_scan", ("sort", "scan", "cumsum"))):
        t = sum(r[1] for r in rows if any(tag in r[0].lower() for tag in tags))
        out[f"{cat}_ms_per_step"] = t / steps / 1e3
    out["top_kernels"] = [{"name": k[:80], "ms_per_step": t / steps / 1e3,
                           "calls_per_step": c / steps} for k, t, c in rows[:8]]
    out["kernel_launches_per_step"] = sum(r[2] for r in rows) / steps
    return out


# -- phase 4: flash kernels ------------------------------------------------------


def flash_inputs(torch, bh: int, seq: int, head_dim: int, dtype, seed: int = 0):
    """q, k, v and dO [bh, seq, head_dim], unit normal, made from a seed on
    the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, seq, head_dim, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]


def flash_bounds(bh, sq, sk, d, esize, q_offset, k_offset, causal, dtype_name) -> dict:
    """Least time of each kernel on these inputs: the larger of its bytes
    (each input read once, each output written once) over 3.35 TB/s and
    its products' FLOPs over the dtype's peak (f32: split-TF32, three TF32
    products each). The FLOPs count the (q, k) pairs the causal mask leaves
    visible on these offsets."""
    if causal:
        pairs = sum(min(max(q_offset + i - k_offset + 1, 0), sk) for i in range(sq))
    else:
        pairs = sq * sk
    per_product = 2 * d * pairs * bh
    rows, keys, stats = bh * sq * d * esize, bh * sk * d * esize, bh * sq * 4
    work = {
        "flash_fwd": (2 * per_product, 2 * rows + 2 * keys + stats),
        "flash_bwd_dq": (3 * per_product, 3 * rows + 2 * keys + 2 * stats),
        "flash_bwd_dkv": (4 * per_product, 2 * rows + 4 * keys + 2 * stats),
    }
    peak = (PEAK_FLOPS["tf32"] / SPLIT_TF32_PASSES if dtype_name == "float32"
            else PEAK_FLOPS[dtype_name])
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return out


def adaptive_time_ms(torch, fn, args_list, budget_s: float = 0.3) -> float:
    """time_ms with as many launches as fit ``budget_s`` (3 to 200)."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args_list[0])
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    return time_ms(torch, fn, args_list, int(min(200, max(3, budget_s / once))))


def flash_check(torch, fa, q, k, v, do, q_offset, k_offset, causal, dtype_name) -> dict:
    """Each kernel against its plain version on the same inputs (the
    backward ones on the plain forward's LSE and delta). Raises when an
    output is non-finite or out of tolerance; returns each kernel's max abs
    error and worst ratio to the tolerance, and the plain outputs."""
    d = q.shape[-1]
    kw = dict(sm_scale=d ** -0.5, causal=causal)
    blocks = dict(block_q=min(FLASH_BLOCK, q.shape[1]), block_k=min(FLASH_BLOCK, k.shape[1]))
    o, lse = fa.flash_fwd_cuda(q, k, v, q_offset, k_offset, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, q_offset, k_offset, **kw, **blocks)
    _, delta = fa.bwd_row_stats(o_p, lse_p, do)
    args = (q, k, v, do, lse_p, delta, q_offset, k_offset)
    dq = fa.flash_bwd_dq_cuda(*args, **kw)
    dk, dv = fa.flash_bwd_dkv_cuda(*args, **kw)
    dq_p = fa.flash_bwd_dq_plain(*args, **kw, **blocks)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*args, **kw, **blocks)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype_name]
    for name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"non-finite {name} from the flash kernels ({dtype_name})")
    if not torch.equal(torch.isinf(lse), torch.isinf(lse_p)):
        raise AssertionError("the forward kernel's -inf LSE rows differ from the plain version's")
    lse_ratio = worst_ratio(lse.nan_to_num(neginf=0.0), lse_p.nan_to_num(neginf=0.0), LSE_TOL)
    err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    out = {
        "flash_fwd": (err(o, o_p), max(worst_ratio(o, o_p, tol), lse_ratio)),
        "flash_bwd_dq": (err(dq, dq_p), worst_ratio(dq, dq_p, tol)),
        "flash_bwd_dkv": (max(err(dk, dk_p), err(dv, dv_p)),
                          max(worst_ratio(dk, dk_p, tol), worst_ratio(dv, dv_p, tol))),
    }
    for name, (e, ratio) in out.items():
        if not ratio <= 1.0:
            raise AssertionError(f"{name} vs plain ({dtype_name}, offsets {q_offset}/"
                                 f"{k_offset}): max abs err {e}, {ratio} times the "
                                 f"tolerance {tol}")
    return {"checks": out, "refs": (o_p, dq_p, dk_p, dv_p), "row_stats": (lse_p, delta)}


def flash_planted_faults(torch, fa, q, k, v, do, checked, dtype_name,
                         causal: bool = True) -> dict:
    """The three faults planted in the kernels (walk_cut=1: the forward and
    dQ stop one kv tile short, before the diagonal when causal, before the
    end of the keys when not; dK/dV starts one q tile late), held against
    the true plain outputs by the same check: each must fail it (ratio >
    1)."""
    kw = dict(sm_scale=q.shape[-1] ** -0.5, causal=causal, walk_cut=1)
    o_p, dq_p, dk_p, dv_p = checked["refs"]
    lse_p, delta = checked["row_stats"]
    tol = FLASH_TOL[dtype_name]
    o_f, _ = fa.flash_fwd_cuda(q, k, v, 0, 0, **kw)
    dq_f = fa.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, 0, 0, **kw)
    dk_f, dv_f = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, 0, 0, **kw)
    ratios = {
        "fwd_drops_diagonal_tile": worst_ratio(o_f, o_p, tol),
        "dq_skips_diagonal_tile": worst_ratio(dq_f, dq_p, tol),
        "dkv_starts_one_q_tile_late": max(worst_ratio(dk_f, dk_p, tol),
                                          worst_ratio(dv_f, dv_p, tol)),
    }
    for fault, ratio in ratios.items():
        if not ratio > 1.0:
            raise AssertionError(f"planted fault {fault} passes the flash check "
                                 f"(ratio {ratio}); the tolerance cannot see it")
    return ratios


def flash_case(torch, fa, bh: int, seq: int, head_dim: int, dtype, causal: bool,
               heads: int, seed: int) -> dict:
    """One shape of the three kernels: each against its plain version and
    with its planted fault, then its time with cold L2, the plain version's
    time, SDPA's (forward, and the median of LIBRARY_BWD_TIMINGS timings of
    its backward, the yardstick for dQ + dK/dV), the bound and the
    kernel's resources. ``heads`` splits ``bh`` for SDPA's 4-D view."""
    import torch.nn.functional as F

    name = str(dtype).split(".")[1]
    q, k, v, do = flash_inputs(torch, bh, seq, head_dim, dtype, seed=seed)
    checked = flash_check(torch, fa, q, k, v, do, 0, 0, causal, name)
    faults = flash_planted_faults(torch, fa, q, k, v, do, checked, name, causal=causal)
    lse_p, delta = checked["row_stats"]
    scale = head_dim ** -0.5
    kw = dict(sm_scale=scale, causal=causal)
    blocks = dict(block_q=min(FLASH_BLOCK, seq), block_k=min(FLASH_BLOCK, seq))

    # cold L2: rotate through copies of the inputs
    one = 4 * q.numel() * q.element_size()
    copies = [[t.clone() for t in (q, k, v, do)] + [lse_p, delta]
              for _ in range(max(2, math.ceil(200e6 / one)))]
    fwd_args = [(c[0], c[1], c[2], 0, 0) for c in copies]
    bwd_args = [(c[0], c[1], c[2], c[3], c[4], c[5], 0, 0) for c in copies]
    ms = {
        "flash_fwd": adaptive_time_ms(
            torch, lambda *a: fa.flash_fwd_cuda(*a, **kw), fwd_args),
        "flash_bwd_dq": adaptive_time_ms(
            torch, lambda *a: fa.flash_bwd_dq_cuda(*a, **kw), bwd_args),
        "flash_bwd_dkv": adaptive_time_ms(
            torch, lambda *a: fa.flash_bwd_dkv_cuda(*a, **kw), bwd_args),
    }
    plain_ms = {
        "flash_fwd": time_ms(
            torch, lambda *a: fa.flash_fwd_plain(*a, **kw, **blocks), fwd_args, 3),
        "flash_bwd_dq": time_ms(
            torch, lambda *a: fa.flash_bwd_dq_plain(*a, **kw, **blocks), bwd_args, 3),
        "flash_bwd_dkv": time_ms(
            torch, lambda *a: fa.flash_bwd_dkv_plain(*a, **kw, **blocks), bwd_args, 3),
    }
    # the yardstick the port never calls: one SDPA call, and its backward
    # for dQ + dK/dV together
    as4 = lambda t: t.view(bh // heads, heads, seq, head_dim)  # noqa: E731
    lib_fwd = adaptive_time_ms(
        torch, lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=causal, scale=scale),
        [tuple(as4(t) for t in c[:3]) for c in copies])
    graphs = []
    for c in copies:
        leaves = [as4(t).detach().requires_grad_() for t in c[:3]]
        graphs.append((F.scaled_dot_product_attention(
            *leaves, is_causal=causal, scale=scale), *leaves, as4(c[3])))
    lib_bwd_all = sorted(adaptive_time_ms(
        torch, lambda out, a, b, c, g: torch.autograd.grad(
            out, (a, b, c), g, retain_graph=True), graphs)
        for _ in range(LIBRARY_BWD_TIMINGS))
    lib_bwd = lib_bwd_all[len(lib_bwd_all) // 2]
    bounds = flash_bounds(bh, seq, seq, head_dim, q.element_size(), 0, 0, causal, name)
    row = {"bh": bh, "seq": seq, "head_dim": head_dim, "dtype": name, "causal": causal,
           "atol": FLASH_TOL[name][0], "rtol": FLASH_TOL[name][1],
           "planted_fault_ratios": faults, "library_fwd_ms": lib_fwd,
           "library_bwd_ms": lib_bwd, "library_bwd_ms_all": lib_bwd_all}
    for kname, (e, ratio) in checked["checks"].items():
        row[kname] = {"max_abs_err": e, "tol_ratio": ratio, "ms": ms[kname],
                      "plain_ms": plain_ms[kname], "bound_ms": bounds[kname][0],
                      "bound_us": bounds[kname][0] * 1e3,
                      "bound_by": bounds[kname][1],
                      "library_ms": lib_fwd if kname == "flash_fwd" else lib_bwd,
                      **fa.kernel_resources(kname, head_dim, dtype)}
    del copies, graphs, fwd_args, bwd_args
    torch.cuda.empty_cache()
    return row


def flash_kernel_phase(torch, fa) -> list[dict]:
    results = []
    bh, seq = FLASH_SHAPE["bh"], FLASH_SHAPE["seq"]
    for head_dim in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            row = flash_case(torch, fa, bh, seq, head_dim, dtype, True, heads=32,
                             seed=head_dim)
            prev_recorded = {(64, "bfloat16"): PREV_MS_RECORDED,
                             (64, "float32"): PREV_MS_RECORDED_F32}
            for kname, prev in prev_recorded.get((head_dim, row["dtype"]), {}).items():
                if kname in row:
                    row[kname]["prev_ms_recorded"] = prev
            log("flash_kernel", **row)
            results.append(row)
    # small cases with nonzero offsets, one of them hiding the first rows'
    # every key (O = 0, LSE = -inf there), and lengths that end in a partial
    # tile in both dtypes (128- and 64-row tiles in bf16): 64 is shorter
    # than one bf16 tile, 129 and 383 one row past and short of one; then
    # F32_EDGE_SEQS in f32 at each head dim, once with a q offset of 72
    cases = [(dtype, 64, seq, q_offset, k_offset)
             for dtype in (torch.bfloat16, torch.float32)
             for seq, q_offset, k_offset in ((256, 64, 0), (256, 0, 128), (200, 0, 0),
                                             (200, 72, 0), (64, 0, 0), (129, 72, 0),
                                             (383, 0, 0))]
    cases += [(torch.float32, head_dim, seq, q_offset, 0)
              for head_dim, seqs in F32_EDGE_SEQS.items() for seq in seqs
              for q_offset in (0, 72)]
    for dtype, head_dim, seq, q_offset, k_offset in cases:
        name = str(dtype).split(".")[1]
        q, k, v, do = flash_inputs(torch, 4, seq, head_dim, dtype,
                                   seed=seq + q_offset + k_offset)
        checked = flash_check(torch, fa, q, k, v, do, q_offset, k_offset, True, name)
        log("flash_small", dtype=name, head_dim=head_dim, seq=seq, q_offset=q_offset,
            k_offset=k_offset, **{kname: {"max_abs_err": e, "tol_ratio": r}
                                  for kname, (e, r) in checked["checks"].items()})
    for head_dim in (64, 128):
        log("flash_near_tie", **flash_near_tie_check(torch, fa, head_dim))
    return results


def flash_near_tie_check(torch, fa, head_dim: int) -> dict:
    """The f32 forward at a near tie of two far keys: keys 0 and 1 at 2000
    along two axes, q[..., 1] = q[..., 0] + 0.002 noise and a scale of 1/8,
    so that the two share the rows' P with scaled scores in the hundreds and
    a score's error moves P's split between them. The forward's scores
    take Q in three parts; two parts miss f32 there (ROADMAP C10). O and
    LSE against the plain version within FLASH_TOL and LSE_TOL."""
    q, k, v, _ = flash_inputs(torch, 4, 256, head_dim, torch.float32, seed=head_dim + 3)
    gen = torch.Generator(device="cuda").manual_seed(head_dim + 4)
    k[:, :2] = 0.0
    k[:, 0, 0] = k[:, 1, 1] = 2000.0
    q[..., 1] = q[..., 0] + 0.002 * torch.randn(q.shape[:-1], generator=gen, device="cuda")
    kw = dict(sm_scale=0.125, causal=True)
    o, lse = fa.flash_fwd_cuda(q, k, v, 0, 0, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, 0, 0, **kw, block_q=256, block_k=256)
    torch.cuda.synchronize()
    ratios = {"o": worst_ratio(o, o_p, FLASH_TOL["float32"]),
              "lse": worst_ratio(lse, lse_p, LSE_TOL)}
    if not max(ratios.values()) <= 1.0:
        raise AssertionError(f"the f32 forward at a near tie (D {head_dim}): {ratios} times "
                             f"the tolerance")
    return {"head_dim": head_dim, "max_abs_err": (o - o_p).abs().max().item(),
            "tol_ratio": ratios}


def flash_f32_path_phase(torch, fa) -> dict:
    """The f32 kernels through the entry point a user calls:
    ``ops.attention.attention(impl="flash")`` forward and backward by
    autograd, at llama-1b's training attention (2 x 32 q heads over 4 kv
    heads, S 2048, causal) in f32 at D 64 and 128. Every count is set to 0
    before each run and read after it (one launch of each kernel), and the
    output and grads are held against dense attention's in f32 within
    FLASH_TOL."""
    from polyaxon_tpu_torch.ops.attention import attention, dense_attention

    out = {}
    for head_dim in (64, 128):
        gen = torch.Generator(device="cuda").manual_seed(head_dim + 1)
        shapes = [(2, 32, 2048, head_dim), (2, 4, 2048, head_dim), (2, 4, 2048, head_dim),
                  (2, 32, 2048, head_dim)]
        q, k, v, g = (torch.randn(s, generator=gen, device="cuda") for s in shapes)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        o = attention(*leaves, causal=True, impl="flash", block_q=FLASH_BLOCK,
                      block_k=FLASH_BLOCK)
        o.backward(g)
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        if launches != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
            raise AssertionError(f"f32 flash at D {head_dim} launched {launches}")
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        o_ref = dense_attention(*ref, causal=True)
        o_ref.backward(g)
        ratios = {"o": worst_ratio(o.detach(), o_ref.detach(), FLASH_TOL["float32"])}
        for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
            ratios[name] = worst_ratio(leaf.grad, r.grad, FLASH_TOL["float32"])
        if not max(ratios.values()) <= 1.0:
            raise AssertionError(f"f32 flash vs dense at D {head_dim}: {ratios} times "
                                 f"the tolerance {FLASH_TOL['float32']}")
        out[f"d{head_dim}"] = {"launches": launches, "tol_ratio_vs_dense": ratios}
        del q, k, v, g, leaves, ref, o, o_ref
        torch.cuda.empty_cache()
    return out


def flash_f32_split_profile_phase(torch, fa) -> dict:
    """The f32 backward kernels' split pass (``split_tf32*_kernel``), which
    each f32 dQ and dK/dV launch runs before its kernel: its device time
    and share beside the kernel's in a torch.profiler trace of three
    launches of each, at the flash_kernel phase's shape (BH 64, S 2048,
    causal) at D 64 and 128."""
    out = {}
    for head_dim in (64, 128):
        q, k, v, do = flash_inputs(torch, 64, 2048, head_dim, torch.float32, seed=head_dim)
        kw = dict(sm_scale=head_dim ** -0.5, causal=True)
        o, lse = fa.flash_fwd_cuda(q, k, v, 0, 0, **kw)
        args = (q, k, v, do, *fa.bwd_row_stats(o, lse, do), 0, 0)
        for kname, fn in (("flash_bwd_dq", fa.flash_bwd_dq_cuda),
                          ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda)):
            prof = profile_steps(torch, lambda: fn(*args, **kw), 3,
                                 kernels=("split_tf32", kname))
            out[f"{kname}_d{head_dim}"] = {
                "split_ms": prof["split_tf32_ms_per_step"],
                "kernel_ms": prof[f"{kname}_ms_per_step"],
                "split_share": prof["split_tf32_share"]}
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()
    return out


def flash_bidir_phase(torch, fa) -> list[dict]:
    """The three kernels non-causal at the new families' shapes (BIDIR_CASES):
    BERT-base's 512 keys and ViT-B/16's 197, whose last q and kv tiles are
    partial; each against its plain version and with walk_cut=1, which must
    fail there too."""
    rows = []
    for case, shape in BIDIR_CASES.items():
        row = flash_case(torch, fa, shape["batch"] * shape["heads"], shape["seq"], 64,
                         torch.bfloat16, False, heads=shape["heads"], seed=shape["seq"])
        row["case"] = case
        log("flash_bidir", **row)
        rows.append(row)
    return rows


def ring_case(torch, fa, ra, name: str, c: dict) -> dict:
    """One RING_CASES shape: the loopback ring's fwd+bwd against one flash
    call over the whole sequence and each visit's kernels against their
    plain versions, a planted fault, and both paths' times."""
    from polyaxon_tpu_torch.ops.attention import repeat_kv

    b, h, nk, d, seq, cp, causal = (c["batch"], c["heads"], c["kv_heads"], c["head_dim"],
                                    c["seq"], c["cp"], c["causal"])
    gen = torch.Generator(device="cuda").manual_seed(seq + cp)
    q, do = (torch.randn(b, h, seq, d, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, nk, seq, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    ring = ra.LoopbackRing(cp)

    def ring_run():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ra.ring_attention(*leaves, exchange=ring, causal=causal)
        o.backward(do)
        return [o.detach()] + [t.grad for t in leaves]

    def single_run():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        flat = lambda t: t.reshape(b * h, seq, d)  # noqa: E731
        o = fa.flash_attention_bhsd(flat(leaves[0]), flat(repeat_kv(leaves[1], h)),
                                    flat(repeat_kv(leaves[2], h)), causal=causal)
        o.backward(flat(do))
        return [o.detach().reshape(b, h, seq, d)] + [t.grad for t in leaves]

    visits = cp * (cp + 1) // 2 if causal else cp * cp
    fa.reset_launch_counts()
    got = ring_run()
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    if launches != {kname: visits for kname in launches}:
        raise AssertionError(f"ring {name}: launches {launches}, {visits} visits")
    want = single_run()
    names = ("o", "dq", "dk", "dv")
    ratios = {n: norm_ratio(x, y) for n, x, y in zip(names, got, want)}
    errors = {n: (x.float() - y.float()).abs().max().item()
              for n, x, y in zip(names, got, want)}
    for n in names:
        if not (torch.isfinite(got[names.index(n)].float()).all() and ratios[n] <= 1.0):
            raise AssertionError(f"ring {name}: {n} vs one flash call, max abs err "
                                 f"{errors[n]}, {ratios[n]} times RING_TOL {RING_TOL} of "
                                 f"its largest element")
    # each visit's kernels against their plain versions at its offsets
    s, group = seq // cp, h // nk
    chunk = lambda t, i: t[:, :, i * s:(i + 1) * s].reshape(-1, s, d).contiguous()  # noqa: E731
    visit_ratio = 0.0
    for my in range(cp):
        for src in range(cp):
            if not ra._visit_pred(causal, src, my):
                continue
            checked = flash_check(
                torch, fa, chunk(q, my), ra._expand_kv(chunk(k, src), group),
                ra._expand_kv(chunk(v, src), group), chunk(do, my), my * s, src * s,
                causal, "bfloat16")
            visit_ratio = max(visit_ratio, *(r for _, r in checked["checks"].values()))
    # the planted fault, through the ring module's own references
    fwd, bwd, pred = ra._flash_fwd, ra._flash_bwd, ra._visit_pred
    if causal:
        # rank 0's diagonal visit: its rows see the fewest keys, so one key
        # lost to the shifted mask moves them most
        fault = "k_offset + 1 on rank 0's diagonal visit"
        shift = lambda qo, ko: ko + 1 if qo == ko == 0 else ko  # noqa: E731
        ra._flash_fwd = lambda q_, k_, v_, qo, ko, **kw: fwd(q_, k_, v_, qo, shift(qo, ko), **kw)
        ra._flash_bwd = lambda q_, k_, v_, o_, l_, d_, qo, ko, **kw: bwd(
            q_, k_, v_, o_, l_, d_, qo, shift(qo, ko), **kw)
    else:
        fault = "the last rank's visit of chunk 0 dropped"
        ra._visit_pred = lambda c_, src, my: pred(c_, src, my) and not (
            my == cp - 1 and src == 0)
    try:
        faulty = ring_run()
    finally:
        ra._flash_fwd, ra._flash_bwd, ra._visit_pred = fwd, bwd, pred
    fault_ratio = max(norm_ratio(x, y) for x, y in zip(faulty, want))
    if not fault_ratio > 1.0:
        raise AssertionError(f"ring {name}: the planted fault ({fault}) passes the "
                             f"check (ratio {fault_ratio})")
    ring_ms = fwd_bwd_ms(torch, ring_run)
    single_ms = fwd_bwd_ms(torch, single_run)
    del got, want, faulty
    torch.cuda.empty_cache()
    return {**c, "visits": visits, "launches": launches, "max_abs_err": errors,
            "tol_ratio": ratios, "rel_tol_of_max": RING_TOL,
            "visit_vs_plain_worst_ratio": visit_ratio, "planted_fault": fault,
            "planted_fault_ratio": fault_ratio, "ring_fwd_bwd_ms": ring_ms,
            "single_fwd_bwd_ms": single_ms, "ring_over_single": ring_ms / single_ms}


def norm_ratio(out, ref) -> float:
    """max |out - ref| / (RING_TOL max |ref|): the ring check passes at <= 1."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / (RING_TOL * ref.abs().max())).item()


def fwd_bwd_ms(torch, fn, iters: int = RING_TIMINGS) -> float:
    """Mean device time of ``fn()`` (a forward and a backward) over
    ``iters`` runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ring_phase(torch, fa) -> dict:
    """Every RING_CASES shape through ring_case; returns the rows by name."""
    ra = importlib.import_module("polyaxon_tpu_torch.ops.ring_attention")
    rows = {}
    for name, c in RING_CASES.items():
        rows[name] = ring_case(torch, fa, ra, name, c)
        log("ring_kernels", case=name, **rows[name])
    return rows


def ring_bench_case(torch, fa, rb, name: str, c: dict) -> dict:
    """One RING_BENCH_CASES head count through scripts/ring_bench.py's
    library call (the launches of B1 it makes are the path's), then per
    sequence: one call of each path (B1's launches a call: the visits
    cp(cp+1)/2 on the ring, cp on the gather path), the rise of
    ``max_memory_allocated`` over each, ring against gather within
    RING_TOL normwise, a planted fault (the gather path's first q chunk
    one block late) that must fail it, and each path's CUDA-event time."""
    from polyaxon_tpu_torch.ops.ring_attention import LoopbackRing

    cp, steps = RING_BENCH_CP, RING_BENCH_STEPS
    visits = cp * (cp + 1) // 2
    fa.reset_launch_counts()
    rows = rb.run_ring_bench(RING_BENCH_SEQS, cp, platform="cuda", steps=steps, **c)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    want = len(RING_BENCH_SEQS) * (1 + steps) * (visits + cp)
    if launches != {"flash_fwd": want, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise AssertionError(f"ring_bench {name}: launches {launches}, want {want} of "
                             f"flash_fwd ({len(RING_BENCH_SEQS)} seqs x {1 + steps} calls x "
                             f"({visits} visits + {cp} gathered calls))")
    for row in rows:
        check_keys(f"ring_bench {name}", row, RING_BENCH_KEYS)
        if (row["platform"], row["dtype"], row["ranks"]) != ("cuda", "bfloat16", 1):
            raise AssertionError(f"ring_bench {name}: {row}")
    ring = LoopbackRing(cp)
    seqs = {}
    for seq in RING_BENCH_SEQS:
        q, k, v = rb.make_inputs(seq, batch=rb.BATCH, kv_heads=c["kv_heads"],
                                 heads=c["heads"], head_dim=rb.HEAD_DIM,
                                 dtype=torch.bfloat16, device="cuda")
        paths = {"ring": lambda: rb.ring_forward(q, k, v, ring),
                 "gather": lambda: rb.gather_forward(q, k, v, ring)}
        got, per_call, rise = {}, {}, {}
        for path, fn in paths.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            got[path] = fn()
            torch.cuda.synchronize()
            per_call[path] = fa.launch_counts["flash_fwd"]
            rise[path] = (torch.cuda.max_memory_allocated() - base) / 2**20
        if per_call != {"ring": visits, "gather": cp}:
            raise AssertionError(f"ring_bench {name} seq {seq}: B1 launches a call "
                                 f"{per_call}, want ring {visits}, gather {cp}")
        ratio = norm_ratio(got["ring"], got["gather"])
        if not (torch.isfinite(got["ring"].float()).all() and ratio <= 1.0):
            raise AssertionError(f"ring_bench {name} seq {seq}: ring vs gather "
                                 f"{ratio} times RING_TOL {RING_TOL} of the largest element")
        # the planted fault on position 0, whose first rows see a few keys:
        # one block more moves them far (a late last chunk, whose rows see
        # thousands, moves them little beside RING_TOL's normwise bound)
        offset, s_l = rb.gather_q_offset, seq // cp
        rb.gather_q_offset = lambda i, n: offset(i, n) + (rb.BLOCK if i == 0 else 0)
        try:
            fault_ratio = norm_ratio(got["ring"], rb.gather_forward(q, k, v, ring))
        finally:
            rb.gather_q_offset = offset
        if not fault_ratio > 1.0:
            raise AssertionError(f"ring_bench {name} seq {seq}: the gather path's first q "
                                 f"chunk one block late passes (ratio {fault_ratio})")
        seqs[seq] = {"s_l": s_l, "launches_per_call": per_call,
                     "mem_rise_mib": rise, "ring_vs_gather_tol_ratio": ratio,
                     "max_abs_err": (got["ring"].float() - got["gather"].float()).abs()
                     .max().item(),
                     "planted_fault_tol_ratio": fault_ratio,
                     "ring_event_ms": fwd_bwd_ms(torch, paths["ring"]),
                     "gather_event_ms": fwd_bwd_ms(torch, paths["gather"])}
        del q, k, v, got, paths
        torch.cuda.empty_cache()
    return {**c, "rows": rows, "launches": launches, "seqs": seqs}


def ring_bench_phase(torch, fa) -> dict:
    """Each RING_BENCH_CASES head count through ring_bench_case."""
    rb = importlib.import_module("polyaxon_tpu_torch.scripts.ring_bench")
    out = {}
    for name, c in RING_BENCH_CASES.items():
        t0 = time.monotonic()
        out[name] = ring_bench_case(torch, fa, rb, name, c)
        out[name]["seconds"] = time.monotonic() - t0
        log("ring_bench", case=name, **out[name])
    return out


# -- phase 5b: the LM loss ---------------------------------------------------------

# the benchmark cells' loss: a chunk of 4,096 rows of each head's padded
# logits (the kernel's shape), and a microbatch through the whole loss;
# ``live`` the share of rows the loss counts (BERT's masked 15%)
LM_LOSS_CASES = {
    "gpt2-345m": dict(vocab=50257, hidden=1024, batch=32, seq=1024, live=1.0),
    "bert-base": dict(vocab=30522, hidden=768, batch=64, seq=512, live=0.15),
}
LM_LOSS_ROWS = 4096
# kernel against plain: each row's loss, and the gradient within one bf16
# place (the tests' LM_LOSS_TOL)
LM_LOSS_TOL = (1e-6, 2.0 ** -7)
LM_LOSS_WHOLE_TIMINGS = 5


def lm_loss_rows_case(torch, ll, c: dict, live: float) -> dict:
    """The row kernel at one chunk: checked against its plain version,
    timed beside its byte bound, the plain version and ``F.cross_entropy``
    forward and backward over the same logits (``library_ms``)."""
    vocab, rows = c["vocab"], LM_LOSS_ROWS
    vp = ll.padded_vocab(vocab)
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = (torch.randn(rows, vp, generator=gen, device="cuda") * 2).to(torch.bfloat16)
    labels = torch.randint(0, vocab, (rows,), generator=gen, device="cuda")
    mask = (torch.rand(rows, generator=gen, device="cuda") < live).float()
    scale = (1.0 / mask.sum().clamp(min=1.0)).reshape(1)
    out = torch.empty(rows, device="cuda")
    got, ref = logits.clone(), logits.clone()
    loss = ll.lm_loss_rows_cuda(got, labels, mask, scale, vocab, grad=True, out=out.clone())
    ref_loss = ll.lm_loss_rows_plain(ref, labels, mask, scale, vocab, grad=True,
                                     out=out.clone())
    torch.cuda.synchronize()
    atol, rtol = LM_LOSS_TOL
    loss_err = ((loss - ref_loss).abs() / (1e-5 + 1e-5 * ref_loss.abs())).max().item()
    grad_err = ((got.float() - ref.float()).abs()
                / (atol + rtol * ref.float().abs())).max().item()
    if loss_err > 1 or grad_err > 1:
        raise AssertionError(f"lm_loss kernel off its plain version: loss {loss_err}, "
                             f"gradient {grad_err} of the tolerance")
    live_rows = int(mask.sum().item())
    # live rows read and written once, the others only written (zeros)
    nbytes = 2 * vp * (2 * live_rows + (rows - live_rows)) + rows * (8 + 4 + 4)
    z = logits[:, :vocab].contiguous()

    def library():
        zz = z.detach().requires_grad_()
        ce = (torch.nn.functional.cross_entropy(zz, labels, reduction="none") * mask).sum()
        torch.autograd.grad(ce * scale, zz)

    return {
        "vocab": vocab, "vp": vp, "rows": rows, "live_rows": live_rows,
        "max_err_of_tol": max(loss_err, grad_err),
        "ms": adaptive_time_ms(torch, lambda: ll.lm_loss_rows_cuda(
            logits, labels, mask, scale, vocab, grad=True, out=out), [()]),
        "plain_ms": time_ms(torch, lambda: ll.lm_loss_rows_plain(
            logits, labels, mask, scale, vocab, grad=True, out=out), [()], 3),
        "library_ms": adaptive_time_ms(torch, library, [()]),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "resources": ll.kernel_resources(vp, torch.bfloat16),
    }


def lm_loss_whole_case(torch, ll, c: dict) -> dict:
    """A cell's microbatch through the whole loss, forward and backward:
    the fused path (``lm_loss_from_hidden``) against the recomputed one it
    replaced (``_recomputed_lm_loss``), same inputs, CUDA-event times; the
    two losses and grads compared normwise, and the fused path's launches."""
    from polyaxon_tpu_torch.models import transformer

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, vocab = c["batch"], c["seq"], c["hidden"], c["vocab"]
    x = torch.randn(b, s, h, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(vocab, h, generator=gen, device="cuda") * 0.05
    labels = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    mask = (None if c["live"] >= 1 else
            (torch.rand(b, s, generator=gen, device="cuda") < c["live"]).float())
    out = {}
    for name, fn in (("fused", transformer.lm_loss_from_hidden),
                     ("recomputed", transformer._recomputed_lm_loss)):
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()

        def step():
            tx.grad = tw.grad = None
            loss = fn(tx, tw, labels, mask, vocab_major=True, chunk_tokens=LM_LOSS_ROWS)
            loss.backward()
            return loss

        ll.reset_launch_counts()
        loss = step()
        torch.cuda.synchronize()
        launches = ll.launch_counts["lm_loss"]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(torch, step, [()], LM_LOSS_WHOLE_TIMINGS)
        out[name] = {"loss": loss.item(), "ms": ms, "launches": launches,
                     "peak_extra_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                     "gx": tx.grad.float(), "gw": tw.grad}
    new, old = out["fused"], out["recomputed"]
    gaps = {k: ((new[k] - old[k]).norm() / old[k].norm()).item() for k in ("gx", "gw")}
    if abs(new["loss"] - old["loss"]) > 1e-3 * abs(old["loss"]) or max(gaps.values()) > 1e-2:
        raise AssertionError(f"fused loss off the recomputed one: {new['loss']} vs "
                             f"{old['loss']}, grads {gaps}")
    for row in out.values():
        del row["gx"], row["gw"]
    return {**out, "grad_gaps": gaps, "speedup": old["ms"] / new["ms"]}


def lm_loss_phase(torch, ll) -> dict:
    """The row kernel at each cell's chunk shape (and BERT's with every row
    live), then each cell's microbatch through the whole loss."""
    out = {}
    for name, c in LM_LOSS_CASES.items():
        out[name] = lm_loss_rows_case(torch, ll, c, c["live"])
        if c["live"] < 1:
            out[f"{name}/all_rows"] = lm_loss_rows_case(torch, ll, c, 1.0)
        out[f"{name}/whole"] = lm_loss_whole_case(torch, ll, c)
        gc.collect()
        torch.cuda.empty_cache()
    for case, row in out.items():
        log("lm_loss", case=case, **row)
    return out


# -- phase 6: train ----------------------------------------------------------------


def flash_launch_formula(spec: dict, layers: int) -> dict:
    """Launches of each flash kernel over a run on one rank: one forward,
    dQ and dK/dV per layer per microbatch per step, plus the forward the
    remat policy reruns in the backward (every policy but none). Under
    ``stage`` a rank runs its L/S layers on each of the pipeline's
    microbatches, and ``pp_remat_ticks`` reruns each tick's forward once
    more in the backward."""
    stages = int((spec.get("parallelism") or {}).get("stage", 1))
    pp = int(spec.get("pp_microbatches") or 2 * stages) if stages > 1 else 1
    per = int(spec["steps"]) * (layers // stages) * int(spec.get("microbatches", 1)) * pp
    rerun = 2 if spec.get("remat", "none") != "none" else 1
    if stages > 1 and spec.get("pp_remat_ticks"):
        rerun += 1
    return {"flash_fwd": per * rerun, "flash_bwd_dq": per, "flash_bwd_dkv": per}


def lm_loss_launch_formula(spec: dict) -> Optional[int]:
    """Launches of the LM loss's row kernel over a run on one rank that
    holds the whole batch: one a loss chunk (``loss_chunks`` of a
    microbatch's rows at the spec's ``loss_chunk_tokens``) of each
    microbatch of each step; 0 for a family with no LM head. None on a
    mesh of more than one rank, whose share of the batch, sequence or
    vocabulary the formula does not follow: such a run's count is
    reported, not checked."""
    from polyaxon_tpu_torch.models import REGISTRY, transformer

    family, cfg = REGISTRY[spec["model"]]
    if family not in ("lm", "mlm"):
        return 0
    if math.prod((spec.get("parallelism") or {}).values()) > 1:
        return None
    micro = int(spec.get("microbatches", 1))
    chunk_tokens = spec.get("loss_chunk_tokens")
    chunks = transformer.loss_chunks(
        int(spec["batch_size"]) // micro, int(spec.get("seq_len", min(2048, cfg.max_seq))),
        cfg.loss_chunk_tokens if chunk_tokens is None else int(chunk_tokens))
    return int(spec["steps"]) * micro * chunks


def model_shape(name: str) -> tuple[str, int, int]:
    """(family, layers that run attention, classes of the loss: the vocab
    or the labels) of a registry model."""
    from polyaxon_tpu_torch.models import REGISTRY

    family, cfg = REGISTRY[name]
    if family in ("lm", "mlm"):
        return family, cfg.num_layers, cfg.vocab_size
    if family == "vit":
        return family, cfg.encoder.num_layers, cfg.num_classes
    return family, 0, cfg.num_classes


def train_phase(torch, fa, spec: dict, visits: int = 1,
                loss0_margin: float = LOSS0_MARGIN) -> dict:
    """The port's builtin runtime on the card; returns its measurements.
    ``visits``: the ring visits of each attention on this rank (its
    context coordinate + 1 in a causal ring)."""
    from polyaxon_tpu_torch.ops import lm_loss as ll
    from polyaxon_tpu_torch.runtime.builtin import run_builtin

    logged = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2**30  # left by the earlier phases
    fa.reset_launch_counts()
    ll.reset_launch_counts()
    t0 = time.monotonic()
    summary = run_builtin(dict(spec), track=lambda step, m: logged.append((step, m)))
    wall_s = time.monotonic() - t0
    launches = {**fa.launch_counts, **ll.launch_counts}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    family, layers, classes = model_shape(spec["model"])
    expected = {k: n * visits for k, n in flash_launch_formula(spec, layers).items()}
    lm_loss_launches = lm_loss_launch_formula(spec)
    if lm_loss_launches is not None:
        expected["lm_loss"] = lm_loss_launches
    losses = [m["loss"] for _, m in sorted(logged, key=lambda e: e[0])]
    per_sample = int(spec["seq_len"]) if family in ("lm", "mlm") else 1
    out = {"losses": losses, "grad_norms": [m["grad_norm"] for _, m in logged],
           "step_time_p50_ms": summary["step_time_p50_ms"],
           "step_time_ms": summary["step_time_ms"], "timed_steps": summary["steps"],
           "tokens_per_sec": summary["tokens_per_sec"],
           "samples_per_sec": summary["tokens_per_sec"] / per_sample, "mfu": summary["mfu"],
           "achieved_tflops": summary["achieved_tflops_per_chip"],
           "peak_mem_gib": peak_gib, "mem_at_start_gib": start_gib, "wall_s": wall_s,
           "launches": launches,
           "expected_launches": expected,
           "anomalies": summary["train_anomalies_loss"] + summary["train_anomalies_grad"]}
    if "accuracy" in summary:
        out["accuracy"] = summary["accuracy"]
    for key in ("router_aux", "router_drop_frac"):
        if key in summary:
            out[key] = [m[key] for _, m in sorted(logged, key=lambda e: e[0])]
    if len(losses) != int(spec["steps"]) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if out["anomalies"]:
        raise AssertionError(f"{out['anomalies']} anomalous steps")
    if not abs(losses[0] - math.log(classes)) <= loss0_margin:
        raise AssertionError(f"step-0 loss {losses[0]} is not within {loss0_margin} of "
                             f"ln {classes}")
    if {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"kernel launches {launches} != formula {expected}")
    if summary["mfu"] is None:
        raise AssertionError("no MFU: the card is not in the meter's peak table")
    return out


def train_compare_phase(torch, fa, spec: dict) -> dict:
    """One microbatch (2 x seq) at full depth: loss and bf16 grads with
    attn_impl flash against dense, from the same random init and batch,
    which must agree, and again with each planted kernel fault, which must
    not (the profile of a step is train_profile_phase's, at the end of the
    run)."""
    from dataclasses import replace

    from polyaxon_tpu_torch.train.tasks import LMTask

    cfg, micro, batch, paths, leaves = train_compare_setup(torch, spec)
    return flash_dense_compare(
        torch, fa, "train_compare", lambda impl: LMTask(replace(cfg, attn_impl=impl)),
        batch, paths, leaves, TRAIN_LOSS_TOL, TRAIN_GRAD_REL_TOL,
        tokens=micro * spec["seq_len"])


def flash_dense_compare(torch, fa, phase: str, task_for_impl, batch: dict, paths, leaves,
                        loss_tol: float, grad_tol: float, **extra) -> dict:
    """The loss and grads of ``task_for_impl(impl).loss`` on ``batch`` with
    attn_impl flash against dense, from the same leaves: they must agree
    within (loss_tol, grad_tol), and with each planted kernel fault
    (FLASH_FAULTS) they must not. Logs the readings under ``phase`` first."""
    from polyaxon_tpu_torch.models.transformer import unflatten

    def loss_and_grads(impl):
        diff = [t.detach().requires_grad_() for t in leaves]
        loss, _, _ = task_for_impl(impl).loss(unflatten(paths, diff), None, batch)
        return loss.item(), torch.autograd.grad(loss, diff)

    ld, gd = loss_and_grads("dense")

    def against_dense(lf, gf) -> dict:
        rel = {"/".join(p): ((a.float() - b.float()).norm() / b.float().norm()).item()
               for p, a, b in zip(paths, gf, gd)
               if not "/".join(p).endswith(ZERO_GRAD_LEAVES)}
        ranked = sorted(rel, key=rel.get, reverse=True)
        return {"loss": lf, "loss_diff": abs(lf - ld), "worst_grad_rel_err": rel[ranked[0]],
                "worst_leaf": ranked[0], "next_leaves": {k: rel[k] for k in ranked[1:3]}}

    sound = against_dense(*loss_and_grads("flash"))
    faults = {}
    for fault, launcher in FLASH_FAULTS.items():
        orig = getattr(fa, launcher)
        setattr(fa, launcher, functools.partial(orig, walk_cut=1))
        try:
            faults[fault] = against_dense(*loss_and_grads("flash"))
        finally:
            setattr(fa, launcher, orig)
    del gd
    out = {"loss_flash": sound["loss"], "loss_dense": ld, "loss_diff": sound["loss_diff"],
           "loss_tol": loss_tol, "worst_grad_rel_err": sound["worst_grad_rel_err"],
           "worst_leaf": sound["worst_leaf"], "grad_rel_tol": grad_tol,
           "planted_faults": faults, **extra}
    log(phase, **out)
    if not (math.isfinite(sound["loss"]) and math.isfinite(ld)):
        raise AssertionError(f"non-finite loss: flash {sound['loss']}, dense {ld}")
    if not sound["loss_diff"] <= loss_tol:
        raise AssertionError(f"flash vs dense loss differ by {sound['loss_diff']}")
    if not sound["worst_grad_rel_err"] <= grad_tol:
        raise AssertionError(f"flash vs dense grads of {sound['worst_leaf']} differ by "
                             f"{sound['worst_grad_rel_err']} (relative)")
    for fault, r in faults.items():
        if r["loss_diff"] <= loss_tol and r["worst_grad_rel_err"] <= grad_tol:
            raise AssertionError(f"planted fault {fault} passes the flash vs dense "
                                 f"compare ({r}); its limits cannot see it")
    return out


def train_compare_setup(torch, spec: dict):
    """The recipe's model config, one microbatch of its data and the random
    init (seed 0) as bf16 leaves: (cfg, micro, batch, paths, leaves)."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY, transformer
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.train.data import DataConfig, synthetic_lm_batches

    cfg = replace(REGISTRY[spec["model"]][1], remat=spec["remat"],
                  attn_block_q=spec["attn_block_q"], attn_block_k=spec["attn_block_k"],
                  loss_chunk_tokens=spec["loss_chunk_tokens"],
                  **{k: spec[k] for k in ("moe_cap_block", "moe_dispatch") if k in spec})
    micro = spec["batch_size"] // spec["microbatches"]
    batch = next(synthetic_lm_batches(DataConfig(
        batch_size=micro, seq_len=spec["seq_len"], vocab_size=cfg.vocab_size)))
    batch = {name: t.cuda() for name, t in batch.items()}
    paths, leaves = zip(*flatten(transformer.init(cfg, seed=0, device="cuda")))
    return cfg, micro, batch, paths, [t.to(torch.bfloat16) for t in leaves]


def train_lora_phase(torch, fa, trained: dict) -> dict:
    """llama-1b LoRA through ``run_builtin`` (LORA_SPEC): train_phase's
    checks (finite losses, no anomaly, the flash launches of full
    training), then every base leaf bit-equal to the random init it
    started from and every ``b`` moved off zero; step p50, MFU and peak
    memory beside the train phase's (``trained``)."""
    from polyaxon_tpu_torch.models import REGISTRY, transformer
    from polyaxon_tpu_torch.partition.rules import tree_paths
    from polyaxon_tpu_torch.train.trainer import Trainer

    kept = {}
    fit = Trainer.fit

    def keep(self, *args, **kwargs):
        state, final = fit(self, *args, **kwargs)
        kept["params"] = state.params
        return state, final

    Trainer.fit = keep
    try:
        run = train_phase(torch, fa, LORA_SPEC)
    finally:
        Trainer.fit = fit
    params = kept.pop("params")
    start = tree_paths(transformer.init(REGISTRY[LORA_SPEC["model"]][1], seed=0,
                                        device="cuda"))
    base = dict(tree_paths(params["base"]))
    moved = [p for p, t in start if not torch.equal(base[p], t)]
    bs = [t for p, t in tree_paths(params["lora"]) if p.endswith("/b")]
    still = sum(t.abs().max().item() == 0 for t in bs)
    run.update(base_leaves=len(start), base_leaves_moved=moved, b_leaves=len(bs),
               b_still_zero=still, train_step_p50_ms=trained["step_time_p50_ms"],
               train_peak_mem_gib=trained["peak_mem_gib"], train_mfu=trained["mfu"],
               step_vs_train=run["step_time_p50_ms"] / trained["step_time_p50_ms"])
    del params, start, base, bs
    if moved:
        raise AssertionError(f"LoRA moved base leaves {moved}")
    if still or not run["b_leaves"]:
        raise AssertionError(f"{still} of {run['b_leaves']} adapter b leaves never moved")
    return run


def lora_compare_phase(torch, fa) -> dict:
    """One microbatch (2 x 2048) at full depth on the train phase's random
    base (bf16): through LoRATask with b = 0 the loss is LMTask's bit for
    bit; with b random, flash against dense within the train phase's
    limits, and each planted kernel fault (walk_cut=1) outside them."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models.transformer import flatten, unflatten
    from polyaxon_tpu_torch.partition.lora import LoRAConfig, LoRATask, init_lora
    from polyaxon_tpu_torch.train.tasks import LMTask

    cfg, micro, batch, paths, leaves = train_compare_setup(torch, TRAIN_SPEC)
    lcfg = LoRAConfig.from_spec(LORA_KEYS)
    base = unflatten(paths, leaves)
    adapters = {p: t.to(torch.bfloat16)
                for p, t in flatten(init_lora(base, lcfg, seed=1))}
    with torch.no_grad():
        plain = LMTask(cfg).loss(base, None, batch)[0]
        merged = LoRATask(LMTask(cfg), lcfg).loss(
            {"base": base, "lora": unflatten(list(adapters), list(adapters.values()))},
            None, batch)[0]
    identity = {"loss_lm": plain.item(), "loss_lora_b0": merged.item(),
                "bit_equal": bool(torch.equal(plain, merged))}
    if not identity["bit_equal"]:
        raise AssertionError(f"LoRATask with b = 0: loss {merged.item()} != LMTask's "
                             f"{plain.item()}")
    gen = torch.Generator(device=leaves[0].device).manual_seed(2)
    for p, t in adapters.items():
        if p[-1] == "b":
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * LORA_B_STD)
    lpaths = [("base",) + p for p in paths] + [("lora",) + p for p in adapters]
    lleaves = list(leaves) + list(adapters.values())
    out = flash_dense_compare(
        torch, fa, "lora_compare",
        lambda impl: LoRATask(LMTask(replace(cfg, attn_impl=impl)), lcfg),
        batch, lpaths, lleaves, TRAIN_LOSS_TOL, TRAIN_GRAD_REL_TOL,
        tokens=micro * TRAIN_SPEC["seq_len"], b_zero=identity)
    return out


def train_profile_phase(torch, spec: dict) -> dict:
    """Where a step's time goes: the profiler's split of the trainer's
    per-microbatch work (loss, grads, the add into the bf16 accumulator),
    which a step runs ``microbatches`` times, and of its tail (divide, grad
    norm, AdamW with bf16 moments), on the train-compare phase's inputs."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models.transformer import unflatten
    from polyaxon_tpu_torch.train.optimizers import (
        OptimizerConfig, global_norm, make_optimizer,
    )
    from polyaxon_tpu_torch.train.tasks import LMTask

    cfg, _, batch, paths, leaves = train_compare_setup(torch, spec)
    acc = [torch.zeros_like(t) for t in leaves]

    def flash_microbatch():
        diff = [t.detach().requires_grad_() for t in leaves]
        loss, _, _ = LMTask(replace(cfg, attn_impl="flash")).loss(
            unflatten(paths, diff), None, batch)
        for a, g in zip(acc, torch.autograd.grad(loss, diff)):
            a.add_(g)

    flash_microbatch()  # warm-up: the allocator's blocks, cuBLAS's choices
    profile = profile_steps(torch, flash_microbatch, steps=1,
                            kernels=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    tx = make_optimizer(OptimizerConfig(
        learning_rate=spec["learning_rate"], warmup_steps=spec["warmup_steps"],
        total_steps=spec["steps"], mu_dtype=spec["mu_dtype"], nu_dtype=spec["nu_dtype"]))
    masters = [t.float() for t in leaves]
    opt_state = tx.init(masters)
    k = spec["microbatches"]

    def step_tail():
        grads = [a / k for a in acc]
        global_norm(grads)
        updates, _ = tx.update(grads, opt_state, masters)
        for p, u in zip(masters, updates):
            p.add_(u)

    tail = profile_steps(torch, step_tail, steps=1, kernels=())
    split = {"microbatches": k, "microbatch_device_ms": profile["device_ms_per_step"],
             "tail_device_ms": tail["device_ms_per_step"],
             "tail_wall_ms": tail["wall_ms_per_step"],
             "step_device_ms": k * profile["device_ms_per_step"]
             + tail["device_ms_per_step"]}
    return {"microbatch_profile": profile, "step_split": split}


def lora_profile_phase(torch) -> dict:
    """What LoRA adds to a microbatch: the profiler's device time, wall
    time, idle share and kernel launches of one flash microbatch (2 x 2048)
    of ``LMTask`` and of ``LoRATask`` (LORA_KEYS, b random) on the
    train-compare phase's base, each after a warm-up, in one process."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models.transformer import flatten, unflatten
    from polyaxon_tpu_torch.partition.lora import LoRAConfig, LoRATask, init_lora
    from polyaxon_tpu_torch.train.tasks import LMTask

    cfg, _, batch, paths, leaves = train_compare_setup(torch, TRAIN_SPEC)
    cfg = replace(cfg, attn_impl="flash")
    lcfg = LoRAConfig.from_spec(LORA_KEYS)
    adapters = [(("lora",) + p, t.to(torch.bfloat16)) for p, t in
                flatten(init_lora(unflatten(paths, leaves), lcfg, seed=1))]
    for p, t in adapters:
        if p[-1] == "b":
            t.normal_(std=LORA_B_STD)
    runs = {"lm": (LMTask(cfg), list(paths), list(leaves)),
            "lora": (LoRATask(LMTask(cfg), lcfg), [("base",) + p for p in paths]
                     + [p for p, _ in adapters], list(leaves) + [t for _, t in adapters])}
    out = {}
    for name, (task, tpaths, tleaves) in runs.items():
        def microbatch():
            diff = [t.detach().requires_grad_() for t in tleaves]
            loss, _, _ = task.loss(unflatten(tpaths, diff), None, batch)
            torch.autograd.grad(loss, diff)

        microbatch()  # warm-up
        prof = profile_steps(torch, microbatch, steps=1, kernels=("flash_fwd",))
        out[name] = {k: prof[k] for k in ("device_ms_per_step", "wall_ms_per_step",
                                          "device_idle_share", "kernel_launches_per_step",
                                          "gemm_ms_per_step")}
    for key in ("wall", "device"):
        ms = f"{key}_ms_per_step"
        out[f"{key}_ratio"] = out["lora"][ms] / out["lm"][ms] if out["lm"][ms] else None
    return out


# -- BERT-base MLM, ViT-B/16 and ResNet-50 training ----------------------------------


def image_stream_s(torch, spec: dict, batches: int = 3) -> float:
    """Host seconds per batch that the spec's synthetic image stream takes
    to draw its images (numpy), apart from the step: the mean of
    ``batches`` draws, the first included."""
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    _, stream = build_trainer(dict(spec, checkpoint=False))
    t0 = time.perf_counter()
    for _ in range(batches):
        next(stream)
    return (time.perf_counter() - t0) / batches


def family_compare_phase(torch, fa, spec: dict) -> dict:
    """One microbatch of the spec's run at full depth (f32 leaves, as the run
    differentiates them): flash against dense, with the planted faults."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY, transformer, vit
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.runtime.builtin import build_trainer
    from polyaxon_tpu_torch.train.tasks import task_for

    family, cfg = REGISTRY[spec["model"]]
    micro = int(spec["batch_size"]) // int(spec.get("microbatches", 1))
    _, stream = build_trainer(dict(spec, checkpoint=False, batch_size=micro))
    batch = {name: t.cuda() for name, t in next(stream).items()}
    if family == "vit":
        params = vit.init(cfg, seed=0, device="cuda")

        def task_for_impl(impl):
            return task_for(family, replace(cfg, encoder=replace(cfg.encoder, attn_impl=impl)))
    else:
        params = transformer.init(cfg, seed=0, device="cuda")

        def task_for_impl(impl):
            return task_for(family, replace(cfg, attn_impl=impl))
    paths, leaves = zip(*flatten(params))
    loss_tol, grad_tol = FAMILY_COMPARE_TOL[spec["model"]]
    tokens = micro * (int(spec["seq_len"]) if family == "mlm" else cfg.num_patches + 1)
    out = flash_dense_compare(torch, fa, f"train_{family}_compare", task_for_impl, batch,
                              paths, list(leaves), loss_tol, grad_tol, tokens=tokens)
    del params, leaves
    return out


def family_profile_phase(torch, spec: dict) -> dict:
    """Where one step of the spec's trainer spends its device time (its
    batch drawn beforehand, so the host's image draw is not in it): the
    profiler's split by kernel, the flash kernels' and cuBLAS's shares and
    the device's idle share of the step's wall time."""
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    trainer, stream = build_trainer(dict(spec, checkpoint=False))
    step = trainer.make_step()
    warm, batch = next(stream), next(stream)
    state, _ = step(trainer.init_state(seed=0), warm)  # warm-up
    held = [state]

    def one_step():
        held[0], metrics = step(held[0], batch)
        float(metrics["loss"])

    return profile_steps(torch, one_step, steps=1,
                         kernels=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def resnet_stats_phase(torch, spec: dict) -> dict:
    """One step of the spec's trainer from a fresh init: every batch
    statistic in ``extra`` must move."""
    from polyaxon_tpu_torch.partition.rules import tree_paths
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    trainer, stream = build_trainer(dict(spec, checkpoint=False))
    state = trainer.init_state(seed=0)
    before = {path: t.clone() for path, t in tree_paths(state.extra)}
    state, metrics = trainer.make_step()(state, next(stream))
    after = dict(tree_paths(state.extra))
    moved = [path for path, t in before.items() if not torch.equal(t, after[path])]
    out = {"stats": len(before), "moved": len(moved), "loss": float(metrics["loss"]),
           "accuracy": float(metrics["accuracy"])}
    if len(moved) != len(before):
        raise AssertionError(f"{len(before) - len(moved)} batch statistics did not move "
                             f"after one step")
    return out


# -- phases 8-9: speculative decoding -----------------------------------------------


# -- slice 10: mixture of experts and the pipeline's gates ---------------------------

MOE_SPEC = {
    # bench.py's single-chip MoE recipe (--moe): llama-moe-1b at 32 x 2048 in 8
    # microbatches, remat attn_qkv, flash blocks 1024, cap-blocked capacity
    # dispatch, bf16 moments, grads and accumulator; 3 steps
    "model": "llama-moe-1b", "steps": 3, "batch_size": 32, "seq_len": 2048,
    "learning_rate": 3.0e-4, "warmup_steps": 5, "remat": "attn_qkv",
    "attn_block_q": 1024, "attn_block_k": 1024, "moe_cap_block": 512,
    "moe_dispatch": "capacity", "mu_dtype": "bfloat16", "nu_dtype": "bfloat16",
    "grad_dtype": "bfloat16", "microbatches": 8, "accum_dtype": "bfloat16",
    "loss_chunk_tokens": 4096, "checkpoint": False, "log_interval": 1,
    "data": {"kind": "synthetic-lm"}, "platform": "cuda",
}
# moe_compare's capacity factors: ample (cf = E/k: nothing can drop), the
# recipe's 1.25, and a tight 0.5 that drops at least half of the assignments
# whatever the routing (cap is half the mean load)
MOE_TIGHT_CF = 0.5
# moe_compare's limits (worst |hidden| difference over the largest |hidden|;
# worst per-leaf grad relative norm error), each between the sound readings
# and those of the planted faults (MOE_FAULTS), measured in every run
MOE_HIDDEN_TOL = 0.02
MOE_GRAD_TOL = 0.1
# the faults the MoE compare must see: a kept assignment's slot read one
# off, the keep mask ignored (dropped assignments combine another token's
# slot), and the combine's router-weight cotangent dropped
MOE_FAULTS = ("slot_off_by_one", "keep_ignored", "combine_dw_dropped")


def moe_setup(torch, spec: dict, micro_rows: int):
    """The recipe's MoE config, one microbatch of ``micro_rows`` rows of its
    data and the random init (seed 0) as bf16 leaves."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY, transformer
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.train.data import DataConfig, synthetic_lm_batches

    cfg = replace(REGISTRY[spec["model"]][1], remat=spec["remat"],
                  attn_block_q=spec["attn_block_q"], attn_block_k=spec["attn_block_k"],
                  loss_chunk_tokens=spec["loss_chunk_tokens"])
    batch = next(synthetic_lm_batches(DataConfig(
        batch_size=micro_rows, seq_len=spec["seq_len"], vocab_size=cfg.vocab_size)))
    batch = {name: t.cuda() for name, t in batch.items()}
    paths, leaves = zip(*flatten(transformer.init(cfg, seed=0, device="cuda")))
    return cfg, batch, paths, [t.to(torch.bfloat16) for t in leaves]


def moe_loss_and_grads(torch, cfg, batch, paths, leaves) -> tuple:
    """(hidden states, aux, LMTask loss, per-leaf grads) of one microbatch."""
    from polyaxon_tpu_torch.models import transformer
    from polyaxon_tpu_torch.models.transformer import unflatten

    diff = [t.detach().requires_grad_() for t in leaves]
    params = unflatten(paths, diff)
    hidden, aux = transformer.apply_hidden(params, batch["inputs"], cfg, return_aux=True)
    w, vocab_major = transformer.head_weights(params, cfg)
    loss = transformer.lm_loss_from_hidden(hidden, w, batch["labels"],
                                           vocab_major=vocab_major,
                                           chunk_tokens=cfg.loss_chunk_tokens)
    loss = loss + cfg.router_aux_coef * aux[0]
    grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    return hidden.detach(), aux.detach(), loss.item(), grads


def moe_masked_dense(torch, cfg):
    """The dense oracle with each assignment the capacity plan drops (the
    plan computed apart from the dispatch tables) weighted zero: what
    capacity dispatch must equal at any capacity factor."""
    from polyaxon_tpu_torch.models import transformer as tm

    oracle = tm._moe_dense

    def dense(y, mp, cfg_, top_idx, top_gates, mesh=None):
        b, s, _ = y.shape
        E, k = cfg_.num_experts, min(cfg_.expert_top_k, cfg_.num_experts)
        T = b * s
        cap = max(int(T * k / E * cfg_.expert_capacity_factor), 1)
        keep = tm._capacity_plan(top_idx.reshape(T, k), None, E, k, cap)[4]
        gates = top_gates * keep.reshape(b, s, k).to(top_gates.dtype)
        return oracle(y, mp, cfg_, top_idx, gates, mesh)

    return dense


def moe_against(torch, paths, ref: tuple, got: tuple) -> dict:
    """A run's hidden states and grads against a reference run's: the
    worst |difference| over the largest |hidden|, the loss difference and
    the worst per-leaf grad relative norm error."""
    h0, a0, l0, g0 = ref
    h1, a1, l1, g1 = got
    scale = h0.float().abs().max().item()
    rel = {}
    for p, a, b in zip(paths, g1, g0):
        nb = b.float().norm().item()
        if nb > 0:
            rel["/".join(p)] = ((a.float() - b.float()).norm() / nb).item()
    worst = max(rel, key=rel.get)
    return {"hidden_rel": (h1.float() - h0.float()).abs().max().item() / scale,
            "loss_diff": abs(l1 - l0), "worst_grad_rel_err": rel[worst], "worst_leaf": worst,
            "aux": a1.tolist(), "aux_ref": a0.tolist()}


def moe_layers_worst(readings: list) -> dict:
    """Per-layer moe_against readings as one: the worst hidden and grad
    errors over the layers (the grad's leaf named with its layer) and each
    aux term's mean."""
    worst = max(range(len(readings)), key=lambda i: readings[i]["worst_grad_rel_err"])

    def mean(key):
        return [sum(col) / len(readings) for col in zip(*(r[key] for r in readings))]

    return {"hidden_rel": max(r["hidden_rel"] for r in readings),
            "worst_grad_rel_err": readings[worst]["worst_grad_rel_err"],
            "worst_leaf": f"layers/{worst}/{readings[worst]['worst_leaf']}",
            "aux": mean("aux"), "aux_ref": mean("aux_ref")}


class MoeFault:
    """One planted fault in the port's MoE dispatch (a context manager)."""

    def __init__(self, name: str):
        self.name = name
        self._undo = []

    def __enter__(self):
        import torch

        from polyaxon_tpu_torch.models import transformer as tm

        if self.name in ("slot_off_by_one", "keep_ignored"):
            tables = tm._dispatch_tables

            def faulty(top_idx, top_gates, E, k, cap):
                tfs, slot, keep, drop = tables(top_idx, top_gates, E, k, cap)
                if self.name == "slot_off_by_one":
                    return tfs, (slot + 1).clamp(max=cap - 1), keep, drop
                return tfs, slot, torch.ones_like(keep), drop

            self._undo.append((tm, "_dispatch_tables", tables))
            tm._dispatch_tables = faulty
        elif self.name == "combine_dw_dropped":
            backward = tm._GatherCombine.backward

            def faulty_bwd(ctx, dout):
                dye, dw, *rest = backward(ctx, dout)
                return (dye, dw * 0, *rest)

            self._undo.append((tm._GatherCombine, "backward", backward))
            tm._GatherCombine.backward = staticmethod(faulty_bwd)
        else:
            raise ValueError(self.name)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, staticmethod(value) if name == "backward" else value)
        return False


def moe_compare_phase(torch, fa, spec: dict) -> dict:
    """One microbatch (4 x 2048) of llama-moe-1b at full width, bf16:

    - capacity at ample capacity (cf = E/k) against the dense oracle, and
      at cf 0.5 (drops) against the dense oracle with the plan's dropped
      assignments weighted zero, layer by layer, each layer on its input
      in one forward of the dense oracle (the same input for both, so the
      same routing: through 16 layers a bf16 rounding flips near-tied
      router choices): each layer's output, and the grads of its input and
      of its leaves under a seeded cotangent of the output (no balance
      term: the router's grad comes through the gates), within
      MOE_HIDDEN_TOL / MOE_GRAD_TOL; each planted
      fault (MOE_FAULTS) must break one of the two;
    - streamed (the recipe's moe_cap_block) against one-shot at the
      recipe's cf 1.25 on the layer that drops the most (its input from
      one forward, the same for both, so the same plan and drops; through
      16 layers a bf16 rounding flips near-tied router choices and with
      them which tokens drop), within the same limits;
    - all-to-all at ``{expert: 1}`` against capacity at cf 1.25: bit-equal
      (the same operations on one rank);
    - that MoE layer's forward and backward twice: bit-equal.
    Returns the readings and the flash launches of the phase."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import transformer as tm
    from polyaxon_tpu_torch.ops import lm_loss as ll

    micro = spec["batch_size"] // spec["microbatches"]
    cfg, batch, paths, leaves = moe_setup(torch, spec, micro)
    E, k = cfg.num_experts, cfg.expert_top_k
    fa.reset_launch_counts()
    ll.reset_launch_counts()
    t0 = time.monotonic()

    def run(**changes):
        return moe_loss_and_grads(torch, replace(cfg, **changes), batch, paths, leaves)

    def layer_run(i, x, **changes):
        r = moe_layer_run(torch, replace(cfg, **changes), x, i, paths, leaves, cot)
        return r[0], r[1], 0.0, r[2:]

    def masked_run(i, x):
        orig_dense = tm._moe_dense
        tm._moe_dense = masked
        try:
            return layer_run(i, x, moe_dispatch="dense", expert_capacity_factor=MOE_TIGHT_CF)
        finally:
            tm._moe_dense = orig_dense

    ample = dict(moe_dispatch="capacity", expert_capacity_factor=E / k, moe_cap_block=0)
    tight = dict(moe_dispatch="capacity", expert_capacity_factor=MOE_TIGHT_CF,
                 moe_cap_block=0)
    masked = moe_masked_dense(torch, cfg)
    lpaths = [("x",)] + moe_layer_paths(paths)
    xs = moe_layer_inputs(torch, replace(cfg, moe_dispatch="dense"), batch, paths, leaves)[0]
    # a seeded cotangent of each token's output, at a mean loss's scale
    gen = torch.Generator(device=xs[0].device).manual_seed(0)
    cot = torch.randn(xs[0].shape, generator=gen, device=xs[0].device) / xs[0].shape[:2].numel()
    per = {"ample": [], "tight": []}
    per_fault = {name: {"ample": [], "tight": []} for name in MOE_FAULTS}
    for i, x in enumerate(xs):
        refs = {"ample": layer_run(i, x, moe_dispatch="dense"), "tight": masked_run(i, x)}
        for case, changes in (("ample", ample), ("tight", tight)):
            per[case].append(moe_against(torch, lpaths, refs[case], layer_run(i, x, **changes)))
            for name in MOE_FAULTS:
                with MoeFault(name):
                    per_fault[name][case].append(
                        moe_against(torch, lpaths, refs[case], layer_run(i, x, **changes)))
        del refs
    del xs
    out = {case: moe_layers_worst(r) for case, r in per.items()}
    faults = {name: {case: moe_layers_worst(r) for case, r in f.items()}
              for name, f in per_fault.items()}
    layer, x_in, out["streamed_layer_drop"] = moe_dropping_layer(torch, cfg, batch, paths,
                                                                 leaves)
    out["streamed_layer"] = layer
    layer_one_shot = moe_layer_run(torch, replace(cfg, moe_cap_block=0), x_in, layer, paths,
                                   leaves)
    layer_streamed = moe_layer_run(torch, replace(cfg, moe_cap_block=spec["moe_cap_block"]),
                                   x_in, layer, paths, leaves)
    out["streamed"] = moe_against(torch, [("x",)] + moe_layer_paths(paths),
                                  *[(r[0], r[1], 0.0, r[2:]) for r in
                                    (layer_one_shot, layer_streamed)])
    del layer_one_shot, layer_streamed
    one_shot = run(moe_dispatch="capacity", moe_cap_block=0)
    a2a = run(moe_dispatch="a2a", moe_cap_block=0)
    out["a2a_bit_equal"] = bool(torch.equal(a2a[0], one_shot[0]) and a2a[2] == one_shot[2]
                                and all(torch.equal(a, b) for a, b in zip(a2a[3], one_shot[3])))
    del a2a, one_shot
    streamed = replace(cfg, moe_cap_block=spec["moe_cap_block"])
    twice = [moe_layer_run(torch, streamed, x_in, layer, paths, leaves) for _ in range(2)]
    out["layer_twice_bit_equal"] = all(torch.equal(a, b) for a, b in zip(*twice))
    del twice, x_in
    out["launches"] = {**fa.launch_counts, **ll.launch_counts}
    out["seconds"] = time.monotonic() - t0
    out["planted_faults"] = faults
    out["limits"] = {"hidden_rel": MOE_HIDDEN_TOL, "grad_rel": MOE_GRAD_TOL}
    log("moe_compare", **out)

    def within(r):
        return r["hidden_rel"] <= MOE_HIDDEN_TOL and r["worst_grad_rel_err"] <= MOE_GRAD_TOL

    for name in ("ample", "tight", "streamed"):
        if not within(out[name]):
            raise AssertionError(f"moe_compare {name}: {out[name]} beyond the limits")
    if out["tight"]["aux"][1] <= 0 or out["streamed"]["aux"][1] <= 0:
        raise AssertionError("a compare meant to drop dropped nothing")
    for name, r in faults.items():
        if within(r["ample"]) and within(r["tight"]):
            raise AssertionError(f"planted fault {name} passes the MoE compare ({r})")
    if not out["a2a_bit_equal"]:
        raise AssertionError("a2a at {expert: 1} is not bit-equal to capacity")
    if not out["layer_twice_bit_equal"]:
        raise AssertionError("one MoE layer's forward and backward differ between runs")
    return out


def moe_layer_paths(paths) -> list:
    """The leaf paths of one layer, in moe_layer_run's grad order."""
    return [p[1:] for p in paths if p[0] == "layers"]


def moe_layer_inputs(torch, cfg, batch, paths, leaves) -> tuple:
    """One forward of ``cfg`` without grad or remat: each layer's input and
    the fraction of its assignments that its MoE plan drops."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import transformer as tm
    from polyaxon_tpu_torch.models.transformer import unflatten
    from polyaxon_tpu_torch.ops.layers import rope_frequencies

    cfg = replace(cfg, remat="none")
    params = unflatten(paths, leaves)
    x = params["embed"]["tokens"].to(cfg.dtype)[batch["inputs"]]
    s = x.shape[1]
    cos, sin = rope_frequencies(cfg.hd, cfg.max_seq, cfg.rope_theta, device=x.device)
    xs, drops = [], []
    with torch.no_grad():
        for lp in tm._unstack(params["layers"], cfg.num_layers):
            xs.append(x)
            x, aux = tm._layer_body(x, lp, cfg, (cos[:s], sin[:s]))
            drops.append(aux[1].item())
    return xs, drops


def moe_dropping_layer(torch, cfg, batch, paths, leaves) -> tuple:
    """One forward without grad (one-shot capacity): the index of the layer
    that drops the most assignments, its input and its drop fraction."""
    from dataclasses import replace

    xs, drops = moe_layer_inputs(torch, replace(cfg, moe_cap_block=0), batch, paths, leaves)
    i = max(range(len(drops)), key=drops.__getitem__)
    return i, xs[i], drops[i]


def moe_layer_run(torch, cfg, x, layer: int, paths, leaves, cot=None) -> list:
    """Layer ``layer`` of the model (attention and the MoE MLP) on input
    ``x``, no remat: [output, aux, grad of the input, grads of the layer's
    leaves] of ``mean(out^2) + balance``, or with ``cot`` of
    ``sum(out * cot)`` (the router's grad then comes through the gates
    alone)."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import transformer as tm
    from polyaxon_tpu_torch.models.transformer import flatten, unflatten
    from polyaxon_tpu_torch.ops.layers import rope_frequencies

    cfg = replace(cfg, remat="none")
    params = unflatten(paths, leaves)
    lpaths, lleaves = zip(*flatten(tm._unstack(params["layers"], cfg.num_layers)[layer]))
    x = x.detach().requires_grad_()
    s = x.shape[1]
    cos, sin = rope_frequencies(cfg.hd, cfg.max_seq, cfg.rope_theta, device=x.device)
    diff = [t.detach().requires_grad_() for t in lleaves]
    y, aux = tm._layer_body(x, unflatten(lpaths, diff), cfg, (cos[:s], sin[:s]))
    loss = (y.float() ** 2).mean() + aux[0] if cot is None else (y.float() * cot).sum()
    grads = torch.autograd.grad(loss, [x] + diff)
    return [y.detach(), aux.detach()] + list(grads)


def moe_parts_phase(torch, spec: dict, iters: int = 5) -> dict:
    """Where one MoE layer's time goes at the recipe's microbatch (4 x
    2048, bf16, cf 1.25): CUDA-event times (forward and backward, host
    launches included, as the step sees them) of the router with the
    capacity plan, the dispatch and combine gathers, the expert products on
    the [E, cap, h] buffer, and the whole MoE MLP one-shot and streamed;
    and a dense MLP of the same active width (top_k x mlp) for scale."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.models import transformer as tm

    cfg = replace(REGISTRY[spec["model"]][1], moe_cap_block=spec["moe_cap_block"])
    E, k, h = cfg.num_experts, cfg.expert_top_k, cfg.hidden
    b = spec["batch_size"] // spec["microbatches"]
    T = b * spec["seq_len"]
    cap = max(int(T * k / E * cfg.expert_capacity_factor), 1)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(
            cfg.dtype).requires_grad_()

    y = rand(b, spec["seq_len"], h)
    mp = {"router": rand(h, E, scale=0.02), "wi": rand(E, h, cfg.mlp_dim, scale=0.02),
          "wg": rand(E, h, cfg.mlp_dim, scale=0.02), "wo": rand(E, cfg.mlp_dim, h, scale=0.02)}
    dense = {"wi": rand(h, k * cfg.mlp_dim, scale=0.02),
             "wg": rand(h, k * cfg.mlp_dim, scale=0.02),
             "wo": rand(k * cfg.mlp_dim, h, scale=0.02)}
    with torch.no_grad():
        ti, tg, _ = tm._route(y, mp["router"], E, k)
        ti, tg = ti.reshape(T, k), tg.reshape(T, k)
        tfs, slot, keep, _ = tm._dispatch_tables(ti, tg, E, k, cap)
    x2 = y.detach().reshape(T, h).requires_grad_()
    xin = rand(E, cap, h)
    ye = rand(E, cap, h)
    w = tg.float().requires_grad_()

    def route():
        t, g, bal = tm._route(y, mp["router"], E, k)
        tm._dispatch_tables(t.reshape(T, k), g.reshape(T, k), E, k, cap)
        (g.float().sum() + bal).backward()

    def gathers():
        a = tm._GatherDispatch.apply(x2, tfs, ti, slot, keep)
        o = tm._GatherCombine.apply(ye, w * keep.float(), tfs, ti, slot, keep)
        torch.autograd.backward([a, o], [torch.ones_like(a), torch.ones_like(o)])

    def experts():
        out = tm._expert_ffn(xin, mp, cfg)
        out.backward(torch.ones_like(out))

    def moe(cb):
        c = replace(cfg, moe_cap_block=cb)

        def fn():
            out, aux = tm._moe_mlp(y, mp, c)
            torch.autograd.backward([out, aux[0]], [torch.ones_like(out), None])
        return fn

    def dense_mlp():
        from polyaxon_tpu_torch.ops.layers import swiglu

        hid = swiglu(torch.matmul(y, dense["wi"]), torch.matmul(y, dense["wg"]))
        out = torch.matmul(hid, dense["wo"])
        out.backward(torch.ones_like(out))

    out = {"tokens": T, "cap": cap}
    for name, fn in (("route_and_plan", route), ("gathers", gathers), ("experts", experts),
                     ("moe_one_shot", moe(0)), ("moe_streamed", moe(cfg.moe_cap_block)),
                     ("dense_mlp_same_active_width", dense_mlp)):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = start.elapsed_time(end) / iters
    return out


PP_GATE_MODELS = ("llama-1b", "llama-moe-1b")


def pp_gate_phase(torch) -> dict:
    """The pipeline's gate on one card at full width (ROADMAP C1's rule):
    layer 0 of llama-1b and of llama-moe-1b (capacity, bf16, 2 x 2048) with
    ``active=False`` emits exact zeros (output and aux), and with
    ``active=True`` equals the ungated body bit for bit."""
    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.models import transformer as tm
    from polyaxon_tpu_torch.ops.layers import rope_frequencies

    out = {}
    for name in PP_GATE_MODELS:
        cfg = REGISTRY[name][1]
        params = tm.init(cfg, seed=0, device="cuda")
        lp = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
              for k, v in tm._unstack(params["layers"], cfg.num_layers)[0].items()}
        del params
        seq = min(2048, cfg.max_seq)
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(2, seq, cfg.hidden, generator=gen, device="cuda").to(cfg.dtype)
        cos, sin = rope_frequencies(cfg.hd, cfg.max_seq, cfg.rope_theta, device="cuda")
        tables = (cos[:seq], sin[:seq])
        inner = tm.InnerAxes()
        with torch.no_grad():
            off, aux_off = tm._layer_body(x, lp, cfg, tables, None, inner, False)
            on, aux_on = tm._layer_body(x, lp, cfg, tables, None, inner, True)
            ref, aux_ref = tm._layer_body(x, lp, cfg, tables, None, inner, None)
        out[name] = {"inactive_max_abs": off.abs().max().item(),
                     "inactive_aux": aux_off.tolist(),
                     "active_equals_ungated": bool(torch.equal(on, ref)
                                                   and torch.equal(aux_on, aux_ref)),
                     "out_max_abs": ref.abs().max().item()}
        if off.abs().max().item() != 0 or aux_off.abs().max().item() != 0:
            raise AssertionError(f"{name}: an inactive body emits {out[name]}")
        if not out[name]["active_equals_ungated"]:
            raise AssertionError(f"{name}: the active body differs from the ungated one")
        del lp, x, off, on, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def spec_phase(torch, spec: dict, prompts: list, max_new: int) -> dict:
    """The production pairing through the HTTP server: build the engine from
    ``spec`` (target and draft random-init), drive the requests, count the
    paged kernel's launches; then time engine iterations with every row
    running (their profile is spec_profile_phase's, at the end of the
    run)."""
    from polyaxon_tpu_torch.serve.runtime import build_engine, warmup
    from polyaxon_tpu_torch.serve.server import build_server

    pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    engine = build_engine(spec)
    engine.start()
    srv = build_server(engine, "127.0.0.1", 0, model_name=engine.model_name)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        warm = threading.Thread(target=warmup, args=(engine,), daemon=True)
        warm.start()
        wait_healthy(base)
        warm.join(timeout=600)
        if warm.is_alive():
            raise TimeoutError("warmup request did not finish")
        snap0 = engine.snapshot()
        pa.reset_launch_counts()
        iterations0 = engine.decode_steps
        t0 = time.monotonic()
        results = drive_requests(base, prompts, max_new)
        wall_s = time.monotonic() - t0
        launches = pa.launch_counts["paged_decode"]
        iterations = engine.decode_steps - iterations0
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    for i, res in enumerate(results):
        toks = res["tokens"]
        if len(toks) != max_new or not all(0 <= t < engine.cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i} returned {len(toks)} tokens: {toks}")
    proposed = stats["spec_tokens_proposed"] - snap0["spec_tokens_proposed"]
    accepted = stats["spec_tokens_accepted"] - snap0["spec_tokens_accepted"]
    out = {"k": engine.spec_k, "draft_layers": engine.draft_cfg.num_layers,
           "target_layers": engine.cfg.num_layers, "launches": launches,
           "iterations": iterations, "wall_s": wall_s,
           "tokens_per_s": sum(len(r["tokens"]) for r in results) / wall_s,
           "tokens_proposed": proposed, "tokens_accepted": accepted,
           "acceptance": accepted / max(proposed, 1),
           "kv_audit_violations": stats["kv_audit_violations"]}
    # with the engine's thread stopped: every row running, iterations timed
    # on the host clock one by one
    reqs = running_rows(engine, prompts)
    host_ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        engine.step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(r.state == "running" for r in reqs):
        raise AssertionError("a row finished inside the timed iterations")
    for r in reqs:
        engine.cancel(r)
    out.update({"iteration_host_ms_p50": sorted(host_ms)[len(host_ms) // 2],
                "iteration_host_ms": host_ms, "timed_rows": len(reqs)})
    return out


def running_rows(engine, prompts: list) -> list:
    """Admit every prompt with as many new tokens as the context holds (a
    block of each row's context left unreserved, so the pool holds every
    row beside the prefix index's published blocks) and step the engine
    until every row runs; returns the requests."""
    from polyaxon_tpu_torch.serve.engine import SamplingParams

    reqs = [engine.submit(p, SamplingParams(
        max_new_tokens=engine.max_seq_len - engine.spec_k - len(p) - engine.block_size))
        for p in prompts]
    for _ in range(1000):
        if all(r.state == "running" for r in reqs):
            return reqs
        engine.step()
    raise AssertionError(f"rows never all ran: {[r.state for r in reqs]}")


def spec_profile_phase(torch, spec: dict, prompts: list) -> dict:
    """One speculative iteration's device work, profiled in two parts: the
    k+1 draft decode steps and the verify step, on an engine built from
    ``spec`` with every prompt's row running."""
    from polyaxon_tpu_torch.serve.model import decode_step, verify_step
    from polyaxon_tpu_torch.serve.runtime import build_engine

    engine = build_engine(spec)
    reqs = running_rows(engine, prompts)
    k = engine.spec_k
    dev = engine.device
    tokens0 = torch.tensor([r.next_token for r in reqs], device=dev)
    pos0 = torch.tensor([r.seq.length for r in reqs], device=dev)
    active = torch.ones(len(reqs), dtype=torch.bool, device=dev)
    t_tables = torch.as_tensor(engine.cache.block_table_array(
        [r.seq for r in reqs], engine.max_blocks_per_seq), device=dev)
    d_tables = torch.as_tensor(engine.draft_cache.block_table_array(
        [r.draft_seq for r in reqs], engine.max_blocks_per_seq), device=dev)
    proposals = []

    def draft_steps():
        tok, pos = tokens0, pos0
        proposals.clear()
        for j in range(k + 1):
            logits = decode_step(engine.draft_params, tok, pos, engine.draft_cache.k,
                                 engine.draft_cache.v, d_tables, active,
                                 cfg=engine.draft_cfg, impl=engine.attn_impl)
            pos = pos + 1
            if j < k:
                tok = torch.argmax(logits, dim=-1)
                proposals.append(tok)

    def verify():
        window = torch.cat([tokens0[:, None], torch.stack(proposals, dim=1)], dim=1)
        verify_step(engine.params, window, pos0, engine.cache.k, engine.cache.v,
                    t_tables, active, cfg=engine.cfg).cpu()

    draft_steps()  # warm-up, and the proposals verify() reads
    verify()
    draft = profile_steps(torch, draft_steps, steps=1)
    ver = profile_steps(torch, verify, steps=1, kernels=())
    return {"rows": len(reqs), "draft_device_ms": draft["device_ms_per_step"],
            "draft_wall_ms": draft["wall_ms_per_step"],
            "draft_paged_ms": draft["paged_decode_ms_per_step"],
            "verify_device_ms": ver["device_ms_per_step"],
            "verify_wall_ms": ver["wall_ms_per_step"],
            "verify_gemm_ms": ver["gemm_ms_per_step"],
            "verify_top_kernels": ver["top_kernels"][:4]}


def verify_check(torch, params, cfg, impl: str, window: int, lengths=VERIFY_LENGTHS) -> dict:
    """verify_step's logits[:, j] against decode_step's (``impl``) at the
    same positions, fed the same window one token at a time, on copies of
    one prefilled cache; returns the largest difference per position."""
    import numpy as np

    from polyaxon_tpu_torch.serve.model import decode_step, verify_step

    dev = params["embed"]["tokens"].device
    rng = np.random.default_rng(2)
    bs = SERVE_SPEC["block_size"]
    cache, tables = prefilled_rows(torch, params, cfg, dev, lengths, bs,
                                   -(-SERVE_SPEC["max_seq_len"] // bs),
                                   SERVE_SPEC["prefill_chunk"], rng, room=window)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (len(lengths), window)),
                             device=dev)
    positions = torch.as_tensor(lengths, device=dev)
    active = torch.ones(len(lengths), dtype=torch.bool, device=dev)
    k2, v2 = cache.k.clone(), cache.v.clone()
    ver = verify_step(params, tokens, positions, cache.k, cache.v, tables, active, cfg=cfg)
    diffs = []
    for j in range(window):
        dec = decode_step(params, tokens[:, j], positions + j, k2, v2, tables, active,
                          cfg=cfg, impl=impl)
        if not (torch.isfinite(dec).all() and torch.isfinite(ver[:, j]).all()):
            raise AssertionError(f"non-finite logits at window position {j} ({impl})")
        diffs.append((ver[:, j] - dec).abs().max().item())
    return {"max_logit_diff": max(diffs), "per_position": diffs, "logit_tol": LOGIT_TOL}


def run_engine(engine, prompts: list, max_new: int) -> dict:
    """Submit every prompt greedy at once (after one short warm-up request)
    and step the engine on this thread until all finish; the paged kernel's
    launches are counted over the timed requests only."""
    from polyaxon_tpu_torch.serve.engine import SamplingParams

    pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    warm = engine.submit(prompts[0][:16], SamplingParams(max_new_tokens=4))
    while warm.state not in ("done", "failed"):
        engine.step()
    snap0 = engine.snapshot()
    pa.reset_launch_counts()
    t0 = time.monotonic()
    reqs = [engine.submit(p, SamplingParams(max_new_tokens=max_new)) for p in prompts]
    while not all(r.state in ("done", "failed") for r in reqs):
        engine.step()
    wall_s = time.monotonic() - t0
    snap = engine.snapshot()
    if any(r.state != "done" or len(r.out_tokens) != max_new for r in reqs):
        raise AssertionError(f"requests failed: {[(r.state, r.error) for r in reqs]}")
    proposed = snap["spec_tokens_proposed"] - snap0["spec_tokens_proposed"]
    accepted = snap["spec_tokens_accepted"] - snap0["spec_tokens_accepted"]
    return {"tokens": [r.out_tokens for r in reqs], "wall_s": wall_s,
            "tokens_per_s": sum(len(r.out_tokens) for r in reqs) / wall_s,
            "iterations": snap["decode_steps"] - snap0["decode_steps"],
            "launches": pa.launch_counts["paged_decode"],
            "tokens_proposed": proposed, "tokens_accepted": accepted,
            "acceptance": accepted / proposed if proposed else None,
            "kv_audit_violations": snap["kv_audit_violations"]}


def spec_accept_phase(torch, prompts: list, max_new: int, device: str = "cuda") -> dict:
    """The JAX package's acceptance fixture at full width: a llama-1b
    draft (seed 0) and a target that is the draft plus 22 identity layers,
    so the two agree by construction up to rounding. verify_step against
    decode_step on the draft first (gather and flash), then speculative
    and plain decode of the target with each impl."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY, transformer
    from polyaxon_tpu_torch.serve.engine import ServeEngine
    from polyaxon_tpu_torch.serve.model import extend_with_identity_layers, serving_params

    cfg = replace(REGISTRY[SERVE_SPEC["model"]][1], max_seq=SERVE_SPEC["max_seq_len"])
    draft = serving_params(transformer.init(cfg, seed=0, device=device), cfg)
    target, target_cfg = extend_with_identity_layers(draft, cfg, ACCEPT_EXTRA_LAYERS)
    out = {"draft_layers": cfg.num_layers, "target_layers": target_cfg.num_layers,
           "k": SPEC_K, "max_new": max_new}
    for impl in ("gather", "flash"):
        check = verify_check(torch, draft, cfg, impl, SPEC_K + 1)
        out[f"verify_vs_decode_{impl}"] = check
        if not check["max_logit_diff"] <= LOGIT_TOL:
            raise AssertionError(f"verify vs decode ({impl}) logits differ by "
                                 f"{check['max_logit_diff']} > {LOGIT_TOL}")
    kw = dict(max_slots=SERVE_SPEC["max_slots"], block_size=SERVE_SPEC["block_size"],
              max_seq_len=SERVE_SPEC["max_seq_len"], prefill_chunk=SERVE_SPEC["prefill_chunk"])
    for impl in ("gather", "flash"):
        plain = run_engine(ServeEngine(target, target_cfg, attn_impl=impl, **kw),
                           prompts, max_new)
        spec = run_engine(ServeEngine(target, target_cfg, attn_impl=impl, draft_params=draft,
                                      draft_cfg=cfg, spec_k=SPEC_K, **kw), prompts, max_new)
        same = [a == b for a, b in zip(spec["tokens"], plain["tokens"])]
        first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                      for a, b in zip(spec["tokens"], plain["tokens"])]
        row = {"acceptance": spec["acceptance"], "tokens_proposed": spec["tokens_proposed"],
               "tokens_accepted": spec["tokens_accepted"],
               "spec_iterations": spec["iterations"], "plain_steps": plain["iterations"],
               "spec_tokens_per_s": spec["tokens_per_s"],
               "plain_tokens_per_s": plain["tokens_per_s"],
               "speedup": spec["tokens_per_s"] / plain["tokens_per_s"],
               "rows_identical_to_plain": sum(same), "rows": len(same),
               "first_divergence": first_diff, "spec_launches": spec["launches"],
               "plain_launches": plain["launches"],
               "kv_audit_violations": spec["kv_audit_violations"]}
        out[impl] = row
        if row["kv_audit_violations"]:
            raise AssertionError(f"KV refcount audit violations ({impl})")
        if impl == "flash":
            want_spec = spec["iterations"] * (SPEC_K + 1) * cfg.num_layers
            want_plain = plain["iterations"] * target_cfg.num_layers
            if (spec["launches"], plain["launches"]) != (want_spec, want_plain):
                raise AssertionError(
                    f"paged launches {spec['launches']} / {plain['launches']} != "
                    f"{want_spec} (iterations x (k+1) x draft layers) / {want_plain} "
                    f"(steps x target layers)")
        elif spec["launches"] or plain["launches"]:
            raise AssertionError("the gather path launched the paged kernel")
    if not out["gather"]["acceptance"] >= ACCEPT_MIN:
        raise AssertionError(f"acceptance {out['gather']['acceptance']} < {ACCEPT_MIN} on "
                             f"the identity-extended target (gather)")
    return out


# -- phase 10: checkpoint save, restore and import ------------------------------------


def one_step_logits(torch, engine, lengths=VERIFY_LENGTHS):
    """Logits of one decode step (the engine's impl) over rows prefilled
    with fixed random tokens, through the engine's own params."""
    import numpy as np

    from polyaxon_tpu_torch.serve.model import decode_step

    rng = np.random.default_rng(3)
    dev = engine.device
    cache, tables = prefilled_rows(torch, engine.params, engine.cfg, dev, lengths,
                                   engine.block_size, engine.max_blocks_per_seq,
                                   engine.prefill_chunk, rng)
    tokens = torch.as_tensor(rng.integers(0, engine.cfg.vocab_size, len(lengths)), device=dev)
    return decode_step(engine.params, tokens, torch.as_tensor(lengths, device=dev),
                       cache.k, cache.v, tables,
                       torch.ones(len(lengths), dtype=torch.bool, device=dev),
                       cfg=engine.cfg, impl=engine.attn_impl)


def restore_phase(torch, fa, train_spec: dict, serve_spec: dict) -> dict:
    """Train llama-1b RESTORE_STEPS step(s) through the builtin runtime's
    trainer, save the state (params, AdamW moments, step) with the port's
    Checkpointer, restore it into a fresh state (every leaf bit-equal), then
    serve it through build_engine's ``checkpoint:`` and, after
    export_hf_llama, its ``import:``: one decode step's logits must equal
    those of an engine built from the in-memory params, bit for bit."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.partition.convert import export_hf_llama
    from polyaxon_tpu_torch.partition.rules import tree_paths
    from polyaxon_tpu_torch.runtime.builtin import build_trainer
    from polyaxon_tpu_torch.serve.engine import ServeEngine
    from polyaxon_tpu_torch.serve.runtime import build_engine
    from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from polyaxon_tpu_torch.train.trainer import state_from_tree, state_tree

    spec = dict(train_spec, steps=RESTORE_STEPS, log_interval=RESTORE_STEPS)
    trainer, batches = build_trainer(spec)
    state, _ = trainer.restore_or_init()
    fa.reset_launch_counts()
    state, metrics = trainer.fit(batches, RESTORE_STEPS, state=state)
    launches = dict(fa.launch_counts)
    expected = flash_launch_formula(spec, trainer.cfg.model.num_layers)
    if launches != expected:
        raise AssertionError(f"flash launches {launches} != formula {expected}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_restore_")
    out = {"train_steps": RESTORE_STEPS, "train_loss": metrics["loss"], "tmp_dir": tmp,
           "flash_launches": launches, "free_disk_gib": shutil.disk_usage(tmp).free / 2**30}
    try:
        ck = Checkpointer(CheckpointConfig(directory=os.path.join(tmp, "ck")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.maybe_save(state.step, state_tree(state), force=True)
        t1 = time.perf_counter()
        ck.wait()
        t2 = time.perf_counter()
        _, nbytes, write_s = ck.last_write
        out.update({"bytes": nbytes, "host_copy_s": t1 - t0, "write_s": write_s,
                    "save_total_s": t2 - t0, "write_gb_per_s": nbytes / write_s / 1e9,
                    "save_gb_per_s": nbytes / (t2 - t0) / 1e9,
                    "layout": sorted(os.listdir(os.path.join(tmp, "ck", str(state.step)))),
                    "one_file_save_total_s": ONE_FILE_SAVE_S})
        fresh = trainer.init_state(seed=1)
        t3 = time.perf_counter()
        tree, step = ck.restore(state_tree(fresh))
        restored = state_from_tree(tree)
        torch.cuda.synchronize()
        out.update({"restored_step": step, "restore_s": time.perf_counter() - t3,
                    "restore_gb_per_s": nbytes / (time.perf_counter() - t3) / 1e9,
                    "one_file_restore_s": ONE_FILE_RESTORE_S})
        leaves = 0
        for (path, a), (_, b) in zip(tree_paths(state_tree(state)),
                                     tree_paths(state_tree(restored))):
            same = (a.dtype == b.dtype and torch.equal(a, b)) \
                if isinstance(a, torch.Tensor) else a == b
            if not same:
                raise AssertionError(f"restored leaf {path} differs from the saved one")
            leaves += 1
        out["leaves_bit_equal"] = leaves
        del fresh, restored, tree

        cfg_spec = {k: v for k, v in serve_spec.items() if k != "warmup"}
        by_ckpt = build_engine({**cfg_spec, "checkpoint": os.path.join(tmp, "ck")})
        reference = ServeEngine(state.params, by_ckpt.cfg, max_slots=by_ckpt.max_slots,
                                block_size=by_ckpt.block_size,
                                prefill_chunk=by_ckpt.prefill_chunk,
                                max_seq_len=by_ckpt.max_seq_len, attn_impl=by_ckpt.attn_impl)
        ref = one_step_logits(torch, reference)
        del reference
        got = one_step_logits(torch, by_ckpt)
        out["checkpoint_provenance"] = by_ckpt.provenance
        del by_ckpt
        if not torch.isfinite(ref).all():
            raise AssertionError("non-finite logits from the trained params")
        if not torch.equal(got, ref):
            raise AssertionError(f"checkpoint-served logits differ by "
                                 f"{(got - ref).abs().max().item()}")
        t4 = time.perf_counter()
        export_hf_llama(state.params, trainer.cfg.model, os.path.join(tmp, "hf"))
        out["export_s"] = time.perf_counter() - t4
        t5 = time.perf_counter()
        by_import = build_engine({**cfg_spec, "import": {"path": os.path.join(tmp, "hf"),
                                                         "layout": "hf-llama"}})
        out["import_engine_build_s"] = time.perf_counter() - t5
        got = one_step_logits(torch, by_import)
        del by_import
        if not torch.equal(got, ref):
            raise AssertionError(f"import-served logits differ by "
                                 f"{(got - ref).abs().max().item()}")
        out["logits_bit_equal"] = ["checkpoint", "import"]
        out["import_lora"] = import_lora_check(torch, train_spec, os.path.join(tmp, "hf"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def import_lora_check(torch, train_spec: dict, hf_dir: str) -> dict:
    """One step of ``run_builtin`` with ``import:`` (the HF export) and
    ``lora:``, and one with the import alone: the step-0 losses are equal
    bit for bit (b = 0, so the merged base is the imported base)."""
    from polyaxon_tpu_torch.runtime.builtin import run_builtin

    spec = {**train_spec, **IMPORT_LORA_KEYS,
            "import": {"path": hf_dir, "layout": "hf-llama"}}
    losses = {}
    for name, run_spec in (("import", spec), ("import_lora", {**spec, "lora": LORA_KEYS})):
        logged = []
        t0 = time.monotonic()
        run_builtin(run_spec, track=lambda step, m: logged.append(m["loss"]))
        losses[name] = {"loss0": logged[0], "wall_s": time.monotonic() - t0}
        gc.collect()
        torch.cuda.empty_cache()
    if losses["import_lora"]["loss0"] != losses["import"]["loss0"]:
        raise AssertionError(f"import + lora step-0 loss {losses['import_lora']['loss0']} != "
                             f"the plain import's {losses['import']['loss0']}")
    return {**losses, "bit_equal": True}


# -- sharded state ------------------------------------------------------------

# sharded_init: examples/mixtral_ep_tpujob.yaml's mesh, two of its 64 ranks
# built in this process (no group: a rank's blocks are a pure function of
# the mesh's sizes and its coordinates); llama2-7b's eight {fsdp: 8} blocks
# against the whole {fsdp: 1} init
SHARDED_INIT_MIXTRAL = ("mixtral-8x7b", {"expert": 8, "fsdp": 8}, (0, 63))
SHARDED_INIT_LLAMA = ("llama2-7b", {"fsdp": 8})
# the rise of max_memory_allocated over a block's build beyond the block
# and one slice: the allocator's rounding and the generators' states
SHARDED_INIT_SLACK = 64 * 2**20
SHARDED_INIT_FAULTS = ("neighbour_coords", "seed_without_layer")
# train_7b_import_lora: examples/llama7b_import_lora.yaml's keys at one card
# (IMPORT_7B_REDUCED lists each cut); its import is the smoke's own hf-llama
# export of a random init in bf16
IMPORT_7B_SPEC = {
    "model": "llama2-7b", "steps": 3, "batch_size": 8, "microbatches": 4, "seq_len": 2048,
    "learning_rate": 1.0e-4, "remat": "attn_qkv", "lora": LORA_KEYS,
    "partition_rules": [["embed/tokens$", [None, "fsdp"]]], "parallelism": {"fsdp": 1},
    "checkpoint": False, "log_interval": 1, "data": {"kind": "synthetic-lm"},
    "platform": "cuda"}
IMPORT_7B_REDUCED = {"steps": "2000 -> 3", "batch_size": "64 -> 8 in 4 microbatches",
                     "parallelism": "{fsdp: 64} -> {fsdp: 1}",
                     "import.path": "a random init's hf-llama export, not the published weights"}
# the one-file layout's save and restore of the restore phase's state
# (NVIDIA H100 80GB HBM3, 700.00 W), beside this layout's
ONE_FILE_SAVE_S, ONE_FILE_RESTORE_S = 24.79, 9.82


def virtual_trainer(torch, model: str, parallelism: dict, rank: int, *, device="cuda"):
    """The Trainer of ``model`` at ``rank`` of a mesh of ``parallelism``
    that no process group backs (nothing here runs a collective), on the
    card."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.parallel.mesh import Mesh, mesh_sizes
    from polyaxon_tpu_torch.train import Trainer, TrainerConfig, task_for

    family, cfg = REGISTRY[model]
    if cfg.num_experts:
        cfg = replace(cfg, moe_dispatch="a2a")  # the example's dispatch
    world = math.prod(parallelism.values())
    mesh = Mesh(sizes=mesh_sizes(parallelism, world), rank=rank, distributed=True,
                declared=frozenset(parallelism))
    return Trainer(TrainerConfig(model=cfg, parallelism=parallelism),
                   device=torch.device(device), mesh=mesh, task=task_for(family, cfg))


def largest_slice_bytes(task) -> int:
    """The largest slice of a task's init laws (one layer of a stacked
    leaf, one expert of one layer, a leaf without layers), in bytes."""
    from polyaxon_tpu_torch.partition.rules import tree_paths

    return max(math.prod(law.shape[law.lead:]) * law.dtype.itemsize
               for _, law in tree_paths(task.param_laws()))


def distinct_slices(torch, trainer, params: dict, name: str) -> int:
    """Every drawn leaf's slices in ``params`` differ pairwise (on their
    first 64 values): a slice seed that loses an index repeats a slice.
    Returns how many slices were compared."""
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.partition.rules import tree_paths

    laws = dict(tree_paths(trainer.task.param_laws()))
    compared = 0
    for path, t in flatten(params):
        law = laws["/".join(path)]
        if law.lead == 0 or law.kind in ("zeros", "ones"):
            continue
        rows = t.reshape(math.prod(t.shape[:law.lead]), -1)[:, :64]
        if torch.unique(rows, dim=0).shape[0] != rows.shape[0]:
            raise AssertionError(f"{name}: slices of {'/'.join(path)} repeat")
        compared += rows.shape[0]
    return compared


def sharded_init_phase(torch, fault: Optional[str] = None) -> dict:
    """mixtral-8x7b's blocks of ranks 0 and 63 at {expert: 8, fsdp: 8}:
    each block's bytes the plan's bytes per device, the rise of
    max_memory_allocated at most the block plus one slice plus
    SHARDED_INIT_SLACK, every slice distinct; llama2-7b's eight {fsdp: 8}
    blocks each equal to its block of the whole {fsdp: 1} init, bit for
    bit. ``fault`` (SHARDED_INIT_FAULTS) plants a rank that builds its
    neighbour's coordinates or a slice seed without its indices; the phase
    must then fail."""
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.parallel import blocks
    from polyaxon_tpu_torch.parallel.mesh import Mesh
    from polyaxon_tpu_torch.partition.plan import build_plan

    seed_fn = blocks.slice_seed
    if fault == "seed_without_layer":
        blocks.slice_seed = lambda seed, key, index: seed_fn(seed, key, ())
    try:
        out = {}
        model, para, ranks = SHARDED_INIT_MIXTRAL
        plan = build_plan(model, parallelism=para, num_devices=math.prod(para.values()))
        want = plan["summary"]["bytes_per_device"]
        for rank in ranks:
            trainer = virtual_trainer(torch, model, para, rank)
            slice_bytes = largest_slice_bytes(trainer.task)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            params = trainer.init_params(seed=0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rise = torch.cuda.max_memory_allocated() - start
            nbytes = sum(t.numel() * t.element_size() for _, t in flatten(params))
            bound = nbytes + slice_bytes + SHARDED_INIT_SLACK
            row = {"block_bytes": nbytes, "plan_bytes_per_device": want,
                   "largest_slice_bytes": slice_bytes, "peak_rise_bytes": rise,
                   "bound_bytes": bound, "seconds": seconds,
                   "coords": {a: c for a, c in trainer.mesh.coords().items()
                              if trainer.mesh.sizes[a] > 1}}
            if nbytes != want:
                raise AssertionError(f"{model} rank {rank}: block of {nbytes} bytes, the plan's "
                                     f"bytes per device {want}")
            if rise > bound:
                raise AssertionError(f"{model} rank {rank}: the build rose {rise} bytes over "
                                     f"its start, beyond the block + a slice + slack {bound}")
            row["slices_distinct"] = distinct_slices(torch, trainer, params,
                                                     f"{model} rank {rank}")
            out[f"{model}/rank{rank}"] = row
            del params, trainer
        gc.collect()
        torch.cuda.empty_cache()

        model, para = SHARDED_INIT_LLAMA
        world = math.prod(para.values())
        t0 = time.perf_counter()
        whole = virtual_trainer(torch, model, {"fsdp": 1}, 0).init_params(seed=0)
        torch.cuda.synchronize()
        row = {"whole_seconds": time.perf_counter() - t0,
               "whole_bytes": sum(t.numel() * t.element_size() for _, t in flatten(whole)),
               "rank_seconds": []}
        for rank in range(world):
            # the planted fault builds the next rank's blocks in rank's place
            built = (rank + 1) % world if fault == "neighbour_coords" else rank
            trainer = virtual_trainer(torch, model, para, built)
            t0 = time.perf_counter()
            params = trainer.init_params(seed=0)
            torch.cuda.synchronize()
            row["rank_seconds"].append(time.perf_counter() - t0)
            ref = Mesh(sizes=trainer.mesh.sizes, rank=rank)
            cuts = trainer.placement().cuts
            for (path, b), (_, w) in zip(flatten(params), flatten(whole)):
                for axis, dim in cuts.get("/".join(path), ()):
                    w = ref.block(w, dim, axis)
                if not torch.equal(b, w):
                    raise AssertionError(f"{model} rank {rank}'s block of {'/'.join(path)} "
                                         f"differs from its block of the whole init")
            if rank == 0:
                row["slices_distinct"] = distinct_slices(torch, trainer, params,
                                                         f"{model} rank 0")
            del params, trainer
        row["blocks_bit_equal"] = world
        out[f"{model}/fsdp{world}"] = row
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        return out
    finally:
        blocks.slice_seed = seed_fn


def sharded_init_faults_phase(torch) -> dict:
    """Each SHARDED_INIT_FAULTS fault must fail sharded_init."""
    out = {}
    for fault in SHARDED_INIT_FAULTS:
        try:
            sharded_init_phase(torch, fault)
        except AssertionError as e:
            out[fault] = {"caught": str(e)[:300]}
        else:
            raise AssertionError(f"the planted fault {fault} passed sharded_init")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_7b_import_lora_phase(torch, fa) -> dict:
    """A random-init llama2-7b exported in bf16 as hf-llama (the port's
    ``export_hf_llama``, into a temporary directory removed after), then
    ``run_builtin`` at IMPORT_7B_SPEC with ``import: {layout: hf-llama,
    dtype: bfloat16}`` (train_phase's checks: losses finite, step 0 near ln
    32000, B1-B3 at D=128 launched as their formula says), and the
    trainer's first step on the import alone with nothing trained: its
    loss must equal the LoRA run's step-0 loss bit for bit (b = 0). Each import's rise of max_memory_allocated must stay
    within the bf16 base plus one layer."""
    import shutil
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.models.transformer import init as init_params
    from polyaxon_tpu_torch.partition import convert
    from polyaxon_tpu_torch.partition.lora import FrozenBaseOptimizer
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    cfg = replace(REGISTRY["llama2-7b"][1], param_dtype=torch.bfloat16)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_7b_")
    hf = os.path.join(tmp, "hf")
    real = convert.import_params
    try:
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=torch.device("cuda", 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        convert.export_hf_llama(params, cfg, hf)
        out = {"reduced": IMPORT_7B_REDUCED, "init_s": t1 - t0,
               "export_s": time.perf_counter() - t1, "tmp_dir": tmp,
               "free_disk_gib": shutil.disk_usage(tmp).free / 2**30}
        base = sum(t.numel() * t.element_size() for _, t in flatten(params))
        layer = sum(t[0].numel() * t.element_size() for _, t in flatten(params["layers"]))
        out.update(base_bytes=base, layer_bytes=layer)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        imports = []

        def measured(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t = time.perf_counter()
            result = real(*args, **kwargs)
            torch.cuda.synchronize()
            imports.append({"seconds": time.perf_counter() - t,
                            "peak_rise_bytes": torch.cuda.max_memory_allocated() - start})
            return result

        convert.import_params = measured
        spec = {**IMPORT_7B_SPEC, "import": {"path": hf, "layout": "hf-llama",
                                             "dtype": "bfloat16"}}
        run = train_phase(torch, fa, spec, loss0_margin=LLAMA7B_LOSS0_MARGIN)
        gc.collect()
        torch.cuda.empty_cache()
        # the import alone: the trainer's first step on the same batch with
        # nothing trained (the step-0 loss comes before any update; no
        # optimizer of the whole base fits beside its f32 grads on one card)
        t2 = time.monotonic()
        trainer, batches = build_trainer({k: v for k, v in spec.items() if k != "lora"})
        trainer.tx = FrozenBaseOptimizer(trainer.tx)
        state = trainer.init_state_from_blocks(convert.import_params(
            hf, trainer.cfg.model, device=trainer.device, layout="hf-llama",
            dtype="bfloat16", placement=trainer.placement()))
        alone = float(trainer.make_step()(state, next(batches))[1]["loss"])
        del trainer, state
        out.update(run, import_alone_loss0=alone, import_alone_wall_s=time.monotonic() - t2,
                   imports=imports)
        if run["losses"][0] != alone:
            raise AssertionError(f"import + lora step-0 loss {run['losses'][0]} != the "
                                 f"import alone's {alone}")
        for imp in imports:
            if imp["peak_rise_bytes"] > base + layer:
                raise AssertionError(f"an import rose {imp['peak_rise_bytes']} bytes over its "
                                     f"start, beyond the bf16 base + one layer {base + layer}")
        out["loss0_bit_equal"] = True
        return out
    finally:
        convert.import_params = real
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# -- the control-plane bridge ----------------------------------------------------

# what the bridge phase adds to the train phase's spec: a progress beat at
# most every second and resource samples every second (chaos stays off)
BRIDGE_TRAIN_KEYS = {"progress_interval": 1.0, "resources": {"interval": 1}}
# the serve phase's settings, the reporter beating twice a second, the
# decode watchdog on (its defaults)
BRIDGE_SERVE_KEYS = {"report_interval": 0.5, "watchdog": True}
# the drain check's requests: long enough that they are still decoding
# when the reporter reads the marker (it reads every report_interval)
BRIDGE_MAX_NEW = 2 * MAX_NEW
# the profile run: the train spec's widths and depth, fewer microbatches,
# the last of its steps traced
PROFILE_SPEC = {"steps": 3, "batch_size": 4, "microbatches": 2, "profile": {"steps": 1}}


class ApiRecorder:
    """The control plane's API as a pod sees it, on the standard library:
    every POST answers 200 and is recorded as (verb, body), the verb being
    the path's last segment (statuses, heartbeat, outputs, lineage)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.records: list = []
        lock = threading.Lock()
        records = self.records

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                with lock:
                    records.append((self.path.rsplit("/", 1)[-1],
                                    json.loads(raw) if raw else None))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def bodies(self, verb: str) -> list:
        return [b for v, b in list(self.records) if v == verb]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class BridgeEnv:
    """A recorder as the API host and a temporary artifacts directory, in
    the environment the control plane gives a pod; both removed after."""

    KEYS = ("PLX_API_HOST", "PLX_ARTIFACTS_PATH", "PLX_RUN_UUID", "PLX_PROJECT")

    def __init__(self, run_uuid: str):
        import tempfile

        self.recorder = ApiRecorder()
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_bridge_")
        self._saved = {k: os.environ.get(k) for k in self.KEYS}
        os.environ.update(PLX_API_HOST=self.recorder.url, PLX_ARTIFACTS_PATH=self.dir,
                          PLX_RUN_UUID=run_uuid, PLX_PROJECT="chip-smoke")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import shutil

        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.recorder.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def bridge_train_phase(torch, fa, spec: dict) -> dict:
    """The train phase's ``run_builtin`` with the tracking bridge on,
    reporting to the recorder: the statuses, progress heartbeats and
    outputs it received, the GPU samples in the run's events, and the
    flash launches against their formula. ``bridge_host_s_per_step`` is
    the host time spent inside the bridge's callbacks, per step."""
    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.runtime.builtin import run_builtin
    from polyaxon_tpu_torch.tracking import read_events

    spec = {**spec, **BRIDGE_TRAIN_KEYS}
    with BridgeEnv("chip-smoke-train") as env:
        fa.reset_launch_counts()
        t0 = time.monotonic()
        summary = run_builtin(dict(spec))
        wall_s = time.monotonic() - t0
        launches = dict(fa.launch_counts)
        rec = env.recorder
        statuses = [b["status"] for b in rec.bodies("statuses")]
        beats = [b for b in rec.bodies("heartbeat") if b and "step" in b]
        outputs: dict = {}
        for b in rec.bodies("outputs"):
            outputs.update(b)
        gpu_mem = [e.metric for e in read_events(env.dir, "metric", "gpu0_mem_gib")]
        gpu_peak = [e.metric for e in read_events(env.dir, "metric", "gpu0_mem_peak_gib")]
        lineage = [b["name"] for b in rec.bodies("lineage")]
    expected = flash_launch_formula(spec, REGISTRY[spec["model"]][1].num_layers)
    out = {"statuses": statuses, "progress_steps": [b["step"] for b in beats],
           "outputs_mfu": outputs.get("mfu"),
           "outputs_tokens_per_sec_per_chip": outputs.get("tokens_per_sec_per_chip"),
           "final_mfu": summary["mfu"],
           "final_tokens_per_sec_per_chip": summary["tokens_per_sec_per_chip"],
           "gpu0_mem_gib_samples": len(gpu_mem),
           "gpu0_mem_gib_max": max(gpu_mem, default=None),
           "gpu0_mem_peak_gib_max": max(gpu_peak, default=None),
           "lineage": lineage, "launches": launches, "expected_launches": expected,
           "step_time_p50_ms": summary["step_time_p50_ms"], "wall_s": wall_s,
           "bridge_host_s": summary["bridge_host_s"],
           "bridge_host_s_per_step": summary["bridge_host_s"] / int(spec["steps"]),
           "posts": len(rec.records)}
    if statuses != ["running", "succeeded"]:
        raise AssertionError(f"statuses received {statuses}, want running then succeeded")
    if not beats or not any(b["step"] >= 0 for b in beats):
        raise AssertionError("no progress heartbeat carried a step")
    if beats[-1]["step"] != int(spec["steps"]):
        raise AssertionError(f"last progress step {beats[-1]['step']} != {spec['steps']}")
    if "mfu" not in outputs or outputs["mfu"] != summary["mfu"] \
            or outputs.get("tokens_per_sec_per_chip") != summary["tokens_per_sec_per_chip"]:
        raise AssertionError(f"outputs mfu/tokens {outputs.get('mfu')}/"
                             f"{outputs.get('tokens_per_sec_per_chip')} != final "
                             f"{summary['mfu']}/{summary['tokens_per_sec_per_chip']}")
    return out


def _healthz(base: str) -> int:
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _wait_healthz(base: str, status: int, timeout: float = 30.0) -> float:
    t0 = time.monotonic()
    while _healthz(base) != status:
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"/healthz never answered {status}")
        time.sleep(0.02)
    return time.monotonic() - t0


def bridge_serve_phase(torch, spec: dict, prompts: list, max_new: int) -> dict:
    """``start_replica`` (the serve runtime's replica, as a pod runs it)
    with the reporter and the watchdog, reporting to the recorder: the
    heartbeats carry the ``serve`` payload; a drain marker written while
    requests decode flips /healthz to 503 and refuses a new request while
    the in-flight ones finish; removing it reopens admission; the paged
    kernel's launches equal decode steps x layers."""
    from polyaxon_tpu_torch.serve.runtime import start_replica

    pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    with BridgeEnv("chip-smoke-serve") as env:
        rep = start_replica({**spec, **BRIDGE_SERVE_KEYS, "port": 0})
        engine, base = rep.engine, f"http://127.0.0.1:{rep.port}"
        try:
            wait_healthy(base)
            pa.reset_launch_counts()
            steps0, done0 = engine.decode_steps, engine.snapshot()["requests_total"]
            results: list = []
            # every request at once (no staggered prefix sharer): all are
            # accepted before the marker closes admission
            sender = threading.Thread(
                target=lambda: results.extend(
                    drive_requests(base, prompts, max_new, shared_rows=(-1, -1))),
                daemon=True)
            sender.start()
            deadline = time.monotonic() + 300
            while (engine.running_count + engine.waiting_count
                   + engine.snapshot()["requests_total"] - done0) < len(prompts):
                if time.monotonic() > deadline or not sender.is_alive():
                    raise TimeoutError("the requests were not all accepted")
                time.sleep(0.002)
            marker = os.path.join(env.dir, "serve-drain-0.json")
            with open(marker, "w", encoding="utf-8") as f:
                json.dump({"replica": 0, "expires_at": time.time() + 600}, f)
            t_marker = time.monotonic()
            while not engine.draining:
                if time.monotonic() - t_marker > 30:
                    raise TimeoutError("the reporter never read the drain marker")
                time.sleep(0.001)
            in_flight = engine.running_count + engine.waiting_count
            drain_s = time.monotonic() - t_marker
            _wait_healthz(base, 503)
            try:
                with _post(base + "/generate", {"tokens": [1, 2, 3], "max_new_tokens": 2}):
                    refused = None
            except urllib.error.HTTPError as e:
                refused = e.code
            sender.join(timeout=600)
            if sender.is_alive():
                raise TimeoutError("the in-flight requests did not finish while draining")
            os.unlink(marker)
            reopen_s = _wait_healthz(base, 200)
            launches = pa.launch_counts["paged_decode"]
            steps = engine.decode_steps - steps0
            time.sleep(2 * BRIDGE_SERVE_KEYS["report_interval"])
        finally:
            rep.close()
            rep.run.end()
        rec = env.recorder
        beats = [b for b in rec.bodies("heartbeat") if b and "serve" in b]
        outputs: dict = {}
        for b in rec.bodies("outputs"):
            outputs.update(b)
        statuses = [(b["status"], b.get("reason")) for b in rec.bodies("statuses")]
    layers = engine.cfg.num_layers
    out = {"heartbeats": len(beats), "draining_beats": sum(b["serve"]["draining"] for b in beats),
           "history_series": len((beats[-1].get("metrics") or {}).get("series", []))
           if beats else 0,
           "statuses": statuses, "drain_503_after_s": drain_s, "in_flight_at_503": in_flight,
           "new_request_during_drain": refused, "reopen_200_after_s": reopen_s,
           "requests_done": len(results), "launches": launches, "decode_steps": steps,
           "layers": layers, "serve_tokens_per_sec": outputs.get("serve_tokens_per_sec"),
           "serve_ttft_p50_ms": outputs.get("serve_ttft_p50_ms"),
           "serve_ttft_p95_ms": outputs.get("serve_ttft_p95_ms"),
           "watchdog_fired": rep.watchdog.fired}
    if not beats:
        raise AssertionError("no heartbeat carried the serve payload")
    if not out["draining_beats"]:
        raise AssertionError("no heartbeat reported the drain")
    if in_flight <= 0:
        raise AssertionError("the marker's drain began after the requests had finished")
    if refused != 503:
        raise AssertionError(f"a request during the drain answered {refused}, not 503")
    if len(results) != len(prompts) or any(len(r["tokens"]) != max_new for r in results):
        raise AssertionError("an in-flight request did not finish during the drain")
    if steps <= 0:
        raise AssertionError("no decode step ran")
    if outputs.get("serve_tokens_per_sec") is None or outputs.get("serve_ttft_p50_ms") is None:
        raise AssertionError(f"serve outputs missing: {sorted(outputs)}")
    if rep.watchdog.fired:
        raise AssertionError("the decode watchdog fired")
    return out


def bridge_profile_phase(torch, spec: dict) -> dict:
    """``profile: {steps: 1}`` through ``run_builtin``: a non-empty
    Chrome trace under ``outputs/profile`` and its ``profile`` artifact."""
    from polyaxon_tpu_torch.runtime.builtin import run_builtin

    spec = {**spec, **PROFILE_SPEC}
    with BridgeEnv("chip-smoke-profile") as env:
        summary = run_builtin(dict(spec))
        trace = os.path.join(env.dir, "outputs", "profile", "trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        lineage = [b["name"] for b in env.recorder.bodies("lineage")]
    out = {"trace_bytes": size, "trace_events": len(events), "kernel_events": kernels,
           "lineage": lineage, "measured_steps": summary["steps"]}
    if size <= 0 or not events:
        raise AssertionError("the profile trace is empty")
    if "profile" not in lineage:
        raise AssertionError(f"no profile artifact in the lineage posts {lineage}")
    return out


# -- main --------------------------------------------------------------------


# -- the distributed phases (slice 8): data and fsdp over torch.distributed ------

# each recipe at one replica's share, under a declared mesh axis of size 1:
# bert_tfjob.yaml's 256 over 4 workers (64 x 512), resnet50_ddp.yaml's "64
# per replica" (6 steps: its ~0.1 s steps vary by tens of ms), and
# llama1b_tpujob.yaml's keys with fsdp, its batch cut from 64 to 16 in 4
# microbatches of 4 x 2048 (a multi-GPU run splits each microbatch over up
# to 4 ranks)
DIST_SPECS = {
    "bert-base": {**BERT_SPEC, "parallelism": {"data": 1}},
    "resnet50-cifar": {**RESNET_SPEC, "batch_size": 64, "steps": 6,
                       "parallelism": {"data": 1}},
    "llama-1b": {**TRAIN_SPEC, "batch_size": 16, "microbatches": 4,
                 "parallelism": {"fsdp": 1}},
    # the same keys with adafactor: under the group its factor means and
    # RMS sums run through NCCL over the fsdp axis
    "llama-1b-adafactor": {**TRAIN_SPEC, "batch_size": 16, "microbatches": 4,
                           "optimizer": "adafactor", "parallelism": {"fsdp": 1}},
}
# the multi-GPU phase: min(GPUs, 4) ranks over each spec's global batch
# (resnet50-cifar's compute replicated over model: each rank the whole batch)
DIST_MULTI = ("bert-base", "llama-1b", "llama-1b-adafactor", "resnet50-cifar")
DIST_MULTI_AXIS = {"bert-base": "data", "llama-1b": "fsdp", "llama-1b-adafactor": "fsdp",
                   "resnet50-cifar": "model"}
# adafactor's factors after one step (step_digest) at W ranks against one
# rank's: each factor's sum of squares within DIST_MULTI_RTOL's step-1
# limit (its bf16 grads are reduced over ranks in other orders)
ADAFACTOR_DIGEST_RTOL = 5e-3
# the planted faults of the multi-GPU phases, each of which must fail its
# check: adafactor factored by the rank's block shape (dist_train_multi's
# factors against one rank's), a user rule's stored leaf read unresharded
# (tp_cp_multi: a leaf the rule replicates differs between the model ranks)
MULTI_FAULTS = {"llama-1b-adafactor": "af_block_shape", "llama-1b-rule/model": "unresharded"}
# tp_cp_multi's user rule: examples/llama7b_import_lora.yaml's, which removes
# the token table's built-in model cut
EMBED_RULES = [["embed/tokens$", [None, "fsdp"]]]
# W ranks against one at the same global batch: step 0 differs only by the
# order of the loss's and the metrics' sums over ranks and the bf16
# products' row blocks (~1e-4 relative); step 1 adds the bf16 grads'
# reduction over ranks, rounded in bf16 as XLA rounds it
DIST_MULTI_RTOL = (1e-3, 5e-3)
DIST_RESULT = "dist_result"
# tp_cp_multi: W ranks of llama-1b at dist_train_1rank's keys over model or
# context (the ring), each against the 1-rank run; with 4 GPUs llama2-7b's
# state (75.3 GiB on one card) over {fsdp: 2, model: 2}, the llama7b_tpujob
# keys at batch 4 in 2 microbatches, 2 steps
TP_CP_AXES = ("model", "context")
# LoRA at dist_train_1rank's llama-1b keys: one rank in this process, then
# {model: W} (each model rank merging its block's delta)
LORA_DIST_SPEC = {**DIST_SPECS["llama-1b"], "lora": LORA_KEYS}
LLAMA7B_TP_SPEC = {
    "model": "llama2-7b", "steps": 2, "batch_size": 4, "seq_len": 2048,
    "learning_rate": 3.0e-4, "warmup_steps": 1, "remat": "attn_qkv",
    "mu_dtype": "bfloat16", "nu_dtype": "bfloat16", "grad_dtype": "bfloat16",
    "microbatches": 2, "accum_dtype": "bfloat16", "loss_chunk_tokens": 4096,
    "checkpoint": False, "log_interval": 1, "data": {"kind": "synthetic-lm"},
    "platform": "cuda", "parallelism": {"fsdp": 2, "model": 2},
}
# pp_ep_multi: llama-1b {stage: 2} at dist_train_1rank's llama-1b keys (one
# row a pipeline microbatch), against its 1-rank run; with 4 GPUs also
# examples/llama_pp_tp.yaml's keys over {stage: 2, model: 2} (steps cut from
# 200 to 3) and llama-moe-1b {stage: 2, expert: 2} with a2a at MOE_SPEC's keys
# (4 microbatches: 4 rows an expert rank, one a pipeline microbatch)
PP_SPECS = {"llama-1b/stage2": {**DIST_SPECS["llama-1b"], "parallelism": {"stage": 2},
                                "pp_microbatches": 4}}
PP_EP_SPECS = {
    "llama-1b/stage2-model2": {
        "model": "llama-1b", "steps": 3, "batch_size": 32, "seq_len": 2048,
        "learning_rate": 3.0e-4, "remat": "attn", "pp_microbatches": 8,
        "pp_remat_ticks": True, "mu_dtype": "bfloat16", "nu_dtype": "bfloat16",
        "grad_dtype": "bfloat16", "checkpoint": False, "log_interval": 1,
        "data": {"kind": "synthetic-lm"}, "platform": "cuda",
        "parallelism": {"stage": 2, "model": 2}},
    "llama-moe-1b/stage2-expert2": {
        **MOE_SPEC, "moe_dispatch": "a2a", "microbatches": 4, "pp_microbatches": 4,
        "parallelism": {"stage": 2, "expert": 2}},
}
# llama2-7b's random-init logits have std ~1.13 (0.0176 x sqrt(4096)),
# which lifts its step-0 loss ~0.63 above ln 32000 (llama-1b's: 0.32)
LLAMA7B_LOSS0_MARGIN = 1.0


# dist_train_multi's llama2-7b {fsdp: W}: examples/llama7b_tpujob.yaml's
# keys, the batch cut from 256 to 4 rows a rank (2 microbatches); the init's
# peak at full depth, the checkpoints at SHARD_7B_LAYERS layers (a step of
# the whole state is ~54 GB, and the card's disk holds ~75 GB)
SHARD_7B_SPEC = {
    "model": "llama2-7b", "steps": 2, "seq_len": 2048, "learning_rate": 3.0e-4,
    "warmup_steps": 1, "remat": "attn_qkv", "mu_dtype": "bfloat16", "nu_dtype": "bfloat16",
    "grad_dtype": "bfloat16", "microbatches": 2, "accum_dtype": "bfloat16",
    "loss_chunk_tokens": 4096, "log_interval": 1, "data": {"kind": "synthetic-lm"},
    "platform": "cuda",
    "checkpoint": {"save_interval_steps": 1, "max_to_keep": 3, "async_save": True}}
SHARD_7B_LAYERS = 4


def sha256_of(torch, t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib

    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def state_leaves(state) -> dict:
    """A state's param leaves and AdamW moments by ``params/<path>``,
    ``mu/<path>`` and ``nu/<path>``."""
    from polyaxon_tpu_torch.models.transformer import flatten

    flat = [("/".join(p), t) for p, t in flatten(state.params)]
    out = {f"params/{p}": t for p, t in flat}
    for name in ("mu", "nu"):
        out.update({f"{name}/{p}": t
                    for (p, _), t in zip(flat, getattr(state.opt_state, name))})
    return out


def shard_7b_spec(world: int) -> dict:
    return {**SHARD_7B_SPEC, "batch_size": 4 * world, "parallelism": {"fsdp": world}}


def with_layers(model: str, layers: int):
    """Set ``model``'s depth in the registry; returns the undo."""
    from dataclasses import replace

    from polyaxon_tpu_torch.models import REGISTRY

    saved = REGISTRY[model]
    REGISTRY[model] = (saved[0], replace(saved[1], num_layers=layers))
    return lambda: REGISTRY.__setitem__(model, saved)


def shard_7b_child(torch, plan: dict) -> dict:
    """This rank of llama2-7b {fsdp: W}: with ``step: save``, the rise of
    max_memory_allocated while it builds its blocks of the params at full
    depth, then two steps at SHARD_7B_LAYERS layers that save each step into
    ``plan["dir"]``; with ``step: restore``, the restore of that directory's
    newest step. Returns every rank's block hashes (on rank 0)."""
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    dist = torch.distributed
    world, rank = dist.get_world_size(), dist.get_rank()
    spec = shard_7b_spec(world)
    out: dict = {}
    if plan["step"] == "save":
        trainer, _ = build_trainer({**spec, "checkpoint": False})
        slice_bytes = largest_slice_bytes(trainer.task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        params = trainer.init_params(seed=0)
        block = sum(t.numel() * t.element_size() for _, t in flatten(params))
        whole = trainer.cfg.model.num_params() * 4
        rise = torch.cuda.max_memory_allocated() - start
        bound = whole // world + slice_bytes + SHARDED_INIT_SLACK
        out["init"] = {"block_bytes": block, "whole_bytes": whole, "peak_rise_bytes": rise,
                       "largest_slice_bytes": slice_bytes, "bound_bytes": bound}
        if rise > bound:
            raise AssertionError(f"rank {rank}'s init rose {rise} bytes, beyond the f32 params "
                                 f"over {world} ranks + a slice + slack {bound}")
        del params, trainer
        gc.collect()
        torch.cuda.empty_cache()
    undo = with_layers(spec["model"], SHARD_7B_LAYERS)
    try:
        trainer, batches = build_trainer(spec, artifacts_dir=plan["dir"])
        if plan["step"] == "save":
            state, _ = trainer.fit(batches, int(spec["steps"]), state=trainer.init_state(0))
            step = int(state.step)
        else:
            state, step = trainer.restore_or_init()
        mine = {"step": step,
                "hashes": {k: sha256_of(torch, t) for k, t in state_leaves(state).items()},
                "cuts": {p: [list(c) for c in cuts] for p, cuts in trainer.placement().cuts.items()},
                "sizes": trainer.mesh.sizes, **out}
    finally:
        undo()
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks}


def whole_block_hashes(torch, state, ranks: list) -> list:
    """For each rank's cuts, the hashes of its blocks of a whole state."""
    from polyaxon_tpu_torch.parallel.mesh import Mesh

    out = []
    for r, mine in enumerate(ranks):
        mesh = Mesh(sizes=mine["sizes"], rank=r)
        hashes = {}
        for key, t in state_leaves(state).items():
            for axis, dim in mine["cuts"].get(key.split("/", 1)[1], ()):
                t = mesh.block(t, dim, axis)
            hashes[key] = sha256_of(torch, t)
        out.append(hashes)
    return out


def shard_7b_multi(torch, envs: list) -> dict:
    """llama2-7b {fsdp: W} (shard_7b_child): every rank's init peak within
    its bound; the step saved at W restored at world 1 in this process, each
    rank's blocks bit-equal (sha256) to the restored state's; that state
    saved at world 1 and restored at W, bit-equal again; then one rank's
    file left out of the newest step (a planted fault): the restore walks
    back to the step before it."""
    import shutil

    from polyaxon_tpu_torch.runtime.builtin import build_trainer
    from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from polyaxon_tpu_torch.train.trainer import state_tree

    world = len(envs)
    spec = shard_7b_spec(world)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard7b_")
    saved_dir, one_dir = os.path.join(tmp, "w"), os.path.join(tmp, "one")
    out: dict = {"world": world, "layers": SHARD_7B_LAYERS}
    try:
        t0 = time.monotonic()
        saved = run_children(envs, {"mode": "shard7b", "step": "save", "dir": saved_dir},
                             timeout=900)["ranks"]
        out["save_run_s"] = time.monotonic() - t0
        out["init"] = [r["init"] for r in saved]
        undo = with_layers(spec["model"], SHARD_7B_LAYERS)
        try:
            one = {**spec, "parallelism": None}
            trainer, _ = build_trainer(one, artifacts_dir=saved_dir)
            t1 = time.monotonic()
            state, step = trainer.restore_or_init()
            out["restore_at_1_s"] = time.monotonic() - t1
            if step != int(spec["steps"]):
                raise AssertionError(f"world 1 restored step {step} of the W-rank save")
            want = whole_block_hashes(torch, state, saved)
            for r, mine in enumerate(saved):
                if mine["hashes"] != want[r]:
                    bad = sorted(k for k in want[r] if mine["hashes"].get(k) != want[r][k])
                    raise AssertionError(f"rank {r}'s blocks differ from the world-1 "
                                         f"restore's: {bad[:5]}")
            ck = Checkpointer(CheckpointConfig(directory=os.path.join(one_dir, "outputs",
                                                                      "checkpoints"),
                                               async_save=False))
            ck.maybe_save(step, state_tree(state), force=True)
            del state, trainer
            gc.collect()
            torch.cuda.empty_cache()
            t2 = time.monotonic()
            restored = run_children(envs, {"mode": "shard7b", "step": "restore",
                                           "dir": one_dir}, timeout=900)["ranks"]
            out["restore_at_w_run_s"] = time.monotonic() - t2
            if any(r["step"] != step or r["hashes"] != w for r, w in zip(restored, want)):
                raise AssertionError("a rank's blocks restored from the world-1 step differ "
                                     "from that step's")
            out["bit_equal"] = ["W -> 1", "1 -> W"]
            # the planted fault: rank 1's file of the newest step left out
            os.unlink(os.path.join(saved_dir, "outputs", "checkpoints", str(step),
                                   "shard-00001.pt"))
            trainer, _ = build_trainer(one, artifacts_dir=saved_dir)
            _, walked = trainer.restore_or_init()
            if walked != step - 1:
                raise AssertionError(f"with rank 1's file of step {step} gone the restore "
                                     f"landed on step {walked}, not {step - 1}")
            out["missing_rank_file_walked_back_to"] = walked
            del trainer
        finally:
            undo()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_envs(world: int) -> list:
    """The PLX_* env of each of ``world`` child ranks on this host, one GPU
    a rank."""
    port = free_port()
    return [{"PLX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "PLX_NUM_PROCESSES": str(world),
             "PLX_PROCESS_ID": str(r), "LOCAL_RANK": str(r)} for r in range(world)]


def dist_env_phase(torch) -> dict:
    """What the distributed phases run on: the card count, NCCL's version,
    the card's name and power limit."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return {"device_count": torch.cuda.device_count(),
            "nccl": ".".join(map(str, torch.cuda.nccl.version())),
            "cards": smi.stdout.strip().splitlines()}


def plant_fault(fault: str) -> None:
    """A multi-GPU phase's planted fault (MULTI_FAULTS), in this child."""
    if fault == "af_block_shape":
        from polyaxon_tpu_torch.train.optimizers import Adafactor

        leaf = Adafactor._leaf
        Adafactor._leaf = lambda self, i, p: (tuple(p.shape), leaf(self, i, p)[1])
    elif fault == "unresharded":
        from polyaxon_tpu_torch.parallel.mesh import Mesh

        Mesh.reshard = lambda self, t, axis, stored, read: t
    else:
        raise ValueError(f"unknown fault {fault!r}")


def step_digest(torch, spec: dict) -> dict:
    """One step of the spec's trainer (the builtin's own, from its seeded
    init and first batch, at the peak learning rate: no warmup, so the
    step moves every param), then in float64 the sum of squares of this
    rank's block of each param leaf (with the leaf's cuts) and, under
    adafactor, of each leaf's whole ``v_row`` and ``v_col``."""
    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    def sumsq(t):
        return float((t.double() ** 2).sum())

    with tempfile.TemporaryDirectory() as tmp:
        trainer, batches = build_trainer({**spec, "steps": 1, "warmup_steps": 0},
                                         artifacts_dir=tmp)
        state = trainer.init_state(seed=0)
        state, _ = trainer.make_step()(state, next(batches))
        paths = ["/".join(p) for p, _ in flatten(state.params)]
        out = {"params": {p: sumsq(t) for p, (_, t) in zip(paths, flatten(state.params))},
               "cuts": {p: [list(c) for c in cuts] for p, cuts in zip(paths, trainer._cuts)}}
        if spec.get("optimizer") == "adafactor":
            out["factors"] = [[sumsq(vr), sumsq(vc)] for vr, vc in
                              zip(state.opt_state.v_row, state.opt_state.v_col)]
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel(a: float, b: float) -> float:
    return abs(a / b - 1) if b else abs(a)


def check_digests(name: str, digests: list, one: Optional[dict]) -> dict:
    """W ranks' step digests: every leaf the storage replicates is bit-equal
    on every rank, and adafactor's factors (whole on every rank) are one
    rank's within ADAFACTOR_DIGEST_RTOL."""
    first = digests[0]
    for path, cuts in first["cuts"].items():
        if not cuts and len({d["params"][path] for d in digests}) != 1:
            raise AssertionError(f"{name}: the replicated leaf {path} differs between the "
                                 f"ranks: {[d['params'][path] for d in digests]}")
    out = {"replicated_leaves": sum(not c for c in first["cuts"].values())}
    if one is not None and "factors" in one:
        rel = max(_rel(x, y) for fa, fb in zip(first["factors"], one["factors"])
                  for x, y in zip(fa, fb))
        out["factors_rel"] = rel
        if rel > ADAFACTOR_DIGEST_RTOL:
            raise AssertionError(f"{name}: adafactor's factors after one step differ from "
                                 f"one rank's by {rel} (limit {ADAFACTOR_DIGEST_RTOL})")
    return out


def dist_child(plan: dict) -> int:
    """One process of a distributed phase (``chip_smoke.py --dist-child
    <plan>``), so that no group outlives its phase. ``1rank``: each spec
    twice without a group (the spread of a run against itself), then each
    under a 1-rank NCCL group; ``multi``: this rank of a group joined from
    the PLX_* env. Prints one ``{"dist_result": ...}`` line (rank 0)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from polyaxon_tpu_torch import parallel

    fa = importlib.import_module("polyaxon_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist = torch.distributed
    out: dict = {}
    if plan["mode"] == "shard7b":
        dev = torch.device("cuda", parallel.local_rank())
        torch.cuda.set_device(dev)
        parallel.initialize(device=dev)
        try:
            out = shard_7b_child(torch, plan)
        finally:
            parallel.shutdown()
        if int(os.environ["PLX_PROCESS_ID"]) != 0:
            return 0
    elif plan["mode"] in ("ring_bench", "pp_bench"):
        dev = torch.device("cuda", parallel.local_rank())
        torch.cuda.set_device(dev)
        parallel.initialize(device=dev)
        try:
            out = tool_child(torch, fa, plan)
        finally:
            parallel.shutdown()
        if int(os.environ["PLX_PROCESS_ID"]) != 0:
            return 0
    elif plan["mode"] == "1rank":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        for name in plan["models"]:
            out[name] = {"alone": [train_phase(torch, fa, DIST_SPECS[name])
                                   for _ in range(2)]}
            gc.collect()
            torch.cuda.empty_cache()
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{plan['port']}",
                                world_size=1, rank=0, device_id=dev)
        try:
            for name in plan["models"]:
                out[name]["group"] = train_phase(torch, fa, DIST_SPECS[name])
                gc.collect()
                torch.cuda.empty_cache()
                if DIST_SPECS[name].get("optimizer") == "adafactor":
                    out[name]["group"]["digest"] = step_digest(torch, DIST_SPECS[name])
        finally:
            dist.destroy_process_group()
    else:
        dev = torch.device("cuda", parallel.local_rank())
        torch.cuda.set_device(dev)
        parallel.initialize(device=dev)
        world = dist.get_world_size()
        if plan["mode"] == "tp_cp":
            specs = {f"llama-1b/{axis}": {**DIST_SPECS["llama-1b"],
                                          "parallelism": {axis: world}}
                     for axis in TP_CP_AXES}
            specs["llama-1b-lora/model"] = {**LORA_DIST_SPEC, "parallelism": {"model": world}}
            specs["llama-1b-rule/model"] = {**DIST_SPECS["llama-1b"],
                                            "parallelism": {"model": world},
                                            "partition_rules": EMBED_RULES}
            if world == 4:
                specs["llama2-7b/fsdp2-model2"] = LLAMA7B_TP_SPEC
        elif plan["mode"] == "pp_ep":
            specs = PP_SPECS if world == 2 else PP_EP_SPECS
        else:
            specs = {name: {**DIST_SPECS[name], "parallelism": {DIST_MULTI_AXIS[name]: world}}
                     for name in plan["models"]}
        if plan.get("fault"):
            # a planted fault runs in a child of its own (nothing undoes it),
            # on its run alone, and only its digests are read
            name = next(n for n, f in MULTI_FAULTS.items() if f == plan["fault"])
            specs = {name: specs[name]}
            plant_fault(plan["fault"])
        rank = dist.get_rank()
        try:
            for name, spec in specs.items():
                if not plan.get("fault"):
                    visits = rank + 1 if "context" in spec["parallelism"] else 1
                    margin = (LLAMA7B_LOSS0_MARGIN if spec["model"] == "llama2-7b"
                              else LOSS0_MARGIN)
                    out[name] = train_phase(torch, fa, spec, visits, margin)
                    gc.collect()
                    torch.cuda.empty_cache()
                if name in MULTI_FAULTS:
                    # every rank's digest, on rank 0
                    digests = [None] * world
                    dist.all_gather_object(digests, step_digest(torch, spec))
                    out.setdefault(name, {})["digests"] = digests
        finally:
            parallel.shutdown()
        if int(os.environ["PLX_PROCESS_ID"]) != 0:
            return 0
    print(json.dumps({DIST_RESULT: out}), flush=True)
    return 0


def tool_child(torch, fa, plan: dict) -> dict:
    """One rank of ring_bench_multi or pp_bench_multi: the tool's library
    call over the group this child joined; every rank's peak memory (and
    B1 launches) gathered on rank 0."""
    dist = torch.distributed
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    if plan["mode"] == "ring_bench":
        from polyaxon_tpu_torch.scripts import ring_bench

        out = {name: ring_bench.run_ring_bench(RING_BENCH_SEQS, platform="cuda",
                                               steps=RING_BENCH_STEPS, **c)
               for name, c in RING_BENCH_CASES.items()}
    else:
        from polyaxon_tpu_torch.scripts import pp_bench

        res = pp_bench.run_pp_bench(platform="cuda")
        out = {"lines": res["lines"], "summary": res["summary"]}
    torch.cuda.synchronize()
    mine = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "flash_fwd": fa.launch_counts["flash_fwd"]}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {**out, "ranks": ranks}


def run_children(envs: list, plan: dict, timeout: float) -> dict:
    """Run one ``--dist-child`` per env, wait for all, and return rank 0's
    result; any child's failure raises with its output."""
    children = []
    for env in envs:
        children.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-child", json.dumps(plan)],
            env={**os.environ, **env}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outputs = []
    try:
        for child in children:
            outputs.append(child.communicate(timeout=timeout)[0])
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for child, text in zip(children, outputs):
        if child.returncode != 0:
            raise AssertionError(f"dist child exited {child.returncode}:\n{text[-6000:]}")
    for line in outputs[0].splitlines():
        if line.startswith('{"' + DIST_RESULT):
            return json.loads(line)[DIST_RESULT]
    raise AssertionError(f"dist child printed no result:\n{outputs[0][-6000:]}")


def _max_abs(a: list, b: list) -> float:
    return max(abs(x - y) for x, y in zip(a, b))


def dist_train_1rank_phase() -> dict:
    """Each DIST_SPECS model through ``run_builtin`` under a 1-rank NCCL
    group (the mesh path: global counts and metrics, all-reduced batch
    norms and grads; llama-1b's fsdp gathers each layer and reduce-scatters
    its grads, B1-B3 inside) against the same spec without a group: the
    losses must be bit-equal or within the no-group run's spread against
    itself; step p50 with and without the group, peak memory, launches."""
    t0 = time.monotonic()
    res = run_children([{}], {"mode": "1rank", "port": free_port(),
                              "models": list(DIST_SPECS)}, timeout=600)
    out = {"seconds": time.monotonic() - t0}
    for name, r in res.items():
        a, b, g = r["alone"][0], r["alone"][1], r["group"]
        spread = _max_abs(a["losses"], b["losses"])
        diff = _max_abs(g["losses"], a["losses"])
        out[name] = {
            "losses_group": g["losses"], "losses_alone": a["losses"],
            "alone_spread": spread, "group_vs_alone": diff,
            "step_p50_ms_group": g["step_time_p50_ms"],
            "step_p50_ms_alone": [a["step_time_p50_ms"], b["step_time_p50_ms"]],
            "mfu_group": g["mfu"], "mfu_alone": a["mfu"],
            "peak_gib_group": g["peak_mem_gib"], "peak_gib_alone": a["peak_mem_gib"],
            "launches": g["launches"], "expected_launches": g["expected_launches"]}
        if "digest" in g:
            # adafactor's factors after one step, for dist_train_multi
            out[name]["digest"] = {"factors": g["digest"]["factors"]}
        if diff > spread:
            raise AssertionError(f"{name}: the 1-rank group's losses {g['losses']} differ "
                                 f"from the run without one {a['losses']} by {diff}, "
                                 f"beyond its spread {spread}")
    return out


def dist_train_multi_phase(torch, single: dict) -> dict:
    """min(GPUs, 4) ranks of bert-base {data: W} and llama-1b {fsdp: W} at
    the 1-rank runs' global batch, their step-0/1 losses against the 1-rank
    group's; a statement, not a failure, when the machine has one GPU."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"skipped": f"{count} GPU"}
    world = min(count, 4)
    envs = rank_envs(world)
    t0 = time.monotonic()
    res = run_children(envs, {"mode": "multi", "models": list(DIST_MULTI)}, timeout=600)
    out = {"world": world, "seconds": time.monotonic() - t0}
    for name, r in res.items():
        one = single[name]["losses_group"]
        rel = [abs(x / y - 1) for x, y in zip(r["losses"][:2], one[:2])]
        out[name] = {"losses": r["losses"], "losses_1rank": one, "rel": rel,
                     "step_p50_ms": r["step_time_p50_ms"], "peak_gib": r["peak_mem_gib"],
                     "launches": r["launches"], "mfu": r["mfu"]}
        if any(x > tol for x, tol in zip(rel, DIST_MULTI_RTOL)):
            raise AssertionError(f"{name}: {world} ranks' losses {r['losses'][:2]} vs one "
                                 f"rank's {one[:2]} (relative {rel}, limits "
                                 f"{DIST_MULTI_RTOL})")
        if "digests" in r:
            out[name].update(check_digests(name, r["digests"], single[name]["digest"]))
    name = "llama-1b-adafactor"
    out[f"{name}/af_block_shape"] = planted_fault_phase(
        envs, {"mode": "multi", "models": [name]}, "af_block_shape", single[name]["digest"])
    out["llama2-7b/fsdp"] = shard_7b_multi(torch, envs)
    return out


def planted_fault_phase(envs: list, plan: dict, fault: str, one: Optional[dict]) -> dict:
    """The children of ``plan`` with ``fault`` planted: their digests must
    fail check_digests (a fault that passes raises)."""
    res = run_children(envs, {**plan, "fault": fault}, timeout=600)
    (name, r), = res.items()
    try:
        check_digests(name, r["digests"], one)
    except AssertionError as e:
        return {"caught": str(e)[:300]}
    raise AssertionError(f"the planted fault {fault} passed {name}'s digest check")


def tp_cp_multi_phase(torch, fa, single: dict) -> dict:
    """min(GPUs, 4) ranks of llama-1b {model: W} and {context: W} at the
    1-rank run's global batch, their step-0/1 losses against its, and of
    llama-1b LoRA {model: W} against its one-rank LoRA run in this
    process; with 4 GPUs llama2-7b {fsdp: 2, model: 2}, its step-0 loss
    near ln 32000 and its peak memory per rank. A statement, not a
    failure, on one GPU."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"skipped": f"{count} GPU"}
    world = min(count, 4)
    one_lora = train_phase(torch, fa, {**LORA_DIST_SPEC, "parallelism": None})["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    envs = rank_envs(world)
    t0 = time.monotonic()
    res = run_children(envs, {"mode": "tp_cp"}, timeout=900)
    out = {"world": world, "seconds": time.monotonic() - t0}
    for name, r in res.items():
        out[name] = {"losses": r["losses"], "step_p50_ms": r["step_time_p50_ms"],
                     "peak_gib_rank0": r["peak_mem_gib"], "launches": r["launches"]}
        if "digests" in r:
            out[name].update(check_digests(name, r["digests"], None))
        if name.startswith("llama-1b"):
            one = one_lora if "lora" in name else single["llama-1b"]["losses_group"]
            rel = [abs(x / y - 1) for x, y in zip(r["losses"][:2], one[:2])]
            out[name].update(losses_1rank=one, rel=rel)
            if any(x > tol for x, tol in zip(rel, DIST_MULTI_RTOL)):
                raise AssertionError(f"{name}: {world} ranks' losses {r['losses'][:2]} vs "
                                     f"one rank's {one[:2]} (relative {rel}, limits "
                                     f"{DIST_MULTI_RTOL})")
    out["llama-1b-rule/model/unresharded"] = planted_fault_phase(
        envs, {"mode": "tp_cp"}, "unresharded", None)
    return out


def pp_ep_multi_phase(torch, single: dict) -> dict:
    """Two ranks of llama-1b {stage: 2} at the 1-rank run's global batch,
    their step-0/1 losses against its; with 4 GPUs four ranks of llama-1b
    {stage: 2, model: 2} and llama-moe-1b {stage: 2, expert: 2} (a2a),
    each step-0 loss near ln 32000, and every run's peak memory per rank.
    A statement, not a failure, on one GPU."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"skipped": f"{count} GPU"}
    out = {}
    for world in ((2, 4) if count >= 4 else (2,)):
        envs = rank_envs(world)
        t0 = time.monotonic()
        res = run_children(envs, {"mode": "pp_ep"}, timeout=900)
        out[f"world{world}_seconds"] = time.monotonic() - t0
        for name, r in res.items():
            out[name] = {"losses": r["losses"], "step_p50_ms": r["step_time_p50_ms"],
                         "peak_gib_rank0": r["peak_mem_gib"], "launches": r["launches"],
                         "mfu": r["mfu"]}
            for key in ("router_aux", "router_drop_frac"):
                if key in r:
                    out[name][key] = r[key]
            if name == "llama-1b/stage2":
                one = single["llama-1b"]["losses_group"]
                rel = [abs(x / y - 1) for x, y in zip(r["losses"][:2], one[:2])]
                out[name].update(losses_1rank=one, rel=rel)
                if any(x > tol for x, tol in zip(rel, DIST_MULTI_RTOL)):
                    raise AssertionError(f"{name}: 2 ranks' losses {r['losses'][:2]} vs one "
                                         f"rank's {one[:2]} (relative {rel}, limits "
                                         f"{DIST_MULTI_RTOL})")
    return out


def ring_bench_multi_phase(torch) -> dict:
    """scripts/ring_bench.py as W NCCL ranks (W the largest power of two
    up to min(GPUs, 8), so that its sequences cut into W chunks), one GPU
    a rank: the ring crosses NVLink, the gather path all-gathers K and V;
    each RING_BENCH_CASES head count, the tool's lines (its own
    ring-against-gather check passed on every rank) and each rank's peak
    memory. A statement, not a failure, on one GPU."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"skipped": f"{count} GPU"}
    world = 1 << (min(count, 8).bit_length() - 1)
    t0 = time.monotonic()
    res = run_children(rank_envs(world), {"mode": "ring_bench"}, timeout=600)
    for name in RING_BENCH_CASES:
        for row in res[name]:
            check_keys(f"ring_bench_multi {name}", row, RING_BENCH_KEYS)
            if (row["ranks"], row["cp"]) != (world, world):
                raise AssertionError(f"ring_bench_multi {name}: {row}")
    return {"world": world, "seconds": time.monotonic() - t0, **res}


def pp_bench_multi_phase(torch) -> dict:
    """scripts/pp_bench.py as 4 NCCL ranks ({stage: 2, model: 2}) with 4+
    GPUs, else 2 ({stage: 2}): both gates' lines (their losses within 1e-6,
    the tool's assert) and the last line, each rank's peak memory. A
    statement, not a failure, on one GPU."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"skipped": f"{count} GPU"}
    world = 4 if count >= 4 else 2
    t0 = time.monotonic()
    res = run_children(rank_envs(world), {"mode": "pp_bench"}, timeout=600)
    gate_keys, last_keys = PP_BENCH_KEYS
    for line in res["lines"]:
        check_keys("pp_bench_multi", line, gate_keys)
    check_keys("pp_bench_multi", res["summary"], last_keys)
    losses = [line["loss"] for line in res["lines"]]
    if not (all(math.isfinite(x) for x in losses) and abs(losses[0] - losses[1]) < 1e-6):
        raise AssertionError(f"pp_bench_multi: the gates' losses {losses}")
    return {"world": world, "seconds": time.monotonic() - t0, **res}


# -- slice 14: the measurement tools -------------------------------------------------

# the bench phases' steps (the tool's own count is 8; 20 for llama2-7b)
BENCH_STEPS = 3
# the keys of the repository's bench.py line and its metric names
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_METRICS = {False: "llama_train_tokens_per_sec_per_chip",
                 True: "llama_moe_train_tokens_per_sec_per_chip"}
# serve_bench's sweep at llama-1b's serving width (examples/llama1b_service.yaml:
# block 128) over the tool's widths, requests and lengths
SERVE_BENCH_MODEL = "llama-1b"
SERVE_BENCH_BLOCK = 128
SERVE_BENCH_WIDTHS = (1, 2, 4, 8)
# prefix share at llama-1b with the tool's lengths (a 1024-token system
# prompt, 8-token tails, 8 new tokens): 64 requests cut to 16 and 3 repeats
# to 1, which hold the phase's time (each re-prefill request is 33 chunks)
PREFIX_SHARE_REQUESTS = 16
PREFIX_SHARE_BEST_OF = 1
# the keys of scripts/serve_bench.py's results
SWEEP_KEYS = {"kind", "model", "platform", "rows", "batched_vs_sequential"}
SWEEP_ROW_KEYS = {"concurrency", "requests", "prompt_len", "max_new", "wall_s", "tokens",
                  "tokens_per_sec", "ttft_p50_ms", "ttft_p95_ms", "req_wall_p50_s"}
PREFIX_KEYS = {"kind", "requests", "sys_len", "tail_len", "max_new", "block_size",
               "shared_prefix_blocks", "shared", "reprefill", "ttft_p50_speedup",
               "ttft_p95_speedup"}
PREFIX_SIDE_KEYS = {"ttft_p50_ms", "ttft_p95_ms", "wall_s", "prefix_hits", "prefix_misses",
                    "extra_kv_blocks_per_request", "cow_copies", "kv_audit_violations"}
SPEC_BENCH_KEYS = {"kind", "requests", "prompt_len", "max_new", "spec_k", "target_layers",
                   "draft_layers", "plain_tokens_per_sec", "spec_tokens_per_sec", "speedup",
                   "tokens_proposed", "tokens_accepted", "acceptance_rate",
                   "kv_audit_violations"}


def check_keys(what: str, got: dict, want: set) -> None:
    if set(got) != want:
        raise AssertionError(f"{what} keys {sorted(got)} != the JAX tool's {sorted(want)}")


def bench_phase(torch, fa, moe: bool = False, data: Optional[str] = None) -> dict:
    """``polyaxon_tpu_torch.bench.run_bench`` on the card at its one-GPU
    recipe (llama-1b 64 x 2048 in 32 microbatches, or llama-moe-1b 32 x
    2048 in 8), ``BENCH_STEPS`` steps, the corpus of ``--data tokens-file``
    in a temporary directory removed after: its line parses with
    bench.py's keys and metric, every loss is finite, the MFU is the
    meter's identity and in (0, 1], and the flash launches equal their
    formula."""
    import shutil

    from polyaxon_tpu_torch import bench

    logged = []
    token_dir = tempfile.mkdtemp(prefix="plx_bench_tokens_") if data else None
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.monotonic()
        res = bench.run_bench(moe=moe, data=data, steps=BENCH_STEPS, token_dir=token_dir,
                              track=lambda step, m: logged.append((step, m)))
        wall_s = time.monotonic() - t0
        launches = dict(fa.launch_counts)
    finally:
        if token_dir:
            shutil.rmtree(token_dir, ignore_errors=True)
    line = json.loads(json.dumps(res.line))
    check_keys("bench line", line, BENCH_KEYS)
    if line["metric"] != BENCH_METRICS[moe]:
        raise AssertionError(f"bench metric {line['metric']!r}")
    losses = [m["loss"] for _, m in sorted(logged, key=lambda e: e[0])]
    if len(losses) != BENCH_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bench losses {losses}")
    m = res.metrics
    identity = m["tokens_per_sec_per_chip"] * res.flops_per_token / PEAK_FLOPS["bfloat16"]
    if not (0 < m["mfu"] <= 1 and math.isclose(m["mfu"], identity, rel_tol=1e-9)):
        raise AssertionError(f"bench mfu {m['mfu']} is not in (0, 1] or is not "
                             f"tokens/s/chip x flops/token / 989e12 = {identity}")
    recipe = res.recipe
    expected = flash_launch_formula({"steps": BENCH_STEPS, "microbatches": recipe.microbatches,
                                     "remat": recipe.model.remat}, recipe.model.num_layers)
    if launches != expected:
        raise AssertionError(f"bench flash launches {launches} != formula {expected}")
    out = {"line": line, "losses": losses, "tokens_per_sec_per_chip":
           m["tokens_per_sec_per_chip"], "mfu": m["mfu"], "mfu_identity": identity,
           "step_time_ms": m["step_time_ms"], "step_time_p50_ms": m["step_time_p50_ms"],
           "flops_per_token": res.flops_per_token, "batch": recipe.batch, "seq": recipe.seq,
           "microbatches": recipe.microbatches, "chips": res.chips, "steps": res.steps,
           "launches": launches, "expected_launches": expected,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall_s}
    if moe:
        out["router_drop_frac"] = m.get("router_drop_frac")
    return out


def serve_bench_phase(torch, pa) -> dict:
    """``polyaxon_tpu_torch.scripts.serve_bench`` on the card with the
    paged kernel (attn_impl flash): the sweep at llama-1b's serving width,
    prefix share at llama-1b, and speculation on the 32x identity-extended
    llama-tiny fixture. Each result has the JAX tool's keys, the paged
    kernel runs in every row, no KV audit violation, the prefix hits cover
    every request's shared blocks with at most one extra block each, and
    acceptance is at least ACCEPT_MIN."""
    from polyaxon_tpu_torch.scripts import serve_bench as sb

    row_launches = []
    inner = sb.run_engine_bench

    def counted(concurrency, **kw):
        before = pa.launch_counts["paged_decode"]
        row = inner(concurrency, **kw)
        row_launches.append(pa.launch_counts["paged_decode"] - before)
        return row

    pa.reset_launch_counts()
    t0 = time.monotonic()
    sb.run_engine_bench = counted
    try:
        sweep = sb.run_sweep(SERVE_BENCH_WIDTHS, model=SERVE_BENCH_MODEL,
                             block_size=SERVE_BENCH_BLOCK)
    finally:
        sb.run_engine_bench = inner
    sweep_s = time.monotonic() - t0
    check_keys("sweep", sweep, SWEEP_KEYS)
    for row in sweep["rows"]:
        check_keys("sweep row", row, SWEEP_ROW_KEYS)
        if row["tokens"] != row["requests"] * row["max_new"]:
            raise AssertionError(f"sweep row {row}")
    if len(row_launches) != len(SERVE_BENCH_WIDTHS) or not all(row_launches):
        raise AssertionError(f"the paged kernel did not run in every sweep row: {row_launches}")
    gc.collect()
    torch.cuda.empty_cache()

    pa.reset_launch_counts()
    t0 = time.monotonic()
    share = sb.run_prefix_share_bench(model=SERVE_BENCH_MODEL, block_size=SERVE_BENCH_BLOCK,
                                      requests=PREFIX_SHARE_REQUESTS,
                                      best_of=PREFIX_SHARE_BEST_OF)
    share_s = time.monotonic() - t0
    share_launches = pa.launch_counts["paged_decode"]
    check_keys("prefix share", share, PREFIX_KEYS)
    for side in ("shared", "reprefill"):
        check_keys(f"prefix share {side}", share[side], PREFIX_SIDE_KEYS)
        if share[side]["kv_audit_violations"]:
            raise AssertionError(f"KV refcount audit violations (prefix share, {side})")
    need_hits = share["requests"] * (share["sys_len"] // share["block_size"])
    if not (share["shared"]["extra_kv_blocks_per_request"] <= 1
            and share["shared"]["prefix_hits"] >= need_hits):
        raise AssertionError(f"prefix share: {share['shared']}; hits must reach {need_hits} "
                             f"with at most one extra block a request")
    if not share_launches:
        raise AssertionError("the paged kernel did not run in the prefix share bench")
    gc.collect()
    torch.cuda.empty_cache()

    # the paged kernel at the fixture's decode shape (f32, D 16), against
    # its plain version, before the fixture runs it
    from polyaxon_tpu_torch.models import REGISTRY

    tiny = REGISTRY["llama-tiny"][1]
    got = (tiny.num_kv_heads, tiny.num_heads // tiny.num_kv_heads, tiny.hidden // tiny.num_heads)
    want = (TINY_KERNEL_SHAPE["kv_heads"], TINY_KERNEL_SHAPE["groups"], TINY_HEAD_DIM)
    if got != want:
        raise AssertionError(f"llama-tiny's decode heads {got} != TINY_KERNEL_SHAPE's {want}")
    tiny_row = kernel_case(torch, pa, TINY_HEAD_DIM, torch.float32, TINY_KERNEL_SHAPE,
                           TINY_KERNEL_LENGTHS)
    log("kernel_tiny", **tiny_row)

    pa.reset_launch_counts()
    t0 = time.monotonic()
    spec = sb.run_speculative_bench()
    spec_s = time.monotonic() - t0
    spec_launches = pa.launch_counts["paged_decode"]
    check_keys("speculative", spec, SPEC_BENCH_KEYS)
    if spec["kv_audit_violations"]:
        raise AssertionError("KV refcount audit violations (speculative bench)")
    if not spec["acceptance_rate"] >= ACCEPT_MIN:
        raise AssertionError(f"speculative bench acceptance {spec['acceptance_rate']} < "
                             f"{ACCEPT_MIN}")
    if not spec_launches:
        raise AssertionError("the paged kernel did not run in the speculative bench")
    return {"sweep": sweep, "sweep_row_launches": row_launches, "sweep_s": sweep_s,
            "prefix_share": share, "prefix_share_launches": share_launches,
            "prefix_share_s": share_s, "speculative": spec,
            "speculative_launches": spec_launches, "speculative_s": spec_s,
            "kernel_tiny": tiny_row,
            "launches": {"serve_bench/sweep": sum(row_launches),
                         "serve_bench/prefix_share": share_launches,
                         "serve_bench/speculative": spec_launches}}


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--dist-child":
        return dist_child(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    except ImportError as e:
        print(f"chip_smoke: the polyaxon_tpu_torch package is missing next "
              f"to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device_phase()
    kind = torch.cuda.get_device_name(0)
    log("device", kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    fa = importlib.import_module("polyaxon_tpu_torch.ops.flash_attention")
    ll = importlib.import_module("polyaxon_tpu_torch.ops.lm_loss")
    build_phase([pa.PAGED_DECODE_LIB, fa.FLASH_FWD_LIB, fa.FLASH_BWD_LIB, ll.LM_LOSS_LIB])
    log("sass", **sass_phase(fa))

    kernel_rows = kernel_phase(torch, pa)
    flash_rows = flash_kernel_phase(torch, fa)
    f32_path = flash_f32_path_phase(torch, fa)
    log("flash_f32_path", **f32_path)
    flash_bidir_phase(torch, fa)
    ring_rows = ring_phase(torch, fa)
    ring_bench_rows = ring_bench_phase(torch, fa)
    lm_loss_rows = lm_loss_phase(torch, ll)

    from polyaxon_tpu_torch.models import REGISTRY

    vocab = REGISTRY[SERVE_SPEC["model"]][1].vocab_size
    served = serve_phase(torch, SERVE_SPEC, make_prompts(vocab), MAX_NEW)
    engine = served.pop("engine")
    layers = engine.cfg.num_layers
    log("serve", **served, layers=layers)
    if served["decode_steps"] <= 0:
        raise AssertionError("no decode step ran")
    if served["launches"] != served["decode_steps"] * layers:
        raise AssertionError(
            f"paged_decode launched {served['launches']} times over "
            f"{served['decode_steps']} decode steps x {layers} layers")
    if served["prefix_cache_hits"] < 2:
        raise AssertionError(f"prefix_cache_hits {served['prefix_cache_hits']} < 2")
    if served["kv_audit_violations"]:
        raise AssertionError("KV refcount audit violations")

    log("compare", **compare_phase(torch, engine))
    del engine
    gc.collect()  # serving's objects may hold the weights in reference cycles
    torch.cuda.empty_cache()

    trained = train_phase(torch, fa, TRAIN_SPEC)
    log("train", **trained)
    torch.cuda.empty_cache()
    train_compare_phase(torch, fa, TRAIN_SPEC)
    gc.collect()
    torch.cuda.empty_cache()
    lora_run = train_lora_phase(torch, fa, trained)
    log("train_lora", **lora_run)
    gc.collect()
    torch.cuda.empty_cache()
    lora_compare_phase(torch, fa)
    gc.collect()
    torch.cuda.empty_cache()

    families = {}
    for phase, spec in (("train_bert", BERT_SPEC), ("train_vit", VIT_SPEC),
                        ("train_resnet", RESNET_SPEC)):
        run = train_phase(torch, fa, spec)
        family = model_shape(spec["model"])[0]
        if family in ("vit", "resnet"):
            if "accuracy" not in run:
                raise AssertionError(f"{phase}: no accuracy in the final metrics")
            run["image_stream_s_per_batch"] = image_stream_s(torch, spec)
            run["image_stream_share_of_step"] = (run["image_stream_s_per_batch"] * 1e3
                                                 / run["step_time_p50_ms"])
        if family == "resnet":
            run["stats"] = resnet_stats_phase(torch, spec)
        log(phase, **run)
        families[phase] = run
        gc.collect()
        torch.cuda.empty_cache()
        if family != "resnet":
            family_compare_phase(torch, fa, spec)
            gc.collect()
            torch.cuda.empty_cache()

    families["train_gpt2"] = train_phase(torch, fa, GPT2_SPEC)
    log("train_gpt2", **families["train_gpt2"])
    gc.collect()
    torch.cuda.empty_cache()

    moe_run = train_phase(torch, fa, MOE_SPEC)
    moe_cfg = REGISTRY[MOE_SPEC["model"]][1]
    moe_run["flops_per_token"] = moe_cfg.flops_per_token(MOE_SPEC["seq_len"])
    moe_run["flops_per_step"] = moe_run["flops_per_token"] * MOE_SPEC["batch_size"] \
        * MOE_SPEC["seq_len"]
    moe_run["peak_step_ms"] = moe_run["flops_per_step"] / PEAK_FLOPS["bfloat16"] * 1e3
    log("train_moe", **moe_run)
    gc.collect()
    torch.cuda.empty_cache()
    moe_cmp = moe_compare_phase(torch, fa, MOE_SPEC)
    gc.collect()
    torch.cuda.empty_cache()
    log("moe_parts", **moe_parts_phase(torch, MOE_SPEC))
    gc.collect()
    torch.cuda.empty_cache()
    log("pp_gate", **pp_gate_phase(torch))
    gc.collect()
    torch.cuda.empty_cache()

    spec = spec_phase(torch, SPEC_SPEC, make_prompts(vocab), MAX_NEW)
    log("spec", **spec)
    want = spec["iterations"] * (spec["k"] + 1) * spec["draft_layers"]
    if spec["iterations"] <= 0 or spec["launches"] != want:
        raise AssertionError(
            f"paged_decode launched {spec['launches']} times over {spec['iterations']} "
            f"speculative iterations; (k+1) x {spec['draft_layers']} draft layers each "
            f"is {want}")
    if spec["kv_audit_violations"]:
        raise AssertionError("KV refcount audit violations (spec)")
    gc.collect()
    torch.cuda.empty_cache()
    log("spec_accept", **spec_accept_phase(torch, make_prompts(vocab), MAX_NEW))
    gc.collect()
    torch.cuda.empty_cache()
    log("restore", **restore_phase(torch, fa, TRAIN_SPEC, SERVE_SPEC))
    gc.collect()
    torch.cuda.empty_cache()
    log("sharded_init", **sharded_init_phase(torch))
    log("sharded_init_faults", **sharded_init_faults_phase(torch))
    import_7b = train_7b_import_lora_phase(torch, fa)
    log("train_7b_import_lora", **import_7b)
    bridged = bridge_train_phase(torch, fa, TRAIN_SPEC)
    log("bridge_train", **bridged)
    if not bridged["outputs_mfu"]:
        raise AssertionError("the bridged run's outputs carry no MFU")
    if not bridged["gpu0_mem_gib_samples"]:
        raise AssertionError("no gpu0_mem_gib in the run's resource events")
    if bridged["launches"] != bridged["expected_launches"]:
        raise AssertionError(f"bridged flash launches {bridged['launches']} != formula "
                             f"{bridged['expected_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    drained = bridge_serve_phase(torch, SERVE_SPEC, make_prompts(vocab), BRIDGE_MAX_NEW)
    log("bridge_serve", **drained)
    if drained["launches"] != drained["decode_steps"] * drained["layers"]:
        raise AssertionError(f"paged_decode launched {drained['launches']} times over "
                             f"{drained['decode_steps']} decode steps x "
                             f"{drained['layers']} layers (bridged)")
    gc.collect()
    torch.cuda.empty_cache()

    # the distributed phases, each in processes of its own (no group
    # outlives its phase), before the profiler
    log("dist_env", **dist_env_phase(torch))
    dist_1rank = dist_train_1rank_phase()
    log("dist_train_1rank", **dist_1rank)
    log("dist_train_multi", **dist_train_multi_phase(torch, dist_1rank))
    log("tp_cp_multi", **tp_cp_multi_phase(torch, fa, dist_1rank))
    log("pp_ep_multi", **pp_ep_multi_phase(torch, dist_1rank))
    log("ring_bench_multi", **ring_bench_multi_phase(torch))
    log("pp_bench_multi", **pp_bench_multi_phase(torch))

    # the measurement tools, through their library calls (slice 14)
    t_tools = time.monotonic()
    benched = {}
    for phase, kw in (("bench", {}), ("bench_moe", {"moe": True}),
                      ("bench_tokens", {"data": "tokens-file"})):
        gc.collect()
        torch.cuda.empty_cache()
        benched[phase] = bench_phase(torch, fa, **kw)
        if phase == "bench_tokens":
            benched[phase]["tokens_per_sec_over_bench"] = (
                benched[phase]["tokens_per_sec_per_chip"]
                / benched["bench"]["tokens_per_sec_per_chip"])
        log(phase, **benched[phase])
    gc.collect()
    torch.cuda.empty_cache()
    tools_serve = serve_bench_phase(torch, pa)
    log("serve_bench", **tools_serve)
    log("tools", seconds=time.monotonic() - t_tools)
    gc.collect()
    torch.cuda.empty_cache()

    # the profiler last: once torch.profiler has run, every later kernel
    # launch in the process pays CUPTI's overhead (a tiny launch's host
    # cost 5.1-5.4 -> 7.1-10.0 us, a decode step's 16-20 -> 26-33 ms, on
    # an NVIDIA H100 80GB HBM3, 700 W), which would inflate each host-clock
    # reading taken after it
    log("compare_profile", **decode_profile_phase(torch, SERVE_SPEC))
    gc.collect()
    torch.cuda.empty_cache()
    log("train_profile", **train_profile_phase(torch, TRAIN_SPEC))
    gc.collect()
    torch.cuda.empty_cache()
    log("train_moe_profile", **train_profile_phase(torch, MOE_SPEC))
    gc.collect()
    torch.cuda.empty_cache()
    log("lora_profile", **lora_profile_phase(torch))
    gc.collect()
    torch.cuda.empty_cache()
    log("spec_profile", **spec_profile_phase(torch, SPEC_SPEC, make_prompts(vocab)))
    gc.collect()
    torch.cuda.empty_cache()
    log("bridge_profile", **bridge_profile_phase(torch, TRAIN_SPEC))
    gc.collect()
    torch.cuda.empty_cache()
    log("flash_f32_split_profile", **flash_f32_split_profile_phase(torch, fa))
    for phase, spec in (("train_bert", BERT_SPEC), ("train_vit", VIT_SPEC),
                        ("train_resnet", RESNET_SPEC)):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{phase}_profile", **family_profile_phase(torch, spec))

    main_row = kernel_rows[0]  # D=64 bf16: the shape the main path gives it
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "polyaxon_tpu_torch/csrc/paged_decode.cu",
        "replaces": "polyaxon_tpu/ops/paged_attention.py:110",
        "launches": served["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "launches_by_path": {"serve": served["launches"], **tools_serve["launches"]},
    }, {
        # the f32 cluster walk: its launches and numbers are the speculative
        # fixture's (llama-tiny, D 16), ``d64`` and ``d128`` phase 3's f32
        # rows at the serving shape
        "name": "paged_decode_f32", "route": "cuda",
        "source": "polyaxon_tpu_torch/csrc/paged_decode.cu",
        "replaces": "polyaxon_tpu/ops/paged_attention.py:110",
        "launches": tools_serve["speculative_launches"],
        **{key: tools_serve["kernel_tiny"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{f"d{row['head_dim']}": {key: row[key] for key in (
            "max_abs_err", "ms", "ms_graph", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for row in kernel_rows if row["dtype"] == "float32"},
    }]
    flash_main = flash_rows[0]  # D=64 bf16: the training shape
    flash_d128 = flash_rows[2]  # D=128 bf16: llama2-7b's attention
    for name, source, replaces in (
            ("flash_fwd", "flash_fwd.cu", "polyaxon_tpu/ops/flash_attention.py:77"),
            ("flash_bwd_dq", "flash_bwd.cu", "polyaxon_tpu/ops/flash_attention.py:210"),
            ("flash_bwd_dkv", "flash_bwd.cu", "polyaxon_tpu/ops/flash_attention.py:262")):
        r = flash_main[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"polyaxon_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": trained["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "launches_by_path": {"train": trained["launches"][name],
                                 "train_lora": lora_run["launches"][name],
                                 **{phase: run["launches"][name]
                                    for phase, run in families.items()
                                    if run["expected_launches"][name]},
                                 **{f"dist_train_1rank/{model}": run["launches"][name]
                                    for model, run in dist_1rank.items()
                                    if isinstance(run, dict) and run["launches"][name]},
                                 **{f"ring_kernels/{case}": row["launches"][name]
                                    for case, row in ring_rows.items()},
                                 **{f"ring_bench/{case}": row["launches"][name]
                                    for case, row in ring_bench_rows.items()
                                    if row["launches"][name]},
                                 "train_moe": moe_run["launches"][name],
                                 "moe_compare": moe_cmp["launches"][name],
                                 "train_7b_import_lora": import_7b["launches"][name],
                                 **{phase: run["launches"][name]
                                    for phase, run in benched.items()}},
            "d128": {"launches": import_7b["launches"][name],
                     **{key: flash_d128[name][key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")}}})
    # the f32 kernels (split-TF32 forward, dQ and dK/dV): their launches are
    # flash_f32_path's, their numbers the D=64 f32 row's, and ``d128`` the
    # D=128 ones
    for name, source, replaces in (
            ("flash_fwd", "flash_fwd.cu", "polyaxon_tpu/ops/flash_attention.py:77"),
            ("flash_bwd_dq", "flash_bwd.cu", "polyaxon_tpu/ops/flash_attention.py:210"),
            ("flash_bwd_dkv", "flash_bwd.cu", "polyaxon_tpu/ops/flash_attention.py:262")):
        row = {"name": f"{name}_f32", "route": "cuda",
               "source": f"polyaxon_tpu_torch/csrc/{source}", "replaces": replaces,
               "launches": f32_path["d64"]["launches"][name]}
        for key, flash_row in (("", flash_rows[1]), ("d128", flash_rows[3])):
            numbers = {k: flash_row[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            if key:
                row[key] = {"launches": f32_path["d128"]["launches"][name], **numbers}
            else:
                row.update(numbers)
        kernels.append(row)
    # the LM loss's row kernel: GPT-2's chunk (every row live); ``bert`` at
    # BERT's chunk with its masked 15% live; launches the llama-1b train
    # phase's, each run's as its formula says (train_phase checks them)
    lm_gpt2, lm_bert = lm_loss_rows["gpt2-345m"], lm_loss_rows["bert-base"]
    kernels.append({
        "name": "lm_loss", "route": "cuda", "source": "polyaxon_tpu_torch/csrc/lm_loss.cu",
        "replaces": None, "launches": trained["launches"]["lm_loss"],
        **{key: lm_gpt2[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
        "bert": {key: lm_bert[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "launches_by_path": {"train": trained["launches"]["lm_loss"],
                             "train_lora": lora_run["launches"]["lm_loss"],
                             **{phase: run["launches"]["lm_loss"]
                                for phase, run in families.items()
                                if run["expected_launches"]["lm_loss"]},
                             **{f"dist_train_1rank/{model}": run["launches"]["lm_loss"]
                                for model, run in dist_1rank.items()
                                if isinstance(run, dict) and run["launches"]["lm_loss"]},
                             "train_moe": moe_run["launches"]["lm_loss"],
                             "moe_compare": moe_cmp["launches"]["lm_loss"],
                             "train_7b_import_lora": import_7b["launches"]["lm_loss"]},
        "per_step": {phase: families[phase]["launches"]["lm_loss"] / spec["steps"]
                     for phase, spec in (("train_bert", BERT_SPEC),
                                         ("train_gpt2", GPT2_SPEC))}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
