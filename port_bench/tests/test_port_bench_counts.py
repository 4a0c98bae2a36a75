"""The benchmark's operation and byte counts against worked numbers, and
the trace's reduction against a hand-made trace."""

from __future__ import annotations

import json

import pytest

from port_bench import kernels, trace
from port_bench.counts import llama, transformer
from port_bench.peaks import peaks_for
from port_bench.tests.tiny import REPO

H100 = peaks_for("NVIDIA H100 80GB HBM3")


def _config(name: str) -> dict:
    return json.loads((REPO / f"port_bench/configs/{name}.json").read_text())


# (config, batch, seq, loss tokens, model FLOPs, matmul FLOPs), worked by hand:
# projections 2 T L (4h^2 + 2hm), head 2 t_loss h V, attention 4 B n P d L
# with P = S^2 (or S(S+1)/2 causal) pairs; each x 3 for forward and backward.
# bert-base S 512: 2*32768*12*7077888 = 5.5667e12, 2*4915*768*30522 =
# 2.3043e11, 4*64*12*262144*64*12 = 6.1848e11 -> 1.92455e13 and 1.73901e13.
STEPS = [
    ("bert-base", 64, 512, 4915, 19245530741760, 17390104869888),
    ("bert-base", 256, 128, 4915, 17853961337856, 17390104869888),
    ("gpt2-345m", 64, 1024, 65536, 148888665194496, 138983396868096),
]


@pytest.mark.parametrize("name,batch,seq,loss_tokens,model,matmul", STEPS)
def test_step_flops_are_the_worked_numbers(name, batch, seq, loss_tokens, model, matmul):
    got = transformer.step_flops(_config(name), batch, seq, loss_tokens)
    assert got == {"model": model, "matmul": matmul}


# least seconds a step (fwd, dQ + dK/dV): bert-base S 512 is bytes-bound in
# the forward, 202.9 MB / 3.35 TB/s = 60.6 us a layer, and FLOP-bound in the
# backward, (7.73e10 + 1.031e11) / 989e12 = 182.4 us a layer, x 12 layers;
# gpt2-345m two microbatches of 32 rows, causal, x 24 layers x 2
FLASH = [
    ("bert-base", 64, 512, 1, 0.0007268040214925373, 0.002188739653371082),
    ("bert-base", 256, 128, 1, 0.0007268040214925373, 0.002005753733731343),
    ("gpt2-345m", 64, 1024, 2, 0.0038762881146268656, 0.011684677837007077),
]


@pytest.mark.parametrize("name,batch,seq,micro,fwd,bwd", FLASH)
def test_flash_least_times_are_the_worked_numbers(name, batch, seq, micro, fwd, bwd):
    got = transformer.flash_least_s(_config(name), batch, seq, micro, H100)
    assert got == pytest.approx({"flash_fwd": fwd, "flash_bwd": bwd}, rel=1e-12)


# TinyLlama's shape (the port's llama-1b: hidden 2048, 22 layers, GQA 32 / 4,
# SwiGLU 5632, an untied 32,000-way head) at 8 x 2048, every position read:
# projections 2 T L (2 h n d + 2 h kv d + 3 h m) = 2*16384*22*(8388608 +
# 1048576 + 34603008) = 3.17484e13, head 2 T h V = 2.14748e12, attention
# 4 B n S(S+1)/2 d L = 4*8*32*2098176*64*22 = 3.02513e12; each x 3
LLAMA_1B = {"hidden_size": 2048, "num_hidden_layers": 22, "num_attention_heads": 32,
            "num_key_value_heads": 4, "intermediate_size": 5632, "vocab_size": 32000,
            "causal": True}


def test_llama_step_flops_are_the_worked_numbers():
    got = llama.step_flops(LLAMA_1B, 8, 2048, 8 * 2048)
    assert got == {"model": 110763045814272, "matmul": 101687645700096}
    # GQA: fewer kv heads, fewer projection FLOPs; attention's are the query heads'
    mha = llama.step_flops(dict(LLAMA_1B, num_key_value_heads=32), 8, 2048, 8 * 2048)
    assert mha["model"] - got["model"] == 3 * 2 * 8 * 2048 * 22 * 2 * 2048 * (32 - 4) * 64


def test_llama_flash_work_reads_k_and_v_over_the_query_heads():
    """The port expands k and v to the query heads before its flash
    kernels, so their work does not depend on the number of kv heads."""
    for kv in (4, 32):
        got = llama.flash_least_s(dict(LLAMA_1B, num_key_value_heads=kv), 8, 2048, 1, H100)
        assert got == transformer.flash_least_s(LLAMA_1B, 8, 2048, 1, H100)


def test_flash_launches_are_one_of_each_kernel_a_layer_and_microbatch():
    work = transformer.flash_launch_work(_config("gpt2-345m"), 64, 1024, 2)
    assert {k: v[0] for k, v in work.items()} == {
        "flash_fwd": 48, "flash_bwd_dq": 48, "flash_bwd_dkv": 48}


@pytest.mark.parametrize("name,layer", [
    ("void flash_fwd_wgmma_kernel<64, false>(CUtensorMap, float)", "flash_fwd"),
    ("void flash_bwd_dq_wgmma_kernel<64>(CUtensorMap)", "flash_bwd"),
    ("void flash_bwd_dkv_wgmma_kernel<64>(CUtensorMap)", "flash_bwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>", "other"),
])
def test_kernel_names_fall_in_their_layer(name, layer):
    assert kernels.classify(name) == layer


def test_a_trace_reduces_to_kernels_busy_time_and_idle_gaps_by_host_op():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 12},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150, "dur": 10},
    ]
    tr = trace.reduce({"traceEvents": ev}, steps=2, window_s=1e-4)
    assert [k[0] for k in tr.kernels] == ["gemm_a", "add_kernel"]
    assert tr.busy_s == pytest.approx(35e-6)          # [10, 35) and [80, 90)
    assert tr.seconds_by("gemm") == pytest.approx(20e-6)
    idle = dict(tr.idle_by_host)                      # [0,10) [35,80) [90,100)
    assert idle["aten::item"] == pytest.approx(45e-6)
    assert idle["aten::mm"] == pytest.approx(10e-6)
    assert idle["(python between ops)"] == pytest.approx(10e-6)
