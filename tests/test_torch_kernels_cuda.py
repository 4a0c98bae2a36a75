"""The paged-decode CUDA kernel against its plain PyTorch version, on the
card. Every test here needs a CUDA device (the kernel has no CPU build)
and skips without one; this file imports nothing of JAX, so it runs on a
machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, elementwise |out - ref| <= atol + rtol |ref|: both versions
compute in f32. In f32 they differ only in the order of the sums (1e-5).
In bf16 they split the online softmax differently (each warp's 32-token
tiles vs whole blocks in order), so p is rounded to bf16 against other
running maxima (~1e-3 absolute at most on the output for unit-normal
inputs), and the output rounds to bf16 (one place is <= 2^-7 relative):
atol 3e-3, rtol 2^-6.
"""

from __future__ import annotations

import importlib

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


def _inputs(dev, dtype, b=5, kvh=2, g=4, d=64, bs=16, t=6, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = b * t + 1
    q = torch.randn(b, kvh, g, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(n, bs, kvh, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(n, bs, kvh, d, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(n - 1, generator=gen, device=dev)[:b * t]
    tables = tables.reshape(b, t).to(torch.int32)
    tables[b - 1, :2] = tables[0, :2]          # an aliased prefix
    lengths = torch.tensor([t * bs, 0, 1, bs, bs + 1][:b], dtype=torch.int32,
                           device=dev)
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


@pytest.mark.cuda
def test_refused_arguments_raise(cuda):
    q, k, v, tables, lengths = _inputs(cuda, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode(q, k, v, tables.long(), lengths)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), tables, lengths)
