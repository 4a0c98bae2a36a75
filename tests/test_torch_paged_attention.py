"""Port parity: ``polyaxon_tpu_torch.ops.paged_attention`` against the JAX
package's ``paged_attention`` on the CPU.

The port's ``flash`` path on a CPU tensor is the plain version of the CUDA
kernel (a block-by-block tile loop with the TPU kernel's online softmax);
it is held against the JAX Pallas kernel run in interpret mode and against
the JAX gather path. The kernel itself is held against the plain version
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances (f32 inputs): the plain version and the Pallas kernel walk the
same blocks in the same order with the same f32 formulas, differing only
in the summation order inside each product: 1e-5, the tolerance the JAX
package holds its own flash kernel to against gather. The port's gather
path is the same dense f32 math as JAX's gather: 1e-6.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops.paged_attention import paged_attention as jax_paged_attention

pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")


def _inputs(seed=0, b=4, kvh=2, g=3, d=16, n=24, bs=8, t=5, tables=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh, g, d)).astype(np.float32)
    kp = rng.normal(size=(n, bs, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(n, bs, kvh, d)).astype(np.float32)
    if tables is None:
        tables = rng.permutation(n)[:b * t].reshape(b, t)
    return q, kp, vp, np.asarray(tables, np.int32)


def _both(q, kp, vp, tables, lengths, impl):
    lengths = np.asarray(lengths, np.int32)
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), impl=impl))
    out = pa.paged_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(tables), torch.tensor(lengths), impl=impl).numpy()
    return out, ref


# ragged lengths around the bs=8 block boundary: 7 (under), 8 (exact),
# 9 (over), plus 0 and a multi-block length
LENGTHS = [7, 8, 9, 0]


class TestPlainVersusJax:
    @pytest.mark.parametrize("impl", ["flash", "gather"])
    def test_ragged_lengths_7_8_9(self, impl):
        q, kp, vp, tables = _inputs(seed=1)
        out, ref = _both(q, kp, vp, tables, LENGTHS, impl)
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    def test_plain_matches_jax_gather(self):
        q, kp, vp, tables = _inputs(seed=2)
        lengths = [40, 17, 3, 25]
        out, _ = _both(q, kp, vp, tables, lengths, "flash")
        _, ref = _both(q, kp, vp, tables, lengths, "gather")
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("impl", ["flash", "gather"])
    def test_aliased_tables(self, impl):
        # rows 0..2 share their first two physical blocks; block 7 repeats
        # inside row 2; row 3 is private
        tables = [[5, 7, 1, 2, 3], [5, 7, 4, 6, 8], [5, 7, 7, 9, 10],
                  [11, 12, 13, 14, 15]]
        q, kp, vp, tables = _inputs(seed=13, tables=tables)
        out, ref = _both(q, kp, vp, tables, [13, 16, 37, 0], impl)
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("impl", ["flash", "gather"])
    def test_zero_length_rows_are_exact_zeros(self, impl):
        q, kp, vp, tables = _inputs(seed=3)
        out, ref = _both(q, kp, vp, tables, [0, 0, 0, 0], impl)
        assert np.all(out == 0.0) and np.all(ref == 0.0)

    @pytest.mark.parametrize("g", [1, 4, 8])
    def test_query_groups(self, g):
        q, kp, vp, tables = _inputs(seed=4, g=g, kvh=1, d=32)
        out, ref = _both(q, kp, vp, tables, [33, 1, 24, 9], "flash")
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    def test_length_past_the_table_attends_over_the_table(self):
        # the TPU kernel clamps its walk to the table; so does the port
        q, kp, vp, tables = _inputs(seed=5, t=2)
        out, ref = _both(q, kp, vp, tables, [16, 40, 3, 17], "flash")
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


class TestPlainVersion:
    def test_matches_dense_oracle_on_gathered_cache(self):
        q, kp, vp, tables = _inputs(seed=6)
        lengths = torch.tensor([5, 40, 0, 12], dtype=torch.int32)
        qt, kt, vt, tt = map(torch.tensor, (q, kp, vp, tables))
        out = pa.paged_decode_plain(qt, kt, vt, tt, lengths, sm_scale=0.25)
        ref = pa.dense_decode_attention(
            qt, pa.gather_blocks(kt, tt), pa.gather_blocks(vt, tt), lengths,
            sm_scale=0.25)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)

    def test_bf16_rounds_p_to_the_value_dtype(self):
        q, kp, vp, tables = _inputs(seed=7)
        qt, kt, vt, tt = (torch.tensor(x) for x in (q, kp, vp, tables))
        lengths = torch.tensor([30, 8, 1, 21], dtype=torch.int32)
        out = pa.paged_decode_plain(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                                    tt, lengths, sm_scale=0.25)
        ref = pa.paged_decode_plain(qt.bfloat16().float(), kt.bfloat16().float(),
                                    vt.bfloat16().float(), tt, lengths,
                                    sm_scale=0.25)
        assert out.dtype == torch.bfloat16
        # same math up to p's bf16 rounding (2^-9 relative) and the output's
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version_and_never_count(self):
        q, kp, vp, tables = _inputs(seed=8)
        before = dict(pa.launch_counts)
        args = (torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
                torch.tensor(tables), torch.tensor([3, 4, 5, 6], dtype=torch.int32))
        out = pa.paged_decode(*args)
        torch.testing.assert_close(
            out, pa.paged_decode_plain(*args, sm_scale=16 ** -0.5))
        assert pa.launch_counts == before

    def test_unknown_impl_raises(self):
        q, kp, vp, tables = _inputs()
        with pytest.raises(ValueError, match="impl"):
            pa.paged_attention(torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
                               torch.tensor(tables), torch.ones(4, dtype=torch.int32),
                               impl="nope")

    def test_other_devices_are_refused(self):
        q = torch.zeros(1, 1, 1, 16, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            pa.paged_decode(q, q, q, q, q)

    @pytest.mark.parametrize("bad,match", [
        ("dtype", "float32 or bfloat16"),
        ("pool_dtype", "q's dtype"),
        ("table_dtype", "int32"),
        ("head_dim", "head_dim"),
        ("groups", "query heads"),
        ("contiguous", "contiguous"),
        ("shape", "pool heads"),
    ])
    def test_kernel_argument_checks(self, bad, match):
        b, kvh, g, d, n, bs, t = 2, 2, 2, 64, 6, 8, 3
        q = torch.zeros(b, kvh, g, d)
        k = torch.zeros(n, bs, kvh, d)
        v = torch.zeros(n, bs, kvh, d)
        tables = torch.zeros(b, t, dtype=torch.int32)
        lengths = torch.zeros(b, dtype=torch.int32)
        if bad == "dtype":
            q, k, v = q.half(), k.half(), v.half()
        elif bad == "pool_dtype":
            k = k.bfloat16()
        elif bad == "table_dtype":
            tables = tables.long()
        elif bad == "head_dim":
            q, k, v = q[..., :48], k[..., :48].contiguous(), v[..., :48].contiguous()
            q = q.contiguous()
        elif bad == "groups":
            q = torch.zeros(b, kvh, 9, d)
        elif bad == "contiguous":
            q = torch.zeros(b, kvh, d, g).transpose(2, 3)
        elif bad == "shape":
            k = v = torch.zeros(n, bs, kvh + 1, d)
        with pytest.raises((TypeError, ValueError), match=match):
            pa._check_kernel_args(q, k, v, tables, lengths)


class TestSplitWorkspace:
    """The bf16 kernel's host rule: the wrapper sizes the split walk from the
    table alone (the lengths live on the card) and allocates its f32
    workspace."""

    @pytest.mark.parametrize("t,bs,splits", [
        (16, 128, 8),    # the llama-1b serving table: 2048 tokens
        (17, 128, 9),
        (6, 16, 1),      # 96 tokens: one split
        (16, 16, 1),     # exactly one split
        (17, 16, 2),     # one block past it
        (1, 8, 1),
    ])
    def test_splits_cover_the_table(self, t, bs, splits):
        n, acc, ml = pa.split_workspace(8, 4, 8, 64, t, bs, 256)
        assert n == splits
        assert (n - 1) * 256 < t * bs <= n * 256
        assert acc == (8, 4, n, 8, 64)
        assert ml == (8, 4, n, 8, 2)

    def test_workspace_is_kept_per_stream_and_grows(self, monkeypatch):
        monkeypatch.setattr(pa, "_workspaces", {})
        cpu = torch.device("cpu")
        first = pa.workspace(cpu, 7, 100)
        assert first.dtype == torch.float32 and first.numel() == 100
        smaller = pa.workspace(cpu, 7, 60)
        assert smaller.numel() == 60
        assert smaller.data_ptr() == first.data_ptr()       # reused, not allocated
        grown = pa.workspace(cpu, 7, 300)
        assert grown.numel() == 300
        assert pa.workspace(cpu, 7, 100).data_ptr() == grown.data_ptr()
        other = pa.workspace(cpu, 8, 100)                   # another stream's own
        assert other.data_ptr() != grown.data_ptr()
        assert len(pa._workspaces) == 2


class TestBuild:
    def test_library_path_is_keyed_by_the_sources(self, tmp_path, monkeypatch):
        lib = pa._Library("paged_decode", ("paged_decode.cu",))
        assert lib.path().parent == pa.PAGED_DECODE_LIB.path().parent
        assert lib.path().name.startswith("libpaged_decode-")
        src = tmp_path / "k.cu"
        src.write_text("// one\n")
        other = pa._Library("k", ())
        other.sources = (src,)
        first = other.digest()
        src.write_text("// two\n")
        assert other.digest() != first

    def test_a_missing_nvcc_leaves_no_temporary_file(self, monkeypatch, tmp_path):
        from polyaxon_tpu_torch.ops import cuda_build

        def missing():
            raise cuda_build.KernelBuildError("nvcc not found")

        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(cuda_build, "_nvcc", missing)
        src = tmp_path / "k.cu"
        src.write_text("// one\n")
        lib = pa._Library("k", ())
        lib.sources = (src,)
        with pytest.raises(cuda_build.KernelBuildError, match="nvcc"):
            lib.build()
        assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())

    def test_missing_nvcc_raises_a_build_error(self, monkeypatch, tmp_path):
        from polyaxon_tpu_torch.ops import cuda_build

        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(cuda_build.Path, "exists", lambda self: False)
        with pytest.raises(cuda_build.KernelBuildError, match="nvcc"):
            cuda_build._nvcc()
