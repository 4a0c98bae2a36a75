"""The port's ``partition/convert.py`` on the CPU: files the JAX package
writes (``save_flat`` npy-dirs, ``export_hf_llama``), an ``.npz`` and a
``.safetensors`` file written with the ``safetensors`` package go through
the port's ``import_params`` and give the JAX model's logits on the same
weights; the port's hand-written safetensors parser reads the same bf16
bytes as ``safetensors.safe_open``; the port's own exports round-trip.

Tolerance: import moves bytes (transposes and reshapes), so the imported
leaves must equal the JAX weights exactly; the logits then differ only by
the two packages' f32 kernels (2e-5, as ``test_torch_train_model.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as JT
from polyaxon_tpu.partition import convert as jconvert
from polyaxon_tpu.partition.rules import tree_paths as jax_tree_paths
from polyaxon_tpu_torch.models import REGISTRY, transformer
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.partition import convert as tconvert
from polyaxon_tpu_torch.partition.rules import tree_paths

TOKENS = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JAX_REGISTRY["llama-tiny"][1]
    jparams = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(3), jcfg))
    ref = np.asarray(JT.apply(jax.tree.map(jnp.asarray, jparams), jnp.asarray(TOKENS), jcfg))
    return jparams, jcfg, REGISTRY["llama-tiny"][1], ref


def _check(params, jparams, tcfg, ref):
    """Leaves equal the JAX weights bit for bit; logits match."""
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    want = {"/".join(k.key for k in path): leaf for path, leaf in jflat.items()}
    got = {"/".join(path): leaf for path, leaf in flatten(params)}
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    out = transformer.apply(params, torch.tensor(TOKENS.astype(np.int64)), tcfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def _hf_dict(jparams, jcfg, tmp_path):
    """The JAX package's HF export, read back as a name -> array dict."""
    jconvert.export_hf_llama(jparams, jcfg, str(tmp_path / "hf"))
    src = jconvert.open_source(str(tmp_path / "hf"))
    return {k: np.asarray(src.get(k)) for k in src.keys()}


def test_tree_paths_follow_the_jax_order(tiny):
    jparams, _, tcfg, _ = tiny
    jax_paths = [p for p, _ in jax_tree_paths(jparams)]
    port = transformer.init(tcfg, seed=0, device="cpu")
    assert [p for p, _ in tree_paths(port)] == jax_paths
    assert tree_paths({"b": [1, {"c": 2}], "a": None, "d": (3,)}) == [
        ("b/0", 1), ("b/1/c", 2), ("d/0", 3)]


def test_jax_save_flat_imports(tiny, tmp_path):
    jparams, _, tcfg, ref = tiny
    jconvert.save_flat(jparams, str(tmp_path / "flat"))
    _check(tconvert.import_params(str(tmp_path / "flat"), tcfg, device="cpu"),
           jparams, tcfg, ref)


def test_jax_hf_export_imports(tiny, tmp_path):
    jparams, jcfg, tcfg, ref = tiny
    jconvert.export_hf_llama(jparams, jcfg, str(tmp_path / "hf"))
    source = tconvert.open_source(str(tmp_path / "hf"))
    assert tconvert.detect_layout(source) == "hf-llama"
    _check(tconvert.import_params(source, tcfg, device="cpu"), jparams, tcfg, ref)


def test_npz_imports(tiny, tmp_path):
    jparams, jcfg, tcfg, ref = tiny
    np.savez(tmp_path / "hf.npz", **_hf_dict(jparams, jcfg, tmp_path))
    _check(tconvert.import_params(str(tmp_path / "hf.npz"), tcfg, device="cpu",
                                  layout="hf-llama"), jparams, tcfg, ref)


def test_safetensors_imports(tiny, tmp_path):
    from safetensors.numpy import save_file

    jparams, jcfg, tcfg, ref = tiny
    path = str(tmp_path / "model.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in
               _hf_dict(jparams, jcfg, tmp_path).items()}, path)
    _check(tconvert.import_params(path, tcfg, device="cpu"), jparams, tcfg, ref)


def test_hand_parser_reads_the_bf16_bytes_of_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"a.bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
               "b.f32": torch.randn(7, generator=gen),
               "c.odd": torch.randn(1, 3, generator=gen).to(torch.bfloat16),
               "d.i64": torch.arange(6).reshape(2, 3),
               "e.f16": torch.randn(4, generator=gen).to(torch.float16)}
    path = str(tmp_path / "mixed.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    src = tconvert.SafetensorsSource(path)
    assert src.keys() == sorted(tensors)
    with safe_open(path, framework="pt") as f:
        for name in tensors:
            ours, theirs = src.get(name), f.get_tensor(name)
            assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
            assert torch.equal(ours.view(torch.uint8), theirs.view(torch.uint8)), name


def test_truncated_safetensors_is_refused(tmp_path):
    from safetensors.torch import save_file

    path = tmp_path / "t.safetensors"
    save_file({"w": torch.ones(64)}, str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-16])
    with pytest.raises(tconvert.ImportError_, match="truncated"):
        tconvert.SafetensorsSource(str(path))


def test_port_export_round_trips_and_the_jax_importer_reads_it(tiny, tmp_path):
    jparams, jcfg, tcfg, ref = tiny
    jconvert.save_flat(jparams, str(tmp_path / "flat"))
    params = tconvert.import_params(str(tmp_path / "flat"), tcfg, device="cpu")
    tconvert.export_hf_llama(params, tcfg, str(tmp_path / "port_hf"))
    back = tconvert.import_params(str(tmp_path / "port_hf"), tcfg, device="cpu")
    _check(back, jparams, tcfg, ref)
    from jax.sharding import Mesh, PartitionSpec

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("serve",))
    jback = jconvert.import_params(str(tmp_path / "port_hf"), jcfg, mesh,
                                   rules=[(".*", PartitionSpec())])
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jback)[0],
                                 jax.tree_util.tree_flatten_with_path(jparams)[0]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_npy_round_trip_and_dtype_cast(tiny, tmp_path):
    _, _, tcfg, _ = tiny
    params = transformer.init(tcfg, seed=1, device="cpu")
    bf16 = {p: t.to(torch.bfloat16) for p, t in tree_paths(params)}
    tconvert.save_flat(bf16, str(tmp_path / "bf16"))
    back = tconvert.import_params(str(tmp_path / "bf16"), tcfg, device="cpu",
                                  dtype="bfloat16")
    for path, leaf in tree_paths(back):
        assert leaf.dtype == torch.bfloat16 and torch.equal(leaf, bf16[path]), path
    # an f32 target widens the bf16 source exactly
    wide = tconvert.import_params(str(tmp_path / "bf16"), tcfg, device="cpu")
    for path, leaf in tree_paths(wide):
        assert torch.equal(leaf, bf16[path].float()), path


def test_key_map_and_transpose(tiny, tmp_path):
    jparams, _, tcfg, ref = tiny
    flat = {p.replace("layers/", "blocks/"): (np.swapaxes(a, -1, -2)
                                            if p == "lm_head/w" else a)
            for p, a in tree_paths(jparams)}
    tconvert.save_flat(flat, str(tmp_path / "renamed"))
    params = tconvert.import_params(
        str(tmp_path / "renamed"), tcfg, device="cpu", layout="flat",
        key_map=[("^layers/", "blocks/")], transpose=[("^lm_head/w$", (1, 0))])
    _check(params, jparams, tcfg, ref)


def test_missing_keys_are_listed(tiny, tmp_path):
    jparams, _, tcfg, _ = tiny
    flat = {p: a for p, a in tree_paths(jparams) if not p.startswith("final_norm")}
    tconvert.save_flat(flat, str(tmp_path / "partial"))
    with pytest.raises(tconvert.ImportError_, match="final_norm/scale"):
        tconvert.import_params(str(tmp_path / "partial"), tcfg, device="cpu")
    with pytest.raises(tconvert.ImportError_, match="not HF-llama-shaped"):
        tconvert.import_params(str(tmp_path / "partial"), REGISTRY["gpt2-tiny"][1],
                               device="cpu", layout="hf-llama")
