"""The port's ``train/checkpoint.py`` on the CPU: a bit-exact round trip
(bf16 included), the torn-step walk, the read-only mode, the explicit
older restore that purges or quarantines newer steps
(``tests/test_selfheal.py`` TestExplicitRestorePurgesNewer, on the port),
and the same save / tear / restore scripts run on the JAX package's Orbax
``Checkpointer``, which must land on the same step numbers."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu_torch.partition.rules import tree_paths
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer


def _ckpt(path, **kw):
    cfg = dict(save_interval_steps=1, max_to_keep=8, async_save=False)
    cfg.update(kw)
    return Checkpointer(CheckpointConfig(directory=str(path), **cfg))


def _state(step: int) -> dict:
    """A train-state-shaped tree whose values depend on ``step``: f32
    params, bf16 moments in lists, Python ints."""
    gen = torch.Generator().manual_seed(step)
    w = torch.randn(4, 8, generator=gen)
    return {"params": {"w": w, "b": torch.arange(8, dtype=torch.float32) * step},
            "opt_state": {"count": step, "mu": [w.to(torch.bfloat16) / 3],
                          "nu": [(w * w).to(torch.bfloat16)]},
            "step": step, "extra": None}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return tree


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _tear(ck, step):
    """Truncate the step's largest file to half its size."""
    root = ck._step_dir(step)
    files = [os.path.join(d, n) for d, _, ns in os.walk(root) for n in ns]
    largest = max(files, key=os.path.getsize)
    with open(largest, "r+b") as f:
        f.truncate(max(os.path.getsize(largest) // 2, 1))


def _listing(path):
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            p = os.path.join(d, n)
            st = os.stat(p)
            out[os.path.relpath(p, path)] = (st.st_size, st.st_mtime_ns)
    return out


class TestRoundTrip:
    @pytest.mark.parametrize("async_save", [False, True])
    def test_bit_exact_including_bf16(self, tmp_path, async_save):
        ck = _ckpt(tmp_path / "ck", async_save=async_save)
        state = _state(3)
        assert ck.maybe_save(3, state, force=True)
        ck.wait()
        assert ck.verify_step(3) and ck.latest_complete_step() == 3
        like = _zeros_like(state)
        restored, step = ck.restore(like)
        assert step == 3
        _assert_equal(restored, state)
        # in place: the restore fills the given tensors
        assert restored["params"]["w"] is like["params"]["w"]
        raw, step = ck.restore_raw()
        assert step == 3 and raw["opt_state"]["mu"][0].dtype == torch.bfloat16
        _assert_equal(raw, state)
        nbytes = sum(t.numel() * t.element_size() for _, t in tree_paths(state)
                     if isinstance(t, torch.Tensor))
        assert ck.last_write[0] == 3 and ck.last_write[1] > nbytes

    def test_async_save_copies_before_returning(self, tmp_path):
        """The trainer updates its state in place right after a save: the
        pending write must hold the values of the moment of the call."""
        ck = _ckpt(tmp_path / "ck", async_save=True)
        state = _state(1)
        want = {k: v.clone() for k, v in state["params"].items()}
        assert ck.maybe_save(1, state)
        state["params"]["w"].add_(1.0)
        ck.wait()
        raw, _ = ck.restore_raw()
        assert torch.equal(raw["params"]["w"], want["w"])

    def test_shape_mismatch_raises(self, tmp_path):
        ck = _ckpt(tmp_path / "ck")
        ck.maybe_save(1, _state(1), force=True)
        like = _zeros_like(_state(1))
        like["params"]["w"] = torch.zeros(4, 9)
        with pytest.raises(ValueError, match="params/w"):
            ck.restore(like, step=1)


class TestTornSteps:
    def test_torn_newest_step_falls_back_to_the_previous(self, tmp_path):
        ck = _ckpt(tmp_path / "ck")
        for s in (2, 4):
            ck.maybe_save(s, _state(s), force=True)
        _tear(ck, 4)
        assert not ck.verify_step(4) and ck.complete_steps_desc() == [2]
        restored, step = ck.restore(_zeros_like(_state(2)))
        assert step == 2
        _assert_equal(restored, _state(2))
        # proven torn: deleted outright, no quarantine
        assert not os.path.isdir(ck._step_dir(4))
        assert not os.path.isdir(os.path.join(ck.directory, "quarantine-4"))

    def test_torn_step_without_manifest_fails_its_read(self, tmp_path):
        """A crash between publish and manifest leaves no manifest; the
        writer backfills it, so tear the step after that and drop every
        manifest (a directory from before manifests): the read fails and
        the walk goes on."""
        ck = _ckpt(tmp_path / "ck")
        for s in (2, 4):
            ck.maybe_save(s, _state(s), force=True)
        _tear(ck, 4)
        for s in (2, 4):
            os.unlink(ck._manifest_path(s))
        ro = Checkpointer(CheckpointConfig(directory=ck.directory), read_only=True)
        assert ro.complete_steps_desc() == [4, 2]
        raw, step = ro.restore_raw()
        assert step == 2

    def test_every_step_torn_raises_and_clears_the_labels(self, tmp_path):
        ck = _ckpt(tmp_path / "ck")
        ck.maybe_save(1, _state(1), force=True)
        _tear(ck, 1)
        with pytest.raises(FileNotFoundError):
            ck.restore(_zeros_like(_state(1)))
        assert ck.all_steps() == []
        assert ck.maybe_save(1, _state(1), force=True)  # the label is free again


class TestReadOnly:
    def test_read_only_writes_nothing(self, tmp_path):
        ck = _ckpt(tmp_path / "ck")
        for s in (2, 4, 6):
            ck.maybe_save(s, _state(s), force=True)
        _tear(ck, 6)
        # a manifest a writer would backfill: a reader may not, so step 4
        # does not verify and the walk lands on 2
        os.unlink(ck._manifest_path(4))
        before = _listing(ck.directory)
        ro = Checkpointer(CheckpointConfig(directory=ck.directory), read_only=True)
        raw, step = ro.restore_raw()
        assert step == 2
        _assert_equal(raw, _state(2))
        _, step = ro.restore(_zeros_like(_state(2)), step=2)  # older: no purge
        assert step == 2
        ro.wait()
        with pytest.raises(RuntimeError, match="read-only"):
            ro.maybe_save(8, _state(8), force=True)
        assert _listing(ck.directory) == before

    def test_read_only_never_creates_the_directory(self, tmp_path):
        missing = tmp_path / "no" / "such" / "dir"
        ro = Checkpointer(CheckpointConfig(directory=str(missing)), read_only=True)
        with pytest.raises(FileNotFoundError):
            ro.restore_raw()
        assert not missing.exists() and not (tmp_path / "no").exists()


class TestExplicitRestorePurgesNewer:
    def test_restore_older_step_quarantines_newer_and_frees_labels(self, tmp_path):
        ck = _ckpt(tmp_path / "ck")
        for s in (2, 4, 6):
            assert ck.maybe_save(s, _state(s), force=True)
        ck.wait()
        restored, step = ck.restore(_zeros_like(_state(0)), step=2)
        assert step == 2 and float(restored["params"]["b"][1]) == 2.0
        assert ck.all_steps() == [2]
        for bad in (4, 6):
            assert not os.path.isdir(ck._step_dir(bad))
            # bytes were never proven torn -> preserved for hand recovery
            assert os.path.isdir(os.path.join(ck.directory, f"quarantine-{bad}"))
            assert not os.path.exists(ck._manifest_path(bad))
        # the freed labels accept the replay's saves again
        assert ck.maybe_save(4, _state(4), force=True)
        ck.wait()
        assert ck.verify_step(4)

    def test_restore_proven_torn_newer_step_is_deleted_outright(self, tmp_path):
        ck = _ckpt(tmp_path / "ck")
        for s in (2, 4):
            assert ck.maybe_save(s, _state(s), force=True)
        ck.wait()
        _tear(ck, 4)
        _, step = ck.restore(_zeros_like(_state(0)), step=2)
        assert step == 2
        assert not os.path.isdir(ck._step_dir(4))
        assert not os.path.isdir(os.path.join(ck.directory, "quarantine-4"))


class TestAgainstTheJaxCheckpointer:
    """The same script on both checkpointers: which saves happen, which
    steps stay, which step a restore lands on."""

    @staticmethod
    def _jax(path, **kw):
        from polyaxon_tpu.train.checkpoint import CheckpointConfig as JCfg
        from polyaxon_tpu.train.checkpoint import Checkpointer as JCkpt

        cfg = dict(save_interval_steps=1, max_to_keep=8, async_save=False)
        cfg.update(kw)
        return JCkpt(JCfg(directory=str(path), **cfg))

    @staticmethod
    def _jax_state(step):
        import jax.numpy as jnp

        return {"w": jnp.arange(64, dtype=jnp.float32) * step,
                "m": (jnp.arange(64, dtype=jnp.float32) * step).astype(jnp.bfloat16),
                "step": jnp.asarray(step)}

    @staticmethod
    def _port_state(step):
        return {"w": torch.arange(64, dtype=torch.float32) * step,
                "m": (torch.arange(64, dtype=torch.float32) * step).to(torch.bfloat16),
                "step": step}

    def _run(self, ck, state, like, script):
        """``script``: a list of ("save", step) / ("force", step) /
        ("tear", step) / ("restore", step-or-None); returns what each
        save answered, the steps left, and each restore's step."""
        answers, restored = [], []
        for verb, arg in script:
            if verb in ("save", "force"):
                answers.append(bool(ck.maybe_save(arg, state(arg), force=verb == "force")))
                ck.wait()
            elif verb == "tear":
                _tear(ck, arg)
            else:
                _, s = ck.restore(like(), step=arg)
                restored.append(int(s))
        ck.wait()
        steps = ck.manager.all_steps() if hasattr(ck, "manager") else ck.all_steps()
        return answers, sorted(int(s) for s in steps), restored

    @pytest.mark.parametrize("interval,keep,script", [
        # the interval policy (the first save always goes), rotation, the
        # final forced save
        (3, 2, [("save", s) for s in range(1, 9)] + [("force", 9), ("restore", None)]),
        # a torn newest step: the restore walks back to the previous one
        (2, 5, [("save", s) for s in range(1, 7)] + [("tear", 6), ("restore", None)]),
        # a rollback to an explicit older step, then its replay's saves
        (1, 8, [("force", 2), ("force", 4), ("force", 6), ("restore", 2),
                ("save", 3), ("save", 4), ("restore", None)]),
    ])
    def test_same_steps_as_the_jax_checkpointer(self, tmp_path, interval, keep, script):
        jck = self._jax(tmp_path / "jax", save_interval_steps=interval, max_to_keep=keep)
        tck = _ckpt(tmp_path / "port", save_interval_steps=interval, max_to_keep=keep)
        jres = self._run(jck, self._jax_state, lambda: self._jax_state(0), script)
        tres = self._run(tck, self._port_state, lambda: self._port_state(0), script)
        jck.close()
        assert tres == jres
        # and the values restored are the saved ones
        raw, step = tck.restore_raw()
        assert torch.equal(raw["w"], self._port_state(step)["w"])
        assert np.array_equal(raw["m"].float().numpy(),
                              self._port_state(step)["m"].float().numpy())


class TestForeignOrbaxDirectory:
    """A directory the JAX package's (Orbax) Checkpointer wrote: the port
    cannot read its steps, so every entry that resumes or restores from it
    refuses loudly, naming the format and the ``import:`` route, and leaves
    every file as it was — no purge, no quarantine, no fresh start."""

    SPEC = {"model": "llama-tiny", "platform": "cpu", "steps": 2, "batch_size": 2,
            "seq_len": 32, "watchdog": False}

    @staticmethod
    def _tree(path):
        out = {}
        for d, _, names in os.walk(path):
            for n in names:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, path)] = f.read()
        return out

    @pytest.mark.parametrize("entry", ["trainer", "runtime", "serving"])
    def test_refused_and_left_byte_identical(self, tmp_path, monkeypatch, entry):
        from polyaxon_tpu_torch.runtime.builtin import build_trainer, run_builtin
        from polyaxon_tpu_torch.serve.runtime import build_engine
        from polyaxon_tpu_torch.train.checkpoint import ForeignCheckpointError

        ckdir = tmp_path / "outputs" / "checkpoints"
        jck = TestAgainstTheJaxCheckpointer._jax(ckdir)
        for step in (1, 2):
            jck.maybe_save(step, TestAgainstTheJaxCheckpointer._jax_state(step), force=True)
            jck.wait()
        jck.close()
        before = self._tree(tmp_path)
        assert any(n.endswith("_CHECKPOINT_METADATA") for n in before)
        monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
        with pytest.raises(ForeignCheckpointError) as err:
            if entry == "trainer":
                trainer, _ = build_trainer(dict(self.SPEC), artifacts_dir=str(tmp_path))
                trainer.restore_or_init()
            elif entry == "runtime":
                run_builtin(dict(self.SPEC))
            else:
                build_engine({"model": "llama-tiny", "platform": "cpu",
                              "checkpoint": str(ckdir)})
        msg = str(err.value)
        assert "Orbax" in msg and "import:" in msg and "[1, 2]" in msg
        after = self._tree(tmp_path)
        if entry == "runtime":
            # the runtime's tracked run adds its own files (events, logs)
            # beside the checkpoints
            after = {k: v for k, v in after.items()
                     if k.startswith(os.path.join("outputs", "checkpoints"))}
        assert after == before
        assert not [n for n in os.listdir(ckdir) if n.startswith("quarantine")]
