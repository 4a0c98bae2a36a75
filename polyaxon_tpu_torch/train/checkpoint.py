"""Checkpoint save, resume and restore of the port — counterpart of
``polyaxon_tpu/train/checkpoint.py`` in a torch-native format.

Layout of a checkpoint directory:

    <directory>/<step>/state.pt       one file per step (``torch.save`` of
                                      the state tree, tensors on the CPU;
                                      bf16 is stored as bf16)
    <directory>/manifest-<step>.json  sha256 and size of every file of
                                      the step
    <directory>/quarantine-<step>/    a newer step moved out of the way by
                                      an explicit older restore

Publishing is atomic at both levels: a step is written into a
``tmp-<step>-*`` directory, its file fsynced, the directory renamed to
``<step>`` and the parent fsynced; a manifest is written to a ``.tmp``
file, fsynced, renamed and the parent fsynced. A pure-digit directory is
therefore a finished save, and a step without a manifest (a crash between
the two renames) gets one backfilled by the next writer.

Atomic publish alone cannot catch a step torn after publish (a truncated
file from a preempted sync, a partial copy). ``restore`` walks the steps
newest first and skips any whose manifest check or read fails, resuming
from the newest COMPLETE step instead of dying on — or training from — a
torn one.

A save is taken off the step's critical path as the JAX package's async
Orbax save is: ``maybe_save`` copies the state to the host and returns;
a thread writes, publishes, hashes and rotates (``max_to_keep``).
``wait()`` joins it. ``read_only=True`` (a serving replica borrowing a
training run's directory) never creates a directory and never writes.

A step holds the full state at every world size: under fsdp the trainer
gathers each leaf to rank 0, the only writer, and the other ranks restore
read-only the step rank 0 names, each keeping its shard (``restore``'s
``select``). So a step saved at ``{fsdp: 2}`` restores at world 1 and the
other way round.

The JAX package's Orbax checkpointer writes the same manifests over steps
the port cannot read (``_CHECKPOINT_METADATA`` and ``default/``, no
``state.pt``). Such a foreign step is refused by name
(:class:`ForeignCheckpointError`) by every restore, and no manifest flush,
rotation or purge touches it: a run moved from the JAX runtime to the
port must not lose its resume point silently.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"
#: what an Orbax step directory of the JAX package holds instead
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default")


class ForeignCheckpointError(RuntimeError):
    """The directory holds steps in the JAX package's Orbax format. The
    port cannot read them, and it never purges or quarantines them."""


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    save_interval_steps: int = 1000
    max_to_keep: int = 3
    async_save: bool = True


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(tree: Any) -> Any:
    """A copy of the tree with every tensor on the CPU: a device tensor is
    copied out, a CPU tensor cloned (the trainer updates its state in
    place, so a pending write must not alias it)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    return tree


def _place_like(like: Any, loaded: Any, where: str = "", select=None) -> Any:
    """Copy ``loaded`` into ``like``'s tensors in place (their device and
    dtype), checking the structure and every shape; non-tensor leaves come
    from ``loaded``. ``select(loaded, like)`` picks the part of a loaded
    leaf that ``like`` holds (an fsdp rank's shard of a full leaf).
    Returns the filled tree."""
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(like) != set(loaded):
            raise ValueError(f"checkpoint tree differs at {where or '/'}: "
                             f"{sorted(like) if isinstance(like, dict) else like} vs "
                             f"{sorted(loaded) if isinstance(loaded, dict) else loaded}")
        return {k: _place_like(like[k], loaded[k], f"{where}/{k}", select) for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(like) != len(loaded):
            raise ValueError(f"checkpoint tree differs at {where}")
        return type(like)(_place_like(a, b, f"{where}/{i}", select)
                          for i, (a, b) in enumerate(zip(like, loaded)))
    if isinstance(like, torch.Tensor):
        if select is not None and isinstance(loaded, torch.Tensor):
            loaded = select(loaded, like)
        if not isinstance(loaded, torch.Tensor) or loaded.shape != like.shape:
            raise ValueError(f"checkpoint leaf {where} has shape "
                             f"{getattr(loaded, 'shape', None)}, want {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(loaded)
        return like
    return loaded


class Checkpointer:
    """Step checkpoints of a state tree (nested dicts, lists and tuples of
    tensors and Python scalars) under one directory.

    ``read_only=True`` is the SERVING mode: N inference replicas restoring
    the same manifest concurrently must be pure readers — no directory
    creation, no manifest backfill, no torn-step purge, no quarantine copy,
    no ``max_to_keep`` rotation. A training pod owns its directory and may
    heal it; a serving pod merely borrows it.
    """

    def __init__(self, cfg: CheckpointConfig, read_only: bool = False):
        self.cfg = cfg
        self.read_only = read_only
        self.directory = os.path.abspath(cfg.directory)
        if not read_only:
            os.makedirs(self.directory, exist_ok=True)
            # a save that died before its rename leaves a tmp dir behind
            for name in os.listdir(self.directory):
                if name.startswith("tmp-"):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        # serializes manifest flushes and rotation: the writer thread vs
        # the synchronous calls in wait()/complete_steps_desc()
        self._flush_lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._writing: Optional[int] = None       # step of the pending write
        self._write_error: Optional[Exception] = None
        #: (step, bytes, seconds) of the last finished write
        self.last_write: Optional[tuple[int, int, float]] = None

    # -- steps ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest-{step}.json")

    def all_steps(self) -> list[int]:
        """Published steps, ascending (plus a step still being written)."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            names = []
        steps = {int(n) for n in names if n.isdigit()
                 and os.path.isdir(os.path.join(self.directory, n))}
        if self._writing is not None:
            steps.add(self._writing)
        return sorted(steps)

    def foreign_steps(self) -> list[int]:
        """Published steps in the JAX package's Orbax format: no
        ``state.pt``, but Orbax's ``_CHECKPOINT_METADATA`` or ``default/``."""
        out = []
        for s in self.all_steps():
            root = self._step_dir(s)
            if s == self._writing or os.path.exists(os.path.join(root, STATE_FILE)):
                continue
            if any(os.path.exists(os.path.join(root, m)) for m in ORBAX_MARKERS):
                out.append(s)
        return out

    def _refuse_foreign(self) -> None:
        foreign = self.foreign_steps()
        if foreign:
            raise ForeignCheckpointError(
                f"checkpoint steps {foreign} under {self.cfg.directory} are in the "
                f"JAX package's Orbax format (_CHECKPOINT_METADATA, default/), which "
                f"the port cannot read; export the params with the reference's "
                f"partition tooling (polyaxon_tpu.partition.convert.save_flat or "
                f"export_hf_llama) and start from them with `import: {{path: ...}}`")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """Orbax's default policy: never at or below the latest step; else
        on the interval, or when there is no checkpoint yet."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % max(int(self.cfg.save_interval_steps), 1) == 0 or latest is None

    # -- save ------------------------------------------------------------------

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save if the interval policy says so (``force``: regardless).
        With ``async_save`` the state is copied to the host here and
        written by a thread; returns whether a save was started."""
        if self.read_only:
            raise RuntimeError("read-only Checkpointer cannot save")
        if not force and not self.should_save(step):
            return False
        self._join()  # one write at a time, as Orbax waits for the previous
        if step in self.all_steps():
            raise FileExistsError(f"checkpoint for step {step} already exists")
        host = _to_host(state)
        self._writing = step
        if self.cfg.async_save:
            self._writer = threading.Thread(target=self._write, args=(step, host),
                                            name="ckpt-write", daemon=True)
            self._writer.start()
        else:
            self._write(step, host)
            self._raise_write_error()
        return True

    def _write(self, step: int, host: Any) -> None:
        try:
            t0 = time.perf_counter()
            tmp = tempfile.mkdtemp(prefix=f"tmp-{step}-", dir=self.directory)
            path = os.path.join(tmp, STATE_FILE)
            with open(path, "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._step_dir(step))
            _fsync_dir(self.directory)
            self._writing = None  # published: an ordinary step from here
            self.last_write = (step, os.path.getsize(
                os.path.join(self._step_dir(step), STATE_FILE)),
                time.perf_counter() - t0)
            self._flush_manifests()
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            self._write_error = e
        finally:
            self._writing = None

    def _join(self) -> None:
        t = self._writer
        if t is not None:
            t.join()
            self._writer = None
        self._raise_write_error()

    def _raise_write_error(self) -> None:
        err, self._write_error = self._write_error, None
        if err is not None:
            raise RuntimeError(f"checkpoint write failed: {err!r}") from err

    # -- checksum manifests --------------------------------------------------

    @staticmethod
    def _sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                h.update(chunk)
        return h.hexdigest()

    def _hash_tree(self, step: int) -> dict:
        root = self._step_dir(step)
        files: dict = {}
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                p = os.path.join(dirpath, n)
                files[os.path.relpath(p, root)] = {
                    "sha256": self._sha256(p), "size": os.path.getsize(p)}
        return files

    def _write_manifest(self, step: int) -> None:
        payload = {"step": step, "complete": True, "files": self._hash_tree(step)}
        path = self._manifest_path(step)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publish: readers see all or nothing
        _fsync_dir(self.directory)

    def _flush_manifests(self) -> None:
        """Write a manifest for every published step that lacks one, rotate
        out steps beyond ``max_to_keep`` (newest kept), and drop manifests
        whose step is gone. Driven by the filesystem: a step published
        right before a crash gets its manifest from the restarted writer
        instead of being mistaken for torn. Read-only mode: no-op."""
        if self.read_only:
            return
        with self._flush_lock:
            foreign = set(self.foreign_steps())  # never rotated, hashed or unlinked
            live = [s for s in self.all_steps() if s != self._writing and s not in foreign]
            keep = int(self.cfg.max_to_keep or 0)
            if keep > 0 and len(live) > keep:
                for s in live[:-keep]:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
                live = live[-keep:]
            for step in live:
                if os.path.exists(self._manifest_path(step)):
                    continue
                try:
                    self._write_manifest(step)
                except OSError:
                    continue  # retry on the next flush
            for name in os.listdir(self.directory):
                if name.startswith("manifest-") and name.endswith(".json"):
                    s = name[len("manifest-"):-len(".json")]
                    if s.isdigit() and int(s) not in live and int(s) != self._writing \
                            and int(s) not in foreign:
                        try:
                            os.unlink(os.path.join(self.directory, name))
                        except OSError:
                            pass

    def verify_step(self, step: int) -> bool:
        """True iff the step has a manifest and every file matches it —
        size first (cheap, catches truncation), then sha256."""
        try:
            with open(self._manifest_path(step), encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        if not manifest.get("complete"):
            return False
        root = self._step_dir(step)
        for rel, info in (manifest.get("files") or {}).items():
            p = os.path.join(root, rel)
            try:
                if os.path.getsize(p) != info["size"]:
                    return False
                if self._sha256(p) != info["sha256"]:
                    return False
            except OSError:
                return False
        return True

    def complete_steps_desc(self) -> list[int]:
        """Restorable steps, newest first. With manifests: only steps that
        verify. Without any manifest (a directory written before
        manifests): every step, trusting the atomic publish."""
        self._refuse_foreign()
        if not self.read_only:
            self._join()
            self._flush_manifests()
        steps = sorted((s for s in self.all_steps() if s != self._writing),
                       reverse=True)
        if not any(os.path.exists(self._manifest_path(s)) for s in steps):
            return steps
        return [s for s in steps if self.verify_step(s)]

    def latest_complete_step(self) -> Optional[int]:
        steps = self.complete_steps_desc()
        return steps[0] if steps else None

    # -- restore -------------------------------------------------------------

    def _load(self, step: int) -> Any:
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location="cpu", mmap=True, weights_only=True)

    def restore(self, state_like: Any, step: Optional[int] = None,
                select=None) -> tuple[Any, int]:
        """Restore the newest COMPLETE step (or the given one) into
        ``state_like``'s tensors, in place (their device and dtype; the
        structure and every shape must match, after ``select(loaded,
        like)`` when given picks each leaf's part). With ``step=None`` a torn
        newest step — checksum mismatch, or a read error on a step
        without a manifest — is skipped and the next older complete step
        restores; only when every candidate fails does this raise.

        Every successful restore — explicit ``step=`` included (the
        divergence rollback targets an older step) — purges or
        quarantines the steps NEWER than the restored one, so the resumed
        run's own saves at those step numbers are not refused. A directory
        with Orbax steps of the JAX package raises
        :class:`ForeignCheckpointError` and is left as it is."""
        self._refuse_foreign()
        candidates = [step] if step is not None else self.complete_steps_desc()
        if not candidates:
            if step is None:
                self._purge_newer_than(-1)
            raise FileNotFoundError(
                f"No complete checkpoint under {self.cfg.directory}")
        errors: list = []
        for s in candidates:
            try:
                loaded = self._load(s)
            except Exception as e:  # a torn step torch.load choked on
                if step is not None:
                    raise
                errors.append((s, repr(e)))
                continue
            restored = _place_like(state_like, loaded, select=select)
            self._purge_newer_than(s)
            return restored, s
        if step is None:
            self._purge_newer_than(-1)
        raise FileNotFoundError(
            f"No restorable checkpoint under {self.cfg.directory}; "
            f"every candidate failed: {errors}")

    def restore_raw(self, step: Optional[int] = None) -> tuple[Any, int]:
        """Restore the newest COMPLETE step (or the given one) as saved:
        the tree with its tensors on the CPU, memory-mapped from the file.
        The serving path uses this (it wants ``params`` and has no
        optimizer state to restore into). Same torn-step walk as
        :meth:`restore`; with ``read_only=True`` entirely side-effect
        free."""
        self._refuse_foreign()
        candidates = [step] if step is not None else self.complete_steps_desc()
        if not candidates:
            raise FileNotFoundError(
                f"No complete checkpoint under {self.cfg.directory}")
        errors: list = []
        for s in candidates:
            try:
                return self._load(s), s
            except Exception as e:
                if step is not None:
                    raise
                errors.append((s, repr(e)))
        raise FileNotFoundError(
            f"No restorable checkpoint under {self.cfg.directory}; "
            f"every candidate failed: {errors}")

    def _purge_newer_than(self, step: int) -> None:
        """Remove every step NEWER than the restored one (``-1``: every
        step — the all-candidates-failed fresh start): left behind, they
        would block the resumed run's saves at those step numbers. A step
        PROVEN torn (its manifest fails verification) is deleted outright;
        one whose bytes were never shown bad is copied to
        ``quarantine-<step>`` first, so the run's newest state stays
        recoverable by hand. Read-only mode: no-op."""
        if self.read_only:
            return
        self._join()
        foreign = set(self.foreign_steps())
        for bad in [s for s in self.all_steps() if s > step and s not in foreign]:
            proven_torn = (os.path.exists(self._manifest_path(bad))
                           and not self.verify_step(bad))
            if not proven_torn:
                dst = os.path.join(self.directory, f"quarantine-{bad}")
                shutil.rmtree(dst, ignore_errors=True)
                try:
                    shutil.copytree(self._step_dir(bad), dst)
                except OSError:
                    pass  # quarantine is best-effort; the removal is not
            shutil.rmtree(self._step_dir(bad), ignore_errors=True)
        self._flush_manifests()  # drops the dead steps' manifests too

    def wait(self) -> None:
        """Join the pending write (raising its error, if any) and flush
        manifests."""
        if self.read_only:
            return
        self._join()
        self._flush_manifests()



def to_device(tree: Any, device: Any) -> Any:
    """A restored tree's tensors on ``device``, each its own copy (a
    restored CPU tensor is mapped from its checkpoint file)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)
