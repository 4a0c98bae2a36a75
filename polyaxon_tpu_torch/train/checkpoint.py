"""Checkpoint save, resume and restore of the port — counterpart of
``polyaxon_tpu/train/checkpoint.py`` in a torch-native format.

Layout of a checkpoint directory:

    <directory>/<step>/shard-<rank>.pt    one file per rank that holds a
                                          block no lower rank holds
                                          (``torch.save`` of ``{leaf path:
                                          its block}``, CPU tensors; bf16
                                          is stored as bf16)
    <directory>/<step>/shard-<rank>.json  one per rank: that rank's leaves,
                                          each one's global shape, dtype,
                                          and its block's start and size
                                          per dim (none for a rank that
                                          writes no block)
    <directory>/<step>/index.json         the ranks' records merged: the
                                          tree's structure and scalars,
                                          every leaf's global shape and the
                                          file and offsets of each block
    <directory>/manifest-<step>.json      sha256 and size of every file of
                                          the step
    <directory>/quarantine-<step>/        a newer step moved out of the way
                                          by an explicit older restore

Each rank writes its own blocks, as the JAX package's Orbax save has each
process write its own shards: a leaf's block goes to the file of the first
rank that holds it (every coordinate off the axes that cut the leaf 0), so
a replicated leaf is written once. No rank gathers a leaf. A step saved at
one world size and mesh restores at any other: each rank reads, for each
leaf of its state, the parts of the saved blocks that overlap its own
block, from memory-mapped files. A step of the one-file layout
(``<step>/state.pt``: the whole state, one ``torch.save``) still restores,
through the same overlap read.

Publishing is atomic at both levels. Every rank writes its files into the
step's ``tmp-<step>-shards`` directory (each fsynced, then renamed into
place; its ``.json`` last, the mark that its ``.pt``, if it has blocks to
write, is whole). Rank 0
waits until every rank's mark is there (a barrier over the shared
directory: its writer thread polls, so no collective runs beside the
training step), writes ``index.json``, renames the directory to ``<step>``
and fsyncs the parent; a manifest is written to a ``.tmp`` file, fsynced,
renamed and the parent fsynced. A pure-digit directory is therefore a
finished save, and a step without a manifest (a crash between the two
renames) gets one backfilled by the next writer.

Atomic publish alone cannot catch a step torn after publish (a truncated
or missing rank file, a partial copy). ``restore`` walks the steps newest
first and skips any whose manifest check or read fails, resuming from the
newest COMPLETE step instead of dying on — or training from — a torn one.

A save is taken off the step's critical path as the JAX package's async
Orbax save is: ``maybe_save`` copies this rank's blocks to the host and
returns; a thread writes, publishes, hashes and rotates (``max_to_keep``).
``wait()`` joins it. ``read_only=True`` (a serving replica borrowing a
training run's directory) never creates a directory and never writes; a
rank other than 0 writes its own files and nothing else (it never
publishes, hashes, rotates or purges).

The JAX package's Orbax checkpointer writes the same manifests over steps
the port cannot read (``_CHECKPOINT_METADATA`` and ``default/``, neither
``index.json`` nor ``state.pt``). Such a foreign step is refused by name
(:class:`ForeignCheckpointError`) by every restore, and no manifest flush,
rotation or purge touches it: a run moved from the JAX runtime to the
port must not lose its resume point silently.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from ..parallel.blocks import Placement, block_bounds

#: the one-file layout of earlier saves (still restored)
STATE_FILE = "state.pt"
#: the merged record of a step's rank files
INDEX_FILE = "index.json"
#: a rank's files in a step: ``.pt`` (its blocks) and ``.json`` (their record)
SHARD_NAME = "shard-{:05d}"
#: what an Orbax step directory of the JAX package holds instead
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default")
#: how long rank 0's writer waits for the other ranks' files of a step
SHARD_WAIT_S = 1800.0


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


def _write_json(path: str, payload: Any) -> int:
    """``payload`` as JSON at ``path``: a ``.part`` file, fsynced, then
    renamed (readers see all of it or nothing). Returns its bytes."""
    with open(path + ".part", "w", encoding="utf-8") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
        size = f.tell()
    os.replace(path + ".part", path)
    return size


def _structure(tree: Any, on_tensor) -> Any:
    """The tree's structure as JSON (``{"d": dict}``, ``{"l": list}``,
    ``{"t": tuple}``, ``{"x": leaf path}``, ``{"v": scalar}``, None);
    ``on_tensor(path, tensor)`` sees each tensor."""

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {"d": {k: walk(v, f"{path}{k}/") for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            kind = "l" if isinstance(node, list) else "t"
            return {kind: [walk(v, f"{path}{i}/") for i, v in enumerate(node)]}
        if isinstance(node, torch.Tensor):
            on_tensor(path[:-1], node)
            return {"x": path[:-1]}
        return None if node is None else {"v": node}

    return walk(tree, "")


def _host_blocks(tree: Any, placement: Optional[Placement], rank: int) -> tuple:
    """(the tree's structure, ``{path: host copy of a block}`` of the blocks
    this rank writes, ``{path: record}`` of each: global shape, dtype, start
    and size). A leaf the placement does not cut is whole, written by rank
    0. A device tensor is copied out, a CPU tensor cloned (the trainer
    updates its state in place, so a pending write must not alias it)."""
    blocks: dict = {}
    records: dict = {}

    def keep(name: str, node: torch.Tensor) -> None:
        if not (placement.writes(name) if placement is not None else rank == 0):
            return
        t = node.detach()
        blocks[name] = t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
        cuts = placement.leaf_cuts(name) if placement is not None else ()
        shape = list(t.shape)
        for axis, dim in cuts:
            shape[dim] *= placement.sizes[axis]
        start = block_bounds(shape, cuts, placement.sizes, placement.coords)[0] if cuts \
            else [0] * t.dim()
        records[name] = {"shape": shape, "dtype": str(t.dtype).split(".")[-1],
                         "start": start, "size": list(t.shape)}

    return _structure(tree, keep), blocks, records


class _Step:
    """One published step opened for reading: its tree structure and, per
    leaf, its global shape, dtype and blocks (each a tensor on the host,
    memory-mapped, and its start). Reads the sharded layout's index and
    files, or the one-file layout's ``state.pt``; a missing or unreadable
    file raises here."""

    def __init__(self, root: str):
        self.leaves: dict = {}
        index = os.path.join(root, INDEX_FILE)
        if os.path.exists(index):
            with open(index, encoding="utf-8") as f:
                meta = json.load(f)
            files = {name: torch.load(os.path.join(root, name), map_location="cpu",
                                      mmap=True, weights_only=True)
                     for name in meta["files"]}
            self.tree = meta["tree"]
            for path, leaf in meta["leaves"].items():
                self.leaves[path] = (leaf["shape"], leaf["dtype"],
                                     [(files[b["file"]][path], b["start"])
                                      for b in leaf["blocks"]])
            return
        loaded = torch.load(os.path.join(root, STATE_FILE), map_location="cpu", mmap=True,
                            weights_only=True)

        def whole(path: str, t: torch.Tensor) -> None:
            self.leaves[path] = (list(t.shape), str(t.dtype).split(".")[-1],
                                 [(t, [0] * t.dim())])

        self.tree = _structure(loaded, whole)

    def read(self, path: str, start: Sequence[int], size: Sequence[int],
             out: Optional[torch.Tensor] = None, device: Any = None) -> torch.Tensor:
        """The block of leaf ``path`` at ``start`` of ``size``: into ``out``
        (in place, its device and dtype) when given, else a new tensor on
        ``device``; with neither, the saved block itself (memory-mapped)
        when it is exactly that block, else a new tensor on the host."""
        _, dt, blocks = self.leaves[path]
        if out is None:
            if device is None and len(blocks) == 1 and list(blocks[0][1]) == list(start) \
                    and list(blocks[0][0].shape) == list(size):
                return blocks[0][0]
            out = torch.empty(tuple(size), dtype=getattr(torch, dt), device=device or "cpu")
        covered = 0
        with torch.no_grad():
            for t, b0 in blocks:
                lo = [max(s, b) for s, b in zip(start, b0)]
                hi = [min(s + n, b + m) for s, n, b, m in zip(start, size, b0, t.shape)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                src = t[tuple(slice(l - b, h - b) for l, h, b in zip(lo, hi, b0))]
                out[tuple(slice(l - s, h - s) for l, h, s in zip(lo, hi, start))].copy_(src)
                covered += math.prod(h - l for l, h in zip(lo, hi))
        if covered != math.prod(size):
            raise ValueError(f"checkpoint leaf {path}: its saved blocks cover {covered} of "
                             f"the {math.prod(size)} elements of the block at {list(start)}")
        return out


def _bounds(step: _Step, path: str, placement: Optional[Placement]) -> tuple:
    shape = step.leaves[path][0]
    if placement is None:
        return [0] * len(shape), list(shape)
    return placement.bounds(path, shape)


def _fill_like(like: Any, node: Any, step: _Step, placement: Optional[Placement],
               where: str = "") -> Any:
    """Copy the step into ``like``'s tensors in place (their device and
    dtype): each tensor is the block of its leaf that ``placement`` gives
    this rank (the whole leaf without one). The structure and every shape
    must match; non-tensor leaves come from the step. Returns the filled
    tree."""
    name = where.lstrip("/") or "/"
    if isinstance(like, dict):
        if not (isinstance(node, dict) and "d" in node) or set(like) != set(node["d"]):
            got = sorted(node["d"]) if isinstance(node, dict) and "d" in node else node
            raise ValueError(f"checkpoint tree differs at {name}: {sorted(like)} vs {got}")
        return {k: _fill_like(like[k], node["d"][k], step, placement, f"{where}/{k}")
                for k in like}
    if isinstance(like, (list, tuple)):
        items = node.get("l", node.get("t")) if isinstance(node, dict) else None
        if items is None or len(items) != len(like):
            raise ValueError(f"checkpoint tree differs at {name}")
        return type(like)(_fill_like(a, b, step, placement, f"{where}/{i}")
                          for i, (a, b) in enumerate(zip(like, items)))
    if isinstance(like, torch.Tensor):
        if not (isinstance(node, dict) and "x" in node):
            raise ValueError(f"checkpoint leaf {name} is not a tensor, want "
                             f"{tuple(like.shape)}")
        path = node["x"]
        start, size = _bounds(step, path, placement)
        if list(size) != list(like.shape):
            raise ValueError(f"checkpoint leaf {name} has shape {tuple(step.leaves[path][0])} "
                             f"(this rank's block {tuple(size)}), want {tuple(like.shape)}")
        return step.read(path, start, size, out=like)
    return _build(node, step, None, None)


def _build(node: Any, step: _Step, placement: Optional[Placement], device: Any) -> Any:
    """The step's tree from its structure: each tensor the block of its
    leaf that ``placement`` gives this rank (the whole leaf without one),
    its own copy on ``device`` (None: memory-mapped where a saved block is
    exactly it, else assembled on the host), one leaf at a time."""
    if node is None:
        return None
    if "d" in node:
        return {k: _build(v, step, placement, device) for k, v in node["d"].items()}
    if "l" in node or "t" in node:
        out = [_build(v, step, placement, device) for v in node.get("l", node.get("t"))]
        return out if "l" in node else tuple(out)
    if "x" in node:
        start, size = _bounds(step, node["x"], placement)
        return step.read(node["x"], start, size, device=device)
    return node["v"]


class Checkpointer:
    """Step checkpoints of a state tree (nested dicts, lists and tuples of
    tensors and Python scalars) under one directory.

    ``read_only=True`` is the SERVING mode: N inference replicas restoring
    the same manifest concurrently must be pure readers — no directory
    creation, no manifest backfill, no torn-step purge, no quarantine copy,
    no ``max_to_keep`` rotation. A training pod owns its directory and may
    heal it; a serving pod merely borrows it.

    Over ``world`` ranks every rank has its own Checkpointer on the same
    directory: rank 0 owns it (publishes, hashes, rotates, purges); a rank
    other than 0 only writes its files of each step.
    """

    def __init__(self, cfg: CheckpointConfig, read_only: bool = False, rank: int = 0,
                 world: int = 1):
        self.cfg = cfg
        self.read_only = read_only
        self.rank, self.world = int(rank), int(world)
        #: this Checkpointer publishes and heals the directory
        self.owner = not read_only and self.rank == 0
        self.directory = os.path.abspath(cfg.directory)
        if self.owner:
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
        #: (step, bytes of this rank's files, seconds) of the last finished
        #: write
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
        """Published steps in the JAX package's Orbax format: neither
        ``index.json`` nor ``state.pt``, but Orbax's
        ``_CHECKPOINT_METADATA`` or ``default/``."""
        out = []
        for s in self.all_steps():
            root = self._step_dir(s)
            if s == self._writing or any(os.path.exists(os.path.join(root, name))
                                         for name in (INDEX_FILE, STATE_FILE)):
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

    def maybe_save(self, step: int, state: Any, force: bool = False,
                   placement: Optional[Placement] = None) -> bool:
        """Save if the interval policy says so (``force``: regardless):
        this rank's blocks of ``state`` (``placement``: where they lie; None:
        every leaf whole, written by rank 0). Over several ranks every rank
        calls it for the step. With ``async_save`` the blocks are copied to
        the host here and written by a thread; returns whether a save was
        started."""
        if self.read_only:
            raise RuntimeError("read-only Checkpointer cannot save")
        if not force and not self.should_save(step):
            return False
        self._join()  # one write at a time, as Orbax waits for the previous
        if self.owner and step in self.all_steps():
            raise FileExistsError(f"checkpoint for step {step} already exists")
        host = _host_blocks(state, placement, self.rank)
        self._writing = step
        if self.cfg.async_save:
            self._writer = threading.Thread(target=self._write, args=(step, host),
                                            name="ckpt-write", daemon=True)
            self._writer.start()
        else:
            self._write(step, host)
            self._raise_write_error()
        return True

    def _write(self, step: int, host: tuple) -> None:
        try:
            t0 = time.perf_counter()
            tree, blocks, records = host
            tmp = os.path.join(self.directory, f"tmp-{step}-shards")
            os.makedirs(tmp, exist_ok=True)
            name = SHARD_NAME.format(self.rank)
            nbytes = 0
            if blocks:
                path = os.path.join(tmp, name + ".pt")
                with open(path + ".part", "wb") as f:
                    torch.save(blocks, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(path + ".part", path)
                _fsync_dir(tmp)
                nbytes = os.path.getsize(path)
            # the record last: its presence says the blocks are whole, and
            # from then on rank 0 may publish (rename) the directory
            nbytes += _write_json(os.path.join(tmp, name + ".json"),
                                  {"rank": self.rank, "leaves": records,
                                   **({"tree": tree} if self.rank == 0 else {})})
            if self.owner:
                self._publish(step, tmp)
            self._writing = None  # published: an ordinary step from here
            self.last_write = (step, nbytes, time.perf_counter() - t0)
            if self.owner:
                self._flush_manifests()
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            self._write_error = e
        finally:
            self._writing = None

    def _publish(self, step: int, tmp: str) -> None:
        """Rank 0: once every rank's record of the step is in ``tmp``, merge
        them into the index, then rename the directory to the step."""
        names = [SHARD_NAME.format(r) for r in range(self.world)]
        deadline = time.monotonic() + SHARD_WAIT_S
        while not all(os.path.exists(os.path.join(tmp, n + ".json")) for n in names):
            if time.monotonic() > deadline:
                raise TimeoutError(f"step {step}: not every rank wrote its files into "
                                   f"{tmp} within {SHARD_WAIT_S:.0f} s")
            time.sleep(0.05)
        leaves: dict = {}
        files = []
        tree = None
        for n in names:
            with open(os.path.join(tmp, n + ".json"), encoding="utf-8") as f:
                record = json.load(f)
            tree = record.get("tree", tree)
            if record["leaves"]:
                files.append(n + ".pt")
            for path, leaf in record["leaves"].items():
                entry = leaves.setdefault(path, {"shape": leaf["shape"],
                                                 "dtype": leaf["dtype"], "blocks": []})
                entry["blocks"].append({"file": n + ".pt", "start": leaf["start"],
                                        "size": leaf["size"]})
        _write_json(os.path.join(tmp, INDEX_FILE),
                    {"format": "sharded", "world": self.world, "tree": tree,
                     "files": files, "leaves": leaves})
        _fsync_dir(tmp)
        os.replace(tmp, self._step_dir(step))
        _fsync_dir(self.directory)

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
        instead of being mistaken for torn. A no-op but on the owner."""
        if not self.owner:
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
        """True iff the step has a manifest, every rank file its index
        names is in it, and every file matches it — size first (cheap,
        catches truncation), then sha256."""
        try:
            with open(self._manifest_path(step), encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        if not manifest.get("complete"):
            return False
        root = self._step_dir(step)
        try:
            with open(os.path.join(root, INDEX_FILE), encoding="utf-8") as f:
                named = set(json.load(f)["files"])
        except FileNotFoundError:
            named = set()
        except (OSError, ValueError, KeyError):
            return False
        if not named <= set(manifest.get("files") or {}):
            return False
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
        if self.owner:
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

    def _open(self, step: int) -> _Step:
        return _Step(self._step_dir(step))

    def restore(self, state_like: Any, step: Optional[int] = None,
                placement: Optional[Placement] = None) -> tuple[Any, int]:
        """Restore the newest COMPLETE step (or the given one) into
        ``state_like``'s tensors, in place (their device and dtype; the
        structure and every shape must match). ``placement``: where this
        rank's blocks lie, each read from the parts of the saved blocks it
        overlaps (at any world size and mesh the step was saved at); None:
        every leaf whole. With ``step=None`` a torn newest step — checksum
        mismatch, a missing rank file, or a read error on a step without a
        manifest — is skipped and the next older complete step restores;
        only when every candidate fails does this raise.

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
                opened = self._open(s)
            except Exception as e:  # a torn step the read choked on
                if step is not None:
                    raise
                errors.append((s, repr(e)))
                continue
            restored = _fill_like(state_like, opened.tree, opened, placement)
            self._purge_newer_than(s)
            return restored, s
        if step is None:
            self._purge_newer_than(-1)
        raise FileNotFoundError(
            f"No restorable checkpoint under {self.cfg.directory}; "
            f"every candidate failed: {errors}")

    def restore_raw(self, step: Optional[int] = None, device: Any = None,
                    placement: Optional[Placement] = None,
                    keys: Optional[Sequence[str]] = None) -> tuple[Any, int]:
        """Restore the newest COMPLETE step (or the given one) as saved:
        the tree, each leaf assembled from its saved blocks one leaf at a
        time — on ``device``, or on the host (memory-mapped from the file
        where one saved block is the leaf). ``placement``: each leaf this
        rank's block of it instead (a fork's start); ``keys``: only these
        top-level subtrees (say ``params``) are built. The serving path uses
        this (it wants ``params`` and has no optimizer state to restore
        into). Same torn-step walk as :meth:`restore`; with
        ``read_only=True`` entirely side-effect free."""
        self._refuse_foreign()
        candidates = [step] if step is not None else self.complete_steps_desc()
        if not candidates:
            raise FileNotFoundError(
                f"No complete checkpoint under {self.cfg.directory}")
        errors: list = []
        for s in candidates:
            try:
                opened = self._open(s)
            except Exception as e:
                if step is not None:
                    raise
                errors.append((s, repr(e)))
                continue
            tree = opened.tree
            if keys is not None:
                tree = {"d": {k: v for k, v in tree["d"].items() if k in keys}}
            return _build(tree, opened, placement, device), s
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
        recoverable by hand. A no-op but on the owner."""
        if not self.owner:
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
        manifests (the owner)."""
        if self.read_only:
            return
        self._join()
        self._flush_manifests()


def read_step(step_dir: str) -> Any:
    """A published step's whole tree on the host, in either layout: each
    leaf memory-mapped where one saved block is the leaf, else assembled
    from its blocks, one leaf at a time."""
    opened = _Step(step_dir)
    return _build(opened.tree, opened, None, None)
