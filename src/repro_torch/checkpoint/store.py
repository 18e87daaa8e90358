"""Checkpointing: crash-consistent npz store + async CheckpointManager.

Port of ``repro/checkpoint/store.py``, in the reference's on-disk format,
so a checkpoint written by either package restores into the other:

* ``save``/``load`` — one checkpoint directory: ``tensors.npz`` holds the
  tree's leaves under their ``/``-joined paths (dict keys, list indices),
  ``meta.json`` the metadata plus ``_keys`` (the sorted paths) and
  ``_dtypes`` (the true dtype of every leaf that npz cannot hold: bf16 is
  stored as its ``uint16`` bits under ``"bfloat16"``, exactly as the
  reference stores ml_dtypes). **Atomic publish**: both files are written
  into a hidden ``.tmp-*`` sibling which is then ``os.replace``-d into
  place, so a reader, or a restart after SIGKILL, sees a complete
  checkpoint or none. Load failures raise :class:`CheckpointError` naming
  the path and key.
* :class:`CheckpointManager` — periodic snapshots of a running trainer:
  every K mega-batches the state is copied to host memory synchronously
  (the copy is the trainer's no longer: a CPU tensor is cloned, never
  shared) and written by a background thread, with at most one write in
  flight and bounded retention.

A tree is a nest of dicts and lists whose leaves are torch tensors, numpy
arrays or scalars; None leaves are absent from the store, as in the
reference. ``load`` returns numpy arrays where ``like`` holds numpy arrays
and CPU tensors where it holds tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

SEP = "/"

#: directory-name prefix of one published checkpoint (suffix = mega-batch
#: index); everything else inside a manager directory is ignored by
#: ``latest_checkpoint`` (in-flight ``.tmp-*`` dirs, stray files).
CKPT_PREFIX = "ckpt-"

# npz holds numpy's own kinds; other dtypes are stored as same-width
# unsigned-int views with the true dtype recorded in metadata (bf16, which
# numpy has no type for, under the name the reference records)
_SAFE_KINDS = "fiub?c"
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


class CheckpointError(Exception):
    """A checkpoint could not be read: missing directory/file, a torn or
    corrupt tensors archive, or a tree key absent from the store. The
    message always names the offending path (and key, where applicable)."""


def _items(node):
    if isinstance(node, dict):
        return node.items()
    return ((str(i), v) for i, v in enumerate(node))


def _leaf_paths(tree, prefix: str = ""):
    """(path, leaf) pairs of a nest of dicts and lists, None leaves left
    out."""
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for k, v in _items(tree):
            yield from _leaf_paths(v, f"{prefix}{SEP}{k}" if prefix else str(k))
        return
    yield prefix, tree


def _map_leaves(fn, tree, prefix: str = ""):
    """The tree's structure with ``fn(path, leaf)`` at every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}{SEP}{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, f"{prefix}{SEP}{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _encode(leaf) -> tuple[np.ndarray, Optional[str]]:
    """(array npz can hold, true dtype name or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind not in _SAFE_KINDS:
        return arr.view(_UINT[arr.dtype.itemsize]), str(arr.dtype)
    return arr, None


def host_copy(tree):
    """A copy of ``tree`` in host memory that nothing else references:
    tensors land on the CPU (cloned where they already were), numpy
    arrays and scalars are copied."""
    def copy(_, leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return np.array(leaf)
    return _map_leaves(copy, tree)


def nbytes(tree) -> int:
    """Bytes of the tree's leaves."""
    total = 0
    for _, leaf in _leaf_paths(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def save(path: str, tree, metadata: Optional[dict] = None) -> None:
    """Write one checkpoint directory atomically.

    Both files are staged in a ``.tmp-*`` sibling and published with
    ``os.replace``: a crash mid-write leaves at most a stale temp dir,
    never a directory with one good and one torn file. Overwriting an
    existing ``path`` moves the old version aside first, so a crash during
    an overwrite still leaves one complete checkpoint on disk.
    """
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    enc, dtypes = {}, {}
    for key, leaf in _leaf_paths(tree):
        enc[key], true_dtype = _encode(leaf)
        if true_dtype is not None:
            dtypes[key] = true_dtype
    meta = dict(metadata or {})
    meta["_keys"] = sorted(enc)
    meta["_dtypes"] = dtypes

    tmp = tempfile.mkdtemp(prefix=".tmp-" + os.path.basename(path) + "-", dir=parent)
    try:
        np.savez(os.path.join(tmp, "tensors.npz"), **enc)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, default=float)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(path):
            # os.replace cannot clobber a non-empty dir: retire the old
            # version first (it stays complete until the new one publishes)
            old = tempfile.mkdtemp(prefix=".tmp-old-", dir=parent)
            os.replace(path, os.path.join(old, "prev"))
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _decode(arr: np.ndarray, stored: Optional[str], like):
    """The stored array as ``like``'s kind and dtype."""
    if stored == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        if isinstance(like, torch.Tensor):
            return t.to(like.dtype)
        arr = t.float().numpy()
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
    return arr.astype(np.asarray(like).dtype)


def load(path: str, like) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (shape and dtype checked).

    Raises :class:`CheckpointError` when the checkpoint directory or either
    of its files is missing, the tensors archive is corrupt, or a leaf of
    ``like`` has no stored tensor. A shape mismatch raises ``ValueError``:
    the checkpoint itself is fine, the receiving tree is wrong.
    """
    meta = load_metadata(path)
    tensor_path = os.path.join(path, "tensors.npz")
    try:
        data = np.load(tensor_path)
    except FileNotFoundError:
        raise CheckpointError(f"checkpoint {path} has no tensors.npz") from None
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint tensors are corrupt (torn write?): {tensor_path}: {e}"
        ) from e
    stored_dtypes = meta.get("_dtypes", {})

    def restore(key, leaf):
        try:
            arr = data[key]
        except KeyError:
            raise CheckpointError(
                f"checkpoint {path} is missing tensor {key!r} "
                f"(stored keys: {len(meta.get('_keys', []))})"
            ) from None
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise CheckpointError(
                f"checkpoint tensors are corrupt (torn write?): {tensor_path}: {e}"
            ) from e
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
        return _decode(arr, stored_dtypes.get(key), leaf)

    with data:
        return _map_leaves(restore, like), meta


def load_metadata(path: str) -> dict:
    meta_path = os.path.join(path, "meta.json")
    try:
        with open(meta_path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointError(f"no checkpoint at {path} (missing {meta_path})") from None
    except json.JSONDecodeError as e:
        raise CheckpointError(f"checkpoint metadata is corrupt: {meta_path}: {e}") from e


# --------------------------------------------------------------------------
# manager: periodic async snapshots with retention
# --------------------------------------------------------------------------


def checkpoint_index(name: str) -> Optional[int]:
    """Mega-batch index of a published checkpoint dir name, else None."""
    if not name.startswith(CKPT_PREFIX):
        return None
    try:
        return int(name[len(CKPT_PREFIX):])
    except ValueError:
        return None


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest *complete* checkpoint under ``directory``: a
    ``ckpt-*`` dir is complete iff its ``meta.json`` exists (both files
    land in one rename); ``.tmp-*`` staging dirs are never candidates.
    None when the directory is missing or holds no checkpoint."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    best, best_idx = None, -1
    for name in names:
        idx = checkpoint_index(name)
        if idx is None or idx <= best_idx:
            continue
        if os.path.isfile(os.path.join(directory, name, "meta.json")):
            best, best_idx = os.path.join(directory, name), idx
    return best


def resolve_checkpoint(path: str) -> str:
    """Accept either one checkpoint dir or a manager directory (-> latest)."""
    if os.path.isfile(os.path.join(path, "meta.json")):
        return path
    latest = latest_checkpoint(path)
    if latest is None:
        raise CheckpointError(f"no checkpoint found under {path}")
    return latest


class CheckpointManager:
    """Periodic crash-consistent snapshots of a running ``ElasticTrainer``.

    ``maybe_save(trainer, state)`` is called once per mega-batch (the
    trainer's ``run`` loop does this when a manager is passed); every
    ``every``-th mega-batch it

    1. **snapshots synchronously** — ``trainer.checkpoint_payload(state)``
       is copied to host memory (``host_copy``) before returning, so the
       copy never observes a later mega-batch: the trainer updates its
       replicas, clocks and speed factors in place;
    2. **writes asynchronously** — one background thread runs the atomic
       :func:`save` and the retention sweep while training continues. At
       most one write is in flight (a new snapshot first joins the
       previous write, bounding host memory to two snapshots);
    3. **retains boundedly** — after each publish, all but the newest
       ``retain`` checkpoints (and stale ``.tmp-*`` dirs) are deleted; the
       just-published one never is.

    A writer-thread failure is re-raised on the next ``maybe_save``/``wait``
    call. ``timings`` holds one record per save: the mega-batch index, the
    snapshot's bytes and synchronous seconds, and the write's seconds
    (filled in when it has published). The multi-process single-writer
    rule (the reference's ``publisher=``) waits for the multi-host slice.
    """

    def __init__(self, directory: str, every: int = 1, retain: int = 3):
        if every < 1:
            raise ValueError(f"checkpoint interval must be >= 1, got {every}")
        if retain < 1:
            raise ValueError(f"checkpoint retention must be >= 1, got {retain}")
        self.directory = os.path.abspath(directory)
        self.every = int(every)
        self.retain = int(retain)
        self.timings: list[dict] = []
        self._thread: Optional[threading.Thread] = None
        # guards _error only: the one attribute both threads touch
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._last_saved: Optional[int] = None

    # ---- saving ----
    def step_path(self, megabatch_idx: int) -> str:
        return os.path.join(self.directory, f"{CKPT_PREFIX}{megabatch_idx:06d}")

    def maybe_save(self, trainer, state) -> Optional[str]:
        """Snapshot ``state`` if it sits on the checkpoint interval; returns
        the (future) checkpoint path when a save was scheduled, else None.
        Index k means "k mega-batches completed"."""
        idx = int(state.megabatch_idx)
        if idx % self.every != 0 or idx == self._last_saved or idx == 0:
            return None
        self._reraise()
        t0 = time.perf_counter()
        tree, meta = trainer.checkpoint_payload(state)
        snapshot = host_copy(tree)
        record = {"megabatch": idx, "bytes": nbytes(snapshot),
                  "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.timings.append(record)
        self._last_saved = idx
        path = self.step_path(idx)
        self.wait()           # <= one write in flight
        self._thread = threading.Thread(
            target=self._write_job, args=(path, snapshot, meta, record),
            name="checkpoint-writer", daemon=True,
        )
        self._thread.start()
        return path

    def _write_job(self, path: str, snapshot, meta: dict, record: dict) -> None:
        try:
            t0 = time.perf_counter()
            save(path, snapshot, metadata=meta)
            self._sweep_retention(keep_path=path)
            record["write_s"] = time.perf_counter() - t0
        except BaseException as e:  # surfaced on the next host-thread call
            with self._lock:
                self._error = e

    def wait(self) -> None:
        """Block until the in-flight write (if any) has published."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._reraise()

    def _reraise(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(f"background checkpoint write failed: {err}") from err

    def _sweep_retention(self, keep_path: str) -> None:
        entries = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith(".tmp-") and full != keep_path:
                shutil.rmtree(full, ignore_errors=True)  # stale staging dir
                continue
            idx = checkpoint_index(name)
            if idx is not None and full != keep_path:
                entries.append((idx, full))
        entries.sort(reverse=True)
        for _, full in entries[self.retain - 1:]:  # keep_path counts as one
            shutil.rmtree(full, ignore_errors=True)

    # ---- restoring ----
    def latest(self) -> Optional[str]:
        return latest_checkpoint(self.directory)

    def restore(self, trainer, path: Optional[str] = None):
        """Restore an ``ElasticState`` into ``trainer`` from ``path`` (or
        the newest checkpoint under this manager's directory)."""
        if path is None:
            path = self.latest()
            if path is None:
                raise CheckpointError(f"no checkpoint found under {self.directory}")
        return trainer.restore_checkpoint(path)
