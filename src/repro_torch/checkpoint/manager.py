"""Fault-tolerant checkpointing of the port, on the JAX package's design
and on-disk layout (``repro.checkpoint.manager``), so that a later step
can restore across the two packages.

* **Atomic and durable**: writes go to ``step_<N>.tmp/`` — contents
  fsynced, tmp dir fsynced — then renamed into place with a parent-dir
  fsync: a crash at any point leaves either the previous complete
  checkpoint or the new complete one.  Auto-restore (``latest_step``)
  skips partial or corrupt checkpoint dirs with a warning; restoring an
  explicit step stays strict.
* **Async**: the device→host copy runs in ``save``; serialisation runs on
  a writer thread with a bounded queue of 1, so the train loop blocks
  only if a previous save is still in flight.
* **Layout**: ``arrays.npz`` keyed by tree path ('/' stored as \\x1f) and
  ``manifest.json`` (step, time, process index, array count, the dtype
  name of every array npz cannot hold natively, and ``extra`` — the data
  cursor).  bfloat16 is stored as its raw bytes (uint8, last axis ×2),
  as the JAX package stores it.
* **Retention**: keep the last ``KEEP`` checkpoints.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.common.dtypes import torch_dtype
from repro_torch.common.pytree import flatten_with_paths, map_with_paths

PREFIX = "step_"
KEEP = 3


def _ckpt_dirs(root: str) -> list[tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith(PREFIX) and not name.endswith(".tmp"):
            try:
                out.append((int(name[len(PREFIX):]), os.path.join(root, name)))
            except ValueError:
                continue
    return sorted(out)


def _is_complete(path: str) -> bool:
    """The manifest parses and names a step, and the array archive is a
    readable zip; anything else is a crash artifact."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return "step" in manifest and zipfile.is_zipfile(
            os.path.join(path, "arrays.npz"))
    except (OSError, ValueError):
        return False


def latest_step(root: str) -> Optional[int]:
    """Newest complete checkpoint step (partial or corrupt dirs are
    skipped with a warning), or None."""
    for step, path in reversed(_ckpt_dirs(root)):
        if _is_complete(path):
            return step
        warnings.warn(f"skipping incomplete/corrupt checkpoint {path} "
                      f"(crash artifact?)", stacklevel=2)
    return None


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_numpy(x) -> tuple[np.ndarray, Optional[str]]:
    """(host array, dtype name if npz cannot hold it natively)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x), None
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy(), "bfloat16"
    return t.numpy(), None


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch_dtype(dtype_name)) if dtype_name else t


class CheckpointManager:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: dict, *, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` (tensors on any device) at ``step``;
        ``extra`` is JSON-serialisable metadata (the data cursor)."""
        if self._err:
            raise RuntimeError("checkpoint writer died") from self._err[0]
        # the device→host copy happens here, so the writer thread owns
        # host snapshots that later steps cannot change
        flat, dtypes = {}, {}
        for path, leaf in flatten_with_paths(tree):
            flat[path], name = _to_numpy(leaf)
            if name:
                dtypes[path] = name
        job = (step, flat, dtypes, dict(extra or {}))
        if not block:
            self._q.put(job)          # blocks only if a save is in flight
        else:
            # a queued save may target the same step: drain it first, two
            # writers on one step_<N>.tmp would tear each other
            self._q.join()
            self._write(*job)

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._write(*job)
            except BaseException as e:   # surfaced on the next save()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, flat: dict, dtypes: dict,
               extra: dict) -> None:
        final = os.path.join(self.root, f"{PREFIX}{step}")
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        packed = {k.replace("/", "\x1f"): v for k, v in flat.items()}
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **packed)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "time": time.time(), "process_index": 0,
                    "n_arrays": len(flat), "dtypes": dtypes, "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)         # atomic publish
        _fsync_path(self.root)
        self._gc()

    def _gc(self):
        for _, path in _ckpt_dirs(self.root)[:-KEEP]:
            shutil.rmtree(path, ignore_errors=True)

    def wait(self):
        """Drain pending async saves (call before exit)."""
        self._q.join()
        if self._err:
            raise RuntimeError("checkpoint writer died") from self._err[0]

    def close(self):
        """Drain pending saves and stop the writer thread."""
        self.wait()
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, *,
                template: Optional[dict] = None):
        """Load a checkpoint (the latest complete one by default) →
        (tree, extra), or (None, None) if there is none.  Without
        ``template`` the tree is {path: tensor} on the CPU; with it, the
        arrays take the template's structure, dtypes, devices and
        ``requires_grad`` (paths must match)."""
        step = latest_step(self.root) if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.root, f"{PREFIX}{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k.replace("\x1f", "/"): _from_numpy(data[k], dtypes.get(
                k.replace("\x1f", "/"))) for k in data.files}
        if template is None:
            return flat, manifest["extra"]

        def fill(p, leaf):
            arr = flat[p]
            if isinstance(leaf, torch.Tensor):
                arr = arr.to(device=leaf.device, dtype=leaf.dtype)
                arr.requires_grad_(leaf.requires_grad)
            return arr

        return map_with_paths(fill, template), manifest["extra"]
