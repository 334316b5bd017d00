"""Checkpointing: per-leaf npz shards, async save, restore onto the
caller's device (the counterpart of ``repro.train.checkpoint``).

Layout (the reference's)::

    <dir>/step_000000123/
        meta.json            step, extra, leaf paths + shapes + dtypes
        leaves.npz           one entry per tree leaf (flattened key paths)
        DONE                 commit marker (atomic-rename protocol)

Fault-tolerance contract (tests/test_torch_train_infra.py, mirroring
tests/test_checkpoint.py):

* a crash mid-save never corrupts the latest checkpoint — saves go to a tmp
  dir and are renamed only after fsync (the DONE marker is written last);
* ``restore_latest`` skips uncommitted/corrupt directories;
* restore loads arrays host-side, one leaf at a time, and places them on
  the caller's device, each like-tree leaf's;
  ``restore_latest_into`` copies them into the caller's tensors instead
  (PyTorch's ``load_state_dict`` idiom: no second copy of the state on the
  card). The reference's re-sharding onto a mesh is out of scope with the
  sharding modules (README);
* async mode runs the serialisation off-thread, overlapping I/O with the
  next training steps (device→host copy is synchronous, disk write is not).
  A save waits for the one in flight before it copies, so the host holds
  one copy of the state at a time; a write that failed raises at the next
  ``save``, ``wait`` or restore.

A bf16 leaf is stored as its uint16 bit patterns (numpy has no bf16) and
``meta.json`` names its dtype; it comes back bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_paths(v, f"{prefix}/{i}"))
        return out
    return [(prefix, tree)]


def _unflatten_like(tree, values: Dict[str, Any], prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], values, f"{prefix}/{k}")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_unflatten_like(v, values, f"{prefix}/{i}")
                 for i, v in enumerate(tree)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return values[prefix]


def _to_host(v) -> Tuple[np.ndarray, str]:
    """A leaf → (numpy array, dtype name); bf16 as its uint16 bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.asarray(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()                           # one in-flight save at a time
        # device→host copy happens synchronously (consistent snapshot)…
        host, dtypes = {}, {}
        for k, v in _flatten_with_paths(tree):
            host[k], dtypes[k] = _to_host(v)
        meta = {"step": step, "extra": extra or {},
                "leaves": {k: [list(v.shape), dtypes[k]]
                           for k, v in host.items()}}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_off_thread, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def wait(self) -> None:
        """Join the save in flight; raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_off_thread(self, step, host, meta) -> None:
        try:
            self._write(step, host, meta)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, np.ndarray], meta) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "leaves.npz"),
                 **{k.replace("/", "|"): v for k, v in host.items()})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(p, "DONE")):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _latest(self):
        """(step, meta, the open npz) of the newest committed checkpoint,
        or None. Waits for a save in flight first, so that a restore sees
        the newest save."""
        self.wait()
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return step, meta, np.load(os.path.join(d, "leaves.npz"))

    def restore_latest(self, like_tree) -> Optional[Tuple[int, Any, Dict]]:
        """Restore the newest committed checkpoint into the structure of
        ``like_tree``: each leaf a new tensor on the device of the
        like-tree's leaf (CPU for a leaf that is no tensor). None if there
        is no committed checkpoint."""
        got = self._latest()
        if got is None:
            return None
        step, meta, data = got
        values = {}
        with data:
            for path, like in _flatten_with_paths(like_tree):
                t = _from_host(data[path.replace("/", "|")],
                               meta["leaves"][path][1])
                values[path] = t.to(like.device if isinstance(
                    like, torch.Tensor) else "cpu")
        return step, _unflatten_like(like_tree, values), meta.get("extra", {})

    @torch.no_grad()
    def restore_latest_into(self, tree) -> Optional[Tuple[int, Any, Dict]]:
        """Copy the newest committed checkpoint into ``tree``'s tensors, one
        leaf at a time (the state is never held twice on the device).
        Returns (step, tree, extra), or None if there is none."""
        got = self._latest()
        if got is None:
            return None
        step, meta, data = got
        with data:
            for path, leaf in _flatten_with_paths(tree):
                src = _from_host(data[path.replace("/", "|")],
                                 meta["leaves"][path][1])
                if tuple(src.shape) != tuple(leaf.shape) \
                        or src.dtype != leaf.dtype:
                    raise ValueError(f"checkpoint leaf {path}: "
                                     f"{tuple(src.shape)} {src.dtype} does "
                                     f"not fit {tuple(leaf.shape)} "
                                     f"{leaf.dtype}")
                leaf.copy_(src)
        return step, tree, meta.get("extra", {})
