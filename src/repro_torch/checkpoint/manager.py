"""Atomic, async checkpointing of dict trees of tensors; the port of
``repro.checkpoint.manager``.

Layout, as the reference's: ``<dir>/step_<N>/`` holds ``arrays.npz`` (the
flattened tree, keys joined by ``/``) and ``meta.json``. Writes go to a
temporary directory and an atomic rename, so a save cut off midway never
corrupts the latest checkpoint, and the oldest ones beyond ``keep`` are
removed. ``save_async`` copies the tensors to the host on the caller's
thread and writes the files on a background thread.

numpy has no bfloat16: a bf16 tensor is stored as its ``uint16`` bit
view and ``meta.json`` records its dtype under ``dtypes``, so it comes
back bit for bit (a deliberate divergence from the reference's files,
which store ml_dtypes' bfloat16). Every other dtype is stored as numpy's
own. ``restore(template, step=, device=)`` rebuilds the template's
structure and places the tensors on ``device`` (default: each template
leaf's own); the on-disk format knows no device or topology, so a
checkpoint taken on the card restores on the CPU and back.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

SEP = "/"


def _flatten(tree) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(prefix + [f"#{i}"], v)
        else:
            flat[SEP.join(prefix)] = node

    rec([], tree)
    return flat


def _unflatten_into(template, flat: dict):
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(prefix + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(prefix + [f"#{i}"], v)
                              for i, v in enumerate(node))
        key = SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        return flat[key]

    return rec([], template)


def _to_host(tree) -> tuple:
    """(flat numpy arrays, {key: "bfloat16"} for the bf16 leaves stored as
    their uint16 bits): copies, so that the caller may update the tensors
    in place while a background thread writes them."""
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
            if t.dtype == torch.bfloat16:
                dtypes[k] = "bfloat16"
                t = t.view(torch.int16)
            v = t.to("cpu", copy=True).numpy()
            if k in dtypes:
                v = v.view(np.uint16)
        arrays[k] = np.asarray(v)
    return arrays, dtypes


def _from_host(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------- save --
    def _write(self, step: int, host: dict, dtypes: dict, meta: dict):
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            meta = dict(meta, step=step, time=time.time(), dtypes=dtypes)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def save(self, step: int, tree, meta: dict | None = None):
        self.wait()
        self._write(step, *_to_host(tree), meta or {})

    def save_async(self, step: int, tree, meta: dict | None = None):
        """The device->host copy happens here; file I/O on a background
        thread (an error there is raised by the next ``wait``)."""
        host, dtypes = _to_host(tree)
        self.wait()

        def run():
            try:
                self._write(step, host, dtypes, meta or {})
            except BaseException as e:     # surfaced by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                device=None) -> tuple:
        """Restore into the structure of ``template`` (a tree whose leaves
        are tensors, or anything else for a key that must exist). Each
        leaf becomes a tensor on ``device``, or on its template leaf's
        device where no device is given (the CPU for a non-tensor).
        Returns (tree, meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: _from_host(data[k], dtypes.get(k))
                    for k in data.files}
        tree = _unflatten_into(template, flat)

        def place(t, like):
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else "cpu")
            return t.to(dev)

        def walk(node, like):
            if isinstance(node, dict):
                return {k: walk(v, like[k]) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v, lk) for v, lk in zip(node, like))
            return place(node, like)
        return walk(tree, template), meta
