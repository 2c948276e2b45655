"""Fault-tolerant checkpointing.

Port of ``src/repro/checkpoint/manager.py``, with its on-disk layout:
- step-atomic: the leaves go to ``<dir>/tmp.<step>/arr_XXXXX.npy`` (in
  the order of ``tree.leaves``), then ``manifest.json`` (each leaf's path,
  shape and dtype) last, then the directory is renamed to
  ``ckpt_XXXXXXXX``, so a crash mid-write never leaves a complete-looking
  checkpoint;
- ``restore`` scans newest → oldest and skips damaged directories;
- ``keep_last`` prunes the oldest;
- ``save_async`` snapshots the tree to host memory before its writer
  thread starts, so training may go on changing the tensors.
A bf16 leaf is stored as its 16-bit patterns (int16) (numpy has no bf16),
its manifest dtype "bfloat16".  ``restore`` reads every leaf of a
checkpoint before it returns any, and puts each on its template leaf's
device and dtype (an ``nn.Module`` in the template takes the values into
its parameters in place).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().copy(), "bfloat16"
    a = t.cpu().numpy().copy()
    return a, str(a.dtype)


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    return [(path, *_host(t)) for path, t in tree_lib.items(tree)]


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree) -> str:
        return self._write(step, _snapshot(tree))

    def save_async(self, step: int, tree) -> None:
        self.wait()
        host = _snapshot(tree)                      # snapshot before thread
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host) -> str:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"ckpt_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, dtype) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
            manifest["leaves"].append({"path": path,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)                 # manifest last = complete
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        return final

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None):
        """template: a tree with the target structure.  Returns (tree,
        step): the newest checkpoint that reads whole (or ``step``)."""
        steps = self.all_steps()
        candidates = list(reversed(steps)) if step is None else [step]
        last_err: Exception | None = None
        for s in candidates:
            try:
                return self._read(template, s), s
            except Exception as e:          # corrupt → try older
                last_err = e
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.dir}: {last_err}")

    def _read(self, template, step: int):
        d = os.path.join(self.dir, f"ckpt_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as fh:
            manifest = json.load(fh)
        flat_t = tree_lib.leaves(template)
        if len(flat_t) != len(manifest["leaves"]):
            raise ValueError("checkpoint/template structure mismatch")
        values = []
        for i, (leaf, meta) in enumerate(zip(flat_t, manifest["leaves"])):
            arr = np.load(os.path.join(d, f"arr_{i:05d}.npy"))
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(
                    f"shape mismatch at {meta['path']}: "
                    f"{arr.shape} vs {tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            values.append(t)
        return tree_lib.unflatten(template, values)
