"""Fault-tolerant checkpointing of the port: async, atomic.

Counterpart of the JAX package's ``checkpoint/checkpointer.py``, in a
format of the port's own.  Layout: ``<dir>/step_<N>/`` with one ``.npy``
file per leaf (the leaf's "/"-joined path, "/" written as "."),
``manifest.json`` (paths, step) and a ``DONE`` marker.  The
device-to-host copy happens when ``save`` is called; the files are
written on a background thread into a temp dir that is renamed into place
and then marked ``DONE``, so a crash mid-write leaves a step that
``restore_latest`` ignores.  Old steps past ``keep`` are removed.

As the reference does, leaves that numpy cannot hold (bf16) are widened to
fp32 on disk and cast back on restore into the ``like`` tree's dtype: the
round trip is exact.  One ``.npy`` a leaf (the reference writes one
``.npz`` a host) lets a restore read each leaf by itself, and a
checkpoint of stablelm-3b's training state (params and fp32 moments,
33.5 GB on disk) is written without zip's CRC pass.  The port reads and
writes only its own directories.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import DeviceLike

MANIFEST = "manifest.json"
DONE = "DONE"


def _file(path: str) -> str:
    return path.replace("/", ".") + ".npy"


def _host(leaf) -> np.ndarray:
    """A copy of a leaf as a numpy array on the host, bf16 widened to fp32
    (a copy even for a CPU tensor: the training step updates its leaves in
    place while the write runs)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Async by default: the device-to-host copy happens now; the
        files are written on a background thread."""
        self.wait()
        flat = T.flatten(tree)
        paths = [p for p, _ in flat]
        host = [_host(leaf) for _, leaf in flat]

        def _write():
            try:
                tmp = self.dir / f".tmp_step_{step}"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for p, arr in zip(paths, host):
                    np.save(tmp / _file(p), arr)
                (tmp / MANIFEST).write_text(json.dumps({
                    "step": step, "paths": paths, "time": time.time()}))
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                (final / DONE).touch()
                self._gc()
            except Exception as e:            # reported by wait()
                self._error = e

        t = threading.Thread(target=_write, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self):
        """Wait for the pending write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / DONE).exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                device: DeviceLike = None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors, meta
        tensors among them), each leaf in its ``like`` leaf's dtype, on
        ``device`` or else on the ``like`` leaf's device."""
        final = self.dir / f"step_{step}"
        out = []
        for p, leaf in T.flatten(like):
            arr = np.load(final / _file(p))
            if not isinstance(leaf, torch.Tensor):
                out.append(arr)
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint step {step}: {p} has shape "
                                 f"{arr.shape}, {tuple(leaf.shape)} expected")
            dev = torch.device(device) if device is not None else leaf.device
            if dev.type == "meta":
                raise ValueError(f"checkpoint step {step}: {p} is a meta "
                                 "tensor; name the device to restore onto")
            out.append(torch.from_numpy(arr).to(dev).to(leaf.dtype))
        return T.unflatten(like, iter(out))

    def restore_latest(self, like: Any, device: DeviceLike = None
                       ) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device)
