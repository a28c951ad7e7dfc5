"""Manifest-versioned, async checkpointing in the reference's layout.

Port of ``repro/train/checkpoint.py`` for one host. Layout:

    <dir>/step_<N>/      N zero-padded to 8 digits
        manifest.json    the step and, per leaf path, shape and dtype
        shard_0.npz      the leaves; keys are the paths with "|" for "/"
        COMMIT           written last; restore ignores directories
                         without it (crash-consistent)

Leaf paths are the reference's ``TrainState`` paths
(``params/segments/0/attn/wq/w``, ``opt/mu/...``, ``opt/nu/...``,
``opt/count``, ``step``), a segment's layers stacked ``[L, ...]``
(``utils/pytree.py``), so a float32 checkpoint written by either
package restores in the other.

bfloat16: numpy has no bfloat16 without ml_dtypes, which the port does
not use. A bf16 leaf is written as the 2-byte records (``|V2``) that
numpy writes for the reference's ml_dtypes bfloat16, its manifest dtype
``bfloat16``; on restore a ``|V2`` leaf is read by the manifest's dtype
as bf16 bits. So the port restores its own bf16 checkpoints and the
reference's, bit for bit (the reference's own restore cannot read a
``|V2`` leaf: ``astype`` finds no cast).

``save`` copies the state to the host before it returns (so the caller
may go on updating the state in place) and writes the files in a
thread, one outstanding write at a time; an error in that thread is
raised by the next ``save`` or ``wait``. ``keep`` newest committed
checkpoints are kept. ``restore`` writes into the tensors of ``like``
in place, each leaf of the file into one of the same shape and dtype,
and returns it with the step: a state of tens of GB gets no second copy
on the card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import load_leaves, stack_leaves

#: how numpy stores a bfloat16 leaf without ml_dtypes (and with it, on disk)
BF16_RECORD = np.dtype("V2")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of the leaf (never a view: the caller goes on updating
    the state in place while the thread writes it)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == BF16_RECORD else a.dtype.name


def _from_host(path: str, arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if dtype != "bfloat16" or arr.dtype.itemsize != 2:
            raise TypeError(f"{path}: {arr.dtype} records with manifest "
                            f"dtype {dtype}")
        return torch.from_numpy(
            np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------- save
    def save(self, step: int, state: Any, *, blocking: bool = False,
             extra: dict | None = None):
        """Async by default: the device-to-host copy before returning, the
        file I/O in a thread."""
        host = stack_leaves(state, _host)
        self.wait()                 # one outstanding write at a time

        def write():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # re-raised by the next wait()
                self._error = e

        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, host: dict, extra: dict):
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": _dtype_name(a)}
                       for k, a in host.items()},
            **extra,
        }
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{k.replace("/", "|"): a for k, a in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Wait for the outstanding write; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from error

    # -------------------------------------------------------- restore
    def committed_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(p, "COMMIT"))):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: int | None = None
                ) -> tuple[Any, int]:
        """Restore into the tensors of ``like`` (in place, on their
        devices; ``utils/pytree.load_leaves``: the same leaves, each of the
        same shape and dtype); returns (like, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {k: v["dtype"]
                      for k, v in json.load(f)["leaves"].items()}
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            load_leaves(like, (k.replace("|", "/") for k in data.files),
                        lambda p: _from_host(p, data[p.replace("/", "|")],
                                             dtypes[p]))
        return like, step
