"""Manifest-versioned, async checkpointing in the reference's layout.

Port of ``repro/train/checkpoint.py``. Layout:

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

A placed state (DTensors on a mesh, ``train/step.py``) is saved as its
logical (full) arrays: every rank gathers each leaf (so every rank calls
``save``), rank 0 writes, and ``wait`` ends in a barrier, so no rank
reads a directory before its commit. ``restore(like, shardings=)`` fills
a full ``like`` and places it by ``shardings``, which may be for another
mesh than the save's (``distributed/elastic.py``); a ``like`` already
placed is filled shard by shard.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.distributed.sharding import place
from repro_torch.distributed.spmd import full_tensor, is_dtensor
from repro_torch.utils.pytree import load_leaves, named_leaves, stack_leaves

#: how numpy stores a bfloat16 leaf without ml_dtypes (and with it, on disk)
BF16_RECORD = np.dtype("V2")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of the leaf (never a view: the caller goes on updating
    the state in place while the thread writes it)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def _placed(tree) -> bool:
    return any(is_dtensor(t) for _, t in named_leaves(tree))


@torch.no_grad()
def _write_leaf(dst: torch.Tensor, x: torch.Tensor) -> None:
    """``dst`` <- the full tensor ``x``; into a DTensor, its own shard."""
    if is_dtensor(dst):
        from torch.distributed.tensor import distribute_tensor

        x = distribute_tensor(x.to(dst.device), dst.device_mesh,
                              dst.placements, src_data_rank=None).to_local()
        dst = dst.to_local()
    dst.copy_(x)


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
        self._group = False     # a placed state was saved: wait() syncs

    # ----------------------------------------------------------- save
    def save(self, step: int, state: Any, *, blocking: bool = False,
             extra: dict | None = None):
        """Async by default: the device-to-host copy before returning, the
        file I/O in a thread. A placed state is gathered on every rank
        (all must call) and written by rank 0."""
        placed = _placed(state)
        host = stack_leaves(state, lambda t: _host(full_tensor(t)))
        self.wait()                 # one outstanding write at a time
        self._group = placed        # wait() then ends in a barrier

        def write():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # re-raised by the next wait()
                self._error = e

        if placed and dist.get_rank() != 0:
            pass                    # rank 0 writes the logical arrays
        elif blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        if blocking and placed:
            self.wait()

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
        if self._group:
            self._group = False
            dist.barrier()
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

    def restore(self, like: Any, *, step: int | None = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the tensors of ``like`` (in place, on their
        devices; ``utils/pytree.load_leaves``: the same leaves, each of the
        same shape and dtype); returns (like, step). With ``shardings``
        (a tree of ``NamedSharding`` as ``like``'s, possibly for another
        mesh than the save's) a full ``like`` is then placed by them and
        the placed state returned."""
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
                                             dtypes[p]), _write_leaf)
        if shardings is not None and not _placed(like):
            from repro_torch.train.step import TrainState, place_train_state

            like = (place_train_state(like, shardings)
                    if isinstance(like, TrainState) else
                    place(like, shardings))
        return like, step
