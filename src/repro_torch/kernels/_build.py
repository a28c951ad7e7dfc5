"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` on its own into ``lib<name>-<hash>.so`` for ``sm_90a``, then
loaded with ``ctypes``; the hash covers the source and the flags, so an
edited kernel is rebuilt and a current one is reused. Sources are built
at first use, or all together (one ``nvcc`` per source, started at once)
through ``build``. A failed build raises with the compiler's output.

The libraries go to ``build/kernels`` at the root of the checkout
(``.gitignore`` lists ``build/``), or to ``$REPRO_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "REPRO_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[3] / "build" / "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> tuple[Path, Path]:
    """(source, shared library) of kernel ``name``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns the compiler output of
    each source built (``-Xptxas -v``: registers, shared memory, spills)."""
    procs = []
    try:
        for name in names:
            src, lib = library_path(name)
            if lib.exists():
                continue
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, lib, tmp, proc in procs:
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, lib)
    finally:
        for _, _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)[1]))
            _loaded[name] = lib
        return lib
