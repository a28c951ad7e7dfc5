"""Provenance header for results of the port.

A result without its environment is unreproducible: the card (or the
CPU), its power limit, the torch and CUDA versions and the code revision
all change what a number means. ``provenance()`` captures them once, with
the reference's keys where they have a torch meaning and torch's own in
place of ``jax_version``.
"""
from __future__ import annotations

import datetime
import platform
import subprocess
from pathlib import Path

import torch

from repro_torch.obs.stats import STATS_VERSION

_ROOT = Path(__file__).resolve().parents[3]


def _run(cmd: list[str]) -> str | None:
    """First line of a command's output; None when it fails or is
    missing."""
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = p.stdout.strip().splitlines()
    return lines[0].strip() if p.returncode == 0 and lines else None


def provenance() -> dict:
    """Environment header: torch and CUDA versions, backend (``"cuda"``
    when a card is visible, else ``"cpu"``), device kind (the card's
    name) and count, UTC timestamp, git sha of the checkout (None outside
    git), stats schema version, host name; on the card also its power
    limit as ``nvidia-smi`` reports it. Values are JSON scalars."""
    on_card = torch.cuda.is_available()
    out = {
        "torch_version": str(torch.__version__),
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(0) if on_card
                        else platform.processor() or platform.machine()
                        or "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
                     .isoformat(timespec="seconds"),
        "git_sha": _run(["git", "-C", str(_ROOT), "rev-parse", "--short",
                         "HEAD"]),
        "stats_version": STATS_VERSION,
        "hostname": platform.node() or None,
    }
    if on_card:
        out["power_limit"] = _run(["nvidia-smi", "--query-gpu=power.limit",
                                   "--format=csv,noheader"])
    return out
