"""Small cross-cutting runtime helpers.

* ``advisory_wall_ms`` — the one sanctioned wall-clock read for the
  decision-path modules (``core/``).  Decisions run on the cost-model
  clock; wall time is advisory reporting only (corelint rule
  ``wall-clock-decision``).
* ``atomic_write_text`` / ``atomic_write_bytes`` — same-directory temp
  file + ``os.replace`` publish (corelint rule ``atomic-persistence``).
* ``resolve_device`` — the device check every tensor entry point runs:
  ``"cuda"`` without a card raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import os
import time

import torch


def advisory_wall_ms() -> float:
    """Milliseconds from a monotonic wall clock — ADVISORY ONLY: it may
    feed stats fields and log lines, never a scheduling or plan decision.
    Device work is asynchronous, so a caller timing device work
    synchronizes before reading it."""
    return time.perf_counter() * 1e3


def atomic_write_bytes(path, data: bytes) -> None:
    """Publish ``data`` at ``path`` atomically: write a same-directory temp
    file, then ``os.replace``.  Readers see the old or the new content,
    never a torn prefix; the pid in the temp name keeps two processes
    publishing the same path apart."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path, text: str, encoding: str = "utf-8") -> None:
    """``atomic_write_bytes`` for text content."""
    atomic_write_bytes(path, text.encode(encoding))


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is present.  Nothing falls back to the CPU silently: a CPU run asks
    for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
