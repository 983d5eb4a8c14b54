"""Build the CUDA kernels with ``nvcc`` into libraries ``ctypes`` loads.

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled at first
use into ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), under a name that carries a digest of the source, the
shared headers (``csrc/*.cuh``) and the compiler flags, so an edited source
or header rebuilds and an unchanged one loads the library it already has.
A failed build raises: nothing falls back to the plain versions.  The
libraries link ``libcuda`` (``-lcuda``) for ``cuTensorMapEncodeTiled``.
``on_device`` is the launch context the wrappers share.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    every header beside it, and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library path.  The compiler's resource report (``-Xptxas -v``) goes to
    ``<library>.log`` beside it."""
    return build_all([name])[name]


def build_all(names) -> dict:
    """``build`` for several sources, one ``nvcc`` each, all started
    together.  Returns {name: library path}; raises if any build fails."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log_text = proc.communicate()[0]
        out = todo[name]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu ({proc.returncode}):\n{log_text}")
            continue
        log = out.with_name(f"{out.name}.log.tmp.{os.getpid()}")
        log.write_text(log_text)
        os.replace(log, out.with_suffix(".log"))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


class on_device:
    """``with on_device(device) as stream:`` makes the CUDA ``device``
    current for a launch and gives the raw handle of its current stream (a
    Python int, as the C entries take it).  It switches devices only where
    ``device`` is not current already, and reads the handle without a
    ``torch.cuda.Stream`` object: at small shapes a launch's host calls
    cost as much as its kernels (with ``torch.cuda.device`` and
    ``current_stream`` a bf16 flash backward at (2, 256, 256, 4, 2, 16) took
    0.057-0.083 ms a call on an H100 host, without them 0.029-0.036)."""

    __slots__ = ("index", "prev")

    def __init__(self, device):
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.prev = None

    def __enter__(self) -> int:
        current = torch.cuda.current_device()
        if current != self.index:
            self.prev = current
            torch.cuda.set_device(self.index)
        return torch._C._cuda_getCurrentRawStream(self.index)

    def __exit__(self, *exc) -> None:
        if self.prev is not None:
            torch.cuda.set_device(self.prev)

