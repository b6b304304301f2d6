"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared library of its own with
a plain C interface, under ``_build/``, and is loaded with ``ctypes``. A library's file name carries
the hash of its source, so an edited source builds anew and a built one is reused. ``build_all``
starts one ``nvcc`` per source, all at once. Nothing builds when this module is imported: a
kernel's wrapper calls :func:`load` at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "check", "load", "stream"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = (
    "masked_attention", "masked_attention_bwd", "knn_topk", "infonce", "ring_attention",
    "topk_merge", "bucket_exchange", "expression_vm",
)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def _build(names: list[str]) -> dict[str, str]:
    """Compile ``names`` with one nvcc each, all started together; returns nvcc's output (with
    ptxas's register and shared-memory report) per source, and raises if one fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        target = _target(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, target))
    logs, failed = {}, []
    for name, proc, tmp, target in running:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: a concurrent loader sees the whole library or none
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    return logs


def build_all() -> dict[str, str]:
    """Compile every source not built yet, all in parallel (see ``_build``)."""
    return _build([name for name in SOURCES if not _target(name).exists()])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if it is not built yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                _build([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``, for a launcher's stream argument
    (PyTorch's own binding: no stream object is built for it)."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if device.index is None else device.index)
