"""Build and load the port's native keyspace module.

``native.c`` is a copy of ``pathway_tpu/native/native.c`` whose module is named
``_pathway_torch_native``: BLAKE2b and splitmix key hashing (``hash_rows``, ``hash_rows2``,
``hash_scalars``, ``hash_scalars2``, ``mix_cols2``), the key table behind ``engine/slotmap.py`` and
the key registry of ``engine/keys.py``. It compiles with the host C compiler (``$CC``, else
``gcc``) and the reference's flags at first use, into ``pathway_tpu_torch/_build/``, under a file
name that carries the source's SHA-256 and the interpreter's extension suffix, so an edited source
builds anew and a built one is reused. Processes that build at once take a file lock, and each
writes a temporary file that ``os.replace`` puts in place whole. Nothing builds when this module is
imported.

Where the reference's loader (``pathway_tpu/native/__init__.py``) returns ``None`` when the build
fails and its engine hashes in Python, this one raises ``RuntimeError`` with the compiler's
output: the port's engine has no other path.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType

__all__ = ["build", "load"]

MODULE = "_pathway_torch_native"
_SRC = Path(__file__).resolve().parent / "native.c"
_BUILD = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_module: ModuleType | None = None


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD / f"{MODULE}-{digest}{suffix}"


def _compile(target: Path) -> str:
    """Compile ``native.c`` into ``target``; returns the compiler's output, raises with it if the
    compiler cannot run or fails."""
    cc = os.environ.get("CC") or "gcc"
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [cc, "-O3", "-shared", "-fPIC", "-std=c11",
           f"-I{sysconfig.get_paths()['include']}", str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native module did not build: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native module did not build: {' '.join(cmd)} exited "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees the whole library or none
    return proc.stdout + proc.stderr


def build() -> str | None:
    """Compile ``native.c`` if it is not built yet; returns the compiler's output, or None when
    the library was built before."""
    target = _target()
    if target.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / f"{MODULE}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # one build among processes that start at once
        return None if target.exists() else _compile(target)


def load() -> ModuleType:
    """The loaded native module, built first if it is not built yet."""
    global _module
    if _module is not None:
        return _module
    with _lock:
        if _module is None:
            build()
            spec = importlib.util.spec_from_file_location(MODULE, _target())
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _module = module
    return _module
