"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every kernel of the port is a ``csrc/<name>.cu`` file with a plain C
interface.  :func:`load` compiles it at first use into a shared library
under ``build/torch_kernels/`` at the root of the checkout (a directory
``.gitignore`` lists) and loads it with ``ctypes``.  The library's file
name carries a hash of the source and the compiler flags, so an edited
source builds anew and an unchanged one is loaded as it is.  The build
uses only the sources in this package and the CUDA toolkit's headers.

:func:`build` starts one ``nvcc`` per source, all at once, and waits for
all of them; ``chip_smoke.py`` calls it before it touches a kernel.

Nothing here runs at import time: the CPU tests import every module of
the port on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["NVCC_FLAGS", "build_dir", "build", "load"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_CSRC = Path(__file__).resolve().parent / "csrc"
_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    """``build/torch_kernels/`` at the root of the checkout."""
    return _CSRC.parents[1] / "build" / "torch_kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); "
            "the port's CUDA kernels build only where the CUDA toolkit "
            "is installed")
    return path


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns the
    library path of each name; raises with the compiler's output if a
    build fails."""
    targets = {name: _target(name) for name in names}
    pending = {}
    for name, lib in targets.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        pending[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (once per process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
