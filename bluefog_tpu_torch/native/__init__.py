"""Native (C++) host runtime of the port, loaded via ctypes.

Port of ``bluefog_tpu/native/``: the two C++ sources are copied
unchanged, since they touch no framework tensor:

* ``bf_native.cc`` — the Chrome-tracing timeline writer (lock-free SPSC
  ring + writer thread, the reference's common/timeline.{h,cc} design),
  behind ``BLUEFOG_TIMELINE_NATIVE`` (:mod:`bluefog_tpu_torch.timeline`);
* ``bf_data.cc`` — the batch-gather data engine (worker threads filling
  a ring of pre-allocated host batch buffers, delivered in order), the
  native pipeline of :class:`bluefog_tpu_torch.data.DataLoader`.

The shared library is built with ``g++ -std=c++17 -O2 -shared -fPIC
-lpthread`` at first use into ``build/torch_native/`` at the root of the
checkout (a directory ``.gitignore`` lists), under a file name keyed by
a hash of the sources and the flags, as ``cuda_build.py`` keys the
kernels: an edited source builds anew, an unchanged one loads as it is.
Each process compiles to a temporary name of its own and renames it into
place, so ``bfrun`` ranks that build at once never see half a file.

Nothing is built at import time.  :func:`available` is False when the
build or the load fails (no compiler); callers that asked for the native
path explicitly raise with :func:`build_error` instead of falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["available", "build_error", "library_path",
           "NativeTimelineWriter", "NativeBatchPipeline"]

_HERE = Path(__file__).resolve().parent
_SRCS = (_HERE / "bf_native.cc", _HERE / "bf_data.cc")
CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def build_dir() -> Path:
    """``build/torch_native/`` at the root of the checkout."""
    return _HERE.parents[1] / "build" / "torch_native"


def library_path() -> Path:
    """The library's path: its name carries a hash of the sources, the
    compiler and its flags."""
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _SRCS)
        + " ".join((CXX,) + CXX_FLAGS).encode())
    return build_dir() / f"libbf_native-{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile into ``lib``; the compiler's complaint, or None."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary name: concurrent ranks (bfrun) may build at
    # once and must not clobber each other's output mid-write
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), *map(str, _SRCS), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120,
                       text=True)
        os.replace(tmp, lib)
        return None
    except subprocess.CalledProcessError as exc:
        return exc.stderr or f"{CXX} exit {exc.returncode}"
    except (OSError, subprocess.SubprocessError) as exc:
        return str(exc)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def _bind(lib: ctypes.CDLL) -> None:
    lib.bf_timeline_open.restype = ctypes.c_void_p
    lib.bf_timeline_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bf_timeline_record.restype = None
    lib.bf_timeline_record.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char]
    lib.bf_timeline_dropped.restype = ctypes.c_longlong
    lib.bf_timeline_dropped.argtypes = [ctypes.c_void_p]
    lib.bf_timeline_close.restype = None
    lib.bf_timeline_close.argtypes = [ctypes.c_void_p]
    lib.bfdata_create.restype = ctypes.c_void_p
    lib.bfdata_create.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int]
    lib.bfdata_start_epoch.restype = None
    lib.bfdata_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.bfdata_num_batches.restype = ctypes.c_longlong
    lib.bfdata_num_batches.argtypes = [ctypes.c_void_p]
    lib.bfdata_next.restype = ctypes.c_longlong
    lib.bfdata_next.argtypes = [ctypes.c_void_p]
    lib.bfdata_release.restype = None
    lib.bfdata_release.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.bfdata_slot_ptr.restype = ctypes.c_void_p
    lib.bfdata_slot_ptr.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    lib.bfdata_slot_count.restype = ctypes.c_longlong
    lib.bfdata_slot_count.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.bfdata_destroy.restype = None
    lib.bfdata_destroy.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (with
    :func:`build_error` set) when the build or the load fails.  A failure
    is remembered: the process does not retry."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        lib = library_path()
        if not lib.exists():
            _error = _build(lib)
            if _error is not None:
                from bluefog_tpu_torch.logging_util import get_logger

                get_logger().warning(
                    "native library build failed; callers that allow it "
                    "fall back to Python implementations. Compiler "
                    "output:\n%s", _error)
                return None
        try:
            handle = ctypes.CDLL(str(lib))
        except OSError as exc:
            _error = f"cannot load {lib}: {exc}"
            return None
        _bind(handle)
        _lib = handle
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None while it builds and loads)."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


class NativeTimelineWriter:
    """ctypes facade over the C++ TimelineWriter.  Single-producer: callers
    must serialize record calls (the tracer fans out under its lock)."""

    def __init__(self, path: str, rank: int):
        self._lib = _require()
        self._dropped_at_close = 0
        self._handle = self._lib.bf_timeline_open(path.encode(), rank)
        if not self._handle:
            raise OSError(f"cannot open timeline file {path}")

    def record(self, name: str, tid: str, phase: str):
        self._lib.bf_timeline_record(
            self._handle, name.encode(), tid.encode(), phase.encode())

    def dropped(self) -> int:
        if not self._handle:
            return self._dropped_at_close
        return int(self._lib.bf_timeline_dropped(self._handle))

    def close(self):
        if self._handle:
            self._dropped_at_close = int(
                self._lib.bf_timeline_dropped(self._handle))
            self._lib.bf_timeline_close(self._handle)
            self._handle = None


class NativeBatchPipeline:
    """ctypes facade over the C++ DataPipeline (bf_data.cc): multi-threaded
    gather of scattered records into a depth-deep ring of contiguous batch
    buffers, delivered strictly in order.

    ``fields`` are C-contiguous numpy arrays sharing a leading sample dim;
    this class holds references to them for the pipeline's lifetime.
    Buffers returned by ``next()`` are views into ring slots — valid only
    until ``release(slot)``.
    """

    def __init__(self, fields, batch_size: int, depth: int = 3,
                 workers: int = 2):
        import numpy as np

        self._lib = _require()
        self._fields = [np.ascontiguousarray(f) for f in fields]
        n = self._fields[0].shape[0]
        for f in self._fields:
            if f.shape[0] != n:
                raise ValueError("all fields need the same sample count")
        self._batch = int(batch_size)
        self._item_shapes = [f.shape[1:] for f in self._fields]
        self._dtypes = [f.dtype for f in self._fields]
        item_bytes = [int(f.nbytes // max(n, 1)) for f in self._fields]
        ptrs = (ctypes.c_void_p * len(fields))(
            *[f.ctypes.data_as(ctypes.c_void_p).value for f in self._fields])
        bts = (ctypes.c_int64 * len(fields))(*item_bytes)
        self._handle = self._lib.bfdata_create(
            len(fields), ptrs, bts, n, self._batch, depth, workers)
        if not self._handle:
            raise RuntimeError("bfdata_create failed")

    def start_epoch(self, order) -> int:
        """Install this epoch's sample-index order; returns batch count."""
        import numpy as np

        order = np.ascontiguousarray(order, dtype=np.int64)
        self._lib.bfdata_start_epoch(
            self._handle, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(order))
        return int(self._lib.bfdata_num_batches(self._handle))

    def next(self):
        """Blocking: (slot, [field views]) or None at epoch end."""
        import numpy as np

        slot = int(self._lib.bfdata_next(self._handle))
        if slot < 0:
            return None
        count = int(self._lib.bfdata_slot_count(self._handle, slot))
        views = []
        for f, (shape, dtype) in enumerate(
                zip(self._item_shapes, self._dtypes)):
            ptr = self._lib.bfdata_slot_ptr(self._handle, slot, f)
            nbytes = (count * int(np.prod(shape, dtype=np.int64))
                      * dtype.itemsize)
            raw = (ctypes.c_uint8 * nbytes).from_address(ptr)
            views.append(np.frombuffer(raw, dtype=dtype).reshape(
                (count,) + tuple(shape)))
        return slot, views

    def release(self, slot: int):
        self._lib.bfdata_release(self._handle, slot)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.bfdata_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
