"""The host-side native runtime: the mapping scheduler, and ctypes
bindings of the repository's C++ runtime (native/vstpu_runtime.cpp).

Port of the JAX package's ``native_runtime.py``:

- the task ids of the runtime's MapTask enum and ``scheduler_next_py``,
  both encoding the priority ladder of the reference's MapMaker::run
  (jni/MapMaker.cc:80-123); HandleBadPoints is not a task, it runs inside
  every tracking step. ``scheduler_next`` asks the C++ function;
- ``decode_image`` / ``image_size`` (PGM, PPM and PNG to 8-bit luma,
  bilinear resize) and ``FramePipeline`` (worker threads that decode ahead
  of the consumer, frames delivered in order);
- ``blob_write`` / ``blob_read``, the VSTPU1 binary checkpoint.

The library is compiled at first use from native/vstpu_runtime.cpp with
the flags of native/Makefile into this package's ``_build/`` (nothing is
written under native/), under a name that carries a hash of the source and
flags. Where it cannot be built or loaded, every binding raises
``NativeRuntimeUnavailable`` carrying the compiler's message, and callers
take their Python paths (utils/datasets reads frames with numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native",
                      "vstpu_runtime.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-fvisibility=hidden")
LD_FLAGS = ("-shared", "-lpng", "-lz", "-lpthread")

TASK_NONE = 0
TASK_BA_RECENT = 1
TASK_REFIND_NEWLY = 2
TASK_BA_ALL = 3
TASK_REFIND_FAILURES = 4
TASK_ADD_KEYFRAME = 6

TASK_NAMES = {
    TASK_NONE: "none", TASK_BA_RECENT: "ba_recent",
    TASK_REFIND_NEWLY: "refind_newly", TASK_BA_ALL: "ba_all",
    TASK_REFIND_FAILURES: "refind_failures",
    TASK_ADD_KEYFRAME: "add_keyframe",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


class NativeRuntimeUnavailable(RuntimeError):
    pass


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libvstpu_runtime_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, SOURCE, "-o", tmp,
           *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeRuntimeUnavailable(
                f"building the native runtime failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    c_int, c_u8p = ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)
    lib.vstpu_decode_image.argtypes = [ctypes.c_char_p, c_u8p, c_int, c_int]
    lib.vstpu_decode_image.restype = c_int
    lib.vstpu_image_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.vstpu_image_size.restype = c_int
    lib.vstpu_pipeline_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int, c_int, c_int]
    lib.vstpu_pipeline_create.restype = ctypes.c_void_p
    lib.vstpu_pipeline_next.argtypes = [ctypes.c_void_p, c_u8p]
    lib.vstpu_pipeline_next.restype = ctypes.c_int64
    lib.vstpu_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.vstpu_pipeline_destroy.restype = None
    lib.vstpu_scheduler_next.argtypes = [c_int] * 6
    lib.vstpu_scheduler_next.restype = c_int
    lib.vstpu_blob_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_uint64), c_int]
    lib.vstpu_blob_write.restype = c_int
    lib.vstpu_blob_read_index.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), c_int]
    lib.vstpu_blob_read_index.restype = c_int
    lib.vstpu_blob_read_section.argtypes = [
        ctypes.c_char_p, c_int, c_u8p, ctypes.c_uint64]
    lib.vstpu_blob_read_section.restype = c_int


def load() -> ctypes.CDLL:
    """The native library, built at first use; raises
    NativeRuntimeUnavailable (with the compiler's or loader's message)
    where that fails, and again on every later call."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise NativeRuntimeUnavailable(_load_error)
        try:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            _declare(lib)
        except Exception as e:  # noqa: BLE001 - any failure: unavailable
            _load_error = f"native runtime unavailable: {e}"
            raise NativeRuntimeUnavailable(_load_error) from e
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeRuntimeUnavailable:
        return False


def _u8_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_image(path: str, width: int, height: int) -> np.ndarray:
    """PGM, PPM or PNG to u8 luma [height, width] (bilinear resize)."""
    lib = load()
    out = np.empty((height, width), np.uint8)
    if lib.vstpu_decode_image(path.encode(), _u8_ptr(out), width,
                              height) != 0:
        raise IOError(f"native decode failed: {path}")
    return out


def image_size(path: str) -> tuple:
    """(width, height) of an image file."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vstpu_image_size(path.encode(), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
        raise IOError(f"native decode failed: {path}")
    return w.value, h.value


class FramePipeline:
    """Prefetching frame reader: worker threads decode and resize ahead of
    the consumer; frames are delivered strictly in order, as (index, u8
    [height, width]). A frame that does not decode is skipped."""

    def __init__(self, paths: Sequence[str], width: int, height: int,
                 n_workers: int = 2, capacity: int = 8):
        self._lib = load()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.vstpu_pipeline_create(
            arr, len(self._paths), width, height, n_workers, capacity)
        if not self._handle:
            raise NativeRuntimeUnavailable("pipeline_create failed")
        self._shape = (height, width)

    def __iter__(self):
        while True:
            out = np.empty(self._shape, np.uint8)
            idx = self._lib.vstpu_pipeline_next(self._handle, _u8_ptr(out))
            if idx == -1:
                return
            if idx == -2:
                continue
            yield int(idx), out

    def close(self) -> None:
        if self._handle:
            self._lib.vstpu_pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


def scheduler_next(queue_size: int, recent_converged: bool,
                   full_converged: bool, has_failure_queue: bool,
                   has_newly_made: bool, rand20: bool) -> int:
    """The C++ runtime's answer to scheduler_next_py's question."""
    lib = load()
    return lib.vstpu_scheduler_next(
        int(queue_size), int(recent_converged), int(full_converged),
        int(has_failure_queue), int(has_newly_made), int(rand20))


def scheduler_next_py(queue_size: int, recent_converged: bool,
                      full_converged: bool, has_failure_queue: bool,
                      has_newly_made: bool, rand20: bool) -> int:
    """The next task. Every bundle-adjustment and re-find rung needs an
    empty keyframe queue (MapMaker.cc:97, 102, 107, 112), so a queued
    keyframe goes first (:120-121); the failure-queue rung is reached only
    when both bundle adjustments have converged, one pass in 20 (:112)."""
    if queue_size > 0:
        return TASK_ADD_KEYFRAME
    if not recent_converged:
        return TASK_BA_RECENT
    if has_newly_made:
        return TASK_REFIND_NEWLY
    if not full_converged:
        return TASK_BA_ALL
    if rand20 and has_failure_queue:
        return TASK_REFIND_FAILURES
    return TASK_NONE


def blob_write(path: str, sections: Dict[str, np.ndarray]) -> None:
    """Writes named arrays, viewed as bytes, as a VSTPU1 checkpoint."""
    lib = load()
    names: List[bytes] = []
    bufs: List[np.ndarray] = []
    for k, v in sections.items():
        names.append(k.encode())
        bufs.append(np.ascontiguousarray(v).view(np.uint8).reshape(-1))
    n = len(names)
    name_arr = (ctypes.c_char_p * n)(*names)
    ptr_arr = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[_u8_ptr(b) for b in bufs])
    size_arr = (ctypes.c_uint64 * n)(*[b.nbytes for b in bufs])
    if lib.vstpu_blob_write(path.encode(), name_arr, ptr_arr, size_arr,
                            n) != 0:
        raise IOError(f"blob write failed: {path}")


def blob_read(path: str) -> Dict[str, np.ndarray]:
    """A VSTPU1 checkpoint as {name: u8 array} (the caller views them)."""
    lib = load()
    max_sections = 256
    names_buf = ctypes.create_string_buffer(max_sections * 128)
    sizes = (ctypes.c_uint64 * max_sections)()
    n = lib.vstpu_blob_read_index(path.encode(), names_buf, len(names_buf),
                                  sizes, max_sections)
    if n < 0:
        raise IOError(f"blob read failed: {path}")
    names: List[str] = []
    off, raw = 0, names_buf.raw
    for _ in range(n):
        end = raw.index(b"\0", off)
        names.append(raw[off:end].decode())
        off = end + 1
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        buf = np.empty(sizes[i], np.uint8)
        if lib.vstpu_blob_read_section(path.encode(), i, _u8_ptr(buf),
                                       buf.nbytes) != 0:
            raise IOError(f"blob section read failed: {path}:{name}")
        out[name] = buf
    return out
