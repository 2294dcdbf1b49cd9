"""Async host file IO: the ctypes surface over ``csrc/aio.cpp``.

Copy of ``deepspeed_tpu/ops/aio/aio_handle.py`` for the PyTorch port: an
``AsyncIOHandle`` with pread/pwrite that return op ids at once and
``wait``/``wait_op`` that surface IO errors as ``OSError``, and
``PinnedBuffer``, a 4096-aligned host allocation seen as a numpy uint8
array (what O_DIRECT wants).  The library is built by ``g++`` at first
use (``ops/build.py::load_host_library``); a failed build raises.
``odirect_fallbacks()`` counts the chunks that ran buffered because the
filesystem refused O_DIRECT.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..build import load_host_library

ALIGN = 4096


def _lib():
    lib = load_host_library("aio")
    lib.ds_aio_new.restype = ctypes.c_void_p
    lib.ds_aio_new.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    lib.ds_aio_destroy.argtypes = [ctypes.c_void_p]
    lib.ds_aio_pread.restype = ctypes.c_int64
    lib.ds_aio_pread.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_char_p,
                                 ctypes.c_int64]
    lib.ds_aio_pwrite.restype = ctypes.c_int64
    lib.ds_aio_pwrite.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_char_p,
                                  ctypes.c_int64, ctypes.c_int]
    lib.ds_aio_wait.argtypes = [ctypes.c_void_p]
    lib.ds_aio_wait_op.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ds_aio_pending.argtypes = [ctypes.c_void_p]
    lib.ds_aio_alloc_pinned.restype = ctypes.c_void_p
    lib.ds_aio_alloc_pinned.argtypes = [ctypes.c_int64]
    lib.ds_aio_free_pinned.argtypes = [ctypes.c_void_p]
    lib.ds_aio_odirect_fallbacks.restype = ctypes.c_int64
    lib.ds_aio_odirect_fallbacks.argtypes = []
    return lib


def aio_available() -> bool:
    try:
        _lib()
        return True
    except RuntimeError:
        return False


def odirect_fallbacks() -> int:
    """Chunks, since the library was loaded, that were O_DIRECT-eligible
    but ran buffered because the filesystem refused O_DIRECT."""
    return int(_lib().ds_aio_odirect_fallbacks())


def round_up(n: int, align: int = ALIGN) -> int:
    return (n + align - 1) // align * align


class PinnedBuffer:
    """A 4096-aligned host allocation exposed as a numpy uint8 array.

    Alignment makes the buffer O_DIRECT-eligible end to end (reference
    new_cpu_locked_tensor, `deepspeed_pin_tensor.cpp`). ``view(dtype,
    shape)`` reinterprets a prefix without copying.
    """

    def __init__(self, nbytes: int):
        self._lib = _lib()
        self.nbytes = round_up(int(nbytes))
        self._ptr = self._lib.ds_aio_alloc_pinned(self.nbytes)
        if not self._ptr:
            raise MemoryError(f"pinned alloc of {self.nbytes} bytes failed")
        self.array = np.ctypeslib.as_array(
            ctypes.cast(self._ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(self.nbytes,))

    def view(self, dtype, shape) -> np.ndarray:
        """Reinterpret a prefix without copying. The view aliases the
        pinned allocation directly — it is valid only while this
        PinnedBuffer object stays referenced (free() runs on __del__)."""
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if n > self.nbytes:
            raise ValueError(f"view of {n} bytes exceeds buffer "
                             f"({self.nbytes})")
        return self.array[:n].view(dtype).reshape(shape)

    def free(self) -> None:
        if self._ptr:
            self._lib.ds_aio_free_pinned(self._ptr)
            self._ptr = None
            self.array = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


class AsyncIOHandle:
    """Thread-pool async pread/pwrite handle (reference ``aio_handle``).

    ``pread``/``pwrite`` return op ids immediately; ``wait()`` blocks for
    everything in flight, ``wait_op(id)`` for one op. IO errors surface as
    OSError at wait time — never silently.
    """

    def __init__(self, block_size: int = 8 << 20, queue_depth: int = 0,
                 num_threads: int = 0, use_odirect: bool = True):
        del queue_depth  # thread pool depth == num_threads here
        if num_threads <= 0:
            num_threads = min(4, os.cpu_count() or 1)
        self._lib = _lib()
        self._h = self._lib.ds_aio_new(num_threads, block_size,
                                       int(use_odirect))
        self.num_threads = num_threads
        self.block_size = block_size

    @staticmethod
    def _buf_ptr(arr: np.ndarray):
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("aio buffers must be C-contiguous")
        return arr.ctypes.data_as(ctypes.c_void_p)

    def pread(self, buffer: np.ndarray, path: str,
              file_offset: int = 0) -> int:
        return self._lib.ds_aio_pread(
            self._h, self._buf_ptr(buffer), buffer.nbytes,
            os.fspath(path).encode(), file_offset)

    def pwrite(self, buffer: np.ndarray, path: str, file_offset: int = 0,
               fsync: bool = False) -> int:
        return self._lib.ds_aio_pwrite(
            self._h, self._buf_ptr(buffer), buffer.nbytes,
            os.fspath(path).encode(), file_offset, int(fsync))

    # reference-compatible names
    def async_pread(self, buffer, path, offset: int = 0) -> int:
        return self.pread(buffer, path, offset)

    def async_pwrite(self, buffer, path, offset: int = 0) -> int:
        return self.pwrite(buffer, path, offset)

    def sync_pread(self, buffer, path, offset: int = 0) -> None:
        self.wait_op(self.pread(buffer, path, offset))

    def sync_pwrite(self, buffer, path, offset: int = 0) -> None:
        self.wait_op(self.pwrite(buffer, path, offset))

    def wait(self) -> None:
        rc = self._lib.ds_aio_wait(self._h)
        if rc < 0:
            raise OSError(-rc, f"aio: {os.strerror(-rc)}")

    def wait_op(self, op_id: int) -> None:
        rc = self._lib.ds_aio_wait_op(self._h, op_id)
        if rc < 0:
            raise OSError(-rc, f"aio: {os.strerror(-rc)}")

    def pending(self) -> int:
        return self._lib.ds_aio_pending(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self.wait()
            self._lib.ds_aio_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ds_aio_destroy(self._h)
                self._h = None
        except Exception:
            pass
