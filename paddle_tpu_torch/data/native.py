"""The native record pipeline (ref: ``paddle_tpu/data/native.py``): record
files stream through C++ reader threads into a bounded ring, off the GIL,
and Python takes one record at a time through a C ABI.

The library is the repository's own ``csrc/dataio/dataio.cc``. At first
use the port compiles it with the host C++ compiler (``c++ -O2 -std=c++17
-shared -fPIC -pthread``) into ``paddle_tpu_torch/csrc/build/<hash of
the source and flags>/``, as it builds its kernels at first use; objects
go to a directory of the process's own and the library appears by an
atomic rename, so two processes building at once cannot mix their files.
No build system is needed, and the port never loads another build of the
source. If the compiler is missing or the build fails, :func:`available`
is False and :class:`NativeRecordReader` raises: there is no Python
reader behind it.

A record file is a sequence of ``(uint32 length, bytes)`` records;
:func:`numpy_records` packs a tuple of arrays into one record.
"""

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "csrc", "dataio", "dataio.cc")
BUILD_ROOT = os.path.join(_ROOT, "paddle_tpu_torch", "csrc", "build")
LIB_NAME = "libpaddle_tpu_torch_dataio.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB = None
_LOCK = threading.Lock()


def build_dir():
    """The build directory of the current source: a hash of the flags and
    of the source's bytes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, "dataio-" + h.hexdigest()[:16])


def build():
    """Compile the library if this build directory does not hold it yet;
    returns its path. Raises when there is no C++ compiler or the build
    fails."""
    out = build_dir()
    lib = os.path.join(out, LIB_NAME)
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++) on PATH: the native "
                           f"record reader is built from {SOURCE}")
    work = os.path.join(out, f"tmp{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    tmp = os.path.join(work, LIB_NAME)
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native record reader build failed "
                           f"({cxx} exited {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def available():
    """True when the library is built, or builds now."""
    try:
        _lib()
    except (OSError, RuntimeError):
        return False
    return True


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.ptdio_create.restype = ctypes.c_void_p
            lib.ptdio_create.argtypes = [ctypes.c_uint64]
            lib.ptdio_add_file.restype = ctypes.c_int
            lib.ptdio_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ptdio_start.restype = ctypes.c_int
            lib.ptdio_start.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_uint64]
            lib.ptdio_next.restype = ctypes.c_int64
            lib.ptdio_next.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_uint64]
            lib.ptdio_destroy.restype = None
            lib.ptdio_destroy.argtypes = [ctypes.c_void_p]
            lib.ptdio_write_records.restype = ctypes.c_int
            lib.ptdio_write_records.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
            _LIB = lib
    return _LIB


def write_record_file(path, records):
    """Write a list of bytes objects as a record file (ref:
    ``native.py:67``)."""
    lib = _lib()
    blob = b"".join(records)
    lens = (ctypes.c_uint64 * len(records))(*[len(r) for r in records])
    buf = (ctypes.c_uint8 * max(len(blob), 1)).from_buffer_copy(
        blob or b"\0")
    if lib.ptdio_write_records(os.fsencode(path), buf, lens,
                               len(records)) != 0:
        raise IOError(f"cannot write {path}")


class NativeRecordReader:
    """Records of ``files`` through ``num_threads`` C++ reader threads and
    a ring of ``capacity`` records, ``epochs`` passes over the files (ref:
    ``native.py:78``); ``shuffle_seed`` seeds the threads' file order as
    the library does. Iterate it for bytes; :meth:`close` stops the
    threads and frees the ring."""

    def __init__(self, files, num_threads=2, epochs=1, capacity=1024,
                 shuffle_seed=0, max_record_bytes=1 << 22):
        lib = _lib()
        self._lib = lib
        self._h = lib.ptdio_create(capacity)
        for f in files:
            if lib.ptdio_add_file(self._h, os.fsencode(f)) != 0:
                lib.ptdio_destroy(self._h)
                self._h = None
                raise IOError(f"cannot open {f}")
        if lib.ptdio_start(self._h, num_threads, epochs, shuffle_seed) != 0:
            lib.ptdio_destroy(self._h)
            self._h = None
            raise RuntimeError("ptdio_start failed (no files?)")
        self._buf = (ctypes.c_uint8 * max_record_bytes)()
        self._cap = max_record_bytes

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        n = self._lib.ptdio_next(self._h, self._buf, self._cap)
        if n == -2:
            raise StopIteration
        if n < 0:
            raise IOError("native reader error (record too large or bad "
                          "file)")
        return ctypes.string_at(self._buf, n)

    def close(self):
        if self._h is not None:
            self._lib.ptdio_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def numpy_records(arrays):
    """A tuple of arrays packed into one record (``np.savez``; ref:
    ``native.py:123``)."""
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    return buf.getvalue()


def unpack_numpy_record(rec):
    """The tuple of arrays of one :func:`numpy_records` record (ref:
    ``native.py:131``)."""
    with np.load(io.BytesIO(rec)) as z:
        return tuple(z[k] for k in z.files)
