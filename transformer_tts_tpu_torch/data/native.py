"""The native mel reader (the port of transformer_tts_tpu/data/native.py:
``load_mel_batch``, :1-153).

``tts_data.cpp`` beside this file (the port's own copy of the JAX
package's ``native/tts_data.cpp``) is compiled with the host's ``c++`` at
its first use (``$CXX``, else ``c++``, else ``g++``) into
``build/tts_data/`` at the root of the checkout, under
a name that hashes the source, and bound with ctypes. A failed build
raises: nothing falls back to numpy for the whole loader. Per file, a
layout the reader does not take (a ragged or Fortran-order npy, a width
other than ``mel_dim``) comes back as length -1 or -2, and the dataset
reads that row through ``__getitem__``, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tts_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tts_data"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")

_lib = None
_lock = threading.Lock()
_buffers = threading.local()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtts_data_{digest[:16]}.so"


def build() -> Path:
    """Compile ``tts_data.cpp`` unless its library is there; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cxx = os.environ.get("CXX") or shutil.which("c++") or "g++"
    try:
        run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
    except OSError as err:
        raise RuntimeError(f"native mel reader: cannot run {cxx}: {err}")
    if run.returncode != 0:
        raise RuntimeError("native mel reader: the build of "
                           f"{SOURCE} failed:\n{run.stderr}")
    os.replace(tmp, path)     # a concurrent builder never sees half a file
    return path


def load_library() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.tts_load_mel_batch.restype = None
            lib.tts_load_mel_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, f32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, f32p, f32p,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            _lib = lib
    return _lib


def _fptr(arr: Optional[np.ndarray]):
    if arr is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _buffer(shape) -> np.ndarray:
    """This thread's reusable output buffer (the loader's threads each
    collate their batch, which copies the rows out, before their next
    call)."""
    buf = getattr(_buffers, "buf", None)
    if buf is None or buf.shape[1:] != shape[1:] or buf.shape[0] < shape[0]:
        buf = _buffers.buf = np.empty(shape, np.float32)
    return buf[:shape[0]]


def load_mel_batch(paths, max_len: int, mel_dim: int,
                   mean: Optional[np.ndarray] = None,
                   var: Optional[np.ndarray] = None,
                   n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """One native call: ``n_threads`` threads load and normalise
    ((x - mean) / sqrt(var) in fp32) each mel of ``paths`` into a (B,
    max_len, mel_dim) buffer, whose rows past a mel's frames are left
    as they were. Returns (that buffer, lengths (B,) int32);
    a length below 0 marks a file the reader does not take. The buffer is
    this thread's and is reused by its next call."""
    lib = load_library()
    mean_f = (np.ascontiguousarray(mean, np.float32).reshape(-1)
              if mean is not None else None)
    var_f = (np.ascontiguousarray(var, np.float32).reshape(-1)
             if var is not None else None)
    b = len(paths)
    out = _buffer((b, max_len, mel_dim))
    lengths = (ctypes.c_int * b)()
    c_paths = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in paths])
    lib.tts_load_mel_batch(c_paths, b, _fptr(out), max_len, mel_dim,
                           ctypes.c_float(0.0), _fptr(mean_f), _fptr(var_f),
                           n_threads, lengths, 0)
    return out, np.frombuffer(lengths, np.int32).copy()
