"""ctypes bindings for the native (C++) mesh-preprocessing runtime.

Counterpart of cbtr_tpu/native/__init__.py, over the port's own copy of its
source (cbtr_native.cpp here, byte for byte the JAX package's).  The library
is built with g++ at the first call, never at import, with the JAX loader's
flags, so the two libraries compute the same bits.  It lands in the ignored
build directory of the CUDA kernels (`ops.cuda_lib.BUILD_DIR`), compiled
under a name of its own and moved into place, so processes that build at
once each load a whole library.  `available()` gates callers; the NumPy
implementation in mesh/core.py remains the behavioural oracle and fallback,
and `build_error()` says why a build failed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda_lib import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cbtr_native.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libcbtr_native.so")
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> None:
    """Compile SOURCE where LIB_PATH is missing or older than it: to a name
    of this process and thread, then `os.replace` into place."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            _build()
        except subprocess.CalledProcessError as e:
            _build_error = e.stderr or str(e)
            return None
        except OSError as e:        # no g++ on PATH, an unwritable build directory
            _build_error = str(e)
            return None
        lib = ctypes.CDLL(LIB_PATH)
        lib.cbtr_preprocess.restype = ctypes.c_int
        lib.cbtr_preprocess.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.cbtr_weld.restype = ctypes.c_int
        lib.cbtr_weld.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built (at the first call) and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the build failed (g++'s error output), None if it did not fail
    or has not been tried."""
    return _build_error


def preprocess(tris: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full native pipeline: weld + orient + topology + vertex-average normals.

    tris [F,3,3] float32 -> (tris, fellow [F,3] i32, fellow_starts [F,3] i32,
    corner_avg_normals [F,3,3] f32) — exactly the device-array set
    TriMesh.device_arrays() produces.  An open mesh raises ValueError.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    tris = np.ascontiguousarray(tris, np.float32).copy()
    F = tris.shape[0]
    fellow = np.empty((F, 3), np.int32)
    starts = np.empty((F, 3), np.int32)
    avg = np.empty((F, 3, 3), np.float32)
    err = ctypes.create_string_buffer(256)
    rc = lib.cbtr_preprocess(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), F,
        fellow.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        avg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        err, 256,
    )
    if rc != 0:
        raise ValueError(err.value.decode())
    return tris, fellow, starts, avg


def weld(tris: np.ndarray) -> np.ndarray:
    """Vertex welding alone: tris [F,3,3] float32 with every corner within
    the weld epsilon moved onto one representative."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    tris = np.ascontiguousarray(tris, np.float32).copy()
    rc = lib.cbtr_weld(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), tris.shape[0]
    )
    if rc != 0:
        raise RuntimeError("cbtr_weld failed")
    return tris
