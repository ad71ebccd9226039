"""The native mesh segmentator (``segmentator.cpp``, host C++), built at
first use and called through ctypes: the port's copy of
``gapro_tpu/native/segmentator.py``.

Replaces ``segmentator.segment_mesh``
(ISBNet/dataset/scannetv2/prepare_superpoint.py:9-16). The library is
built with ``g++ -O3 -shared -fPIC`` into ``gapro_tpu_torch/_build/``,
never beside the source, and rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "segmentator.cpp"
LIB = BUILD_DIR / "libsegmentator.so"

_lib = None


def build() -> Path:
    """Compile ``segmentator.cpp`` into ``LIB`` if it is missing or older
    than the source (written to a temporary name, then moved into place)."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return LIB
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found to build the mesh segmentator")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, str(SRC)],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {SRC.name} failed:\n{e.stdout}{e.stderr}") from e
    os.replace(tmp, LIB)
    return LIB


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.segment_mesh.restype = ctypes.c_int32
        lib.segment_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def segment_mesh(vertices, faces, kthr: float = 0.01, seg_min: int = 20):
    """Felzenszwalb-style mesh segmentation -> per-vertex superpoint ids.

    vertices [N, 3] float, faces [M, 3] int vertex indices; ``kthr`` the FH
    threshold constant, ``seg_min`` the minimum segment size. Returns [N]
    int32 compact segment labels.
    """
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    out = np.empty(len(v), np.int32)
    n = lib.segment_mesh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        ctypes.c_float(kthr), ctypes.c_int32(seg_min),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n < 0:
        raise RuntimeError("segment_mesh failed")
    return out
