"""Build the hand-written CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on first
use, never at import, by ``nvcc`` for ``sm_90a`` into
``gapro_tpu_torch/_build/lib<name>.so``. A library is rebuilt when its
source, or a header of ``csrc/`` (``*.cuh``), is newer than the shared
object. ``build_all`` starts one ``nvcc``
per source at once, so a cold start costs the slowest build, not the sum.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("subm_conv", "subm_conv_bf16", "subm_conv_dw", "fps", "dyco")

# fps.cu must round every multiply and add on its own, as the plain version
# and the JAX package do: a contracted FMA flips near-tied argmaxes.
_EXTRA_FLAGS = {"fps": ["-fmad=false"]}

_loaded: dict = {}
build_logs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or "
                       "CUDA_HOME)")


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _target(name)
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return not so.exists() or so.stat().st_mtime < newest


def _start(name: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *_EXTRA_FLAGS.get(name, []), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, _target(name))  # atomic: a concurrent loader never sees half a file


def build_all(names=SOURCES) -> None:
    """Compile every stale library in ``names``, all nvcc runs in parallel."""
    started = [(n, *_start(n)) for n in names if _stale(n)]
    errors = []
    for name, proc, tmp in started:
        try:
            _finish(name, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch_counts() -> dict:
    """Each kernel wrapper's count of its launches in this process."""
    from .models import dyco
    from .ops import fps
    from .sparse import conv

    return {"subm_conv": conv.subm_conv_cuda.launches,
            "subm_conv_bf16": conv.subm_conv_bf16_cuda.launches,
            "subm_conv_dfeats": conv.subm_conv_dfeats_cuda.launches,
            "subm_conv_dw": conv.subm_conv_dw_cuda.launches, "fps": fps.fps_cuda.launches,
            "dyco": dyco.dyco_cuda.launches}
