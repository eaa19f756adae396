"""ctypes bindings for the native negative sampler (``mhrec_native.cpp``, a
copy of the JAX package's), built at first use.

``available()`` compiles the source with the system ``g++`` (``-O3
-fopenmp -shared -fPIC``) into ``mhrec_tpu_torch/_build/``, under a file
name that carries a digest of the source, and loads it. Where no ``g++`` is
found or the build fails it returns False and the sampler takes its numpy
path, as the JAX package does; the two paths draw the same distribution
from different random streams. Nothing is built when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "mhrec_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_state = {"lib": None, "tried": False}


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libmhrec_native-{h}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    path = _library_path()
    if not path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            logger.warning("g++ not found: the negative sampler runs its numpy path")
            return None
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            logger.warning("native sampler build failed, using the numpy path:\n%s",
                           proc.stderr[-2000:])
            return None
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    lib.sample_negatives_uniform.argtypes = [i64p, i64, i64, i64p, i64, i64, u64]
    lib.sample_negatives_pool.argtypes = [i64p, i64, i64, i64p, i64, i64p, i64, u64]
    lib.sample_negatives_weighted.argtypes = [i64p, i64, i64, i64p, i64, i64p, f64p, i64, u64]
    for fn in (lib.sample_negatives_uniform, lib.sample_negatives_pool,
               lib.sample_negatives_weighted):
        fn.restype = None
    return lib


def available() -> bool:
    """True once the library is built and loaded (building it at the first
    call)."""
    if not _state["tried"]:
        _state["tried"] = True
        _state["lib"] = _build_and_load()
    return _state["lib"] is not None


def _ptr(a, ctype=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sample_negatives_uniform(blacklist: np.ndarray, k: int, item_num: int,
                             seed: int) -> np.ndarray:
    B, Lb = blacklist.shape
    bl = np.ascontiguousarray(blacklist, dtype=np.int64)
    out = np.empty((B, k), dtype=np.int64)
    _state["lib"].sample_negatives_uniform(
        _ptr(out), B, k, _ptr(bl), Lb, item_num, seed & 0xFFFFFFFFFFFFFFFF)
    return out


def sample_negatives_pool(blacklist: np.ndarray, k: int, pool: np.ndarray,
                          seed: int) -> np.ndarray:
    B, Lb = blacklist.shape
    bl = np.ascontiguousarray(blacklist, dtype=np.int64)
    p = np.ascontiguousarray(pool, dtype=np.int64)
    out = np.empty((B, k), dtype=np.int64)
    _state["lib"].sample_negatives_pool(
        _ptr(out), B, k, _ptr(bl), Lb, _ptr(p), len(p), seed & 0xFFFFFFFFFFFFFFFF)
    return out


def sample_negatives_weighted(blacklist: np.ndarray, k: int, pool: np.ndarray,
                              cdf: np.ndarray, seed: int) -> np.ndarray:
    B, Lb = blacklist.shape
    bl = np.ascontiguousarray(blacklist, dtype=np.int64)
    p = np.ascontiguousarray(pool, dtype=np.int64)
    c = np.ascontiguousarray(cdf, dtype=np.float64)
    out = np.empty((B, k), dtype=np.int64)
    _state["lib"].sample_negatives_weighted(
        _ptr(out), B, k, _ptr(bl), Lb, _ptr(p), _ptr(c, ctypes.c_double),
        len(p), seed & 0xFFFFFFFFFFFFFFFF)
    return out
