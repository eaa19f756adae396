"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``mhrec_tpu_torch/_build/``, then loaded with ``ctypes``. A library's file
name carries a digest of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded. Builds happen at first use, or
all at once and in parallel through :func:`build` (one ``nvcc`` process per
source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("hstu_stu_gated_fwd", "hstu_attn_fwd", "hstu_stu_gated_bwd", "hstu_attn_bwd",
           "row_adamw", "packed_attn_fwd", "packed_attn_bwd", "hstu_stu_f32",
           "packed_attn_bwd_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# where nvcc is looked for, in order: the PATH, then the toolkit's default home
NVCC_CANDIDATES = ("nvcc", "/usr/local/cuda/bin/nvcc")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in NVCC_CANDIDATES:
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from "
        f"{CSRC} on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build took
    (0.0 for a library already built). ``verbose`` adds ``-Xptxas -v`` and
    prints each kernel's registers and shared memory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", file=sys.stderr, flush=True)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def aligned16(t):
    """``t`` when its pointer and every stride above the last are 16-byte
    multiples, as the bfloat16 kernels' 16-byte ``cp.async`` copies need,
    else a contiguous copy (whose rows are, for the widths they take)."""
    ok = t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                        for s in t.stride()[:-1])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
