"""Build the port's CUDA sources into shared libraries at first use.

Every kernel source under ops/csrc is a plain C ABI (no PyTorch headers),
compiled by nvcc for sm_90a into build/tidb_tpu_torch/ and loaded with
ctypes. A library is named by a hash of its source and flags, so an
edited kernel never loads a stale build; it is built under a temporary
name and renamed into place, so a build that is cut leaves nothing
half-written. `build_libraries` starts one nvcc per missing library, all
at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.utils import dispatch

__all__ = ["CSRC", "build_libraries", "load_library", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "..", "..", "build", "tidb_tpu_torch")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise ExecutionError("nvcc not found: the port's kernels build from "
                         "source on first use and need the CUDA toolkit")


def _so_path(src: str) -> str:
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(os.path.abspath(_BUILD_DIR), f"lib{stem}-{tag}.so")


def build_libraries(sources: List[str]) -> List[str]:
    """Build every source whose library is missing, one nvcc process per
    source, all running together. Returns the library paths in order."""
    paths = [_so_path(s) for s in sources]
    os.makedirs(os.path.abspath(_BUILD_DIR), exist_ok=True)
    running = []
    t0 = time.perf_counter()
    for src, so in zip(sources, paths):
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc_path(), *_NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {src}:\n{out}\n{err}")
        else:
            os.replace(tmp, so)
    if len(running) > len(failed):
        # the builds ran together: their wall time is the batch's
        dispatch.record_compile(time.perf_counter() - t0, len(running) - len(failed))
    if failed:
        raise ExecutionError("\n".join(failed))
    return paths


def load_library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (once per source version) and load csrc/<name>, once per
    process; `signatures` maps each C function to its argument types (each
    returns a CUDA error code, 0 for success)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (so,) = build_libraries([os.path.join(CSRC, name)])
            lib = ctypes.CDLL(so)
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
