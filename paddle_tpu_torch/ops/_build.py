"""Build the CUDA sources under ops/csrc with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The library is built at
first use into `<checkout>/build/kernels/`, named by the hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.
A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -lcuda: the driver's cuTensorMapEncodeTiled, which makes the TMA maps
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lcuda")

_lock = threading.Lock()
_loaded: dict = {}
# nvcc's output for each source built by this process
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _build(name: str, target: Path) -> None:
    """Run nvcc on csrc/<name>.cu into `target`; raise if it fails. nvcc's
    output (ptxas's register and spill report) is kept in BUILD_LOG."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {out.returncode}):\n{out.stdout}")
    os.replace(tmp, target)
    BUILD_LOG[name] = out.stdout


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target = _lib_path(name)
            if not target.exists():
                _build(name, target)
            lib = ctypes.CDLL(str(target))
            _loaded[name] = lib
        return lib
