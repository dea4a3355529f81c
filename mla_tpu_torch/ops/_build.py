"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``mla_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface under ``build/mla_tpu_torch/`` at
the root of the checkout. The library's file name carries a hash of the
source and the flags, so an edited source never loads a stale build.
nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mla_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the port's kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def compile_library(src: Path, lib: Path, extra_flags: Sequence[str] = ()) -> None:
    """nvcc src -> lib with the port's flags (plus ``extra_flags``), the
    ptxas report beside it as ``<lib>.log``."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    lib.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiling it first if needed.
    ``signatures`` maps each C entry point to its argtypes: pointers and the
    stream as c_void_p (a bare int would be cut to 32 bits), ints as c_int;
    every entry point returns a cudaError_t as int."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        compile_library(CSRC / f"{name}.cu", library_path(name))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    _LOADED[name] = lib
    return lib
