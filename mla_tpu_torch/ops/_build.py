"""Build the port's native code at first use and load it with ctypes.

Each ``mla_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface under ``build/mla_tpu_torch/`` at
the root of the checkout. The library's file name carries a hash of the
source and the flags, so an edited source never loads a stale build.
nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``<library>.log``.

The native HTTP front, ``native/serve_front.cpp``, compiles with ``g++``
the same way (``load_native``); with ``-march=native`` its hash also covers
the target that flag resolves to on this host.
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
NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-shared", "-pthread")

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


def _compile(cmd: Sequence[str], src: Path, lib: Path) -> None:
    """Run ``cmd`` + ``-o <tmp> src`` and rename the result to ``lib``; the
    compiler's report goes beside it as ``<lib>.log``. Raises with the
    compiler's output if it fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    lib.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def compile_library(src: Path, lib: Path, extra_flags: Sequence[str] = ()) -> None:
    """nvcc src -> lib with the port's flags (plus ``extra_flags``), the
    ptxas report beside it as ``<lib>.log``."""
    _compile([_nvcc(), *NVCC_FLAGS, *extra_flags], src, lib)


def native_library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds: the hash covers the source, the
    flags and the target ``-march=native`` resolves to here, so a library
    built on another host's CPU is never loaded."""
    src = NATIVE_DIR / f"{name}.cpp"
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + target.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load_native(name: str) -> ctypes.CDLL:
    """The library built from native/<name>.cpp, unedited, with ``g++`` and
    ``GXX_FLAGS``, compiling it first if needed. The caller declares the
    argument and result types."""
    lib = _LOADED.get(f"native/{name}")
    if lib is not None:
        return lib
    path = native_library_path(name)
    if not path.exists():
        _compile(["g++", *GXX_FLAGS], NATIVE_DIR / f"{name}.cpp", path)
    lib = _LOADED[f"native/{name}"] = ctypes.CDLL(str(path))
    return lib


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
