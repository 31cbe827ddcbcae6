"""Build and load the CUDA kernels of ``fqss_tpu_torch/csrc`` at first use.

``nvcc`` compiles the sources into a shared library with a plain C interface
under ``fqss_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash of
the sources and flags so that an edited source is rebuilt. The library is
loaded with ``ctypes``; nothing here includes PyTorch's headers, so a build
takes seconds. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "fake_quant.cu",)
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    compiled: bool  # False: the library for these sources was already built
    seconds: float = 0.0
    log: str = ""  # nvcc's output, with ptxas's register and spill report


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfqss_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile the sources unless a library for them exists."""
    path = _library_path()
    if path.exists():
        return BuildResult(path, compiled=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return BuildResult(path, compiled=True, seconds=seconds, log=log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.fqss_act_fake_quant.argtypes = [p, p, p, p, i64, i32, p]
        lib.fqss_act_fake_quant.restype = i32
        lib.fqss_weight_fake_quant.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
        lib.fqss_weight_fake_quant.restype = i32
        lib.fqss_act_bwd_blocks.argtypes = [i64]
        lib.fqss_act_bwd_blocks.restype = i32
        lib.fqss_act_fake_quant_bwd.argtypes = [p, p, p, p, p, p, p, i64, i32, f32, p]
        lib.fqss_act_fake_quant_bwd.restype = i32
        lib.fqss_weight_fake_quant_bwd.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i32, f32, p]
        lib.fqss_weight_fake_quant_bwd.restype = i32
        _lib = lib
    return _lib
