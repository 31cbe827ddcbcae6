"""Build and load the CUDA kernels of ``fqss_tpu_torch/csrc`` at first use.

``nvcc`` compiles each source into an object file, all sources at once in
parallel processes, and links them into one shared library with a plain C
interface under ``fqss_tpu_torch/build/`` (listed in ``.gitignore``), named
by a hash of the sources and flags so that an edited source is rebuilt. The library is
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
SOURCES = tuple(_PKG / "csrc" / name for name in ("fake_quant.cu", "int8_matmul.cu", "lstm.cu", "lstm_static.cu",
                                                              "attention.cu", "qat_dense.cu"))
# included by the sources; part of the library's hash
HEADERS = tuple(_PKG / "csrc" / name for name in ("fake_quant.cuh", "tf32_mma.cuh", "lstm.cuh"))
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _library_path(sources: tuple[Path, ...], stem: str) -> Path:
    h = hashlib.sha256()
    for src in (*sources, *HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise naming the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build(sources: tuple[Path, ...] = SOURCES, stem: str = "libfqss_kernels") -> BuildResult:
    """Compile the sources unless a library for them exists. ``sources`` may replace one of ``SOURCES`` with
    another version of it (``scripts/bench_qat_dense.py`` builds an earlier kernel beside the current one); the
    headers are always ``csrc``'s."""
    path = _library_path(sources, stem)
    if path.exists():
        return BuildResult(path, compiled=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    include = ("-I", str(_PKG / "csrc"))
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, *include, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)])
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return BuildResult(path, compiled=True, seconds=seconds, log=log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        _lib = load(build().path)
    return _lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
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
    lib.fqss_weight_group_fake_quant.argtypes = [p, p, i64, i64, p, p, p, p, i32, p]
    lib.fqss_weight_group_fake_quant.restype = i32
    lib.fqss_weight_group_fake_quant_bwd.argtypes = [p, p, i64, p, p, p, p, p, p, p, p, p]
    lib.fqss_weight_group_fake_quant_bwd.restype = i32
    lib.fqss_int8_matmul_requant.argtypes = [p, p, p, p, i32, f32, f32, f32, f32, f32, f32, f32, i64, p, i64,
                                             i64, i64, i32, p]
    lib.fqss_int8_matmul_requant.restype = i32
    lib.fqss_int8_matmul_blocks_per_sm.argtypes = [i64, i64, ctypes.POINTER(i32)]
    lib.fqss_int8_matmul_blocks_per_sm.restype = i32
    lib.fqss_lstm_max_hidden.argtypes = []
    lib.fqss_lstm_max_hidden.restype = i32
    lib.fqss_lstm_recurrence.argtypes = [p, p, p, p, p, p, i32, i64, i64, i64, p]
    lib.fqss_lstm_recurrence.restype = i32
    lib.fqss_lstm_cluster.argtypes = [p, p, p, p, p, p, i32, i64, i64, i64, i32, i32, p]
    lib.fqss_lstm_cluster.restype = i32
    lib.fqss_lstm_cluster_max_active.argtypes = [i64, i32, i32, i32, ctypes.POINTER(i32)]
    lib.fqss_lstm_cluster_max_active.restype = i32
    lib.fqss_lstm_observe.argtypes = [ctypes.POINTER(i64), i32, i64, i64, i64, i32, i32, p]
    lib.fqss_lstm_observe.restype = i32
    lib.fqss_lstm_static.argtypes = [ctypes.POINTER(i64), i32, i64, i64, i64, i32, i32, i32, p]
    lib.fqss_lstm_static.restype = i32
    lib.fqss_lstm_static_max_active.argtypes = [i64, i32, i32, ctypes.POINTER(i32)]
    lib.fqss_lstm_static_max_active.restype = i32
    lib.fqss_attention_max_dim.argtypes = []
    lib.fqss_attention_max_dim.restype = i32
    lib.fqss_attention.argtypes = [p, p, p, p, p, p, ctypes.POINTER(i64), i32, i32, p]
    lib.fqss_attention.restype = i32
    lib.fqss_attention_bf16.argtypes = lib.fqss_attention.argtypes
    lib.fqss_attention_bf16.restype = i32
    lib.fqss_qat_dense_tiles.argtypes = [i64, i64, p]
    lib.fqss_qat_dense_tiles.restype = None
    lib.fqss_qat_dense_dwq_splits.argtypes = [i64, i64, i64]
    lib.fqss_qat_dense_dwq_splits.restype = i32
    lib.fqss_qat_dense.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i64, i64, i64, i32, i32, p]
    lib.fqss_qat_dense.restype = i32
    lib.fqss_qat_dense_bf16.argtypes = lib.fqss_qat_dense.argtypes
    lib.fqss_qat_dense_bf16.restype = i32
    for name in ("fqss_qat_dense_gelu", "fqss_qat_dense_bf16_gelu"):  # absent from older sources a bench loads
        if hasattr(lib, name):
            getattr(lib, name).argtypes = lib.fqss_qat_dense.argtypes
            getattr(lib, name).restype = i32
    lib.fqss_qat_dense_bwd_mask.argtypes = [p, p, p, p, p, p, p, p, p, p, f32, p, p, p, p, p, p, i64, i64, i64,
                                            i32, i32, p]
    lib.fqss_qat_dense_bwd_mask.restype = i32
    if hasattr(lib, "fqss_qat_dense_bwd_mask_gelu"):  # absent from older sources a bench loads
        lib.fqss_qat_dense_bwd_mask_gelu.argtypes = lib.fqss_qat_dense_bwd_mask.argtypes
        lib.fqss_qat_dense_bwd_mask_gelu.restype = i32
    lib.fqss_qat_dense_dx_splits.argtypes = [i64, i64, i64]
    lib.fqss_qat_dense_dx_splits.restype = i32
    lib.fqss_qat_dense_dx.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
    lib.fqss_qat_dense_dx.restype = i32
    lib.fqss_qat_dense_dwq.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
    lib.fqss_qat_dense_dwq.restype = i32
    lib.fqss_qmatmul.argtypes = [p, p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, i32, i32, p]
    lib.fqss_qmatmul.restype = i32
    lib.fqss_qmatmul_bf16.argtypes = lib.fqss_qmatmul.argtypes
    lib.fqss_qmatmul_bf16.restype = i32
    return lib
