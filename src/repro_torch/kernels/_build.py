"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its own
into a shared library under ``build/repro_torch_kernels/`` at the repository
root (ignored by git), named by a hash of its source and flags so an edited
source rebuilds and an unchanged one is reused.  ``build()`` starts one
``nvcc`` per source, all at once, and waits for every one of them.  Nothing
here runs at import time: this module imports on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"

#: kernel library name -> CUDA source
SOURCES: dict[str, Path] = {
    "conv2d_tile": _PKG / "conv2d_tiled" / "csrc" / "conv2d_tile.cu",
    "conv2d_dgrad_tile": _PKG / "conv2d_tiled" / "csrc" / "conv2d_dgrad_tile.cu",
    "conv2d_wgrad_tile": _PKG / "conv2d_tiled" / "csrc" / "conv2d_wgrad_tile.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Loaded libraries, one per process: a CDLL cannot be unloaded, so a second
# load of the same library would only hand back the same handle.
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
        "is installed (CPU tensors take the plain torch versions instead)"
    )


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory / spill report) of the
    last build of ``name`` in this checkout, or '' when it was not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=None) -> dict[str, Path]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` process per source, all started together.  Raises with nvcc's
    output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            output, _ = proc.communicate()
            todo[n].with_suffix(".log").write_text(output)
            if proc.returncode != 0:
                failed.append(f"{n} (exit {proc.returncode}):\n{output}")
                continue
            os.replace(tmp, todo[n])     # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
