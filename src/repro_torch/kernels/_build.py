"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its own
into a shared library under ``build/repro_torch_kernels/`` at the repository
root (ignored by git), named by a hash of its source, the shared headers of
``kernels/csrc/`` and the flags, so an edited source or header rebuilds and
an unchanged one is reused.  ``build()`` starts one
``nvcc`` per source, all at once, and waits for every one of them.  Nothing
here runs at import time: this module imports on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "flash_attention_fwd": _PKG / "flash_attention" / "csrc" / "flash_attention_fwd.cu",
    "rmsnorm": _PKG / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "ssd_chunk_fwd": _PKG / "ssd_chunk" / "csrc" / "ssd_chunk_fwd.cu",
}

#: headers the sources include (``#include "../../csrc/hopper.cuh"``)
HEADERS: tuple[Path, ...] = (_PKG / "csrc" / "hopper.cuh",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: the CUDA grid's limit in y and z
MAX_GRID_YZ = 65535

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
    data = src.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory / spill report) of the
    last build of ``name`` in this checkout, or '' when it was not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def spills(name: str) -> dict[str, tuple[int, int]]:
    """(spill store bytes, spill load bytes) of each kernel function in
    ``name``'s last build, by mangled name, from ptxas' report."""
    out = {}
    for fn, stores, loads in re.findall(
            r"Function properties for (\S+)\s*\n\s*\d+ bytes stack frame, (\d+) bytes spill "
            r"stores, (\d+) bytes spill loads", build_log(name)):
        out[fn] = (int(stores), int(loads))
    return out


def registers(name: str) -> dict[str, int]:
    """Registers a thread of each kernel function in ``name``'s last build
    uses, by mangled name, from ptxas' report."""
    return {fn: int(n) for fn, n in re.findall(
        r"Function properties for (\S+)\s*\n[^\n]*\n[^\n]*Used (\d+) registers", build_log(name))}


def demangle(fn: str) -> str:
    """A kernel function's C++ name (``cu++filt``), for reports."""
    tool = Path(nvcc_path()).with_name("cu++filt")
    if not tool.exists():
        return fn
    return subprocess.run([str(tool), fn], capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def sass(name: str) -> dict[str, str]:
    """The SASS of each kernel function in library ``name`` (``cuobjdump
    -sass`` of the built library), by mangled name."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


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


def check_operands(name: str, tensors, dtypes, ndim: int) -> None:
    """Raises unless every tensor is a contiguous ``ndim``-d CUDA tensor of
    one of ``dtypes`` and all lie on one device (the checks every conv
    wrapper makes before a launch)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"{name} launches on CUDA tensors only (CPU tensors take the "
            f"plain version); got devices {[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands on different devices: {[str(t.device) for t in tensors]}")
    if any(t.dtype not in dtypes for t in tensors):
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))} operands; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.dim() != ndim for t in tensors):
        raise ValueError(f"{name} takes {ndim}-d operands; got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def run(name: str, argtypes: list, device, *args) -> None:
    """Launch ``<name>_launch(*args, stream)`` of kernel library ``name`` on
    ``device``'s current stream (``argtypes`` without the trailing stream
    pointer); raises with CUDA's message if the launch was refused.  Kept
    lean (the raw stream, no device switch where the device is current):
    the shortest kernels (B6) take about as long on the card as a launch
    takes the host."""
    import torch

    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
