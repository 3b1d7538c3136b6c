"""Build a CUDA source of ``pose3d_tpu_torch/csrc`` into a shared library
and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` compiles ``csrc/<name>.cu`` (a plain C interface, no
PyTorch headers, so a build takes seconds) into
``build/pose3d_tpu_torch/lib<name>-<hash>.so`` at the repository root,
where the hash covers the source, the headers beside it (``csrc/*.cuh``,
which a source includes by name) and the flags. The library is built at
first use in a process, written under a temporary name and renamed into
place, so concurrent builders never load a half-written file. Each source
has its own lock, so several sources build in parallel threads.
:func:`load_library` also declares the entry point's C signature (ctypes
would otherwise pass a pointer as a 32-bit int). Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "pose3d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when reused), "log": nvcc's stderr}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "pose3d_tpu_torch are compiled at first use and need the toolkit"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    when no library of the same source and flags exists. Raises with
    nvcc's output when the build fails."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if out.is_file():
            build_info[name] = {"seconds": 0.0, "log": "(reused " + out.name + ")"}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                                       dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {name}:\n"
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": proc.stdout + proc.stderr}
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def load_library(name: str, argtypes: Sequence) -> ctypes.CDLL:
    """:func:`load` plus the C signature of the library's entry point
    ``pose3d_<name>`` (``argtypes``, returning the CUDA error code of the
    launch) and of ``pose3d_cuda_error_string``; idempotent."""
    lib = load(name)
    fn = getattr(lib, "pose3d_" + name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.pose3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pose3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_if_failed(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise for a launch that CUDA refused (``rc`` is what the entry
    point returned: ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib.pose3d_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
