"""ctypes bindings of the native host decoder (counterpart of
``pose3d_tpu/data/native.py``).

``decode_jpeg_batch`` / ``decode_png_gray_batch`` decode, resize and store
a whole list of encoded blobs in one GIL-free C call with an internal
thread pool; ``read_chunk_members`` inflates a chunk archive (tar /
tar.gz) into memory in one native pass.

The library is built at first use in a process from the checkout's
sources, ``native/posedec.cc`` and ``native/chunkio.cc``, with ``g++ -O3
-fPIC -std=c++17 -shared ... -ljpeg -lpng -lz -lpthread`` (no
``-march=native``, so the library runs on any x86-64 host), into
``build/native/libposedec-<hash>.so`` at the repository root; the hash
covers the sources and the flags, so a changed source is rebuilt. The
prebuilt ``native/libposedec.so`` of the repository is never loaded.

When the build fails (no ``g++``, or no libjpeg / libpng headers) the
error names what is missing (a missing header is found by the
preprocessor alone, without compiling), and decoding falls back to
OpenCV where it is installed (imported inside the function), as the JAX
package does; with neither, decoding raises. Archive reads fall back to
Python's ``tarfile``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("pose3d_tpu_torch.data")

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "posedec.cc", ROOT / "native" / "chunkio.cc")
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

_lock = threading.Lock()
# the loaded library, or the reason it could not be built (one attempt a
# process)
_state: dict = {}


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libposedec-{h.hexdigest()[:16]}.so"


def _failure(cmd, log: str) -> RuntimeError:
    """The error of a failed ``cmd``, naming the headers and libraries its
    output says are missing."""
    headers = sorted(set(re.findall(
        r"fatal error: ([\w./+-]+): No such file", log)))
    libs = sorted(set(re.findall(r"cannot find (-l\w+)", log)))
    missing = ", ".join(
        ([f"headers {' '.join(headers)}"] if headers else [])
        + ([f"libraries {' '.join(libs)}"] if libs else []))
    return RuntimeError(
        f"g++ could not build the native decoder"
        f"{' (missing ' + missing + ')' if missing else ''}: "
        f"{' '.join(cmd)}\n{log[-2000:]}")


def _build(out: Path) -> None:
    """Compile the sources into ``out`` (written under a temporary name and
    renamed into place); raises RuntimeError naming what is missing. The
    preprocessor runs over the sources first, which takes a fraction of a
    second: a missing header is named without compiling anything (the
    compile took seconds, in every process, on a host without libjpeg's
    headers)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pre = [cxx, "-std=c++17", "-E", *map(str, SOURCES)]
    proc = subprocess.run(pre, stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE, text=True)
    if proc.returncode != 0:
        raise _failure(pre, proc.stderr)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *map(str, SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise _failure(cmd, proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    for name, out_t in (("pd_decode_jpeg_batch", ctypes.c_float),
                        ("pd_decode_png_gray_batch", ctypes.c_float),
                        ("pd_decode_jpeg_batch_u8", ctypes.c_uint8),
                        ("pd_decode_png_gray_batch_u8", ctypes.c_uint8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(out_t), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
    lib.pd_chunk_open.restype = ctypes.c_void_p
    lib.pd_chunk_open.argtypes = [ctypes.c_char_p]
    lib.pd_chunk_count.restype = ctypes.c_int64
    lib.pd_chunk_count.argtypes = [ctypes.c_void_p]
    lib.pd_chunk_name.restype = ctypes.c_char_p
    lib.pd_chunk_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pd_chunk_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.pd_chunk_data.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.pd_chunk_close.restype = None
    lib.pd_chunk_close.argtypes = [ctypes.c_void_p]
    lib.pd_chunk_error.restype = ctypes.c_char_p
    lib.pd_chunk_error.argtypes = []


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on the first call of the process when no
    library of the same sources exists; None (with the reason in
    :func:`build_error`) when it cannot be built."""
    with _lock:
        if not _state:
            out = library_path()
            try:
                if not out.is_file():
                    _build(out)
                lib = ctypes.CDLL(str(out))
                _declare(lib)
                _state["lib"] = lib
                logger.info("Loaded native decoder %s", out)
            except (RuntimeError, OSError) as e:
                _state["error"] = str(e)
                logger.warning("Native decoder unavailable: %s", e)
        return _state.get("lib")


def build_error() -> Optional[str]:
    """Why the native library is unavailable, or None."""
    get_lib()
    return _state.get("error")


def native_available() -> bool:
    return get_lib() is not None


def decode_route() -> str:
    """The route :func:`decode_jpeg_batch` takes in this process:
    ``"native"`` or ``"cv2"``; raises when there is none."""
    if native_available():
        return "native"
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "no JPEG/PNG decoder: the native library is unavailable "
            f"({build_error()}) and cv2 is not installed") from None
    return "cv2"


def _batch_call(fn_name: str, blobs: Sequence[bytes], out_hw, channels: int,
                num_threads: int, out_dtype):
    lib = get_lib()
    n = len(blobs)
    h, w = out_hw
    out = np.zeros((n, h, w, channels), out_dtype)
    flags = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_int64 * n)(*[len(b) for b in blobs])
    out_ctype = ctypes.c_uint8 if out_dtype == np.uint8 else ctypes.c_float
    ok = getattr(lib, fn_name)(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(sizes, ctypes.POINTER(ctypes.c_int64)),
        n, h, w,
        out.ctypes.data_as(ctypes.POINTER(out_ctype)),
        num_threads,
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if ok != n:
        logger.warning("%s: %d/%d blobs decoded", fn_name, ok, n)
    return out, flags.astype(bool)


def _cv2_decode(blobs, out_hw, gray: bool, dtype):
    """The JAX package's cv2 fallback, one blob after another (cv2 spreads
    each resize over the cores itself; a pool of Python threads on top
    measured no faster on the card's host, PERF.md)."""
    import cv2

    h, w = out_hw
    c = 1 if gray else 3
    out = np.zeros((len(blobs), h, w, c), dtype)
    flags = np.zeros((len(blobs),), bool)
    for i, b in enumerate(blobs):
        buf = np.frombuffer(b, np.uint8)
        img = cv2.imdecode(
            buf, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
        )
        if img is None:
            continue
        if not gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        if dtype == np.uint8:
            out[i] = img.reshape(h, w, c)
        else:
            out[i] = (img.astype(np.float32) / 255.0).reshape(h, w, c)
        flags[i] = True
    return out, flags


def _decode(kind: str, blobs, out_hw, num_threads: int, dtype):
    u8 = np.dtype(dtype) == np.uint8
    gray = kind == "png_gray"
    if decode_route() == "native":
        return _batch_call(f"pd_decode_{kind}_batch{'_u8' if u8 else ''}",
                           blobs, out_hw, 1 if gray else 3, num_threads,
                           np.uint8 if u8 else np.float32)
    return _cv2_decode(blobs, out_hw, gray, np.uint8 if u8 else np.float32)


def decode_jpeg_batch(blobs: Sequence[bytes], out_hw,
                      num_threads: int = 8, dtype=np.float32):
    """[N encoded JPEGs] → ([N, H, W, 3] RGB, [N] bool per-slot success
    flags). ``dtype=np.float32`` (default) yields [0, 1] floats;
    ``np.uint8`` yields 0..255 bytes."""
    return _decode("jpeg", blobs, out_hw, num_threads, dtype)


def decode_png_gray_batch(blobs: Sequence[bytes], out_hw,
                          num_threads: int = 8, dtype=np.float32):
    """[N encoded PNGs] → ([N, H, W, 1] gray, [N] bool per-slot success
    flags). ``dtype`` as in :func:`decode_jpeg_batch`."""
    return _decode("png_gray", blobs, out_hw, num_threads, dtype)


def read_chunk_members(tar_path) -> Optional[dict]:
    """Native in-memory read of a chunk archive: ``{member_name: bytes}``
    for every regular file, no extraction to disk. None when the native
    library is unavailable or cannot parse the archive (.tar.bz2 / .xz),
    so callers fall back to Python's ``tarfile``."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.pd_chunk_open(str(tar_path).encode())
    if not handle:
        logger.warning(
            "native chunk read failed for %s: %s — falling back",
            tar_path, lib.pd_chunk_error().decode(errors="replace"),
        )
        return None
    try:
        members = {}
        for i in range(lib.pd_chunk_count(handle)):
            name = lib.pd_chunk_name(handle, i).decode(errors="replace")
            size = ctypes.c_int64()
            ptr = lib.pd_chunk_data(handle, i, ctypes.byref(size))
            members[name] = ctypes.string_at(ptr, size.value) if size.value \
                else b""
        return members
    finally:
        lib.pd_chunk_close(handle)
