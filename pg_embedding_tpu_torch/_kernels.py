"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first CUDA use,
:func:`load_library` compiles them with ``nvcc`` for Hopper (``sm_90a``)
into one shared library under ``.kernel_build/`` at the repository root,
keyed by a hash of the sources and flags, and loads it with ``ctypes``.
The compiler's report (``-Xptxas -v``: registers, shared memory and spills
of each kernel) is kept beside it; :func:`build_log` returns it.
Importing this module builds nothing.  A failed build raises: there is no
fallback to a plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("bruteforce_topk.cu",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".kernel_build")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bruteforce_topk, lib.bruteforce_topk_bf16):
        fn.argtypes = [vp, vp, vp, *[ci] * 9, *[vp] * 7]
        fn.restype = ci
    lib.bruteforce_topk_error_string.argtypes = [ci]
    lib.bruteforce_topk_error_string.restype = ctypes.c_char_p


def load_library():
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(_PKG_DIR, "csrc", s) for s in _SOURCES]
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"libpg_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            # build to a private name, then rename: concurrent builders
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, *srcs],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
                with open(path + ".log", "w") as f:
                    f.write(proc.stderr)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return lib


def build_log() -> str:
    """The compiler's report for the loaded library ("" if not kept)."""
    lib = load_library()
    try:
        with open(lib._name + ".log") as f:
            return f.read()
    except OSError:
        return ""


def check(lib, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.bruteforce_topk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
