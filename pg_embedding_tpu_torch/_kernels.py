"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first CUDA use,
:func:`load_library` compiles them with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and links the objects into
one shared library under ``.kernel_build/`` at the repository root, keyed
by a hash of the sources and flags, and loads it with ``ctypes``.
The compiler's report (``-Xptxas -v``: registers, shared memory and spills
of each kernel) is kept beside it; :func:`build_log` returns it.  nvcc runs
with ``NVCC_PREPEND_FLAGS`` / ``NVCC_APPEND_FLAGS`` taken out of its
environment, so the library is built with the flags its key names and
nothing else (``-lineinfo`` from there alone moves ptxas's registers).
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
_SOURCES = ("bruteforce_topk.cu", "pq_topk.cu", "beam_walk.cu",
            "prune_scan.cu", "connect_batch.cu")
# no --use_fast_math: the walk's sqrtf must stay correctly rounded
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".kernel_build")
# the variables through which nvcc takes flags from its environment
NVCC_ENV_FLAGS = ("NVCC_PREPEND_FLAGS", "NVCC_APPEND_FLAGS")

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


def nvcc_env() -> dict:
    """The environment nvcc runs in: the caller's without NVCC_ENV_FLAGS."""
    return {k: v for k, v in os.environ.items() if k not in NVCC_ENV_FLAGS}


def declare_graph(lib) -> None:
    """The argument types of csrc/beam_walk.cu's and csrc/prune_scan.cu's
    entries in ``lib`` (the port's library or a probe's build)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.beam_walk.argtypes = [*[vp] * 9, *[ci] * 16, *[vp] * 5]
    lib.beam_walk.restype = ci
    if hasattr(lib, "beam_walk_blocks"):  # (an earlier tree's build: none)
        lib.beam_walk_blocks.argtypes = [ci] * 7
        lib.beam_walk_blocks.restype = ci
    lib.prune_scan.argtypes = [*[vp] * 5, *[ci] * 3, *[vp] * 3]
    lib.prune_scan.restype = ci


def declare_connect(lib) -> None:
    """The argument types of csrc/connect_batch.cu's entry in ``lib``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.connect_batch.argtypes = [vp, ci, *[vp] * 6, *[ci] * 9, *[vp] * 3]
    lib.connect_batch.restype = ci


def declare_sweep(lib) -> None:
    """The argument types of csrc/bruteforce_topk.cu's entries in ``lib``
    (the port's library or a probe's build of that source alone)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bruteforce_topk, lib.bruteforce_topk_bf16):
        fn.argtypes = [vp, vp, vp, *[ci] * 9, *[vp] * 7]
        fn.restype = ci
    # the Hopper instances take the same (an earlier tree's build: none)
    for name in ("bruteforce_topk_wgmma", "bruteforce_topk_bf16_wgmma"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [vp, vp, vp, *[ci] * 9, *[vp] * 7]
            getattr(lib, name).restype = ci
    # the wide selection's entries (and Manhattan's) take the shared bound
    # and its rank before the stream
    for fn in (lib.bruteforce_topk_wide, lib.bruteforce_topk_bf16_wide,
               lib.bruteforce_topk_l1, lib.bruteforce_topk_bf16_l1):
        fn.argtypes = [vp, vp, vp, *[ci] * 9, *[vp] * 7, ci, vp]
        fn.restype = ci
    # the int8-row instances take the rows' scales after the rows
    for name in ("bruteforce_topk_q8", "bruteforce_topk_q8_l1",
                 "bruteforce_topk_q8_wgmma"):
        if hasattr(lib, name):          # (an earlier tree's build: no wgmma)
            getattr(lib, name).argtypes = [vp, vp, vp, vp, *[ci] * 9,
                                           *[vp] * 7, ci, vp]
            getattr(lib, name).restype = ci
    lib.bruteforce_topk_error_string.argtypes = [ci]
    lib.bruteforce_topk_error_string.restype = ctypes.c_char_p


def declare_pq(lib) -> None:
    """The argument types of csrc/pq_topk.cu's entries in ``lib`` (the
    port's library or a probe's build of that source alone)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bruteforce_topk_pq.argtypes = [vp, vp, vp, vp, *[ci] * 8, vp, ci, vp,
                                       vp, ci, *[vp] * 7]
    lib.bruteforce_topk_pq.restype = ci
    lib.pq_topk_smem_bytes.argtypes = []
    lib.pq_topk_smem_bytes.restype = ci


def _declare(lib) -> None:
    declare_sweep(lib)
    declare_pq(lib)
    declare_graph(lib)
    declare_connect(lib)


def _build(srcs, work: str, path: str) -> None:
    """Compile each source to an object in ``work`` (one nvcc each, side
    by side), link them into the library at ``path`` and keep the
    compilers' reports in ``path``.log."""
    nvcc, env = _nvcc(), nvcc_env()
    objs = [os.path.join(work, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for s, o in zip(srcs, objs)]
    reports = [p.communicate() for p in procs]
    failed = [(s, p.returncode, err) for s, p, (_, err)
              in zip(srcs, procs, reports) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{os.path.basename(s)} ({rc}):\n{err}" for s, rc, err in failed))
    tmp = os.path.join(work, "lib.so")
    link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", tmp,
                           *objs], capture_output=True, text=True, env=env)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    with open(path + ".log", "w") as f:
        f.write("".join(err for _, err in reports))
    os.replace(tmp, path)


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
            # build in a private directory, then rename: concurrent
            # builds never load a half-written library
            work = tempfile.mkdtemp(dir=BUILD_DIR)
            try:
                _build(srcs, work, path)
            finally:
                shutil.rmtree(work, ignore_errors=True)
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
