"""Where the exact-sweep kernel's time goes, on one NVIDIA GPU.

  python -m pg_embedding_tpu_torch.sweep_probe [--reps N]

Builds variants of csrc/bruteforce_topk.cu with one part switched off, each
into its own library under .kernel_build/probe/ (nvcc, in parallel), and
times every variant with CUDA events at the main path's shape: 1M x 128-d
random rows, B=1024 queries, k_run=12, L2, float32 and bf16 corpus.  The
variants, each against the kernel:
  kernel          as built for the port (the launch shape's resident queries)
  streamed-q      the same library, queries streamed through the ring
  no-select       the selection after each tile removed (scores still made)
  loads-only      the mma's, the score tile and the selection removed
  cvt-rounding    the TF32 split by cvt.rna.tf32.f32 instead of integer ops
A variant's answers are wrong by design; only the kernel's ids are checked
(against the plain twin).  Variants are timed in turns, then in reverse
order, on one card, with its name and power limit printed first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess

import torch

from . import _kernels
from .ops import cuda_bruteforce as cb

B, N, D, K_RUN, L2 = 1024, 1_000_000, 128, 12, 0
SRC = os.path.join(_kernels._PKG_DIR, "csrc", "bruteforce_topk.cu")
OUT = os.path.join(_kernels.BUILD_DIR, "probe")

_SELECTION = "    // selection: warp w alone"
_EPILOGUE = "    // accumulators -> scores"
_NEXT_TILE = "    tile += kTileN;\n"
_CVT_SPLIT = (
    "__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,\n"
    "                                           uint32_t& lo) {\n"
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)\n'
    '      : "f"(x - __uint_as_float(hi)));\n'
    "}")


def _cut(src: str, begin: str, end: str) -> str:
    """Comment out src from ``begin`` up to the next ``end``."""
    a = src.index(begin)
    b = src.index(end, a)
    return src[:a] + "#if 0\n" + src[a:b] + "#endif\n" + src[b:]


def variants(src: str) -> dict:
    no_select = _cut(src, _SELECTION, _NEXT_TILE)
    no_mma = no_select.replace('  asm("mma.sync', '  if (0) asm("mma.sync')
    loads = _cut(no_mma, _EPILOGUE, "    __syncthreads();\n\n#if 0")
    a = src.index("__device__ __forceinline__ void split_tf32")
    cvt = src[:a] + _CVT_SPLIT + src[src.index("}", a) + 1:]
    return {"kernel": src, "no-select": no_select, "loads-only": loads,
            "cvt-rounding": cvt}


def build(name: str, src: str):
    cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    _kernels._declare(lib)
    return lib


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    with open(SRC) as f:
        srcs = variants(f.read())
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(build, srcs, srcs.values())))
    runs = [("kernel", False), ("streamed-q", True), ("no-select", False),
            ("loads-only", False), ("cvt-rounding", False)]

    g = torch.Generator(device="cuda").manual_seed(12345)
    rows = torch.randn((N, D), generator=g, device="cuda")
    qs = torch.randn((B, D), generator=g, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for order in (runs, runs[::-1]):
        for name, streamed in order:
            lib = libs["kernel" if name == "streamed-q" else name]
            for corpus in (rows, rows.to(torch.bfloat16)):
                isz = corpus.element_size()
                qt, splits, q_res, smem = cb._launch_shape(B, N, K_RUN, sms,
                                                           isz, D)
                if streamed:
                    q_res, smem = False, cb._smem_bytes(qt, K_RUN, isz, D,
                                                        False)
                part_d = torch.empty((splits, B, K_RUN), device="cuda")
                part_i = torch.empty((splits, B, K_RUN), dtype=torch.int32,
                                     device="cuda")
                out_d = torch.empty((B, K_RUN), device="cuda")
                out_i = torch.empty((B, K_RUN), dtype=torch.int32,
                                    device="cuda")
                fn = lib.bruteforce_topk if isz == 4 else (
                    lib.bruteforce_topk_bf16)

                def call():
                    err = fn(qs.data_ptr(), corpus.data_ptr(), None, B, N, D,
                             K_RUN, L2, qt, splits, int(q_res), smem,
                             part_d.data_ptr(), part_i.data_ptr(),
                             out_d.data_ptr(), out_i.data_ptr(), None,
                             None, stream)
                    _kernels.check(lib, err, name)
                ms = time_ms(call, args.reps)
                note = ""
                if name == "kernel" and order is runs:
                    want = cb._bruteforce_topk_plain(qs, corpus, K_RUN, L2,
                                                     N)[1]
                    note = (f"; ids equal to the plain twin's: "
                            f"{(out_i == want).float().mean().item():.4f}")
                print(f"{name:13s} {'float32' if isz == 4 else 'bf16':7s} "
                      f"QT={qt} S={splits} resident queries={q_res}: "
                      f"{ms:.3f} ms{note}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
