"""Where the exact-sweep kernel's time goes, on one NVIDIA GPU.

  python -m pg_embedding_tpu_torch.sweep_probe [--reps N] [--variants a,b]

Builds variants of csrc/bruteforce_topk.cu with one part switched off, each
into its own library under .kernel_build/probe/ (nvcc, in parallel), and
times every variant with CUDA events at the shapes below over 1M x 128-d
random rows, L2: the exact route's (B=1024 queries, k_run=12, float32 and
bf16 corpus, through the Hopper instance the wrapper takes there
(bruteforce_topk_wgmma / _bf16_wgmma) and the mma.sync one it took
before; float32 at k_run 12, 32, 64 and 102 (k = 100) through both
the exact route's instance and the wide one, where the wrapper's
WIDE_MIN_K comes from, and at 32 through the Hopper one) and the build sweep's (one 256-row insert batch:
the int8 shadow of the rows at k_run = 2 cand_cap = 256 through the Hopper
instance the wrapper takes there (bruteforce_topk_q8_wgmma) and the
mma.sync one (also at the other query tile), and exact mode's float32 / bf16 rows at cand_cap + 2 = 130,
through the wide instances and, float32, the exact route's).  Then the
Manhattan instances at the exact route's shape (float32 and bf16 rows,
B=1024, k=10) and the build's (the int8 shadow, B=256, pool 256), in the
L1 variants and, with ``--before FILE`` (an earlier tree's
csrc/bruteforce_topk.cu, built as "before" and timed at every shape, the
L2 ones too, launched with that tree's shared-memory figure), against it
in turns, beside their twin, the library call (torch.cdist(p=1) +
torch.topk over one chunk), the bound (2 B N D at 67 TFLOP/s) and the
FADD ceiling (2 B N D FADDs at the SMs' 128 lanes and the card's max SM
clock), with each build's registers, stack, FADDs and 16-byte shared
loads by Manhattan instance (cuobjdump): l1_shapes.  Then the
compressed sweep's pool (csrc/pq_topk.cu, PQ codes of G = 32 bytes a row
through a normal codebook, B=1024) built in its own variants (pq-kernel
as built; pq-no-select: the scores made but no row
admitted, no bound kept, the select over empty segments; pq-no-decode: an
element is its code's bits, no table read; pq-loads-only: the copies and
the code reads alone; pq-profile: the kernel with its phase clocks,
-DPG_PROFILE; pq-profile-conflicts: the same with the table read as PR
15's layout banked it, code % 32; pq-one-sum: no partial sum a step,
every mma adding into the tile's sums), first held to float64 on
clustered rows at pool 32 beside the twin (pq_error), then timed at pools
32 to 1024 beside the twin and the library call, with the candidate
segments' counts and the phase clocks; and Manhattan at pool 32 against
the twin: pq_pools.  The row sweep's
variants, each against the kernel:
  kernel          as built for the port (the launch shape's resident queries)
  streamed-q      the same library, queries streamed through the ring
  no-select       the selection after each tile removed (scores still made;
                  the Hopper instances: the selector warpgroups only take
                  the score tiles and hand them back)
  loads-only      the mma's, the score tile and the selection removed (the
                  Hopper instances, the int8 one too: the wgmma's and the
                  selection removed, the ring, the splits, the widening
                  and the score epilogue kept)
  wgmma-2         the Hopper instances with a wgmma group of 2 steps (the
                  kernel's: a chunk's 4), each retired before the next
  cvt-rounding    the TF32 split by cvt.rna.tf32.f32 instead of integer ops
  smem-lists      the wide selection's lists in shared memory, every
                  insertion one by one there (the exact route's way,
                  reading and publishing the shared bound)
  serial-select   the wide selection as it was before the shared bound:
                  every admitted row inserted one by one, no bound read
  no-shared-bound the splits' bound published but never read
  bound-serial    the shared bound read, every admitted row inserted one
                  by one (no tile merge)
  bound-merge     the shared bound read, every tile's admitted rows merged
                  at once (no one-by-one insertion)
  serial-max-N    the shared bound read, up to N of a tile's admitted rows
                  one by one, more merged (the kernel's cut-off is 8)
  unused-bound    the bound read before each tile but not applied (its
                  reads' cost: this minus no-shared-bound)
(the wide shapes take every one from smem-lists on; the int8 Hopper shape
those that change its selection too: all but smem-lists and unused-bound)
and Manhattan's, timed at l1_shapes only:
  l1-no-select    the scores made, the selection removed (no-select's text)
  l1-loads-only   the staging and widening alone: no selection and no
                  register tile (no FADD)
  l1-tile-8x4     a thread's register tile 8 queries x 4 rows at QT = 64
                  (the kernel's: 4 x 8)
  l1-no-swap      a query's dim read from the component of the row's (its
                  pairs still swapped: wrong sums), so both operands of each
                  subtraction sit in one register bank
  l1-pipe         the next four dims' operands loaded before this four's
                  FADDs (two register sets in turn), the launch bounds at
                  one block an SM (255 registers)
  l1-compute      no-select with the ring's copies after the first step
                  skipped (stale chunks): the register tile, the widening
                  and the barriers alone
  l1-compute-no-barrier  the same without the step loop's barriers
The wide shapes also run the count build (the kernel, and serial-select,
with atomics: the rows each (query, split) admitted at its tiles' starts,
the rows merged a tile at a time and the tile merges; mean and max beside
the model k (1 + ln(rows a split / k)) of a split that admits against its
own k-th alone) and time the merge kernel alone at the launch's partial
lists.  A variant's answers are wrong by design but for bound-serial's,
bound-merge's and serial-max-N's; those and the kernel's ids are checked
(against the plain twin); the PQ kernel's pool at 32 too.  Variants are timed in turns, then in
reverse order (--passes of them, every other reversed), on one card, with
its name and power limit printed first; each variant's best and worst pass
close the run.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import math
import os
import re
import shutil
import subprocess

import torch

from . import _kernels
from .core.build import quantize_rows
from .ops import cuda_bruteforce as cb
from .ops import pq_sweep

N, D, L2 = 1_000_000, 128, 0
# (corpus, queries B, k_run, forced query tile, path: False the exact
# route's mma.sync instance, True the wide one, "wgmma" the Hopper one):
# the exact route's shapes, then the build's
SHAPES = (("float32", 1024, 12, None, "wgmma"), ("bf16", 1024, 12, None, "wgmma"),
          ("float32", 1024, 12, None, False), ("bf16", 1024, 12, None, False),
          ("float32", 1024, 32, None, "wgmma"),
          ("float32", 1024, 12, None, True),
          ("float32", 1024, 32, None, False),
          ("float32", 1024, 32, None, True),
          ("float32", 1024, 64, None, False),
          ("float32", 1024, 64, None, True),
          ("float32", 1024, 102, None, False),
          ("float32", 1024, 102, None, True),
          ("int8", 256, 256, None, "wgmma"),
          ("int8", 256, 256, None, True), ("int8", 256, 256, 16, True),
          ("float32", 256, 130, None, False),
          ("float32", 256, 130, None, True), ("bf16", 256, 130, None, True))
# the PQ pool's codes a row and its pools
PQ_GROUPS = 32
PQ_POOLS = (32, 256, 512, 1024)
SRC = os.path.join(_kernels._PKG_DIR, "csrc", "bruteforce_topk.cu")
PQ_SRC = os.path.join(_kernels._PKG_DIR, "csrc", "pq_topk.cu")
OUT = os.path.join(_kernels.BUILD_DIR, "probe")

_SELECTION = "    // selection: warp w alone"
# the Hopper instances' selection of a tile, and their wgmma
_W_SELECTION = "      // the selection of a tile\n"
_W_SELECTION_END = "      // the selection of a tile: end"
# the int8 Hopper instance's
_W8_SELECTION = "      // the int8 selection of a tile (it releases the tile)\n"
_W8_SELECTION_END = "      // the int8 selection of a tile: end"
_W_MMA = "  asm volatile(\n      \"{\\n .reg .pred p;\\n setp.ne.b32 p, %37"
_W_GROUP = "constexpr int kWGroupSteps = 4;"
_EPILOGUE = "    // accumulators -> scores"
_NEXT_TILE = "    tile += kTileN;\n"
_REG_LISTS = "        if (k_run <= kRegK) {\n"
_SERIAL = "constexpr int kSerialMax = "
_READ_BOUND = "constexpr bool kReadBound = true;"
_APPLY_BOUND = ("      const float tau =\n"
                "          kWide ? __shfl_sync(kFull, tau_mine, i) : "
                "CUDART_INF_F;\n")
_ADMITTED = "  if (admitted <= kSerialMax)\n"
_NAMESPACE = "\nnamespace {\n"
# Manhattan's register tile: its call and its 4-dim step loop
_L1_CALL = "      l1_tile<QT>(q_s + l1_qg * qs"
# the register tile's row groups at QT = 64 (l1-tile-8x4: 32, a thread 8
# queries x 4 rows)
_L1_GROUPS = "  static constexpr int RG = QT >= 64 ? 16 : 32;"
# the tile's step loop and the Manhattan instances' launch bounds
# (l1-pipe: the next four dims' operands loaded before this four's FADDs,
# two register sets in turn, at one block an SM: 255 registers)
_L1_LOOP = """  float4 qv[L1Tile<QT>::RQ], pv[L1Tile<QT>::RN];
#pragma unroll 1
  for (int k0 = 0; k0 < kTileD; k0 += 4) {
    l1_load<QT>(q_s, qs, p_f, k0, qv, pv);
    l1_step<QT>(qv, pv, acc);
  }
"""
_L1_PIPE = """  float4 qa[L1Tile<QT>::RQ], pa[L1Tile<QT>::RN];
  float4 qb[L1Tile<QT>::RQ], pb[L1Tile<QT>::RN];
  l1_load<QT>(q_s, qs, p_f, 0, qa, pa);
#pragma unroll 1
  for (int k0 = 0; k0 < kTileD; k0 += 8) {
    l1_load<QT>(q_s, qs, p_f, k0 + 4, qb, pb);
    l1_step<QT>(qa, pa, acc);
    if (k0 + 8 < kTileD) l1_load<QT>(q_s, qs, p_f, k0 + 8, qa, pa);
    l1_step<QT>(qb, pb, acc);
  }
"""
_L1_BOUNDS = "__global__ void __launch_bounds__(kThreads, 2)\nsweep_kernel_l1("
# the Manhattan instances' shapes: (corpus, queries B, k_run): the exact
# route's, then the build's
L1_SHAPES = (("float32", 1024, 10), ("bf16", 1024, 10), ("int8", 256, 256))
# H100 SXM: float32 outside the tensor cores (the data sheet's, an FMA
# counted as two), and the FP32 lanes of an SM
PEAK_F32 = 67e12
FP32_LANES = 128
# the PQ kernel's filter's bound, its bound phase, its table reads, its
# mma's, its laps
_PQ_TAU = ("          const float qn = qn_s[ql], tau = tau_s[ql], "
           "fd = fld_s[ql];\n")
_PQ_BOUND = "      if (bound != nullptr || own) {\n"
# tiles between the shared slots' reads that pq-refresh-N tries (the
# kernel's is 8), and the seeding launch's tiles that pq-seed-N tries
# (the kernel's is 2; 0: no seeding)
PQ_REFRESH_TRIED = (1, 32)
PQ_SEED_TRIED = (0, 8)
_PQ_GATHER = ("        uint32_t w = tab[codes_s[r * kCS + o0] * kPairs + "
              "lane];\n")
_PQ_STRADDLE = "        if (o1 != o0)\n"
_PQ_MMA = '  asm("mma.sync.aligned.m16n8k16'
# the cut-offs between one-by-one insertion and a tile merge that
# serial-max-N tries beside the kernel's
SERIAL_MAX_TRIED = (2, 4, 16)
# the variants whose answers are the kernel's
_EXACT = ("kernel", "bound-serial", "bound-merge",
          *(f"serial-max-{n}" for n in SERIAL_MAX_TRIED))
_CVT_SPLIT = (
    "__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,\n"
    "                                           uint32_t& lo) {\n"
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)\n'
    '      : "f"(x - __uint_as_float(hi)));\n'
    "}")
# the count build: per (query, split) slot, (rows admitted, rows merged a
# tile at a time, tile merges); the entries that read and clear them, and
# one that launches the merge kernel alone
_COUNT_SLOTS = 1024 * 128
_COUNTERS = (
    f"\n__device__ unsigned g_probe_counts[3][{_COUNT_SLOTS}];\n")
_COUNT = (
    "  if (lane == 0) {\n"
    "    atomicAdd(&g_probe_counts[0][at], (unsigned)admitted);\n"
    "    if (admitted > kSerialMax) {\n"
    "      atomicAdd(&g_probe_counts[1][at], (unsigned)admitted);\n"
    "      atomicAdd(&g_probe_counts[2][at], 1u);\n"
    "    }\n"
    "  }\n")
_COUNT_ENTRIES = """
extern "C" int probe_counts(void* dst) {
  void* src = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&src, g_probe_counts);
  if (err == cudaSuccess)
    err = cudaMemcpy(dst, src, sizeof(g_probe_counts),
                     cudaMemcpyDeviceToDevice);
  if (err == cudaSuccess) err = cudaMemset(src, 0, sizeof(g_probe_counts));
  return (int)err;
}

extern "C" int probe_merge(const float* part_d, const int* part_i, int B,
                           int S, int k_run, float* out_d, int* out_i,
                           void* stream) {
  merge_kernel<<<ceil_div(B, kMergeWarps), kMergeWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      part_d, part_i, B, S, k_run, kMetricL2, out_d, out_i, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}
"""


def _cut(src: str, begin: str, end: str) -> str:
    """Comment out src from ``begin`` up to the next ``end``."""
    a = src.index(begin)
    b = src.index(end, a)
    return src[:a] + "#if 0\n" + src[a:b] + "#endif\n" + src[b:]


def _once(src: str, old: str, new: str, times: int = 1) -> str:
    """src with its ``times`` copies of ``old`` (one by default) replaced
    by ``new``."""
    if src.count(old) != times:
        raise ValueError(f"{old!r} appears {src.count(old)} times")
    return src.replace(old, new)


def _counting(src: str) -> str:
    src = _once(src, _NAMESPACE, _COUNTERS + _NAMESPACE)
    return _once(src, _ADMITTED, _COUNT + _ADMITTED) + _COUNT_ENTRIES


def _serial_max(src: str, n) -> str:
    """src with the cut-off kSerialMax set to ``n``."""
    if src.count(_SERIAL) != 1:
        raise ValueError(f"{_SERIAL!r} appears {src.count(_SERIAL)} times")
    a = src.index(_SERIAL) + len(_SERIAL)
    return src[:a] + str(n) + src[src.index(";", a):]


def variants(src: str) -> dict:
    no_select = _cut(_cut(_cut(src, _SELECTION, _NEXT_TILE), _W_SELECTION,
                          _W_SELECTION_END), _W8_SELECTION, _W8_SELECTION_END)
    # the TF32 and the bf16 wgmma
    no_mma = _once(no_select, _W_MMA, "  if (0)" + _W_MMA[1:], 2).replace(
        '  asm("mma.sync', '  if (0) asm("mma.sync')
    loads = _cut(no_mma, _EPILOGUE, "    __syncthreads();\n\n#if 0")
    a = src.index("__device__ __forceinline__ void split_tf32")
    cvt = src[:a] + _CVT_SPLIT + src[src.index("}", a) + 1:]
    smem_lists = _once(src, _REG_LISTS, "        if (false) {\n")
    no_bound = _once(src, _READ_BOUND, "constexpr bool kReadBound = false;")
    serial = _serial_max(no_bound, "kRegK")
    bound_serial = _serial_max(src, "kRegK")
    bound_merge = _serial_max(src, 0)
    unused = _once(src, _APPLY_BOUND,
                   "      const float tau = kWide && isnan(__shfl_sync(kFull, "
                   "tau_mine, i)) ? 0.f : CUDART_INF_F;\n")
    cut_offs = {f"serial-max-{n}": _serial_max(src, n)
                for n in SERIAL_MAX_TRIED}
    l1_loads = _once(no_select, _L1_CALL, "      if (false) " + _L1_CALL[6:])
    tile_8x4 = _once(src, _L1_GROUPS, "  static constexpr int RG = 32;")
    no_swap = _once(src, "part(qv[i], c ^ 1)", "part(qv[i], c)")
    pipe = _once(_once(src, _L1_LOOP, _L1_PIPE), _L1_BOUNDS,
                 _L1_BOUNDS.replace(", 2)", ", 1)"))
    # the ring's copies after the first step skipped (the sums of stale
    # chunks), with no selection: the register tile, the widening and the
    # barriers alone; then without the step loop's barriers either
    compute = _once(
        no_select, "    if (s + 1 < total)\n      load_step",
        "    if (s + 1 < total && (!kL1 || s < 1))\n      load_step")
    no_bar = _once(_once(_once(
        compute, "    cp_async_wait<kStages - 1>();\n    __syncthreads();",
        "    cp_async_wait<kStages - 1>();\n    if (!kL1) __syncthreads();"),
        "      if (kWiden || !kQRes || s == 0) __syncthreads();",
        "      if (false) __syncthreads();"),
        "    __syncthreads();\n    if (!last) {",
        "    if (!kL1) __syncthreads();\n    if (!last) {")
    return {"kernel": src, "no-select": no_select, "loads-only": loads,
            "l1-no-select": no_select, "l1-loads-only": l1_loads,
            "l1-tile-8x4": tile_8x4, "l1-no-swap": no_swap,
            "l1-pipe": pipe, "l1-compute": compute,
            "l1-compute-no-barrier": no_bar,
            "wgmma-2": _once(src, _W_GROUP, "constexpr int kWGroupSteps = 2;"),
            "cvt-rounding": cvt, "smem-lists": smem_lists,
            "serial-select": serial, "no-shared-bound": no_bound,
            "bound-serial": bound_serial, "bound-merge": bound_merge,
            "unused-bound": unused, "count": _counting(src),
            "count-serial": _counting(serial), **cut_offs}


def pq_variants(src: str) -> dict:
    """csrc/pq_topk.cu and its rewrites: pq-no-select (every query's bound
    NaN, so no row is admitted, though the compiler cannot tell: the
    scores made, nothing appended, no bound kept), pq-no-decode (an
    element is its code's bits: no table read, no straddling pair),
    pq-loads-only (no-select and no-decode with the mma's off),
    pq-profile (the kernel with PG_PROFILE defined: phase clocks),
    pq-profile-conflicts (the same reading the table as PR 15's layout
    banked it, code % 32: the decode's clock against the kernel's),
    pq-one-sum (no partial sum a step: every mma adds into the tile's
    sums)."""
    no_select = _once(_once(src, _PQ_TAU, _PQ_TAU.replace(
        "tau = tau_s[ql]", "tau = 0.f * tau_s[ql] - CUDART_INF_F")),
                      _PQ_BOUND, "      if (false) {\n")
    no_decode = _once(_once(src, _PQ_GATHER,
                            "        uint32_t w = codes_s[r * kCS + o0];\n"),
                      _PQ_STRADDLE, "        if (false)\n")
    loads = _once(_once(_once(no_select, _PQ_GATHER,
                              "        uint32_t w = codes_s[r * kCS + o0];\n"),
                        _PQ_STRADDLE, "        if (false)\n"),
                  _PQ_MMA, '  if (0) asm("mma.sync.aligned.m16n8k16')
    refresh = {f"pq-refresh-{n}": _once(src, "constexpr int kRefresh = 8;",
                                        f"constexpr int kRefresh = {n};")
               for n in PQ_REFRESH_TRIED}
    seed = {f"pq-seed-{n}": _once(src, "constexpr int kSeedTiles = 2;",
                                  f"constexpr int kSeedTiles = {n};")
            for n in PQ_SEED_TRIED}
    # PR 15's table layout, entry (pair, code) at word 256 pair + code:
    # bank code % 32, so random codes collide (the values read are wrong;
    # only the decode's phase clock means anything)
    conflicts = _once(_once(
        src, "tab[codes_s[r * kCS + o0] * kPairs + lane]",
        "tab[lane * kCodes + codes_s[r * kCS + o0]]"),
        "tab[codes_s[r * kCS + o1] * kPairs + lane]",
        "tab[lane * kCodes + codes_s[r * kCS + o1]]")
    # the step's products summed straight into the tile's sums, with no
    # partial sum a step (the accumulation of the redesign's first draft)
    one_sum = _once(_once(_once(
        src, "mma_bf16(part[nt], a0, b0, b1);",
        "mma_bf16(acc[mt][nt], a0, b0, b1);"),
        "if (pass == 0) mma_bf16(part[nt], a1, b0, b1);",
        "if (pass == 0) mma_bf16(acc[mt][nt], a1, b0, b1);"),
        "acc[mt][nt][c] = __fadd_rn(acc[mt][nt][c], part[nt][c]);",
        "(void)part[nt][c];")
    return {"pq-kernel": src, "pq-one-sum": one_sum,
            "pq-no-select": no_select,
            "pq-no-decode": no_decode, "pq-loads-only": loads,
            "pq-profile": "#define PG_PROFILE\n" + src,
            "pq-profile-conflicts": "#define PG_PROFILE\n" + conflicts,
            **refresh, **seed}


def build(name: str, src: str, declare=_kernels.declare_sweep):
    cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS,
                           "-shared", "-o", so, cu], capture_output=True,
                          text=True, env=_kernels.nvcc_env())
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    declare(lib)
    return lib


def _path(wide) -> str:
    """A shape's instance, as the summary lines name it."""
    return {True: "wide", "wgmma": "Hopper"}.get(wide, "exact route")


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


def launcher(lib, corpus, q, k_run: int, force_qt, wide,
             streamed: bool, sms: int, stream, metric: int = L2,
             widened: bool = True):
    """A launch over all N rows (``metric``, L2 by default) of ``lib``'s
    wide instance for this corpus (``wide`` True; int8 rows have no other),
    its Hopper instance (``wide`` "wgmma") or the exact route's mma.sync
    one (Manhattan's instance under metric 2), the entry and
    its shared bound as the wrapper's ``_entry`` makes them, the bound
    refilled with +inf before each launch.  A corpus is float32 / bf16 rows
    or the int8 shadow (qvec, qscale).  ``widened`` False sizes a
    Manhattan launch without the widened chunk (a tree before it).
    Returns (call, its launch shape and buffers)."""
    rows_k, scale = corpus if isinstance(corpus, tuple) else (corpus, None)
    isz, b = rows_k.element_size(), q.shape[0]
    l1 = metric == 2 and widened
    wgmma = wide == "wgmma"
    qt, splits, q_res, smem = cb._launch_shape(b, N, k_run, sms, isz, D,
                                               force_qt, manhattan=l1,
                                               wgmma=wgmma)
    if streamed:
        q_res, smem = False, cb._smem_bytes(qt, k_run, isz, D, False, l1)
    part_d = torch.empty((splits, b, k_run), device="cuda")
    part_i = torch.empty((splits, b, k_run), dtype=torch.int32,
                         device="cuda")
    out_d = torch.empty((b, k_run), device="cuda")
    out_i = torch.empty((b, k_run), dtype=torch.int32, device="cuda")
    name, scratch, tail = cb._entry(rows_k.dtype, k_run, b, splits, "cuda",
                                    None if wgmma else wide,
                                    manhattan=metric == 2, wgmma=wgmma)
    fn = getattr(lib, name)
    lead = ((q.data_ptr(), rows_k.data_ptr())
            + (() if scale is None else (scale.data_ptr(),)))

    def call():
        if scratch is not None:
            scratch.fill_(float("inf"))
        err = fn(*lead, None, b, N, D, k_run, metric, qt, splits,
                 int(q_res),
                 smem, part_d.data_ptr(), part_i.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(), None, None, *tail,
                 stream)
        _kernels.check(lib, err, name)
    return call, dict(name=name, qt=qt, splits=splits, q_res=q_res,
                      part_d=part_d, part_i=part_i, out_d=out_d, out_i=out_i)


def counts(libs, corpus, q, k_run, force_qt, sms, stream) -> None:
    """The count builds at one wide shape: each (query, split)'s admitted
    rows, rows merged a tile at a time and tile merges, under the kernel's
    selection and serial-select's; then the merge kernel alone on the
    kernel's partial lists."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    b = q.shape[0]
    got = torch.empty((3, _COUNT_SLOTS), dtype=torch.int32, device="cuda")
    for name in ("count-serial", "count"):
        lib = libs[name]
        lib.probe_counts.argtypes, lib.probe_counts.restype = [vp], ci
        call, shape = launcher(lib, corpus, q, k_run, force_qt, True, False,
                               sms, stream)
        _kernels.check(lib, lib.probe_counts(got.data_ptr()), name)
        call()
        _kernels.check(lib, lib.probe_counts(got.data_ptr()), name)
        s = shape["splits"]
        adm, merged, merges = got[:, : b * s].view(3, b, s).double()
        model = k_run * (1 + math.log(N / s / k_run))
        print(f"{name:15s} B={b} k_run={k_run} QT={shape['qt']} S={s}: a "
              f"query a split admits {adm.mean():.1f} rows at its tiles' "
              f"starts (max {adm.max():.0f}; the model without a shared "
              f"bound {model:.0f}), {merged.mean():.1f} of them merged a "
              f"tile at a time in {merges.mean():.2f} tile merges (max "
              f"{merges.max():.0f}), {(adm - merged).mean():.1f} one by one",
              flush=True)
    lib = libs["count"]
    lib.probe_merge.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
    lib.probe_merge.restype = ci

    def merge():
        _kernels.check(lib, lib.probe_merge(
            shape["part_d"].data_ptr(), shape["part_i"].data_ptr(), b,
            shape["splits"], k_run, shape["out_d"].data_ptr(),
            shape["out_i"].data_ptr(), stream), "merge")
    print(f"merge_kernel alone at B={b}, S={shape['splits']}, k_run={k_run}:"
          f" {time_ms(merge, 20):.4f} ms", flush=True)


def max_sm_clock_hz() -> float:
    """The card's max SM clock (nvidia-smi's clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def l1_bound_ms(b: int, n: int, d: int) -> float:
    """A Manhattan sweep's bound: 2 B N D float32 operations (a
    subtraction and an |.|-addition a term) at the published 67 TFLOP/s."""
    return 2.0 * b * n * d / PEAK_F32 * 1e3


def fadd_ceiling_ms(b: int, n: int, d: int, sms: int, clock_hz: float):
    """A Manhattan sweep's reachable floor: its 2 B N D operations are
    FADDs that cannot fuse (the published rate counts an FMA as two), one
    a lane a cycle on ``sms`` SMs of FP32_LANES at ``clock_hz``."""
    return 2.0 * b * n * d / (sms * FP32_LANES * clock_hz) * 1e3


def _cuobjdump(lib, flag: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, lib._name], capture_output=True,
                          text=True, check=True).stdout


def res_usage(lib) -> dict:
    """{function: (registers, stack bytes)} of a built library
    (cuobjdump -res-usage)."""
    out, name = {}, None
    for line in _cuobjdump(lib, "-res-usage").splitlines():
        m = re.search(r"Function ([^\s:]+)", line)
        if m:
            name = m[1]
        m = re.search(r"REG:(\d+)\s+STACK:(\d+)", line)
        if m and name:
            out[name], name = (int(m[1]), int(m[2])), None
    return out


def _by_name(usage: dict) -> dict:
    """``usage`` keyed by the mangled names without the anonymous
    namespace (its mangling differs between two source files)."""
    out = {}
    for fn, v in usage.items():
        m = re.match(r"_ZN(\d+)_GLOBAL__N_", fn)
        out[fn[3 + len(m[1]) + int(m[1]):] if m else fn] = v
    return out


def sass_report(lib) -> dict:
    """Per Manhattan row instance (sweep_kernel_l1) of a built library:
    (registers, stack bytes, FADDs, 16-byte shared loads, instructions)
    from cuobjdump's -res-usage and -sass."""
    out, name = {}, None
    for fn, (regs, stack) in res_usage(lib).items():
        if "sweep_kernel_l1" in fn:
            out[fn] = [regs, stack, 0, 0, 0]
    for line in _cuobjdump(lib, "-sass").splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m[1] if m[1] in out else None
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            op = line.split("*/")[1].strip().split(" ")
            op = op[1] if op[0].startswith("@") else op[0]
            out[name][2] += op.startswith("FADD")
            out[name][3] += op == "LDS.128"
            out[name][4] += 1
    return out


def _instance_label(mangled: str) -> str:
    m = re.search(r"sweep_kernel_l1ILi(\d+)ELb([01])E([fta])E", mangled)
    if not m:
        return mangled
    return (f"QT={m[1]}, {'resident' if m[2] == '1' else 'streamed'} "
            f"queries, {dict(f='float32', t='bf16', a='int8')[m[3]]} rows")


def l1_shapes(libs, corpora, qs, sms, stream, passes: int,
              widened_before: bool = False) -> None:
    """The Manhattan instances at the exact route's shape (float32 and
    bf16 rows, B=1024, k_run = k = 10) and the build's (the int8 shadow of
    the rows, one 256-row insert batch, k_run = 2 cand_cap = 256): each of
    ``libs`` (the kernel, the l1-* variants and an earlier tree's
    "before", launched with its own shared-memory figure), in ``passes``
    turns, every other reversed, each a call between CUDA events after a
    warm-up call; beside them the twin (_bruteforce_topk_plain: sweep_min_k
    over torch.cdist chunks), the library call (torch.cdist(p=1) over one
    1M chunk + torch.topk), the bound and the FADD ceiling; ids of the
    kernel and "before" against the twin's.  Then each build's registers,
    stack, FADDs and 16-byte shared loads by Manhattan instance.
    ``widened_before``: "before" is a tree whose Manhattan instances widen
    bf16 and int8 chunks, so its launches take that figure."""
    clock = max_sm_clock_hz()
    best, worst = {}, {}
    order = list(libs)
    for p in range(passes):
        for name in (order[::-1] if p % 2 else order):
            for kind, b, k_run in L1_SHAPES:
                call, shape = launcher(libs[name], corpora[kind], qs[:b],
                                       k_run, None, True, False, sms, stream,
                                       metric=2,
                                       widened=(name != "before"
                                                or widened_before))
                ms = time_ms(call, 5)
                key = kind, name
                best[key] = min(ms, best.get(key, ms))
                worst[key] = max(ms, worst.get(key, ms))
                note = ""
                if name in ("kernel", "before") and p == 0:
                    want = cb._bruteforce_topk_plain(qs[:b], corpora[kind],
                                                     k_run, 2, N)
                    same = (shape["out_i"] == want[1]).float().mean()
                    bits = torch.equal(shape["out_d"], want[0])
                    note = (f"; ids equal to the twin's: {same:.5f}, "
                            f"distances bit-equal: {bits}")
                print(f"manhattan {name:15s} {shape['name']:25s} B={b} "
                      f"k_run={k_run} QT={shape['qt']} S={shape['splits']}: "
                      f"{ms:.3f} ms{note}", flush=True)
    for kind, b, k_run in L1_SHAPES:
        corpus = corpora[kind]
        q = qs[:b]
        twin = time_ms(lambda: cb._bruteforce_topk_plain(q, corpus, k_run, 2,
                                                         N), 1)
        dense = (cb.dequantize_rows(*corpus).float() if kind == "int8"
                 else corpus.float())
        library = time_ms(lambda: torch.topk(
            torch.cdist(q, dense, p=1.0), k_run, dim=1, largest=False), 3)
        del dense
        times = ", ".join(f"{name} {best[kind, name]:.3f} (worst "
                          f"{worst[kind, name]:.3f})" for name in order)
        print(f"manhattan {kind} B={b} k_run={k_run}, best of {passes} "
              f"passes: {times} ms; twin {twin:.3f} ms, library "
              f"(torch.cdist + topk) {library:.3f} ms; bound "
              f"{l1_bound_ms(b, N, D):.3f} ms (2 B N D at 67 TFLOP/s), FADD "
              f"ceiling {fadd_ceiling_ms(b, N, D, sms, clock):.3f} ms ({sms} "
              f"SMs x {FP32_LANES} lanes at {clock / 1e9:.3f} GHz)",
              flush=True)
    if "before" in libs:
        # every other function's registers and stack as the earlier tree's
        now, then = (_by_name(res_usage(libs[k])) for k in ("kernel",
                                                             "before"))
        moved = {fn: (then.get(fn), use) for fn, use in now.items()
                 if "sweep_kernel_l1" not in fn and then.get(fn) != use}
        print(f"registers and stack of the {len(now)} functions but the "
              f"Manhattan sweeps, against the earlier tree: "
              f"{moved or 'all the same'}", flush=True)
    for name in order:
        for fn, (regs, stack, fadd, lds, total) in sorted(
                sass_report(libs[name]).items()):
            print(f"sass {name:15s} sweep_kernel_l1<{_instance_label(fn)}>: "
                  f"{regs} registers, {stack} bytes stack, {fadd} FADD, "
                  f"{lds} LDS.128 of {total} instructions", flush=True)


def pq_call(lib, codes, table, qs, pool: int, sms: int, stream,
            metric: int = L2):
    """One sweep and select of ``lib``'s bruteforce_topk_pq over all N
    rows, shaped as the wrapper's _pq_launch_shape shapes it (the bound
    refilled with +inf before each call; no rerun of an overflowed
    segment).  Returns (call, shape and buffers)."""
    b = qs.shape[0]
    splits, rank, cap, per = cb._pq_launch_shape(b, N, pool, sms)
    buf = torch.empty((b, splits, cap, 2), dtype=torch.int32, device="cuda")
    counts = torch.empty((b, splits), dtype=torch.int32, device="cuda")
    bound = torch.full((b, splits), float("inf"), device="cuda")
    out_d = torch.empty((b, pool), device="cuda")
    out_i = torch.empty((b, pool), dtype=torch.int32, device="cuda")

    def call():
        bound.fill_(float("inf"))
        err = lib.bruteforce_topk_pq(
            qs.data_ptr(), codes.data_ptr(), table.data_ptr(), None, b, N, D,
            codes.shape[1], pool, metric, splits, cb.PQ_SMEM, buf.data_ptr(),
            cap, counts.data_ptr(), bound.data_ptr() if rank else None, rank,
            out_d.data_ptr(), out_i.data_ptr(), None, None, None, None,
            stream)
        if err:
            raise RuntimeError(f"bruteforce_topk_pq: CUDA error {err}")
    return call, dict(splits=splits, rank=rank, cap=cap, counts=counts,
                      out_d=out_d, out_i=out_i)


def pq_error(pq_libs, sms, stream) -> None:
    """The PQ pool's distances against float64 on clustered rows (the
    smoke's phase 8 recipe: utils.io.synthetic_clustered, 1M x 128-d,
    50,000 centres, 1024 queries of the mixture; a G=32 codebook by
    ops/pq.train_pq on 65,536 of the rows), pool 32, L2: for pq-kernel,
    pq-one-sum and the twin, the mean and largest |d - d64| over the
    returned (query, row) pairs (d64 over the decoded bf16 rows), and for
    the variants the largest |d - twin's d| at equal ranks over the
    smoke's tolerance, 1e-5 d + 1e-6 (past 1, chip_smoke's parity check
    fails)."""
    from .ops.pq import pq_decode, pq_encode, train_pq
    from .utils.io import synthetic_clustered
    pts, qs = synthetic_clustered(N, D, 50_000, seed=12348, n_queries=1024)
    rows = torch.as_tensor(pts, device="cuda")
    qs = torch.as_tensor(qs, device="cuda")
    book = train_pq(rows[:65536], groups=PQ_GROUPS)
    codes = pq_encode(rows, book)
    del rows
    table = cb.pq_table(book)
    q64 = qs.double()

    def err64(d, ids):
        dec = pq_decode(codes[ids.long()].view(-1, PQ_GROUPS), book)
        p = dec.to(torch.bfloat16).double().view(*ids.shape, D)
        e = (d.double() - torch.sqrt(((p - q64[:, None]) ** 2).sum(-1))).abs()
        return f"mean {e.mean():.3g}, largest {e.max():.3g}"
    want = pq_sweep._pq_pool_plain(qs, codes, book, None, N, None, pool=32,
                                   metric_value=L2, chunk=16384)
    line = [f"twin {err64(*want)}"]
    for name in ("pq-kernel", "pq-one-sum"):
        if name not in pq_libs:
            continue
        call, shape = pq_call(pq_libs[name], codes, table, qs, 32, sms,
                              stream)
        call()
        got = shape["out_d"], shape["out_i"]
        ratio = ((got[0] - want[0]).abs()
                 / (1e-5 * want[0].abs() + 1e-6)).max()
        line.append(f"{name} {err64(*got)}, worst difference from the "
                    f"twin {ratio:.3f} of the tolerance, ids equal "
                    f"{(got[1] == want[1]).float().mean():.5f}")
    print("pq pool 32 vs float64 on clustered rows: " + "; ".join(line),
          flush=True)


def pq_pools(pq_libs, codes, book, qs, sms, stream, reps: int) -> None:
    """The PQ pool at pools 32 to 1024 over the PQ codes, B=1024, L2: each
    variant of csrc/pq_topk.cu (its sweep and select), the kernel also
    through the wrapper (pq_topk: reruns of overflowed segments
    included), the twin _pq_pool_plain and the library call (pq_decode of
    every row to bf16, then torch.matmul in float32 + torch.topk to the
    pool); the kernel's segment counts (mean and largest, rows a query,
    queries that overflowed) and its ids against the twin's at pool 32;
    the profile build's phase clocks (a sweep block's cycles a tile in
    each phase, a select block's cycles); then Manhattan at pool 32, the
    kernel against the twin.  Each a call between CUDA events after a
    warm-up call."""
    from .ops.pq import pq_decode
    table = cb.pq_table(book)

    def library(pool):
        rows = pq_decode(codes, book).to(torch.bfloat16).float()
        torch.topk(torch.matmul(qs, rows.T), pool, dim=1, largest=False,
                   sorted=False)

    def twin(pool, metric=L2):
        return pq_sweep._pq_pool_plain(qs, codes, book, None, N, None,
                                       pool=pool, metric_value=metric,
                                       chunk=16384)
    for pool in PQ_POOLS:
        got = {}
        for name, lib in pq_libs.items():
            call, shape = pq_call(lib, codes, table, qs, pool, sms, stream)
            if name.startswith("pq-profile"):
                prof = torch.zeros(10, dtype=torch.int64, device="cuda")
                call()
                torch.cuda.synchronize()
                _kernels.check(lib, lib.pq_topk_profile(prof.data_ptr()),
                               name)
                call()
                _kernels.check(lib, lib.pq_topk_profile(prof.data_ptr()),
                               name)
                p = prof.tolist()
                laps = ("copies", "decode", "mma", "filter", "bound",
                        "closing barrier")
                print(f"pq pool {pool} {name} phase clocks (a sweep block's "
                      f"cycles a tile, thread 0): " + ", ".join(
                          f"{k} {v / max(p[6], 1):.0f}"
                          for k, v in zip(laps, p[:6]))
                      + f"; {p[6]} tiles over {p[7]} blocks; a select "
                      f"block {p[8] / max(p[9], 1):.0f} cycles over "
                      f"{p[9]} blocks", flush=True)
                continue
            got[name] = time_ms(call, reps)
            if name == "pq-kernel" or name.startswith(("pq-refresh",
                                                        "pq-seed")):
                c = shape["counts"].double()
                over = int((c > shape["cap"]).any(dim=1).sum())
                print(f"pq pool {pool} {name} segments (S={shape['splits']}, rank "
                      f"{shape['rank']}, cap {shape['cap']}): mean "
                      f"{c.mean():.1f} rows, largest {c.max():.0f}, "
                      f"{c.sum(1).mean():.0f} rows a query, {over} of "
                      f"{qs.shape[0]} queries overflowed", flush=True)
                if pool == 32:
                    same = (shape["out_i"] == twin(pool)[1]).float().mean()
                    print(f"pq pool 32 ids equal to the twin's: {same:.5f}",
                          flush=True)
        got["wrapper"] = time_ms(lambda: cb.pq_topk(qs, codes, table, pool,
                                                    L2, N), reps)
        got["twin"] = time_ms(lambda: twin(pool), 1)
        got["library"] = time_ms(lambda: library(pool), 3)
        print(f"pq pool {pool}, B={qs.shape[0]}, G={codes.shape[1]}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in got.items()),
              flush=True)
    ms = time_ms(lambda: cb.pq_topk(qs, codes, table, 32, 2, N), reps)
    got = cb.pq_topk(qs, codes, table, 32, 2, N)
    want = twin(32, 2)
    same = (got[1] == want[1]).float().mean()
    print(f"pq pool 32, Manhattan: kernel {ms:.3f} ms, twin "
          f"{time_ms(lambda: twin(32, 2), 1):.3f} ms; ids equal to the "
          f"twin's: {same:.5f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--passes", type=int, default=2,
                    help="passes over the variants, every other reversed")
    ap.add_argument("--variants", help="comma-separated: time only these "
                    "(and build only what they and the counts need)")
    ap.add_argument("--before", help="an earlier tree's bruteforce_topk.cu, "
                    "built and timed beside the kernel at every shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    with open(SRC) as f:
        srcs = variants(f.read())
    l1_runs = ["kernel", *(k for k in srcs if k.startswith("l1-"))]
    runs = [("kernel", False), ("streamed-q", True), ("no-select", False),
            ("loads-only", False), ("wgmma-2", False), ("cvt-rounding", False),
            ("smem-lists", False), ("serial-select", False),
            ("no-shared-bound", False), ("bound-serial", False),
            ("bound-merge", False), ("unused-bound", False),
            *((f"serial-max-{n}", False) for n in SERIAL_MAX_TRIED)]
    pq_runs = ["pq-kernel", "pq-one-sum", "pq-no-select", "pq-no-decode", "pq-loads-only",
               "pq-profile", "pq-profile-conflicts",
               *(f"pq-refresh-{n}" for n in PQ_REFRESH_TRIED),
               *(f"pq-seed-{n}" for n in PQ_SEED_TRIED)]
    if args.variants:
        runs = [r for r in runs if r[0] in args.variants.split(",")]
        pq_runs = [r for r in pq_runs if r in args.variants.split(",")]
        l1_runs = [r for r in l1_runs if r in args.variants.split(",")]
    if args.before:
        with open(args.before) as f:
            srcs["before"] = f.read()
        runs.append(("before", False))
        l1_runs.append("before")
    with open(PQ_SRC) as f:
        pq_srcs = {k: v for k, v in pq_variants(f.read()).items()
                   if k in pq_runs}
    wanted = {"kernel" if name == "streamed-q" else name for name, _ in runs}
    # the count builds go with the row sweep's variants
    counted = {"count", "count-serial"} if wanted - {"before"} else set()
    srcs = {k: v for k, v in srcs.items()
            if k in wanted | set(l1_runs) | counted}
    jobs = [(k, v, _kernels.declare_sweep) for k, v in srcs.items()] + [
        (k, v, _kernels.declare_pq) for k, v in pq_srcs.items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip([j[0] for j in jobs],
                         ex.map(lambda j: build(*j), jobs)))
    libs = {k: built[k] for k in srcs}
    pq_libs = {k: built[k] for k in pq_srcs}
    for lib in pq_libs.values():
        if hasattr(lib, "pq_topk_profile"):
            lib.pq_topk_profile.argtypes = [ctypes.c_void_p]
            lib.pq_topk_profile.restype = ctypes.c_int
    # these differ from the kernel in the wide selection alone; all but
    # smem-lists and unused-bound (sweep_block's text) change the int8
    # Hopper instance's selection too
    wide_only = {"smem-lists", "serial-select", "no-shared-bound",
                 "bound-serial", "bound-merge", "unused-bound",
                 *(f"serial-max-{n}" for n in SERIAL_MAX_TRIED)}
    q8_hopper_too = wide_only - {"smem-lists", "unused-bound"}

    g = torch.Generator(device="cuda").manual_seed(12345)
    rows = torch.randn((N, D), generator=g, device="cuda")
    qs = torch.randn((1024, D), generator=g, device="cuda")
    book = torch.randn((PQ_GROUPS, 256, D // PQ_GROUPS), generator=g,
                       device="cuda")
    codes = torch.randint(0, 256, (N, PQ_GROUPS), generator=g,
                          device="cuda", dtype=torch.uint8)
    corpora = {"float32": rows, "bf16": rows.to(torch.bfloat16),
               "int8": quantize_rows(rows)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    best, worst = {}, {}
    for p in range(args.passes):
        order = runs[::-1] if p % 2 else runs
        for name, streamed in order:
            lib = libs["kernel" if name == "streamed-q" else name]
            for kind, b, k_run, force_qt, wide in SHAPES:
                q8_hopper = wide == "wgmma" and kind == "int8"
                if name in wide_only and wide is not True and not (
                        q8_hopper and name in q8_hopper_too):
                    continue
                # the Hopper instances: not in an earlier tree, one query
                # placement, and the only ones wgmma-2 changes
                if wide == "wgmma" and name in ("before", "streamed-q"):
                    continue
                if name == "wgmma-2" and (wide != "wgmma" or kind == "int8"):
                    continue
                q = qs[:b]
                call, shape = launcher(lib, corpora[kind], q, k_run, force_qt,
                                       wide, streamed, sms, stream)
                ms = time_ms(call, args.reps)
                key = (kind, b, k_run, force_qt, wide)
                best[key, name] = min(ms, best.get((key, name), ms))
                worst[key, name] = max(ms, worst.get((key, name), ms))
                note = ""
                if name in _EXACT and p == 0:
                    want = cb._bruteforce_topk_plain(q, corpora[kind], k_run,
                                                     L2, N)[1]
                    note = (f"; ids equal to the plain twin's: "
                            f"{(shape['out_i'] == want).float().mean():.4f}")
                print(f"{name:15s} {shape['name']:25s} B={b} k_run={k_run} "
                      f"QT={shape['qt']} S={shape['splits']} resident "
                      f"queries={shape['q_res']}: {ms:.3f} ms{note}",
                      flush=True)
    for key in dict.fromkeys(k for k, _ in best):
        kind, b, k_run, force_qt, wide = key
        if (key, "kernel") not in best or (key, "no-select") not in best:
            continue
        sel = best[key, "kernel"] - best[key, "no-select"]
        print(f"selection share, {kind} B={b} k_run={k_run} QT="
              f"{force_qt or 'auto'} {_path(wide)}: "
              f"kernel {best[key, 'kernel']:.3f} - no-select "
              f"{best[key, 'no-select']:.3f} = {sel:.3f} ms (best of "
              f"{args.passes} passes)", flush=True)
    # each variant's best and worst pass: the run-to-run spread
    for (key, name), ms in best.items():
        kind, b, k_run, force_qt, wide = key
        print(f"passes, {name:15s} {kind} B={b} k_run={k_run} QT="
              f"{force_qt or 'auto'} {_path(wide)}: "
              f"best {ms:.3f} ms, worst {worst[key, name]:.3f} ms",
              flush=True)
    for kind, b, k_run, force_qt, wide in SHAPES:
        if wide is True and "count" in libs:
            counts(libs, corpora[kind], qs[:b], k_run, force_qt, sms, stream)
    if l1_runs:
        l1_shapes({k: libs[k] for k in l1_runs}, corpora, qs, sms, stream,
                  args.passes,
                  widened_before="widened_bytes" in srcs.get("before", ""))
    if pq_libs:
        pq_error(pq_libs, sms, stream)
        pq_pools(pq_libs, codes, book, qs, sms, stream, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
