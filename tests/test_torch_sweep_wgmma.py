"""The Hopper instances of the exact sweep (csrc/bruteforce_topk.cu's
sweep_wgmma_kernel: bruteforce_topk_wgmma and bruteforce_topk_bf16_wgmma)
as far as the CPU reaches them: the rule that sends a launch to them
(ops/cuda_bruteforce._wgmma_route), their shared-memory figure and launch
shape against the kernel source's constants, and a paged call, whose pages
all keep the mma.sync instances.  The kernels themselves run on the card
only (tests/test_torch_cuda.py); their arithmetic order is emulated in
tests/test_torch_tf32_split.py."""

import os
import re

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

L2, COSINE, MANHATTAN = 0, 1, 2
F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8


def _source() -> str:
    return open(os.path.join(os.path.dirname(cb.__file__), "..", "csrc",
                             "bruteforce_topk.cu")).read()


def _corpus(dtype, dims, n=300):
    rng = np.random.default_rng(dims)
    rows = torch.from_numpy(rng.normal(size=(n, dims)).astype(np.float32))
    if dtype is I8:
        return (rows.to(I8), torch.ones(n))
    return rows.to(dtype)


def _expect(dtype, metric, k_run, dims, aligned=True, page=False):
    """The rule as its docstring states it: float32 / bf16 rows at k_run <
    WIDE_MIN_K, int8 rows at k_run <= WIDE_MAX_K (the build's pools: the
    int8 instance, tests/test_torch_sweep_q8_wgmma.py); L2 or cosine, D <=
    WGMMA_MAX_D, 16-byte rows and base, no page."""
    itemsize = {F32: 4, BF16: 2, I8: 1}[dtype]
    k_max = cb.WIDE_MAX_K if dtype is I8 else cb.WIDE_MIN_K - 1
    return (metric in (L2, COSINE)
            and k_run <= k_max and dims <= cb.WGMMA_MAX_D
            and dims * itemsize % 16 == 0 and aligned and not page)


@pytest.mark.parametrize("dtype", [F32, BF16, I8])
@pytest.mark.parametrize("metric", [L2, COSINE, MANHATTAN])
@pytest.mark.parametrize("k_run", [1, 12, 63, 64, 256, 257])
def test_route_by_dtype_metric_and_k(dtype, metric, k_run):
    """The Hopper instances take float32 / bf16 rows under L2 and cosine
    below WIDE_MIN_K, and int8 rows up to WIDE_MAX_K; every other launch
    keeps its instance as before."""
    pts = _corpus(dtype, 128)
    qs = torch.zeros((5, 128))
    name, wgmma = cb.launch_instance(qs, pts, k_run, metric)
    assert wgmma == _expect(dtype, metric, k_run, 128)
    if wgmma:
        assert name == cb._WGMMA_KERNELS[dtype]
    else:
        assert name == cb._instance(dtype, k_run,
                                    manhattan=metric == MANHATTAN)[0]
        assert "wgmma" not in name


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("dims", [4, 8, 30, 32, 96, 100, 128, 129, 136,
                                  256, 960])
def test_route_by_dims(dtype, dims):
    """D up to WGMMA_MAX_D in 16-byte rows (float32: D % 4 == 0, bf16: D %
    8 == 0); past the limit, or rows the copy engine cannot take (D = 30,
    bf16 at D = 100), the mma.sync instance."""
    pts = _corpus(dtype, dims)
    qs = torch.zeros((5, dims))
    name, wgmma = cb.launch_instance(qs, pts, 12, L2)
    assert wgmma == _expect(dtype, L2, 12, dims)
    assert name == (cb._WGMMA_KERNELS[dtype] if wgmma else cb._KERNELS[dtype])
    if dims > cb.WGMMA_MAX_D:
        assert not wgmma


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_route_unaligned_view_and_page(dtype):
    """A view that starts one element in, and a page of a paged call, take
    the mma.sync instance by the rule."""
    pts = _corpus(dtype, 128, n=301)
    qs = torch.zeros((5, 128))
    assert cb.launch_instance(qs, pts[:300], 12, L2)[1]
    off = pts.view(-1)[1:1 + 300 * 128].view(300, 128)
    assert off.data_ptr() % 16
    assert cb.launch_instance(qs, off, 12, L2) == (cb._KERNELS[dtype], False)
    assert cb.launch_instance(qs, pts, 12, COSINE, page=True) == (
        cb._KERNELS[dtype], False)
    assert not cb._wgmma_route(dtype, L2, 12, 128, True, True)
    assert not cb._wgmma_route(dtype, L2, 12, 128, False, False)
    assert cb._wgmma_route(dtype, COSINE, 63, 128, True, False)


def test_paged_call_keeps_one_path(monkeypatch):
    """k = 1030 goes in two pages, each with a floor, so the rule keeps
    both on the mma.sync instance (the pages concatenate only if every row
    scores the same in each); the pages still equal the twin's one list.
    A call at k_run 12 over the same rows would take the Hopper one."""
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.normal(size=(3000, 32)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    routes = []

    def recording(queries, points, k, metric, n_valid, deleted=None,
                  after=None):
        routes.append(cb.launch_instance(queries, points, k, metric,
                                         page=after is not None))
        return cb._bruteforce_topk_plain(queries, points, k, metric,
                                         n_valid, deleted, after)
    monkeypatch.setattr(cb, "bruteforce_topk", recording)
    got = cb.bruteforce_topk_paged(qs, pts, 1030, L2, 3000)
    assert routes == [("bruteforce_topk", False)] * 2
    want = cb._bruteforce_topk_plain(qs, pts, 1030, L2, 3000)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ids = got[1]
    assert all(len(set(r.tolist())) == 1030 for r in ids)    # no duplicate
    assert bool((ids >= 0).all())                             # no gap
    routes.clear()
    cb.bruteforce_topk_paged(qs, pts, 12, L2, 3000)
    assert routes == [("bruteforce_topk_wgmma", True)]


def _constants(src):
    return {m[0]: m[1] for m in re.findall(
        r"constexpr int (k\w+) = ([^;]+);", src)}


def test_wgmma_shape_mirrors_the_kernel_source():
    """The constants the Python figure is built from, read out of the
    source: the query tile, the limits, the score stride, the mbarriers'
    bytes, the stages by row type and a stage's bytes (the tensor copy's
    [128 x 32] box)."""
    src = _source()
    const = _constants(src)
    assert int(const["kWQT"]) == cb._WG_QT == 64
    assert int(const["kWMaxD"]) == cb.WGMMA_MAX_D
    assert int(const["kWMaxK"]) == cb.WIDE_MIN_K
    assert const["kWSStride"] == "kTileN + 4" and (
        cb._WG_SCORE_STRIDE == cb._TILE_N + 4)
    assert int(const["kWBarBytes"]) == cb._WG_BAR_BYTES
    assert int(const["kWScoreBufs"]) == cb._WG_SCORE_BUFS
    stages = re.search(r"constexpr int kWStages\(\) \{\s*return sizeof\(T\) "
                       r"== 4 \? (\d+) : (\d+);", src)
    assert (int(stages[1]), int(stages[2])) == (cb._WG_STAGES[4],
                                                cb._WG_STAGES[2])
    assert "return kTileN * kTileD * (int)sizeof(T);" in src
    # every mbarrier of the ring (full and empty, 8 bytes each) fits
    assert 2 * max(cb._WG_STAGES.values()) * 8 <= cb._WG_BAR_BYTES


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("dims", [4, 32, 100, 128])
@pytest.mark.parametrize("k_run", [1, 12, 63])
def test_wgmma_smem_bytes(itemsize, dims, k_run):
    """wgmma_smem_bytes term by term: the ring, the query hi and lo tiles
    (D in whole 32-dim chunks), two score tiles, |q|^2, the mbarriers, the
    lists; within a block at every shape the rule admits."""
    chunks = -(-dims // 32)
    want = (cb._WG_STAGES[itemsize] * 128 * 32 * itemsize
            + 2 * chunks * 32 * 64 * 4 + 2 * 64 * 132 * 4 + 64 * 4
            + cb._WG_BAR_BYTES + 8 * 64 * k_run)
    got = cb._smem_bytes(64, k_run, itemsize, dims, True, wgmma=True)
    assert got == want <= cb.SMEM_LIMIT


def test_wgmma_launch_shape_of_the_main_path():
    """1M rows, 128-d, B = 1024, k_run = 12: 16 query tiles of 64 with
    resident queries, one block an SM, 33 splits (four whole waves of 132
    SMs), 188,800 bytes of shared memory for float32 and bf16 rows alike
    (the bf16 ring has twice the stages of half the bytes)."""
    for itemsize in (4, 2):
        assert cb._launch_shape(1024, 1_000_000, 12, 132, itemsize, 128,
                                wgmma=True) == (64, 33, True, 188_800)
    # the rule's widest lists and rows still fit
    assert cb._launch_shape(1024, 1_000_000, 63, 132, 4, 128,
                            wgmma=True)[3] <= cb.SMEM_LIMIT
    # one query tile: as many splits as rows allow, up to the SMs
    assert cb._launch_shape(17, 100_000, 12, 132, wgmma=True)[1] == 49


def test_c_entry_refuses_what_the_rule_keeps_off():
    """The C launch refuses, rather than run, what the rule sends
    elsewhere: a floor, k_run from 64, D past 128, a query tile other than
    64, streamed queries, unaligned rows, Manhattan."""
    src = _source()
    start = src.index("int run_topk_wgmma(")
    body = src[start:src.index("const size_t smem = wgmma_smem_bytes",
                               start)]
    for cond in ("D > kWMaxD", "k_run >= kWMaxK", "qt != kWQT", "!q_res",
                 "floor_d != nullptr", "(D * sizeof(T)) % 16 != 0",
                 "reinterpret_cast<uintptr_t>(p) % 16 != 0",
                 "metric != kMetricL2 && metric != kMetricCosine"):
        assert cond in body, cond
