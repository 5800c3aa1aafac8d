"""The int8 Hopper instance of the build's sweep (csrc/bruteforce_topk.cu's
sweep_q8_wgmma_kernel: bruteforce_topk_q8_wgmma) as far as the CPU reaches
it: the rule that sends a launch there (ops/cuda_bruteforce._wgmma_route),
its shared-memory figure and launch shape against the kernel source's
constants, and its arithmetic emulated in numpy.

The kernel scores on bf16 wgmma: the int8 row element bf16(bf16(q) *
bf16(scale)) is a bf16 value, and each query is split by truncation into
three bf16 parts, x = hi + mid + lo exactly (split3_bf16, as
csrc/pq_topk.cu's split3).  A k16 step takes the lo, mid and hi passes in
turn; its step pairs a thread's eight consecutive int8 dims with the
wgmma columns (w8_q_offset).  The emulation multiplies the bf16 values
exactly and adds each pass's 16 exact products into a float32
accumulator, as the tensor cores do.  The bar is the Pallas kernel's bf16
x 3 split, 2^-18 of |q| |p| on a product; one bf16 pass (the JAX
package's coarse exact8 form, the query rounded to bf16) misses it.  The
kernel itself runs on the card only (tests/test_torch_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch.core.build import quantize_rows
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

from test_torch_tf32_split import clustered

L2, COSINE, MANHATTAN = 0, 1, 2
I8 = torch.int8
BAR = 2.0 ** -18


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source() -> str:
    return open(os.path.join(os.path.dirname(cb.__file__), "..", "csrc",
                             "bruteforce_topk.cu")).read()


def _shadow(n, dims, seed=0):
    rng = np.random.default_rng(seed + dims)
    return quantize_rows(torch.from_numpy(
        rng.normal(size=(n, dims)).astype(np.float32)))


# --- the rule ---------------------------------------------------------------

@pytest.mark.parametrize("metric", [L2, COSINE, MANHATTAN])
@pytest.mark.parametrize("k_run", [1, 63, 64, 130, 256, 257])
def test_route_by_metric_and_k(metric, k_run):
    """int8 rows under L2 / cosine up to WIDE_MAX_K take the Hopper
    instance; a pool past it keeps bruteforce_topk_q8, Manhattan keeps
    bruteforce_topk_q8_l1."""
    shadow = _shadow(300, 128)
    qs = torch.zeros((5, 128))
    got = cb.launch_instance(qs, shadow, k_run, metric)
    if metric == MANHATTAN:
        assert got == ("bruteforce_topk_q8_l1", False)
    elif k_run <= cb.WIDE_MAX_K:
        assert got == ("bruteforce_topk_q8_wgmma", True)
        assert cb._instance(I8, k_run, wgmma=True) == (
            "bruteforce_topk_q8_wgmma", True)
    else:
        assert got == ("bruteforce_topk_q8", False)


@pytest.mark.parametrize("dims", [16, 32, 64, 96, 100, 128, 136, 960])
def test_route_by_dims(dims):
    """D up to WGMMA_MAX_D in whole 16-byte rows (D % 16 == 0) takes the
    Hopper instance; D = 100, 136 and 960 keep bruteforce_topk_q8."""
    shadow = _shadow(300, dims)
    qs = torch.zeros((5, dims))
    name, wgmma = cb.launch_instance(qs, shadow, 256, L2)
    assert wgmma == (dims % 16 == 0 and dims <= cb.WGMMA_MAX_D)
    assert name == ("bruteforce_topk_q8_wgmma" if wgmma
                    else "bruteforce_topk_q8")


def test_route_views_and_page():
    """A shard's view of a stacked shadow takes the Hopper instance where
    its rows and scales start 16-byte aligned; a view one byte in, scales
    one float in, and a page of a paged call keep bruteforce_topk_q8."""
    qv, qs = _shadow(3 * 512, 128)
    qv, qs = qv.view(3, 512, 128), qs.view(3, 512)
    q = torch.zeros((5, 128))
    for s in range(3):
        assert cb.launch_instance(q, (qv[s], qs[s]), 256, L2)[1]
    flat_v, flat_s = qv.view(-1), qs.view(-1)
    off_rows = (flat_v[1:1 + 500 * 128].view(500, 128), flat_s[:500])
    off_scales = (flat_v[:500 * 128].view(500, 128), flat_s[1:501])
    for view in (off_rows, off_scales):
        assert (view[0].data_ptr() % 16) or (view[1].data_ptr() % 16)
        assert cb.launch_instance(q, view, 256, L2) == (
            "bruteforce_topk_q8", False)
    assert cb.launch_instance(q, (qv[0], qs[0]), 256, COSINE, page=True) == (
        "bruteforce_topk_q8", False)
    assert not cb._wgmma_route(I8, L2, 256, 128, True, True)
    assert not cb._wgmma_route(I8, L2, 256, 128, False, False)
    assert cb._wgmma_route(I8, COSINE, 256, 128, True, False)
    assert not cb._wgmma_route(I8, COSINE, 257, 128, True, False)


def test_entry_takes_the_shared_bound():
    """The Hopper int8 entry runs the wide selection: its launch allocates
    the bound f32[B, S] of +inf and passes (scratch, rank ceil(k_run /
    S)) before the stream, as bruteforce_topk_q8's."""
    name, scratch, tail = cb._entry(I8, 256, 256, 33, "cpu", wgmma=True)
    assert name == "bruteforce_topk_q8_wgmma"
    assert tuple(scratch.shape) == (256, 33)
    assert bool(torch.isinf(scratch).all())
    assert tail == (scratch.data_ptr(), 8)
    # the float32 / bf16 Hopper entries take none
    for dtype in (torch.float32, torch.bfloat16):
        assert cb._entry(dtype, 12, 1024, 33, "cpu", wgmma=True)[1:] == (
            None, ())


# --- shared memory and the launch shape -------------------------------------

def _constants(src):
    return {m[0]: m[1] for m in re.findall(
        r"constexpr int (k\w+) = ([^;]+);", src)}


def test_q8_wgmma_shape_mirrors_the_kernel_source():
    """The constants the Python figure is built from, read out of the
    source (as test_wgmma_shape_mirrors_the_kernel_source reads the float32
    / bf16 instances'): the list limit, the stages and a stage's bytes
    (the int8 [128 x 32] box and the tile's scales), the query parts, the
    selector warps' staging, and the smem function's terms."""
    src = _source()
    const = _constants(src)
    assert const["kWQ8MaxK"] == "kRegK" and int(const["kRegE"]) * 32 == (
        cb.WIDE_MAX_K)
    assert int(const["kWQ8Stages"]) == cb._WG_STAGES[1]
    assert const["kWQ8ScaleBytes"] == "kTileN * 4"
    assert const["kWQ8StageBytes"] == "kTileN * kTileD + kWQ8ScaleBytes"
    assert int(const["kWQ8Parts"]) == cb._WG_Q8_PARTS == 3
    assert int(const["kWQ8StageWords"]) == cb._WG_Q8_STAGE_WORDS
    assert int(const["kWQ8SelectorWarps"]) == cb._WG_Q8_SELECTOR_WARPS
    body = src[src.index("size_t q8_wgmma_smem_bytes("):]
    body = body[:body.index("\n}\n")]
    for term in ("(size_t)kWQ8Stages * kWQ8StageBytes",
                 "(size_t)kWQ8Parts * chunks * kTileD * kWQT * 2",
                 "(size_t)kWQT * kWSStride * 4", "kWQT * 4", "kWBarBytes",
                 "(size_t)kWQ8SelectorWarps * kWQ8StageWords * 4",
                 "(size_t)8 * kWQT * k_run"):
        assert term in body, term
    # every mbarrier of the ring (full and empty, 8 bytes each) fits
    assert 2 * cb._WG_STAGES[1] * 8 <= cb._WG_BAR_BYTES


@pytest.mark.parametrize("dims", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("k_run", [1, 63, 64, 130, 256])
def test_q8_wgmma_smem_bytes(dims, k_run):
    """q8_wgmma_smem_bytes term by term, within a block at every shape the
    rule admits: 230,272 bytes at the build's (k_run 256, D 128)."""
    chunks = -(-dims // 32)
    want = (3 * (128 * 32 + 128 * 4) + 3 * chunks * 32 * 64 * 2
            + 64 * 132 * 4 + 64 * 4 + 128 + 8 * 64 * 4 + 8 * 64 * k_run)
    got = cb._smem_bytes(64, k_run, 1, dims, True, wgmma=True)
    assert got == want <= cb.SMEM_LIMIT
    if (dims, k_run) == (128, 256):
        assert got == 230_272


def test_q8_wgmma_launch_shape_of_the_build():
    """One 256-row insert batch at 1M rows, pool 256: 4 query tiles of 64
    with resident queries, 33 splits, 132 blocks, one wave of 132 SMs."""
    qt, splits, q_res, smem = cb._launch_shape(256, 1_000_000, 256, 132, 1,
                                               128, wgmma=True)
    assert (qt, splits, q_res, smem) == (64, 33, True, 230_272)
    assert -(-256 // qt) * splits == 132
    # the bound's rank: 33 slots of the 8th score name 264 >= 256 rows
    assert cb._shared_bound(256, splits, 256) == ((256, 33), 8)


def test_c_entry_refuses_what_the_rule_keeps_off():
    """The C launch refuses, rather than run, what the rule sends
    elsewhere: k_run past kWQ8MaxK, D past 128 or not in 16-byte rows,
    unaligned rows or scales, a floor, Manhattan, a bound rank j with S j
    < k_run."""
    src = _source()
    start = src.index("int run_topk_q8_wgmma(")
    body = src[start:src.index("const size_t smem = q8_wgmma_smem_bytes",
                               start)]
    for cond in ("D > kWMaxD", "k_run > kWQ8MaxK", "qt != kWQT", "!q_res",
                 "floor_d != nullptr", "D % 16 != 0", "scale == nullptr",
                 "reinterpret_cast<uintptr_t>(p) % 16 != 0",
                 "reinterpret_cast<uintptr_t>(scale) % 16 != 0",
                 "metric != kMetricL2 && metric != kMetricCosine",
                 "(long long)S * bound_rank < k_run"):
        assert cond in body, cond


# --- the arithmetic ---------------------------------------------------------

def split3(x):
    """split3_bf16 in numpy: truncation to the top 16 bits, three times."""
    x = np.asarray(x, np.float32)
    keep = np.uint32(0xFFFF0000)
    hi = (x.view(np.uint32) & keep).view(np.float32)
    r = (x - hi).astype(np.float32)
    mid = (r.view(np.uint32) & keep).view(np.float32)
    lo = (r - mid).astype(np.float32)
    return hi, mid, lo


def is_bf16(x):
    return not (np.asarray(x, np.float32).view(np.uint32) & 0xFFFF).any()


def q8_steps(dims):
    """The kernel's k16 steps: step s of 32-dim chunk c takes, for wgmma
    columns 2t + e and 2t + 8 + e (t < 4, e < 2), dims 32 c + 8 t + 4 s + e
    and 32 c + 8 t + 4 s + 2 + e (a thread's 8 consecutive int8 dims of a
    row), as w8_q_offset lays the query tiles out; past D zero."""
    chunks = -(-dims // 32)
    return [[32 * c + 8 * t + 4 * s + e for t in range(4) for e in (0, 1)]
            + [32 * c + 8 * t + 4 * s + 2 + e for t in range(4)
               for e in (0, 1)]
            for c in range(chunks) for s in range(2)]


def w8_q_offset(n, d):
    """csrc/bruteforce_topk.cu's w8_q_offset (64 queries a tile)."""
    c, r = d // 32, d % 32
    return (((c * 2 + (r & 7) // 4) * 2 + (r & 3) // 2) * 64 + n) * 8 + (
        2 * (r // 8) + (r & 1))


def test_steps_cover_every_dim_once_in_the_tile_layout():
    """q8_steps and w8_q_offset agree: column k of step (c, s) is element k
    % 8 of K-half k // 8 of the step's 2 KB, for every query; every dim
    appears once."""
    dims = 128
    steps = q8_steps(dims)
    assert sorted(d for step in steps for d in step) == list(range(dims))
    for i, step in enumerate(steps):
        for k, d in enumerate(step):
            for n in (0, 5, 63):
                assert w8_q_offset(n, d) == (
                    ((i * 2 + k // 8) * 64 + n) * 8 + k % 8)


def test_split3_is_exact():
    """hi + mid + lo == x bit for bit, each part a bf16 value, over the
    bench recipe's points, zeros and extreme values (from 2^-100 to the
    largest float32, signed)."""
    pts, qs = clustered(4000, 256)
    rng = np.random.default_rng(5)
    extremes = np.concatenate([
        np.float32([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).max,
                    -np.finfo(np.float32).max, 2.0 ** -100, -(2.0 ** -100),
                    1e-30, 3.0e38, 1 + 2.0 ** -23]),
        (rng.uniform(-1, 1, 4000) * np.exp2(rng.integers(-100, 127, 4000))
         ).astype(np.float32)])
    for x in (pts.ravel(), qs.ravel(), extremes):
        hi, mid, lo = split3(x)
        assert is_bf16(hi) and is_bf16(mid) and is_bf16(lo)
        total = (hi.astype(np.float64) + mid.astype(np.float64)
                 + lo.astype(np.float64))
        assert np.array_equal(total, x.astype(np.float64))
        # summed in the kernel's order, lo + mid + hi, in float32: exact,
        # bit for bit but the sign of a zero (-0 splits into -0 + 0 + 0)
        again = ((lo + mid).astype(np.float32) + hi).astype(np.float32)
        nz = x != 0
        assert np.array_equal(again.view(np.uint32)[nz],
                              x.view(np.uint32)[nz])
        assert not again[~nz].any()


def q8_dot(q, rows, passes):
    """q . rows as the kernel computes it: rows bf16 values (exact), each
    query split by split3, per k16 step (q8_steps) the lo, mid and hi
    passes (passes=1: bf16(q) alone, rounded to nearest even: the JAX
    coarse form), each pass's 16 exact products added into a float32
    accumulator."""
    dims = q.shape[1]
    pad = -(-dims // 32) * 32 - dims
    q = np.pad(q, ((0, 0), (0, pad)))
    rows = np.pad(rows, ((0, 0), (0, pad)))
    if passes == 1:
        parts = [torch.from_numpy(q).to(torch.bfloat16).float().numpy()]
    else:
        hi, mid, lo = split3(q)
        parts = [lo, mid, hi]
    acc = np.zeros((len(q), len(rows)), np.float32)
    for step in q8_steps(dims):
        r64 = rows[:, step].astype(np.float64)
        for part in parts:
            acc += (part[:, step].astype(np.float64) @ r64.T).astype(
                np.float32)
    return acc


def _dequantized(qv, qs):
    return cb.dequantize_rows(qv, qs).float().numpy()


def test_three_passes_meet_the_bar_and_one_misses():
    """On the bench recipe's points as the int8 shadow's rows, with the
    recipe's queries: the three passes' product differs from float64 by at
    most 2^-18 of |q| |p|; one bf16 pass (the JAX package's coarse exact8
    form) by far more."""
    pts, qs = clustered(3000, 64)
    rows = _dequantized(*quantize_rows(torch.from_numpy(pts)))
    assert is_bf16(rows)
    ref = qs.astype(np.float64) @ rows.astype(np.float64).T
    scale = (np.linalg.norm(qs.astype(np.float64), axis=1)[:, None]
             * np.linalg.norm(rows.astype(np.float64), axis=1)[None, :])
    errs = {p: float(np.max(np.abs(q8_dot(qs, rows, p) - ref) / scale))
            for p in (1, 3)}
    assert errs[3] <= BAR < errs[1], errs
    assert errs[1] > 16 * BAR


def _emulated_pool(qs, qv, qsc, keep, metric):
    """The kernel's pool from the emulated scores: |p|^2 and |q|^2 in
    float32, the score max(|p|^2 + |q|^2 - 2 q.p, 0) (cosine 1 - q.p
    rsqrt(|p|^2 |q|^2)), the keep least by (score, id), L2 sqrt'd."""
    rows = _dequantized(qv, qsc)
    dot = q8_dot(qs, rows, 3)
    pn = np.sum(rows * rows, axis=1, dtype=np.float32)[None, :]
    qn = np.sum(qs * qs, axis=1, dtype=np.float32)[:, None]
    if metric == L2:
        score = np.maximum(pn + qn - np.float32(2) * dot, 0).astype(
            np.float32)
    else:
        score = (1 - dot / np.sqrt(np.maximum(pn * qn, 1e-30))).astype(
            np.float32)
    order = np.lexsort((np.broadcast_to(np.arange(len(rows)), score.shape),
                        score), axis=1)[:, :keep]
    d = np.take_along_axis(score, order, axis=1)
    return (np.sqrt(d) if metric == L2 else d), order


@pytest.mark.parametrize("metric", [L2, COSINE])
def test_emulated_pool_equals_the_twin(metric):
    """The pool of 256 from the emulated scores equals the plain twin's
    (_bruteforce_topk_plain over the dequantised rows), ids but where the
    two rows' float64 distances lie within 1e-5 relative, distances at
    rtol 1e-5."""
    pts, qs = clustered(3000, 48, seed=metric + 3)
    qv, qsc = quantize_rows(torch.from_numpy(pts))
    d, ids = _emulated_pool(qs, qv, qsc, 256, metric)
    want_d, want_i = cb._bruteforce_topk_plain(torch.from_numpy(qs),
                                               (qv, qsc), 256, metric, 3000)
    want_d, want_i = want_d.numpy(), want_i.numpy()
    np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)
    rows = _dequantized(qv, qsc).astype(np.float64)
    q64 = qs.astype(np.float64)

    def d64(i):
        p = rows[i]
        if metric == L2:
            return np.sqrt(((p - q64[:, None]) ** 2).sum(-1))
        return 1 - (p * q64[:, None]).sum(-1) / np.sqrt(
            (p * p).sum(-1) * (q64 * q64).sum(-1)[:, None])
    diff = ids != want_i
    assert diff.mean() < 0.01
    a, b = d64(ids), d64(want_i)
    assert np.all(np.abs(a[diff] - b[diff]) <= 1e-5 * np.abs(b[diff]))
