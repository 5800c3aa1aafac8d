"""The build's candidate sweep (core/build._exact_candidates) on the CPU:
the sweep kernel's plain twin (ops/cuda_bruteforce.sweep_pool, the pool
the card's one launch computes) plus the exact rerank, against the
torch-op chunk loop that the CPU runs, and both against the JAX package's
_exact_candidates (jitted, as its insert programs run it) on the same
numpy inputs; the int8 instance's element rule, launch shape and
operands; the count of torch-op sweeps on the card.

Tolerances: on random float data (no exact ties) the twin and the loop
give equal ids and distances; against JAX, distances at rtol 1e-6 (float32
sums in another order) and ids equal except float32 near-ties, judged in
float64 (within 1e-5 relative of each other).  On tie-heavy integer data
only distances are held to JAX (see test_ties_hold_distances_only)."""

import functools
import math
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.core import build as jb
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
from pg_embedding_tpu_torch.ops.bruteforce import _rerank_exact

L2, COSINE, MANHATTAN = 0, 1, 2
CAP, D, B, CAND_CAP, CHUNK = 3000, 16, 24, 64, 700
# base not a multiple of the chunk; under both pools (128 / 66); empty
BASES = {"ragged": 2345, "under keep": 50, "empty": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_inputs(seed=3):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(CAP, D)).astype(np.float32)
    pts = rng.normal(size=(B, D)).astype(np.float32)
    qv, qs = tb.quantize_rows(torch.from_numpy(rows))
    return rows, pts, qv.numpy(), qs.numpy()


def _port(rows, pts, qv, qs, base, metric, coarse, cand_cap=CAND_CAP,
          chunk=CHUNK):
    """(the twin's pool + the rerank, the chunk loop) on the CPU."""
    vectors, points = torch.from_numpy(rows), torch.from_numpy(pts)
    shadow = dict(qvec=torch.from_numpy(qv), qscale=torch.from_numpy(qs))
    keep = 2 * cand_cap if coarse else cand_cap + 2
    src = (shadow["qvec"], shadow["qscale"]) if coarse else vectors
    _, pool = cb.sweep_pool(points, src, keep, metric, base)
    twin = _rerank_exact(points, vectors, pool, k=cand_cap,
                         metric_value=metric)
    loop = tb._exact_candidates(vectors, points, base, cand_cap=cand_cap,
                                metric_value=metric, chunk=chunk,
                                **(shadow if coarse else {}))
    return twin, loop


def _jax(rows, pts, qv, qs, base, metric, coarse, cand_cap=CAND_CAP,
         chunk=CHUNK):
    fn = jax.jit(functools.partial(jb._exact_candidates, cand_cap=cand_cap,
                                   metric_value=metric, chunk=chunk))
    kw = dict(qvec=jnp.asarray(qv), qscale=jnp.asarray(qs)) if coarse else {}
    d, i = fn(jnp.asarray(rows), jnp.asarray(pts), jnp.int32(base), **kw)
    return np.asarray(d), np.asarray(i)


def _dist64(rows, pts, ids, metric):
    """float64 distances of each point to its rows ``ids`` (inf for -1)."""
    p = rows[np.maximum(ids, 0)].astype(np.float64)
    q = pts.astype(np.float64)[:, None, :]
    if metric == L2:
        d = np.sqrt(((p - q) ** 2).sum(-1))
    elif metric == MANHATTAN:
        d = np.abs(p - q).sum(-1)
    else:
        d = 1.0 - (p * q).sum(-1) / np.sqrt((p * p).sum(-1) * (q * q).sum(-1))
    return np.where(ids >= 0, d, np.inf)


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("coarse", [True, False], ids=["exact8", "exact"])
@pytest.mark.parametrize("metric", [L2, COSINE, MANHATTAN],
                         ids=["l2", "cosine", "manhattan"])
def test_twin_pool_equals_chunk_loop_and_jax(metric, coarse, base):
    rows, pts, qv, qs = _random_inputs()
    n = BASES[base]
    (td, ti), (ld, li) = _port(rows, pts, qv, qs, n, metric, coarse)
    np.testing.assert_array_equal(ti.numpy(), li.numpy())
    np.testing.assert_array_equal(td.numpy(), ld.numpy())
    jd, ji = _jax(rows, pts, qv, qs, n, metric, coarse)
    got_d, got_i = td.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(got_d[fin], jd[fin], rtol=1e-6, atol=1e-7)
    assert (got_i[~fin] == -1).all() and (ji[~fin] == -1).all()
    diff = got_i != ji
    a, b = _dist64(rows, pts, got_i, metric), _dist64(rows, pts, ji, metric)
    assert np.all(np.abs(a[diff] - b[diff]) <= 1e-5 * np.abs(b[diff]))
    if n == 0:
        assert (got_i == -1).all()
    else:
        valid = (got_i >= 0).sum(1)
        assert (valid == min(n, CAND_CAP)).all()
        assert (got_i < n).all()


@pytest.mark.parametrize("coarse", [True, False], ids=["exact8", "exact"])
@pytest.mark.parametrize("metric", [L2, COSINE, MANHATTAN],
                         ids=["l2", "cosine", "manhattan"])
def test_ties_hold_distances_only(metric, coarse):
    """6,000 x 16 rows with coordinates in [-2, 2]: the distance at every
    rank is shared by many rows.  The port keeps the lowest ids among
    equal scores (every top-k of the port does); JAX's approx_min_k on the
    CPU keeps its own order among equal values (not the lowest ids), so
    the chosen members of a tie group differ between the packages.  The
    distances at every rank must agree, and each side's ids must have the
    same multiset of true distances: the same tie groups, other members."""
    rng = np.random.default_rng(21)
    rows = rng.integers(-2, 3, size=(6000, 16)).astype(np.float32)
    pts = rng.integers(-2, 3, size=(32, 16)).astype(np.float32)
    qv, qs = (t.numpy() for t in tb.quantize_rows(torch.from_numpy(rows)))
    n = 5900
    (td, ti), (ld, li) = _port(rows, pts, qv, qs, n, metric, coarse,
                               chunk=2048)
    jd, ji = _jax(rows, pts, qv, qs, n, metric, coarse, chunk=2048)
    for d, i in ((td.numpy(), ti.numpy()), (ld.numpy(), li.numpy())):
        np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            np.sort(_dist64(rows, pts, i, metric), axis=1),
            np.sort(_dist64(rows, pts, ji, metric), axis=1),
            rtol=1e-6, atol=1e-7)
        assert (i >= 0).all() and (i < n).all()


def _bf16_rne(x):
    """float32 -> bf16 -> float32, to nearest even, by the kernel's integer
    rule (round_bf16 in csrc/bruteforce_topk.cu)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_widening_is_the_bf16_product_bit_for_bit():
    """The kernel's int8 element, round_bf16(float(q) * round_bf16(s)),
    rendered in numpy, against dequantize_rows (qvec.bf16 * qscale.bf16)
    over every int8 value and scales of many magnitudes, including ones
    whose low 16 bits sit at the rounding midpoint (ties to even) and the
    scales quantize_rows makes."""
    rng = np.random.default_rng(4)
    scales = np.concatenate([
        np.exp(rng.uniform(-30, 10, 3000)),
        (rng.integers(1 << 22, 1 << 30, 500).astype(np.uint32)
         & np.uint32(0xFFFF0000) | np.uint32(0x8000)).view(np.float32),
        tb.quantize_rows(torch.from_numpy(
            rng.normal(size=(500, 8)).astype(np.float32) * 3))[1].numpy(),
    ]).astype(np.float32)
    scales = scales[np.isfinite(scales) & (scales > 0)]
    q = np.arange(-128, 128, dtype=np.int8)
    qv = np.broadcast_to(q, (len(scales), 256)).copy()
    want = cb.dequantize_rows(torch.from_numpy(qv), torch.from_numpy(scales))
    got = _bf16_rne(qv.astype(np.float32) * _bf16_rne(scales)[:, None])
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.float().numpy().view(np.uint32))
    # the float32 product of the two bf16 values is exact: one rounding
    exact = qv.astype(np.float64) * _bf16_rne(scales)[:, None]
    assert np.array_equal(exact, qv.astype(np.float32)
                          * _bf16_rne(scales)[:, None])


def _c_smem_bytes(itemsize, qt, k_run, dims, q_res, manhattan=False):
    """sweep_smem_bytes<T, kL1> of csrc/bruteforce_topk.cu, term by term:
    two ring stages of [128 x (32 + 16 / itemsize)] elements (+ 128
    float32 scales for int8 rows, + a [QT x 36] float32 query chunk when
    queries stream), the Manhattan instances' widened [128 x 36] float32
    chunk over bf16 and int8 rows (widened_bytes<T, kL1>), the resident [QT
    x (32 ceil(D / 32) + 4)] queries, the [QT x 136] score tile, |q|^2,
    |p|^2 and the [QT x k_run] (score, id) lists."""
    stage = (128 * (32 + 16 // itemsize) * itemsize
             + (128 * 4 if itemsize == 1 else 0)
             + (0 if q_res else qt * 36 * 4))
    widened = 128 * 36 * 4 if manhattan and itemsize < 4 else 0
    q_stride = 32 * -(-dims // 32) + 4
    return (2 * stage + widened
            + 4 * ((qt * q_stride if q_res else 0) + qt * 136 + qt + 128)
            + 8 * qt * k_run)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("dims", [30, 128, 960])
def test_smem_bytes_match_the_kernel(itemsize, dims):
    """_smem_bytes against sweep_smem_bytes<T, kL1>, which every entry (the
    exact route's, the wide ones, the int8 one and the three Manhattan
    ones) reaches through run_topk: one figure for every L2 / cosine
    instance of a row type, and the Manhattan ones' (kL1) with the widened
    chunk over bf16 and int8 rows (the PQ kernel's own:
    tests/test_torch_pq_pool.py)."""
    src = open(os.path.join(os.path.dirname(cb.__file__), "..", "csrc",
                            "bruteforce_topk.cu")).read()
    assert ("stage_extra_bytes<T>() +" in src
            and "return scaled_rows<T>() ? kTileN * 4" in src
            and "return std::is_same<T, int8_t>::value;" in src
            and "return kStages * stage + widened_bytes<T, kL1>() +" in src
            and "return kL1 && !std::is_same<T, float>::value ? "
                "kTileN * kWStride * 4 : 0;" in src
            and "constexpr int kWStride = kTileD + 4;" in src)
    assert src.count("sweep_smem_bytes<T, kL1>(qt, k_run, D, q_res != 0)") == 1
    entries = src[src.index('extern "C" {'):]
    assert entries.count("return run_topk<") == 8
    for manhattan in (False, True):
        for qt in (64, 16):
            for k_run in (1, 130, 256, 1024):
                for q_res in (True, False):
                    assert cb._smem_bytes(qt, k_run, itemsize, dims, q_res,
                                          manhattan) == _c_smem_bytes(
                        itemsize, qt, k_run, dims, q_res, manhattan)
            for k_run in range(1, cb.MAX_K_RUN + 1, 7):
                _, _, _, smem = cb._launch_shape(256, 1_000_000, k_run, 132,
                                                 itemsize, dims,
                                                 manhattan=manhattan)
                assert smem <= cb.SMEM_LIMIT


def test_launch_shape_of_the_build_sweep():
    """One 256-row insert batch at 1M x 128-d: exact8's pool of 256 (QT =
    64, queries resident, one block an SM: 33 splits of 4 query tiles fill
    132 SMs once); exact mode's 130 over float32 rows; 960-d streams."""
    assert cb._launch_shape(256, 1_000_000, 256, 132, 1, 128) == (
        64, 33, True, 213_760)
    assert cb._launch_shape(256, 1_000_000, 130, 132, 4, 128) == (
        64, 33, True, 172_800)
    assert not cb._launch_shape(256, 1_000_000, 256, 132, 1, 960)[2]
    assert cb._launch_shape(256, 1_000_000, 257, 132, 1, 128)[0] == 16
    # Manhattan's over the shadow: the widened chunk still fits beside
    # the resident queries, one block an SM
    assert cb._launch_shape(256, 1_000_000, 256, 132, 1, 128,
                            manhattan=True) == (64, 33, True, 232_192)
    assert cb._blocks_per_sm(232_192) == 1


def test_sweep_pool_pages_past_one_launch():
    """keep past MAX_K_RUN (efc > 256) runs in pages that concatenate to
    the twin's one list, over the int8 shadow too."""
    rng = np.random.default_rng(6)
    rows = rng.normal(size=(4000, 12)).astype(np.float32)
    qv, qs = tb.quantize_rows(torch.from_numpy(rows))
    pts = torch.from_numpy(rng.normal(size=(5, 12)).astype(np.float32))
    for src in ((qv, qs), torch.from_numpy(rows)):
        for metric in (L2, COSINE):
            got = cb.sweep_pool(pts, src, 1500, metric, 3900)
            want = cb._bruteforce_topk_plain(pts, src, 1500, metric, 3900)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])


def test_wrapper_checks_the_shadow():
    qv = torch.zeros((100, 8), dtype=torch.int8)
    qs = torch.ones(100)
    pts = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="int8"):
        cb.bruteforce_topk(pts, (qv.float(), qs), 5, L2, 100)
    with pytest.raises(ValueError, match="qscale"):
        cb.bruteforce_topk(pts, (qv, qs[:99]), 5, L2, 100)
    with pytest.raises(ValueError, match="qscale"):
        cb.bruteforce_topk(pts, (qv, qs.double()), 5, L2, 100)
    with pytest.raises(ValueError, match="contiguous"):
        cb.bruteforce_topk(pts, (torch.zeros((8, 100), dtype=torch.int8).T,
                                 qs), 5, L2, 100)
    with pytest.raises(ValueError, match="contiguous"):
        cb.bruteforce_topk(pts, (qv, torch.ones(200)[::2]), 5, L2, 100)
    with pytest.raises(ValueError, match="shapes"):
        cb.bruteforce_topk(torch.zeros((2, 9)), (qv, qs), 5, L2, 100)
    with pytest.raises(ValueError, match="pair"):
        cb.bruteforce_topk(pts, (qv, qs, qs), 5, L2, 100)
    with pytest.raises(ValueError, match="L2, cosine or Manhattan"):
        cb.sweep_pool(pts, (qv, qs), 5, 3, 100)


@pytest.mark.parametrize("metric", [L2, COSINE, MANHATTAN])
@pytest.mark.parametrize("coarse", [True, False], ids=["exact8", "exact"])
def test_cpu_sweeps_are_not_counted(metric, coarse):
    """PLAIN_SWEEPS_ON_CARD counts torch-op sweeps on a CUDA tensor only;
    the CPU's loop is its route, not a fallback."""
    rows, pts, qv, qs = _random_inputs()
    before = tb.PLAIN_SWEEPS_ON_CARD
    _, loop = _port(rows, pts, qv, qs, 2345, metric, coarse) if (
        metric != MANHATTAN) else (None, tb._exact_candidates(
            torch.from_numpy(rows), torch.from_numpy(pts), 2345,
            cand_cap=CAND_CAP, metric_value=metric, chunk=CHUNK,
            **(dict(qvec=torch.from_numpy(qv), qscale=torch.from_numpy(qs))
               if coarse else {})))
    assert (loop[1] >= 0).all()
    assert tb.PLAIN_SWEEPS_ON_CARD == before


def test_sweep_probe_rewrites_find_their_text():
    """sweep_probe builds its variants by rewriting the sweep's source:
    each rewrite still finds its text in the source as it is."""
    from pg_embedding_tpu_torch import sweep_probe
    src = open(sweep_probe.SRC).read()
    got = sweep_probe.variants(src)
    assert got["kernel"] == src
    # no-select cuts the mma.sync instances' selection and the Hopper
    # instances' (the float32 / bf16 ones' and the int8 one's: their
    # selector warpgroups only hand the tiles back); loads-only also their
    # epilogue and mma's, and the Hopper wgmma's, TF32 and bf16
    assert got["no-select"].count("#if 0") == 3
    for begin in (sweep_probe._SELECTION, sweep_probe._W_SELECTION,
                  sweep_probe._W8_SELECTION):
        assert "#if 0\n" + begin in got["no-select"]
    assert got["loads-only"].count("#if 0") == 4
    assert "if (0) asm(\"mma.sync" in got["loads-only"]
    assert got["loads-only"].count("  if (0) asm volatile(") == 2
    assert ("if (0) asm volatile(\n      \"{\\n .reg .pred p;\\n setp.ne.b32 "
            "p, %37, 0;\\n\"\n      \" wgmma.mma_async.sync.aligned.m64n64k16"
            in got["loads-only"])
    assert "constexpr int kWGroupSteps = 2;" in got["wgmma-2"]
    assert "cvt.rna.tf32.f32" in got["cvt-rounding"]
    assert "if (false) {" in got["smem-lists"]
    assert "constexpr bool kReadBound = false;" in got["no-shared-bound"]
    assert "constexpr int kSerialMax = 8;" in got["no-shared-bound"]
    assert "constexpr bool kReadBound = false;" in got["serial-select"]
    assert "constexpr int kSerialMax = kRegK;" in got["serial-select"]
    for name, base in (("count", src), ("count-serial",
                                         got["serial-select"])):
        assert got[name].count("atomicAdd(&g_probe_counts") == 3
        assert got[name].index("__device__ unsigned g_probe_counts") < (
            got[name].index("namespace {"))
        assert 'extern "C" int probe_merge(' in got[name]
        assert 'extern "C" int probe_counts(' in got[name]
        assert got[name].startswith(base[:base.index("\nnamespace {")])
    assert "isnan(__shfl_sync(kFull, tau_mine, i))" in got["unused-bound"]
    for name, serial_max in (("bound-serial", "kRegK"), ("bound-merge", "0"),
                             *((f"serial-max-{n}", n)
                               for n in sweep_probe.SERIAL_MAX_TRIED)):
        assert "constexpr bool kReadBound = true;" in got[name]
        assert f"constexpr int kSerialMax = {serial_max};" in got[name]
    # Manhattan's: l1-no-select is no-select's text, timed at its shapes
    assert got["l1-no-select"] == got["no-select"]
    assert got["l1-loads-only"].count("#if 0") == 3
    assert "      if (false) l1_tile<QT>(" in got["l1-loads-only"]
    assert "  static constexpr int RG = 32;" in got["l1-tile-8x4"]
    assert "part(qv[i], c)," in got["l1-no-swap"]
    assert ("l1_load<QT>(q_s, qs, p_f, k0 + 4, qb, pb);" in got["l1-pipe"]
            and "__launch_bounds__(kThreads, 1)\nsweep_kernel_l1("
            in got["l1-pipe"])
    assert "(!kL1 || s < 1))\n      load_step" in got["l1-compute"]
    assert got["l1-compute"].count("#if 0") == 3
    assert got["l1-compute-no-barrier"].count("if (!kL1) __syncthreads();") == 2
    assert len({*got.values()}) + 1 == len(got) == (
        20 + len(sweep_probe.SERIAL_MAX_TRIED))
    # the PQ kernel's own variants
    pq_src = open(sweep_probe.PQ_SRC).read()
    pq = sweep_probe.pq_variants(pq_src)
    assert pq["pq-kernel"] == pq_src and len({*pq.values()}) == len(pq) == (
        7 + len(sweep_probe.PQ_REFRESH_TRIED) + len(sweep_probe.PQ_SEED_TRIED))
    assert "mma_bf16(part" not in pq["pq-one-sum"]
    assert pq["pq-one-sum"].count("mma_bf16(acc[mt][nt], a") == 2
    assert "tab[lane * kCodes + codes_s[r * kCS + o1]]" in pq[
        "pq-profile-conflicts"]
    for n in sweep_probe.PQ_SEED_TRIED:
        assert f"constexpr int kSeedTiles = {n};" in pq[f"pq-seed-{n}"]
    for n in sweep_probe.PQ_REFRESH_TRIED:
        assert f"constexpr int kRefresh = {n};" in pq[f"pq-refresh-{n}"]
    assert pq["pq-no-select"].count("if (false) {") == 1
    assert "tau = 0.f * tau_s[ql] - CUDART_INF_F" in pq["pq-no-select"]
    assert pq["pq-profile"] == "#define PG_PROFILE\n" + pq_src
    assert "uint32_t w = codes_s[r * kCS + o0];" in pq["pq-no-decode"]
    assert "if (0) asm(\"mma.sync" in pq["pq-loads-only"]
    assert "uint32_t w = codes_s[r * kCS + o0];" in pq["pq-loads-only"]
    assert pq["pq-loads-only"].count("if (false) {") == 1


# --- the wide selection: the bound shared across splits ---------------------

# (rows, k_run, splits, tile) of the split filter's model
FILTER_SHAPES = [(600, 16, 5, 8), (1000, 64, 33, 4), (2000, 130, 33, 16),
                 (300, 40, 7, 32)]


def _filter_scores(kind, shape, gen):
    """One query's scores f32[n]: normal; integers in {0, 1, 2}; all
    equal; {0, 1, 2} with 40% of the rows masked (+inf); all masked but a
    few rows, fewer than a pool; or "spread": the pool's least S floor(k_run
    / S) scores floor(k_run / S) at the head of each split, its rest at the
    tail of split 0 (a rank j with S j < k_run would bound those out)."""
    n, k_run, splits, tile = shape
    if kind == "spread":
        scores = 10 + torch.rand(n, generator=gen)
        top = torch.sort(torch.rand(k_run, generator=gen)).values
        per = tile * math.ceil(math.ceil(n / splits) / tile)
        j0, r = k_run // splits, 0
        for start in range(0, n, per):
            scores[start:start + j0] = top[r:r + j0]
            r += j0
        scores[per - (k_run - r):per] = top[r:]
        return scores
    if kind == "normal":
        return torch.randn(n, generator=gen)
    if kind == "all equal":
        return torch.zeros(n)
    scores = torch.randint(0, 3, (n,), generator=gen).float()
    if kind == "masked":
        scores[torch.rand(n, generator=gen) < 0.4] = float("inf")
    elif kind == "few live":
        keep = torch.randperm(n, generator=gen)[:9]
        scores = torch.full((n,), float("inf")).index_copy(0, keep,
                                                           scores[keep])
    return scores


@pytest.mark.parametrize("kind", ["normal", "ties 012", "all equal",
                                  "masked", "few live", "spread"])
@pytest.mark.parametrize("shape", FILTER_SHAPES,
                         ids=[f"n{n}-k{k}-s{s}-t{t}"
                              for n, k, s, t in FILTER_SHAPES])
def test_split_filter_gives_the_plain_pool(kind, shape):
    """The wide selection's bound shared across splits, modelled in torch
    (tests/split_filter.py): under random interleavings of the splits'
    tiles, bound reads fresh or stale by any number of publications, the
    merged partial lists equal the plain top k_run, on tie-heavy scores
    too."""
    from split_filter import plain_topk, split_filter
    n, k_run, splits, tile = shape
    gen = torch.Generator().manual_seed(zlib.crc32(repr((kind, shape))
                                                   .encode()))
    for trial in range(6):
        scores = _filter_scores(kind, shape, gen)
        want = plain_topk(scores, k_run)
        got = split_filter(scores, k_run, splits, tile, gen,
                           max_lag=None if trial % 2 else 0)
        assert got == want


def test_split_filter_needs_the_bound_inclusive():
    """All rows equal and a pool longer than a tile: once every split has
    published, the bound equals every score, so a bound test of score <
    bound (not <=) turns away rows of the true pool.  The model with the
    kernel's test gives the plain pool on every interleaving; the strict
    one does not."""
    from split_filter import plain_topk, split_filter
    scores = torch.zeros(400)
    want = plain_topk(scores, 16)
    assert [i for _, i in want] == list(range(16))
    gen = torch.Generator().manual_seed(5)
    wrong = 0
    for _ in range(10):
        assert split_filter(scores, 16, 4, 8, gen, max_lag=0) == want
        wrong += split_filter(scores, 16, 4, 8, gen, strict=True,
                              max_lag=0) != want
    assert wrong > 0


def test_shared_bound_arithmetic_over_the_launch_shapes():
    """For every launch _launch_shape makes that takes the bound (the int8
    instance up to WIDE_MAX_K, the wide float32 / bf16 ones from
    WIDE_MIN_K): the scratch is f32[B, S], the rank j = ceil(k_run / S) is
    the least with S j >= k_run (so S published j-th scores name k_run
    rows) and lies in [1, k_run], and the launch takes the query tile of 64
    that the wide instances exist at."""
    dtypes = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}
    for itemsize, dtype in dtypes.items():
        for b in (1, 63, 65, 256, 1024):
            for n_rows in (1, 2047, 131_075, 1_000_000):
                for k_run in range(1, cb.WIDE_MAX_K + 1):
                    qt, splits, _, _ = cb._launch_shape(b, n_rows, k_run, 132,
                                                        itemsize, 128)
                    if not cb._instance(dtype, k_run)[1]:
                        assert dtype != torch.int8 and k_run < cb.WIDE_MIN_K
                        continue
                    shape, j = cb._shared_bound(b, splits, k_run)
                    assert shape == (b, splits)
                    assert 1 <= j <= k_run
                    assert splits * j >= k_run > (j - 1) * splits
                    assert qt == 64


def test_wide_instances_serve_the_wide_lists_only():
    """The wrapper's choice of C entry by k_run: the int8 instance takes
    the bound up to WIDE_MAX_K (longer lists keep the shared-memory
    insertion); float32 / bf16 rows take the wide instances from
    WIDE_MIN_K to WIDE_MAX_K (the build's pools, the exact route's k from
    62), else the exact route's (its k_run = 12 among them)."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    assert cb._instance(i8, 1) == ("bruteforce_topk_q8", True)
    assert cb._instance(i8, 256) == ("bruteforce_topk_q8", True)
    assert cb._instance(i8, 257) == ("bruteforce_topk_q8", False)
    assert cb._instance(f32, 130) == ("bruteforce_topk_wide", True)
    assert cb._instance(f32, cb.WIDE_MIN_K) == ("bruteforce_topk_wide", True)
    assert cb._instance(bf16, 256) == ("bruteforce_topk_bf16_wide", True)
    assert cb._instance(f32, 12) == ("bruteforce_topk", False)
    assert cb._instance(bf16, cb.WIDE_MIN_K - 1) == ("bruteforce_topk_bf16",
                                                     False)
    assert cb._instance(f32, 257) == ("bruteforce_topk", False)
    assert set(cb.LAUNCHES) == {*cb._KERNELS.values(),
                                *cb._WGMMA_KERNELS.values(),
                                *cb._WIDE_KERNELS.values(),
                                *cb._L1_KERNELS.values(),
                                "bruteforce_topk_pq"}
    # a probe forces the float32 / bf16 choice; the int8 entry has one
    assert cb._instance(f32, 12, wide=True) == ("bruteforce_topk_wide", True)
    assert cb._instance(f32, 130, wide=False) == ("bruteforce_topk", False)
    assert cb._instance(i8, 256, wide=False) == ("bruteforce_topk_q8", True)


@pytest.mark.parametrize("dtype,k_run,tail", [
    (torch.int8, 256, "bound"), (torch.int8, 257, "none given"),
    (torch.float32, 130, "bound"), (torch.bfloat16, 64, "bound"),
    (torch.float32, 12, "no bound"), (torch.bfloat16, 300, "no bound")])
def test_entry_passes_the_bound_its_entry_takes(dtype, k_run, tail):
    """_entry, the one place that says which C entry a launch calls and
    what it passes for the shared bound: the scratch f32[B, S] of +inf and
    its rank where the entry shares one, (None, 0) for the int8 entry past
    WIDE_MAX_K, nothing for the exact route's entries (as
    _kernels.declare_sweep types them)."""
    b, splits = 5, 33
    name, scratch, args = cb._entry(dtype, k_run, b, splits, "cpu")
    assert name == cb._instance(dtype, k_run)[0]
    if tail == "bound":
        assert scratch.shape == (b, splits) and scratch.dtype == torch.float32
        assert bool(torch.isinf(scratch).all()) and bool((scratch > 0).all())
        assert args == (scratch.data_ptr(), -(-k_run // splits))
    else:
        assert scratch is None
        assert args == ((None, 0) if tail == "none given" else ())
