"""bfloat16 storage in the port against the JAX package, on the CPU: a
bf16-storage build, one insert step on a bf16 graph, the exact route over a
bf16 corpus (the kernel's plain twin, the Pallas kernel in interpret mode,
Manhattan's chunked sweep), and downcast_corpus.

Tolerances: stored rows are equal bit for bit (both round to nearest even);
after one insert step or a whole build, >= 95% of the node link rows are
identical (the near-tie rule of tests/test_torch_api.py: float32 sums in
another order move distances by an ulp, and the pruning heuristic over
bf16 rows, whose norms are bf16-rounded, flips at such near-ties); ids of the exact route are equal and
distances agree to rtol 1e-6 / atol 1e-6 (float32 sums of upcast rows in
another order; cosine's 1 - x cancels near 0);
against the Pallas kernel, distances to rtol 1e-4 (its bf16x3 split) and
ids equal except at near-ties within 1e-4 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu.core import build as jb
from pg_embedding_tpu.ops.pallas_bruteforce import pallas_exact_search
from pg_embedding_tpu_torch import HnswConfig, HnswIndex
from pg_embedding_tpu_torch.config import Metric
from pg_embedding_tpu_torch.convert import graph_from_numpy, index_from_numpy
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
from pg_embedding_tpu_torch.ops.bruteforce import exact_search

N, D, K = 1200, 16, 8
CFG = dict(dims=D, m=6, ef_construction=32, ef_search=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=3.0, size=(25, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 25, N)] +
           rng.normal(size=(N, D))).astype(np.float32)
    qs = (centers[rng.integers(0, 25, 32)] +
          rng.normal(size=(32, D))).astype(np.float32)
    return pts, qs


@pytest.mark.parametrize("metric", ["l2", "cosine", "manhattan"])
def test_bf16_build_matches_jax(data, metric):
    pts, qs = data
    cfg = dict(CFG, metric=metric)
    ji = JaxIndex(JaxConfig(**cfg), storage_dtype="bfloat16")
    ti = HnswIndex(HnswConfig(**cfg), device="cpu", storage_dtype="bfloat16")
    ji.build(pts)
    ti.build(pts)
    assert ti.graph.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(ti.graph.vectors.float().numpy(),
                                  np.asarray(ji.graph.vectors, np.float32))
    same = (ti.graph.links.numpy()[:N] ==
            np.asarray(ji.graph.links)[:N]).all(axis=1)
    assert same.mean() >= 0.95, same.mean()
    _, jl, _ = ji.search(qs, K, mode="graph")
    _, tl, _ = ti.search(qs, K, mode="graph")
    assert (tl == jl).all(axis=1).mean() >= 0.95
    jd, jl, jv = ji.search(qs, K, mode="exact")
    td, tl, tv = ti.search(qs, K, mode="exact")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_bf16_graph(data):
    pts, _ = data
    ji = JaxIndex(JaxConfig(**CFG), storage_dtype="bfloat16")
    ji.build(pts[:500])
    return ji.graph, ji.n_nodes


@pytest.mark.parametrize("mode", ["beam", "exact8", "exact"])
def test_insert_step_on_bf16_graph(data, jax_bf16_graph, mode):
    """One insert_batch_core step (jitted, as the JAX package runs it) from
    the same bf16 graph: rows stored in bf16, the batch's own distances in
    float32, gathered rows upcast."""
    pts, _ = data
    g, base = jax_bf16_graph
    new = pts[500:540] + 0.25
    kw = dict(ef_construction=CFG["ef_construction"], m=CFG["m"],
              max_m=2 * CFG["m"], metric_value=0,
              cand_cap=(32 if mode == "beam" else 64), expand_width=4,
              candidates=mode)
    tg = graph_from_numpy(g.vectors, g.links, g.link_counts, g.deleted, base)
    assert tg.vectors.dtype == torch.bfloat16
    jkw, tkw = {}, {}
    if mode == "exact8":
        jqv, jqs = JaxIndex._quantize(g.vectors, jnp.int32(base))
        q, s = jb.quantize_rows(jnp.asarray(new))
        jkw = dict(qvec=jax.lax.dynamic_update_slice(jqv, q, (base, 0)),
                   qscale=jax.lax.dynamic_update_slice(jqs, s, (base,)))
        tqv, tqs = HnswIndex._quantize(tg.vectors, base)
        tqv[base:base + 40], tqs[base:base + 40] = tb.quantize_rows(
            torch.from_numpy(new))
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jkw["qvec"]))
        tkw = dict(qvec=tqv, qscale=tqs)
    step = jax.jit(functools.partial(jb.insert_batch_core, **kw))
    jg = step(g._replace(n_nodes=jnp.int32(base)), jnp.asarray(new),
              jnp.int32(37), **jkw)
    tb.insert_batch_core(tg, torch.from_numpy(new), 37, **kw, **tkw)
    np.testing.assert_array_equal(tg.vectors.float().numpy(),
                                  np.asarray(jg.vectors, np.float32))
    n = base + 37
    assert tg.n_nodes == int(jg.n_nodes) == n
    same = (tg.links.numpy()[:n] == np.asarray(jg.links)[:n]).all(axis=1)
    assert same.mean() >= 0.95, same.mean()


def test_kernel_twin_takes_bf16_rows(data):
    """The wrapper on a bf16 corpus (the plain twin here) computes what it
    computes on the float32 upcast of the same rows."""
    pts, qs = data
    bf = torch.from_numpy(pts).to(torch.bfloat16)
    q = torch.from_numpy(qs)
    dead = torch.zeros(N, dtype=torch.bool)
    dead[::9] = True
    before = dict(cb.LAUNCHES)
    for metric in (0, 1):
        got = cb.bruteforce_topk(q, bf, 12, metric, 1000, dead)
        want = cb._bruteforce_topk_plain(q, bf.float(), 12, metric, 1000,
                                         dead)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cb.LAUNCHES == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cb.bruteforce_topk(q, bf.half(), 12, 0, N)
    with pytest.raises(ValueError, match="queries must be float32"):
        cb.bruteforce_topk(q.to(torch.bfloat16), bf, 12, 0, N)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE])
def test_exact_route_matches_pallas_on_bf16(data, metric):
    pts, qs = data
    bf = torch.from_numpy(pts).to(torch.bfloat16)
    deleted = np.zeros(N, bool)
    deleted[::13] = True
    td, ti = cb.fused_exact_search(qs, bf, K, metric, n_valid=1100,
                                   deleted=torch.from_numpy(deleted))
    jd, ji = pallas_exact_search(qs, jnp.asarray(pts, jnp.bfloat16), K,
                                 metric.value, n_valid=1100, deleted=deleted,
                                 tile_n=128)
    td, ti, jd, ji = td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    diff = ti != ji
    assert np.all(np.abs(td[diff] - jd[diff]) <= 1e-4 * np.abs(jd[diff]))
    assert not np.isin(ti, np.nonzero(deleted)[0]).any()
    assert (ti < 1100).all()


def test_manhattan_sweep_upcasts_per_chunk(data):
    pts, qs = data
    bf = torch.from_numpy(pts).to(torch.bfloat16)
    got = exact_search(qs, bf, K, Metric.MANHATTAN, chunk=100)
    want = exact_search(qs, bf.float(), K, Metric.MANHATTAN, chunk=100)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_downcast_matches_jax(data, tmp_path):
    """downcast_corpus on the same f32-built graph in both packages: the
    same ids afterwards, the shadows kept, later inserts and a save/load
    round trip in the narrow dtype."""
    pts, qs = data
    ji = JaxIndex(JaxConfig(**CFG), packed_traversal=True,
                  packed_dtype="float32")
    ji.build(pts[:1000])
    g = ji.graph
    ti = index_from_numpy(HnswConfig(**CFG), g.vectors, g.links,
                          g.link_counts, g.deleted, ji.n_nodes, ji.labels,
                          packed_traversal=True, packed_dtype="float32")
    ji._ensure_packed()
    pc, _ = ti._ensure_packed()
    qv, _ = ti._ensure_quantized()
    for idx in (ji, ti):
        idx.downcast_corpus("bfloat16")
        idx.downcast_corpus("bfloat16")            # a no-op the second time
        assert idx.storage_dtype == "bfloat16"
    assert ti.graph.vectors.dtype == torch.bfloat16
    assert ti._pcodes is pc and ti._qvec is qv     # shadows are kept
    np.testing.assert_array_equal(ti.graph.vectors.float().numpy(),
                                  np.asarray(ji.graph.vectors, np.float32))
    for mode in ("graph", "exact"):
        _, jl, _ = ji.search(qs, K, mode=mode)
        _, tl, _ = ti.search(qs, K, mode=mode)
        np.testing.assert_array_equal(tl, jl)
    with pytest.raises(ValueError, match="cannot widen"):
        ti.downcast_corpus("float32")
    with pytest.raises(ValueError, match="unknown downcast"):
        ti.downcast_corpus("int8")
    for idx in (ji, ti):
        idx.add(pts[1000:], np.arange(1000, N))
    np.testing.assert_array_equal(ti.graph.links.numpy()[:N],
                                  np.asarray(ji.graph.links)[:N])
    ti.save(str(tmp_path / "dc"))
    back = HnswIndex.load(str(tmp_path / "dc"), device="cpu")
    assert back.storage_dtype == "bfloat16"
    assert back.graph.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.search(qs, K, mode="graph")[1],
                                  ji.search(qs, K, mode="graph")[1])
