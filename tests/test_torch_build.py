"""The port's construction (core/build.py) against the JAX package's, step
by step on identical inputs: the pruning heuristic (ties and the unpruned
quirk included), the batch wiring, the int8 shadow, and one whole
insert_batch_core step in beam and exact8 mode from the same graph.

Links and counts must be identical: these inputs hold no float near-ties
except the deliberate exact ones, which both sides must break the same
way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu import HnswConfig as JaxConfig
from pg_embedding_tpu import HnswIndex as JaxIndex
from pg_embedding_tpu.core import build as jb
from pg_embedding_tpu_torch.convert import graph_from_numpy
from pg_embedding_tpu_torch.core import build as tb


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prune_inputs(seed, b=48, c=20, tie=True):
    rng = np.random.default_rng(seed)
    # coarse grid values make exact ties in both the query distances and
    # the pairwise matrix
    cand_d = (rng.integers(1, 12, size=(b, c)) / 4).astype(np.float32)
    cand_i = rng.permutation(5000)[: b * c].reshape(b, c).astype(np.int32)
    if not tie:
        cand_d += rng.random((b, c)).astype(np.float32) * 1e-2
    dead = rng.random((b, c)) < 0.2
    cand_i[dead] = -1
    cand_d[rng.random((b, c)) < 0.1] = np.inf
    # rows with few valid candidates exercise the unpruned path
    cand_i[: b // 4, 6:] = -1
    pair = (rng.integers(1, 12, size=(b, c, c)) / 4).astype(np.float32)
    pair = np.minimum(pair, pair.transpose(0, 2, 1))
    return cand_d, cand_i, pair


@pytest.mark.parametrize("seed,nn,tie", [(0, 6, True), (1, 8, True),
                                         (2, 6, False), (3, 16, True)])
def test_prune_heuristic(seed, nn, tie):
    cand_d, cand_i, pair = _prune_inputs(seed, tie=tie)
    jk, jc = jax.vmap(lambda d, i, p: jb._prune_heuristic(d, i, p, nn))(
        jnp.asarray(cand_d), jnp.asarray(cand_i), jnp.asarray(pair))
    tk, tc = tb._prune_heuristic(torch.from_numpy(cand_d),
                                 torch.from_numpy(cand_i),
                                 torch.from_numpy(pair), nn)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (tc.numpy() < nn).any()            # the unpruned path ran


def test_quantize_rows():
    """Against the compiled function, which is what the JAX index runs
    (XLA turns its /127 into a multiply by the reciprocal); bf16-valued
    rows put many codes at x.5, where an ulp of scale moves them."""
    rng = np.random.default_rng(5)
    v = (rng.normal(size=(2000, 24)) * 3).astype(np.float32)
    v[1000:] = np.asarray(jnp.asarray(v[1000:], jnp.bfloat16), np.float32)
    v[3] = 0.0
    jq, js = jax.jit(jb.quantize_rows)(jnp.asarray(v))
    tq, ts = tb.quantize_rows(torch.from_numpy(v))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def jax_graph():
    """A 600-node JAX-built graph (m=4, so maxM=8 fills and re-prunes)."""
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(600, 16)).astype(np.float32)
    idx = JaxIndex(JaxConfig(dims=16, m=4, ef_construction=24,
                             ef_search=24))
    idx.build(pts)
    return idx


def _torch_graph(idx):
    g = idx.graph
    return graph_from_numpy(g.vectors, g.links, g.link_counts, g.deleted,
                            idx.n_nodes)


def test_connect_batch(jax_graph):
    """Back-links with many per-target collisions and full targets."""
    cfg = jax_graph.config
    rng = np.random.default_rng(10)
    b, n_insert, base = 32, 29, jax_graph.n_nodes
    g = jax_graph.graph
    vectors = np.asarray(g.vectors).copy()
    vectors[base:base + b] = rng.normal(size=(b, cfg.dims))
    hubs = rng.choice(base, 12, replace=False)
    kept = np.stack([rng.choice(hubs, cfg.m, replace=False)
                     for _ in range(b)]).astype(np.int32)
    cnt = rng.integers(0, cfg.m + 1, b).astype(np.int32)
    jl, jc = jb._connect_batch(
        jnp.asarray(vectors), g.links, g.link_counts, jnp.int32(base),
        jnp.asarray(kept), jnp.asarray(cnt), jnp.int32(n_insert),
        m=cfg.m, max_m=cfg.max_m, metric_value=cfg.metric.value)
    tl = torch.from_numpy(np.asarray(g.links).copy())
    tc = torch.from_numpy(np.asarray(g.link_counts).copy())
    tb._connect_batch(torch.from_numpy(vectors), tl, tc, base,
                      torch.from_numpy(kept), torch.from_numpy(cnt),
                      n_insert, m=cfg.m, max_m=cfg.max_m,
                      metric_value=cfg.metric.value)
    assert (np.asarray(jc)[hubs] == cfg.max_m).any()   # re-prunes ran
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("mode", ["beam", "exact8", "exact"])
def test_insert_batch_core_step(jax_graph, mode):
    cfg = jax_graph.config
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(40, cfg.dims)).astype(np.float32)
    n_insert = 37
    g = jax_graph.graph
    base = jax_graph.n_nodes
    kw = dict(ef_construction=cfg.ef_construction, m=cfg.m,
              max_m=cfg.max_m, metric_value=cfg.metric.value,
              cand_cap=(cfg.ef_construction if mode == "beam"
                        else 2 * cfg.ef_construction),
              expand_width=4, candidates=mode)
    tg = _torch_graph(jax_graph)
    jkw, tkw = {}, {}
    if mode == "exact8":
        # the API's shadow: the live rows quantized, then the batch staged
        jqv, jqs = JaxIndex._quantize(g.vectors, jnp.int32(base))
        q, s = jb.quantize_rows(jnp.asarray(pts))
        jkw = dict(qvec=jax.lax.dynamic_update_slice(jqv, q, (base, 0)),
                   qscale=jax.lax.dynamic_update_slice(jqs, s, (base,)))
        tqv, tqs = tb.quantize_rows(torch.where(
            (torch.arange(tg.capacity) < base).unsqueeze(1), tg.vectors, 0.0))
        tqv[base:base + 40], tqs[base:base + 40] = tb.quantize_rows(
            torch.from_numpy(pts))
        tkw = dict(qvec=tqv, qscale=tqs)
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jkw["qvec"]))
    jg = jb.insert_batch_core(g._replace(n_nodes=jnp.int32(base)),
                              jnp.asarray(pts), jnp.int32(n_insert), **kw,
                              **jkw)
    tb.insert_batch_core(tg, torch.from_numpy(pts), n_insert, **kw, **tkw)
    assert tg.n_nodes == int(jg.n_nodes) == base + n_insert
    np.testing.assert_array_equal(tg.vectors.numpy(), np.asarray(jg.vectors))
    np.testing.assert_array_equal(tg.link_counts.numpy(),
                                  np.asarray(jg.link_counts))
    np.testing.assert_array_equal(tg.links.numpy(), np.asarray(jg.links))


def test_staging_past_capacity_raises(jax_graph):
    tg = _torch_graph(jax_graph)
    pts = torch.zeros((tg.capacity - tg.n_nodes + 1, tg.dims))
    with pytest.raises(ValueError, match="capacity"):
        tb.insert_batch_core(tg, pts, 1, ef_construction=8, m=4, max_m=8,
                             metric_value=0)


def test_build_schedule():
    assert tb.build_schedule(600, 256) == jb.build_schedule(600, 256)
    assert tb.build_schedule(0, 256) == []
