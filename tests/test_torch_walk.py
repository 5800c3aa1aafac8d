"""The walk and prune kernels' semantics, held on the CPU (ops/cuda_graph:
beam_walk and prune_scan run on the card only; on the CPU each wrapper runs
its plain twin).

  * An integer-coordinate fixture: rows and queries drawn by numpy from a
    seed as integers in [-8, 8], D = 32, 3,000 rows, built by the port on
    the CPU.  Every L2 and Manhattan distance is then exact in float32
    whatever the summation order, and exact ties are frequent, so the tie
    order is exercised.  On it the port's search_graph equals the JAX
    package's bit for bit: ids, distances, hops and dist_evals.  Cosine is
    held as tests/test_torch_search.py holds it (>= 99% of queries equal,
    every other one at a near-tie).
  * core/search.walk_route: which walks go to the kernel.
  * ops/cuda_graph._walk_layout / _walk_wide_words: the walk block's
    shared memory, the sizes of its dedupe tables, and the wide walks'
    device memory a query (the held bits, the queues where they leave
    shared memory) (tests/test_torch_schedules.py holds the tables' rule
    and the wide schedule).
  * core/build._prune_scan_plain: reading pair_d through the sort order
    equals scanning the gathered matrix.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.core.graph import GraphState as JaxGraph
from pg_embedding_tpu.core.search import search_graph as jax_search
from pg_embedding_tpu_torch.convert import graph_from_numpy
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.core import search as ts
from pg_embedding_tpu_torch.ops import cuda_graph as cg
# the integer fixture and the prune's candidate sets, shared with the card
# tests (that file imports no JAX)
from test_torch_cuda import METRICS, QUEUES, D, integer_graph, prune_case
from walk_operands import integer_operands
from test_torch_search import _near_tie


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["l2", "manhattan"])
def fixture(request):
    arrays, qs = integer_graph(request.param)
    tg = graph_from_numpy(arrays["vectors"], arrays["links"],
                          arrays["link_counts"], arrays["deleted"],
                          arrays["n_nodes"], device="cpu")
    jg = JaxGraph(*(jnp.asarray(arrays[k]) for k in
                    ("vectors", "links", "link_counts", "deleted")),
                  n_nodes=jnp.int32(arrays["n_nodes"]))
    return request.param, tg, jg, qs


@pytest.mark.parametrize("ef,cap", QUEUES)
@pytest.mark.parametrize("width", [1, 4, 8])
def test_integer_walk_equals_jax(fixture, width, ef, cap):
    metric, tg, jg, qs = fixture
    kw = dict(ef=ef, metric_value=METRICS[metric], cand_cap=cap,
              expand_width=width)
    jd, ji, js = jax_search(jg, jnp.asarray(qs), **kw)
    td, ti, tstats = ts.search_graph(tg, torch.from_numpy(qs), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tstats.hops.numpy(), np.asarray(js.hops))
    np.testing.assert_array_equal(tstats.dist_evals.numpy(),
                                  np.asarray(js.dist_evals))
    assert (tstats.hops.numpy() > 1).all()


@pytest.mark.parametrize("width", [1, 4, 8])
def test_integer_walk_cosine(fixture, width):
    """Cosine distances are not exact in float32: ids, hops and evals equal
    on >= 99% of queries, every other query at a near-tie."""
    _, tg, jg, qs = fixture
    kw = dict(ef=64, metric_value=1, expand_width=width)
    jd, ji, js = jax_search(jg, jnp.asarray(qs), **kw)
    td, ti, tstats = ts.search_graph(tg, torch.from_numpy(qs), **kw)
    same = ((np.asarray(ji) == ti.numpy()).all(axis=1) &
            (np.asarray(js.hops) == tstats.hops.numpy()) &
            (np.asarray(js.dist_evals) == tstats.dist_evals.numpy()))
    assert same.mean() >= 0.99, same.mean()
    for q in np.nonzero(~same)[0]:
        assert _near_tie(np.asarray(jd)[q]) or _near_tie(td.numpy()[q]), q
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_twin(fixture):
    """beam_walk on CPU tensors is _search_batch, with float32 rows and
    with float32 records (which walk the same values), and it counts
    neither as a launch nor as a plain walk on the card."""
    from pg_embedding_tpu_torch.core.graph import pack_records
    metric, tg, _, qs = fixture
    q = torch.from_numpy(qs)
    kw = dict(ef=32, metric_value=METRICS[metric], cand_cap=48,
              expand_width=4)
    before = (dict(cg.LAUNCHES), ts.PLAIN_WALKS_ON_CARD)
    want = ts._search_batch(tg, q, **kw)
    recs = pack_records(tg.vectors, tg.links)
    for records in (None, recs):
        got = cg.beam_walk(tg, q, records=records, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (dict(cg.LAUNCHES), ts.PLAIN_WALKS_ON_CARD) == before


def test_wrapper_refuses_other_devices(fixture):
    _, tg, _, qs = fixture
    q = torch.empty((2, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cg.beam_walk(tg, q, ef=8, metric_value=0, cand_cap=8)
    z = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cg.prune_scan(z, z.bool(), z.long(), torch.empty((2, 4, 4),
                                                         device="meta"),
                      torch.empty(2, dtype=torch.bool, device="meta"), 2)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("device,rows,kw,want", [
    ("cuda", F32, {}, "kernel"),
    ("cuda", F32, dict(records_dtype=F32), "kernel"),
    ("cuda", BF16, dict(records_dtype=F32), "kernel"),
    ("cuda", F32, dict(ef=4096, cand_cap=4096), "kernel"),
    ("cuda", F32, dict(visited_slots=0), "kernel"),           # bitmap
    ("cuda", F32, dict(visited_slots=8192), "kernel"),        # hash
    ("cuda", F32, dict(quantized=True), "kernel"),            # int8 rows
    ("cuda", F32, dict(records_dtype=torch.int8, record_scales=True),
     "kernel"),
    ("cuda", F32, dict(records_dtype=BF16), "kernel"),
    ("cuda", F32, dict(records_dtype=torch.uint8, pq=True), "kernel"),
    ("cuda", BF16, {}, "kernel"),                             # bf16 rows
    ("cuda", F32, dict(records_dtype=torch.uint8, pq=True, rotated=True),
     "kernel"),                                               # OPQ
    ("cuda", F32, dict(ef=8192), "kernel"),          # queues in device memory
    ("cuda", F32, dict(cand_cap=4097), "kernel"),
    ("cpu", F32, {}, "plain"),
    ("cpu", F32, dict(records_dtype=F32), "plain"),
])
def test_walk_route(device, rows, kw, want):
    """Every variant on the card goes to the kernel, whatever its queue
    widths (past MAX_WALK_QUEUE they live in device memory and the kernel
    still takes them), every walk on the CPU to the twin; the kernel counts
    each launch under the variant's name."""
    kw = dict(dict(ef=64, cand_cap=64), **kw)
    ef, cap = kw.pop("ef"), kw.pop("cand_cap")
    assert ts.walk_route(device) == want
    assert (cg._walk_wide_words(ef, cap, 8, 32, 128, 10**6, True,
                                None) > 0) == (
        max(ef, cap) > cg.MAX_WALK_QUEUE)
    cg._walk_layout(ef, cap, 8, 32, 128, None)   # a shape the kernel takes
    kw.pop("record_scales", None)
    pq = kw.pop("pq", False)
    name = cg.walk_variant(rows, **kw)
    source, visited = name.split(", ")
    assert visited == cg.visited_name(kw.get("visited_slots", -1))
    dtype = kw.get("records_dtype")
    if dtype is not None:
        assert source.startswith("records ") and (
            ("pq" in source) == pq)
    else:
        want_src = "rows int8" if kw.get("quantized") else (
            "rows bf16" if rows == BF16 else "rows f32")
        assert source == want_src
    assert source.endswith(" rotated") == kw.get("rotated", False)


def test_cpu_walks_are_not_counted_on_card(fixture):
    _, tg, _, qs = fixture
    before = ts.PLAIN_WALKS_ON_CARD
    ts.search_graph(tg, torch.from_numpy(qs[:4]), ef=16, metric_value=0,
                    visited_slots=0)
    assert ts.PLAIN_WALKS_ON_CARD == before


@pytest.mark.parametrize("ef,cap,t,max_m,dims,tables", [
    (64, 64, 8, 32, 128, True),    # the smoke's main path at T = 8
    (320, 320, 8, 32, 128, True),  # the widest queues of the table scheme
    (1, 1, 1, 1, 1, True),
    (16, 48, 3, 7, 30, True),      # D rounds up to whole float4's
    (320, 320, 8, 32, 52_000, False),     # no room for the hash tables
    (321, 64, 8, 32, 128, "wide"),        # the narrowest wide queues
    (4096, 4096, 8, 32, 128, "wide"),
    (5120, 5120, 8, 32, 128, "wide"),     # the API's widening past 4096
    (8191, 64, 4, 16, 30, "wide"),
    (8191, 8191, 8, 32, 128, "wide"),     # the widest the widening reaches
    (13852, 13852, 8, 32, 128, "wide"),   # the widest queues in shared memory
    (13854, 13854, 8, 32, 128, "device"),  # past them: in device memory
    (16384, 16384, 8, 32, 128, "device"),
])
def test_walk_smem_bytes(ef, cap, t, max_m, dims, tables):
    query = 4 * 4 * -(-dims // 4)
    queues = 2 * (ef + cap) * (4 + 4)          # two buffers of (d, id)
    slots = t * max_m * (4 + 4 + 4 + 4 + 4 + 4)
    counters = 8 * 4
    held = 1 << (2 * (ef + cap) - 1).bit_length()   # ids, 4 bytes each
    first = 1 << (2 * t * max_m - 1).bit_length()   # (id, slot), 8 bytes
    base = query + queues + slots + counters
    want = (base + 4 * held + 8 * first, held, first) if tables else (
        base, 0, 0)
    rows = 1_000_003
    wide = {True: 0, False: 0}                       # by dense dedupe
    if tables in ("wide", "device"):
        # one buffer a queue, the candidate ring a multiple of T; no held
        # table: the held set is two bits an id in device memory (dense)
        ring = -(-cap // t) * t
        assert ring % t == 0 and cap <= ring < cap + t
        one = (ef + ring) * (4 + 4)
        fixed = query + slots + counters + 8 * first
        want = (fixed + one if tables == "wide" else fixed, 0, first)
        assert (fixed + one <= cg.SMEM_LIMIT) == (tables == "wide")
        queue_words = 0 if tables == "wide" else one // 4
        wide = {True: -(-rows // 16) + queue_words, False: queue_words}
    assert cg._walk_layout(ef, cap, t, max_m, dims, None) == want
    for dense, words in wide.items():
        assert cg._walk_wide_words(ef, cap, t, max_m, dims, rows,
                                   dense, None) == words
    assert cg._walk_smem_bytes(ef, cap, t, max_m, dims,
                               None) == want[0]
    assert want[0] <= cg.SMEM_LIMIT
    assert held >= 2 * (ef + cap) and first >= 2 * t * max_m


def test_walk_smem_bytes_refuses_past_the_limit():
    assert cg._walk_smem_bytes(320, 320, 8, 32, 52_000,
                               None) <= cg.SMEM_LIMIT
    with pytest.raises(ValueError, match="232448"):
        cg._walk_smem_bytes(320, 320, 8, 32, 55_000, None)
    # wide queues that do not fit move to device memory, leaving the row
    # and the slots in shared memory
    assert cg._walk_smem_bytes(5120, 5120, 8, 32, 50_000,
                               None) <= cg.SMEM_LIMIT
    assert cg._walk_wide_words(5120, 5120, 8, 32, 50_000, 64, False,
                               None) == (
        2 * (5120 + 5120))
    with pytest.raises(ValueError, match="232448"):
        cg._walk_smem_bytes(5120, 5120, 8, 32, 60_000, None)


def _gathered_scan(d_s, valid_s, pair_s, do_prune, nn):
    """The scan as core/build ran it before the kernel: over the pairwise
    matrix already gathered into scan order."""
    bsz, c = d_s.shape
    closer = pair_s < d_s.unsqueeze(2)
    kept_mask = torch.zeros((bsz, c), dtype=torch.bool)
    kept_count = torch.zeros(bsz, dtype=torch.int32)
    for j in range(c):
        conflict = (kept_mask & closer[:, j]).any(dim=1)
        take = valid_s[:, j] & (~conflict | ~do_prune) & (kept_count < nn)
        kept_mask[:, j] = take
        kept_count += take
    return kept_mask, kept_count


@pytest.mark.parametrize("seed,c,nn", [(0, 20, 6), (1, 33, 16), (2, 33, 32),
                                       (3, 64, 16)])
def test_prune_scan_plain_reads_through_the_order(seed, c, nn):
    cand_d, cand_i, pair = prune_case(seed, 40, c)
    _, order, d_s, valid_s, do_prune = tb._prune_order(cand_d, cand_i, nn)
    bsz = cand_d.shape[0]
    pair_s = torch.gather(pair, 1, order.unsqueeze(2).expand(bsz, c, c))
    pair_s = torch.gather(pair_s, 2, order.unsqueeze(1).expand(bsz, c, c))
    want = _gathered_scan(d_s, valid_s, pair_s, do_prune, nn)
    got = tb._prune_scan_plain(d_s, valid_s, order, pair, do_prune, nn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the CPU wrapper is the twin, and counts no launch
    before = (cg.LAUNCHES["prune_scan"], dict(cg.PRUNE_SHAPES))
    for a, b in zip(cg.prune_scan(d_s, valid_s, order, pair, do_prune, nn),
                    want):
        assert torch.equal(a, b)
    assert (cg.LAUNCHES["prune_scan"], dict(cg.PRUNE_SHAPES)) == before
    assert not do_prune.all() and (got[1] < nn).any()


def test_l2_sqrt_is_correctly_rounded():
    """The port's L2 distances on the CPU take the correctly rounded square
    root, as the JAX package's do: torch's vectorised float32 sqrt misses
    it by an ulp on ~0.5% of inputs, which moved a distance of the integer
    fixture (sqrt(999))."""
    from pg_embedding_tpu_torch.ops.distance import (dist_one_to_many,
                                                      pairwise_dist)
    v = torch.arange(0, 200_000, dtype=torch.float32)
    want = torch.sqrt(v.double()).float()
    assert torch.equal(torch.from_numpy(np.sqrt(v.numpy())), want)
    q = torch.zeros((1, 3))
    p = torch.tensor([[[31.0, 7.0, 3.0]]])          # 961 + 49 + 9 = 1019
    assert dist_one_to_many(q, p, 0).item() == np.sqrt(np.float32(1019))
    rows = torch.stack([v[:4096], torch.zeros(4096)], dim=1).sqrt()
    got = pairwise_dist(torch.zeros((1, 2)), rows, 0)[0]
    assert torch.equal(got, torch.sqrt(rows[:, 0].double() ** 2).float())
    p = torch.tensor([[[30.0, 9.0, 3.0, 3.0]]])     # 900 + 81 + 9 + 9 = 999
    assert dist_one_to_many(torch.zeros((1, 4)), p, 0).item() == float(
        np.sqrt(np.float32(999)))


@pytest.fixture(scope="module")
def l2_arrays():
    return integer_graph("l2")


def _operands(arrays, qs, source):
    """integer_operands' graph, queries and operands under the wrapper's
    names (records for search_graph's pcodes)."""
    g, q, kw = integer_operands(arrays, qs, source)
    return g, q, {("records" if k == "pcodes" else k): v
                  for k, v in kw.items()}


@pytest.mark.parametrize("source,elem", [
    ("rows f32", 0), ("rows bf16", 2), ("rows int8", 1), ("records f32", 0),
    ("records bf16", 2), ("records int8", 1), ("records pq", 3),
    ("records pq rotated", 3)])
def test_check_walk_args_takes_every_source(l2_arrays, source, elem):
    """Each row source's operands pass the checks, and name the kernel's
    element type, the records flag, the walk's query and the variant."""
    g, q, kw = _operands(*l2_arrays, source)
    src = cg._check_walk_args(g, q, 32, 32, 4, 0, visited_slots=0, **kw)
    assert src.elem == elem and src.records == source.startswith("records")
    assert src.query is kw.get("query_t", q)
    assert src.variant == f"{source}, bitmap"
    assert (src.scales is not None) == ("int8" in source)
    assert (src.codebook is not None) == ("pq" in source)


def _faulty(x, fault):
    if fault == "dtype":
        return x.to(torch.float64 if x.dtype != torch.float64
                    else torch.float32)
    if fault == "shape":
        return x[:-1]
    if fault == "device":
        return x.to("meta")
    return x.transpose(0, 1).contiguous().transpose(0, 1)   # strided


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "layout"])
@pytest.mark.parametrize("source,operand", [
    ("rows int8", "qvectors"), ("rows int8", "qscale"),
    ("records int8", "records"), ("records int8", "pscales"),
    ("records bf16", "records"), ("records pq", "records"),
    ("records pq", "pq_codebook"), ("records pq rotated", "query_t")])
def test_check_walk_args_refuses_a_wrong_operand(l2_arrays, source, operand,
                                                 fault):
    """A wrong dtype, shape, device or layout of any new operand raises
    ValueError before a launch."""
    g, q, kw = _operands(*l2_arrays, source)
    x = kw[operand]
    if fault == "layout" and x.dim() < 2:
        x = torch.stack([x, x], 1)[:, 0]                # a strided view
    else:
        x = _faulty(x, fault)
    assert x.dtype != kw[operand].dtype or x.shape != kw[operand].shape or (
        x.device != kw[operand].device or not x.is_contiguous())
    kw[operand] = x
    with pytest.raises(ValueError):
        cg._check_walk_args(g, q, 32, 32, 4, 0, **kw)


def test_check_walk_args_refuses_mismatched_operands(l2_arrays):
    """Operands that do not go together, and visited sets the kernel does
    not take, raise ValueError."""
    g, q, i8 = _operands(*l2_arrays, "records int8")
    _, _, rows = _operands(*l2_arrays, "rows int8")
    _, _, pq = _operands(*l2_arrays, "records pq")
    _, _, bf = _operands(*l2_arrays, "records bf16")
    bad = [dict(records=i8["records"]),                  # no scales
           dict(bf, pscales=i8["pscales"]),              # bf16 + scales
           dict(qvectors=rows["qvectors"]),              # no qscale
           dict(i8, **rows),                             # records and rows
           dict(pq_codebook=pq["pq_codebook"]),          # no PQ records
           dict(records=pq["records"].view(torch.int8),
                pq_codebook=pq["pq_codebook"])]
    for kw in bad:
        with pytest.raises(ValueError):
            cg._check_walk_args(g, q, 32, 32, 4, 0, **kw)
    for slots in (2, 48, 3):
        with pytest.raises(ValueError, match="power of 2"):
            cg._check_walk_args(g, q, 32, 32, 4, 0, visited_slots=slots)
    gh = dataclasses.replace(g, vectors=g.vectors.to(torch.float16))
    with pytest.raises(ValueError, match="float32 or bf16"):
        cg._check_walk_args(gh, q, 32, 32, 4, 0)
    with pytest.raises(ValueError):
        cg._check_walk_args(g, q.double(), 32, 32, 4, 0)
