"""The schedules of the walk and prune kernels (csrc/beam_walk.cu,
csrc/prune_scan.cu), rendered in torch ops and plain Python here and held
on the CPU to what the kernels replace.

  * The keeper-driven scan: one round per kept neighbour, each round
    rejecting every alive later candidate that the new keeper is closer to
    (pair read at [candidate, keeper]).  Held bit for bit to
    core/build._prune_scan_plain, and, through the port's _prune_heuristic,
    to the JAX package's _prune_heuristic.  Cases: exact distance ties,
    repeated ids, invalid entries, sets too small to prune (do_prune
    false), nn = 1, C not a multiple of 32 (1, 31, 33, 129), the re-prune
    shape (C = 33, nn = 32), and a pair matrix that is not symmetric.
  * The kernel's word arithmetic: the first-r-bits trick of unpruned sets
    and the staged block's odd row stride.
  * The hash-plus-minimum-slot dedupe: the held ids (both queues, the
    popped ones included) and each expansion id's smallest slot in
    open-addressed tables with the kernel's hash, sizes and linear probing
    (ops/cuda_graph._walk_layout), held to the dense rule of
    core/search._search_batch on adversarial expansions (ids repeated
    within and across popped rows, invalid slots, ids that collide in the
    table); and a whole walk on that schedule (hash dedupe, admitted
    ranked by (d, slot), both queues merged by rank) held bit for bit to
    _search_batch on the integer fixture.
  * graph_probe's variants: rewrites of the kernels' text that apply to
    the sources as they are, which take no build option but the clock
    stamps.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.core.build import _prune_heuristic as jax_prune
from pg_embedding_tpu_torch import graph_probe
from pg_embedding_tpu_torch.convert import graph_from_numpy
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.core import search as ts
from pg_embedding_tpu_torch.ops import cuda_graph as cg
from pg_embedding_tpu_torch.ops.distance import dist_one_to_many
from test_torch_cuda import (METRICS, integer_graph,
                             prune_case_adversarial, repeated_links)

_INF = float("inf")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the prune scan ---------------------------------------------------------

def keeper_scan(d_s, valid_s, order, pair_d, do_prune, nn):
    """prune_scan.cu's schedule in torch ops, over a batch of sets: the
    next keeper is the first alive candidate after the last one; a keeper
    of a pruned set rejects every alive later candidate i with
    pair_d[order[i], order[keeper]] < d_s[i].  Returns (kept_mask, kept
    count, rounds a set took)."""
    bsz, c = d_s.shape
    bi = torch.arange(bsz)
    pos_of = torch.arange(c).unsqueeze(0)
    alive = valid_s.clone()
    kept = torch.zeros_like(valid_s)
    count = torch.zeros(bsz, dtype=torch.int32)
    last = torch.full((bsz,), -1)
    rounds = torch.zeros(bsz, dtype=torch.int32)
    for _ in range(min(nn, c)):
        free = alive & (pos_of > last.unsqueeze(1))
        has = free.any(dim=1) & (count < nn)
        if not bool(has.any()):
            break
        j = torch.where(has, free.int().argmax(dim=1), 0)
        kept[bi[has], j[has]] = True
        count += has.int()
        rounds += (has & do_prune).int()
        last = torch.where(has, j, last)
        keeper = order[bi, j]                                   # [B]
        col = pair_d[bi.unsqueeze(1), order, keeper.unsqueeze(1)]  # [B, C]
        reject = (col < d_s) & (pos_of > j.unsqueeze(1))
        alive &= ~(reject & (has & do_prune).unsqueeze(1))
    return kept, count, rounds


@pytest.mark.parametrize("c,nn", [(1, 1), (31, 16), (33, 16), (33, 32),
                                  (129, 16), (129, 1), (64, 64), (20, 32)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_keeper_scan_equals_the_twin(c, nn, symmetric):
    cand_d, cand_i, pair = prune_case_adversarial(c * 7 + nn, 96, c,
                                                  symmetric)
    _, order, d_s, valid_s, do_prune = tb._prune_order(cand_d, cand_i, nn)
    want = tb._prune_scan_plain(d_s, valid_s, order, pair, do_prune, nn)
    got, count, rounds = keeper_scan(d_s, valid_s, order, pair, do_prune, nn)
    assert torch.equal(got, want[0]) and torch.equal(count, want[1])
    # at most nn rounds a set, and only pruned sets take any
    assert int(rounds.max()) <= min(nn, c)
    assert not bool(rounds[~do_prune].any())
    if 1 < c and nn <= c:
        assert bool(do_prune.any()) and not bool(do_prune.all())
    else:
        assert not bool(do_prune[3::8].any())


@pytest.mark.parametrize("c,nn", [(33, 32), (64, 16), (31, 1)])
def test_keeper_scan_matches_jax_prune(monkeypatch, c, nn):
    """The port's _prune_heuristic on the keeper schedule gives the JAX
    package's kept ids and counts."""
    cand_d, cand_i, pair = prune_case_adversarial(c + 3 * nn, 64, c)
    monkeypatch.setattr(tb, "prune_scan",
                        lambda *a: keeper_scan(*a)[:2])
    got_i, got_n = tb._prune_heuristic(cand_d, cand_i, pair, nn)
    want_i, want_n = jax.vmap(functools.partial(jax_prune, nn=nn))(
        jnp.asarray(cand_d.numpy()), jnp.asarray(cand_i.numpy()),
        jnp.asarray(pair.numpy()))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def _first_bits(m, r):
    """prune_scan.cu's unpruned sets: keep the lowest r set bits of m."""
    rest = m
    for _ in range(r):
        rest &= rest - 1
    return m ^ rest


def test_first_bits_and_the_staged_stride():
    rng = np.random.default_rng(3)
    for m in [0, 1, 0xffffffff, 0x80000000, *rng.integers(0, 2**32, 200)]:
        m = int(m)
        bits = [i for i in range(32) if m >> i & 1]
        for r in range(0, 33):
            assert _first_bits(m, r) == sum(1 << i for i in bits[:r])
    # the staged block: flat index i = r * C + c goes to r * (C | 1) + c
    for c in (1, 2, 32, 33, 64, 65):
        cp = c | 1
        for i in range(c * c):
            at = i if c & 1 else i + i // c
            assert at == (i // c) * cp + i % c


# --- the walk's dedupe ------------------------------------------------------

def _hash(i, n):
    """beam_walk.cu's hash_id."""
    h = (int(i) * 0x9E3779B1) & 0xffffffff
    return (h ^ (h >> 15)) & (n - 1)


class _Tables:
    """The kernel's two open-addressed tables (linear probing, -1 empty):
    the held ids, and each expansion id's smallest slot."""

    def __init__(self, held_n, slot_n):
        self.held = [-1] * held_n
        self.keys = [-1] * slot_n
        self.first = [2**31 - 1] * slot_n
        self.probes = 0

    def _find(self, tab, i):
        h = _hash(i, len(tab))
        while tab[h] not in (-1, i):
            h = (h + 1) & (len(tab) - 1)
            self.probes += 1
        return h

    def hold(self, i):
        self.held[self._find(self.held, i)] = i

    def add_slot(self, i, s):
        h = self._find(self.keys, i)
        self.keys[h] = i
        self.first[h] = min(self.first[h], s)

    def keep(self, i, s):
        return (self.held[self._find(self.held, i)] != i
                and self.first[self._find(self.keys, i)] == s)


def hash_dedupe(slot_id, ci, ri, held_n, slot_n):
    """The kernel's phases 1-2 for one query: insert ci[0, cap) (the pop
    and the queue after it) and ri into the held table and every valid
    slot into the slot table; a slot is processed iff its id is not held
    and it is its id's smallest slot."""
    tables = _Tables(held_n, slot_n)
    for i in list(ci) + list(ri):
        if i >= 0:
            tables.hold(i)
    for s, i in enumerate(slot_id):
        if i >= 0:
            tables.add_slot(i, s)
    keep = [i >= 0 and tables.keep(i, s) for s, i in enumerate(slot_id)]
    return np.array(keep), tables.probes


def dense_rule(nbrs, valid, ci, ri, t):
    """_search_batch's dense dedupe for a batch (its expressions): skip
    ids in the queue after the pop, the results or the pop, then every
    valid slot repeating an earlier valid slot's id."""
    tm = nbrs.shape[1]
    slot = torch.arange(tm)
    earlier = slot.unsqueeze(0) < slot.unsqueeze(1)
    sn = torch.where(valid, nbrs, 0)
    pop_i, cq = ci[:, :t], torch.cat([ci[:, t:], torch.full_like(ci[:, :t],
                                                                 -1)], 1)
    unvisited = ~((sn.unsqueeze(2) == cq.unsqueeze(1)).any(2) |
                  (sn.unsqueeze(2) == ri.unsqueeze(1)).any(2) |
                  (sn.unsqueeze(2) == pop_i.unsqueeze(1)).any(2))
    dup = ((sn.unsqueeze(1) == sn.unsqueeze(2)) & earlier &
           valid.unsqueeze(1)).any(2)
    return valid & unvisited & ~dup


def _colliding_ids(n, count, bucket=0):
    """``count`` ids that the kernel hashes to one bucket of an n table."""
    out, i = [], 0
    while len(out) < count:
        if _hash(i, n) == bucket:
            out.append(i)
        i += 1
    return out


@pytest.mark.parametrize("ef,cap,t,max_m", [(64, 64, 8, 32), (64, 64, 4, 32),
                                            (16, 48, 3, 7), (128, 64, 16, 16),
                                            (4, 4, 4, 5)])
@pytest.mark.parametrize("pool", ["small", "colliding"])
def test_hash_dedupe_equals_the_dense_rule(ef, cap, t, max_m, pool):
    _, held_n, slot_n = cg._walk_layout(ef, cap, t, max_m, 128)
    assert held_n >= 2 * (ef + cap) and slot_n >= 2 * t * max_m
    rng = np.random.default_rng(ef + cap + t + max_m)
    b, tm = 40, t * max_m
    ids = (np.arange(3 * t) if pool == "small" else
           np.array(_colliding_ids(held_n, 2 * t + 8)))
    nbrs = rng.choice(ids, size=(b, tm)).astype(np.int32)
    valid = rng.random((b, tm)) < 0.8
    valid[:, -max_m:] &= rng.random((b, 1)) < 0.5      # a pop not expanding
    # the queues hold half the pool (and ids from outside it, and padding)
    queued = np.concatenate([ids[: len(ids) // 2], 10**6 + ids, [-1]])
    ci = rng.choice(queued, size=(b, cap)).astype(np.int32)
    ci[:, cap // 2:] = np.where(rng.random((b, cap - cap // 2)) < 0.5, -1,
                                ci[:, cap // 2:])
    ri = rng.choice(queued, size=(b, ef)).astype(np.int32)
    want = dense_rule(*(torch.from_numpy(x) for x in (nbrs, valid, ci, ri)),
                      t).numpy()
    probes = 0
    for q in range(b):
        slot_id = np.where(valid[q], nbrs[q], -1)
        got, p = hash_dedupe(slot_id, ci[q], ri[q], held_n, slot_n)
        probes += p
        np.testing.assert_array_equal(got, want[q])
    assert want.any() and not want.all()
    if pool == "colliding":
        assert probes > 0


def schedule_walk(graph, queries, *, ef, metric_value, cand_cap, t):
    """beam_walk.cu's step for one query at a time: the pop, the links,
    the hash dedupe, the distances (the twin's torch op), admission below
    lower, the admitted ranked by (d, slot) and both queues merged by rank
    (an incumbent moves down by the admitted strictly below it, an
    admitted entry by the incumbents at or below it)."""
    max_m = graph.max_m
    tm = t * max_m
    _, held_n, slot_n = cg._walk_layout(ef, cand_cap, t, max_m,
                                        graph.dims)
    out = []
    for q in queries:
        rd = np.full(ef, _INF, np.float32)
        ri = np.full(ef, -1, np.int32)
        cd = np.full(cand_cap, _INF, np.float32)
        ci = np.full(cand_cap, -1, np.int32)
        d0 = dist_one_to_many(q[None], graph.vectors[:1][None],
                              metric_value)[0, 0].item()
        rd[0] = cd[0] = d0
        ri[0] = ci[0] = 0
        hops = evals = 0
        while cd[0] < _INF and not cd[0] > rd[-1]:
            lower = rd[-1]
            slot_id = np.full(tm, -1, np.int32)
            for j in range(t):
                p = ci[j]
                if p < 0 or cd[j] > lower:
                    continue
                n = int(graph.link_counts[p])
                row = graph.links[p].numpy()
                for r in range(max_m):
                    if r < n and row[r] >= 0:
                        slot_id[j * max_m + r] = row[r]
            keep, _ = hash_dedupe(slot_id, ci, ri, held_n, slot_n)
            proc = np.nonzero(keep)[0]
            d = dist_one_to_many(
                q[None], graph.vectors[torch.from_numpy(slot_id[proc])
                                       .long()][None],
                metric_value)[0].numpy()
            adm = d < lower
            new_d, new_s = d[adm], proc[adm]
            rank = np.lexsort((new_s, new_d))
            srt_d, srt_i = new_d[rank], slot_id[new_s[rank]]
            rd, ri = _merge_by_rank(rd, ri, srt_d, srt_i, ef)
            cd, ci = _merge_by_rank(cd[t:], ci[t:], srt_d, srt_i, cand_cap)
            hops += 1
            evals += len(proc)
        out.append((rd, ri, hops, evals))
    rd, ri, hops, evals = zip(*out)
    return (torch.from_numpy(np.stack(rd)), torch.from_numpy(np.stack(ri)),
            torch.tensor(hops, dtype=torch.int32),
            torch.tensor(evals, dtype=torch.int32))


def _merge_by_rank(inc_d, inc_i, srt_d, srt_i, width):
    res_d = np.full(width, _INF, np.float32)
    res_i = np.full(width, -1, np.int32)
    for p in range(len(inc_d)):
        o = p + int(np.searchsorted(srt_d, inc_d[p], side="left"))
        if o < width:
            res_d[o], res_i[o] = inc_d[p], inc_i[p]
    for e in range(len(srt_d)):
        o = e + int(np.searchsorted(inc_d, srt_d[e], side="right"))
        if o < width:
            res_d[o], res_i[o] = srt_d[e], srt_i[e]
    return res_d, res_i


@pytest.mark.parametrize("metric", ["l2", "manhattan"])
@pytest.mark.parametrize("t,ef,cap", [(1, 16, 16), (4, 64, 64), (8, 64, 128),
                                      (4, 128, 64)])
@pytest.mark.parametrize("links", ["built", "repeated"])
def test_schedule_walk_equals_the_twin(metric, t, ef, cap, links):
    arrays, qs = integer_graph(metric)
    if links == "repeated":
        arrays = repeated_links(arrays)
    g = graph_from_numpy(arrays["vectors"], arrays["links"],
                         arrays["link_counts"], arrays["deleted"],
                         arrays["n_nodes"], device="cpu")
    q = torch.from_numpy(qs[:16])
    kw = dict(ef=ef, metric_value=METRICS[metric], cand_cap=cap)
    want = ts._search_batch(g, q, expand_width=t, **kw)
    got = schedule_walk(g, q, t=t, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[2] > 1).all())


# --- graph_probe's variants -------------------------------------------------

@pytest.mark.parametrize("name", sorted(graph_probe.VARIANTS))
def test_probe_variants_rewrite_the_sources(name):
    """graph_probe builds each variant by rewriting the kernels' text (as
    sweep_probe does): every rewrite finds its text exactly once in the
    sources as they are, and changes only the source it names."""
    got = graph_probe.variant_sources(name)
    rewrites = graph_probe.VARIANTS[name][1]
    assert sorted(got) == sorted(graph_probe.SOURCES)
    for src in graph_probe.SOURCES:
        with open(os.path.join(graph_probe.CSRC, src)) as f:
            text = f.read()
        assert (got[src] != text) == any(w == src for w, _, _ in rewrites)


def test_kernel_sources_take_no_build_option_but_the_clocks():
    """The walk and the scan are built one way for the port; only the
    probe's clock-stamped build (-DPG_PROFILE) sets a macro."""
    for src in graph_probe.SOURCES:
        with open(os.path.join(graph_probe.CSRC, src)) as f:
            text = f.read()
        assert set(re.findall(r"#\s*if(?:n?def)?\s+!?\s*(?:defined\()?(\w+)",
                              text)) == {"PG_PROFILE"}, src
