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
  * The kernels' word arithmetic: the first-r-bits trick of prune_scan's
    unpruned sets and the odd row stride of connect_batch's staged rows.
  * The hash-plus-minimum-slot dedupe: the held ids (both queues, the
    popped ones included) and each expansion id's smallest slot in
    open-addressed tables with the kernel's hash, sizes and linear probing
    (ops/cuda_graph._walk_layout), held to the dense rule of
    core/search._search_batch on adversarial expansions (ids repeated
    within and across popped rows, invalid slots, ids that collide in the
    table); and a whole walk on that schedule (hash dedupe, admitted
    ranked by (d, slot), both queues merged by rank) held bit for bit to
    _search_batch on the integer fixture.
  * The wide instances' schedule (queues past MAX_WALK_QUEUE): the held
    set kept from step to step as two bits an id (admissions that land
    set theirs, evictions and pops clear theirs), the result queue one
    buffer, the candidate queue a ring popped by its head, the in-place
    merge in tail-first rounds; held bit for bit to _search_batch on the
    integer fixture at queues that evict (rounds of 3 entries) and at the
    wide widths (the kernel's rounds), the held bits checked against the
    queues after every step.
  * graph_probe's variants: rewrites of the kernels' text that apply to
    the sources as they are, which take no build option but the clock
    stamps.
"""

import collections
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
from test_torch_cuda import (METRICS, integer_graph, prune_case_adversarial,
                             repeated_links)
from walk_operands import integer_operands

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
    # connect_batch.cu's staged rows [C, D | 1]: 32 lanes reading one
    # column of 32 rows (a warp task's keepers) whose indices differ mod 32
    # hit 32 banks, at every D
    for d in (1, 2, 8, 32, 33, 128, 400):
        for rows in ([*range(32)], [*range(40, 72)],
                     [int(r + 32 * rng.integers(0, 32))
                      for r in rng.permutation(32)]):
            for k in (0, d - 1):
                assert len({(r * (d | 1) + k) % 32 for r in rows}) == 32
        # where D is even, a stride of D itself would not
        if d % 2 == 0:
            assert len({r * d % 32 for r in range(32)}) < 32
    # the warp tier's rows (_connect_warp_bytes): a stride of 16-byte chunks
    # rounded up to a multiple of 8, each lane reading a row's chunks from
    # its own column (lane mod chunks) on: the 8 lanes of a quarter-warp
    # reading any 8 rows hit the 8 groups of four banks where the chunks
    # are a multiple of 8 (D = 128: 32 float32 or 16 bf16 chunks); a
    # stride of an odd number of chunks would not
    for d, itemsize in ((128, 4), (128, 2), (64, 4), (256, 2)):
        chunks = d * itemsize // 16
        stride = -(-chunks // 8) * 8
        assert cg._connect_warp_bytes(33, d, itemsize) == (
            16 + -(-33 * 28 // 16) * 16 + 34 * stride * 16)
        for c in (0, 5, chunks - 1):
            for rows in ([*range(8)], [int(r) for r in rng.choice(33, 8)]):
                for q in range(4):
                    lanes = range(8 * q, 8 * q + 8)
                    groups = {(rows[lane % 8] * stride
                               + (c + lane) % chunks) % 8 for lane in lanes}
                    assert len(groups) == 8
        odd = chunks | 1
        assert len({(r * odd + c) % 8 for r in (0, 8, 16, 24, 1, 9, 17,
                                                 25)}) < 8


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
    _, held_n, slot_n = cg._walk_layout(ef, cap, t, max_m, 128, None)
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
                                        graph.dims, None)
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


# --- the wide instances: the held set kept, the in-place merge, the ring ---

def _kernel_constant(name):
    """An integer constexpr of csrc/beam_walk.cu."""
    with open(os.path.join(graph_probe.CSRC, graph_probe.WALK)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read())[1])


# incumbents a merge round moves: kMoveRun a thread of kWideThreads
WIDE_ROUND = _kernel_constant("kMoveRun") * _kernel_constant("kWideThreads")
_IN_RES, _IN_CAND = 1, 2


def _bits(held, i):
    return int(held[i >> 4] >> np.uint32(2 * (i & 15))) & 3


def _set(held, i, bits):
    held[i >> 4] |= np.uint32(bits << (2 * (i & 15)))


def _clear(held, i, bits):
    held[i >> 4] &= ~np.uint32(bits << (2 * (i & 15)))


def wide_schedule_walk(graph, queries, *, ef, metric_value, cand_cap, t,
                       round_size=WIDE_ROUND):
    """beam_walk_wide_kernel's walk for one query at a time: the held set
    as two bits an id (node 0's set at the start), read by each slot and
    updated after the dedupe: the popped ids clear their candidate bit,
    the admitted that land set theirs, the incumbents pushed past ef or
    cand_cap clear theirs; the result queue one buffer, the candidate
    queue a ring of cand_cap rounded up to a multiple of T popped by
    advancing its head (the next pop's places past the queue padded, the
    rest of the ring left stale); the merge in place: the admitted's
    places first, then the displaced suffix tail first in rounds of
    ``round_size`` entries (each round read whole, then written), then the
    admitted.  Returns the walk's (res_d, res_i, hops, evals) and counts
    of the events the schedule must get right."""
    max_m = graph.max_m
    tm, ring = t * max_m, cg._walk_ring(cand_cap, t)
    words = -(-graph.capacity // 16)
    seen = collections.Counter()
    out = []
    for q in queries:
        held = np.zeros(words, np.uint32)
        rd = np.full(ef, _INF, np.float32)
        ri = np.full(ef, -1, np.int32)
        cd = np.full(ring, _INF, np.float32)
        ci = np.full(ring, -1, np.int32)
        rd[0] = cd[0] = dist_one_to_many(q[None], graph.vectors[:1][None],
                                         metric_value)[0, 0].item()
        ri[0] = ci[0] = 0
        _set(held, 0, _IN_RES | _IN_CAND)
        head, n_res, n_cand = 0, 1, 1
        hops = evals = 0
        while cd[head] < _INF and not cd[head] > rd[-1]:
            lower = rd[-1]
            pop = [(cd[head + j], ci[head + j]) for j in range(t)]
            slot_id = np.full(tm, -1, np.int32)
            for j, (pd, p) in enumerate(pop):
                if p < 0 or pd > lower:
                    continue
                n = int(graph.link_counts[p])
                row = graph.links[p].numpy()
                for r in range(max_m):
                    if r < n and row[r] >= 0:
                        slot_id[j * max_m + r] = row[r]
            first, keep = {}, np.zeros(tm, bool)
            for s_, i in enumerate(slot_id):
                if i >= 0:
                    first.setdefault(int(i), s_)
            popped = {int(p) for _, p in pop[:min(t, n_cand)]}
            for s_, i in enumerate(slot_id):
                if i >= 0 and first[int(i)] == s_:
                    keep[s_] = _bits(held, i) == 0
                    seen["popped id met"] += int(i) in popped
            for _, p in pop[:min(t, n_cand)]:
                _clear(held, p, _IN_CAND)
            proc = np.nonzero(keep)[0]
            d = dist_one_to_many(
                q[None], graph.vectors[torch.from_numpy(slot_id[proc])
                                       .long()][None],
                metric_value)[0].numpy()
            adm = d < lower
            rank = np.lexsort((proc[adm], d[adm]))
            srt_d, srt_i = d[adm][rank], slot_id[proc[adm]][rank]
            n_new = len(srt_d)
            rest = max(n_cand - t, 0)
            head2 = (head + t) % ring
            cand = (head2 + np.arange(ring)) % ring     # logical -> ring
            n_cand2 = rest
            if n_new:
                at_r = np.arange(n_new) + np.searchsorted(rd[:n_res], srt_d,
                                                          "right")
                inc_c = cd[cand[:rest]]
                at_c = np.arange(n_new) + np.searchsorted(inc_c, srt_d,
                                                          "right")
                seen["ties"] += int(np.isin(srt_d, rd[:n_res]).sum()
                                    + np.isin(srt_d, inc_c).sum())
                gone = []
                for d_q, i_q, at, n_inc, width, bit, frm in (
                        (rd, ri, np.arange(ef), n_res, ef, _IN_RES, at_r[0]),
                        (cd, ci, cand, rest, cand_cap, _IN_CAND, at_c[0])):
                    hi = n_inc
                    while hi > frm:
                        lo = max(frm, hi - round_size)
                        idx = at[lo:hi]
                        vd, vi = d_q[idx].copy(), i_q[idx].copy()
                        vo = np.arange(lo, hi) + np.searchsorted(srt_d, vd,
                                                                 "left")
                        stay = vo < width
                        d_q[at[vo[stay]]], i_q[at[vo[stay]]] = (vd[stay],
                                                                vi[stay])
                        gone += [(int(i), bit) for i in vi[~stay]]
                        seen["rounds"] += 1
                        hi = lo
                for e in range(n_new):
                    bits = 0
                    if at_r[e] < ef:
                        rd[at_r[e]], ri[at_r[e]] = srt_d[e], srt_i[e]
                        bits |= _IN_RES
                    if at_c[e] < cand_cap:
                        c = cand[at_c[e]]
                        cd[c], ci[c] = srt_d[e], srt_i[e]
                        bits |= _IN_CAND
                    seen["admitted, pushed out"] += bits != (_IN_RES
                                                             | _IN_CAND)
                    _set(held, srt_i[e], bits)
                for i, bit in gone:
                    _clear(held, i, bit)
                seen["evicted"] += len(gone)
                n_res = min(ef, n_res + n_new)
                n_cand2 = min(cand_cap, rest + n_new)
            for x in range(n_cand2, t):
                cd[cand[x]], ci[cand[x]] = _INF, -1
            head, n_cand = head2, n_cand2
            seen["wraps"] += head == 0
            hops += 1
            evals += len(proc)
            # the held bits are the queues' membership
            live_c = ci[(head + np.arange(n_cand)) % ring]
            assert (ri[n_res:] == -1).all() and (live_c >= 0).all()
            want = np.zeros(words, np.uint32)
            for ids, bit in ((ri[:n_res], _IN_RES), (live_c, _IN_CAND)):
                np.bitwise_or.at(want, ids >> 4, (bit << (2 * (ids & 15)))
                                 .astype(np.uint32))
            assert np.array_equal(held, want)
        out.append((rd, ri, hops, evals))
    rd, ri, hops, evals = zip(*out)
    return (torch.from_numpy(np.stack(rd)), torch.from_numpy(np.stack(ri)),
            torch.tensor(hops, dtype=torch.int32),
            torch.tensor(evals, dtype=torch.int32)), seen


def _holes(arrays, seed=17):
    """repeated_links with a tenth of the slots inside each row's count set
    to -1 (slots the kernel must skip)."""
    arrays = repeated_links(arrays, seed)
    rng = np.random.default_rng(seed)
    links = arrays["links"].copy()
    inside = np.arange(links.shape[1]) < arrays["link_counts"][:, None]
    links[inside & (rng.random(links.shape) < 0.1)] = -1
    return dict(arrays, links=links)


@functools.lru_cache(maxsize=None)
def _integer_graph(metric):
    """integer_graph, built once a metric (its arrays are copied before
    any change)."""
    return integer_graph(metric)


def _hold_wide(metric, t, ef, cap, links, n_queries, round_size):
    arrays, qs = _integer_graph(metric)
    arrays = repeated_links(arrays) if links == "repeated" else _holes(arrays)
    g = graph_from_numpy(arrays["vectors"], arrays["links"],
                         arrays["link_counts"], arrays["deleted"],
                         arrays["n_nodes"], device="cpu")
    q = torch.from_numpy(qs[:n_queries])
    kw = dict(ef=ef, metric_value=METRICS[metric], cand_cap=cap)
    want = ts._search_batch(g, q, expand_width=t, **kw)
    got, seen = wide_schedule_walk(g, q, t=t, round_size=round_size, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[2] > 1).all())
    return seen


@pytest.mark.parametrize("metric", ["l2", "manhattan"])
@pytest.mark.parametrize("t,ef,cap", [(t, ef, cap) for t in (1, 4, 8)
                                      for ef, cap in ((16, 16), (64, 128),
                                                      (128, 64))])
@pytest.mark.parametrize("links", ["repeated", "holes"])
def test_wide_schedule_walk_equals_the_twin(metric, t, ef, cap, links):
    """The wide instances' schedule at queues narrow enough that both
    evict, with rounds of 3 entries (many rounds a merge), over links
    repeated within and across popped rows (and -1 slots): bit for bit the
    twin's walk; ids admitted and pushed out in one step, popped ids met
    again in their own step, ties with incumbents and evictions happened
    (and, at cand_cap 16, the ring wrapped)."""
    seen = _hold_wide(metric, t, ef, cap, links, 8, 3)
    assert seen["admitted, pushed out"] and seen["evicted"]
    assert seen["ties"] and seen["rounds"]
    assert seen["wraps"] or cap > 16
    if links == "repeated":
        assert seen["popped id met"]


@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("ef,cap", [(4097, 64), (64, 8191), (5120, 5120)])
def test_wide_schedule_walk_at_wide_queues(t, ef, cap):
    """The same schedule at the wide instances' own widths, with the
    kernel's rounds (WIDE_ROUND): bit for bit the twin's walk."""
    _hold_wide("l2", t, ef, cap, "repeated", 4, WIDE_ROUND)


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


@pytest.mark.parametrize("name", sorted(graph_probe.WIRING_VARIANTS))
def test_probe_wiring_variants_rewrite_the_source(name):
    """graph_probe's wiring variants rewrite csrc/connect_batch.cu alone,
    each rewrite finding its text exactly once (the variants without one
    leave it as it is)."""
    got = graph_probe.variant_sources(name, wiring=True)
    assert sorted(got) == sorted(graph_probe.WIRING_SOURCES)
    with open(os.path.join(graph_probe.CSRC, graph_probe.WIRE)) as f:
        text = f.read()
    assert (got[graph_probe.WIRE] != text) == bool(
        graph_probe.WIRING_VARIANTS[name][1])


def test_kernel_sources_take_no_build_option_but_the_clocks():
    """The walk, the scan and the wiring are built one way for the port;
    only the probe's clock-stamped build (-DPG_PROFILE) sets a macro."""
    for src in graph_probe.SOURCES + graph_probe.WIRING_SOURCES:
        with open(os.path.join(graph_probe.CSRC, src)) as f:
            text = f.read()
        assert set(re.findall(r"#\s*if(?:n?def)?\s+!?\s*(?:defined\()?(\w+)",
                              text)) == {"PG_PROFILE"}, src


# --- the walk's variants: the visited sets and the row sources -------------
#
# beam_walk.cu's step under the bitmap and hash visited sets, and its phase
# 3 for every row source, rendered per query in numpy and held bit for bit
# to _search_batch (before finish_walk) and, after finish_walk, to the JAX
# package's walks on the integer fixture, whose int8, bf16 and PQ operands
# keep every value and every L2 and Manhattan distance exact.

SOURCES = ("rows bf16", "rows int8", "records f32", "records bf16",
           "records int8", "records pq", "records pq rotated")


def _widen_bf16(x):
    """bf16 values to float32 by the kernel's rule: the 16 bits shifted
    into the top of a 32-bit word."""
    bits = x.contiguous().view(torch.int16).numpy().astype(np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _round_bf16(x):
    """float32 -> bf16 -> float32, to nearest even (__float2bfloat16_rn)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


class RowRule:
    """beam_walk.cu's phase 3 row for expansion slot r of popped node p
    holding id n: the records at (p, r) or the rows at n, each element the
    float32 the kernel computes (int8: code x scale, one rounding; bf16:
    widened; PQ: codebook[c / sub, code[c / sub], c % sub])."""

    def __init__(self, graph, kw):
        self.kw = {k: v for k, v in kw.items() if k != "query_t"}
        self.vectors = graph.vectors
        self.records = "pcodes" in kw

    def row(self, p, r, n):
        kw = self.kw
        if "pq_codebook" in kw:
            cb = kw["pq_codebook"].numpy()
            codes = kw["pcodes"][p, r].numpy().astype(np.int64)
            g, _, sub = cb.shape
            e = np.arange(g * sub)
            return cb[e // sub, codes[e // sub], e % sub]
        if "pscales" in kw:
            return (kw["pcodes"][p, r].numpy().astype(np.float32)
                    * np.float32(kw["pscales"][p, r].item()))
        if "qvectors" in kw:
            return (kw["qvectors"][n].numpy().astype(np.float32)
                    * np.float32(kw["qscale"][n].item()))
        src = kw["pcodes"][p, r] if self.records else self.vectors[n]
        if src.dtype == torch.bfloat16:
            return _widen_bf16(src)
        return src.numpy()


def _distance(q, p, metric, round_pp):
    """The kernel's distance of one row in float32 (on integer data every
    sum is exact, so the order does not matter)."""
    d = (p - q).astype(np.float32)
    if metric == 0:
        return np.sqrt(np.float32((d * d).sum(dtype=np.float32)))
    if metric == 2:
        return np.float32(np.abs(d).sum(dtype=np.float32))
    dot = torch.tensor((p * q).sum(dtype=np.float32))
    pp = np.float32((p * p).sum(dtype=np.float32))
    pp = torch.tensor(_round_bf16(pp) if round_pp else pp)
    qq = torch.tensor((q * q).sum(dtype=np.float32))
    return np.float32(1.0 - dot * torch.rsqrt(torch.clamp(qq * pp,
                                                           min=1e-30)))


def _vis_slot(i, slots):
    """beam_walk.cu's vis_bucket / vis_slot: the hash set's bucket start
    and the slot an id writes."""
    b = (int(i) * 2654435761) & ((slots - 1) & ~3)
    return b, b + ((((int(i) * 0x9E3779B1) & 0xffffffff)) >> 30)


def variant_walk(graph, queries, kw, *, ef, metric_value, cand_cap, t,
                 visited_slots=-1):
    """beam_walk.cu's walk for one query at a time with any row source and
    visited set: the dense dedupe through its tables; the bitmap (words of
    32 ids, node 0's bit set, processed ids' bits set after every slot has
    read); the hash set (4-slot buckets, node 0 in slot 0, the hop cap;
    after every slot has read, warp 0's pass: chunks of 32 slots in order,
    the highest lane of a chunk writing each table slot).  Returns the
    walk's (res_d, res_i, hops, evals) before finish_walk, and the number
    of steps where two processed ids wrote one hash slot."""
    max_m, tm, cap = graph.max_m, t * graph.max_m, graph.capacity
    _, held_n, slot_n = cg._walk_layout(ef, cand_cap, t, max_m,
                                        graph.dims, None)
    rule = RowRule(graph, kw)
    walk_q = kw.get("query_t", queries).numpy()
    round_pp = (metric_value == 1 and not rule.records
                and graph.vectors.dtype == torch.bfloat16)
    out, collided = [], 0
    for qi, q in enumerate(queries):
        wq = walk_q[qi]
        rd = np.full(ef, _INF, np.float32)
        ri = np.full(ef, -1, np.int32)
        cd = np.full(cand_cap, _INF, np.float32)
        ci = np.full(cand_cap, -1, np.int32)
        d0 = dist_one_to_many(q[None], graph.vectors[:1][None],
                              metric_value)[0, 0].item()
        rd[0] = cd[0] = d0
        ri[0] = ci[0] = 0
        words = np.zeros(-(-cap // 32), np.uint32)
        words[0] = 1
        table = np.full(max(visited_slots, 1), -1, np.int64)
        table[0] = 0
        hops = evals = 0
        while cd[0] < _INF and not cd[0] > rd[-1]:
            if visited_slots > 0 and hops >= visited_slots:
                break
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
            if visited_slots < 0:
                keep, _ = hash_dedupe(slot_id, ci, ri, held_n, slot_n)
            else:
                keep, _ = hash_dedupe(slot_id, [], [], held_n, slot_n)
                for s, i in enumerate(slot_id):
                    if not keep[s]:
                        continue
                    if visited_slots == 0:
                        keep[s] = not (words[i >> 5] >> (i & 31)) & 1
                    else:
                        b, _ = _vis_slot(i, visited_slots)
                        keep[s] = i not in table[b:b + 4]
            proc = np.nonzero(keep)[0]
            if visited_slots == 0:
                for s in proc:
                    words[slot_id[s] >> 5] |= np.uint32(1 << (slot_id[s]
                                                              & 31))
            elif visited_slots > 0:
                for c0 in range(0, tm, 32):
                    chunk = {}                  # table slot: highest lane
                    for s in proc[(proc >= c0) & (proc < c0 + 32)]:
                        chunk[_vis_slot(slot_id[s], visited_slots)[1]] = s
                    for at, s in chunk.items():
                        table[at] = slot_id[s]
                collided += any(
                    v > 1 for v in collections.Counter(
                        _vis_slot(slot_id[s], visited_slots)[1]
                        for s in proc).values())
            d = np.array([_distance(wq, rule.row(ci[s // max_m], s % max_m,
                                                 slot_id[s]),
                                    metric_value, round_pp)
                          for s in proc], np.float32)
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
            torch.tensor(evals, dtype=torch.int32)), collided


def _jax_walk(arrays, qs, kw, metric, **walk):
    """The JAX package's walk on the same graph and operands (its records
    flat, [cap, maxM * W])."""
    from pg_embedding_tpu.core import search as js
    from pg_embedding_tpu.core.graph import GraphState as JaxGraph
    vec = jnp.asarray(arrays["vectors"])
    if kw.get("bf16_rows"):
        vec = vec.astype(jnp.bfloat16)
    jg = JaxGraph(vec, *(jnp.asarray(arrays[k]) for k in
                         ("links", "link_counts", "deleted")),
                  n_nodes=jnp.int32(arrays["n_nodes"]))
    q = jnp.asarray(qs)
    walk = dict(walk, metric_value=METRICS[metric])

    def flat(x):
        x = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
        out = jnp.asarray(x.reshape(x.shape[0], -1).numpy())
        return (out.astype(jnp.bfloat16)
                if kw["pcodes"].dtype == torch.bfloat16 else out)
    if "pq_codebook" in kw:
        return js.search_graph_pq(jg, q, flat(kw["pcodes"]),
                                  jnp.asarray(kw["pq_codebook"].numpy()),
                                  None if kw.get("rot") is None else
                                  jnp.asarray(kw["rot"].numpy()), **walk)
    if "pcodes" in kw:
        ps = kw.get("pscales")
        return js.search_graph_packed(
            jg, q, flat(kw["pcodes"]),
            None if ps is None else jnp.asarray(ps.numpy()), **walk)
    if "qvectors" in kw:
        return js.search_graph_quantized(
            jg, q, jnp.asarray(kw["qvectors"].numpy()),
            jnp.asarray(kw["qscale"].numpy()), **walk)
    return js.search_graph(jg, q, **walk)


def _hold_variant(arrays, qs, source, metric, t, visited_slots, ef=32,
                  cap=48):
    """The rendered walk against _search_batch (bit for bit, before the
    tail) and, after finish_walk, against the JAX package's walk."""
    g, q, kw = integer_operands(arrays, qs, source)
    walk = dict(ef=ef, metric_value=METRICS[metric], cand_cap=cap)
    got, collided = variant_walk(g, q, kw, t=t,
                                 visited_slots=visited_slots, **walk)
    want = ts._search_batch(g, q, expand_width=t,
                            visited_slots=visited_slots, **walk, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fin = dict(metric_value=METRICS[metric], hashed=visited_slots > 0,
               rerank=source not in ("rows f32", "rows bf16",
                                     "records f32"))
    fd, fi = ts.finish_walk(g, q, *got[:2], **fin)
    jkw = dict(kw, bf16_rows=source == "rows bf16")
    if source.endswith("rotated"):
        jkw["rot"] = _rotation_of(kw, q)
    jd, ji, js_ = _jax_walk(arrays, qs, jkw, metric, ef=ef, cand_cap=cap,
                            expand_width=t, visited_slots=visited_slots)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(fd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(js_.hops))
    np.testing.assert_array_equal(got[3].numpy(),
                                  np.asarray(js_.dist_evals))
    return got, collided


def _rotation_of(kw, q):
    """The signed permutation R of integer_operands, read back from q and
    q @ R (each column of q @ R is +- one column of q)."""
    qt = kw["query_t"]
    rot = torch.zeros((q.shape[1], q.shape[1]))
    for c in range(q.shape[1]):
        for r in range(q.shape[1]):
            for sign in (1.0, -1.0):
                if torch.equal(qt[:, c], sign * q[:, r]):
                    rot[r, c] = sign
                    break
            if rot[:, c].any():
                break
    assert torch.equal(q @ rot, qt)
    return rot


@pytest.fixture(scope="module", params=["l2", "manhattan"])
def int_fixture(request):
    arrays, qs = integer_graph(request.param)
    return request.param, arrays, qs[:12]


@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("source", SOURCES)
def test_row_source_walk_equals_twin_and_jax(int_fixture, source, t):
    """Each row source's dequantisation (int8 x a power-of-two scale, bf16
    widened, PQ through an integer codebook, OPQ's rotated query) in the
    kernel's step: bit for bit the twin's walk and the JAX package's."""
    metric, arrays, qs = int_fixture
    got, _ = _hold_variant(arrays, qs, source, metric, t, -1)
    assert bool((got[2] > 1).all())


@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("visited", ["bitmap", "hash"])
def test_visited_set_walk_equals_twin_and_jax(int_fixture, visited, t):
    """The bitmap and the hash set (8,192 slots) in the kernel's step: the
    twin's walk and the JAX package's, bit for bit."""
    metric, arrays, qs = int_fixture
    _hold_variant(arrays, qs, "rows f32", metric, t,
                  0 if visited == "bitmap" else 8192)


def _colliding_slot_ids(slots, count, below):
    """``count`` ids under ``below`` that write one slot of a ``slots``
    table (the hash set's _vis_slot), as _colliding_ids finds ids of one
    bucket of the dedupe's tables."""
    by_slot = collections.defaultdict(list)
    for i in range(1, below):
        by_slot[_vis_slot(i, slots)[1]].append(i)
    return max(by_slot.values(), key=len)[:count]


@pytest.mark.parametrize("t", [1, 4, 8])
def test_hash_highest_slot_wins(int_fixture, t):
    """Ids that write one slot of a 64-slot table in the same step: node 0
    links to 8 of them and each links to the others, so every step's
    writes collide and overwritten ids come back.  The rendered pass (the
    highest slot of a step wins) is the twin's walk and the JAX package's,
    bit for bit; collisions did happen."""
    metric, arrays, qs = int_fixture
    arrays = dict(arrays)
    links = arrays["links"].copy()
    counts = arrays["link_counts"].copy()
    ids = _colliding_slot_ids(64, 8, int(arrays["n_nodes"]))
    for node in [0, *ids]:
        row = [i for i in ids if i != node]
        links[node, :len(row)] = row
        counts[node] = max(counts[node], len(row))
    arrays.update(links=links, link_counts=counts)
    _, collided = _hold_variant(arrays, qs, "rows f32", metric, t, 64,
                                ef=16, cap=16)
    assert collided > 0


def test_bf16_rows_cosine_rounds_the_norm():
    """Cosine over bf16 corpus rows: the twin's _sum_sq rounds |p|^2 to
    bf16 (the kernel's round_pp), over bf16 records it does not (they are
    widened first); the rendered walk with that rule is the twin's, bit
    for bit, on the integer fixture (dot products and norms exact)."""
    from pg_embedding_tpu_torch.ops.distance import _sum_sq
    arrays, qs = integer_graph("l2")
    rows = torch.from_numpy(arrays["vectors"][:500]).to(torch.bfloat16)
    pp = _sum_sq(rows).to(torch.float32).numpy()
    exact = (rows.float() ** 2).sum(1).numpy()
    np.testing.assert_array_equal(pp, _round_bf16(exact))
    assert (pp != exact).any()
    for source in ("rows bf16", "records bf16"):
        g, q, kw = integer_operands(arrays, qs[:12], source)
        for t in (1, 8):
            walk = dict(ef=32, metric_value=1, cand_cap=48)
            got, _ = variant_walk(g, q, kw, t=t, **walk)
            want = ts._search_batch(g, q, expand_width=t, **walk, **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b), source
