"""The build's wiring kernel (csrc/connect_batch.cu) on the CPU: its
schedule rendered in torch ops and held to the plain twin, its launch
shape and shared-memory tiers, and the wrapper's CPU route.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds it
to the twin bit for bit there).  Here the schedule it implements, chain
heads over the sorted ops, each candidate's scan rank counted rather than
sorted, the bit masks built in warp tasks of 4 candidates by 32 keepers,
the scan over the bits and the compaction of the keepers, is written out
in Python on the twin's distances and must give the twin's links and
counts exactly: a change to that schedule has to change this rendering
too."""

import numpy as np
import pytest
import torch

from pg_embedding_tpu_torch.config import MAX_DIMS, MAX_M
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.ops import cuda_graph as cg
from pg_embedding_tpu_torch.ops.distance import (dist_one_to_many,
                                                 pairwise_dist)
from connect_operands import chain_targets, wiring_case, wiring_tensors

METRICS = {"l2": 0, "cosine": 1, "manhattan": 2}
ROWS_PER_TASK = 4                     # csrc/connect_batch.cu kRowsPerTask


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_reprune(vectors, links, counts, t, cur, max_m, metric):
    """One re-prune as a connect_batch block computes it."""
    c = max_m + 1
    ids = torch.cat([links[t], torch.tensor([cur], dtype=torch.int32)])
    d = dist_one_to_many(vectors[t], vectors[ids.clamp(min=0).long()],
                         metric).to(torch.float32)
    dk = torch.where((ids >= 0) & torch.isfinite(d), d, float("inf"))
    valid = dk < float("inf")
    nv = int(valid.sum())
    prune = nv >= max_m
    # each valid candidate's rank, counted over the candidates before it
    di, dj = dk[:, None], dk[None, :]
    ii, ij = ids[:, None], ids[None, :]
    id_first = ij > ii if prune else ij < ii
    pos = torch.arange(c)
    before = valid[None, :] & ((dj < di) | ((dj == di) & (
        id_first | ((ij == ii) & (pos[None, :] < pos[:, None])))))
    rank = before.sum(dim=1)
    row = torch.full((max_m,), -1, dtype=torch.int32)
    if not prune:
        row[nv - 1 - rank[valid]] = ids[valid]
        links[t], counts[t] = row, nv
        return
    order = torch.empty(nv, dtype=torch.long)
    order[rank[valid]] = pos[valid]
    rows = vectors[ids.clamp(min=0).long()]
    pair = pairwise_dist(rows, rows, metric)
    # the masks, task by task: rows 4 g .. 4 g + 3, words 0 .. the last
    # row's; bit l of word w: keeper r = 32 w + l < j is closer to j than
    # the target is
    masks = {}
    lanes = torch.arange(32)
    for g in range(-(-nv // ROWS_PER_TASK)):
        last_w = (g * ROWS_PER_TASK + ROWS_PER_TASK - 1) >> 5
        for w in range(last_w + 1):
            r = 32 * w + lanes
            b = order[torch.where(r < nv, r, 0)]
            for u in range(ROWS_PER_TASK):
                j = g * ROWS_PER_TASK + u
                if j >= nv:
                    continue
                a = order[j]
                bits = (r < j) & (pair[a, b] < dk[a])
                masks[j, w] = int((bits.long() << lanes).sum())
    kept_words = [0] * (-(-c // 32))
    k = 0
    for j in range(nv):
        if k >= max_m:
            break
        if not any(masks[j, w] & kept_words[w] for w in range((j >> 5) + 1)):
            kept_words[j >> 5] |= 1 << (j & 31)
            k += 1
    slot = 0
    for j in range(nv):
        if kept_words[j >> 5] >> (j & 31) & 1:
            row[slot] = ids[order[j]]
            slot += 1
    links[t], counts[t] = row, k


def kernel_schedule(vectors, links, counts, keys, perm, *, base, m, max_m,
                    metric):
    """csrc/connect_batch.cu's grid-stride loop: each chain head (the first
    sorted op of its target) replays its chain in op order."""
    keys, perm = keys.tolist(), perm.tolist()
    for p in range(len(keys)):
        t = keys[p]
        if t == tb.NO_TARGET or (p and keys[p - 1] == t):
            continue
        for q in range(p, len(keys)):
            if keys[q] != t:
                break
            cur = base + perm[q] // m
            cnt = int(counts[t])
            if cnt < max_m:
                links[t, cnt], counts[t] = cur, cnt + 1
            else:
                _kernel_reprune(vectors, links, counts, t, cur, max_m,
                                metric)
    return links, counts


def serial_replay(vectors, links, counts, keys, perm, *, base, m, max_m,
                  metric):
    """The twin's ops one at a time in sorted order: append, or the twin's
    re-prune (core/build._reprune) of that one target."""
    for q in range(len(keys)):
        t = int(keys[q])
        if t == tb.NO_TARGET:
            break
        cur = base + int(perm[q]) // m
        cnt = int(counts[t])
        if cnt < max_m:
            links[t, cnt], counts[t] = cur, cnt + 1
            continue
        rows, n = tb._reprune(vectors, links[t:t + 1], keys[q:q + 1],
                              torch.tensor([cur], dtype=torch.int32),
                              max_m=max_m, metric_value=metric)
        links[t], counts[t] = rows[0], n[0]
    return links, counts


@pytest.mark.parametrize("max_m", [8, 32, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", list(METRICS))
def test_kernel_schedule_matches_twin(metric, dtype, max_m):
    """The kernel's schedule, rendered here, wires wiring_case's batch
    exactly as the twin's re-prune applied op by op in chain order does:
    every metric, float32 and bf16 rows, maxM 8, the main path's 32 and the
    default 200.  (One op at a time, not the twin's rounds: torch's bf16
    rsqrt on the CPU gives other bits in its vectorised loop than in its
    scalar tail, so a bf16 cosine re-prune's distances there depend on how
    many re-prunes share its round; on the card they do not.)"""
    arrays, (base, n_insert, m) = wiring_case(max_m * 3 + METRICS[metric],
                                              max_m)
    out = []
    for replay in (serial_replay, kernel_schedule):
        vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu",
                                                           dtype)
        tgt = tb._forward_links(links, counts, base, kept, cnt, n_insert,
                                m=m, max_m=max_m)
        keys, perm = tb._chain_order(tgt)
        replay(vectors, links, counts, keys, perm, base=base, m=m,
               max_m=max_m, metric=METRICS[metric])
        out.append((links, counts))
    (pl, pc), (kl, kc) = out
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    full = torch.from_numpy(arrays[2] == max_m)
    assert bool((pc[full] < max_m).any())               # re-prunes pruned


def test_mask_tasks_cover_every_scanned_word():
    """A task of rows 4 g .. 4 g + 3 computes words 0 .. (4 g + 3) >> 5,
    every word the scan reads for each of its rows (0 .. j >> 5), at every
    width a config admits."""
    for j in range(2 * MAX_M + 1):
        g = j // ROWS_PER_TASK
        assert (j >> 5) <= ((g * ROWS_PER_TASK + ROWS_PER_TASK - 1) >> 5)


@pytest.mark.parametrize("c,dims,tier", [
    (9, 8, "staged"), (33, 128, "staged"), (201, 128, "staged"),
    (201, 400, "masks only"), (1025, 8, "staged"), (1025, 128, "masks only"),
    (1401, 8, "device masks"), (2 * MAX_M + 1, MAX_DIMS, "device masks")])
def test_connect_layout(c, dims, tier):
    """_connect_layout, re-derived: the ids, d, two norms and order (20
    bytes a candidate), the kept words and prefixes and 8 scalars; the
    masks where they fit in SMEM_LIMIT, the float32 rows (odd stride) where
    those fit too."""
    smem, in_smem, stage = cg._connect_layout(c, dims)
    w = -(-c // 32)
    base = 20 * c + 8 * w + 32
    want = {"staged": (True, True), "masks only": (True, False),
            "device masks": (False, False)}[tier]
    assert (in_smem, stage) == want
    assert smem == (base + 4 * c * w * in_smem
                    + 4 * c * (dims | 1) * stage)
    assert smem <= cg.SMEM_LIMIT


def test_connect_layout_takes_every_config():
    """Every maxM HnswConfig admits (2 .. 2 MAX_M) has a tier at any D: no
    ValueError; a wider set than any config's raises one."""
    for max_m in range(2, 2 * MAX_M + 1, 2):
        cg._connect_layout(max_m + 1, MAX_DIMS)
    with pytest.raises(ValueError, match="shared memory"):
        cg._connect_layout(20_000, 8)


@pytest.mark.parametrize("bm,c,in_smem,sms,want", [
    (4096, 33, True, 132, 528), (100, 33, True, 132, 100),
    (1, 33, True, 132, 1), (2_800_000, 1401, False, 132, 528),
    (2_800_000, 8193, False, 132,
     (1 << 30) // (4 * 8193 * 257))])
def test_connect_blocks(bm, c, in_smem, sms, want):
    """Four blocks an SM, no more than the ops, and no more than the masks'
    scratch (SCRATCH_BYTES) holds where they live in device memory."""
    assert cg._connect_blocks(bm, c, in_smem, sms) == want


def test_connect_batch_wrapper_on_cpu():
    """On CPU tensors the wrapper is the twin (_replay_chains): no launch
    counted, no plain replay counted as the card's; on a device with no
    kernel it raises."""
    arrays, (base, n_insert, m) = wiring_case(11, 8)
    outs = []
    launches, plain = cg.LAUNCHES["connect_batch"], tb.PLAIN_CONNECTS_ON_CARD
    for fn in (cg.connect_batch, tb._replay_chains):
        vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
        tgt = tb._forward_links(links, counts, base, kept, cnt, n_insert,
                                m=m, max_m=8)
        keys, perm = tb._chain_order(tgt)
        fn(vectors, links, counts, keys, perm, base=base, m=m, max_m=8,
           metric_value=0)
        outs.append((links, counts))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert cg.LAUNCHES["connect_batch"] == launches
    assert tb.PLAIN_CONNECTS_ON_CARD == plain
    meta = [t.to("meta") for t in wiring_tensors(arrays, "cpu")]
    keys = torch.zeros(16 * m, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cg.connect_batch(meta[0], meta[1], meta[2], keys, keys.long(),
                         base=base, m=m, max_m=8, metric_value=0)


@pytest.mark.parametrize("case", ["no valid op", "first batch",
                                  "nothing inserted"])
def test_connect_batch_edges_on_cpu(case):
    """Batches with nothing to wire write only the forward rows (the
    wiring's own members), on the twin's route and the kernel's schedule
    alike: no valid op, node 0's first batch, no member inserted."""
    arrays, (base, n_insert, m) = wiring_case(12, 8, b=8, n_insert=8)
    vectors, links, counts, kept, cnt = (np.array(a) for a in arrays)
    if case == "no valid op":
        kept[:] = -1
    elif case == "first batch":
        base, counts[:], links[:], cnt[:] = 0, 0, -1, 0
    else:
        n_insert = 0
    arrays = (vectors, links, counts, kept, cnt)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    tb._connect_batch_plain(vectors, links, counts, base, kept, cnt,
                            n_insert, m=m, max_m=8, metric_value=0)
    others = torch.ones(len(counts), dtype=torch.bool)
    others[base:base + n_insert] = False
    assert torch.equal(links[others], torch.from_numpy(arrays[1])[others])
    assert torch.equal(counts[others], torch.from_numpy(arrays[2])[others])
    _, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    tgt = tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                            max_m=8)
    assert bool((tb._chain_order(tgt)[0] == tb.NO_TARGET).all())


@pytest.mark.parametrize("seed,max_m", [(0, 8), (1, 8), (2, 32), (3, 200)])
def test_chain_targets_name_the_repruned(monkeypatch, seed, max_m):
    """chain_targets (chip_smoke.py's split of a wiring's targets into
    those that only append and those that re-prune) names exactly the
    targets the plain twin re-prunes, from the counts before the replay."""
    arrays, (base, n_insert, m) = wiring_case(seed, max_m)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    tgt = tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                            max_m=max_m)
    keys, perm = tb._chain_order(tgt)
    targets, repruned = chain_targets(keys, counts, max_m)
    seen, real = set(), tb._reprune

    def spy(vectors, rows, t, cur, **kw):
        seen.update(t.tolist())
        return real(vectors, rows, t, cur, **kw)
    monkeypatch.setattr(tb, "_reprune", spy)
    tb._replay_chains(vectors, links, counts, keys, perm, base=base, m=m,
                      max_m=max_m, metric_value=0)
    assert seen == set(targets[repruned].tolist())
    assert seen and not bool(repruned.all())
