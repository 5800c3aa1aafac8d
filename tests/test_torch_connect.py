"""The build's wiring kernel (csrc/connect_batch.cu) on the CPU: its
schedule rendered in torch ops and held to the plain twin, its launch
shape and tiers, the wrapper's CPU route, and the card route's host half
held to the JAX package's _connect_batch.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds it
to the twin bit for bit there).  Here the schedule it implements is written
out in Python on the twin's distances and must give the twin's links and
counts exactly: a change to that schedule has to change this rendering
too.  The warp tier (C <= 64): a warp at each chain head, the chain's
appends in one step, each lane ranking its two candidates, the bit masks
built by the lanes in 4 x 4 tiles of the pair matrix's lower triangle,
the 64-bit scan and the popcount compaction, a member's chain starting from its forward row, and
the members no chain targets found by the warp's 32-way search.  The block
tier (C > 64): a block at each chain head replaying its ops one by one,
the masks in tasks of 4 scan rows by 32 keepers, in 32-bit words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.core import build as jb
from pg_embedding_tpu_torch.config import MAX_DIMS, MAX_M
from pg_embedding_tpu_torch.core import build as tb
from pg_embedding_tpu_torch.ops import cuda_graph as cg
from pg_embedding_tpu_torch.ops.distance import (dist_one_to_many,
                                                 pairwise_dist)
from connect_operands import (chain_targets, long_chain_case,
                              reprune_witness, wiring_case, wiring_tensors)

METRICS = {"l2": 0, "cosine": 1, "manhattan": 2}
ROWS_PER_TASK = 4                     # csrc/connect_batch.cu kRowsPerTask
TILE = 4                              # csrc/connect_batch.cu kTile


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(dk, ids, i, prune):
    """Candidate i's place among the valid ones, counted over the set:
    pruned, in scan order (d ascending, ties larger-id-first); unpruned, in
    (d, id) ascending order; position breaks what remains."""
    r = 0
    for j in range(len(ids)):
        id_first = ids[j] > ids[i] if prune else ids[j] < ids[i]
        r += dk[j] < dk[i] or (dk[j] == dk[i] and (
            id_first or (ids[j] == ids[i] and j < i)))
    return r


def _block_reprune(vectors, ids, t, max_m, metric):
    """One re-prune of candidates ``ids`` (the row, then cur) as a block
    of the block tier computes it (thread i ranks candidate i; the masks
    in tasks of 4 scan rows by 32 keepers, 32-bit words): (the new row as a
    list of maxM ids, its count)."""
    c = max_m + 1
    d = dist_one_to_many(vectors[t], vectors[ids.clamp(min=0).long()],
                         metric).to(torch.float32)
    dk = torch.where((ids >= 0) & torch.isfinite(d), d,
                     float("inf")).tolist()
    valid = [x < float("inf") for x in dk]
    nv = sum(valid)
    prune = nv >= max_m
    id_list = ids.tolist()
    rank = {i: _rank(dk, id_list, i, prune) for i in range(c) if valid[i]}
    row = [-1] * max_m
    if not prune:
        for i, r in rank.items():
            row[nv - 1 - r] = id_list[i]
        return row, nv
    order = [0] * nv
    for i, r in rank.items():
        order[r] = i
    cvecs = vectors[ids.clamp(min=0).long()]
    pair = pairwise_dist(cvecs, cvecs, metric)
    # the masks, task by task: scan rows 4 g .. 4 g + 3 by the 32 keepers of
    # word w, words up to the task's last row's; bit l of word w: keeper r =
    # 32 w + l < j is closer to j than the target is
    masks = {}
    for g in range(-(-nv // ROWS_PER_TASK)):
        for w in range(((g * ROWS_PER_TASK + ROWS_PER_TASK - 1) >> 5) + 1):
            for u in range(ROWS_PER_TASK):
                j = g * ROWS_PER_TASK + u
                if j >= nv:
                    continue
                a = order[j]
                word = 0
                for lane in range(32):
                    r = 32 * w + lane
                    b = order[r if r < nv else 0]
                    if r < j and float(pair[a, b]) < dk[a]:
                        word |= 1 << lane
                masks[j, w] = word
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
            row[slot] = int(ids[order[j]])
            slot += 1
    return row, k


def _tile_blocks(t):
    """csrc/connect_batch.cu tile_blocks: tile t = J (J + 1) / 2 + R."""
    big_j = 0
    while (big_j + 1) * (big_j + 2) // 2 <= t:
        big_j += 1
    return big_j, t - big_j * (big_j + 1) // 2


def _warp_reprune(vectors, ids, t, max_m, metric):
    """One re-prune of candidates ``ids`` (the row, then cur) inside a warp
    of the warp tier: lane l ranks candidates l and l + 32; the masks, a
    64-bit word a scan row, built by the lanes in 4 x 4 tiles of the pair
    matrix's lower triangle (lane l takes tiles l, l + 32, ...); the scan
    the same in every lane; each keeper placed by the popcount of the kept
    bits below it.  Returns (the new row as a list of maxM ids, its
    count)."""
    c = max_m + 1
    d = dist_one_to_many(vectors[t], vectors[ids.clamp(min=0).long()],
                         metric).to(torch.float32)
    dk = torch.where((ids >= 0) & torch.isfinite(d), d,
                     float("inf")).tolist()
    valid = [x < float("inf") for x in dk]
    nv = sum(valid)
    prune = nv >= max_m
    id_list = ids.tolist()
    rank = {}
    for lane in range(32):
        for i in (lane, lane + 32):
            if i < c and valid[i]:
                rank[i] = _rank(dk, id_list, i, prune)
    assert sorted(rank) == [i for i in range(c) if valid[i]]
    row = [-1] * max_m
    if not prune:
        for i, r in rank.items():
            row[nv - 1 - r] = id_list[i]
        return row, nv
    order = [0] * nv
    for i, r in rank.items():
        order[r] = i
    cvecs = vectors[ids.clamp(min=0).long()]
    pair = pairwise_dist(cvecs, cvecs, metric)
    nb = -(-nv // TILE)
    masks = [0] * nv
    for lane in range(32):
        for tile in range(lane, nb * (nb + 1) // 2, 32):
            big_j, big_r = _tile_blocks(tile)
            for u in range(TILE):
                j = big_j * TILE + u
                a = order[min(j, nv - 1)]
                for v in range(TILE):
                    r = big_r * TILE + v
                    b = order[min(r, nv - 1)]
                    if j < nv and r < j and float(pair[a, b]) < dk[a]:
                        masks[j] |= 1 << r
    kept, k = 0, 0
    for j in range(nv):
        if k >= max_m:
            break
        if not masks[j] & kept:
            kept |= 1 << j
            k += 1
    for j in range(nv):
        if kept >> j & 1:
            row[bin(kept & ((1 << j) - 1)).count("1")] = id_list[order[j]]
    return row, k


def _forward_row(kept_i, kept_cnt, u, m, max_m):
    """Member u's forward row and count, read from kept_i / kept_cnt."""
    cnt = int(kept_cnt[u])
    return [int(kept_i[u, s]) if s < m and s < cnt and int(kept_i[u, s]) >= 0
            else -1 for s in range(max_m)], cnt


def warp_has_key(keys, v):
    """csrc/connect_batch.cu's warp_has_key: a 32-way search of the sorted
    keys, 32 evenly spaced probes a round."""
    lo, hi = 0, len(keys)
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        less = sum(1 for lane in range(32)
                   if lo + (lane + 1) * step - 1 < hi
                   and keys[lo + (lane + 1) * step - 1] < v)
        nlo = lo + less * step
        lo, hi = nlo, min(hi, nlo + step)
    return any(keys[i] == v for i in range(lo, hi))


def _warp_chain(vectors, links, counts, keys, perm, kept_i, kept_cnt, p, *,
                base, n_insert, m, max_m, metric):
    """A warp at sorted position p: nothing unless p heads a chain; a chain
    that only appends stores its ops in one step; else the row (a member's
    forward row) is appended to as far as it fills and re-pruned op by op,
    a chunk of 32 ops at a time, and written once."""
    bm = len(keys)
    t = keys[p]
    if t == tb.NO_TARGET or (p > 0 and keys[p - 1] == t):
        return

    def chunk(q0):                        # the chain's ops among the next 32
        n = 0
        while n < 32 and q0 + n < bm and keys[q0 + n] == t:
            n += 1
        return n
    n = chunk(p)
    member = base <= t < base + n_insert
    if member:
        row, cnt = _forward_row(kept_i, kept_cnt, t - base, m, max_m)
    else:
        cnt = int(counts[t])
    if not member and n < 32 and cnt + n <= max_m:
        for x in range(n):
            links[t, cnt + x] = base + perm[p + x] // m
        counts[t] = cnt + n
        return
    if not member:
        row = links[t].tolist()
    q0 = p
    while n > 0:
        curs = [base + perm[q0 + x] // m for x in range(n)]
        x = 0
        while x < n:
            n_app = max(0, min(n - x, max_m - cnt))
            row[cnt:cnt + n_app] = curs[x:x + n_app]
            cnt, x = cnt + n_app, x + n_app
            if x == n:
                break
            ids = torch.tensor(row + [curs[x]], dtype=torch.int32)
            row, cnt = _warp_reprune(vectors, ids, t, max_m, metric)
            x += 1
        if n < 32:
            break
        q0 += 32
        n = chunk(q0)
    links[t] = torch.tensor(row, dtype=torch.int32)
    counts[t] = cnt


def _block_chain(vectors, links, counts, keys, perm, kept_i, kept_cnt, p, *,
                 base, n_insert, m, max_m, metric):
    """A block at sorted position p: a chain head writes its member's
    forward row first, then replays its ops one by one."""
    t = keys[p]
    if t == tb.NO_TARGET or (p > 0 and keys[p - 1] == t):
        return
    if base <= t < base + n_insert:
        row, cnt = _forward_row(kept_i, kept_cnt, t - base, m, max_m)
        links[t], counts[t] = torch.tensor(row, dtype=torch.int32), cnt
    for q in range(p, len(keys)):
        if keys[q] != t:
            break
        cur = base + perm[q] // m
        cnt = int(counts[t])
        if cnt < max_m:
            links[t, cnt], counts[t] = cur, cnt + 1
        else:
            ids = torch.cat([links[t], torch.tensor([cur],
                                                    dtype=torch.int32)])
            row, k = _block_reprune(vectors, ids, t, max_m, metric)
            links[t], counts[t] = torch.tensor(row, dtype=torch.int32), k


def kernel_schedule(vectors, links, counts, keys, perm, kept_i, kept_cnt, *,
                    base, n_insert, m, max_m, metric):
    """csrc/connect_batch.cu on its operands: every sorted position's warp
    (the warp tier) or block (the block tier), then the members that no
    chain targets, their forward rows."""
    warp = cg._connect_layout(max_m + 1, vectors.shape[1],
                              vectors.element_size()).tier == "warp"
    keys, perm = keys.tolist(), perm.tolist()
    chain = _warp_chain if warp else _block_chain
    for p in range(len(keys)):
        chain(vectors, links, counts, keys, perm, kept_i, kept_cnt, p,
              base=base, n_insert=n_insert, m=m, max_m=max_m, metric=metric)
    for u in range(n_insert):
        if not warp_has_key(keys, base + u):
            row, cnt = _forward_row(kept_i, kept_cnt, u, m, max_m)
            links[base + u] = torch.tensor(row, dtype=torch.int32)
            counts[base + u] = cnt
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
    """The kernel's schedule, rendered here from the sorted targets and the
    kept lists (the forward rows its own), wires wiring_case's batch
    exactly as the twin's forward rows and re-prune applied op by op in
    chain order do: every metric, float32 and bf16 rows, maxM 8 and the
    main path's 32 (the warp tier) and the default 200 (the block tier).
    (One op at a time, not the twin's rounds: torch's bf16 rsqrt on the CPU
    gives other bits in its vectorised loop than in its scalar tail, so a
    bf16 cosine re-prune's distances there depend on how many re-prunes
    share its round; on the card they do not.)"""
    arrays, (base, n_insert, m) = wiring_case(max_m * 3 + METRICS[metric],
                                              max_m)
    kw = dict(base=base, m=m, max_m=max_m, metric=METRICS[metric])
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu", dtype)
    keys, perm = tb._chain_order(tb._back_link_targets(kept, cnt, n_insert,
                                                       m=m))
    tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                      max_m=max_m)
    pl, pc = serial_replay(vectors, links, counts, keys, perm, **kw)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu", dtype)
    kl, kc = kernel_schedule(vectors, links, counts, keys, perm, kept, cnt,
                             n_insert=n_insert, **kw)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    full = torch.from_numpy(arrays[2] == max_m)
    assert bool((pc[full] < max_m).any())               # re-prunes pruned
    # chains that target the batch's own members, and members no chain
    # targets
    targets = set(keys[keys != tb.NO_TARGET].tolist())
    members = set(range(base, base + n_insert))
    assert members & targets and members - targets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", list(METRICS))
def test_kernel_schedule_long_chains(metric, dtype):
    """Chains of more than 32 ops (the warp tier reads a chain's ops 32 at
    a time) that append, re-prune, append where a re-prune left room and
    re-prune again: the rendered schedule equals the twin's ops applied
    one by one."""
    arrays, (base, n_insert, m) = long_chain_case(METRICS[metric])
    kw = dict(base=base, m=m, max_m=32, metric=METRICS[metric])
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu", dtype)
    keys, perm = tb._chain_order(tb._back_link_targets(kept, cnt, n_insert,
                                                       m=m))
    kl, kc = kernel_schedule(vectors, links, counts, keys, perm, kept, cnt,
                             n_insert=n_insert, **kw)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu", dtype)
    tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                      max_m=32)
    pl, pc = serial_replay(vectors, links, counts, keys, perm, **kw)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    _, length = torch.unique(keys[keys != tb.NO_TARGET], return_counts=True)
    assert int(length.max()) > 32


def test_mask_tasks_cover_every_scanned_word():
    """The block tier: a task of rows 4 g .. 4 g + 3 computes words 0 ..
    (4 g + 3) >> 5, every word the scan reads for each of its rows (0 .. j
    >> 5), at every width a config admits.  The warp tier: the lower
    triangle's 4 x 4 tiles, numbered J (J + 1) / 2 + R, cover every pair
    r < j < nv once, at every set the tier takes (nv <= 64)."""
    for j in range(2 * MAX_M + 1):
        g = j // ROWS_PER_TASK
        assert (j >> 5) <= ((g * ROWS_PER_TASK + ROWS_PER_TASK - 1) >> 5)
    for nv in range(1, cg.CONNECT_WARP_MAX_C + 1):
        nb = -(-nv // TILE)
        seen = []
        for tile in range(nb * (nb + 1) // 2):
            big_j = int(((8 * tile + 1) ** 0.5 - 1) / 2)
            while (big_j + 1) * (big_j + 2) // 2 <= tile:
                big_j += 1
            while big_j * (big_j + 1) // 2 > tile:
                big_j -= 1
            big_r = tile - big_j * (big_j + 1) // 2
            seen += [(big_j * TILE + u, big_r * TILE + v)
                     for u in range(TILE) for v in range(TILE)]
        pairs = [(j, r) for j, r in seen if r < j < nv]
        assert sorted(pairs) == [(j, r) for j in range(nv) for r in range(j)]


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 31), (3, 32),
                                    (4, 33), (5, 4096), (6, 5000)])
def test_warp_has_key(seed, n):
    """The warp's 32-way search finds exactly the keys a sorted run holds:
    runs of repeated keys, the NO_TARGET tail, keys before the first and
    past the last."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 3 * n + 2, n)).astype(np.int64)
    keys[rng.random(n) < 0.2] = tb.NO_TARGET
    keys = np.sort(keys).tolist()
    for v in range(-1, 3 * n + 4):
        assert warp_has_key(keys, v) == (v in keys)


@pytest.mark.parametrize("c,dims,itemsize,tier,threads", [
    (9, 8, 4, "warp", 128), (33, 128, 4, "warp", 128),
    (33, 128, 2, "warp", 128), (33, 7, 2, "warp", 128),
    (64, 128, 4, "warp", 128), (64, 600, 4, "warp", 32),
    (65, 8, 4, "staged", 256), (201, 128, 4, "staged", 256),
    (201, 400, 4, "masks only", 256), (1025, 8, 4, "staged", 256),
    (1025, 128, 4, "masks only", 256), (64, MAX_DIMS, 4, "masks only", 256),
    (1401, 8, 4, "device masks", 256),
    (2 * MAX_M + 1, MAX_DIMS, 4, "device masks", 256)])
def test_connect_layout(c, dims, itemsize, tier, threads):
    """_connect_layout, re-derived.  The warp tier (c <= 64): a warp's
    staging barrier (16 bytes), masks (8 bytes a candidate), row, d, two
    norms and order (4 bytes each), rounded to 16 bytes, then c + 1 rows at a stride of 16-byte
    chunks rounded up to a multiple of 8; four warps a block where they fit SMEM_LIMIT, else fewer (and
    the block tier where not one does).  The block tier: the ids, d, two
    norms and order (20 bytes a candidate), the kept words and prefixes and
    8 scalars; the masks where they fit in SMEM_LIMIT, the float32 rows
    (odd stride) where those fit too."""
    lay = cg._connect_layout(c, dims, itemsize)
    assert (lay.tier, lay.threads) == (tier, threads)
    if tier == "warp":
        chunks = -(-dims * itemsize // 16 // 8) * 8
        assert chunks % 8 == 0 and chunks * 16 >= dims * itemsize
        per = 16 + -(-28 * c // 16) * 16 + (c + 1) * chunks * 16
        assert per % 16 == 0
        assert lay.smem == threads // 32 * per
        assert (threads // 32 == cg.CONNECT_WARPS
                or (threads // 32 + 1) * per > cg.SMEM_LIMIT)
    else:
        w = -(-c // 32)
        base = 20 * c + 8 * w + 32
        in_smem, stage = {"staged": (True, True), "masks only": (True, False),
                          "device masks": (False, False)}[tier]
        assert lay.smem == (base + 4 * c * w * in_smem
                            + 4 * c * (dims | 1) * stage)
    assert lay.smem <= cg.SMEM_LIMIT


def test_connect_layout_main_path_residency():
    """Config 1's sets (C = 33, D = 128, float32): four warps a block of
    73,408 bytes, so three blocks (1,584 warps on 132 SMs) are resident at
    the card's 233,472 bytes an SM (1,024 a block reserved)."""
    lay = cg._connect_layout(33, 128, 4)
    assert lay == ("warp", 73_408, 128)
    assert 3 * (lay.smem + 1024) <= 233_472 < 4 * (lay.smem + 1024)
    assert 3 * lay.threads // 32 * 132 >= 1_500


def test_connect_layout_takes_every_config():
    """Every maxM HnswConfig admits (2 .. 2 MAX_M) has a tier at any D: no
    ValueError; a wider set than any config's raises one."""
    for max_m in range(2, 2 * MAX_M + 1, 2):
        cg._connect_layout(max_m + 1, MAX_DIMS)
    for dims in (1, 7, 128, 1000, MAX_DIMS):
        for itemsize in (2, 4):
            cg._connect_layout(33, dims, itemsize)
    with pytest.raises(ValueError, match="shared memory"):
        cg._connect_layout(20_000, 8)


@pytest.mark.parametrize("bm,c,dims,sms,want", [
    (4096, 33, 128, 132, 1024), (100, 33, 128, 132, 25),
    (1, 33, 128, 132, 1), (4096, 65, 8, 132, 528), (100, 201, 8, 132, 100),
    (2_800_000, 1401, 8, 132, 528),
    (2_800_000, 8193, 8, 132, (1 << 30) // (4 * 8193 * 257))])
def test_connect_blocks(bm, c, dims, sms, want):
    """The warp tier: a warp a sorted op (four a block).  The block tier:
    four blocks an SM, no more than the ops, and no more than the masks'
    scratch (SCRATCH_BYTES) holds where they live in device memory."""
    lay = cg._connect_layout(c, dims)
    assert cg._connect_blocks(bm, c, lay, sms) == want


def test_connect_batch_wrapper_on_cpu():
    """On CPU tensors the wrapper is the twin (_connect_sorted_plain: the
    forward rows, then _replay_chains): no launch counted, no plain replay
    counted as the card's; on a device with no kernel it raises."""
    arrays, (base, n_insert, m) = wiring_case(11, 8)
    kw = dict(base=base, m=m, max_m=8, metric_value=0)
    launches, plain = cg.LAUNCHES["connect_batch"], tb.PLAIN_CONNECTS_ON_CARD
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    keys, perm = tb._chain_order(tb._back_link_targets(kept, cnt, n_insert,
                                                       m=m))
    cg.connect_batch(vectors, links, counts, keys, perm, kept, cnt,
                     n_insert=n_insert, **kw)
    got = links, counts
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                      max_m=8)
    tb._replay_chains(vectors, links, counts, keys, perm, **kw)
    assert torch.equal(got[0], links) and torch.equal(got[1], counts)
    assert cg.LAUNCHES["connect_batch"] == launches
    assert tb.PLAIN_CONNECTS_ON_CARD == plain
    meta = [t.to("meta") for t in wiring_tensors(arrays, "cpu")]
    with pytest.raises(ValueError, match="no kernel"):
        cg.connect_batch(meta[0], meta[1], meta[2], keys.to("meta"),
                         perm.to("meta"), meta[3], meta[4],
                         n_insert=n_insert, **kw)


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
    want = links, counts
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    keys, perm = tb._chain_order(tb._back_link_targets(kept, cnt, n_insert,
                                                       m=m))
    assert bool((keys == tb.NO_TARGET).all())
    kernel_schedule(vectors, links, counts, keys, perm, kept, cnt,
                    base=base, n_insert=n_insert, m=m, max_m=8, metric=0)
    assert torch.equal(links, want[0]) and torch.equal(counts, want[1])


@pytest.mark.parametrize("max_m", [8, 32, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", list(METRICS))
def test_card_route_host_half_matches_jax(metric, dtype, max_m):
    """The card route's host half (core/build._back_link_targets and
    _chain_order: torch ops that write nothing into links) gives the
    kernel operands whose plain twin (_connect_sorted_plain: the forward
    rows, then the chains) wires the batch exactly as the JAX package's
    _connect_batch does, bit for bit: every metric, float32 and bf16 rows,
    maxM 8, 32 and 200.  Cosine's rows are continuous (XLA's CPU rsqrt is
    an approximation; integer rows make exact ties its ulp breaks
    otherwise, see tests/test_torch_build.py)."""
    (vectors, links, counts, kept, cnt), (base, n_insert, m) = wiring_case(
        max_m * 5 + METRICS[metric], max_m,
        rows="normal" if metric == "cosine" else "integer")
    kw = dict(m=m, max_m=max_m, metric_value=METRICS[metric])
    jl, jc = jb._connect_batch(
        jnp.asarray(vectors, getattr(jnp, dtype)), jnp.asarray(links),
        jnp.asarray(counts), jnp.int32(base), jnp.asarray(kept),
        jnp.asarray(cnt), jnp.int32(n_insert), **kw)
    tl, tc = torch.from_numpy(links.copy()), torch.from_numpy(counts.copy())
    tk, tn = torch.from_numpy(kept), torch.from_numpy(cnt)
    keys, perm = tb._chain_order(tb._back_link_targets(tk, tn, n_insert,
                                                       m=m))
    assert torch.equal(tl, torch.from_numpy(links))     # nothing written yet
    assert torch.equal(tc, torch.from_numpy(counts))
    tb._connect_sorted_plain(
        torch.from_numpy(vectors).to(getattr(torch, dtype)), tl, tc, keys,
        perm, tk, tn, base=base, n_insert=n_insert, **kw)
    full = counts == max_m
    assert (np.asarray(jl)[full] != links[full]).any()   # re-prunes ran
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("seed,max_m", [(0, 8), (1, 8), (2, 32), (3, 200)])
def test_chain_targets_name_the_repruned(monkeypatch, seed, max_m):
    """chain_targets (chip_smoke.py's split of a wiring's targets into
    those that only append and those that re-prune) names exactly the
    targets the plain twin re-prunes, from the counts before the replay."""
    arrays, (base, n_insert, m) = wiring_case(seed, max_m)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                      max_m=max_m)
    keys, perm = tb._chain_order(tb._back_link_targets(kept, cnt, n_insert,
                                                       m=m))
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


@pytest.mark.parametrize("case", ["dropped", "swapped"])
@pytest.mark.parametrize("max_m", [8, 32])
@pytest.mark.parametrize("metric", ["l2", "manhattan"])
def test_reprune_witness(metric, max_m, case):
    """reprune_witness (chip_smoke.py's account of the re-pruned rows that
    differ from the twin's) replays each re-pruned chain to the twin's own
    row, and on integer rows its float64 replay agrees.  A row that lacks
    the twin's second kept candidate is found at that candidate, decided
    by a kept candidate's comparison that both the twin's float32 and the
    float64 distances make on the keeping side; a row with the twin's
    first two candidates swapped is a tie at slot 0, the twin's order the
    nearer-first one in float32 and in float64."""
    arrays, (base, n_insert, m) = wiring_case(5 + max_m, max_m)
    vectors, links, counts, kept, cnt = wiring_tensors(arrays, "cpu")
    keys, perm = tb._chain_order(tb._back_link_targets(kept, cnt, n_insert,
                                                       m=m))
    tb._forward_links(links, counts, base, kept, cnt, n_insert, m=m,
                      max_m=max_m)
    start_links, start_counts = links.clone(), counts.clone()
    targets, repruned = chain_targets(keys, counts, max_m)
    targets = targets[repruned]
    tb._replay_chains(vectors, links, counts, keys, perm, base=base, m=m,
                      max_m=max_m, metric_value=METRICS[metric])
    got_rows, got_counts = links[targets].clone(), counts[targets].clone()
    kw = dict(base=base, m=m, max_m=max_m, metric=METRICS[metric])
    same = reprune_witness(vectors, start_links, start_counts, keys, perm,
                           targets, got_rows, got_counts, **kw)
    assert len(same) == len(targets) > 0
    for res, row, n in zip(same, got_rows, got_counts):
        assert res["reprunes"] >= 1 and res["position"] is None
        assert res["twin_row"] == res["kernel_row"] == row[:n].tolist()
        assert res["f64_row"] == res["twin_row"]
    i = next(i for i, r in enumerate(same) if len(r["twin_row"]) >= 2)
    first, second = got_rows[i, 0].item(), got_rows[i, 1].item()
    if case == "dropped":
        got_rows[i, 1:-1] = got_rows[i, 2:].clone()
        got_rows[i, -1] = -1
        got_counts[i] -= 1
    else:
        got_rows[i, 0], got_rows[i, 1] = second, first
    res = reprune_witness(vectors, start_links, start_counts, keys, perm,
                          targets[i:i + 1], got_rows[i:i + 1],
                          got_counts[i:i + 1], **kw)[0]
    assert res["margin_ulps"] >= 0 and res["f64_margin_ulps"] >= 0
    if case == "dropped":
        assert res["kind"] == "pair" and res["position"] >= 1
        assert res["gap_ulps"] >= 0 and second not in res["kernel_row"]
    else:
        assert res["kind"] == "tie" and res["position"] == 0
        assert res["kernel_row"][:2] == [second, first]
