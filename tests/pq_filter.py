"""A pure-torch model of the PQ kernel's sweep (csrc/pq_topk.cu,
pq_sweep_kernel): the filter that fills one query's candidate segments.

One query's rows are cut into S splits of whole tiles, as the kernel's
launch cuts them.  Each split takes its rows a tile at a time in ascending
id order.  Before a tile it holds a bound: the least of its own list's
k_run-th score (when k_run <= 32) and the bound the S slots give as some
earlier moment left them (a read may be stale by any number of other
splits' publications): lane l folds slots l, l + 32, ... into their
largest, +inf while any is unpublished, and the bound is the P-th least of
the 32 folds, P = ceil(k_run / j).  Every row of the tile that scores at
most the bound is appended to the split's segment: the first ``cap`` are
stored, the count goes on.  After the tile the list takes the 32 least of
itself and the tile's stored rows (the kernel stages the rows that beat
its last, or reads them back past 32), and its slot takes the list's j-th
when that fell below it.  The shared slots are read before the first
tile and then every ``refresh`` tiles (in between a split's bound falls
only with its own list).  With ``seed`` tiles, a seeding pass sweeps the
first ``seed`` tiles of every split first (its segments dropped), and the
sweep proper starts from the slots it left, with empty lists and
segments.  Which split takes its next tile is drawn at random, so the
splits' progress interleaves as blocks on a card may.
"""

import math

import torch

INF = float("inf")
LIST = 32


def fold_bound(slots, k_run: int, rank: int) -> float:
    """The bound S slots of rank j give: the ceil(k_run / j)-th least of
    the 32 lanes' folds (+inf for a lane with no slot)."""
    folds = [max(slots[lane::LIST]) if lane < len(slots) else INF
             for lane in range(LIST)]
    return sorted(folds)[-(-k_run // rank) - 1]


def pq_filter(scores: torch.Tensor, k_run: int, splits: int, tile: int,
              cap: int, rank: int, gen: torch.Generator,
              max_lag: int | None = None, refresh: int = 1, seed: int = 0):
    """(segments: a list a split of the stored (score, id), counts a
    split, the final slots, or None without a bound) for one query whose
    rows score ``scores`` f32[n] (+inf: masked, never appended), the
    splits publishing their lists' ``rank``-th (0: no shared bound).
    ``gen`` draws the interleaving and the staleness of each bound read
    (up to ``max_lag`` publications old; any age when None)."""
    slots = [INF] * splits
    if seed and rank > 0:
        _, _, slots = _sweep(scores, k_run, splits, tile, cap, rank, gen,
                             max_lag, refresh, seed, slots)
    return _sweep(scores, k_run, splits, tile, cap, rank, gen, max_lag,
                  refresh, None, slots)


def _sweep(scores, k_run, splits, tile, cap, rank, gen, max_lag, refresh,
           limit, slots):
    """One launch of the model: each split's first ``limit`` tiles (all
    when None), from ``slots``."""
    n = scores.shape[0]
    per = tile * math.ceil(math.ceil(n / splits) / tile) if n else 0
    shared = rank > 0
    slots = list(slots)
    history = [tuple(slots)]
    lists = [[] for _ in range(splits)]
    segments = [[] for _ in range(splits)]
    counts = [0] * splits
    nxt = [min(n, s * per) for s in range(splits)]
    end = [min(n, (s + 1) * per) for s in range(splits)]
    if limit is not None:
        end = [min(e, b + limit * tile) for b, e in zip(nxt, end)]
    taus = [None] * splits
    done = [0] * splits
    vals = scores.tolist()

    def read():
        oldest = 0 if max_lag is None else max(0, len(history) - 1 - max_lag)
        seen = history[int(torch.randint(oldest, len(history), (1,),
                                         generator=gen))]
        return fold_bound(seen, k_run, rank) if shared else INF
    while True:
        active = [s for s in range(splits) if nxt[s] < end[s]]
        if not active:
            break
        s = active[int(torch.randint(len(active), (1,), generator=gen))]
        if taus[s] is None:
            taus[s] = read()
        own = lists[s]
        if k_run <= LIST and len(own) >= k_run:
            taus[s] = min(taus[s], own[k_run - 1])
        tau = taus[s]
        stored = []
        rows = range(nxt[s], min(nxt[s] + tile, end[s]))
        nxt[s] = rows.stop
        for r in rows:
            if vals[r] != INF and vals[r] <= tau:
                if counts[s] < cap:
                    segments[s].append((vals[r], r))
                    stored.append(vals[r])
                counts[s] += 1
        lists[s] = sorted(own + stored)[:LIST]
        if (shared and len(lists[s]) >= rank
                and lists[s][rank - 1] < slots[s]):
            slots[s] = lists[s][rank - 1]
            history.append(tuple(slots))
        done[s] += 1
        if done[s] % refresh == 0:
            taus[s] = min(taus[s], read())
    return segments, counts, (slots if shared else None)


def select(segments, slots, k_run: int, rank: int):
    """The select launch's pool from one query's segments: the stored rows
    that score at most the bound the slots give (all without a bound), the
    k_run least (score, id), padded with (+inf, -1)."""
    tau = fold_bound(slots, k_run, rank) if slots is not None else INF
    rows = sorted(e for seg in segments for e in seg if e[0] <= tau)
    return (rows + [(INF, -1)] * k_run)[:k_run]
