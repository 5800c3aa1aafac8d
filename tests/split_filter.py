"""A pure-torch model of the sweep kernel's wide selection across splits
(csrc/bruteforce_topk.cu, "A bound shared across the splits").

One query's rows are cut into S splits of whole tiles, as the kernel's
launch cuts them.  Each split takes its rows a tile at a time in ascending
id order and keeps a sorted list of at most k_run (score, id) entries.
Before a tile it reads the bound: the largest of the S slots as some
earlier moment left them (a read may be stale by any number of other
splits' publications).  It admits a row only if the row scores at most
the bound and less than the k-th entry its list had when the tile began.
After the tile it publishes its list's j-th score (j = ceil(k_run / S))
to its own slot when that fell.  Which split takes its next tile is drawn
at random, so the splits' progress interleaves as blocks on a card may.
The merged partial lists must give the plain top k_run, whatever the
interleaving and whatever stale slots a split read.
"""

import math

import torch

INF = float("inf")


def plain_topk(scores: torch.Tensor, k_run: int):
    """The k_run least (score, id) pairs of ``scores`` f32[n] (ids are the
    positions; +inf rows are masked and never taken), as a list padded
    with (+inf, -1)."""
    live = [(float(s), i) for i, s in enumerate(scores.tolist()) if s != INF]
    live.sort()
    return (live + [(INF, -1)] * k_run)[:k_run]


def split_filter(scores: torch.Tensor, k_run: int, splits: int, tile: int,
                 gen: torch.Generator, strict: bool = False,
                 max_lag: int | None = None):
    """The pool the kernel's wide selection would merge for one query
    whose rows score ``scores`` f32[n]: S = ``splits`` splits of whole
    ``tile``-row tiles.  ``gen`` draws the interleaving and the staleness
    of each bound read (up to ``max_lag`` publications old; any age when
    None).  ``strict`` admits rows that score below the bound, not at it:
    unsafe, for the test that shows it."""
    n = scores.shape[0]
    per = tile * math.ceil(math.ceil(n / splits) / tile)
    rank = -(-k_run // splits)
    lists = [[] for _ in range(splits)]
    slots = [INF] * splits
    history = [tuple(slots)]            # every state the slots have had
    nxt = [min(n, s * per) for s in range(splits)]
    end = [min(n, (s + 1) * per) for s in range(splits)]
    vals = scores.tolist()
    while True:
        active = [s for s in range(splits) if nxt[s] < end[s]]
        if not active:
            break
        s = active[int(torch.randint(len(active), (1,), generator=gen))]
        oldest = 0 if max_lag is None else max(0, len(history) - 1 - max_lag)
        seen = history[int(torch.randint(oldest, len(history), (1,),
                                         generator=gen))]
        tau = max(seen)
        own = lists[s]
        kth = own[k_run - 1][0] if len(own) >= k_run else INF
        rows = range(nxt[s], min(nxt[s] + tile, end[s]))
        nxt[s] = rows.stop
        taken = [(vals[r], r) for r in rows
                 if vals[r] < kth and (vals[r] < tau if strict
                                       else vals[r] <= tau)]
        own = lists[s] = sorted(own + taken)[:k_run]
        jth = own[rank - 1][0] if len(own) >= rank else INF
        if jth < slots[s]:
            slots[s] = jth
            history.append(tuple(slots))
    merged = sorted(e for own in lists for e in own)
    return (merged + [(INF, -1)] * k_run)[:k_run]
