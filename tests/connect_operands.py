"""The build's wiring on a synthetic graph state, and the kernel against its
plain twin: one source of cases for the CPU tests (tests/test_torch_build.py,
tests/test_torch_connect.py), the card tests (tests/test_torch_cuda.py)
and chip_smoke.py, which imports it without pytest.  Imports no JAX."""

import numpy as np
import torch


def wiring_case(seed, max_m, *, b=16, n_insert=13, base=300, dims=8,
                rows="integer"):
    """A wiring's inputs at maxM = ``max_m`` (m = maxM / 2, at least 1):
    rows of integers in [-2, 2] (every sum, product and bf16 rounding exact
    whatever the order) or, ``rows="normal"``, normal floats; links of
    random distinct ids with half the rows full (a few of those with -1
    slots inside), and kept lists drawn from a small pool of hubs and the
    batch's own earlier members (long chains, members as targets), with
    invalid slots inside the kept counts and members past ``n_insert``.
    Returns numpy (vectors f32[cap, D], links i32[cap, maxM], counts
    i32[cap], kept i32[b, m], cnt i32[b]) and (base, n_insert, m)."""
    rng = np.random.default_rng(seed)
    m = max(max_m // 2, 1)
    cap = base + b + 4
    if rows == "integer":
        vectors = rng.integers(-2, 3, size=(cap, dims)).astype(np.float32)
    else:
        vectors = rng.normal(size=(cap, dims)).astype(np.float32)
    links = np.full((cap, max_m), -1, np.int32)
    counts = np.zeros(cap, np.int32)
    for i in range(base):
        k = max_m if rng.random() < 0.5 else int(rng.integers(0, max_m))
        k = min(k, base - 1)
        ids = rng.choice(base - 1, k, replace=False)
        links[i, :k] = ids + (ids >= i)              # never itself
        counts[i] = k
    full = np.nonzero(counts == max_m)[0]
    holes = full[rng.random(len(full)) < 0.1]
    links[holes, rng.integers(0, max_m, len(holes))] = -1
    hubs = rng.choice(base, min(base, max(m + 4, int(1.5 * m))),
                      replace=False)
    kept = np.full((b, m), -1, np.int32)
    for j in range(b):
        pool = np.concatenate([hubs, base + np.arange(j)])
        kept[j] = rng.choice(pool, m, replace=False)
    kept[rng.random((b, m)) < 0.05] = -1
    cnt = rng.integers(0, m + 1, b).astype(np.int32)
    cnt[: b // 2] = m
    return (vectors, links, counts, kept, cnt), (base, n_insert, m)


def wiring_tensors(arrays, device, dtype=torch.float32):
    """wiring_case's arrays as tensors on ``device``, the rows in ``dtype``
    (fresh copies: the wiring updates links and counts in place)."""
    vectors, links, counts, kept, cnt = (torch.from_numpy(np.array(a))
                                         for a in arrays)
    return (vectors.to(device=device, dtype=dtype), links.to(device),
            counts.to(device), kept.to(device), cnt.to(device))


def kernel_and_twin(arrays, meta, metric, device, dtype=torch.float32):
    """The wiring of wiring_case's batch through core/build._connect_batch
    (on a CUDA device: one connect_batch launch) and through the plain
    twin core/build._connect_batch_plain, each on its own copy on
    ``device``.  Returns ((links, counts) of the kernel route, of the
    twin, the kernel route's connect_batch launches)."""
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops import cuda_graph
    base, n_insert, m = meta
    max_m = arrays[1].shape[1]
    kw = dict(m=m, max_m=max_m, metric_value=metric)
    out = []
    for fn in (core_build._connect_batch, core_build._connect_batch_plain):
        vectors, links, counts, kept, cnt = wiring_tensors(arrays, device,
                                                           dtype)
        before = cuda_graph.LAUNCHES["connect_batch"]
        fn(vectors, links, counts, base, kept, cnt, n_insert, **kw)
        out.append((links, counts,
                    cuda_graph.LAUNCHES["connect_batch"] - before))
    (kl, kc, launches), (pl, pc, _) = out
    return (kl, kc), (pl, pc), launches


def chain_targets(keys, counts, max_m):
    """The targets of a wiring's sorted back-link ops (core/build's
    _chain_order keys, invalid ops at NO_TARGET) and which of them
    re-prune at least once, read before the replay from ``counts`` (the
    counts after the forward rows): appends alone raise a count by one an
    op until it reaches maxM, so a chain re-prunes iff its target's count
    plus its length passes maxM.  Returns (targets i64[T] ascending,
    repruned bool[T])."""
    from pg_embedding_tpu_torch.core.build import NO_TARGET
    targets, length = torch.unique(keys[keys != NO_TARGET],
                                   return_counts=True)
    targets = targets.long()
    return targets, counts[targets].long() + length > max_m


def long_chain_case(seed, max_m=32, *, b=64, hubs=20, base=300, dims=8):
    """Chains longer than a warp's 32 ops: every member keeps m = maxM / 2
    links drawn from ``hubs`` targets one slot short of full (~b m / hubs
    ops each), so a chain appends once, then re-prunes, appends where a
    re-prune left room, and re-prunes again, op after op; integer rows.
    Returns wiring_case's (arrays, (base, n_insert, m))."""
    arrays, (base, _, m) = wiring_case(seed, max_m, b=b, n_insert=b,
                                       base=base, dims=dims)
    vectors, links, counts, kept, cnt = arrays
    rng = np.random.default_rng(seed)
    targets = rng.choice(base, hubs, replace=False)
    for i in targets:
        links[i] = -1
        links[i, :max_m - 1] = rng.choice(np.delete(np.arange(base), i),
                                          max_m - 1, replace=False)
        counts[i] = max_m - 1
    kept[:] = np.stack([rng.choice(targets, m, replace=False)
                        for _ in range(b)])
    cnt[:] = m
    return (vectors, links, counts, kept, cnt), (base, b, m)


def _dist64(t, p, metric):
    """Distances in float64 from row ``t`` [D] to rows ``p`` [K, D], in the
    difference form for L2 and Manhattan, every sum in float64."""
    if metric == 0:
        return np.sqrt(((p - t) ** 2).sum(axis=1))
    if metric == 1:
        na, nb = (t * t).sum(), (p * p).sum(axis=1)
        return 1.0 - (p @ t) / np.sqrt(np.maximum(na * nb, 1e-30))
    return np.abs(p - t).sum(axis=1)


def _reprune64(rows, ids, t, max_m, metric):
    """core/build._reprune of one set in float64: ``ids`` the maxM + 1
    candidates (-1 invalid), ``rows`` their float64 rows [C, D] (the
    target's ``t``).  Returns (kept ids in the row's order, d, pair, the
    scan order)."""
    valid = ids >= 0
    d = np.where(valid, _dist64(t, rows, metric), np.inf)
    pair = np.stack([_dist64(rows[j], rows, metric) for j in range(len(ids))])
    order = sorted(range(len(ids)), key=lambda j: (d[j], -ids[j]))
    if valid.sum() < max_m:                     # kept farthest-first
        asc = sorted(np.nonzero(valid)[0], key=lambda j: (d[j], ids[j]))
        return [int(ids[j]) for j in reversed(asc)], d, pair, order
    kept = []
    for j in order:
        if valid[j] and len(kept) < max_m and not any(
                pair[j, r] < d[j] for r in kept):
            kept.append(j)
    return [int(ids[j]) for j in kept], d, pair, order


def reprune_witness(vectors, links, counts, keys, perm, targets, got_rows,
                    got_counts, *, base, m, max_m, metric):
    """What separates a kernel's re-pruned rows from the twin's.  For each
    target in ``targets`` (i64[T]) replays its chain (the sorted ops of
    ``keys`` / ``perm``, from ``links`` / ``counts`` as they stand after
    the forward rows) twice: in the twin's float32 forms
    (core/build._reprune, on ``vectors``' device) and in float64 (the
    difference form for every distance, float64 sums: the second witness).
    In the twin's last re-prune it walks the scan order to the first
    candidate that the kernel's row (``got_rows`` / ``got_counts``, the
    target's row and count after the kernel) keeps and the twin rejects,
    or the other way round, and measures the margin there: pair - d for
    the kept candidate r that decides it (the least pair[j, r] - d[j]:
    negative rejects), in float32 ulps of that d, from the twin's float32
    values and from the float64 ones, and the gap from d to its
    neighbours in the scan order.  Where both keep the same candidates in
    another order, it measures the tie instead: at the first slot where
    the rows differ, d of the kernel's candidate less d of the twin's, in
    float32 ulps of the twin's, in float32 and in float64.  Returns a dict
    a target: reprunes, twin_row / f64_row / kernel_row (id lists),
    position (the scan position, or for a tie the row's slot; None where
    the kernel's row equals the twin's), kind ("pair": a kept candidate's
    comparison decides it; "order": no kept candidate precedes it;
    "limit": maxM were kept; "tie": the same candidates in another order;
    "unpruned": fewer than maxM valid, every one kept; "earlier": the
    kernel's row holds a candidate of no set in the twin's last re-prune),
    margin_ulps, f64_margin_ulps, gap_ulps (None for a tie)."""
    from pg_embedding_tpu_torch.core import build as core_build
    from pg_embedding_tpu_torch.ops.distance import (dist_one_to_many,
                                                     pairwise_dist)
    dev = vectors.device
    keys_l, perm_l = keys.tolist(), perm.tolist()
    where = {}
    for p, k in enumerate(keys_l):
        where.setdefault(k, []).append(p)
    out = []
    for i, t in enumerate(targets.tolist()):
        srcs = [base + perm_l[p] // m for p in where[t]]
        row32, cnt32 = links[t].clone(), int(counts[t])
        row64 = [x for x in links[t, :cnt32].tolist()]
        t64 = vectors[t].double().cpu().numpy()
        last, after, reprunes = None, [], 0
        for s in srcs:
            if cnt32 < max_m:
                row32[cnt32] = s
                cnt32 += 1
                after.append(s)
            else:
                cand = torch.cat([row32, torch.tensor([s], dtype=torch.int32,
                                                      device=dev)])
                # _reprune's forms and shapes ([1, C, D])
                cvecs = vectors[cand.clamp(min=0).long()][None]
                d = dist_one_to_many(vectors[t:t + 1], cvecs, metric)[0]
                d = torch.where(cand >= 0, d.to(torch.float32), np.inf)
                pair = pairwise_dist(cvecs, cvecs, metric)[0]
                kept, n = core_build._reprune(
                    vectors, row32[None], torch.tensor([t], device=dev),
                    torch.tensor([s], dtype=torch.int32, device=dev),
                    max_m=max_m, metric_value=metric)
                last = (cand.tolist(), d.tolist(), pair.tolist())
                row32, cnt32, after = kept[0].clone(), int(n[0]), []
                reprunes += 1
            if len(row64) < max_m:
                row64.append(s)
            else:
                ids = np.array(row64 + [s])
                rows = vectors[torch.as_tensor(ids).clamp(min=0).to(
                    dev)].double().cpu().numpy()
                row64 = _reprune64(rows, ids, t64, max_m, metric)[0]
        twin = row32[:cnt32].tolist()
        kernel = got_rows[i, :int(got_counts[i])].tolist()
        res = dict(target=t, reprunes=reprunes, twin_row=twin, f64_row=row64,
                   kernel_row=kernel, position=None, kind=None,
                   margin_ulps=None, f64_margin_ulps=None, gap_ulps=None)
        out.append(res)
        if kernel == twin or last is None:
            continue
        cand, d, pair = last
        in_kernel = set(kernel) - set(after)
        if not in_kernel <= set(cand):
            res["kind"] = "earlier"
            continue
        if sum(c >= 0 for c in cand) < max_m:
            res["kind"] = "unpruned"
            continue
        order = sorted(range(len(cand)), key=lambda j: (d[j], -cand[j]))
        if set(kernel) == set(twin):
            slot = next(q for q, (a, b) in enumerate(zip(twin, kernel))
                        if a != b)
            a, b = cand.index(twin[slot]), cand.index(kernel[slot])
            ulp = float(np.spacing(np.float32(abs(d[a]))))
            rows = vectors[torch.tensor([t, cand[a], cand[b]],
                                        device=dev).long()]
            rows = rows.double().cpu().numpy()
            d64 = _dist64(rows[0], rows[1:], metric)
            res.update(position=slot, kind="tie",
                       margin_ulps=(d[b] - d[a]) / ulp,
                       f64_margin_ulps=float(d64[1] - d64[0]) / ulp)
            continue
        kept = []
        for pos, j in enumerate(order):
            keep = (cand[j] >= 0 and len(kept) < max_m and not any(
                pair[j][r] < d[j] for r in kept))
            if keep != (cand[j] in in_kernel):
                ulp = float(np.spacing(np.float32(abs(d[j]))))
                near = [abs(d[j] - d[order[q]]) for q in (pos - 1, pos + 1)
                        if 0 <= q < len(order)]
                res.update(position=pos, gap_ulps=min(near) / ulp)
                if len(kept) >= max_m:
                    res["kind"] = "limit"
                elif not kept:
                    res["kind"] = "order"
                else:
                    r = min(kept, key=lambda r: pair[j][r] - d[j])
                    rows = vectors[torch.tensor([t, cand[j], cand[r]],
                                                device=dev).long()]
                    rows = rows.double().cpu().numpy()
                    d64 = _dist64(rows[0], rows[1:2], metric)[0]
                    p64 = _dist64(rows[1], rows[2:3], metric)[0]
                    res.update(kind="pair",
                               margin_ulps=(pair[j][r] - d[j]) / ulp,
                               f64_margin_ulps=(p64 - d64) / ulp)
                break
            if keep:
                kept.append(j)
    return out
