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
