#!/usr/bin/env python3
"""Smoke run of pg_embedding_tpu_torch on one NVIDIA GPU.

  python3 chip_smoke.py [--n ROWS] [--queries B]

Phases, each printing one line (no failure is caught; any failed check
exits non-zero):
  1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
  2. build the CUDA kernels from the repository's sources;
  3. the kernel: its compiler report (registers, spills) and the TF32
     HMMA instructions of each sweep instance (cuobjdump -sass); against its
     plain torch twin: L2 and cosine, D in {30, 100, 128, 960}, k_run from 1
     to 1024 with each query tile's edges (64 / 65, 256 / 257), B not a
     multiple of the tile, with and without n_valid < N and tombstones, one
     k > n_valid case, up to 1M rows x 1024 queries, for a float32 corpus
     and a bfloat16 one (aligned and an unaligned view); k_run 1502 and
     2100 in pages (bruteforce_topk_paged) against the plain twin's one
     list; at 1M x 128-d,
     B=1024, k_run=12 (CUDA events) each instantiation's time, its bound
     (3 TF32 passes for float32 rows, 2 for bf16, at 495 TFLOP/s) and share
     of it, the plain twin's time, and library_ms: torch.addmm of the L2
     scores in full float32 plus torch.topk (a yardstick the port never
     calls);
  4. the main path at SIFT1M's shape (1,000,000 x 128-d, BASELINE.md
     config 1, bench.py's clustered recipe as utils/io.synthetic_clustered
     draws it, seed 12345): HnswIndex.build,
     graph invariants, search() in auto mode through the kernel, exact and
     graph QPS, recall@10 of the graph route (>= 0.90 at T=8; T=4's is
     printed), deletes never surfacing; before it, a small build that must
     match the same build on the CPU;
  5. on the same index: the serving variants at T=8 (quantized, packed
     int8 / bf16 / float32 records; QPS and recall@10; float32 records give
     the plain walk's ids and order), the bitmap visited set against dense;
     save -> load onto the card (same answers, clean integrity, vacuum);
     WAL crash recovery (snapshot, 10,000 adds + 1,000 deletes, no save,
     load with the log: the live index's state); a scan cursor against
     search(); right after the main path, search(k=1500) on 64 queries,
     past one launch's k_run cap: two kernel launches (pages of 751), and
     the answer equals ops/bruteforce's exact_search on the same rows (ids
     except float64 near-ties, distances rtol 1e-5);
  6. product quantization on the same index: the PQ walk at G=32 (T=8,
     ef=64; train / encode / pack seconds, records GB, QPS and recall@10,
     printed: ~1,000 rows per centre are too many for PQ to rank inside
     ef=64); the card's pq_encode against the CPU's on 100k rows (>= 99.9%
     equal codes, every other one a float64 near-tie) and the card's PQ
     walk against the CPU's on the same state;
  7. last on that index, downcast_corpus("bfloat16") and search() through
     the kernel's bf16 instantiation, held on every query to a float64
     oracle over the stored bf16 rows: recall@10 >= 0.99, and every row it
     returns within the kernel check's near-tie tolerance of the oracle's
     10th distance.  Its recall@10 against the float32 route is printed,
     not held: bf16 rounding of the rows reorders near-ties at rank 10.
     The PQ shadows must be the same tensors after the cast, and the PQ
     walk must still answer;
  8. PQ serving on a second 1M x 128-d index of benchmarks/bench_pq.py's
     recipe (50,000 centres), where the JAX package measured it: the PQ
     walk at G=16, OPQ G=32 and G=32 (G=32 held within 0.03 of the plain
     walk's recall@10, the others printed); tune_sweep_pool(0.95) on 256
     queries, then search(mode="sweep_pq") on all (recall@10 >= 0.95,
     distances equal to a float64 recompute at rtol 1e-5, QPS); save ->
     load (the same codebook bytes, walk and sweep labels);
  9. VectorTable on the card: the knn.sql replay (3-d), then a 20,000 x
     128-d table with <->, <=> and <~> indexes: the seq scan
     (order_by(use_index=False), through the exact entry) against a
     float64 oracle, and the pull scan against order_by through the index.
Phases are timed with utils/profiling's Timer (synchronising the card).
The last three lines are the card's nvidia-smi line, a JSON line of the
kernels, and {"ok": true, "device": {...}}.

Needs a CUDA device and nvcc; without a device it exits non-zero before
printing any result.
"""

import argparse
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

L2, COSINE = 0, 1
SEED = 12345
N_CENTERS = 1_000
# The PQ index's data: benchmarks/bench_pq.py's recipe, where the JAX
# package measured PQ serving.  At bench.py's 1,000 centres a 1M corpus
# holds ~1,000 rows per centre, too many for 4-dim PQ cells to rank inside
# ef=64 (PERF.md, Findings).
PQ_CENTERS = 50_000
DIMS = 128
K = 10
GRAPH_T = 8
# NVIDIA's H100 SXM data sheet, dense: TF32 tensor cores, HBM3
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg):
    print(msg, flush=True)


def make_data(seed, n, n_queries, n_centers=N_CENTERS):
    """SIFT-like clustered synthetic corpus and queries (bench.py's recipe;
    with PQ_CENTERS, benchmarks/bench_pq.py's)."""
    from pg_embedding_tpu_torch.utils.io import synthetic_clustered
    return synthetic_clustered(n, DIMS, n_centers, seed=seed,
                               n_queries=n_queries)


def true_dist(torch, qs, pts, ids, metric):
    """float64 distances of queries [B, D] to rows ids [B, k]."""
    q = qs.double().unsqueeze(1)
    p = pts[ids.clamp(min=0).long()].double()
    if metric == L2:
        return torch.sqrt(((p - q) ** 2).sum(-1))
    dot = (p * q).sum(-1)
    return 1.0 - dot / torch.sqrt((p * p).sum(-1) * (q * q).sum(-1))


def compare(torch, got, want, qs, pts, metric, n_valid, dead):
    """Kernel vs plain: distances to rtol 1e-5; where ids differ, the
    kernel's row must be a near-tie: its float64 distance within 1e-5
    relative of the plain's distance at that rank.  Returns (max abs
    distance error, mismatched ids)."""
    dk, ik = got
    dp, ip = want
    check(torch.equal(torch.isinf(dk), torch.isinf(dp)), "inf pattern")
    fin = torch.isfinite(dp)
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    check(torch.allclose(dk[fin], dp[fin], rtol=1e-5, atol=1e-6),
          f"distances differ by up to {err}")
    ok_ids = ik[ik >= 0]
    check(bool((ok_ids < n_valid).all()), "id past n_valid")
    if dead is not None:
        check(not bool(dead[ok_ids.long()].any()), "tombstone returned")
    diff = ik != ip
    if diff.any():
        d64 = true_dist(torch, qs, pts, ik, metric)[diff]
        ref = dp[diff].double()
        check(bool(((d64 - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all()),
              "an id differs at a rank that is not a near-tie")
    return err, int(diff.sum())


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(torch, cb, dev):
    """Both instantiations against the plain twin, then timed.  Returns
    {kernel name: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}}; the bf16 instantiation's library_ms runs on the float32
    values of its rows."""
    bf16 = torch.bfloat16
    # (metric, rows, dims, queries, k_run, n_valid fraction, tombstones,
    #  corpus dtype)
    f32 = torch.float32
    cases = [
        (L2, 1_000_000, 128, 1024, 12, 1.0, False, f32),
        (COSINE, 1_000_000, 128, 1024, 10, 0.9, True, f32),
        (L2, 300_000, 100, 1024, 102, 1.0, True, f32),
        (COSINE, 300_000, 100, 1024, 1, 0.5, False, f32),
        (L2, 100_000, 960, 1024, 1, 0.8, True, f32),
        (COSINE, 100_000, 960, 1024, 100, 1.0, False, f32),
        (L2, 200_000, 128, 1024, 3, 1.0, False, f32),
        (COSINE, 50_000, 128, 256, 1000, 1.0, True, f32),
        (L2, 50_000, 100, 128, 1024, 0.7, False, f32),
        (L2, 20_000, 128, 1024, 100, 0.004, True, f32),   # k > n_valid
        (L2, 1_000_000, 128, 1024, 12, 1.0, False, bf16),
        (COSINE, 300_000, 100, 1024, 10, 0.9, True, bf16),
        (L2, 100_000, 960, 1024, 12, 1.0, False, bf16),
        # each query tile's k_run edges (QT 128 / 64 / 16), B not a multiple
        # of the tile, D % 4 != 0 (element loads)
        (L2, 200_000, 128, 1000, 64, 1.0, True, f32),
        (COSINE, 200_000, 128, 300, 65, 0.9, False, f32),
        (L2, 100_000, 100, 300, 256, 1.0, False, f32),
        (COSINE, 100_000, 30, 17, 257, 0.8, True, f32),
        (L2, 50_000, 960, 300, 1024, 1.0, True, f32),
        (COSINE, 200_000, 128, 1000, 64, 1.0, False, bf16),
        (L2, 100_000, 960, 17, 65, 0.9, True, bf16),
        (COSINE, 100_000, 30, 300, 256, 1.0, True, bf16),
        (L2, 100_000, 128, 300, 257, 0.8, False, "bf16 unaligned"),
        (COSINE, 50_000, 100, 17, 1024, 1.0, True, "bf16 unaligned"),
        # past one launch's cap: pages of 751 and of 700
        (L2, 200_000, 128, 64, 1502, 0.9, True, f32),
        (COSINE, 100_000, 100, 40, 2100, 1.0, False, bf16),
    ]
    max_err = {f32: 0.0, bf16: 0.0}
    for metric, n, d, b, k_run, frac, tomb, dtype in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + n + d + k_run)
        unaligned = dtype == "bf16 unaligned"
        if unaligned:           # rows start 2 bytes in: element loads
            dtype = bf16
            pts = torch.randn((n + 1, d), generator=g, device=dev).to(dtype)
            pts = pts.view(-1)[1:1 + n * d].view(n, d)
        else:
            pts = torch.randn((n, d), generator=g, device=dev).to(dtype)
        qs = torch.randn((b, d), generator=g, device=dev)
        n_valid = int(n * frac)
        dead = (torch.rand(n, generator=g, device=dev) < 0.05) if tomb else None
        got = cb.bruteforce_topk_paged(qs, pts, k_run, metric, n_valid,
                                       dead)
        want = cb._bruteforce_topk_plain(qs, pts, k_run, metric, n_valid,
                                         dead)
        torch.cuda.synchronize()
        err, n_diff = compare(torch, got, want, qs, pts, metric, n_valid,
                              dead)
        live = n_valid - (0 if dead is None else int(dead[:n_valid].sum()))
        if k_run > live:
            check(bool((got[1][:, live:] == -1).all()), "k > n_valid padding")
        max_err[dtype] = max(max_err[dtype], err)
        log(f"kernel vs plain: {cb._KERNELS[dtype]}"
            f"{' (unaligned view)' if unaligned else ''} "
            f"{'l2' if metric == L2 else 'cosine'} "
            f"N={n} D={d} B={b} k_run={k_run} n_valid={n_valid} "
            f"tombstones={tomb}: max_abs_err={err:.3g} near-tie id "
            f"swaps={n_diff}")
        del pts, qs, got, want

    g = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.randn((1_000_000, 128), generator=g, device=dev)
    qs = torch.randn((1024, 128), generator=g, device=dev)
    (n, d), b, k_run = pts.shape, qs.shape[0], K + 2
    out = {}
    for corpus in (pts, pts.to(bf16)):
        plain_ms = time_ms(torch, lambda: cb._bruteforce_topk_plain(
            qs, corpus, k_run, L2, n), 3)
        ms = time_ms(torch, lambda: cb.bruteforce_topk(qs, corpus, k_run, L2,
                                                       n), 10)
        plain_ms2 = time_ms(torch, lambda: cb._bruteforce_topk_plain(
            qs, corpus, k_run, L2, n), 3)
        lib_ms = library_ms(torch, qs, corpus.float(), k_run)
        name = cb._KERNELS[corpus.dtype]
        bound, bound_by = bound_ms(b, n, d, corpus.element_size(), k_run)
        qt, splits, q_res, smem = cb._launch_shape(
            b, n, k_run, torch.cuda.get_device_properties(dev)
            .multi_processor_count, corpus.element_size(), d)
        log(f"launch shape of {name}: QT={qt}, {splits} splits, resident "
            f"queries {q_res}, {smem} bytes of shared memory per block")
        log(f"timing {name} at 1M x 128-d, B=1024, k=10 (k_run=12): "
            f"kernel {ms:.3f} ms ({b / ms * 1e3:.0f} QPS), bound "
            f"{bound:.3f} ms ({bound_by}; {bound / ms:.1%} of it reached), "
            f"plain {plain_ms:.3f} / {plain_ms2:.3f} ms, library (addmm + "
            f"topk) {lib_ms:.3f} ms")
        out[name] = dict(max_abs_err=max_err[corpus.dtype], ms=ms,
                         plain_ms=(plain_ms + plain_ms2) / 2,
                         bound_ms=bound, bound_by=bound_by,
                         library_ms=lib_ms)
    return out


def bound_ms(b, n, d, itemsize, k_run):
    """The least time the card could take for one launch: the products on
    the TF32 tensor cores (3 passes for float32 rows, 2 for bf16 rows, which
    are exact in TF32) or the bytes (corpus, queries, output lists) at the
    HBM rate, whichever is larger."""
    passes = 3 if itemsize == 4 else 2
    ops = passes * 2.0 * b * n * d
    nbytes = n * d * itemsize + b * d * 4 + b * k_run * 8
    t_ops, t_bytes = ops / PEAK_TF32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def library_ms(torch, qs, rows, k_run):
    """torch.addmm of the L2 scores |p|^2 - 2 q.p in full float32 (|q|^2 is
    the same for a query's every row), then torch.topk: two library calls
    for what the kernel does in one pass.  Timing only; the port never
    calls it."""
    pn = (rows * rows).sum(1).unsqueeze(0)

    def call():
        scores = torch.addmm(pn, qs, rows.T, alpha=-2.0)
        return torch.topk(scores, k_run, dim=1, largest=False)
    return time_ms(torch, call, 3)


def compiler_report(_kernels):
    """ptxas's registers and spills for each sweep instance, and the TF32
    HMMA count of each in the built library's SASS; fails if an instance
    issues no TF32 HMMA."""
    def instance(mangled):
        m = re.search(r"sweep_kernelILi(\d+)ELb([01])E([ft])E", mangled)
        return m and (f"sweep_kernel<QT={m[1]}, "
                      f"{'resident' if m[2] == '1' else 'streamed'} queries, "
                      f"{'float' if m[3] == 'f' else 'bf16'}>")
    name, built = None, set()
    for line in _kernels.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = instance(m[1])
            if name:
                built.add(name)
        elif name and ("spill" in line or "Used" in line):
            log(f"ptxas {name}: {line.strip()}")
    lib = _kernels.load_library()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    counts, example = {}, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = instance(m[1])
        elif name and "HMMA" in line and "TF32" in line:
            counts[name] = counts.get(name, 0) + 1
            example.setdefault(name, line.split(";")[0].split("*/")[-1]
                               .strip())
    for name in sorted(counts):
        log(f"sass {name}: {counts[name]} TF32 HMMA, e.g. {example[name]}")
    check(len(built) == 8 and set(counts) == built,
          f"TF32 HMMA in {len(counts)} of {len(built)} sweep instances")


def small_build_matches_cpu(torch, HnswConfig, HnswIndex, dev):
    pts, qs = make_data(SEED, 4000, 64)
    cfg = HnswConfig(dims=DIMS, m=16, ef_construction=64, ef_search=64)
    gpu = HnswIndex(cfg, device=dev)
    cpu = HnswIndex(cfg, device="cpu")
    gpu.build(pts)
    cpu.build(pts)
    same = (gpu.graph.links.cpu() == cpu.graph.links).all(dim=1)[:4000]
    _, lg, _ = gpu.search(qs, K, mode="graph")
    _, lc, _ = cpu.search(qs, K, mode="graph")
    _, eg, _ = gpu.exact_search(qs, K)
    _, ec, _ = cpu.exact_search(qs, K)
    frac, gsame, esame = (float(same.float().mean()), float((lg == lc).mean()),
                          float((eg == ec).mean()))
    log(f"small build (4000 x 128-d) cuda vs cpu: identical link rows "
        f"{frac:.4f}, graph ids {gsame:.4f}, exact ids {esame:.4f}")
    check(frac >= 0.95 and gsame >= 0.95 and esame >= 0.99,
          "cuda and cpu builds disagree")


def reset_launches(cb):
    for name in cb.LAUNCHES:
        cb.LAUNCHES[name] = 0


def recall(got_l, got_v, want_l, k=K):
    return float(np.mean([len(set(got_l[i][got_v[i]][:k].tolist()) &
                              set(want_l[i][:k].tolist())) / k
                          for i in range(len(got_l))]))


def main_path(torch, cb, HnswConfig, HnswIndex, dev, n, n_queries):
    from pg_embedding_tpu_torch.utils.profiling import Timer
    timer = Timer()
    with timer.phase("data"):
        pts, qs = make_data(SEED, n, n_queries)
    log(f"data: {n} x {DIMS} SIFT-like clustered, {n_queries} queries "
        f"(seed {SEED}) in {timer.seconds['data']:.1f} s")

    reset_launches(cb)
    # The graph route expands T=8 candidates per step, the setting of the
    # JAX package's own 1M graph measurement (BASELINE.md, "Measured at
    # 1M"): on this data the default T=4 reaches recall@10 0.895 at 1M, a
    # property of the exact8-built graph that the JAX build shares (the two
    # builds agree link for link at small sizes); it is printed below too.
    idx = HnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                               ef_search=64), device=dev,
                    search_expand_width=GRAPH_T)
    with timer.phase("build", torch.empty(0, device=dev)):
        idx.build(pts)
    build_s = timer.seconds["build"]
    log(f"build: {n} vectors in {build_s:.1f} s = {n / build_s:.0f} vec/s")

    g = idx.graph
    links = g.links[:n]
    cnts = g.link_counts[:n]
    slot = torch.arange(links.shape[1], device=dev)
    used = slot < cnts.unsqueeze(1)
    check(idx.n_nodes == n, "n_nodes")
    check(bool((cnts <= idx.config.max_m).all()), "counts over maxM")
    check(bool(((links >= 0) & (links < n))[used].all()), "link id range")
    check(bool((links[~used] == -1).all()), "-1 padding")
    log(f"graph invariants ok: mean degree {float(cnts.float().mean()):.2f}")

    d, l, v = idx.search(qs, K)                        # auto -> exact route
    check(cb.LAUNCHES["bruteforce_topk"] > 0,
          "search(mode='auto') did not launch the kernel")
    check(d.shape == (n_queries, K) and bool(np.isfinite(d).all())
          and bool(v.all()), "exact results shape/finite")

    # the exact route against a float64 oracle on a few queries
    sub = torch.as_tensor(qs[:16], device=dev).double()
    full = torch.as_tensor(pts, device=dev)
    d64 = torch.cdist(sub, full.double())
    oracle = torch.topk(d64, K, largest=False).indices.cpu().numpy()
    check(recall(l[:16], v[:16], oracle) >= 0.99, "exact vs float64 oracle")

    reps = 5
    t0 = time.time()
    for _ in range(reps):
        el = idx.exact_search(qs, K)[1]
    exact_qps = reps * n_queries / (time.time() - t0)
    t0 = time.time()
    for _ in range(reps):
        _, gl, gv = idx.search(qs, K, mode="graph")
    graph_qps = reps * n_queries / (time.time() - t0)
    rec = recall(gl, gv, el)
    idx.search_expand_width = 4
    _, gl4, gv4 = idx.search(qs, K, mode="graph")
    idx.search_expand_width = GRAPH_T
    log(f"exact_search: {exact_qps:.0f} QPS; search(mode='graph', "
        f"T={GRAPH_T}): {graph_qps:.0f} QPS at recall@10 {rec:.4f} vs the "
        f"exact route (T=4: recall@10 {recall(gl4, gv4, el):.4f})")
    check(rec >= 0.90, f"graph recall {rec} < 0.90")

    dead = np.random.default_rng(SEED + 4).choice(
        n, n // 100, replace=False).astype(np.uint64)
    check(idx.delete(dead) == len(dead), "delete count")
    for mode in ("exact", "graph"):
        _, dl, dv = idx.search(qs, K, mode=mode)
        check(not np.isin(dl[dv], dead).any(), f"deleted label from {mode}")
        check(bool(dv.all()), f"{mode}: fewer than k live results")
    log(f"delete: {len(dead)} labels tombstoned; none returned by the exact "
        f"or graph route")
    launches = dict(cb.LAUNCHES)
    log(f"main path kernel launches: {launches}")
    return idx, pts, qs, launches


def serving_variants(torch, idx, qs):
    """Quantized and packed walks on the 1M index at T=8: QPS and recall@10
    against the exact route, each within 0.005 of the plain walk's recall;
    float32 records must give the plain walk's ids and order; the bitmap
    visited set must give dense's ids."""
    _, el, _ = idx.exact_search(qs, K)
    _, plain_ids = idx.search_ids(qs)
    _, pl, pv = idx.search(qs, K, mode="graph")
    plain_rec = recall(pl, pv, el)
    log(f"serving plain walk (T={idx.search_expand_width}): recall@10 "
        f"{plain_rec:.4f} vs the exact route")
    variants = [("quantized", dict(quantized_traversal=True)),
                ("packed int8", dict(packed_traversal=True,
                                     packed_dtype="int8")),
                ("packed bfloat16", dict(packed_traversal=True,
                                         packed_dtype="bfloat16")),
                ("packed float32", dict(packed_traversal=True,
                                        packed_dtype="float32"))]
    reps = 3
    for name, knobs in variants:
        for key, val in knobs.items():
            setattr(idx, key, val)
        t0 = time.time()
        _, ids = idx.search_ids(qs)            # builds the shadow/records
        torch.cuda.synchronize()
        first_s = time.time() - t0
        t0 = time.time()
        for _ in range(reps):
            _, gl, gv = idx.search(qs, K, mode="graph")
        qps = reps * len(qs) / (time.time() - t0)
        size = (idx._pcodes if idx.packed_traversal else idx._qvec)
        gb = size.numel() * size.element_size() / 1e9
        rec = recall(gl, gv, el)
        log(f"serving {name} (T={idx.search_expand_width}): {qps:.0f} QPS at "
            f"recall@10 {rec:.4f} vs the exact route; shadow {gb:.2f} GB, "
            f"first call {first_s:.1f} s")
        check(rec >= plain_rec - 0.005,
              f"{name}: recall {rec} vs the plain walk's {plain_rec}")
        if name == "packed float32":
            check(np.array_equal(ids, plain_ids),
                  "packed float32 ids/order differ from the plain walk")
        idx.quantized_traversal = idx.packed_traversal = False
    log("packed float32 walk: ids and order equal the plain walk's on all "
        f"{len(qs)} queries")
    sub = qs[:64]
    _, dense = idx.search_ids(sub)
    idx.visited_mode = "bitmap"
    _, bitmap = idx.search_ids(sub)
    idx.visited_mode = "dense"
    check(np.array_equal(bitmap, dense), "bitmap visited set != dense")
    log("visited_mode='bitmap' gives dense's ids on 64 queries")


def answers(idx, qs):
    return [idx.search(qs, K, mode=mode)[1] for mode in ("graph", "exact")]


def same_answers(a, b, what):
    for mode, x, y in zip(("graph", "exact"), a, b):
        check(np.array_equal(x, y), f"{what}: {mode} labels differ")


def persistence(torch, HnswIndex, idx, qs, tmp):
    path = os.path.join(tmp, "index.npz")
    t0 = time.time()
    idx.save(path, compressed=False)
    save_s = time.time() - t0
    t0 = time.time()
    back = HnswIndex.load(path, device=idx.device)
    back.search_expand_width = idx.search_expand_width   # not persisted
    torch.cuda.synchronize()
    load_s = time.time() - t0
    log(f"save(compressed=False) of {idx.n_nodes} nodes: "
        f"{os.path.getsize(path) / 1e9:.3f} GB in {save_s:.1f} s; "
        f"load onto the card {load_s:.1f} s")
    same_answers(answers(idx, qs), answers(back, qs), "loaded index")
    viol = back.check_integrity(raise_on_error=False)
    check(not any(viol.values()), f"loaded index integrity {viol}")
    counts = ("num_nodes", "num_live", "num_dead")     # capacity may differ
    check(all(back.vacuum()[c] == idx.vacuum()[c] for c in counts),
          "vacuum counts differ")
    check(back.counters["n_deleted"] == idx.counters["n_deleted"],
          "tombstone count")
    log(f"loaded index: graph and exact labels equal the saved index's; "
        f"integrity clean; vacuum {back.vacuum()}")
    del back
    os.remove(path)


def wal_recovery(torch, HnswIndex, idx, pts, qs, tmp):
    snap, log_path = os.path.join(tmp, "snap.npz"), os.path.join(tmp, "wal")
    idx.enable_wal(log_path)
    idx.save(snap, compressed=False)
    rng = np.random.default_rng(SEED + 1)
    n0 = idx.n_nodes
    extra = (pts[:10_000] + rng.normal(scale=0.1, size=(10_000, DIMS))
             ).astype(np.float32)
    t0 = time.time()
    idx.add(extra, np.arange(n0, n0 + 10_000, dtype=np.uint64))
    alive = np.nonzero(~idx.graph.deleted[:idx.n_nodes].cpu().numpy())[0]
    gone = rng.choice(idx.labels[alive], 1_000, replace=False)
    check(idx.delete(gone) == 1_000, "WAL phase delete count")
    torch.cuda.synchronize()
    write_s = time.time() - t0
    want = (idx.n_nodes, idx.counters["n_deleted"], answers(idx, qs))
    wal_bytes = os.path.getsize(log_path)
    t0 = time.time()
    back = HnswIndex.load(snap, wal=log_path, device=idx.device)
    back.search_expand_width = idx.search_expand_width
    torch.cuda.synchronize()
    rec_s = time.time() - t0
    got = (back.n_nodes, back.counters["n_deleted"], answers(back, qs))
    check(got[:2] == want[:2], f"recovered n_nodes/tombstones {got[:2]} "
          f"!= live {want[:2]}")
    same_answers(want[2], got[2], "WAL-recovered index")
    log(f"WAL: 10,000 adds + 1,000 deletes logged ({wal_bytes / 1e6:.1f} MB, "
        f"{write_s:.1f} s with the writes); load(snapshot, wal=) recovered "
        f"n_nodes {got[0]}, {got[1]} tombstones and both routes' labels in "
        f"{rec_s:.1f} s")
    del back
    os.remove(snap)


def scan_check(idx, qs):
    scan = idx.open_scan(qs[0])
    _, labels = scan.next(K)
    _, gl, gv = idx.search(qs[:1], K, mode="graph")
    check(len(labels) == K == len(set(labels.tolist())), "scan labels")
    check(np.array_equal(labels, gl[0][gv[0]]), "scan != search(graph)")
    _, more = scan.next(K)
    check(not np.isin(more, labels).any(), "scan repeated a row")
    log(f"open_scan: first {K} labels equal search(mode='graph')'s; the next "
        f"{len(more)} are new")


def wide_k_phase(torch, cb, idx, qs):
    """search() with k past one launch's k_run cap runs the kernel in pages
    (two launches of 751 at k=1500) and answers what ops/bruteforce's
    exact_search answers on the same rows: ids except float64 near-ties,
    distances to rtol 1e-5."""
    from pg_embedding_tpu_torch.ops.bruteforce import exact_search
    check(np.array_equal(idx.labels, np.arange(idx.n_nodes)),
          "labels are node ids")
    launches = dict(cb.LAUNCHES)
    t0 = time.time()
    d, l, v = idx.search(qs[:64], 1500)                # auto -> exact route
    wide_s = time.time() - t0
    pages = cb.LAUNCHES["bruteforce_topk"] - launches["bruteforce_topk"]
    check(pages == 2, f"k=1500 took {pages} kernel launches, not 2 pages")
    check(bool(v.all()), "wide k: fewer than k results")
    g = idx.graph
    q = torch.as_tensor(qs[:64], device=idx.device)
    want = exact_search(q, g.vectors, 1500, n_valid=idx.n_nodes,
                        deleted=g.deleted)
    got = (torch.as_tensor(d, device=idx.device),
           torch.as_tensor(l.astype(np.int32), device=idx.device))
    err, n_diff = compare(torch, got, want, q, g.vectors, L2, idx.n_nodes,
                          g.deleted)
    log(f"wide k: search(k=1500) on 64 queries ran the kernel in {pages} "
        f"pages in {wide_s:.2f} s; against ops/bruteforce.exact_search: "
        f"max_abs_err={err:.3g}, near-tie id swaps={n_diff}")


def pq_walk(torch, idx, qs, el, groups, opq):
    """Train, encode and pack at G=``groups`` (OPQ with ``opq``), then time
    the PQ walk; returns its recall@10 against the exact route."""
    from pg_embedding_tpu_torch.utils.profiling import Timer
    idx.pq_groups, idx.pq_opq = groups, opq
    idx._pq_codebook = idx._pq_rot = idx._pq_codes = idx._pcodes = None
    idx.packed_traversal, idx.packed_dtype = True, "pq"
    timer, card = Timer(), idx.graph.vectors
    with timer.phase("train", card):
        idx._ensure_pq_codebook()
    with timer.phase("encode", card):
        codes = idx._ensure_pq_codes()
    with timer.phase("pack", card):
        recs, _ = idx._ensure_packed()
    idx.search(qs, K, mode="graph")
    reps = 3
    hops = idx.counters["n_hops"]
    t0 = time.time()
    for _ in range(reps):
        _, gl, gv = idx.search(qs, K, mode="graph")
    qps = reps * len(qs) / (time.time() - t0)
    hops = (idx.counters["n_hops"] - hops) / (reps * len(qs))
    rec = recall(gl, gv, el)
    log(f"PQ walk G={groups}{' OPQ' if opq else ''} "
        f"(T={idx.search_expand_width}, ef={idx.config.ef_search}): "
        f"{timer.report()}; codes {codes.numel() / 1e9:.3f} GB, records "
        f"{recs.numel() / 1e9:.3f} GB; {qps:.0f} QPS, {hops:.1f} hops a "
        f"query, at recall@10 {rec:.4f} vs the exact route")
    return rec


def codes_card_vs_cpu(torch, idx, rows=100_000):
    """The card's pq_encode against the CPU's on the same rows: >= 99.9%
    equal codes, every other one a float64 near-tie (< 1e-5 relative)."""
    from pg_embedding_tpu_torch.ops.pq import pq_encode
    cb = idx._pq_codebook
    rows = min(rows, idx.n_nodes)
    x = idx.graph.vectors[:rows].float()
    got = pq_encode(x, cb).cpu()
    want = pq_encode(x.cpu(), cb.cpu())
    diff = (got != want).nonzero()
    g = cb.shape[0]
    sub = x.cpu().double().view(rows, g, -1)
    c64 = cb.cpu().double()
    worst = 0.0
    for r, grp in diff.tolist():
        a = float(((sub[r, grp] - c64[grp, want[r, grp].long()]) ** 2).sum())
        b = float(((sub[r, grp] - c64[grp, got[r, grp].long()]) ** 2).sum())
        worst = max(worst, abs(a - b) / max(a, 1e-12))
    same = 1.0 - len(diff) / want.numel()
    log(f"pq_encode card vs CPU on {rows} rows x G={g}: {same:.6f} of codes "
        f"equal, {len(diff)} differ (largest float64 gap "
        f"{worst:.2e} relative)")
    check(same >= 0.999, f"card/CPU codes agree on {same}")
    check(worst < 1e-5, f"a differing code is not a near-tie ({worst})")


def pq_sweep_phase(torch, idx, qs, el):
    """tune_sweep_pool(0.95) on 256 queries, then sweep_pq on all: recall@10
    >= 0.95 vs the exact route, distances equal to a float64 recompute."""
    t0 = time.time()
    res = idx.tune_sweep_pool(qs[:256], 0.95)
    tune_s = time.time() - t0
    idx.search(qs, K, mode="sweep_pq")
    reps = 2
    t0 = time.time()
    for _ in range(reps):
        d, l, v = idx.search(qs, K, mode="sweep_pq")
    qps = reps * len(qs) / (time.time() - t0)
    rec = recall(l, v, el)
    check(bool(v.all()), "sweep_pq: fewer than k results")
    rows = idx.graph.vectors[:idx.n_nodes]
    q = torch.as_tensor(qs, device=rows.device)
    ids = torch.as_tensor(l.astype(np.int64), device=rows.device)
    d64 = true_dist(torch, q, rows.float(), ids, L2).cpu().numpy()
    err = float(np.max(np.abs(d - d64) / np.maximum(d64, 1e-12)))
    log(f"sweep_pq: tune_sweep_pool(0.95) chose pool {res.ef} (recall@10 "
        f"{res.recall:.4f} on 256 queries, {tune_s:.1f} s); "
        f"search(mode='sweep_pq') {qps:.0f} QPS at recall@10 {rec:.4f} vs "
        f"the exact route on {len(qs)} queries; distances vs float64 max "
        f"relative error {err:.2e}")
    check(rec >= 0.95, f"sweep_pq recall {rec} < 0.95")
    check(err <= 1e-5, f"sweep_pq distances off by {err}")


def pq_persistence(torch, HnswIndex, idx, qs, tmp):
    path = os.path.join(tmp, "pq.npz")
    idx.save(path, compressed=False)
    back = HnswIndex.load(path, device=idx.device)
    for knob in ("search_expand_width", "packed_traversal", "packed_dtype",
                 "pq_sweep_pool"):
        setattr(back, knob, getattr(idx, knob))
    check(np.array_equal(back._pq_codebook.cpu().numpy(),
                         idx._pq_codebook.cpu().numpy()),
          "loaded codebook bytes differ")
    for mode in ("graph", "sweep_pq"):
        check(np.array_equal(back.search(qs, K, mode=mode)[1],
                             idx.search(qs, K, mode=mode)[1]),
              f"loaded PQ index: {mode} labels differ")
    log(f"PQ save -> load: codebook bytes equal (G={back.pq_groups}); PQ "
        f"walk and sweep_pq labels equal on {len(qs)} queries")
    del back
    os.remove(path)


def pq_walk_card_vs_cpu(torch, idx, qs):
    """The card's PQ walk against its CPU twin on the same graph, codebook
    and codes: the same ids in the same order on >= 90% of 64 queries
    (distances summed in another order may flip a near-tie and with it the
    rest of a walk)."""
    from pg_embedding_tpu_torch.convert import index_from_numpy, to_numpy
    a = to_numpy(idx.graph)
    cpu = index_from_numpy(
        idx.config, a["vectors"], a["links"], a["link_counts"], a["deleted"],
        a["n_nodes"], idx.labels, device="cpu",
        pq_codebook=idx._pq_codebook.cpu().numpy(), packed_traversal=True,
        packed_dtype="pq", search_expand_width=idx.search_expand_width)
    cpu._pq_codes = idx._pq_codes.cpu()
    _, gi = idx.search_ids(qs[:64])
    _, ci = cpu.search_ids(qs[:64])
    same = float((gi == ci).all(axis=1).mean())
    log(f"PQ walk card vs CPU on the same state: identical ids and order on "
        f"{same:.4f} of 64 queries")
    check(same >= 0.9, f"card and CPU PQ walks agree on {same}")


def pq_main(torch, idx, qs):
    """G=32 on the main index (bench.py's 1,000 centres): printed, not
    held; then the card against the CPU (codes and the walk)."""
    _, el, _ = idx.exact_search(qs, K)
    _, pl, pv = idx.search(qs, K, mode="graph")
    log(f"PQ on the main index (1,000 centres, ~1,000 rows each): plain "
        f"walk recall@10 {recall(pl, pv, el):.4f}")
    pq_walk(torch, idx, qs, el, 32, False)
    codes_card_vs_cpu(torch, idx)
    pq_walk_card_vs_cpu(torch, idx, qs)


def pq_serving_phase(torch, HnswConfig, HnswIndex, dev, n, n_queries, tmp):
    """PQ where the JAX package measured it serving (bench_pq.py's
    50,000-centre recipe): G=16, OPQ G=32 and G=32 walks (G=32 held within
    0.03 of the plain walk's recall), the tuned sweep, save -> load."""
    from pg_embedding_tpu_torch.utils.profiling import Timer
    pts, qs = make_data(SEED + 3, n, n_queries, PQ_CENTERS)
    idx = HnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                               ef_search=64), device=dev,
                    search_expand_width=GRAPH_T)
    timer = Timer()
    with timer.phase("build", torch.empty(0, device=dev)):
        idx.build(pts)
    build_s = timer.seconds["build"]
    _, el, _ = idx.exact_search(qs, K)
    _, pl, pv = idx.search(qs, K, mode="graph")
    plain = recall(pl, pv, el)
    log(f"PQ index: {n} x {DIMS}-d, {PQ_CENTERS} centres (bench_pq.py's "
        f"recipe, seed {SEED + 3}) built in {build_s:.1f} s; plain walk "
        f"recall@10 {plain:.4f} (T={idx.search_expand_width}, "
        f"ef={idx.config.ef_search})")
    pq_walk(torch, idx, qs, el, 16, False)
    pq_walk(torch, idx, qs, el, 32, True)
    rec = pq_walk(torch, idx, qs, el, 32, False)
    check(rec >= plain - 0.03,
          f"PQ G=32 walk recall {rec} vs the plain walk's {plain}")
    pq_sweep_phase(torch, idx, qs, el)
    pq_persistence(torch, HnswIndex, idx, qs, tmp)


def bf16_phase(torch, cb, idx, qs):
    """The one-way downcast, then the exact route through the bf16
    instantiation; returns its launch counts.  On every query the route must
    return the exact top-k of the rows it stores: a float64 oracle over the
    bf16 rows, with the kernel check's near-tie rule (a returned row within
    1e-5 relative of the oracle's k-th distance).  Its recall against the
    float32 route is printed only: bf16 rounding reorders near-ties."""
    n = idx.n_nodes
    check(np.array_equal(idx.labels, np.arange(n)), "labels are node ids")
    _, el, _ = idx.exact_search(qs, K)
    idx.downcast_corpus("bfloat16")
    reset_launches(cb)
    _, bl, bv = idx.search(qs, K)                      # auto -> exact route
    launches = dict(cb.LAUNCHES)
    check(launches["bruteforce_topk_bf16"] > 0,
          "search() on a bf16 corpus did not launch the bf16 kernel")
    check(bool(bv.all()), "bf16 route: fewer than k results")
    rec32 = recall(bl, bv, el)
    rows = idx.graph.vectors[:n].double()
    dead = idx.graph.deleted[:n]
    oracle, kth, got_d = [], [], []
    for lo in range(0, len(qs), 128):
        q = torch.as_tensor(qs[lo:lo + 128], device=rows.device).double()
        d64 = torch.cdist(q, rows).masked_fill(dead, float("inf"))
        top = torch.topk(d64, K, largest=False)
        oracle.append(top.indices.cpu().numpy())
        kth.append(top.values[:, K - 1])
        got = torch.as_tensor(bl[lo:lo + 128].astype(np.int64),
                              device=rows.device)
        got_d.append(d64.gather(1, got).amax(1))
        del d64
    oracle = np.concatenate(oracle)
    kth, got_d = torch.cat(kth), torch.cat(got_d)
    rec_own = recall(bl, bv, oracle)
    excess = float(((got_d - kth) / kth).max())
    log(f"downcast_corpus('bfloat16'): search(mode='auto') recall@10 "
        f"{rec_own:.4f} vs a float64 oracle over the bf16 rows on "
        f"{len(qs)} queries (largest returned distance {excess:+.2e} "
        f"relative to the oracle's 10th); recall@10 {rec32:.4f} vs the "
        f"float32 exact route (not held); launches {launches}")
    check(rec_own >= 0.99, f"bf16 route vs its own rows: recall {rec_own}")
    check(bool((got_d <= kth * (1 + 1e-5) + 1e-6).all()),
          f"bf16 route returned a row past the oracle's 10th ({excess})")
    return launches


def pq_after_downcast(idx, qs, shadows):
    """The PQ codebook, codes and records survive the one-way cast as the
    same tensors, and the PQ walk keeps answering."""
    check(all(a is b for a, b in zip(shadows, (
        idx._pq_codebook, idx._pq_codes, idx._pcodes))),
        "PQ shadows were rebuilt by the downcast")
    _, _, v = idx.search(qs, K, mode="graph")
    check(bool(v.all()), "PQ walk after the downcast")
    log("after the downcast: PQ codebook, codes and records are the same "
        "tensors; the PQ walk answers every query")


def table_phase(torch, VectorTable, dev):
    """knn.sql on the card, then a 20,000 x 128-d table with three
    indexes: the seq scan against a float64 oracle, the pull scan against
    order_by."""
    t = VectorTable(dims=3, device=dev)
    ids = t.insert([[0, 1, 2], [1, 2, 3], [1, 1, 1], None])
    t.create_index("<->", m=3)
    t.insert([[1, 2, 4]])
    check([r for r, _ in t.order_by([3, 3, 3], "<->", limit=4)]
          == [1, 4, 2, 0], "knn.sql index order")
    for op in ("<=>", "<~>"):
        t.create_index(op, m=3)
    for op in ("<->", "<=>", "<~>"):
        a = t.order_by([3, 3, 3], op, limit=4)
        b = t.order_by([3, 3, 3], op, limit=4, use_index=False)
        check({r for r, _ in a} == {r for r, _ in b} and np.allclose(
            [d for _, d in a], [d for _, d in b], rtol=1e-5, atol=1e-6),
            f"knn.sql {op}: index and seq scan differ")
    t.delete(ids + [4])
    check(t.count() == 0 and t.order_by([3, 3, 3], limit=4) == [],
          "knn.sql delete")
    log("VectorTable knn.sql replay on the card: index order, three "
        "opclasses against the seq scan, delete")

    from pg_embedding_tpu_torch.utils.profiling import sync
    pts, qs = make_data(SEED + 2, 20_000, 32)
    t = VectorTable(dims=DIMS, device=dev)
    t0 = time.time()
    t.insert(list(pts))
    insert_s = time.time() - t0
    ops = {"<->": 0, "<=>": 1, "<~>": 2}
    build_s = {}
    for op in ops:
        t0 = time.time()
        t.create_index(op, m=16, ef_construction=64, ef_search=64)
        sync(torch.empty(0, device=dev))
        build_s[op] = time.time() - t0
    rows = torch.as_tensor(pts, device=dev).double()
    seq_ms, idx_ms = {}, {}
    for op, metric in ops.items():
        t0 = time.time()
        seq = [t.order_by(q, op, limit=K, use_index=False) for q in qs]
        seq_ms[op] = (time.time() - t0) / len(qs) * 1e3
        t0 = time.time()
        via = [t.order_by(q, op, limit=K) for q in qs]
        idx_ms[op] = (time.time() - t0) / len(qs) * 1e3
        q = torch.as_tensor(qs, device=dev).double()
        if metric == 2:
            d64 = torch.cdist(q, rows, p=1)
        elif metric == 0:
            d64 = torch.cdist(q, rows)
        else:
            d64 = 1 - (q @ rows.T) / (q.norm(dim=1, keepdim=True)
                                      * rows.norm(dim=1))
        top = torch.topk(d64, K, largest=False)
        kth = top.values[:, K - 1].cpu().numpy()
        for i, res in enumerate(seq):
            got = np.array([d for _, d in res])
            want = d64[i, [r for r, _ in res]].cpu().numpy()
            check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"seq scan {op}: distances vs float64")
            check(got[-1] <= kth[i] * (1 + 1e-5) + 1e-5,
                  f"seq scan {op}: a row past the oracle's k-th")
        for q, res in zip(qs[:8], via[:8]):
            pulled = list(itertools.islice(t.scan(q, op), K))
            check([r for r, _ in pulled] == [r for r, _ in res],
                  f"pull scan {op} != order_by")
    log(f"VectorTable 20000 x {DIMS}-d on the card: insert {insert_s:.2f} "
        f"s; create_index "
        + ", ".join(f"{op} {s:.1f} s" for op, s in build_s.items())
        + "; order_by per query, index / seq scan: "
        + ", ".join(f"{op} {idx_ms[op]:.2f} / {seq_ms[op]:.2f} ms"
                    for op in ops)
        + f"; seq scan equals a float64 oracle on {len(qs)} queries per "
        f"opclass; pull scan equals order_by on 8")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pg_embedding_tpu_torch import (HnswConfig, HnswIndex, VectorTable,
                                        _kernels)
    from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls on")

    t0 = time.time()
    _kernels.load_library()
    log(f"kernel build: {time.time() - t0:.1f} s (nvcc, sm_90a)")
    compiler_report(_kernels)

    timings = kernel_phase(torch, cb, dev)
    small_build_matches_cpu(torch, HnswConfig, HnswIndex, dev)
    idx, pts, qs, main_launches = main_path(torch, cb, HnswConfig, HnswIndex,
                                            dev, args.n, args.queries)
    wide_k_phase(torch, cb, idx, qs)
    serving_variants(torch, idx, qs)
    os.makedirs(os.path.join(REPO, ".kernel_build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(REPO, ".kernel_build")) as tmp:
        persistence(torch, HnswIndex, idx, qs, tmp)
        wal_recovery(torch, HnswIndex, idx, pts, qs, tmp)
        scan_check(idx, qs)
        pq_main(torch, idx, qs)
        shadows = (idx._pq_codebook, idx._pq_codes, idx._pcodes)
        bf16_launches = bf16_phase(torch, cb, idx, qs)
        pq_after_downcast(idx, qs, shadows)
        del idx, pts
        torch.cuda.empty_cache()
        pq_serving_phase(torch, HnswConfig, HnswIndex, dev, args.n,
                         args.queries, tmp)
    table_phase(torch, VectorTable, dev)

    log(smi)
    kernels = []
    for name, launches in (("bruteforce_topk", main_launches),
                           ("bruteforce_topk_bf16", bf16_launches)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pg_embedding_tpu_torch/csrc/bruteforce_topk.cu",
            "replaces": "pg_embedding_tpu/ops/pallas_bruteforce.py:58",
            "launches": launches[name], **timings[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
