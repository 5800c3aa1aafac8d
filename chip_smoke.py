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
     and a bfloat16 one (aligned and an unaligned view); at 1M x 128-d,
     B=1024, k_run=12 (CUDA events) each instantiation's time, its bound
     (3 TF32 passes for float32 rows, 2 for bf16, at 495 TFLOP/s) and share
     of it, the plain twin's time, and library_ms: torch.addmm of the L2
     scores in full float32 plus torch.topk (a yardstick the port never
     calls);
  4. the main path at SIFT1M's shape (1,000,000 x 128-d, BASELINE.md
     config 1, bench.py's clustered recipe, seed 12345): HnswIndex.build,
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
     search(); last, downcast_corpus("bfloat16") and search() through the
     kernel's bf16 instantiation, held on every query to a float64 oracle
     over the stored bf16 rows: recall@10 >= 0.99, and every row it returns
     within the kernel check's near-tie tolerance of the oracle's 10th
     distance.  Its recall@10 against the float32 route is printed, not
     held: bf16 rounding of the rows reorders near-ties at rank 10.
The last three lines are the card's nvidia-smi line, a JSON line of the
kernels, and {"ok": true, "device": {...}}.

Needs a CUDA device and nvcc; without a device it exits non-zero before
printing any result.
"""

import argparse
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


def make_data(rng, n, n_queries):
    """SIFT-like clustered synthetic corpus (bench.py's recipe)."""
    centers = rng.normal(scale=4.0, size=(N_CENTERS, DIMS)).astype(np.float32)
    assign = rng.integers(0, N_CENTERS, n)
    pts = (centers[assign] +
           rng.normal(size=(n, DIMS)).astype(np.float32)).astype(np.float32)
    qassign = rng.integers(0, N_CENTERS, n_queries)
    qs = (centers[qassign] +
          rng.normal(size=(n_queries, DIMS)).astype(np.float32)
          ).astype(np.float32)
    return pts, qs


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
        got = cb.bruteforce_topk(qs, pts, k_run, metric, n_valid, dead)
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
    rng = np.random.default_rng(SEED)
    pts, qs = make_data(rng, 4000, 64)
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
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    pts, qs = make_data(rng, n, n_queries)
    log(f"data: {n} x {DIMS} SIFT-like clustered, {n_queries} queries "
        f"(seed {SEED}) in {time.time() - t0:.1f} s")

    reset_launches(cb)
    # The graph route expands T=8 candidates per step, the setting of the
    # JAX package's own 1M graph measurement (BASELINE.md, "Measured at
    # 1M"): on this data the default T=4 reaches recall@10 0.895 at 1M, a
    # property of the exact8-built graph that the JAX build shares (the two
    # builds agree link for link at small sizes); it is printed below too.
    idx = HnswIndex(HnswConfig(dims=DIMS, m=16, ef_construction=64,
                               ef_search=64), device=dev,
                    search_expand_width=GRAPH_T)
    t0 = time.time()
    idx.build(pts)
    torch.cuda.synchronize()
    build_s = time.time() - t0
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

    dead = rng.choice(n, n // 100, replace=False).astype(np.uint64)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pg_embedding_tpu_torch import HnswConfig, HnswIndex, _kernels
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
    serving_variants(torch, idx, qs)
    os.makedirs(os.path.join(REPO, ".kernel_build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(REPO, ".kernel_build")) as tmp:
        persistence(torch, HnswIndex, idx, qs, tmp)
        wal_recovery(torch, HnswIndex, idx, pts, qs, tmp)
    scan_check(idx, qs)
    bf16_launches = bf16_phase(torch, cb, idx, qs)

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
